"""The matrix-free exact GP of ``abstractgps_tpu_torch`` (GPyTorch-style
BBMM, Gardner et al. 2018): σ²·k(‖x − x′‖/ℓ) with isotropic noise, its
log marginal likelihood estimated by ``approx_log_evidence(CGInference(),
fx, y)`` (mBCG, SLQ, the pivoted-Cholesky preconditioner) and MLE-II
through ``fit``. The data, the kernel and θ0 are the exact family's. All
on the card in float32.

The estimator is stochastic: its probes are drawn from ``probe_seed``
through the preconditioner, and the preconditioner's pivots depend on the
hyperparameters of each step. The reference is handed both as data, as
the program drew them: the probe normals, and the pivot order at each
recorded step."""

from __future__ import annotations

import torch

import abstractgps_tpu_torch as agt
import abstractgps_tpu_torch.params as P
from abstractgps_tpu_torch.ops.draws import as_draws
from abstractgps_tpu_torch.ops.pivchol import pivoted_cholesky_with_pivots

from gpbench import faults
from gpbench.families import exact_gp

make_data = exact_gp.make_data


class TrainProblem:
    """−(the CG estimate of log N(y; 0, K + noise·I)) over the raw leaves of
    {ell, noise, s2}, each positive. Every step sees all N rows."""

    def __init__(self, cfg: dict, traffic: dict, data: dict, gen: torch.Generator):
        self.data = data
        self.start = exact_gp._theta(cfg, data["x"].device)
        self.theta0 = {k: P.positive(v) for k, v in self.start.items()}
        self.inference = agt.CGInference(**cfg["cg"])
        self.build = exact_gp._build_fx(cfg)
        self.recorded, self.recording = [], False
        x, y = data["x"], data["y"]

        def loss(raw):
            th = P.constrain(raw)
            if self.recording:
                self.recorded.append({k: v.detach().clone() for k, v in th.items()})
            return -agt.approx_log_evidence(self.inference, self.build(th, x), y)

        self.loss = loss

    def record(self, flag: bool) -> None:
        """Keep the hyperparameters of each step while ``flag`` is set."""
        self.recording = flag

    def mark_call(self) -> None:
        """A call's first step starts from the point ``point_inputs`` is
        given: nothing to keep."""

    def _normals(self) -> dict:
        """The normals the preconditioner's sampler turns into the probes:
        u (rank × p) and then w (n × p), drawn as the program draws them,
        from a new generator seeded with ``probe_seed`` on every call."""
        inf, x = self.inference, self.data["x"]
        draws = as_draws(inf.probe_seed, x.device)
        u = draws.normal((inf.precond_rank, inf.num_probes), x.dtype, x.device)
        return {"u": u, "w": draws.normal((x.shape[0], inf.num_probes), x.dtype, x.device)}

    def _pivots(self, th: dict) -> torch.Tensor:
        """The preconditioner's pivot order at the hyperparameters ``th``, as
        the program's step there picks it."""
        fx = self.build(th, self.data["x"])
        with torch.no_grad():
            return pivoted_cholesky_with_pivots(fx.f.kernel, fx.x,
                                                self.inference.precond_rank)[1]

    def reference_inputs(self, steps: int) -> dict:
        """The data, the constrained starting values (the reference works out
        the raw leaves itself), the probe normals and the pivots of each
        recorded step."""
        return {"x": self.data["x"], "y": self.data["y"], "start": self.start, "steps": steps,
                "normals": self._normals(),
                "pivots": [self._pivots(th) for th in self.recorded[:steps]]}

    def point_inputs(self, raw: dict) -> dict:
        """The data, the raw leaves at the start of a call, the probe normals
        and the pivots there, for one step."""
        th = P.constrain(P.with_leaves(self.theta0, [raw[k] for k in sorted(raw)]))
        return {"x": self.data["x"], "y": self.data["y"], "raw": raw, "steps": 1,
                "normals": self._normals(), "pivots": [self._pivots(th)]}


def fault_patches(name: str) -> list:
    """The parts of fault ``name`` (``gpbench.faults``) that lie in this
    family's model, as (owner, attribute, value)."""
    evidence = agt.CGInference.approx_log_evidence
    if name == "half_batch":
        def half_evidence(self, fx, y):
            h = fx.x.shape[0] // 2
            return 2.0 * evidence(self, fx.f(fx.x[:h], fx.noise.diag()[:h]), y[:h])

        return [(agt.CGInference, "approx_log_evidence", half_evidence)]
    if name == "altered_answer":
        return [(agt.CGInference, "approx_log_evidence",
                 lambda self, fx, y: faults.alter_loss(evidence(self, fx, y)))]
    return []
