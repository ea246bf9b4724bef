"""The temporal GP of ``abstractgps_tpu_torch`` on the state-space path:
σ²·Matérn-3/2(ℓ) on 1-D timestamps with isotropic noise, its log marginal
likelihood by ``markov_logpdf(fx, y, parallel=True)`` (the parallel-in-time
Kalman filter) and MLE-II through ``fit``. All on the card in float32.

Data: t = sort(U(0, t_max)), drawn in float64 from the seed and cast to
float32, which keeps the timestamps that fall on one float32 value
(repeated timepoints, Δt = 0); y = Σ_k a_k sin(2π t / p_k + φ_k) +
noise_std·ε, periods and amplitudes from the configuration, the phases φ_k
uniform from the seed."""

from __future__ import annotations

import math

import torch

import abstractgps_tpu_torch as agt
import abstractgps_tpu_torch.params as P

from gpbench import faults
from gpbench.families import exact_gp


def make_data(cfg: dict, gen: torch.Generator) -> dict:
    d, dev = cfg["data"], gen.device
    t64 = torch.rand(cfg["n"], generator=gen, device=dev, dtype=torch.float64) * d["t_max"]
    t64 = torch.sort(t64).values
    periods = torch.tensor(d["periods"], dtype=torch.float64, device=dev)
    amps = torch.tensor(d["amplitudes"], dtype=torch.float64, device=dev)
    phases = 2.0 * math.pi * torch.rand(periods.shape, generator=gen, device=dev,
                                        dtype=torch.float64)
    f = torch.sin(2.0 * math.pi * t64[:, None] / periods + phases) @ amps
    eps = torch.randn(cfg["n"], generator=gen, device=dev, dtype=torch.float64)
    y = f + d["noise_std"] * eps
    return {"t": t64.float(), "y": y.float()}


class TrainProblem:
    """−log N(y; 0, K + noise·I) by the parallel Kalman filter, over the raw
    leaves of {ell, noise, s2}, each positive. Every step sees all N
    timestamps."""

    def __init__(self, cfg: dict, traffic: dict, data: dict, gen: torch.Generator):
        self.data = data
        self.start = exact_gp._theta(cfg, data["t"].device)
        self.theta0 = {k: P.positive(v) for k, v in self.start.items()}
        t, y = data["t"], data["y"]

        def loss(raw):
            th = P.constrain(raw)
            kernel = th["s2"] * agt.with_lengthscale(agt.Matern32Kernel(), th["ell"])
            return -agt.markov_logpdf(agt.GP(kernel)(t, th["noise"]), y, parallel=True)

        self.loss = loss

    def record(self, flag: bool) -> None:
        """Every step reads the same rows: nothing to record."""

    def mark_call(self) -> None:
        """Every step reads the same rows: nothing to keep of a call's first."""

    def reference_inputs(self, steps: int) -> dict:
        """The data and the constrained starting values (the reference works
        out the raw leaves itself)."""
        return {"t": self.data["t"], "y": self.data["y"], "start": self.start, "steps": steps}

    def point_inputs(self, raw: dict) -> dict:
        """The data and the raw leaves at the start of a call, for one step."""
        return {"t": self.data["t"], "y": self.data["y"], "raw": raw, "steps": 1}


def fault_patches(name: str) -> list:
    """The parts of fault ``name`` (``gpbench.faults``) that lie in this
    family's model, as (owner, attribute, value): ``markov_logpdf`` as the
    package exports it, which the loss looks up at each call."""
    logpdf = agt.markov_logpdf
    if name == "half_batch":
        def half_logpdf(fx, y, parallel=False):
            h = fx.x.shape[0] // 2
            return 2.0 * logpdf(fx.f(fx.x[:h], fx.noise.diag()[:h]), y[:h], parallel)

        return [(agt, "markov_logpdf", half_logpdf)]
    if name == "altered_answer":
        return [(agt, "markov_logpdf",
                 lambda fx, y, parallel=False: faults.alter_loss(logpdf(fx, y, parallel)))]
    return []
