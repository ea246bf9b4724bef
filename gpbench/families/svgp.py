"""The SVGP of ``abstractgps_tpu_torch`` (``SVGP``, ``svgp_elbo``,
``svgp_posterior``): σ²·SE ∘ ARD(1/ℓ) with M inducing points, trained
jointly with σ², ℓ, the noise, z, m and C_raw through ``fit`` on
minibatches, and queried through ``svgp_posterior(...).mean_and_var``. All
on the card in float32."""

from __future__ import annotations

import torch

import abstractgps_tpu_torch as agt
import abstractgps_tpu_torch.params as P

from gpbench import faults


def draw_inputs(cfg: dict, gen: torch.Generator, count: int) -> torch.Tensor:
    """Inputs drawn as the training inputs are: U(0, 4)^D."""
    return 4.0 * torch.rand((count, cfg["d"]), generator=gen, device=gen.device)


def make_data(cfg: dict, gen: torch.Generator) -> dict:
    """``examples/sparse_vfe_50k.py``'s data: x ~ U(0, 4)^D,
    y = sin(x)·w + 0.3·cos(2x₀) + noise_std·ε with w_k = e^{−k/2}."""
    d = cfg["d"]
    x = draw_inputs(cfg, gen, cfg["n"])
    w = torch.exp(-torch.arange(d, device=x.device, dtype=torch.float32) / 2.0)
    f = torch.sin(x) @ w + 0.3 * torch.cos(2.0 * x[:, 0])
    y = f + cfg["data"]["noise_std"] * torch.randn(cfg["n"], generator=gen, device=x.device)
    return {"x": x, "y": y}


def _state(cfg: dict, data: dict, gen: torch.Generator) -> dict:
    """z: M rows of x drawn without replacement; q(ε) = N(m, CCᵀ) with
    m ~ m_std·N(0, I) and C_raw = c_off_std·N(0, 1) below the diagonal and
    softplus⁻¹(c_diag) on it; σ², ℓ and the noise at θ0."""
    x = data["x"]
    dev, M = x.device, cfg["m"]
    v = cfg["model"]["variational"]
    z = x[torch.randperm(x.shape[0], generator=gen, device=dev)[:M]].clone()
    m = v["m_std"] * torch.randn(M, generator=gen, device=dev)
    c_raw = torch.tril(v["c_off_std"] * torch.randn((M, M), generator=gen, device=dev), -1)
    c_diag = torch.full((M,), v["c_diag"], device=dev)
    c_raw += torch.diag(c_diag + torch.log(-torch.expm1(-c_diag)))  # softplus⁻¹
    th = cfg["theta0"]
    return {"s2": torch.tensor(float(th["s2"]), device=dev),
            "ard": torch.full((cfg["d"],), float(th["ard"]), device=dev),
            "noise2": torch.tensor(float(th["noise2"]), device=dev),
            "z": z, "m": m, "C_raw": c_raw}


def _svgp(cfg: dict, th: dict):
    kernel = agt.compose(agt.SqExponentialKernel(), agt.ARDTransform(1.0 / th["ard"])) * th["s2"]
    jitter = torch.tensor(cfg["model"]["inducing_jitter"], device=th["z"].device)
    return agt.SVGP(None, kernel, th["z"], th["m"], th["C_raw"], jitter)


class Minibatches:
    """Minibatch rows in epochs: a permutation of the n rows drawn on the card
    from the seed's generator, cut into n // B batches of B distinct rows."""

    def __init__(self, n: int, batch: int, gen: torch.Generator):
        self.n, self.batch, self.gen = n, batch, gen
        self.perm, self.pos = None, n
        self.recorded, self.recording = [], False
        self.first, self.keep_next = None, False

    def next(self) -> torch.Tensor:
        if self.pos + self.batch > self.n:
            self.perm = torch.randperm(self.n, generator=self.gen, device=self.gen.device)
            self.pos = 0
        idx = self.perm[self.pos:self.pos + self.batch]
        self.pos += self.batch
        if self.recording:
            self.recorded.append(idx)
        if self.keep_next:
            self.first, self.keep_next = idx, False
        return idx


class TrainProblem:
    """−ELBO of one minibatch, over the raw leaves of {C_raw, ard, m, noise2,
    s2, z}: σ², ℓ and the noise positive, the rest real. The SVGP is
    rebuilt from the constrained tree at every step."""

    def __init__(self, cfg: dict, traffic: dict, data: dict, gen: torch.Generator):
        self.data = data
        self.start = _state(cfg, data, gen)
        self.theta0 = {k: (P.positive(v) if k in ("s2", "ard", "noise2") else v)
                       for k, v in self.start.items()}
        self.feed = Minibatches(data["x"].shape[0], traffic["batch"], gen)
        x, y, n = data["x"], data["y"], data["x"].shape[0]

        def loss(raw):
            idx = self.feed.next()
            th = P.constrain(raw)
            return -agt.svgp_elbo(_svgp(cfg, th), x[idx], y[idx], th["noise2"], n_total=n)

        self.loss = loss

    def record(self, flag: bool) -> None:
        """Keep the rows of each step while ``flag`` is set."""
        self.feed.recording = flag

    def mark_call(self) -> None:
        """Keep the rows of the next step, the first of a call."""
        self.feed.keep_next = True

    def reference_inputs(self, steps: int) -> dict:
        """The data, the starting state with σ², ℓ and the noise constrained
        (the reference works out the raw leaves itself), and the rows each
        recorded step read."""
        return {"x": self.data["x"], "y": self.data["y"], "start": self.start, "steps": steps,
                "batches": list(self.feed.recorded[:steps])}

    def point_inputs(self, raw: dict) -> dict:
        """The data, the raw leaves at the start of the last call marked and
        the rows of its first step, for one step."""
        return {"x": self.data["x"], "y": self.data["y"], "raw": raw, "steps": 1,
                "batches": [self.feed.first]}


def predictor(cfg: dict, data: dict, gen: torch.Generator):
    """(the variational posterior at a state drawn from the seed, the
    reference's inputs, the prior variance)."""
    st = _state(cfg, data, gen)
    state = {k: st[k] for k in ("s2", "ard", "z", "m", "C_raw")}
    return agt.svgp_posterior(_svgp(cfg, st)), {"state": state}, float(st["s2"])


def fault_patches(name: str) -> list:
    """The parts of fault ``name`` (``gpbench.faults``) that lie in this
    family's model, as (owner, attribute, value)."""
    from abstractgps_tpu_torch.models.svgp import SVGPPosterior

    elbo, mean_and_var = agt.svgp_elbo, SVGPPosterior.mean_and_var
    if name == "half_batch":
        def half_elbo(svgp, x, y, noise, n_total=None):
            h = x.shape[0] // 2
            return elbo(svgp, x[:h], y[:h], noise, n_total=n_total)

        return [(agt, "svgp_elbo", half_elbo)]
    if name == "altered_answer":
        return [(agt, "svgp_elbo", lambda *a, **k: faults.alter_loss(elbo(*a, **k))),
                (SVGPPosterior, "mean_and_var",
                 lambda self, x: faults.alter_mean(mean_and_var(self, x)))]
    return []
