"""The exact GP of ``abstractgps_tpu_torch``: σ²·k(‖x − x′‖/ℓ) with
isotropic noise, MLE-II through ``fit(nlml(...))`` and prediction through
``posterior(fx, y).mean_and_var``. All on the card in float32."""

from __future__ import annotations

import math

import torch

import abstractgps_tpu_torch as agt
import abstractgps_tpu_torch.params as P

from gpbench import faults

KERNELS = {"matern32": "Matern32Kernel", "matern52": "Matern52Kernel"}


def draw_inputs(cfg: dict, gen: torch.Generator, count: int) -> torch.Tensor:
    """Inputs drawn as the training inputs are: U(0, 1)^D."""
    return torch.rand((count, cfg["d"]), generator=gen, device=gen.device)


def make_data(cfg: dict, gen: torch.Generator) -> dict:
    """x ~ U(0, 1)^D; y = Σ_k e^{−k/2} sin(2π x_k) + noise_std·ε."""
    d = cfg["d"]
    x = draw_inputs(cfg, gen, cfg["n"])
    w = torch.exp(-torch.arange(d, device=x.device, dtype=torch.float32) / 2.0)
    f = torch.sin(2.0 * math.pi * x) @ w
    y = f + cfg["data"]["noise_std"] * torch.randn(cfg["n"], generator=gen, device=x.device)
    return {"x": x, "y": y}


def _theta(cfg: dict, dev) -> dict:
    return {k: torch.tensor(float(v), device=dev) for k, v in cfg["theta0"].items()}


def _build_fx(cfg: dict):
    kcls = getattr(agt, KERNELS[cfg["kernel"]])

    def build(th, x):
        return agt.GP(th["s2"] * agt.with_lengthscale(kcls(), th["ell"]))(x, th["noise"])

    return build


class TrainProblem:
    """−log N(y; 0, K + noise·I) over the raw leaves of {ell, noise, s2},
    each positive. Every step sees all N rows."""

    def __init__(self, cfg: dict, traffic: dict, data: dict, gen: torch.Generator):
        self.data = data
        self.start = _theta(cfg, data["x"].device)
        self.theta0 = {k: P.positive(v) for k, v in self.start.items()}
        self.loss = agt.nlml(_build_fx(cfg), data["x"], data["y"])

    def record(self, flag: bool) -> None:
        """Every step reads the same rows: nothing to record."""

    def mark_call(self) -> None:
        """Every step reads the same rows: nothing to keep of a call's first."""

    def reference_inputs(self, steps: int) -> dict:
        """The data and the constrained starting values (the reference works
        out the raw leaves itself)."""
        return {"x": self.data["x"], "y": self.data["y"], "start": self.start, "steps": steps}

    def point_inputs(self, raw: dict) -> dict:
        """The data and the raw leaves at the start of a call, for one step."""
        return {"x": self.data["x"], "y": self.data["y"], "raw": raw, "steps": 1}


def predictor(cfg: dict, data: dict, gen: torch.Generator):
    """(the posterior at θ0, the reference's inputs, the prior variance)."""
    th = _theta(cfg, data["x"].device)
    post = agt.posterior(_build_fx(cfg)(th, data["x"]), data["y"])
    return post, {"x": data["x"], "y": data["y"], "theta": th}, float(th["s2"])


def fault_patches(name: str) -> list:
    """The parts of fault ``name`` (``gpbench.faults``) that lie in this
    family's model, as (owner, attribute, value)."""
    from abstractgps_tpu_torch.models.exact_posterior import PosteriorGP
    from abstractgps_tpu_torch.models.finite_gp import FiniteGP

    logpdf, mean_and_var = FiniteGP.logpdf, PosteriorGP.mean_and_var
    if name == "half_batch":
        def half_logpdf(self, y):
            h = self.x.shape[0] // 2
            return 2.0 * logpdf(self.f(self.x[:h], self.noise.diag()[:h]), y[:h])

        return [(FiniteGP, "logpdf", half_logpdf)]
    if name == "altered_answer":
        return [(FiniteGP, "logpdf", lambda self, y: faults.alter_loss(logpdf(self, y))),
                (PosteriorGP, "mean_and_var",
                 lambda self, x: faults.alter_mean(mean_and_var(self, x)))]
    return []
