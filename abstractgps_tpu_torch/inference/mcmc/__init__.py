"""MCMC samplers: NUTS, HMC, elliptical slice sampling, SMC.

Counterpart of the JAX package's ``inference/mcmc``: batched over a leading
chain dimension, with randomness from a ``torch.Generator`` (or a seed) on
the positions' device, and ``chain_eval="vmap" | "loop"`` for how the
chains meet the log density (``sample.py``).
"""

from . import diagnostics
from .adaptation import (
    da_init,
    da_update,
    welford_init,
    welford_update,
    welford_variance,
    window_schedule,
)
from .ess import ESSState, ess_init, ess_kernel, run_ess
from .hmc import GeneratorDraws, HMCState, hmc_init, hmc_kernel, leapfrog
from .nuts import NUTSInfo, nuts_kernel
from .sample import MCMCResult, init_chain_positions, logdensity_and_grad, run_mcmc
from .smc import SMCResult, run_smc, systematic_resample

__all__ = [
    "run_mcmc",
    "MCMCResult",
    "init_chain_positions",
    "logdensity_and_grad",
    "nuts_kernel",
    "NUTSInfo",
    "hmc_kernel",
    "hmc_init",
    "HMCState",
    "leapfrog",
    "GeneratorDraws",
    "da_init",
    "da_update",
    "welford_init",
    "welford_update",
    "welford_variance",
    "window_schedule",
    "run_ess",
    "ess_kernel",
    "ess_init",
    "ESSState",
    "run_smc",
    "SMCResult",
    "systematic_resample",
    "diagnostics",
]
