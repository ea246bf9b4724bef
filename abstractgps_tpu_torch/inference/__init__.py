"""Inference engines: the MLE-II training loops (``training``) and the
MCMC samplers (``mcmc``)."""

from . import mcmc, training
from .mcmc import (
    MCMCResult,
    SMCResult,
    init_chain_positions,
    run_ess,
    run_mcmc,
    run_smc,
)
from .training import FitResult, fit, fit_lbfgs, neg_elbo, nlml

__all__ = ["fit", "fit_lbfgs", "nlml", "neg_elbo", "FitResult", "training", "mcmc", "run_mcmc",
           "MCMCResult", "init_chain_positions", "run_ess", "run_smc", "SMCResult"]
