"""Inference engines: the MLE-II training loops (``training``)."""

from . import training
from .training import FitResult, fit, fit_lbfgs, nlml

__all__ = ["fit", "fit_lbfgs", "nlml", "FitResult", "training"]
