from . import blocked_chol, covmat, distance, fused_gram, noise, precision  # noqa: F401
