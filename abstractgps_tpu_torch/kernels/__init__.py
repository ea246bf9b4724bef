from .base import (  # noqa: F401
    Kernel,
    KernelSum,
    KernelProduct,
    ScaledKernel,
    TransformedKernel,
    ScaleTransform,
    ARDTransform,
    LinearTransform,
    FunctionTransform,
    with_lengthscale,
    compose,
    kernelmatrix,
    kernelmatrix_diag,
)
from .stationary import *  # noqa: F401,F403
