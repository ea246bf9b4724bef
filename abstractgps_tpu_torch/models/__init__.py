from .gp import GP, AbstractGP  # noqa: F401
from .finite_gp import FiniteGP  # noqa: F401
from .exact_posterior import PosteriorGP, posterior, ExactInference  # noqa: F401
