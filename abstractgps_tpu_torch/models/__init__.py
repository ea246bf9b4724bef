"""GP models: the prior (``gp``), its finite projections (``finite_gp``),
the exact posterior with sequential conditioning (``exact_posterior``),
LatentGPs (``latent_gp``), the sparse VFE/DTC approximations with online
updates (``sparse``), the stochastic variational GP (``svgp``),
streaming exact conditioning into a fixed-capacity cache (``online``), the
matrix-free CG backend (``iterative``), pathwise posterior sampling
(``pathwise``) and the Markov (state-space) backend (``markov``)."""

from .gp import GP, AbstractGP  # noqa: F401
from .finite_gp import FiniteGP  # noqa: F401
from .exact_posterior import PosteriorGP, posterior, ExactInference  # noqa: F401
from .latent_gp import LatentFiniteGP, LatentGP  # noqa: F401
from .iterative import CGInference, CGPosteriorGP, cg_logpdf, mbcg, slq_logdet  # noqa: F401
from .markov import (  # noqa: F401
    MarkovPosteriorGP,
    is_markov_kernel,
    markov_logpdf,
    markov_mean_and_var,
    markov_posterior,
    markov_rand,
)
from .pathwise import (  # noqa: F401
    FourierFeatures,
    pathwise_sample,
    prior_function_sample,
    sample_fourier_features,
)
from .sparse import VFE, DTC, ApproxPosteriorGP, elbo, update_posterior  # noqa: F401
from .svgp import (  # noqa: F401
    SVGP,
    SVGPPosterior,
    fit_svgp,
    fit_svgp_natgrad,
    svgp_elbo,
    svgp_elbo_quadrature,
    svgp_init,
    svgp_posterior,
)
