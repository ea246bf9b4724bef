"""Operations and bytes of the exact GP's work, from its shapes.

Model FLOPs are fixed by the mathematics, not by the program: a later PR
that does the same work another way keeps the same count.

One MLE-II step (the gradient of −log N(y; 0, K + σ²I) in σ², ℓ, noise):
  the gram's lower triangle       N(N+1)/2 · (3D + 12)
  the Cholesky factor             N³/3
  α = K⁻¹y, two triangular solves 2N²
  K⁻¹ for ∂/∂K (trtri + lauum)    2N³/3
  the gram's VJP                  ``sweep_flops`` (C = ½(ααᵀ − K⁻¹))
At N = 8192, D = 8 that is 5.50e11, N³ of it.

One query of q points (mean and variance):
  the cross gram K(X, x*)   3·N·q·D
  the whitening solve       N²·q
  mean and variance         4·N·q
The program re-inverts L for a wide query; that is not counted.
"""

from __future__ import annotations

from gpbench import peaks

FAMILY_IDS = {"matern32": 2, "matern52": 3}
# the port's fused gram runs on the card at and above this many entries
# (``ops/fused_gram.py`` _MIN_SIZE); a launch count that disagrees with it
# leaves the metrics that use it silent
GRAM_TILE_MIN_ENTRIES = 512 * 512


def step_flops(cfg: dict, traffic: dict) -> float:
    n, d = cfg["n"], cfg["d"]
    fam = FAMILY_IDS[cfg["kernel"]]
    gram = n * (n + 1) / 2 * (3.0 * d + peaks.MAP_FLOPS)
    vjp = peaks.sweep_flops(n, n, d, fam, True, 5, 4)
    return gram + n ** 3 / 3.0 + 2.0 * n * n + 2.0 * n ** 3 / 3.0 + vjp


def query_flops(cfg: dict, q: int) -> float:
    n, d = cfg["n"], cfg["d"]
    return 3.0 * n * q * d + float(n) * n * q + 4.0 * n * q


def logpdf_contraction_launches(cfg: dict, traffic: dict) -> list:
    """(bytes, operations) of each launch of the logpdf-backward contraction
    in one step: one, over the whole N×N lower triangle with q = 1."""
    return [peaks.logpdf_contraction_cost(cfg["n"], cfg["d"], 1, FAMILY_IDS[cfg["kernel"]])]


def gram_tile_launches(cfg: dict, q: int) -> list:
    """(bytes, operations) of each gram-tile launch of one query: the cross
    gram K(X, x*) when it is on the fused path."""
    n, d = cfg["n"], cfg["d"]
    return [peaks.gram_tile_cost(n, q, d)] if n * q >= GRAM_TILE_MIN_ENTRIES else []
