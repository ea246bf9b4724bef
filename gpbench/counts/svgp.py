"""Operations and bytes of the SVGP's work (Hensman et al. 2013), from its
shapes: M inducing points, a minibatch of B, D inputs.

One ELBO evaluation (forward):
  K(z, z)'s lower triangle      M(M+1)/2 · (3D + 12)
  K(z, x_B)                     M·B·(3D + 12)
  chol(K(z, z))                 M³/3
  A = L⁻¹K(z, x_B)              M²·B
  CᵀA                           M²·B
  mean, variance, KL            O(M·B + M²)
One training step is the forward and its backward, counted as 2× the
forward: 3× in all (3.50e9 at M = 512, B = 2048, D = 8).

One query of q points: K(z, x*) M·q·(3D + 12), A and CᵀA 2M²·q, mean and
variance 4M·q. The program re-factors K(z, z) on every query; that is not
counted.
"""

from __future__ import annotations

from gpbench import peaks

SE_FAMILY = 0
GRAM_TILE_MIN_ENTRIES = 512 * 512  # as in counts/exact_gp.py


def _forward_flops(m: int, b: int, d: int) -> float:
    per = 3.0 * d + peaks.MAP_FLOPS
    return (m * (m + 1) / 2 * per + m * b * per + m ** 3 / 3.0 + 2.0 * m * m * b
            + 6.0 * m * b + 2.0 * m * m)


def step_flops(cfg: dict, traffic: dict) -> float:
    return 3.0 * _forward_flops(cfg["m"], traffic["batch"], cfg["d"])


def query_flops(cfg: dict, q: int) -> float:
    m, d = cfg["m"], cfg["d"]
    return m * q * (3.0 * d + peaks.MAP_FLOPS) + 2.0 * m * m * q + 4.0 * m * q


def gram_bwd_launches(cfg: dict, traffic: dict) -> list:
    """(bytes, operations) of each gram-VJP launch of one step: K(z, z)'s
    symmetric sweep, and K(z/ℓ, x_B/ℓ)'s plain and transposed sweeps (both
    operands carry ℓ's gradient)."""
    m, b, d = cfg["m"], traffic["batch"], cfg["d"]
    return [peaks.gram_bwd_cost(m, m, d, SE_FAMILY, True),
            peaks.gram_bwd_cost(m, b, d, SE_FAMILY, False),
            peaks.gram_bwd_cost(b, m, d, SE_FAMILY, False)]


def gram_tile_launches(cfg: dict, q: int) -> list:
    """(bytes, operations) of each gram-tile launch of one query: K(z, z)
    and, when it is on the fused path, K(z, x*)."""
    m, d = cfg["m"], cfg["d"]
    out = [peaks.gram_tile_cost(m, m, d, sym=True)]
    if m * q >= GRAM_TILE_MIN_ENTRIES:
        out.append(peaks.gram_tile_cost(m, q, d))
    return out
