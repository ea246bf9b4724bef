"""Published peaks of one NVIDIA H100 SXM and the roofline arithmetic.

The rates are NVIDIA's data sheet figures at the card's full 700 W power
limit; a run prints the card's ``power.limit`` beside its numbers. The
port keeps TF32 off (``abstractgps_tpu_torch/ops/precision.py``), so its
FP32 work is held against the FP32 rate outside the tensor cores.
"""

from __future__ import annotations

PEAK_F32 = 67e12        # FLOP/s, FP32 outside the tensor cores
BYTES_PER_S = 3.35e12   # HBM3 bandwidth, bytes/s

# operations of the gram map's VJP per family id (csrc/gram_sweep.cuh
# agp::map_vjp), a sqrt, exp, pow, log or trig counting as one
MAP_VJP_FLOPS = {0: 3, 1: 4, 2: 6, 3: 11, 4: 9, 5: 9, 6: 6}
# operations of the gram map per entry (csrc/gram_tile.cu's epilogue)
MAP_FLOPS = 12


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: bytes at the HBM rate or
    operations at the FP32 rate, whichever is longer."""
    return max(nbytes / BYTES_PER_S, flops / PEAK_F32)


def sweep_flops(n: int, m: int, d: int, family: int, sym: bool, cot_flops: int,
                epi_flops: int) -> float:
    """Operations a backward sweep over the (n, m) grid needs: per pair (each
    entry of the lower triangle when ``sym``, else each entry) d² from the
    differences (3D), the cotangent entry, the map VJP and the epilogue
    (+ 2 for a map hyperparameter of families 4 and 5); per ordered entry
    the x̄ update w·(x_r − z_c) (3D)."""
    pairs = n * (n + 1) / 2 if sym else n * m
    per_pair = 3 * d + cot_flops + MAP_VJP_FLOPS[family] + epi_flops + (
        2 if family in (4, 5) else 0)
    return pairs * per_pair + n * m * 3.0 * d


def gram_tile_cost(n: int, m: int, d: int, sym: bool = False) -> tuple[float, float]:
    """(bytes, operations) of one gram tile: x and z read and the (n, m) tile
    written once; d² from the differences and the map per entry needed (the
    lower triangle of a symmetric tile)."""
    pairs = n * (n + 1) / 2 if sym else n * m
    return 4.0 * ((n + m) * d + n * m), pairs * (3.0 * d + MAP_FLOPS)


def gram_bwd_cost(n: int, m: int, d: int, family: int, sym: bool) -> tuple[float, float]:
    """(bytes, operations) of one gram VJP sweep: the cotangent read once,
    x, z read and x̄ written once."""
    return 4.0 * (n * m + (2 * n + m) * d), sweep_flops(n, m, d, family, sym, int(sym), 1)


def logpdf_contraction_cost(n: int, d: int, q: int, family: int) -> tuple[float, float]:
    """(bytes, operations) of the logpdf-backward contraction: T's lower
    triangle, x′, α and α·ḡ read once, x̄′ written once; d², C (2q + 3) and
    the map VJP once per lower-triangle pair, x̄′ once per ordered entry."""
    return (4.0 * (n * (n + 1) / 2 + 2 * n * d + 2 * n * q),
            sweep_flops(n, n, d, family, True, 2 * q + 3, 4))
