"""Operations and bytes of the matrix-free exact GP's work (BBMM, Gardner
et al. 2018), from its shapes: N points of D inputs, p probes, a rank-k
preconditioner.

Model FLOPs are the estimator's, whatever implements it: a later PR that
stops the solver at convergence or fuses the gram into its product keeps
the same count. One MLE-II step:
  ``model_iters`` matvecs (K + σ²I)·[y, Z]: each the gram map over all N²
  entries, N²·(3D + 12), and the product with the N × (1 + p) block,
  2N²·(1 + p); ``model_iters`` is the least number of solver steps in
  which some column was still active, measured on the card at θ0 over the
  calibration seeds (the configuration's ``assumed``)
  the rank-k pivoted Cholesky   k columns of the gram N·(3D + 12) each,
                                and the rank-1 updates N·k² in all
  one gram VJP for the gradient ``sweep_flops`` over the lower triangle, the
                                cotangent a rank-(1 + p) product, 2(1 + p)
                                an entry
At N = 32 768, D = 8, p = 32, k = 64 that is 1.10e11 a matvec.

One launch of the gram tile on a panel of the matvec: ``panel`` rows
against all N, read x's panel and all of x and write the panel once.
"""

from __future__ import annotations

from gpbench import peaks

FAMILY_IDS = {"matern32": 2, "matern52": 3}


def matvec_flops(cfg: dict) -> float:
    n, d, p = cfg["n"], cfg["d"], cfg["cg"]["num_probes"]
    return float(n) * n * (3.0 * d + peaks.MAP_FLOPS) + 2.0 * n * n * (1 + p)


def step_flops(cfg: dict, traffic: dict) -> float:
    n, d, p, k = cfg["n"], cfg["d"], cfg["cg"]["num_probes"], cfg["cg"]["precond_rank"]
    pivchol = k * n * (3.0 * d + peaks.MAP_FLOPS) + float(n) * k * k
    vjp = peaks.sweep_flops(n, n, d, FAMILY_IDS[cfg["kernel"]], True, 2 * (1 + p), 1)
    return cfg["model_iters"] * matvec_flops(cfg) + pivchol + vjp


def gram_panel_launch(cfg: dict) -> tuple[float, float] | None:
    """(bytes, operations) of one gram-tile launch of a matvec's panel: its
    rows against all N padded to whole panels; None where N is at most
    ``max_dense_n`` (the gram is then formed once)."""
    n, c = cfg["n"], cfg["cg"]
    if n <= c["max_dense_n"]:
        return None
    return peaks.gram_tile_cost(c["panel"], -(-n // c["panel"]) * c["panel"], cfg["d"])
