"""MCMC diagnostics: split-R̂ and effective sample size.

Counterpart of the JAX package's ``inference/mcmc/diagnostics.py`` (this
package keeps its own copy). Implementations follow Vehtari et al. 2021
("Rank-normalization, folding, and localization: An improved R̂"):
split-chain R̂ and the autocorrelation-based bulk ESS via Geyer's initial
monotone sequence.

All functions take draws shaped (num_chains, num_samples) — tensors or
numpy arrays — or a tree of such arrays via the *_tree variants, and run
in numpy on the host at the end of a run.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["rhat", "ess", "rhat_tree", "ess_tree", "summary"]


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def _split_chains(x: np.ndarray) -> np.ndarray:
    c, n = x.shape
    half = n // 2
    return np.concatenate([x[:, :half], x[:, half: 2 * half]], axis=0)


def rhat(draws) -> float:
    """Split-chain potential scale reduction factor R̂."""
    x = _split_chains(_host(draws))
    m, n = x.shape
    chain_means = x.mean(axis=1)
    B = n * chain_means.var(ddof=1)
    W = x.var(axis=1, ddof=1).mean()
    var_plus = (n - 1) / n * W + B / n
    return float(np.sqrt(var_plus / W))


def _autocov(x: np.ndarray) -> np.ndarray:
    """Per-chain autocovariance via FFT, shape (chains, n)."""
    m, n = x.shape
    xc = x - x.mean(axis=1, keepdims=True)
    size = 2 ** int(np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, size, axis=1)
    acov = np.fft.irfft(f * np.conj(f), size, axis=1)[:, :n].real
    return acov / n


def ess(draws) -> float:
    """Bulk effective sample size (Geyer initial positive monotone sequence).

    ``τ = −1 + 2·Σ_k P_k`` over pair sums ``P_k = ρ_{2k} + ρ_{2k+1}``,
    truncated at the first non-positive pair and forced monotone
    non-increasing; ESS = m·n/τ.
    """
    x = _split_chains(_host(draws))
    m, n = x.shape
    acov = _autocov(x)
    chain_var = acov[:, 0] * n / (n - 1.0)
    W = chain_var.mean()
    var_plus = W * (n - 1.0) / n + x.mean(axis=1).var(ddof=1)
    if var_plus <= 0:
        return float(m * n)

    rho = 1.0 - (W - acov.mean(axis=0)) / var_plus
    rho[0] = 1.0

    tau = -1.0
    prev = np.inf
    for k in range(n // 2):
        pair = rho[2 * k] + rho[2 * k + 1]
        if pair <= 0:
            break
        pair = min(pair, prev)
        tau += 2.0 * pair
        prev = pair
    return float(m * n / max(tau, 1e-12))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def rhat_tree(positions):
    """R̂ for every scalar component of a positions tree (leaves shaped
    (chains, samples, ...))."""
    return _tree_map(lambda a: _per_component(a, rhat), positions)


def ess_tree(positions):
    return _tree_map(lambda a: _per_component(a, ess), positions)


def _per_component(a, fn):
    a = _host(a)
    if a.ndim == 2:
        return fn(a)
    flat = a.reshape(a.shape[0], a.shape[1], -1)
    return np.array([fn(flat[:, :, i]) for i in range(flat.shape[2])]).reshape(a.shape[2:])


def summary(result) -> dict:
    """Compact diagnostics for an MCMCResult: per-leaf R̂/ESS plus sampler
    health (acceptance, divergences, step sizes)."""
    return {
        "rhat": rhat_tree(result.positions),
        "ess": ess_tree(result.positions),
        "accept_prob": float(_host(result.accept_prob).mean()),
        "divergence_rate": float(_host(result.diverging).mean()),
        "step_size": _host(result.step_size),
    }
