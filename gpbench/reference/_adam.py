"""Adam as ``torch.optim.Adam`` defines it (β = (0.9, 0.999), ε = 1e-8, no
weight decay), written out for the references to follow three steps."""

from __future__ import annotations

import torch

BETAS = (0.9, 0.999)
EPS = 1e-8


def follow(loss_fn, raw0: dict, steps: int, lr: float) -> dict:
    """Run ``steps`` Adam steps of ``loss_fn(raw)`` from ``raw0`` (a dict of
    leaves). Returns the loss before each step, the first gradient and the
    change of each leaf over the steps."""
    raw = {k: v.detach().clone() for k, v in raw0.items()}
    m = {k: torch.zeros_like(v) for k, v in raw.items()}
    v2 = {k: torch.zeros_like(v) for k, v in raw.items()}
    losses, grad1 = [], None
    b1, b2 = BETAS
    for t in range(1, steps + 1):
        leaves = {k: v.requires_grad_() for k, v in raw.items()}
        val = loss_fn(leaves)
        grads = dict(zip(leaves, torch.autograd.grad(val, list(leaves.values()))))
        losses.append(float(val.detach()))
        if grad1 is None:
            grad1 = {k: g.detach().clone() for k, g in grads.items()}
        with torch.no_grad():
            for k in raw:
                g = grads[k]
                m[k] = b1 * m[k] + (1 - b1) * g
                v2[k] = b2 * v2[k] + (1 - b2) * g * g
                mhat = m[k] / (1 - b1 ** t)
                vhat = v2[k] / (1 - b2 ** t)
                raw[k] = (raw[k] - lr * mhat / (vhat.sqrt() + EPS)).detach()
    delta = {k: raw[k] - raw0[k].detach() for k in raw}
    return {"losses": losses, "grad1": grad1, "delta": delta}
