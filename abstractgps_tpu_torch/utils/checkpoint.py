"""Checkpoint/resume of posterior caches, parameter trees and sampler state.

Counterpart of the JAX package's ``utils/checkpoint.py`` (an orbax
round trip). ``save`` writes a tree's tensor leaves, keyed by their path in
the tree, with ``torch.save`` into a directory; ``restore`` loads them
(``weights_only=True``) into the structure of a ``like`` tree, each leaf on
``like``'s device and dtype. A tree is built of dicts, lists, tuples,
NamedTuples, dataclasses (the posterior caches, ``MCMCResult``, the
parameter tags) and plain objects holding tensors (the noise objects);
anything else is kept from ``like``.
"""

from __future__ import annotations

import copy
import dataclasses
import os

import torch

__all__ = ["save", "restore"]

_FILE = "tree.pt"


def _children(tree):
    """[(key, child)] of a container, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    if hasattr(tree, "__dict__") and not isinstance(tree, (torch.nn.Module, type)):
        return list(vars(tree).items())
    return None


def _flatten(tree, prefix, out):
    if isinstance(tree, torch.Tensor):
        out[prefix] = tree.detach()
        return
    for k, v in _children(tree) or ():
        _flatten(v, f"{prefix}.{k}" if prefix else k, out)


def _rebuild(like, prefix, saved):
    if isinstance(like, torch.Tensor):
        got = saved[prefix]
        if got.shape != like.shape:
            raise ValueError(f"checkpoint leaf {prefix!r} has shape {tuple(got.shape)}, "
                             f"expected {tuple(like.shape)}")
        return got.to(device=like.device, dtype=like.dtype).requires_grad_(like.requires_grad)
    kids = _children(like)
    if kids is None:
        return like
    new = {k: _rebuild(v, f"{prefix}.{k}" if prefix else k, saved) for k, v in kids}
    if isinstance(like, dict):
        return {k: new[str(k)] for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):  # a NamedTuple
        return type(like)(*new.values())
    if isinstance(like, (list, tuple)):
        return type(like)(new.values())
    out = copy.copy(like)
    for k, v in new.items():
        object.__setattr__(out, k, v)  # frozen dataclasses too
    return out


def save(path: str, tree) -> None:
    """Write the tensor leaves of ``tree`` to the directory ``path``."""
    leaves = {}
    _flatten(tree, "", leaves)
    os.makedirs(path, exist_ok=True)
    torch.save(leaves, os.path.join(path, _FILE))


def restore(path: str, like):
    """The tree saved at ``path``, in the structure of ``like``; each leaf
    on ``like``'s device and dtype. Raises on a leaf whose shape differs
    from ``like``'s."""
    saved = torch.load(os.path.join(path, _FILE), map_location="cpu", weights_only=True)
    return _rebuild(like, "", saved)
