"""Faults planted in the program under test, each one that breaks the timed
path underneath the benchmark: the harness runs as it always does, and
what it compares has to come out not correct.

- ``frozen_step``: every optimizer step returns the state unchanged (the
  Adam update is skipped; its hooks still run).
- ``half_batch``: each loss sees the first half of its rows, the mean taken
  over them (the sum doubled, or the minibatch scaled by n/(B/2)).
- ``altered_answer``: where a result is produced, it is altered: each loss
  by 1e-3 of itself, each query's first mean by 1e-2.

A fault is found by name. The generator that a cell's traffic names lists
the faults its kind of cell can have (``FAULTS``) and gives the parts that
lie in the loop it drives; the configuration's family gives the parts that
lie in its model. Each does so in ``fault_patches(name)``: a list of
(owner, attribute, value). A new generator or family brings its own.
"""

from __future__ import annotations

import contextlib

import torch

LOSS_ALTERATION = 1e-3   # relative
MEAN_ALTERATION = 1e-2   # absolute, at a prior standard deviation of 1


@contextlib.contextmanager
def patched(*patches):
    """Set each (owner, name, value) and restore the originals after."""
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in patches]
    try:
        for owner, name, value in patches:
            setattr(owner, name, value)
        yield
    finally:
        for owner, name, value in reversed(saved):
            setattr(owner, name, value)


def alter_loss(v):
    return v + LOSS_ALTERATION * v.detach().abs()


def alter_mean(out):
    mu, var = out
    bump = torch.zeros_like(mu)
    bump[0] = MEAN_ALTERATION
    return mu + bump, var


def faults_of(cell) -> tuple:
    """The faults a cell can have: its generator's."""
    return tuple(cell.generator().FAULTS)


def planted(cell, name: str):
    """A context manager that plants fault ``name`` in the cell's path."""
    if name not in faults_of(cell):
        raise KeyError(f"{cell.name} cannot have the fault {name!r}")
    return patched(*cell.generator().fault_patches(name), *cell.family().fault_patches(name))
