"""The program slice of a prediction cell: one more cycle of the query
sizes, in the order the seed draws, each query answered to the host as the
window's are. The posterior and the pool are built from the seed as the
generator builds them, each size warmed, outside the slice."""

from __future__ import annotations

import types

from gpbench import spans
from gpbench import spec as S


def prepare(rec: dict, seed: int, device):
    cfg, traffic = rec["config"], rec["traffic"]
    fam = S.load_module("families", cfg["family"])
    generator = S.load_module("generators", traffic["generator"])
    su = generator.Setup(types.SimpleNamespace(family=lambda: fam, config=cfg, traffic=traffic),
                   seed, device)

    def run(span):
        for _ in range(len(su.sizes)):
            q, off = next(su.queries)
            with span(spans.CALL_SPAN):
                su.query(q, off)

    return run
