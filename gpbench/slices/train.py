"""The program slice of a training cell: one more ``fit`` call of
``steps_per_call`` steps, ending in the host read of its loss history, as
the window's calls do. The problem is built from the seed as the
generator builds it; one call of as many steps runs first, outside the
slice, so that the allocator's cache and the card's clocks are as the
window left them."""

from __future__ import annotations

import torch

import abstractgps_tpu_torch as agt

from gpbench import spans
from gpbench import spec as S


def prepare(rec: dict, seed: int, device):
    cfg, traffic = rec["config"], rec["traffic"]
    fam = S.load_module("families", cfg["family"])
    gen = torch.Generator(device=device).manual_seed(seed)
    prob = fam.TrainProblem(cfg, traffic, fam.make_data(cfg, gen), gen)
    lr = traffic["learning_rate"]
    theta = agt.fit(prob.loss, prob.theta0, num_steps=traffic["steps_per_call"],
                    learning_rate=lr).params

    def run(span):
        with span(spans.CALL_SPAN):
            res = agt.fit(prob.loss, theta, num_steps=traffic["steps_per_call"],
                          learning_rate=lr)
            res.history.cpu()

    return run
