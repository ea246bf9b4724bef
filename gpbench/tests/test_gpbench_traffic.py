"""Each traffic generator repeats for a seed and differs across seeds, and
the ragged mix puts about a third of its queries on the wide solve."""

from __future__ import annotations

import itertools
import json

import numpy as np
import torch

from gpbench import spec as S
from gpbench.families import exact_gp, svgp
from gpbench.generators import predict


def _mix():
    return json.loads((S.CODE_DIR / "traffic" / "predict_ragged.json").read_text())


def test_ragged_sizes_are_fixed_and_a_third_are_wide():
    sizes = predict.query_sizes(_mix()["sizes"])
    assert len(sizes) == 256 and min(sizes) == 1 and 4000 < max(sizes) <= 4096
    assert sizes == predict.query_sizes(_mix()["sizes"])
    wide = sum(q >= 256 for q in sizes) / len(sizes)
    assert abs(wide - 1 / 3) < 0.02


def _take(seed, k=600):
    sched = predict.schedule(predict.query_sizes(_mix()["sizes"]), 65536,
                             np.random.default_rng(seed))
    return list(itertools.islice(sched, k))


def test_ragged_schedule_repeats_for_a_seed_and_differs_across_seeds():
    a, b, c = _take(2**31 + 11), _take(2**31 + 11), _take(2**31 + 12)
    assert a == b and a != c
    # every cycle is the same multiset of sizes, in another order
    sizes = sorted(predict.query_sizes(_mix()["sizes"]))
    assert sorted(q for q, _ in a[:256]) == sizes == sorted(q for q, _ in c[:256])
    assert [q for q, _ in a[:256]] != [q for q, _ in a[256:512]]
    assert all(0 <= off <= 65536 - q for q, off in a)


def _gen(seed):
    return torch.Generator(device="cpu").manual_seed(seed)


def test_data_repeats_for_a_seed_and_differs_across_seeds():
    for fam, cfg in ((exact_gp, {"n": 64, "d": 3, "data": {"noise_std": 0.3}}),
                     (svgp, {"n": 64, "d": 3, "data": {"noise_std": 0.2}})):
        a, b, c = (fam.make_data(cfg, _gen(s)) for s in (2**32 + 5, 2**32 + 5, 2**32 + 6))
        assert torch.equal(a["x"], b["x"]) and torch.equal(a["y"], b["y"])
        assert not torch.equal(a["x"], c["x"])


def test_minibatches_repeat_for_a_seed_differ_across_seeds_and_hold_distinct_rows():
    def rows(seed):
        mb = svgp.Minibatches(1000, 64, _gen(seed))
        return [mb.next() for _ in range(20)]

    a, b, c = rows(7), rows(7), rows(8)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))
    # 15 batches of 64 distinct rows an epoch of 1000
    assert len(torch.cat(a[:15]).unique()) == 15 * 64
    assert all(len(x.unique()) == 64 for x in a)


def test_the_sample_is_uniform_drawn_from_the_seed_and_keeps_the_largest():
    def keep(seed, n=500):
        s = predict.Sample(8, seed)
        for i in range(n):
            s.offer((1 + (i * 37) % 300, i, 0.0, None, None))
        return [a[1] for a in s.answers()]

    a, b, c = keep(2**31 + 3), keep(2**31 + 3), keep(2**31 + 4)
    assert a == b and a != c and len(a) == 9
    assert a[-1] == next(i for i in range(500) if 1 + (i * 37) % 300 == 300)
    # every answer is as likely to be kept: the mean kept position is mid-window
    pos = [i for s in range(400) for i in keep(s)[:-1]]
    assert abs(sum(pos) / len(pos) - 249.5) < 10
