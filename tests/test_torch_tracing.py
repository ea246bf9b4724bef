"""The port's span recorder (``utils.profiling``) on the CPU.

- Off (the default), ``span`` is one shared object that records nothing,
  and the counters count as they do with it on.
- On, ``fit`` records one ``fit.step`` unit a step with the loop's spans
  in order, nested in time; each unit of the three benchmark paths (an
  exact step, an SVGP step, a query), reached through the kernel paths in
  interpret mode, stays within its budget of spans.
- A posterior forms one triangular inverse, on its first query whatever q;
  every later query whitens by one product with it.
- The spans share ``torch.profiler``'s clock, and ``trace`` writes them
  into its Chrome trace.
- A span opened in another thread while its opener blocks (autograd's
  device thread) gets the opener's span as its parent.
- A CG step's spans nest as named, one ``ops.cg.matvec`` a solver step;
  ``library.cg_matvec`` counts every matvec,
  ``library.cg_skipped_matvec`` the steps the solver stopped short of, and
  ``library.cg_converged_matvec``, only while recording, those after every
  column had frozen.
- The parallel Markov logpdf opens ``model.markov_logpdf`` and in it
  ``ops.markov.ssm`` (the model, then its filtering elements), ``.scan``
  (the recursion; in a chunked scan the carries' final combine too),
  ``.carry`` (a chunked scan only) and ``.likelihood``; ``library.markov_carry_combine`` counts
  the combines of the scan over the chunk totals, two a level of its
  odd/even recursion, recording or not; nothing is recorded outside
  ``recording()``, and its value and gradient are bitwise the same with
  the recorder on and off.
"""

import json
import math
import threading
from collections import Counter

import pytest
import torch
import torch_threads  # noqa: F401
from torch.profiler import ProfilerActivity, profile, record_function

import abstractgps_tpu_torch as agt
import abstractgps_tpu_torch.params as P
from abstractgps_tpu_torch.ops import blocked_chol, cuda, distance, fused_gram
from abstractgps_tpu_torch.utils import profiling

BUDGET = {"exact step": 150, "svgp step": 40, "query": 40}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(distance, "_DEFAULT_DEVICE", torch.device("cpu"))


@pytest.fixture
def kernel_paths(monkeypatch):
    """The kernel paths in interpret mode, cut so that N = 1024 sweeps eight
    outer slabs of four blocks, as N = 8192 sweeps eight of eight."""
    for mod in (blocked_chol, fused_gram):
        monkeypatch.setattr(mod, "_INTERPRET", True)
    monkeypatch.setattr(blocked_chol, "_MIN_N", 256)
    monkeypatch.setattr(blocked_chol, "_BLOCK", 32)
    monkeypatch.setattr(blocked_chol, "_OUTER", 128)
    monkeypatch.setattr(fused_gram, "_MIN_SIZE", 64 * 64)


def _data(n, d=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((n, d), generator=g)
    y = torch.sin(2 * math.pi * x).sum(1) + 0.1 * torch.randn(n, generator=g)
    return x, y


def _build(th, x):
    return agt.GP(th["s2"] * agt.with_lengthscale(agt.Matern32Kernel(), th["ell"]))(
        x, th["noise"])


def _exact_fit(n, steps):
    x, y = _data(n)
    theta = {k: P.positive(torch.tensor(v)) for k, v in dict(s2=1.0, ell=0.5, noise=0.1).items()}
    return agt.fit(agt.nlml(_build, x, y), theta, num_steps=steps)


def _svgp_fit(steps):
    x, y = _data(1000, seed=1)
    g = torch.Generator().manual_seed(2)
    m = 64
    theta = {"s2": P.positive(torch.tensor(1.0)), "ard": P.positive(torch.ones(3)),
             "noise": P.positive(torch.tensor(0.1)), "z": x[:m].clone(),
             "m": 0.1 * torch.randn(m, generator=g), "C_raw": torch.eye(m)}

    def loss(raw):
        th = P.constrain(raw)
        idx = torch.randint(0, x.shape[0], (128,), generator=g)
        k = agt.compose(agt.SqExponentialKernel(), agt.ARDTransform(1.0 / th["ard"])) * th["s2"]
        sv = agt.SVGP(None, k, th["z"], th["m"], th["C_raw"], torch.tensor(1e-6))
        return -agt.svgp_elbo(sv, x[idx], y[idx], th["noise"], n_total=x.shape[0])

    return agt.fit(loss, theta, num_steps=steps)


def _posterior(n):
    x, y = _data(n)
    th = {"s2": torch.tensor(1.0), "ell": torch.tensor(0.5), "noise": torch.tensor(0.1)}
    return agt.posterior(_build(th, x), y)


def _query(post, q):
    g = torch.Generator().manual_seed(q)
    with torch.no_grad():
        return post.mean_and_var(torch.rand((q, post.data.x.shape[1]), generator=g))


def test_off_records_nothing_and_the_counters_count_alike():
    assert profiling.span("fit.step") is profiling.span("ops.sweep")
    with profiling.span("fit.step") as s:
        assert s is None
    assert profiling._REC is None and not profiling._STACK

    def counted(on):
        lib, launches = dict(profiling.LIBRARY_CALLS), dict(cuda.LAUNCHES)
        if on:
            with profiling.recording():
                _exact_fit(200, 2)
        else:
            _exact_fit(200, 2)
        return ({k: v - lib[k] for k, v in profiling.LIBRARY_CALLS.items()},
                {k: v - launches[k] for k, v in cuda.LAUNCHES.items()})

    off, on = counted(False), counted(True)
    assert off == on
    # the library path of a small CPU GP: one factor and one solve a step
    assert off[0]["cholesky_lower"] == 2 and off[0]["tri_solve"] >= 2


def test_fit_records_a_unit_a_step_with_the_loops_spans_in_order():
    with profiling.recording() as rec:
        _exact_fit(200, 3)
    spans = rec.spans
    steps = [i for i, s in enumerate(spans) if s.name == "fit.step"]
    assert [spans[i].unit for i in steps] == [0, 1, 2] and rec.units == 3
    assert all(spans[i].parent == -1 for i in steps)
    for i in steps:
        kids = [s for s in spans if s.parent == i]
        assert [s.name for s in kids] == ["fit.zero_grad", "fit.loss", "fit.backward",
                                          "fit.optimizer", "fit.history"]
        prev = spans[i].start_ns
        for s in kids:
            assert s.unit == spans[i].unit
            assert prev <= s.start_ns <= s.end_ns <= spans[i].end_ns
            prev = s.end_ns
    for j, s in enumerate(spans):  # every span lies inside its parent, later in the list
        if s.parent >= 0:
            p = spans[s.parent]
            assert s.parent < j and p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
            assert s.unit == p.unit
    loss = next(j for j, s in enumerate(spans) if s.name == "fit.loss")
    assert any(s.name == "model.logpdf" and s.parent == loss for s in spans)


def _units(rec):
    return Counter(s.unit for s in rec.spans if s.unit >= 0)


@pytest.mark.parametrize("path", sorted(BUDGET))
def test_spans_a_unit_stay_within_budget(kernel_paths, path):
    if path == "query":
        post = _posterior(1024)
        with profiling.recording() as rec:
            _query(post, 300)
            _query(post, 40)
        needed = {"posterior.mean_and_var", "model.cross_gram", "ops.gram", "ops.whiten",
                  "ops.wide_solve.inverse"}
        units = 2
    else:
        with profiling.recording() as rec:
            _exact_fit(1024, 1) if path == "exact step" else _svgp_fit(2)
        needed = ({"model.logpdf", "ops.sweep", "ops.sweep.panel", "ops.sweep.update",
                   "ops.sweep.factor", "ops.sweep.solve", "ops.gram", "ops.logpdf_backward",
                   "ops.logpdf_backward.assemble", "ops.logpdf_backward.trtri",
                   "ops.logpdf_backward.lauum", "ops.logpdf_backward.contraction"}
                  if path == "exact step" else
                  {"model.svgp_elbo", "model.cross_gram", "ops.gram", "ops.gram_backward",
                   "ops.cholesky", "ops.trsm"})
        units = 1 if path == "exact step" else 2
    per_unit = _units(rec)
    assert len(per_unit) == units
    assert max(per_unit.values()) <= BUDGET[path], per_unit
    assert needed <= {s.name for s in rec.spans}
    if path == "exact step":  # one sweep of eight outer slabs
        assert Counter(s.name for s in rec.spans)["ops.sweep.panel"] == 8


@pytest.mark.parametrize("q", [1, 255, 256, 700])
def test_the_wide_solve_counts_one_inverse_a_query_from_q_256(monkeypatch, q):
    # the posterior holds L⁻¹: its first query forms the one inverse (thin
    # or wide, on either side of _WIDE_RHS), each later query whitens by one
    # product with it and counts no inverse and no substitution
    monkeypatch.setattr(blocked_chol, "_INTERPRET", True)
    monkeypatch.setattr(blocked_chol, "_MIN_N", 256)
    monkeypatch.setattr(blocked_chol, "_BLOCK", 32)
    assert blocked_chol._WIDE_RHS == 256
    post = _posterior(256)
    profiling.reset_library_calls()
    _query(post, q)
    assert {k: profiling.LIBRARY_CALLS[k] for k in ("wide_inverse", "tri_solve",
                                                    "whiten_cached")} == {
        "wide_inverse": 1, "tri_solve": 0, "whiten_cached": 1}
    with profiling.recording() as rec:
        _query(post, q)
        _query(post, q)
    roots = [s for s in rec.spans if s.name == "posterior.mean_and_var"]
    assert len(roots) == 2
    for root in roots:
        assert root.counts.get("library.wide_inverse", 0) == 0
        assert root.counts.get("library.tri_solve", 0) == 0
        assert root.counts["library.whiten_cached"] == 1


def test_spans_share_the_profilers_clock_and_trace_writes_them(tmp_path):
    x, y = _data(200)
    fx = _build({"s2": torch.tensor(1.0), "ell": torch.tensor(0.5),
                 "noise": torch.tensor(0.1)}, x)
    with profile(activities=[ProfilerActivity.CPU]) as prof, profiling.recording() as rec:
        with record_function("same.block"), profiling.span("model.block"):
            fx.logpdf(y)
    (ev,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "same.block"]
    (sp,) = [s for s in rec.spans if s.name == "model.block"]
    assert abs(sp.start_ns - ev.start_ns()) < 1_000_000
    assert abs(sp.end_ns - (ev.start_ns() + ev.duration_ns())) < 1_000_000

    with profiling.trace(str(tmp_path / "prof")):
        with record_function("same.block"):
            fx.logpdf(y)
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    (blk,) = [e for e in events if e.get("name") == "same.block"]
    (lp,) = [e for e in events if e.get("name") == "model.logpdf"]
    assert lp["cat"] == "program_span" and lp["args"]["parent"] == -1
    assert abs(lp["ts"] - blk["ts"]) < 1000.0  # µs
    assert abs(lp["ts"] + lp["dur"] - blk["ts"] - blk["dur"]) < 1000.0
    assert not profiling._REC  # trace() turned the recorder off again


def test_a_span_in_another_thread_gets_the_blocked_openers_span_as_parent():
    def backward_thread():
        with profiling.span("ops.logpdf_backward"):
            with profiling.span("ops.logpdf_backward.trtri"):
                pass

    with profiling.recording() as rec:
        with profiling.span("fit.step"), profiling.span("fit.backward"):
            th = threading.Thread(target=backward_thread)
            th.start()
            th.join(timeout=30)
        assert not th.is_alive()
    names = [(s.name, s.parent, s.unit) for s in rec.spans]
    assert names == [("fit.step", -1, 0), ("fit.backward", 0, 0),
                     ("ops.logpdf_backward", 1, 0), ("ops.logpdf_backward.trtri", 2, 0)]


def test_recording_is_not_reentrant_and_ends_clean():
    with profiling.recording():
        with pytest.raises(RuntimeError):
            with profiling.recording():
                pass
    assert not profiling._ON and profiling._REC is None
    with pytest.raises(ValueError):
        with profiling.recording():
            with profiling.span("fit.step"):
                raise ValueError
    assert not profiling._ON and not profiling._STACK


CG_SMALL = dict(num_probes=8, max_iters=40, panel=64, max_dense_n=0, precond_rank=16)


def _cg_fit(steps=1, n=200):
    x, y = _data(n, seed=3)
    theta = {k: P.positive(torch.tensor(v)) for k, v in dict(s2=1.0, ell=0.5, noise=0.1).items()}
    inf = agt.CGInference(**CG_SMALL)

    def loss(raw):
        return -agt.approx_log_evidence(inf, _build(P.constrain(raw), x), y)

    return agt.fit(loss, theta, num_steps=steps)


def _inside(spans, i, name):
    """Whether span ``i`` lies inside an open span called ``name``."""
    j = spans[i].parent
    while j >= 0:
        if spans[j].name == name:
            return True
        j = spans[j].parent
    return False


def test_the_cg_spans_nest_as_named():
    ran = profiling.LIBRARY_CALLS["cg_matvec"]
    with profiling.recording() as rec:
        _cg_fit()
    ran = profiling.LIBRARY_CALLS["cg_matvec"] - ran
    spans = rec.spans
    names = Counter(s.name for s in spans)
    assert names["model.cg_logpdf"] == 1 and names["ops.cg.solve"] == 1
    assert names["ops.cg.slq"] == 1 and names["ops.cg_backward"] == 1
    # one a step run, not one a panel; the solver stops once every column froze
    assert names["ops.cg.matvec"] == ran < CG_SMALL["max_iters"]
    assert names["ops.cg.precond"] == 2  # the factor and sampler; the Woodbury solver
    for i, s in enumerate(spans):
        if s.name == "model.cg_logpdf":
            assert spans[s.parent].name == "fit.loss"
        if s.name in ("ops.cg.precond", "ops.cg.solve", "ops.cg.slq"):
            assert _inside(spans, i, "model.cg_logpdf")
        if s.name == "ops.cg.matvec":
            assert spans[s.parent].name == "ops.cg.solve"
        if s.name == "ops.cg_backward":
            assert _inside(spans, i, "fit.backward")
    # the CG posterior's solves (``_CGSolve``) are solver spans too
    x, y = _data(200, seed=3)
    th = {"s2": torch.tensor(1.0), "ell": torch.tensor(0.5), "noise": torch.tensor(0.1)}
    with torch.no_grad():
        post = agt.posterior(agt.CGInference(**CG_SMALL), _build(th, x), y)
        ran = profiling.LIBRARY_CALLS["cg_matvec"]
        with profiling.recording() as rec:
            post.mean_and_var(torch.rand((5, 3), generator=torch.Generator().manual_seed(4)))
        ran = profiling.LIBRARY_CALLS["cg_matvec"] - ran
    names = Counter(s.name for s in rec.spans)
    assert names["ops.cg.solve"] == 1
    assert names["ops.cg.matvec"] == ran < CG_SMALL["max_iters"]


def test_the_cg_counters_count_matvecs_and_those_after_convergence(monkeypatch):
    from abstractgps_tpu_torch.models import iterative

    seen, mbcg = [], iterative.mbcg

    def kept(*args, **kwargs):
        ran = profiling.LIBRARY_CALLS["cg_matvec"]
        out = mbcg(*args, **kwargs)
        seen.append(out[1][2][:profiling.LIBRARY_CALLS["cg_matvec"] - ran])  # the rows run
        return out

    monkeypatch.setattr(iterative, "mbcg", kept)
    for on in (False, True):
        seen.clear()
        profiling.reset_library_calls()
        if on:
            with profiling.recording():
                _cg_fit(2)
        else:
            _cg_fit(2)
        calls = dict(profiling.LIBRARY_CALLS)
        assert len(seen) == 2
        assert calls["cg_matvec"] + calls["cg_skipped_matvec"] == 2 * CG_SMALL["max_iters"]
        assert calls["cg_matvec"] == sum(len(a) for a in seen)
        idle = sum(int((~a.any(dim=1)).sum()) for a in seen)
        assert calls["cg_converged_matvec"] == (idle if on else 0)
    # at these sizes every column converges within 40 steps: the solver stops
    # there, and on the CPU, which reads the masks at once, runs no idle step
    assert calls["cg_skipped_matvec"] > 0 and idle == 0


def test_a_cg_step_records_no_span_while_nothing_records(monkeypatch):
    def opened(name):
        raise AssertionError(f"span {name!r} recorded with no recording open")

    monkeypatch.setattr(profiling, "_On", opened)
    _cg_fit()
    assert profiling._REC is None and not profiling._STACK


def _markov_value_and_grad(n):
    """The parallel Markov logpdf of σ²·Matérn-3/2 + noise on n sorted
    timestamps (a few repeated), and its gradient in (σ², ℓ, noise)."""
    g = torch.Generator().manual_seed(5)
    t = torch.sort(torch.rand(n, generator=g) * n * 1e-3).values
    t[1::40] = t[0::40]
    y = torch.sin(2 * math.pi * t) + 0.3 * torch.randn(n, generator=g)
    th = {k: torch.tensor(v, requires_grad=True) for k, v in dict(s2=1.0, ell=0.5,
                                                                  noise=0.1).items()}
    val = agt.markov_logpdf(_build(th, t), y, parallel=True)
    return val.detach(), torch.autograd.grad(val, list(th.values()))


@pytest.mark.parametrize("n, chunk, combines", [
    (1000, 64, 6),    # 15 totals: levels of 15, 7, 3
    (50, 64, 0),      # one chunk: no carries
    (128, 64, 0),     # two chunks: the one total is its own prefix
    (2048, 8, 14),    # 255 totals: levels of 255, 127, ..., 3; a fold made 255
])
def test_the_markov_spans_nest_and_the_carries_count(monkeypatch, n, chunk, combines):
    from abstractgps_tpu_torch.models import markov

    monkeypatch.setattr(markov, "_PAR_CHUNK", chunk)
    chunked = n > chunk
    before = profiling.LIBRARY_CALLS["markov_carry_combine"]
    with profiling.recording() as rec:
        _markov_value_and_grad(n)
    assert profiling.LIBRARY_CALLS["markov_carry_combine"] - before == combines
    spans = rec.spans
    names = Counter(s.name for s in spans)
    assert names == Counter({"model.markov_logpdf": 1, "ops.markov.ssm": 2,
                             "ops.markov.scan": 2 if chunked else 1,
                             "ops.markov.likelihood": 1,
                             **({"ops.markov.carry": 1} if chunked else {})})
    for i, s in enumerate(spans):
        if s.name != "model.markov_logpdf":
            assert spans[s.parent].name == "model.markov_logpdf"
        if s.name == "ops.markov.carry":
            assert s.counts == ({"library.markov_carry_combine": combines} if combines else {})
    # the counter counts with nothing recording, too
    before = profiling.LIBRARY_CALLS["markov_carry_combine"]
    _markov_value_and_grad(n)
    assert profiling.LIBRARY_CALLS["markov_carry_combine"] - before == combines


def test_the_markov_path_records_nothing_while_nothing_records(monkeypatch):
    from abstractgps_tpu_torch.models import markov

    def opened(name):
        raise AssertionError(f"span {name!r} recorded with no recording open")

    monkeypatch.setattr(markov, "_PAR_CHUNK", 64)
    monkeypatch.setattr(profiling, "_On", opened)
    _markov_value_and_grad(1000)
    assert profiling._REC is None and not profiling._STACK


def test_the_markov_outputs_are_bitwise_the_same_recording_or_not(monkeypatch):
    from abstractgps_tpu_torch.models import markov

    monkeypatch.setattr(markov, "_PAR_CHUNK", 64)
    off = _markov_value_and_grad(1000)
    with profiling.recording():
        on = _markov_value_and_grad(1000)
    assert torch.equal(off[0], on[0])
    assert all(torch.equal(a, b) for a, b in zip(off[1], on[1]))
