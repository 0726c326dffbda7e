"""The port's tracer (``bwtb3m_tpu_torch/util/trace.py``) and the spans
the program records through it.

Nesting (parent, root, self time), durations on the monotonic clock,
the ring's bound, two threads at once, the ``bwtb3m::`` annotation only
under a profiler and on the profiler's clock, and the spans of
``compute_ssa``, ``all_ham_dna`` (and its closing log line) and
``Phases``.  CPU only.
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from bwtb3m_tpu_torch.util import trace

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _window(fn):
    """(records of the default tracer that ``fn()`` made, its result)."""
    lo = time.time_ns()
    out = fn()
    return trace.records(lo, time.time_ns()), out


def _by_name(recs):
    got = {}
    for r in recs:
        got.setdefault(r.name, []).append(r)
    return got


def test_nesting_gives_parent_root_and_self_time():
    t = trace.Tracer()
    with t.span("a", k=1) as a:
        time.sleep(0.002)
        with t.span("b") as b:
            time.sleep(0.003)
            with t.span("c") as c:
                time.sleep(0.001)
        with t.span("d") as d:
            time.sleep(0.002)
    with t.span("e") as e:
        pass
    assert (a.parent, a.root, a.attrs) == (None, a.id, {"k": 1})
    assert (b.parent, b.root) == (a.id, a.id)
    assert (c.parent, c.root) == (b.id, a.id)
    assert (d.parent, d.root) == (a.id, a.id)
    assert (e.parent, e.root) == (None, e.id)
    assert [r.name for r in t.records()] == ["c", "b", "d", "a", "e"]
    assert t.self_ns(a) == a.ns - b.ns - d.ns
    assert t.self_ns(b) == b.ns - c.ns
    assert t.self_ns(c) == c.ns
    assert a.start_ns <= b.start_ns < c.start_ns <= c.end_ns <= b.end_ns \
        <= d.start_ns < d.end_ns <= a.end_ns
    assert t.self_ns(a) >= 2e6 and a.seconds == pytest.approx(a.ns / 1e9)
    assert t.records(b.start_ns, b.end_ns) == [c, b]


def test_a_step_of_the_wall_clock_does_not_bend_a_duration(monkeypatch):
    t = trace.Tracer()
    wall = iter([5 * 10**18, 5 * 10**18 - 10**9])    # one second back
    monkeypatch.setattr(trace.time, "time_ns", lambda: next(wall))
    with t.span("x") as x:
        time.sleep(0.002)
    assert x.end_ns - x.start_ns == -10**9
    assert 2e6 <= x.ns < 1e9 and x.seconds == pytest.approx(x.ns / 1e9)


def test_span_closes_on_an_exception():
    t = trace.Tracer()
    with pytest.raises(ValueError):
        with t.span("outer"):
            with t.span("inner"):
                raise ValueError("x")
    with t.span("next") as nxt:
        pass
    assert [r.name for r in t.records()] == ["inner", "outer", "next"]
    assert nxt.parent is None


def test_ring_keeps_the_newest_and_counts_the_dropped():
    t = trace.Tracer(ring=8)
    for i in range(20):
        with t.span("s", i=i):
            pass
    recs = t.records()
    assert [r.attrs["i"] for r in recs] == list(range(12, 20))
    assert recs[0].id - 1 == 12         # the 12 oldest were pushed out
    assert trace.RING == 65536 and trace.TRACER._ring.maxlen == trace.RING


def test_two_threads_keep_their_own_stacks():
    t = trace.Tracer()
    rounds = 2000
    start = threading.Barrier(2)
    interval = sys.getswitchinterval()

    def work(tag):
        start.wait(timeout=30)
        for _ in range(rounds):
            with t.span("outer", tag=tag):
                with t.span("inner", tag=tag):
                    pass

    threads = [threading.Thread(target=work, args=(tag,))
               for tag in ("x", "y")]
    sys.setswitchinterval(1e-6)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    recs = t.records()
    by_id = {r.id: r for r in recs}
    assert len(recs) == 4 * rounds == len(by_id)
    for r in recs:
        if r.name == "inner":
            parent = by_id[r.parent]
            assert parent.name == "outer"
            assert parent.attrs["tag"] == r.attrs["tag"]
            assert r.root == parent.id
        else:
            assert r.parent is None and r.root == r.id
    assert sum(r.name == "inner" for r in recs) == 2 * rounds
    for tag in ("x", "y"):
        assert sum(r.attrs["tag"] == tag for r in recs) == 2 * rounds


def test_annotation_only_under_a_profiler(monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def spy(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    t = trace.Tracer()
    with t.span("quiet"):
        pass
    assert opened == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with t.span("loud"):
            pass
    assert opened == ["bwtb3m::loud"]
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert "bwtb3m::loud" in names


def test_spans_share_the_profilers_clock():
    t = trace.Tracer()
    spans = []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i in range(5):
            with t.span("clock.%d" % i) as s:
                time.sleep(0.003)
                with t.span("clock.inner.%d" % i) as inner:
                    time.sleep(0.001)
            spans += [s, inner]
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    for s in spans:
        ev = events[trace.PREFIX + s.name]
        assert abs(s.start_ns - ev.start_ns()) <= 2_000_000, s
        assert abs(s.end_ns - ev.end_ns()) <= 2_000_000, s


def _pacterm_build(tmp_path, n, bwt_only, sa_rate=32, seed=5):
    from bwtb3m_tpu_torch.engine.api import compute_bwt
    from bwtb3m_tpu_torch.engine.options import BwtOptions
    from bwtb3m_tpu_torch.io.pac import write_pac
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n, dtype=np.int32)
    pac = str(tmp_path / "g.pac")
    write_pac(pac, codes)
    recs, res = _window(lambda: compute_bwt(BwtOptions(
        input_path=pac, input_type="pacterm", bwt_only=bwt_only,
        sa_sampling_rate=sa_rate, isa_sampling_rate=sa_rate, verbose=0,
        device="cpu")))
    roots = [r for r in recs if r.name == "engine.build"]
    assert len(roots) == 1 and roots[0].parent is None
    assert all(r.root == roots[0].id for r in recs)
    return codes, res


def test_compute_ssa_records_the_rank_rows_steps(tmp_path, monkeypatch):
    from bwtb3m_tpu_torch.engine.result import BwtResult, clear_caches
    from bwtb3m_tpu_torch.engine.ssa import compute_ssa
    _codes, res = _pacterm_build(tmp_path, 400_000, bwt_only=True)
    compute_ssa(res.bwt_path, 32, 32, device="cpu")   # imports, first use
    clear_caches()
    walls = []
    real = BwtResult.load_focc

    def timed(self, *a, **kw):
        t0 = time.time_ns()
        try:
            return real(self, *a, **kw)
        finally:
            walls.append(time.time_ns() - t0)

    monkeypatch.setattr(BwtResult, "load_focc", timed)
    recs, _ = _window(lambda: compute_ssa(res.bwt_path, 32, 32,
                                          device="cpu"))
    got = _by_name(recs)
    (root,) = got["engine.ssa"]
    (walk,) = got["engine.ssa.walk"]
    assert root.parent is None and walk.parent == root.id
    rows = [got["index.rows." + k][0] for k in ("decode", "densify",
                                                "build")]
    for r in rows:
        assert r.parent == walk.id and r.root == root.id
    assert rows[0].end_ns <= rows[1].start_ns and \
        rows[1].end_ns <= rows[2].start_ns
    assert len(walls) == 1
    assert sum(r.ns for r in rows) == pytest.approx(walls[0], rel=0.05)
    assert {r.root for r in recs} == {root.id}


def test_all_ham_dna_records_its_steps(tmp_path, capsys):
    import io
    from bwtb3m_tpu_torch.apps.hamdna import READ_CHUNK, all_ham_dna
    codes, res = _pacterm_build(tmp_path, 3000, bwt_only=False, sa_rate=8)
    fa = str(tmp_path / "reads.fa")
    reads = READ_CHUNK + 5          # two chunks
    rng = np.random.default_rng(9)
    with open(fa, "w") as f:
        for i in range(reads):
            at = int(rng.integers(0, len(codes) - 30))
            f.write(">r%d\n%s\n" % (i, "".join(
                "ACGT"[c] for c in codes[at:at + 30])))
    out = io.StringIO()
    recs, rc = _window(lambda: all_ham_dna(res.bwt_path, fa, maxmis=1,
                                           out=out, device="cpu"))
    assert rc == 0 and out.getvalue().count("\n") > reads
    got = _by_name(recs)
    (root,) = got["apps.align"]
    assert root.parent is None and root.attrs == {"reads": reads}
    assert len(got["apps.load"]) == 1
    for name in ("apps.search", "apps.locate", "apps.emit"):
        assert len(got[name]) == 2, name
    for r in recs:
        assert r.root == root.id
        if r.name.startswith("apps.") and r is not root:
            assert r.parent == root.id, r
    kids = sum(r.ns for r in recs if r.parent == root.id)
    assert trace.self_ns(root) == root.ns - kids >= 0
    (line,) = [ln for ln in capsys.readouterr().err.splitlines()
               if "allHamDna: load " in ln]
    said = [float(w.rstrip("s,")) for w in line.split()
            if w[0].isdigit()]
    want = [sum(r.ns for r in got[k]) / 1e9 for k in
            ("apps.load", "apps.search", "apps.locate", "apps.emit")]
    want.append(trace.self_ns(root) / 1e9)
    assert said == pytest.approx(want, abs=6e-4)


def test_phases_line_parses_to_the_same_keys():
    sys.path.insert(0, ROOT)
    try:
        from portbench.program import parse_phases
    finally:
        sys.path.remove(ROOT)
    from bwtb3m_tpu_torch.util.phases import Phases
    phase = Phases("cpu")
    lo = time.time_ns()
    with phase("write .bwt"):
        time.sleep(0.002)
        with phase("gt bits (host)"):
            time.sleep(0.003)
    with phase("chains"):
        pass
    line = "[V] phases (wall s): %s" % json.dumps(phase.wall)
    got = parse_phases(line)
    assert got == phase.wall
    assert list(got) == ["gt bits (host)", "write .bwt", "chains"]
    spans = _by_name(trace.records(lo, time.time_ns()))
    outer, inner = spans["write .bwt"][0], spans["gt bits (host)"][0]
    assert inner.parent == outer.id
    assert got["gt bits (host)"] == pytest.approx(inner.seconds)
    assert got["write .bwt"] == pytest.approx(outer.seconds - inner.seconds)
