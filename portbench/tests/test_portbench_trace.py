"""What a traced run reads: the union of the device's intervals, where
the idle time went, the phases line of a build, and the annotations that
the profiler mirrors on the card's timeline."""

from __future__ import annotations

import pytest

from portbench import program, trace


@pytest.mark.parametrize("intervals,union", [
    ([], 0),
    ([(0, 10, "a")], 10),
    ([(0, 10, "a"), (5, 15, "b")], 15),
    ([(0, 10, "a"), (10, 20, "b")], 20),
    ([(20, 30, "a"), (0, 10, "b"), (2, 4, "c")], 20),
    ([(0, 100, "a"), (10, 20, "b"), (50, 60, "c")], 100),
])
def test_union_of_busy_intervals(intervals, union):
    assert trace.union_ns(intervals) == union


def test_idle_time_goes_to_the_innermost_annotation():
    dev = [(0, 10, "k"), (50, 60, "k")]
    host = [(0, 100, trace.WINDOW), (5, 40, "span::a"),
            (20, 30, "bwtb3m::b"), (40, 100, "span::c")]
    got = dict(trace.idle_gaps(dev, host, 0, 100))
    assert got == {"span::c": 50e-9, "span::a": 20e-9, "bwtb3m::b": 10e-9}


class Ev:
    def __init__(self, name, kind, start, end):
        self._n, self._k, self._s, self._e = name, kind, start, end

    def name(self):
        return self._n

    def device_type(self):
        return self._k

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e


def test_mirrored_annotations_are_no_device_work():
    evs = [Ev("void chain_kernel<true>", "DeviceType.CUDA", 10, 20),
           Ev("span::write .bwt", "DeviceType.CUDA", 0, 100),
           Ev("span::write .bwt", "DeviceType.CPU", 0, 100),
           Ev("aten::sort", "DeviceType.CPU", 5, 6),
           Ev(trace.WINDOW, "DeviceType.CPU", 0, 200)]
    dev, host = trace.split_events(evs)
    assert dev == [(10, 20, "void chain_kernel<true>")]
    assert [h[2] for h in host] == ["span::write .bwt", trace.WINDOW]
    assert trace.window_of(host) == (0, 200)


def test_top_ops_sum_by_name():
    dev = [(0, 10, "a"), (10, 40, "b"), (40, 45, "a")]
    assert trace.top_ops(dev) == [["b", 30e-9], ["a", 15e-9]]


def test_phases_line():
    line = ('[V] phases (wall s): {"block sorts": 0.9, "gt bits (host)": '
            '1.25, "write .bwt": 3.5}')
    assert program.parse_phases(line) == {"block sorts": 0.9,
                                          "gt bits (host)": 1.25,
                                          "write .bwt": 3.5}
    assert program.parse_phases("[V] write .bwt (rl) done in 3.5s") is None
    assert program.parse_phases("phases (wall s): {not json") is None


def test_span_log_keeps_spans_and_phases():
    log = program.SpanLog()
    with log.span("write .hwt (Huffman wavelet tree)"):
        pass
    with log.span("write .hwt (Huffman wavelet tree)"):
        pass
    log.v('phases (wall s): {"chains": 0.5, "anchors": 0.25}')
    assert set(log.spans) == {"write .hwt (Huffman wavelet tree)"}
    assert log.phases == {"chains": 0.5, "anchors": 0.25}
    assert program.span_seconds(log.spans, "write .hwt") >= 0
    assert program.span_seconds(log.spans, "suffix sort") is None


def test_roofline_bound_names_its_side():
    from portbench import roofline
    t, side = roofline.bound(3.35e12, 1.0)
    assert t == pytest.approx(1.0) and side == "bytes"
    t, side = roofline.bound(1.0, 67e12)
    assert t == pytest.approx(1.0) and side == "operations"
