"""trace_reduce.py against a small trace recorded on an H100 (two fused
characterisation calls at n = 4 inside a ``bench:window`` span), checked
by a plain sweep over its raw events."""

import os

import pytest

import trace_reduce as tr

FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "trace_n4_h100.xplane.pb.gz")


@pytest.fixture(scope="module")
def profile():
    return tr.load(FIXTURE)


def raw(profile):
    """Window and device events, read without the reducer."""
    window = None
    for plane in profile.planes:
        for line in plane.lines:
            for ev in line.events:
                if ev.name == "bench:window":
                    window = (ev.start_ns, ev.start_ns + ev.duration_ns)
    dev = [(ev.start_ns, ev.start_ns + ev.duration_ns, ev.name)
           for plane in profile.planes if plane.name == "/device:GPU:0"
           for line in plane.lines for ev in line.events]
    return window, dev


def sweep_busy(window, events):
    """Busy time by a sweep over interval edges with a depth counter."""
    lo, hi = window
    edges = []
    for s, e, _ in events:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            edges += [(s, 1), (e, -1)]
    edges.sort(key=lambda x: (x[0], -x[1]))
    busy, depth, start = 0.0, 0, None
    for t, d in edges:
        if depth == 0 and d == 1:
            start = t
        depth += d
        if depth == 0 and d == -1:
            busy += t - start
    return busy / 1e9


def test_window_and_busy_time(profile):
    red = tr.reduce_profile(profile)
    window, dev = raw(profile)
    assert red.devices == 1
    assert red.window_s == pytest.approx((window[1] - window[0]) / 1e9)
    assert red.busy_s == pytest.approx(sweep_busy(window, dev), rel=1e-12)
    assert 0 < red.busy_s < red.window_s
    assert red.idle_share == pytest.approx(1 - red.busy_s / red.window_s)


def test_kernel_time_and_union(profile):
    red = tr.reduce_profile(profile)
    window, dev = raw(profile)
    lo, hi = window
    kern = [(s, e, n) for s, e, n in dev if n == "jacobi_herm_fid_n4"]
    assert len(kern) == 2          # one kernel launch per call
    want = sum(min(e, hi) - max(s, lo) for s, e, _ in kern) / 1e9
    got = red.op_seconds(lambda n: n.startswith("jacobi_herm_fid_n4"))
    assert got == pytest.approx(want)
    assert red.union_seconds(lambda n: n.startswith("jacobi_")) == \
        pytest.approx(sweep_busy(window, kern))
    top = dict(red.top_ops(100))
    assert top["jacobi_herm_fid_n4"] == pytest.approx(want)
    assert sum(top.values()) == pytest.approx(red.op_seconds())


def test_idle_gaps_are_labelled_by_harness_spans(profile):
    red = tr.reduce_profile(profile)
    gaps = red.idle_gaps(100)
    total = sum(t for _, t in gaps)
    assert total == pytest.approx(red.window_s - red.busy_s)
    assert all(label.startswith("bench:") for label, _ in gaps)


def test_union_and_complement():
    u = tr.union([(5, 7), (0, 2), (1, 3), (6, 9)])
    assert u == [(0, 3), (5, 9)]
    assert tr.length(u) == 7
    assert tr.complement(u, -1, 10) == [(-1, 0), (3, 5), (9, 10)]


def test_missing_window_is_an_error():
    class Empty:
        planes = []
    with pytest.raises(ValueError):
        tr.reduce_profile(Empty())
