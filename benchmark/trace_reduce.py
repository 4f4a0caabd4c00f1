"""Reduce a JAX profiler trace of the measured window to the numbers the
per-layer readers use.

The trace is the ``.xplane.pb`` that ``jax.profiler`` writes; it is read
with ``jax.profiler.ProfileData`` alone.  The window is the harness's
own host span ``bench:window``.  Device planes are ``/device:GPU:<i>``;
on them, the operations are the events of the stream lines (the lines
XLA derives from them, such as "XLA Ops" or "XLA Modules", repeat the
same time and are left out).  Everything is clipped to the window.

- busy time of a device: the length of the union of its operations'
  intervals; idle share: 1 - busy / window, averaged over the devices;
- time by operation name: summed durations, over all devices;
- the union of the operations whose name passes a test (a kernel), so
  that the busy time outside it is busy minus that union;
- idle gaps: the stretches of the window in which a device runs nothing,
  each labelled by the innermost harness span (``bench:*``) open on the
  host at its midpoint and the innermost host event inside that span.
"""

from __future__ import annotations

import bisect
import glob
import os
from dataclasses import dataclass, field

WINDOW_SPAN = "bench:window"
SPAN_PREFIX = "bench:"
DEVICE_PREFIX = "/device:GPU:"
DERIVED_LINES = ("XLA Modules", "XLA Ops", "XLA TraceMe", "Steps",
                 "Framework Name Scope", "Framework Ops", "Source code",
                 "Launch Stats", "Async XLA Ops")


def union(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def length(intervals) -> float:
    return float(sum(e - s for s, e in intervals))


def complement(intervals, lo, hi):
    """Gaps of a sorted disjoint union inside [lo, hi]."""
    gaps, t = [], lo
    for s, e in intervals:
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        gaps.append((t, hi))
    return [(s, e) for s, e in gaps if e > s]


@dataclass
class Reduced:
    """A window of trace, reduced.  Times in seconds."""
    window_s: float
    devices: int
    #: per device: the sorted union of its operation intervals (ns)
    busy_union: list = field(default_factory=list)
    #: per device: every operation as (start_ns, end_ns, name)
    ops: list = field(default_factory=list)
    #: harness spans on the host as (start_ns, end_ns, name, thread)
    spans: list = field(default_factory=list)
    #: other host events by thread: (starts, ends, names), by start
    host: dict = field(default_factory=dict)
    window_ns: tuple = (0.0, 0.0)

    @property
    def busy_s(self) -> float:
        """Device busy seconds, averaged over the devices."""
        return sum(length(u) for u in self.busy_union) / \
            max(self.devices, 1) / 1e9

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def op_seconds(self, test=lambda name: True) -> float:
        """Summed durations of the operations whose name passes ``test``,
        over all devices."""
        return sum(e - s for dev in self.ops for s, e, name in dev
                   if test(name)) / 1e9

    def union_seconds(self, test) -> float:
        """Length of the union of the operations passing ``test``,
        averaged over the devices."""
        return sum(length(union([(s, e) for s, e, name in dev
                                  if test(name)]))
                   for dev in self.ops) / max(self.devices, 1) / 1e9

    def top_ops(self, k: int = 10):
        """[[name, seconds]] of the k operation names with the most time,
        summed over all devices."""
        tot = {}
        for dev in self.ops:
            for s, e, name in dev:
                tot[name] = tot.get(name, 0.0) + (e - s) / 1e9
        return [[n, t] for n, t in
                sorted(tot.items(), key=lambda kv: -kv[1])[:k]]

    def label_at(self, t) -> str:
        """Innermost harness span open at host time ``t``, and the
        innermost other host event inside it on the same thread."""
        spans = [h for h in self.spans if h[0] <= t < h[1]]
        if not spans:
            return "outside harness spans"
        span = max(spans, key=lambda h: h[0])
        starts, ends, names = self.host.get(span[3], ([], [], []))
        # events nest, so the latest-starting one that still covers t
        # is the innermost
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and starts[i] >= span[0]:
            if ends[i] > t:
                return span[2] + " > " + names[i]
            i -= 1
        return span[2]

    def idle_gaps(self, k: int = 10):
        """[[label, seconds]]: idle time of the devices (averaged over
        them) grouped by what the host was doing, the k largest."""
        tot = {}
        lo, hi = self.window_ns
        for u in self.busy_union:
            for s, e in complement(u, lo, hi):
                lab = self.label_at(0.5 * (s + e))
                tot[lab] = tot.get(lab, 0.0) + (e - s) / 1e9 / self.devices
        return [[n, t] for n, t in
                sorted(tot.items(), key=lambda kv: -kv[1])[:k]]


def _op_lines(plane):
    lines = list(plane.lines)
    streams = [l for l in lines if l.name.startswith("Stream")]
    return streams or [l for l in lines if l.name not in DERIVED_LINES]


def reduce_profile(profile, devices: int | None = None) -> Reduced:
    """Reduce a ``jax.profiler.ProfileData`` to the window's numbers.
    ``devices``: how many device planes to read (the first ones)."""
    planes = list(profile.planes)
    spans, host = [], {}
    for plane in planes:
        if not plane.name.startswith("/host:"):
            continue
        for line in plane.lines:
            evs = sorted((ev.start_ns, ev.start_ns + ev.duration_ns, ev.name)
                         for ev in line.events)
            spans += [(s, e, n, line.name) for s, e, n in evs
                      if n.startswith(SPAN_PREFIX)]
            rest = [x for x in evs if not x[2].startswith(SPAN_PREFIX)]
            host[line.name] = ([x[0] for x in rest], [x[1] for x in rest],
                               [x[2] for x in rest])
    window = next(((s, e) for s, e, n, _ in spans if n == WINDOW_SPAN),
                  None)
    if window is None:
        raise ValueError(f"no {WINDOW_SPAN!r} span in the trace")
    lo, hi = window
    dev_planes = sorted((p for p in planes
                         if p.name.startswith(DEVICE_PREFIX)),
                        key=lambda p: int(p.name[len(DEVICE_PREFIX):]
                                          .split()[0] or 0))
    if devices is not None:
        dev_planes = dev_planes[:devices]
    ops, unions = [], []
    for plane in dev_planes:
        dev = []
        for line in _op_lines(plane):
            for ev in line.events:
                s = max(ev.start_ns, lo)
                e = min(ev.start_ns + ev.duration_ns, hi)
                if e > s:
                    dev.append((s, e, ev.name))
        ops.append(dev)
        unions.append(union([(s, e) for s, e, _ in dev]))
    return Reduced(window_s=(hi - lo) / 1e9, devices=len(dev_planes),
                   busy_union=unions, ops=ops, spans=spans, host=host,
                   window_ns=window)


def find_xplane(trace_dir: str) -> str:
    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    return max(paths, key=os.path.getmtime)


def load(path: str):
    """ProfileData of an ``.xplane.pb`` file, gzip-compressed or not."""
    import gzip
    from jax.profiler import ProfileData
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\x1f\x8b":
        data = gzip.decompress(data)
    return ProfileData.from_serialized_xspace(data)


def reduce_dir(trace_dir: str, devices: int | None = None) -> Reduced:
    return reduce_profile(load(find_xplane(trace_dir)), devices)
