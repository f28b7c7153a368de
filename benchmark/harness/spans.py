"""Readings of the program's own spans (star_tpu_torch/utils/profiling.py:
`jobs.*`, `sr.*`, `sampler.step`, `unet.call`, `dit.call`, `train.*`,
`batch.*`, `kernel.K*`, `gc`) in a traced run's Timeline.

A span is named by a pattern: a name, or a prefix ending in '.' that
stands for every name under it (`kernel.` for each `kernel.K*`). On the
device's side a span is its projection (Timeline.ranges: from the first
to the last activity of the kernels launched inside it); an activity is
inside a span when its whole interval is. Each reading is None when the
run holds no span of the pattern in its window: a program without the
span reads nothing rather than 0."""

from __future__ import annotations

from bisect import bisect_right

from .trace import Timeline, merged


def matches(name: str, patterns) -> bool:
    return any(name == p or (p.endswith('.') and name.startswith(p))
               for p in patterns)


class _Union:
    """The union of intervals, for containment tests by bisection."""

    def __init__(self, intervals):
        self.spans = merged(intervals)
        self.starts = [s for s, _ in self.spans]

    def covers(self, s: float, e: float) -> bool:
        i = bisect_right(self.starts, s) - 1
        return i >= 0 and e <= self.spans[i][1]

    def holds(self, t: float) -> bool:
        return self.covers(t, t)


def _in_window(tl: Timeline, events, patterns) -> list:
    lo, hi = tl.window
    return [(s, e) for n, s, e in events
            if matches(n, patterns) and e > lo and s < hi]


def device_s(tl: Timeline, inside, outside=()) -> float | None:
    """Device seconds of the window's activities that run inside a span
    of `inside` and inside none of `outside`."""
    spans = _in_window(tl, tl.ranges, inside)
    if not spans:
        return None
    within = _Union(spans)
    without = _Union((s, e) for n, s, e in tl.ranges
                     if matches(n, outside)) if outside else None
    lo, hi = tl.window
    total = 0.0
    for _, s, e in tl.device:
        if e > lo and s < hi and within.covers(s, e) and not (
                without is not None and without.covers(s, e)):
            total += min(e, hi) - max(s, lo)
    return total


def host_s(tl: Timeline, patterns) -> float | None:
    """Host seconds of the window inside the host spans of `patterns`
    (their union: a span nested in another counts once)."""
    spans = _in_window(tl, tl.host, patterns)
    if not spans:
        return None
    lo, hi = tl.window
    return sum(min(e, hi) - max(s, lo) for s, e in merged(spans))


def idle_gaps(tl: Timeline) -> list[tuple[float, float]]:
    """Every stretch of the window with nothing on the device."""
    lo, hi = tl.window
    gaps, t = [], lo
    for s, e in merged((max(s, lo), min(e, hi)) for _, s, e in tl.device
                       if e > lo and s < hi):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def idle_outside_s(tl: Timeline, patterns) -> float | None:
    """Device-idle seconds of the window whose gap has its midpoint
    outside every host span of `patterns` (None without a device
    activity: a trace of the host alone)."""
    spans = _in_window(tl, tl.host, patterns)
    if not spans or not tl.device:
        return None
    host = _Union(spans)
    return sum(e - s for s, e in idle_gaps(tl)
               if not host.holds(0.5 * (s + e)))
