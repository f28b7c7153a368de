"""The traced run's device timeline: torch.profiler's raw events reduced
to device busy time, idle gaps labelled by what the host was doing, and
device time by kernel name.

The reduction works on plain records (name, start_s, end_s) so that the
CPU tests can hold it without a card."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Timeline:
    """device: every device activity (kernels, copies, sets); host: host
    events (operators and the harness's spans); window: the traced
    window's (start, end); all in seconds on one clock."""
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    window: tuple = (0.0, 0.0)
    ranges: list = field(default_factory=list)   # host ranges as the
    # device's timeline shows them (the span of their kernels)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


def from_profiler(prof, window: tuple[float, float] | None = None
                  ) -> Timeline:
    """A Timeline from a finished torch.profiler.profile. `window` is
    (start, end) in the profiler's clock; by default the span of the
    host event named 'window'."""
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() * 1e-9
        rec = (e.name(), start, start + e.duration_ns() * 1e-9)
        (host if str(e.device_type()).endswith('CPU') else device).append(rec)
    # a host range (record_function) shows on the device's timeline too,
    # under its own name, spanning the kernels launched inside it; kernels,
    # copies and sets are named otherwise
    names = {h[0] for h in host}
    ranges = [d for d in device if d[0] in names]
    device = [d for d in device if d[0] not in names]
    if window is None:
        spans = [h for h in host if h[0] == 'window']
        window = (spans[0][1], spans[0][2]) if spans else (
            min(r[1] for r in device + host),
            max(r[2] for r in device + host))
    return Timeline(device, host, window, ranges)


def merged(intervals) -> list[tuple[float, float]]:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def clipped(tl: Timeline):
    lo, hi = tl.window
    return [(max(s, lo), min(e, hi)) for _, s, e in tl.device
            if e > lo and s < hi]


def busy_s(tl: Timeline) -> float:
    """Seconds of the window in which some device activity ran."""
    return sum(e - s for s, e in merged(clipped(tl)))


def idle_gaps(tl: Timeline, top: int = 10) -> list[list]:
    """The longest stretches of the window with nothing on the device,
    each named by the innermost host event running at its middle (and
    the outermost one, when they differ)."""
    lo, hi = tl.window
    busy = merged(clipped(tl))
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for s, e in gaps[:top]:
        mid = 0.5 * (s + e)
        over = [h for h in tl.host if h[1] <= mid <= h[2]]
        if over:
            inner = min(over, key=lambda h: h[2] - h[1])[0]
            outer = max(over, key=lambda h: h[2] - h[1])[0]
            label = inner if inner == outer else f'{inner} in {outer}'
        else:
            label = 'no host event'
        out.append([label, e - s])
    return out


def device_time_by_name(tl: Timeline) -> dict[str, float]:
    lo, hi = tl.window
    out: dict[str, float] = {}
    for name, s, e in tl.device:
        if e > lo and s < hi:
            out[name] = out.get(name, 0.0) + min(e, hi) - max(s, lo)
    return out


def kernel_seconds(tl: Timeline, key: str) -> tuple[float, int]:
    """Device seconds and count of the activities whose name holds
    `key`, inside the window."""
    lo, hi = tl.window
    total, n = 0.0, 0
    for name, s, e in tl.device:
        if key in name and e > lo and s < hi:
            total += min(e, hi) - max(s, lo)
            n += 1
    return total, n


def top_ops(tl: Timeline, top: int = 10) -> list[list]:
    by = device_time_by_name(tl)
    names = sorted(by, key=lambda k: -by[k])[:top]
    return [[n[:160], by[n]] for n in names]


def seconds_in_ranges(tl: Timeline, range_name: str) -> tuple[float, int]:
    """Device seconds of the activities that run inside the device-side
    spans of the host ranges named `range_name`, and the ranges' count."""
    spans = merged((s, e) for n, s, e in tl.ranges if n == range_name)
    n = sum(1 for r in tl.ranges if r[0] == range_name)
    if not spans:
        return 0.0, 0
    total, j = 0.0, 0
    for _, s, e in sorted(tl.device, key=lambda r: r[1]):
        while j < len(spans) and spans[j][1] <= s:
            j += 1
        if j < len(spans) and spans[j][0] <= s and e <= spans[j][1]:
            total += e - s
    return total, n
