"""Share of the traced window in which nothing ran on the device (the
union of the device activities' intervals), in percent."""

from benchmark.harness import trace


def read(r):
    tl = r.get('timeline')
    if tl is None or not tl.device or tl.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s(tl) / tl.window_s)
