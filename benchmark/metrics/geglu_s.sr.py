"""Device seconds per clip inside the program's `kernel.K12` spans: the
UNet's and the ControlNet's GEGLU kernel (ops/geglu._launch). A program
without the span reads nothing."""

from benchmark.harness import spans


def read(r):
    tl = r.get('timeline')
    if tl is None or not r.get('units'):
        return None
    s = spans.device_s(tl, ('kernel.K12',))
    return None if s is None else s / r['units']
