"""Device seconds per clip inside the program's `kernel.K13` spans: the
GroupNorm kernel's statistics and apply launches (ops/norms._launch_stats,
_launch_apply) in the UNet, the ControlNet and the VAE. A program without
the span reads nothing."""

from benchmark.harness import spans


def read(r):
    tl = r.get('timeline')
    if tl is None or not r.get('units'):
        return None
    s = spans.device_s(tl, ('kernel.K13',))
    return None if s is None else s / r['units']
