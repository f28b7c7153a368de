"""Device seconds per clip inside the UNet + ControlNet calls (the
program's `unet.call` spans) and outside every kernel launcher's span
(`kernel.*`): cuBLAS and cuDNN products and every eager PyTorch
operation of the networks."""

from benchmark.harness import spans


def read(r):
    tl = r.get('timeline')
    if tl is None or not r.get('units'):
        return None
    s = spans.device_s(tl, ('unet.call',), outside=('kernel.',))
    return None if s is None else s / r['units']
