"""Device seconds per step inside the program's `train.step` span and
outside every kernel launcher's span (`kernel.*`): the DiT's cuBLAS
products, its eager operations (K9's plain backward among them), the
loss, clip and AdamW on the masters."""

from benchmark.harness import spans


def read(r):
    tl = r.get('timeline')
    if tl is None or not r.get('units'):
        return None
    s = spans.device_s(tl, ('train.step',), outside=('kernel.',))
    return None if s is None else s / r['units']
