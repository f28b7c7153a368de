"""Device seconds per step inside the program's `batch.t5` span: the
T5-XXL encode of the step's captions in make_batch."""

from benchmark.harness import spans


def read(r):
    tl = r.get('timeline')
    if tl is None or not r.get('units'):
        return None
    s = spans.device_s(tl, ('batch.t5',))
    return None if s is None else s / r['units']
