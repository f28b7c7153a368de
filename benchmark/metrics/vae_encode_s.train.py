"""Device seconds per step inside the program's `batch.vae_encode` span:
the causal VAE's encodes of gt (a posterior sample) and lq in
make_batch."""

from benchmark.harness import spans


def read(r):
    tl = r.get('timeline')
    if tl is None or not r.get('units'):
        return None
    s = spans.device_s(tl, ('batch.vae_encode',))
    return None if s is None else s / r['units']
