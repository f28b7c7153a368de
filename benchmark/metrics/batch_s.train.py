"""Seconds per step in the training loop's `make_batch` (the T5 encode of
the captions and the causal VAE's encodes of gt and lq), timed by the
harness, which injects make_batch, from a synchronise to a synchronise."""


def read(r):
    vals = r.get('batch_s') or []
    return sum(vals) / len(vals) if vals else None
