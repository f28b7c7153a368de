"""Milliseconds per step in the train step (`make_cog_train_step`: the
DiT's forward and backward with every layer recomputed, the loss, clip
and AdamW on the masters, the copy back), CUDA events around the injected
step_fn, summed over the window over its steps."""


def read(r):
    vals = r.get('step_ms') or []
    return sum(vals) / len(vals) if vals else None
