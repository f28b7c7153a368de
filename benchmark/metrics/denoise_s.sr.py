"""Seconds per clip in the pipeline's denoise stage (the 14 UNet +
ControlNet calls on the CFG pair and the sampler), as the pipeline times
it when its stages are timed."""


def read(r):
    vals = [c['stages'].get('denoise') for c in r.get('clips') or []]
    if not vals or None in vals:
        return None
    return sum(vals) / len(vals)
