"""Device-idle seconds per clip while the host was outside the pipeline's
stages: each stretch of the window with nothing on the card whose
midpoint falls outside every `sr.*` span of the program (the job loop's
waits, copies, saves and whatever runs between clips)."""

from benchmark.harness import spans


def read(r):
    tl = r.get('timeline')
    if tl is None or not r.get('units'):
        return None
    s = spans.idle_outside_s(tl, ('sr.',))
    return None if s is None else s / r['units']
