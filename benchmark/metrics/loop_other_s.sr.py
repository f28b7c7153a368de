"""Seconds per clip of the job loop outside the pipeline's stages: each
clip's share of the window (its start to the next clip's start, the last
to its save) less the stage seconds the pipeline timed (prefetch hand-off,
pinned copy, save, glue between stages)."""


def read(r):
    clips = r.get('clips') or []
    if not clips or not all(c['stages'] for c in clips):
        return None
    ends = [c['start'] for c in clips[1:]] + [r['saved_at'][-1]]
    other = [e - c['start'] - sum(c['stages'].values())
             for c, e in zip(clips, ends)]
    return sum(other) / len(other)
