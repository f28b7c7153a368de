"""Seconds per clip in the pipeline's VAE stages (encode and the windowed
decode), as the pipeline times them when its stages are timed."""


def read(r):
    vals = []
    for c in r.get('clips') or []:
        s = c['stages']
        if 'vae_encode' not in s or 'vae_decode' not in s:
            return None
        vals.append(s['vae_encode'] + s['vae_decode'])
    return sum(vals) / len(vals) if vals else None
