"""Ahead-of-time build of the port's CUDA kernels (counterpart of
star_tpu/cli/warm_cache.py, flag for flag).

The JAX package compiles the whole-clip graph of every shape bucket into a
persistent compile cache, so that a served request pays no compile. The
port has no graph compile to cache: its kernels are hand-written CUDA that
takes any shape of a bucket, built by nvcc into one shared library under
build/kernels/ of the checkout (ops/_build.py) and reused by every process
that runs from it. So warming is one build, done where nvcc is (no card is
needed); the buckets are logged for the record. First-launch costs on the
card are paid by `serve --warm FxHxW` (STARPipeline.warm).

    python -m star_tpu_torch.cli.warm_cache --frames 8,16 \
        --sizes 180x320,128x128 [--upscale 4] [--decode_window 3]

Without nvcc it raises.
"""

from __future__ import annotations

import time
from argparse import ArgumentParser

from ..ops import _build
from ..utils.logger import get_logger


def parse_args(argv=None):
    p = ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--frames', default='8',
                   help='comma list of clip lengths to warm')
    p.add_argument('--sizes', default='180x320',
                   help='comma list of input HxW buckets (pre-upscale)')
    p.add_argument('--upscale', type=int, default=4)
    p.add_argument('--decode_window', type=int, default=3)
    return p.parse_args(argv)


def main(argv=None) -> str:
    """Builds the kernel library (or finds it built from the same sources)
    and returns its path."""
    args = parse_args(argv)
    logger = get_logger()
    frames = [int(x) for x in args.frames.split(',') if x]
    sizes = [tuple(int(v) for v in s.split('x')) for s in
             args.sizes.split(',') if s]
    for f in frames:
        for h, w in sizes:
            logger.info('bucket f=%d %dx%d -> x%d, decode window %d: served '
                        'by the one kernel library', f, h, w, args.upscale,
                        args.decode_window)
    t0 = time.perf_counter()
    so = _build.build(verbose=True)
    logger.info('kernel library %s ready in %.1f s', so,
                time.perf_counter() - t0)
    return so


if __name__ == '__main__':
    main()
