"""Time chip_smoke.py's I2VGen clip (phase 3) in one process per arm, to
compare two checkouts, or two prefixes of phase 2b, within one call.

    python3 chip_clip_ab.py [--root DIR] [--cog-train on|off|imports]
                            [--clips N] [--label NAME] [--out FILE]

Runs DIR's chip_smoke.py (default: the one beside this script) with DIR's
star_tpu_torch as chip_smoke.main does up to the clip, without the kernel
checks of phase 2: builds the kernels, runs phase 2b's small-width checks
(the UNet+ControlNet and VAE, the small train step, the small Cog DiT and
causal VAE) and then, by --cog-train, the small Cog train step (`on`),
nothing (`off`), or only what that step imports: a non-reentrant
torch.utils.checkpoint on the host and train.cog_trainer (`imports`).
Then phase 3 (run_pipeline: the full-width models through the converter,
inference_sr's job loop on 8 frames of 180x320) and N - 1 more clips on
its pipeline. Around each clip it records the wall seconds, the stages,
the device time of the UNet calls (CUDA events at each call's start and
end), the Python garbage collector's collections and milliseconds by
generation, the objects it tracks and the modules loaded before the
clip, the allocator's cudaMalloc/cudaFree calls, the process's CPU
seconds, the host's load average and threads, and the card's clock,
power and temperature. Prints one JSON line, and appends it to --out.
Run arms in an interleaved order (a b b a ...) in one call.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import threading
import time


def threads() -> int:
    with open('/proc/self/status') as f:
        for line in f:
            if line.startswith('Threads:'):
                return int(line.split()[1])
    return -1


class GcClock:
    """Collections and milliseconds by generation while `on`."""

    def __init__(self):
        self.on = False
        self.t0 = 0.0
        self.ms = [0.0, 0.0, 0.0]
        self.n = [0, 0, 0]
        gc.callbacks.append(self)

    def __call__(self, phase, info):
        if not self.on:
            return
        if phase == 'start':
            self.t0 = time.perf_counter()
        else:
            g = info['generation']
            self.ms[g] += (time.perf_counter() - self.t0) * 1e3
            self.n[g] += 1

    def reset(self):
        self.ms, self.n = [0.0, 0.0, 0.0], [0, 0, 0]


def imports_only():
    """What the small Cog train step imports, without its card work: the
    port's Cog trainer and a non-reentrant checkpoint on the host."""
    import torch
    from torch.utils.checkpoint import checkpoint
    import star_tpu_torch.train.cog_trainer  # noqa: F401
    x = torch.ones(4, requires_grad=True)
    checkpoint(lambda t: (t * 2).sum(), x, use_reentrant=False).backward()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--root', default=os.path.dirname(
        os.path.abspath(__file__)))
    ap.add_argument('--cog-train', choices=('on', 'off', 'imports'),
                    default='on')
    ap.add_argument('--clips', type=int, default=3)
    ap.add_argument('--label', default='')
    ap.add_argument('--out', default='')
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('chip_clip_ab: no CUDA device', file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    from star_tpu_torch.cli import inference_sr
    from star_tpu_torch.ops import _build
    assert os.path.dirname(os.path.abspath(cs.__file__)) == root
    assert os.path.dirname(os.path.abspath(_build.__file__)).startswith(root)

    dev = torch.device('cuda', 0)
    card = cs.card_line()
    _build.build()
    _build.lib()
    cs.check_small_models(dev)
    cs.check_small_train(dev)
    cs.check_small_cog(dev)
    if args.cog_train == 'on':
        cs.check_small_cog_train(dev)
    elif args.cog_train == 'imports':
        imports_only()

    clock = GcClock()
    clips = []
    run_jobs = inference_sr.run_jobs

    def measured(pipe, *a, **k):
        unet = pipe.models.unet
        ev = []

        def mark(*_):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            ev.append(e)
        pre = unet.register_forward_pre_hook(mark)
        hook = unet.register_forward_hook(mark)
        rec = dict(modules=len(sys.modules), gc_objects=len(gc.get_objects()),
                   gc_count=list(gc.get_count()),
                   load=list(os.getloadavg()), threads=threads(),
                   py_threads=threading.active_count(),
                   card_before=cs.gpu_state())
        s0 = torch.cuda.memory_stats(dev)
        clock.reset()
        clock.on = True
        c0 = time.process_time()
        t0 = time.perf_counter()
        try:
            return run_jobs(pipe, *a, **k)
        finally:
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            cpu = time.process_time() - c0
            clock.on = False
            pre.remove()
            hook.remove()
            s1 = torch.cuda.memory_stats(dev)
            unet_ms = [s.elapsed_time(e) for s, e in zip(ev[::2], ev[1::2])]
            rec.update(
                wall_s=wall, cpu_s=cpu, stages=dict(pipe.stage_seconds),
                unet_calls=len(unet_ms), unet_ms=unet_ms,
                unet_device_s=sum(unet_ms) / 1e3,
                gc_ms=clock.ms, gc_n=clock.n,
                cuda_malloc=s1['num_device_alloc'] - s0['num_device_alloc'],
                cuda_free=s1['num_device_free'] - s0['num_device_free'],
                alloc_retries=s1['num_alloc_retries']
                - s0['num_alloc_retries'],
                card_after=cs.gpu_state())
            clips.append(rec)
    inference_sr.run_jobs = measured
    run = cs.run_pipeline(dev)
    # run_pipeline's input clip
    videos = cs.MemoryVideos(clip=np.random.RandomState(0).uniform(
        0, 255, (8, 180, 320, 3)).astype(np.uint8))
    for _ in range(args.clips - 1):
        inference_sr.run_jobs(run['pipe'], [('clip', 'a good video',
                                             'clip.mp4')],
                              videos.load, videos.save, seed=666)
    res = dict(label=args.label, root=root, cog_train=args.cog_train,
               card=card, clip_s=run['clip_s'], clips=clips)
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, 'a') as f:
            f.write(line + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
