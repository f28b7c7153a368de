"""Long-running inference daemon: the models stay resident, shape buckets
are warmed ahead of traffic, and a file-queue request loop serves clips
(counterpart of star_tpu/cli/serve.py, flag for flag, with --device added).

The reference runs one process per video (inference_sr.sh:43-53), so every
clip pays the model build and the card's first launches. Here the process
stays resident: the kernels are built once, `--warm FxHxW` runs one clip of
each bucket before the first request, and every request after that runs
warm.

Protocol (a filesystem queue, driven from a shell or cron and testable
without sockets; cli/web.py puts HTTP in front of it):
  * drop `<name>.json` into --queue_dir:
      {"input_path": "...", "prompt": "...", "seed": 666,
       "output_name": "clip.mp4"}          (prompt/seed/output optional)
  * the daemon renames it to .working, runs the pipeline, writes the video
    into --save_dir, then writes `<name>.done.json` with
    {"ok": true, "output": path, "seconds": t} (or {"ok": false, "error":
    "Type: message", "seconds": t}) and removes the request file;
  * a file named `shutdown` in the queue dir stops the daemon.

    python -m star_tpu_torch.cli.serve --queue_dir q/ --save_dir out/ \
        --model_path weights/ [--warm 8x180x320]

--model_path is a directory of files written by star_tpu_torch.convert.cli
(unet.pt, vae.pt, clip.pt); when it is absent, --allow_random_weights
serves random weights with the hash tokenizer (smoke runs). It runs on the
CUDA card in bf16; --device cpu runs the plain PyTorch versions on the
host.
"""

from __future__ import annotations

import json
import os
import time
from argparse import ArgumentParser

import torch

from ..config import PipelineConfig, SamplerConfig
from ..convert.load import load_star_models
from ..data.io import load_video, save_video
from ..pipeline.build import build_pipeline, init_random_models
from ..utils.device import resolve_device
from ..utils.logger import get_logger


def parse_args(argv=None):
    p = ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--queue_dir', required=True)
    p.add_argument('--save_dir', default='results')
    p.add_argument('--model_path', type=str, default='./pretrained_weight')
    p.add_argument('--upscale', type=int, default=4)
    p.add_argument('--max_chunk_len', type=int, default=32)
    p.add_argument('--cfg', type=float, default=7.5)
    p.add_argument('--solver_mode', type=str, default='fast',
                   choices=('fast', 'normal'))
    p.add_argument('--steps', type=int, default=15)
    p.add_argument('--color_fix', type=str, default='adain',
                   choices=('adain', 'wavelet', 'none'))
    p.add_argument('--poll_secs', type=float, default=1.0)
    p.add_argument('--warm', action='append', default=[],
                   help='FxHxW shape buckets to run once before serving '
                        '(e.g. 8x180x320); repeatable')
    p.add_argument('--allow_random_weights', action='store_true')
    p.add_argument('--device', type=str, default='cuda',
                   help='cuda (the default) or cpu')
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    buckets = [tuple(int(v) for v in spec.split('x')) for spec in args.warm]
    logger = get_logger()
    os.makedirs(args.queue_dir, exist_ok=True)
    os.makedirs(args.save_dir, exist_ok=True)

    dtype = torch.bfloat16
    if os.path.exists(args.model_path):
        models = load_star_models(args.model_path, dtype=dtype, device=device)
    elif args.allow_random_weights:
        logger.warning('serving with RANDOM weights (smoke mode)')
        models = init_random_models(seed=0, dtype=dtype, device=device)
    else:
        raise FileNotFoundError(args.model_path)

    steps = 15 if args.solver_mode == 'fast' else args.steps
    cfg = PipelineConfig(
        sampler=SamplerConfig(steps=steps, solver_mode=args.solver_mode,
                              guide_scale=args.cfg),
        upscale=args.upscale, max_chunk_len=args.max_chunk_len,
        color_fix=args.color_fix)
    pipe = build_pipeline(models, cfg, param_dtype=dtype,
                          allow_hash_tokenizer=args.allow_random_weights,
                          device=device)

    for f, h, w in buckets:
        logger.info('warming bucket %dx%dx%d', f, h, w)
        logger.info('warmed in %.1f s', pipe.warm(f, h, w))

    logger.info('serving: queue=%s save=%s', args.queue_dir, args.save_dir)
    serve_loop(pipe, args.queue_dir, args.save_dir, args.poll_secs)


def serve_loop(pipe, queue_dir: str, save_dir: str, poll_secs: float = 1.0,
               load=None, save=None) -> None:
    """Blocking request loop; see the module docstring for the protocol.
    load(input_path) -> (frames [F, H, W, 3] uint8, fps) and
    save(frames, save_dir, name, fps=fps) -> the output's path default to
    data/io's load_video and save_video."""
    load = load or load_video
    save = save or save_video
    logger = get_logger()
    while True:
        if os.path.exists(os.path.join(queue_dir, 'shutdown')):
            os.remove(os.path.join(queue_dir, 'shutdown'))
            logger.info('shutdown requested')
            return
        reqs = sorted(f for f in os.listdir(queue_dir)
                      if f.endswith('.json') and '.done.' not in f
                      and not f.endswith('.working'))
        if not reqs:
            time.sleep(poll_secs)
            continue
        name = reqs[0]
        path = os.path.join(queue_dir, name)
        working = path + '.working'
        try:
            os.rename(path, working)
        except OSError:
            continue                     # raced with another consumer
        t0 = time.time()
        done_path = os.path.join(queue_dir, name[:-5] + '.done.json')
        try:
            with open(working) as f:
                req = json.load(f)
            frames, fps = load(req['input_path'])
            out = pipe.enhance_a_video(
                frames, req.get('prompt', 'a good video'),
                seed=int(req.get('seed', 666)))
            out_name = req.get('output_name',
                               os.path.basename(req['input_path']))
            saved = save(out, save_dir, out_name, fps=fps)
            result = {'ok': True, 'output': saved,
                      'seconds': round(time.time() - t0, 3)}
            logger.info('done %s in %.1fs -> %s', name, result['seconds'],
                        saved)
        except Exception as e:  # noqa: BLE001 — the daemon outlives a job
            logger.exception('request %s failed', name)
            result = {'ok': False, 'error': f'{type(e).__name__}: {e}',
                      'seconds': round(time.time() - t0, 3)}
        with open(done_path, 'w') as f:
            json.dump(result, f)
        os.remove(working)


if __name__ == '__main__':
    main()
