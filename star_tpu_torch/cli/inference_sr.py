"""CLI entry of the I2VGen-XL video super-resolution (counterpart of
star_tpu/cli/inference_sr.py, flag for flag, with --device added; the
reference: video_super_resolution/scripts/inference_sr.py:87-102).

    python -m star_tpu_torch.cli.inference_sr --input_path in.mp4 \
        --model_path weights/ --prompt "a good video" --upscale 4

--model_path is a directory of files written by star_tpu_torch.convert.cli
(unet.pt, vae.pt, clip.pt); when it is absent, --allow_random_weights runs
the full pipeline with random weights (smoke and timing runs; the output is
noise). It runs on the CUDA card; --device cpu runs the plain PyTorch
versions on the host.
"""

from __future__ import annotations

import glob
import os
from argparse import ArgumentParser
from contextlib import nullcontext

import torch

from ..config import PipelineConfig, SamplerConfig
from ..convert.load import load_star_models
from ..data.io import load_video, save_video
from ..data.prefetch import PrefetchIterator
from ..pipeline.build import build_pipeline, init_random_models
from ..utils.device import resolve_device
from ..utils.logger import get_logger
from ..utils.profiling import annotate, gc_spans, trace


def parse_args(argv=None):
    p = ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--input_path', type=str, default=None,
                   help='input video path (single-video mode)')
    p.add_argument('--input_dir', type=str, default=None,
                   help='directory of *.mp4 (batch mode, like '
                        'inference_sr.sh pairing videos with prompt lines)')
    p.add_argument('--prompt_file', type=str, default=None,
                   help='one prompt per line, paired with sorted videos '
                        '(batch mode; count must match)')
    p.add_argument('--save_dir', type=str, default='results')
    p.add_argument('--file_name', type=str, default=None)
    p.add_argument('--model_path', type=str, default='./pretrained_weight')
    p.add_argument('--prompt', type=str, default='a good video')
    p.add_argument('--upscale', type=int, default=4)
    p.add_argument('--max_chunk_len', type=int, default=32)
    p.add_argument('--cfg', type=float, default=7.5)
    p.add_argument('--solver_mode', type=str, default='fast',
                   choices=('fast', 'normal'))
    p.add_argument('--steps', type=int, default=15)
    p.add_argument('--seed', type=int, default=666)
    p.add_argument('--color_fix', type=str, default='adain',
                   choices=('adain', 'wavelet', 'none'))
    p.add_argument('--dtype', type=str, default='bfloat16',
                   choices=('bfloat16', 'float32'),
                   help='float32 only with --device cpu: the CUDA kernels '
                   'take bf16')
    p.add_argument('--allow_random_weights', action='store_true')
    p.add_argument('--device', type=str, default='cuda',
                   help='cuda (the default) or cpu')
    p.add_argument('--trace_dir', type=str, default=None,
                   help='profile the job loop and write its Chrome trace '
                        '(spans, operators, kernels) to DIR/trace.json')
    return p.parse_args(argv)


def make_jobs(args) -> list[tuple[str, str, str]]:
    """(video path, prompt, output name) for each video, checked before any
    model is built (inference_sr.sh:27-30 asserts that the video and
    prompt counts agree up front)."""
    if args.input_dir:
        videos = sorted(glob.glob(os.path.join(args.input_dir, '*.mp4')))
        if not videos:
            raise FileNotFoundError(f'no *.mp4 under {args.input_dir}')
        if args.prompt_file:
            with open(args.prompt_file) as f:
                prompts = [ln.strip() for ln in f if ln.strip()]
            if len(prompts) != len(videos):
                raise ValueError(f'{len(videos)} videos but {len(prompts)} '
                                 'prompts')
        else:
            prompts = [args.prompt] * len(videos)
    else:
        if not args.input_path:
            raise ValueError('pass --input_path or --input_dir')
        videos, prompts = [args.input_path], [args.prompt]
    for video_path in videos:
        if not os.path.exists(video_path):
            raise FileNotFoundError(video_path)
    return [(v, p, args.file_name if len(videos) == 1 and args.file_name
             else os.path.basename(v)) for v, p in zip(videos, prompts)]


def run_jobs(pipe, jobs, load, save, seed: int = 666) -> list:
    """Enhance each job's clip; returns what `save` returned for each.

    jobs: (source, prompt, name); load(source) -> (frames [F, H, W, 3]
    uint8, fps); save(frames, name, fps). Three stages overlap: a prefetch
    thread loads clip N+1 while the card runs clip N, and clip N-1 is
    saved only after clip N is queued (the reference runs one process per
    video, inference_sr.sh:43-53). Each output is copied into pinned host
    memory behind its clip, so saving it waits for that copy only."""
    logger = get_logger()

    def fetch(job):
        source, prompt, name = job
        return (source, prompt, name) + tuple(load(source))

    def flush(pending):
        host, done, name, fps = pending
        if done is not None:
            with annotate('jobs.wait_output'):
                done.synchronize()
        with annotate('jobs.save'):
            path = save(host.numpy(), name, fps)
        logger.info('saved %s', path)
        saved.append(path)

    saved, pending = [], None
    loaded = PrefetchIterator((fetch(j) for j in jobs), depth=2)
    try:
        with gc_spans():
            while True:
                with annotate('jobs.wait_input'):
                    item = next(loaded, None)
                if item is None:
                    break
                source, prompt, name, frames, fps = item
                logger.info('input %s: %s frames @ %.2f fps, %sx%s', source,
                            frames.shape[0], fps, frames.shape[1],
                            frames.shape[2])
                out = pipe.enhance_a_video_async(frames, prompt, seed=seed)
                with annotate('jobs.to_host'):
                    host, done = out.to('cpu', non_blocking=True), None
                    if out.is_cuda:
                        done = torch.cuda.Event()
                        done.record()
                if pending is not None:
                    flush(pending)
                pending = (host, done, name, fps)
            if pending is not None:
                flush(pending)
    finally:
        loaded.close()
    return saved


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.dtype == 'float32' and device.type == 'cuda':
        raise ValueError(
            '--dtype float32 runs only with --device cpu: the CUDA kernels '
            '(flash attention, the fused convs and norms) take bf16 tensors '
            'only')
    logger = get_logger()
    steps = 15 if args.solver_mode == 'fast' else args.steps
    jobs = make_jobs(args)

    dtype = torch.bfloat16 if args.dtype == 'bfloat16' else torch.float32
    if os.path.exists(args.model_path):
        models = load_star_models(args.model_path, dtype=dtype, device=device)
    elif args.allow_random_weights:
        logger.warning('model_path %s not found; using RANDOM weights '
                       '(--allow_random_weights)', args.model_path)
        models = init_random_models(seed=0, dtype=dtype, device=device)
    else:
        raise FileNotFoundError(
            f'{args.model_path} not found; pass --allow_random_weights for a '
            'smoke run or convert checkpoints with star_tpu_torch.convert.cli')

    cfg = PipelineConfig(
        sampler=SamplerConfig(steps=steps, solver_mode=args.solver_mode,
                              guide_scale=args.cfg),
        upscale=args.upscale, max_chunk_len=args.max_chunk_len,
        color_fix=args.color_fix)
    pipe = build_pipeline(models, cfg, param_dtype=dtype,
                          allow_hash_tokenizer=args.allow_random_weights,
                          device=device)
    with trace(args.trace_dir) if args.trace_dir else nullcontext():
        return run_jobs(pipe, jobs, load_video,
                        lambda frames, name, fps: save_video(
                            frames, args.save_dir, name, fps=fps), args.seed)


if __name__ == '__main__':
    main()
