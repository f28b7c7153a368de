"""CLI entry of the CogVideoX-based video super-resolution (counterpart of
star_tpu/cli/sample_sr.py, flag for flag, with --device added).

Behavioral reference: cogvideox-based/sat/sample_sr.py + inference_sr.sh —
iterates (lq video, prompt) pairs, 720x480 inputs, 4k+1 frames, 50-step
VPSDE-DPM++2M with DynamicCFG, serial windowed decode, AdaIN.

    python -m star_tpu_torch.cli.sample_sr --input_path lq.mp4 \
        --prompt "..." --model_path weights_cog/ --save_dir out/

--model_path is a directory of files written by star_tpu_torch.convert.cli
(dit.pt, t5.pt, causal_vae.pt); when it is absent, --allow_random_weights
runs with random weights (smoke and timing runs; the output is noise). It
runs on the CUDA card in bf16; --device cpu runs the plain PyTorch
versions on the host.
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

from ..convert.load import load_cog_models
from ..data.io import load_video, save_video
from ..pipeline.build import build_cog_pipeline, init_random_cog_models
from ..pipeline.cogvideo_sr import CogSamplerConfig
from ..utils.device import resolve_device
from ..utils.logger import get_logger


def parse_args(argv=None):
    p = ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--input_path', required=True)
    p.add_argument('--prompt', type=str, default='a good video')
    p.add_argument('--save_dir', type=str, default='results')
    p.add_argument('--file_name', type=str, default=None)
    p.add_argument('--model_path', type=str, default='./weights_cog')
    p.add_argument('--sampling_num_frames', type=int, default=7,
                   help='latent frames; must be odd (yaml: 13, 11 or 9)')
    p.add_argument('--num_steps', type=int, default=50)
    p.add_argument('--guider_scale', type=float, default=6.0)
    p.add_argument('--seed', type=int, default=42)
    p.add_argument('--allow_random_weights', action='store_true')
    p.add_argument('--device', type=str, default='cuda',
                   help='cuda (the default) or cpu')
    return p.parse_args(argv)


def run_jobs(pipe, jobs, load, save, seed: int = 42,
             sampling_num_frames: int = 7) -> list:
    """Enhance each job's clip, its first 4k+1 frames for k + 1 =
    `sampling_num_frames` latent frames; returns what `save` returned for
    each. jobs: (source, prompt, name); load(source) -> (frames
    [F, H, W, 3] uint8, fps); save(frames, name, fps)."""
    logger = get_logger()
    want = (sampling_num_frames - 1) * 4 + 1
    saved = []
    for source, prompt, name in jobs:
        frames, fps = load(source)
        frames = frames[:want]
        if frames.shape[0] != want:
            raise ValueError(
                f'need {want} frames (4k+1 for {sampling_num_frames} '
                f'latents), got {frames.shape[0]}')
        logger.info('input %s frames @ %.2f fps %sx%s', frames.shape[0], fps,
                    frames.shape[1], frames.shape[2])
        out = pipe.enhance_a_video(frames, prompt, seed=seed)
        path = save(out, name, fps)
        logger.info('saved %s', path)
        saved.append(path)
    return saved


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    logger = get_logger()
    if os.path.exists(args.model_path):
        models = load_cog_models(args.model_path, device=device)
    elif args.allow_random_weights:
        logger.warning('using RANDOM weights (smoke/perf run)')
        models = init_random_cog_models(seed=0, device=device)
    else:
        raise FileNotFoundError(args.model_path)
    pipe = build_cog_pipeline(
        models, CogSamplerConfig(num_steps=args.num_steps,
                                 guider_scale=args.guider_scale),
        allow_hash_tokenizer=args.allow_random_weights, device=device)
    name = args.file_name or os.path.basename(args.input_path)
    return run_jobs(pipe, [(args.input_path, args.prompt, name)], load_video,
                    lambda frames, name, fps: save_video(
                        frames, args.save_dir, name, fps=fps),
                    args.seed, args.sampling_num_frames)


if __name__ == '__main__':
    main()
