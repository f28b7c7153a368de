"""CLI entry of stock CogVideoX text-to-video, not SR (counterpart of
star_tpu/cli/sample_t2v.py, flag for flag, with --device added).

Behavioral reference: cogvideox-based/inference/cli_demo.py: a prompt in,
a 49-frame 480x720 clip out, 50 steps, guidance 6.

    python -m star_tpu_torch.cli.sample_t2v --prompt "a cat surfing" \
        --model_path weights_cog_t2v/ --save_dir out/

--model_path is a directory of the port's files: dit.pt (the state dict of
the stock CogVideoDiT(liem=False), written with
star_tpu_torch.convert.save_params), t5.pt and causal_vae.pt (written by
star_tpu_torch.convert.cli). When it is absent, --allow_random_weights runs
with random weights and the hash tokenizer (smoke and timing runs; the
output is noise). It runs on the CUDA card in bf16; --device cpu runs the
plain PyTorch versions on the host.
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

from ..convert.load import load_cog_models
from ..data.io import save_video
from ..models.t5.tokenizer import default_t5_tokenizer
from ..pipeline.build import init_random_cog_models
from ..pipeline.cogvideo_sr import CogModelBundle, CogSamplerConfig
from ..pipeline.cogvideo_t2v import CogVideoT2VPipeline
from ..utils.device import resolve_device
from ..utils.logger import get_logger


def parse_args(argv=None):
    p = ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--prompt', required=True)
    p.add_argument('--negative_prompt', type=str, default='')
    p.add_argument('--save_dir', type=str, default='results')
    p.add_argument('--file_name', type=str, default='t2v.mp4')
    p.add_argument('--model_path', type=str, default='./weights_cog_t2v')
    p.add_argument('--num_frames', type=int, default=49,
                   help='4k+1 with odd latent count (49 -> 13 latents)')
    p.add_argument('--num_steps', type=int, default=50)
    p.add_argument('--guider_scale', type=float, default=6.0)
    p.add_argument('--fps', type=int, default=8)
    p.add_argument('--seed', type=int, default=42)
    p.add_argument('--allow_random_weights', action='store_true')
    p.add_argument('--device', type=str, default='cuda',
                   help='cuda (the default) or cpu')
    return p.parse_args(argv)


def run_jobs(pipe, jobs, save, num_frames: int = 49, fps: int = 8) -> list:
    """Sample each job's clip; returns what `save` returned for each.
    jobs: (prompt, negative prompt, name, seed); save(frames [F, H, W, 3]
    uint8, name, fps)."""
    logger = get_logger()
    saved = []
    for prompt, negative_prompt, name, seed in jobs:
        out = pipe.sample(prompt, num_frames, negative_prompt, seed)
        path = save(out, name, fps)
        logger.info('saved %s', path)
        saved.append(path)
    return saved


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    logger = get_logger()
    # stock CogVideoX-5B: no LIEM, 16-channel input (no LQ concat)
    if os.path.exists(args.model_path):
        models = load_cog_models(args.model_path, device=device, liem=False)
    elif args.allow_random_weights:
        logger.warning('using RANDOM weights (smoke/perf run)')
        models = init_random_cog_models(seed=0, device=device, liem=False)
    else:
        raise FileNotFoundError(args.model_path)
    bundle = CogModelBundle(models.dit, models.vae, models.text,
                            default_t5_tokenizer(
                                allow_fallback=args.allow_random_weights))
    pipe = CogVideoT2VPipeline(bundle, CogSamplerConfig(
        num_steps=args.num_steps, guider_scale=args.guider_scale),
        device=device)
    return run_jobs(pipe, [(args.prompt, args.negative_prompt,
                            args.file_name, args.seed)],
                    lambda frames, name, fps: save_video(
                        frames, args.save_dir, name, fps=fps),
                    args.num_frames, args.fps)


if __name__ == '__main__':
    main()
