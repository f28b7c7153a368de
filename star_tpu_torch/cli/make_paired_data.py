"""Paired-data generation driver (counterpart of
star_tpu/cli/make_paired_data.py, flag for flag, with --device added).

Behavioral reference: utils_data/make_paired_data.py:20-103 — a CSV of
(path, text) rows; per clip: every frame_interval-th frame, the first
num_frames, a centre crop and resize to height x width, the two-stage
degradation (on the device, all frames at once), a x(scale) cubic upsample
of the LQ (jax.image.resize's Keys cubic), and the {gt, lq, text} triplet
saved. Rows are split across processes by rank striding.

    python -m star_tpu_torch.cli.make_paired_data --csv data.csv \
        --save_dir out/ --num_frames 32 --frame_interval 2 \
        --height 720 --width 1280

It runs on the CUDA card; --device cpu runs the same PyTorch ops on the
host. Decoding and encoding the videos is host work (cv2, data/io.py).
"""

from __future__ import annotations

import csv
import os
from argparse import ArgumentParser
from typing import Callable

import numpy as np
import torch

from ..data.dataset import shard_for_process
from ..data.degradation import degrade_video, resize_jax
from ..data.io import load_video, save_video
from ..utils.device import resolve_device
from ..utils.logger import get_logger


def parse_args(argv=None):
    p = ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--csv', required=True, help='csv with path,text rows')
    p.add_argument('--save_dir', required=True)
    p.add_argument('--num_frames', type=int, default=32)
    p.add_argument('--frame_interval', type=int, default=2)
    p.add_argument('--height', type=int, default=720)
    p.add_argument('--width', type=int, default=1280)
    p.add_argument('--scale', type=int, default=4)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--no_codec', action='store_true',
                   help='skip the H.264/mpeg4 re-encode stage')
    p.add_argument('--recipe', default='default',
                   choices=('default', 'mid'),
                   help="degradation recipe: 'default' = degrade_video.py, "
                        "'mid' = degrade_video_mid.py (stage-1 resize "
                        "toward final LR size)")
    # rank striding defaults from the launcher's environment (torchrun's
    # RANK and WORLD_SIZE)
    p.add_argument('--process_index', type=int,
                   default=int(os.environ.get('RANK', 0)))
    p.add_argument('--process_count', type=int,
                   default=int(os.environ.get('WORLD_SIZE', 1)))
    p.add_argument('--device', type=str, default='cuda',
                   help='cuda (the default) or cpu')
    return p.parse_args(argv)


def center_crop_resize(frames: np.ndarray, h: int, w: int) -> np.ndarray:
    """Scale to cover h x w (cv2 INTER_AREA), then crop the centre. Frames
    already h x w are returned as they are (cv2 would copy them)."""
    f, fh, fw, _ = frames.shape
    scale = max(h / fh, w / fw)
    nh, nw = int(round(fh * scale)), int(round(fw * scale))
    if (nh, nw) != (fh, fw):
        import cv2
        frames = np.stack([cv2.resize(fr, (nw, nh),
                                      interpolation=cv2.INTER_AREA)
                           for fr in frames])
    top, left = (nh - h) // 2, (nw - w) // 2
    return frames[:, top:top + h, left:left + w]


Saver = Callable[[str, str, float, torch.Tensor, torch.Tensor], object]


def make_pair(frames: np.ndarray, *, index: int, num_frames: int = 32,
              frame_interval: int = 2, height: int = 720, width: int = 1280,
              scale: int = 4, seed: int = 0, use_codec: bool = True,
              recipe: str = 'default', device='cuda', draw=None
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One clip's pair from its decoded frames [F, H, W, 3] uint8: (gt
    uint8, lq uint8 upsampled to height x width, lq01 before the upsample
    [F, height/scale, width/scale, 3] fp32), all on `device`. The clip's
    degradation seed is seed + index * 7919, as in the JAX CLI."""
    frames = frames[::frame_interval][:num_frames]
    frames = center_crop_resize(frames, height, width)
    gt01 = torch.from_numpy(np.ascontiguousarray(frames)).to(
        device).float() / 255.0
    lq01, _ = degrade_video(gt01, scale=scale, seed=seed + index * 7919,
                            use_codec=use_codec, recipe=recipe,
                            device=gt01.device, draw=draw)
    # x(scale) cubic upsample of LQ (make_paired_data.py:86-96)
    lq_up = torch.clamp(resize_jax(lq01, height, width, 'cubic'), 0, 1)
    return ((gt01 * 255).to(torch.uint8), (lq_up * 255).to(torch.uint8),
            lq01)


def file_saver(save_dir: str) -> Saver:
    """save(name, text, fps, gt, lq): {save_dir}/gt/name.mp4,
    lq/name.mp4 and text/name.txt."""
    for sub in ('gt', 'lq', 'text'):
        os.makedirs(os.path.join(save_dir, sub), exist_ok=True)

    def save(name, text, fps, gt, lq):
        save_video(gt.cpu().numpy(), os.path.join(save_dir, 'gt'),
                   name + '.mp4', fps=fps)
        save_video(lq.cpu().numpy(), os.path.join(save_dir, 'lq'),
                   name + '.mp4', fps=fps)
        with open(os.path.join(save_dir, 'text', name + '.txt'), 'w') as f:
            f.write(text)
        return name
    return save


def run_rows(rows, load, save: Saver, **pair_kw) -> list:
    """Make and save the pair of each (path, text) row: load(path) ->
    (frames, fps); returns what `save` returned for each."""
    logger = get_logger()
    out = []
    for i, row in enumerate(rows):
        path, text = row[0], (row[1] if len(row) > 1 else '')
        name = os.path.splitext(os.path.basename(path))[0]
        frames, fps = load(path)
        gt, lq, _ = make_pair(frames, index=i, **pair_kw)
        out.append(save(name, text, fps, gt, lq))
        logger.info('[%d/%d] %s done', i + 1, len(rows), name)
    return out


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    with open(args.csv) as f:
        rows = [r for r in csv.reader(f) if r]
    rows = shard_for_process(rows, args.process_index, args.process_count)
    return run_rows(rows, load_video, file_saver(args.save_dir),
                    num_frames=args.num_frames,
                    frame_interval=args.frame_interval, height=args.height,
                    width=args.width, scale=args.scale, seed=args.seed,
                    use_codec=not args.no_codec, recipe=args.recipe,
                    device=device)


if __name__ == '__main__':
    main()
