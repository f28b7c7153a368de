"""ControlNet+LIEM fine-tuning driver (counterpart of
star_tpu/cli/train_sr.py, flag for flag, with --device added).

Behavioral reference: video_super_resolution/scripts/train_sr.py +
train_sr.sh (8xGPU DDP, bs 1/device, lr 5e-5, 15k steps, ckpt every 500,
scalars loss_v/loss_low/loss_high/lr). Each step: a batch of
{gt, lq, text} clips, the VAE encode of gt (a posterior sample) and lq
(the posterior mean), the text encode, one train step (fp32 masters of the
ControlNet+LIEM set, bf16 compute on the card); a JSONL metrics row per
step in output_dir/metrics.jsonl, checkpoints as torch files in
output_dir/ckpt (--resume continues from the newest), denoise previews in
output_dir/samples every --sample_every steps.

    python -m star_tpu_torch.cli.train_sr --data_root paired/ \
        --output_dir runs/x --pretrained weights/ --max_train_steps 15000

--pretrained is a directory of the port's converted files (unet.pt,
vae.pt, clip.pt); without it, --allow_random_weights trains from random
weights (a smoke run). It runs on the CUDA card in bf16; --device cpu runs
the plain PyTorch versions on the host in fp32 (--frozen_bf16 makes the
compute copy bf16 there too). One process, one card: --data_parallel and
--tensor_parallel above 1 and --coordinator wait for the port of
star_tpu/parallel/ (ROADMAP.md, section 1, item 5).
"""

from __future__ import annotations

import json
import os
import time
from argparse import ArgumentParser
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ..convert.load import load_star_models
from ..data.dataset import PairedCaptionImageDataset, PairedCaptionVideoDataset
from ..data.io import save_video
from ..data.prefetch import PrefetchIterator
from ..diffusion import DiffusionTables, default_star_schedule
from ..models.clip.tokenizer import default_tokenizer
from ..pipeline.build import init_random_models
from ..train import TrainConfig, cast_frozen, make_train_state, \
    make_train_step
from ..train.checkpoint import CheckpointManager
from ..utils.device import resolve_device
from ..utils.logger import get_logger
from ..utils.seed import setup_seed


def parse_args(argv=None):
    p = ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--data_root', required=True,
                   help='dir with gt/ lq/ text/ triplets')
    p.add_argument('--image_data', action='store_true',
                   help='data_root holds gt/ + sr_bicubic/ PNG image pairs '
                        '(PairedCaptionImageDataset, ref dataset.py:63) — '
                        'trains on single-frame clips')
    p.add_argument('--output_dir', required=True)
    p.add_argument('--pretrained', default=None,
                   help='directory of converted files (unet.pt, vae.pt, '
                        'clip.pt) to start from')
    p.add_argument('--vae_weights', default=None)
    p.add_argument('--clip_weights', default=None)
    p.add_argument('--learning_rate', type=float, default=5e-5)
    p.add_argument('--max_grad_norm', type=float, default=1.0)
    p.add_argument('--max_train_steps', type=int, default=15000)
    p.add_argument('--checkpointing_steps', type=int, default=500)
    p.add_argument('--num_frames', type=int, default=32)
    p.add_argument('--batch_size', type=int, default=1)
    p.add_argument('--seed', type=int, default=666)
    p.add_argument('--resume', action='store_true')
    p.add_argument('--freq_loss', action='store_true', default=True)
    p.add_argument('--allow_random_weights', action='store_true')
    p.add_argument('--data_parallel', type=int, default=1,
                   help='data-parallel processes; above 1 waits for the port '
                        'of star_tpu/parallel/')
    p.add_argument('--tensor_parallel', type=int, default=1,
                   help='tensor-parallel degree; above 1 waits for the port '
                        'of star_tpu/parallel/')
    p.add_argument('--frozen_bf16', action='store_true',
                   help='hold the frozen (non-trainable) parameters in bf16 '
                        '(always so on the card); trainable masters stay '
                        'fp32')
    p.add_argument('--ema_decay', type=float, default=0.0,
                   help='EMA of params; reference default 0.9999, 0 = off')
    p.add_argument('--sample_every', type=int, default=0,
                   help='decode a denoise preview of the current batch every '
                        'N steps into output_dir/samples; 0 = off')
    p.add_argument('--coordinator', default=None,
                   help='multi-process rendezvous; waits for the port of '
                        'star_tpu/parallel/')
    p.add_argument('--device', type=str, default='cuda',
                   help='cuda (the default) or cpu')
    return p.parse_args(argv)


def refuse_parallel(args) -> None:
    """The DP/TP mesh and multi-process start of the JAX CLIs live in
    star_tpu/parallel/, which the port has not taken over yet."""
    if args.data_parallel > 1 or args.tensor_parallel > 1 \
            or args.coordinator:
        raise ValueError(
            '--data_parallel/--tensor_parallel above 1 and --coordinator '
            'need the port of star_tpu/parallel/ onto torch.distributed '
            '(ROADMAP.md, section 1, item 5); the port trains on one card')


def collect_samples(it, reset, n):
    """Pull n samples from the (cycling) dataset iterator; `reset`
    re-creates the iterator at epoch end. Returns (samples, it)."""
    out = []
    while len(out) < n:
        try:
            out.append(next(it))
        except StopIteration:
            it = reset()
    return out, it


def stack_batch(samples):
    """Stack per-sample dicts into batched arrays (host-side numpy)."""
    gt = np.stack([s['gt'] for s in samples])
    lq = np.stack([s['lq'] for s in samples])
    texts = [s['text'] for s in samples]
    return gt, lq, texts


def compute_dtype(device: torch.device, frozen_bf16: bool) -> torch.dtype:
    """bf16 on the card (its kernels take bf16); fp32 on the host unless
    the frozen set is asked for in bf16."""
    return torch.bfloat16 if device.type == 'cuda' or frozen_bf16 \
        else torch.float32


def train_loop(step_fn: Callable, state, make_batch: Callable,
               make_it: Callable[[], Iterator], *, start_step: int,
               max_train_steps: int, global_batch: int,
               checkpoints: Optional[CheckpointManager],
               write_row: Callable[[dict], None], learning_rate: float,
               generator: Optional[torch.Generator] = None,
               after_step: Optional[Callable] = None):
    """The training CLIs' loop, with its data and outputs injected:
    make_it() gives a fresh iterator of samples (a new epoch);
    make_batch(samples) the device batch; step_fn(state, batch) ->
    (state, metrics); after each step after_step(step, state, batch) (the
    previews), then the checkpoint with `generator`'s state (when the
    manager's policy says so) and the metrics row, the JAX CLI's keys:
    each metric, step, lr and sec_per_step (host seconds since the
    previous row, the batch's load and encode included). A run resumed at
    start_step is handed data already past the samples of the finished
    steps (the datasets' skip), so that it sees the data a continued run
    sees (the JAX CLIs restart their data and key). Returns the state
    after the last step."""
    logger = get_logger()
    it = make_it()
    t_last = time.time()
    for step in range(start_step, max_train_steps):
        samples, it = collect_samples(it, make_it, global_batch)
        batch = make_batch(samples)
        state, metrics = step_fn(state, batch)
        if after_step is not None:
            after_step(step + 1, state, batch)
        if checkpoints is not None:
            checkpoints.save(step + 1, state, generator)
        row = {k: float(v) for k, v in metrics.items()}
        row.update(step=step + 1, lr=learning_rate,
                   sec_per_step=time.time() - t_last)
        t_last = time.time()
        write_row(row)
        if (step + 1) % 10 == 0:
            logger.info('step %d loss %.4f', step + 1, row['total_loss'])
    return state


def jsonl_writer(path: str) -> Callable[[dict], None]:
    def write(row):
        with open(path, 'a') as f:
            f.write(json.dumps(row) + '\n')
    return write


def make_trainer(models, cfg: TrainConfig, device: torch.device,
                 generator: torch.Generator, tokenizer,
                 frozen_bf16: bool = False):
    """(state, step_fn, make_batch, train_step) over the I2VGen models:
    the UNet+ControlNet made the compute copy (remat on), its trainable
    set as fp32 masters; make_batch encodes a list of samples as the JAX
    CLI does."""
    unet, vae, text = models.unet, models.vae, models.text
    dtype = compute_dtype(device, frozen_bf16)
    unet.to(dtype)
    vae.to(dtype)
    text.to(dtype)
    if frozen_bf16:
        cast_frozen(unet)
    unet.unet.remat = unet.controlnet.remat = True
    state, tx = make_train_state(cfg, unet)
    train_step = make_train_step(
        cfg, unet, DiffusionTables.from_schedule(default_star_schedule(),
                                                 device), tx,
        vae_decode=vae.decode if cfg.freq_loss else None)

    @torch.no_grad()
    def make_batch(samples):
        gt_np, lq_np, texts = stack_batch(samples)
        gt = torch.from_numpy(gt_np).to(device, dtype)
        lq = torch.from_numpy(lq_np).to(device, dtype)
        gt_lat = vae.encode(gt, generator=generator)
        lq_lat = vae.encode(lq, eps=torch.zeros(gt_lat.shape, device=device))
        tokens = torch.as_tensor(np.asarray(tokenizer(texts)), device=device)
        batch = {'gt_latent': gt_lat, 'lq_latent': lq_lat, 'y': text(tokens)}
        if cfg.freq_loss:
            batch['gt_pixels'] = gt
        return batch

    def step_fn(state, batch):
        return train_step(state, batch, generator)
    return state, step_fn, make_batch, train_step


def preview_saver(output_dir: str):
    """Write each preview as output_dir/samples/step{N:06d}.mp4 at 8 fps."""
    def save(frames: np.ndarray, step: int):
        return save_video(frames, os.path.join(output_dir, 'samples'),
                          f'step{step:06d}.mp4', fps=8)
    return save


def previews(train_step, every: int, generator: torch.Generator,
             save: Callable[[np.ndarray, int], object]):
    """after_step for train_loop: every `every` steps, a one-shot denoise
    of the batch at t 499, decoded, as uint8 frames of its first clip."""
    def after_step(step, state, batch):
        if every and step % every == 0:
            pix = train_step.preview_x0(batch, generator)
            frames = (torch.clamp(pix[0].float() * 0.5 + 0.5, 0, 1) * 255)
            save(frames.to(torch.uint8).cpu().numpy(), step)
    return after_step


def main(argv=None):
    args = parse_args(argv)
    refuse_parallel(args)
    device = resolve_device(args.device)
    logger = get_logger()
    generator = setup_seed(args.seed, device)
    os.makedirs(args.output_dir, exist_ok=True)

    dtype = compute_dtype(device, args.frozen_bf16)
    if args.pretrained and os.path.exists(args.pretrained):
        models = load_star_models(args.pretrained, dtype=dtype,
                                  device=device)
    elif args.allow_random_weights:
        logger.warning('training from RANDOM weights (smoke run)')
        models = init_random_models(seed=0, dtype=dtype, device=device)
    else:
        raise FileNotFoundError('--pretrained not found; pass '
                                '--allow_random_weights for a smoke run')
    cfg = TrainConfig(learning_rate=args.learning_rate,
                      max_grad_norm=args.max_grad_norm,
                      freq_loss=args.freq_loss, ema_decay=args.ema_decay)
    tokenizer = default_tokenizer(allow_fallback=args.allow_random_weights)
    state, step_fn, make_batch, train_step = make_trainer(
        models, cfg, device, generator, tokenizer, args.frozen_bf16)

    ckpt = CheckpointManager(os.path.join(args.output_dir, 'ckpt'),
                             max_to_keep=3,
                             save_interval_steps=args.checkpointing_steps)
    start_step = 0
    if args.resume and ckpt.latest_step() is not None:
        start_step = ckpt.latest_step()
        state = ckpt.restore(start_step, state, models.unet, generator)
        logger.info('resumed from step %d', start_step)

    if args.image_data:
        ds = PairedCaptionImageDataset(args.data_root)
    else:
        ds = PairedCaptionVideoDataset(args.data_root, args.num_frames,
                                       seed=args.seed)
    ds.skip(start_step * args.batch_size)
    # background-thread decode overlaps the device step (cv2 releases the
    # GIL)
    make_it = lambda: PrefetchIterator(ds, depth=2 * args.batch_size)
    after = None
    if args.sample_every and args.freq_loss:
        after = previews(train_step, args.sample_every, generator,
                         preview_saver(args.output_dir))
    return train_loop(
        step_fn, state, make_batch, make_it, start_step=start_step,
        max_train_steps=args.max_train_steps, global_batch=args.batch_size,
        checkpoints=ckpt,
        write_row=jsonl_writer(os.path.join(args.output_dir,
                                            'metrics.jsonl')),
        learning_rate=args.learning_rate, generator=generator,
        after_step=after)


if __name__ == '__main__':
    main()
