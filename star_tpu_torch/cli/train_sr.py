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
compute copy bf16 there too).

One process a card: --data_parallel D and --tensor_parallel T need D*T
processes, started by torchrun (NCCL between cards; gloo with --device
cpu) or given a rendezvous by --coordinator host:port:

    torchrun --nproc_per_node 8 -m star_tpu_torch.cli.train_sr \
        --data_root paired/ --output_dir runs/x --data_parallel 4 \
        --tensor_parallel 2 ...

Every rank reads the same seeded data and keeps its rows of the global
batch (D * --batch_size samples); the AdamW moments are split over 'data'
(ZeRO-1) and the UNet+ControlNet over 'tensor' (parallel/). Rank 0 writes
the metrics rows, the checkpoints (the single-process file) and the
previews.
"""

from __future__ import annotations

import json
import os
import time
from argparse import ArgumentParser
from typing import Callable, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..convert.load import load_star_models
from ..data.dataset import PairedCaptionImageDataset, PairedCaptionVideoDataset
from ..data.io import save_video
from ..data.prefetch import PrefetchIterator
from ..diffusion import DiffusionTables, default_star_schedule
from ..models.clip.tokenizer import default_tokenizer
from ..parallel import (AXIS_DATA, init_distributed, make_hybrid_mesh,
                        make_mesh, shard_opt_state, shard_params)
from ..parallel.mesh import Mesh, draw_rows
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
                   help='data-parallel ranks (ZeRO-1 moments); the global '
                        'batch is data_parallel * batch_size')
    p.add_argument('--tensor_parallel', type=int, default=1,
                   help='tensor-parallel ranks (Megatron UNet+ControlNet)')
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
                   help='host:port of the rendezvous (tcp://) when the '
                        'processes are not started by torchrun')
    p.add_argument('--device', type=str, default='cuda',
                   help='cuda (the default) or cpu')
    return p.parse_args(argv)


def start_processes(args, device: torch.device):
    """init_distributed, then the mesh of --data_parallel x
    --tensor_parallel over the processes; raises before any model is
    built unless the process count is their product. Returns (mesh,
    device: this process's card)."""
    _, count = init_distributed(args.coordinator, device=device)
    need = args.data_parallel * args.tensor_parallel
    if count != need:
        raise ValueError(
            f'--data_parallel {args.data_parallel} x --tensor_parallel '
            f'{args.tensor_parallel} needs {need} processes, one a card, and '
            f'this run has {count}: start it with torchrun --nproc_per_node '
            f'{need} (or {need} processes with --coordinator host:port)')
    if device.type == 'cuda' and count > 1:
        device = torch.device('cuda', torch.cuda.current_device())
    make = make_hybrid_mesh if count > 1 else make_mesh
    return make(data=args.data_parallel, tensor=args.tensor_parallel), device


def stop_processes(started: bool) -> None:
    """End the process group this run started."""
    if started and dist.is_initialized():
        dist.destroy_process_group()


def rank_rows(samples: list, mesh: Optional[Mesh]) -> list:
    """This data rank's samples of the global batch."""
    if mesh is None:
        return samples
    n, r = mesh.size(AXIS_DATA), mesh.index(AXIS_DATA)
    b = len(samples) // n
    return samples[r * b:(r + 1) * b]


def is_writer() -> bool:
    """Rank 0 writes the run's files."""
    return not dist.is_initialized() or dist.get_rank() == 0


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


def row_writer(output_dir: str) -> Callable[[dict], None]:
    """The metrics rows' writer: output_dir/metrics.jsonl on rank 0."""
    if not is_writer():
        return lambda row: None
    return jsonl_writer(os.path.join(output_dir, 'metrics.jsonl'))


def posterior_eps(generator, device, mesh):
    """The encode's eps as a function of the latent shape: the global
    batch's draw, this rank's rows."""
    return lambda shape: draw_rows(
        lambda s: torch.randn(s, generator=generator, device=device),
        shape, mesh)


def make_trainer(models, cfg: TrainConfig, device: torch.device,
                 generator: torch.Generator, tokenizer,
                 frozen_bf16: bool = False, mesh: Optional[Mesh] = None):
    """(state, step_fn, make_batch, train_step) over the I2VGen models:
    the UNet+ControlNet made the compute copy (remat on; split over the
    mesh's 'tensor' axis), its trainable set as fp32 masters (their
    moments split over 'data' when it has more than one rank); make_batch
    encodes this rank's rows of a list of samples (the global batch) as
    the JAX CLI does."""
    unet, vae, text = models.unet, models.vae, models.text
    dtype = compute_dtype(device, frozen_bf16)
    unet.to(dtype)
    vae.to(dtype)
    text.to(dtype)
    if frozen_bf16:
        cast_frozen(unet)
    unet.unet.remat = unet.controlnet.remat = True
    if mesh is not None:
        shard_params(unet, mesh)
    state, tx = make_train_state(cfg, unet)
    if mesh is not None and mesh.group(AXIS_DATA) is not None:
        shard_opt_state(tx, mesh)
    train_step = make_train_step(
        cfg, unet, DiffusionTables.from_schedule(default_star_schedule(),
                                                 device), tx,
        vae_decode=vae.decode if cfg.freq_loss else None, mesh=mesh)

    @torch.no_grad()
    def make_batch(samples):
        gt_np, lq_np, texts = stack_batch(rank_rows(samples, mesh))
        gt = torch.from_numpy(gt_np).to(device, dtype)
        lq = torch.from_numpy(lq_np).to(device, dtype)
        gt_lat = vae.encode(gt, eps=posterior_eps(generator, device, mesh))
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
    of the batch at t 499, decoded, as uint8 frames of its first clip
    (every rank denoises its rows, drawing the global batch's noise, and
    rank 0 saves)."""
    def after_step(step, state, batch):
        if every and step % every == 0:
            pix = train_step.preview_x0(batch, generator)
            frames = (torch.clamp(pix[0].float() * 0.5 + 0.5, 0, 1) * 255)
            if is_writer():
                save(frames.to(torch.uint8).cpu().numpy(), step)
    return after_step


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    started = not dist.is_initialized()
    mesh, device = start_processes(args, device)
    try:
        return run(args, device, mesh)
    finally:
        stop_processes(started)


def run(args, device: torch.device, mesh: Mesh):
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
        models, cfg, device, generator, tokenizer, args.frozen_bf16, mesh)

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
    global_batch = args.batch_size * args.data_parallel
    ds.skip(start_step * global_batch)
    # background-thread decode overlaps the device step (cv2 releases the
    # GIL)
    make_it = lambda: PrefetchIterator(ds, depth=2 * global_batch)
    after = None
    if args.sample_every and args.freq_loss:
        after = previews(train_step, args.sample_every, generator,
                         preview_saver(args.output_dir))
    return train_loop(
        step_fn, state, make_batch, make_it, start_step=start_step,
        max_train_steps=args.max_train_steps, global_batch=global_batch,
        checkpoints=ckpt, write_row=row_writer(args.output_dir),
        learning_rate=args.learning_rate, generator=generator,
        after_step=after)


if __name__ == '__main__':
    main()
