"""CogVideoX SR fine-tuning driver: LoRA + final layer + proj_sr + LIEM
(counterpart of star_tpu/cli/train_cog.py, flag for flag, with --device
added).

Behavioral reference: the SAT training plumbing the reference carries
(arguments.py:179-253, diffusion_video.py:94-164 disable_untrainable_params
and shared_step, loss.py:196-278 SRDiffusionLoss). Each step: a batch of
{gt, lq, text} clips of 4k+1 frames at 480x720 (CogPairedCaptionDataset's
resize and crop rules), the causal-VAE encode of gt (a posterior sample)
and lq (the posterior mean), the T5-XXL encode of the captions, one train
step of the DiT (fp32 masters of the trainable set, bf16 compute on the
card, every layer rematerialised), with --freq_loss the Fourier loss of
pred-x0 decoded in one window with a cleared cache; the same metrics rows
and torch checkpoints as train_sr.

    python -m star_tpu_torch.cli.train_cog --data_root paired/ \
        --output_dir runs/c --model_path weights_cog/ --max_train_steps 100

--model_path is a directory of the port's files: dit.pt the state dict of
a CogVideoDiT(lora_rank=--lora_rank) that keeps its LoRA keys (a file
converted with --merge-lora has none and is refused), t5.pt and
causal_vae.pt; without it, --allow_random_weights trains from random
weights with the hash tokenizer (a smoke run). It runs on the CUDA card in
bf16; --device cpu runs the plain versions on the host in fp32.
--data_parallel, --tensor_parallel (the DiT split over 'tensor') and
--coordinator work as in train_sr: D*T processes under torchrun, rank 0
writing the files.
"""

from __future__ import annotations

import os
from argparse import ArgumentParser
from contextlib import nullcontext
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..convert.convert import load_params
from ..convert.load import module_from_state_dict
from ..data.dataset import CogPairedCaptionDataset
from ..data.prefetch import PrefetchIterator
from ..models.dit.dit import CogVideoDiT
from ..models.t5.encoder import T5Encoder
from ..models.t5.tokenizer import default_t5_tokenizer
from ..parallel import AXIS_DATA, shard_opt_state, shard_params
from ..parallel.mesh import Mesh
from ..pipeline.build import CogModels, _init_random
from ..train.checkpoint import CheckpointManager
from ..train.cog_trainer import (CogTrainConfig, make_cog_train_state,
                                 make_cog_train_step)
from ..utils.device import resolve_device
from ..utils.logger import get_logger
from ..utils.profiling import annotate, trace
from ..utils.seed import setup_seed
from ..vae.causal_vae import CogVideoVAE
from .train_sr import (compute_dtype, posterior_eps, rank_rows, row_writer,
                       stack_batch, start_processes, stop_processes,
                       train_loop)


def parse_args(argv=None):
    p = ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--data_root', required=True,
                   help='dir with gt/ lq/ text/ triplets (720x480 clips)')
    p.add_argument('--output_dir', required=True)
    p.add_argument('--model_path', default=None,
                   help='directory of the port files dit.pt (with its LoRA '
                        'keys), causal_vae.pt and t5.pt')
    p.add_argument('--learning_rate', type=float, default=1e-4)
    p.add_argument('--max_grad_norm', type=float, default=1.0)
    p.add_argument('--max_train_steps', type=int, default=10000)
    p.add_argument('--checkpointing_steps', type=int, default=500)
    p.add_argument('--num_frames', type=int, default=25,
                   help='pixel frames, 4k+1 (data_video.py:458-527)')
    p.add_argument('--batch_size', type=int, default=1)
    p.add_argument('--lora_rank', type=int, default=512)
    p.add_argument('--seed', type=int, default=666)
    p.add_argument('--resume', action='store_true')
    p.add_argument('--freq_loss', action='store_true',
                   help='timestep-aware Fourier loss (decodes pred-x0 '
                        'through the VAE, loss.py:247-278); costs a decode '
                        'per step')
    p.add_argument('--clean_captions', action='store_true')
    p.add_argument('--allow_random_weights', action='store_true')
    p.add_argument('--data_parallel', type=int, default=1,
                   help='data-parallel ranks (ZeRO-1 moments)')
    p.add_argument('--tensor_parallel', type=int, default=1,
                   help='tensor-parallel ranks (Megatron DiT)')
    p.add_argument('--ema_decay', type=float, default=0.0)
    p.add_argument('--coordinator', default=None,
                   help='host:port of the rendezvous (tcp://) when the '
                        'processes are not started by torchrun')
    p.add_argument('--device', type=str, default='cuda',
                   help='cuda (the default) or cpu')
    p.add_argument('--trace_dir', type=str, default=None,
                   help='profile the train loop and write its Chrome trace '
                        '(spans, operators, kernels) to DIR/trace.json')
    return p.parse_args(argv)


def towers(lora_rank: int) -> dict[str, Callable[[], torch.nn.Module]]:
    """Constructors of the trained DiT (LoRA of `lora_rank`, LIEM) and of
    the causal VAE and T5-XXL, at their published sizes."""
    return {'dit': lambda: CogVideoDiT(lora_rank=lora_rank),
            'causal_vae': CogVideoVAE, 't5': T5Encoder}


def load_train_models(root: str, lora_rank: int, dtype: torch.dtype,
                      device: torch.device) -> CogModels:
    """dit.pt, causal_vae.pt and t5.pt of `root` onto `device`. A dit.pt
    without the LoRA keys of lora_rank (merged at conversion) is refused
    with the keys it lacks named."""
    build = towers(lora_rank)
    sds = {k: load_params(os.path.join(root, f'{k}.pt')) for k in build}
    with torch.device('meta'):
        keys = set(build['dit']().state_dict())
    missing = sorted(keys - set(sds['dit']))
    if missing:
        raise ValueError(
            f'{os.path.join(root, "dit.pt")} lacks {len(missing)} keys of a '
            f'CogVideoDiT with LoRA rank {lora_rank}, first few: '
            f'{missing[:4]}; train_cog needs the LoRA kept (a file converted '
            'with --merge-lora has none)')
    return CogModels(*(module_from_state_dict(build[k], sds[k], dtype, device)
                       for k in ('dit', 'causal_vae', 't5')))


def init_random_train_models(lora_rank: int, seed: int, dtype: torch.dtype,
                             device: torch.device) -> CogModels:
    build = towers(lora_rank)
    return CogModels(*_init_random(
        [build[k] for k in ('dit', 'causal_vae', 't5')], seed, dtype,
        device))


def make_cog_trainer(models: CogModels, cfg: CogTrainConfig,
                     device: torch.device, generator: torch.Generator,
                     tokenizer, mesh: Optional[Mesh] = None):
    """(state, step_fn, make_batch) over the Cog models: the DiT made the
    compute copy (its layers rematerialised, the DiT's default; split
    over the mesh's 'tensor' axis), its trainable set as fp32 masters
    (their moments split over 'data' when it has more than one rank);
    make_batch encodes this rank's rows of a list of samples (the global
    batch) as the JAX CLI does."""
    dit, vae, t5 = models.dit, models.vae, models.text
    dtype = next(dit.parameters()).dtype
    if mesh is not None:
        shard_params(dit, mesh)
    state, tx = make_cog_train_state(cfg, dit)
    if mesh is not None and mesh.group(AXIS_DATA) is not None:
        shard_opt_state(tx, mesh)
    decode = None
    if cfg.freq_loss:
        # one window with a cleared cache (the JAX CLI's training decode;
        # serving keeps the serial windows)
        decode = lambda z: vae.decode_window(z.to(dtype), {}, True)[0]
    train_step = make_cog_train_step(cfg, dit, tx, decode, mesh)

    @torch.no_grad()
    def make_batch(samples):
        with annotate('batch.to_device'):
            gt_np, lq_np, texts = stack_batch(rank_rows(samples, mesh))
            gt = torch.from_numpy(gt_np).to(device, dtype)
            lq = torch.from_numpy(lq_np).to(device, dtype)
        with annotate('batch.vae_encode'):
            gt_lat = vae.encode(gt, eps=posterior_eps(generator, device,
                                                      mesh))
            lq_lat = vae.encode(lq, eps=torch.zeros(gt_lat.shape,
                                                    device=device))
        with annotate('batch.t5'):
            tokens = torch.as_tensor(np.asarray(tokenizer(texts)),
                                     device=device)
            y = t5(tokens)
        batch = {'gt_latent': gt_lat, 'lq_latent': lq_lat, 'y': y}
        if cfg.freq_loss:
            batch['gt_pixels'] = gt
        return batch

    def step_fn(state, batch):
        return train_step(state, batch, generator)
    return state, step_fn, make_batch


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

    dtype = compute_dtype(device, False)
    if args.model_path and os.path.exists(args.model_path):
        models = load_train_models(args.model_path, args.lora_rank, dtype,
                                   device)
    elif args.allow_random_weights:
        logger.warning('training from RANDOM weights (smoke run)')
        models = init_random_train_models(args.lora_rank, 0, dtype, device)
    else:
        raise FileNotFoundError('--model_path not found; pass '
                                '--allow_random_weights for a smoke run')
    tokenizer = default_t5_tokenizer(
        allow_fallback=args.allow_random_weights)
    cfg = CogTrainConfig(learning_rate=args.learning_rate,
                         max_grad_norm=args.max_grad_norm,
                         freq_loss=args.freq_loss, ema_decay=args.ema_decay)
    state, step_fn, make_batch = make_cog_trainer(models, cfg, device,
                                                  generator, tokenizer, mesh)

    ckpt = CheckpointManager(os.path.join(args.output_dir, 'ckpt'),
                             max_to_keep=3,
                             save_interval_steps=args.checkpointing_steps)
    start_step = 0
    if args.resume and ckpt.latest_step() is not None:
        start_step = ckpt.latest_step()
        state = ckpt.restore(start_step, state, models.dit, generator)
        logger.info('resumed from step %d', start_step)

    ds = CogPairedCaptionDataset(args.data_root, args.num_frames,
                                 seed=args.seed,
                                 clean_captions=args.clean_captions)
    global_batch = args.batch_size * args.data_parallel
    ds.skip(start_step * global_batch)
    make_it = lambda: PrefetchIterator(ds, depth=2 * global_batch)
    with trace(args.trace_dir) if args.trace_dir else nullcontext():
        return train_loop(
            step_fn, state, make_batch, make_it, start_step=start_step,
            max_train_steps=args.max_train_steps, global_batch=global_batch,
            checkpoints=ckpt, write_row=row_writer(args.output_dir),
            learning_rate=args.learning_rate, generator=generator)


if __name__ == '__main__':
    main()
