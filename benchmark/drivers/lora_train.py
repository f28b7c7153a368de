"""Traffic kind `lora_train`: the CogVideoX SR LoRA fine-tune as
`star_tpu_torch.cli.train_cog` runs it (`train_sr.train_loop` over
`train_cog.make_cog_trainer`), on a pool of seeded (gt, lq, caption)
triplets held in host memory and cycled.

Set-up builds the trainer once and drives it through its first three
steps by the window's own loop and feed, on three different rows; their
losses, the first gradient as AdamW took it (its first moment after step
1 over 1 - beta1) and the masters' change over the three steps are kept.
The window then continues the same trainer: the first step always runs,
each further one only while the elapsed time plus the mean step so far
stays within the window's seconds. A step is the batch's encodes, the
train step and the metrics row.

After the window the program is freed and the plain float32 reference
follows the first three steps from the same weights, rows and draws
(`compare`)."""

from __future__ import annotations

import gc
import itertools
import sys
import time

import numpy as np
import torch

from ..harness import common, inputs
from ..harness.weights import assign, make_weights
from ..harness.work import FlopCount
from ..reference import cogvideox, prims

FIRST_STEPS = 3


class WindowClosed(Exception):
    pass


def build(cfg: dict, seed: int, device, dtype):
    """The three towers at the configuration's sizes on weights drawn from
    the seed; returns (CogModels, state dict)."""
    from star_tpu_torch.models.dit.dit import CogVideoDiT
    from star_tpu_torch.models.t5.encoder import T5Encoder
    from star_tpu_torch.pipeline.build import CogModels
    from star_tpu_torch.vae.causal_vae import CogVideoVAE
    d, v, t = cfg['dit'], cfg['vae'], cfg['text']
    with torch.device('meta'):
        dit = CogVideoDiT(
            hidden_size=d['hidden_size'], num_layers=d['num_layers'],
            num_heads=d['num_heads'], patch_size=d['patch_size'],
            latent_channels=d['latent_channels'],
            text_hidden_size=d['text_hidden_size'],
            text_length=d['text_length'],
            time_embed_dim=d['time_embed_dim'],
            lora_rank=cfg['train']['lora_rank'], liem=d['liem'])
        vae = CogVideoVAE(ch=v['ch'], ch_mult=tuple(v['ch_mult']),
                          num_res_blocks=v['num_res_blocks'],
                          z_channels=v['z_channels'])
        t5 = T5Encoder(vocab_size=t['vocab_size'], d_model=t['d_model'],
                       d_ff=t['d_ff'], num_heads=t['num_heads'],
                       num_layers=t['num_layers'])
    towers = {'dit.': dit, 'vae.': vae, 't5.': t5}
    sd = {}
    for i, (prefix, m) in enumerate(towers.items()):
        sd.update(make_weights(m, seed * 8 + i, device, dtype, prefix))
    for prefix, m in towers.items():
        assign(m, sd, prefix)
    return CogModels(dit, vae, t5), sd


def leaf_gaps(prog: dict, ref: dict, keep) -> list[float]:
    """Each kept leaf's |‖prog‖ - ‖ref‖| over the larger of the
    reference's norm of that leaf and the median leaf's."""
    norms = [(float(torch.linalg.vector_norm(prog[n].float())),
              float(torch.linalg.vector_norm(ref[n].float()))) for n in keep]
    med = float(np.median([r for _, r in norms]))
    return [abs(p - r) / max(r, med) for p, r in norms]


def leaf_diffs(prog: dict, ref: dict, keep) -> list[float]:
    """Each kept leaf's ‖prog - ref‖ over the larger of the reference's
    norm of that leaf and the median leaf's (read beside the gaps of
    norms, which rounding noise moves only to second order)."""
    ref_n = [float(torch.linalg.vector_norm(ref[n].float())) for n in keep]
    med = float(np.median(ref_n))
    return [float(torch.linalg.vector_norm(
        prog[n].float().to(ref[n].device) - ref[n].float())) / max(r, med)
        for n, r in zip(keep, ref_n)]


def worst_leaves(prog: dict, ref: dict, keep, top: int = 6) -> list:
    """(gap, leaf, ‖prog‖, ‖ref‖) of the leaves that read worst."""
    norms = {n: (float(torch.linalg.vector_norm(prog[n].float())),
                 float(torch.linalg.vector_norm(ref[n].float())))
             for n in keep}
    med = float(np.median([r for _, r in norms.values()]))
    rows = [(abs(p - r) / max(r, med), n, p, r)
            for n, (p, r) in norms.items()]
    return sorted(rows, reverse=True)[:top]


def compare(prog: dict, ref: dict) -> dict:
    """prog and ref: losses [3], grad1 and delta3 (leaf -> tensor). Leaves
    whose reference gradient is under a thousandth of the median leaf's
    are nought to rounding and left out. Each of grad1 and delta3 by its
    worst leaf and by its median leaf, and the median leaf's norm of the
    difference; the losses by their largest relative gap."""
    gnorm = {n: float(torch.linalg.vector_norm(g))
             for n, g in ref['grad1'].items()}
    med = float(np.median(list(gnorm.values())))
    keep = [n for n, v in gnorm.items() if v >= 1e-3 * med]
    out = {'loss_gap': max(abs(p - r) / abs(r) for p, r in
                           zip(prog['losses'], ref['losses']))}
    for what in ('grad1', 'delta3'):
        gaps = leaf_gaps(prog[what], ref[what], keep)
        out[f'{what}_gap'] = max(gaps)
        out[f'{what}_median_gap'] = float(np.median(gaps))
        out[f'{what}_diff_median'] = float(np.median(
            leaf_diffs(prog[what], ref[what], keep)))
    out['leaves_kept'] = float(len(keep))
    return out


def reference_draws(device, seed: int, lat_shape, steps: int) -> list:
    """The numbers the trainer draws from its generator, in its order:
    per step the gt encode's eps (make_batch), then the timestep index and
    the noise (the train step)."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = []
    for _ in range(steps):
        eps = torch.randn(lat_shape, generator=g, device=device)
        idx = torch.randint(0, 1000, (1,), generator=g, device=device)
        noise = torch.randn(lat_shape, generator=g, device=device)
        out.append((eps, idx, noise))
    return out


def reference_batches(p, sd32, cfg, rows, draws, device):
    """The reference's own encodes of the rows: T5 of the captions, the
    causal VAE of gt (a posterior sample) and lq (the mean), scaled."""
    t, v = cfg['text'], cfg['vae']
    tok = inputs.WordHashT5Tokenizer(cfg['dit']['text_length'],
                                     t['vocab_size'])
    tw = prims.Weights(sd32, 't5.')
    vw = prims.Weights(sd32, 'vae.encoder.')
    out = []
    for row, (eps, idx, noise) in zip(rows, draws):
        y = cogvideox.t5_encode(p, tw, torch.as_tensor(
            tok([row['text']]), device=device), t['num_heads'],
            t['num_layers'])
        lat = []
        for key in ('gt', 'lq'):
            clip = torch.as_tensor(row[key], device=device)[None]
            mom = cogvideox.causal_vae_encode_moments(
                p, vw, clip, len(v['ch_mult']), v['num_res_blocks'])
            mean, logvar = mom.chunk(2, dim=-1)
            z = mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * (
                eps if key == 'gt' else 0.0)
            lat.append(z * cogvideox.VAE_SCALE)
        out.append({'gt': lat[0], 'lq': lat[1], 'y': y, 'idx': idx,
                    'noise': noise})
    return out


def optimizer_of(cfg) -> dict:
    tr = cfg['train']
    return {'lr': tr['learning_rate'], 'beta1': tr['adam_beta1'],
            'beta2': tr['adam_beta2'], 'eps': tr['adam_eps'],
            'weight_decay': tr['weight_decay'],
            'max_grad_norm': tr['max_grad_norm']}


def run(ctx: dict) -> dict:
    from star_tpu_torch.cli.train_cog import make_cog_trainer
    from star_tpu_torch.cli.train_sr import train_loop
    from star_tpu_torch.train.cog_trainer import CogTrainConfig
    cfg, tr, dev = ctx['config'], ctx['traffic'], ctx['device']
    seed, traced = ctx['seed'], ctx['trace']
    dtype = torch.bfloat16 if dev.type == 'cuda' else torch.float32
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == 'cuda' \
        else (lambda: None)

    models, sd = build(cfg, seed, dev, dtype)
    t = cfg['train']
    tcfg = CogTrainConfig(learning_rate=t['learning_rate'],
                          max_grad_norm=t['max_grad_norm'],
                          freq_loss=t['freq_loss'], ema_decay=0.0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tok = inputs.WordHashT5Tokenizer(cfg['dit']['text_length'],
                                     cfg['text']['vocab_size'])
    state, step_fn, make_batch = make_cog_trainer(models, tcfg, dev, gen,
                                                  tok)
    tx = state.opt_state
    pool = inputs.video_pairs(seed, tr['pool'], tr['frames'], tr['height'],
                              tr['width'], dev)

    def rows_from(start):
        return lambda: (pool[i % len(pool)]
                        for i in itertools.count(start))

    # the window's feed and step, timed when traced
    timing = {'batch_s': [], 'step_events': [], 'gate': None}

    def timed_batch(samples):
        gate = timing['gate']
        if gate is not None and not gate():
            raise WindowClosed
        if traced:
            sync()
            t0 = time.perf_counter()
            batch = make_batch(samples)
            sync()
            timing['batch_s'].append(time.perf_counter() - t0)
            return batch
        return make_batch(samples)

    def timed_step(state, batch):
        if traced and dev.type == 'cuda':
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            out = step_fn(state, batch)
            b.record()
            timing['step_events'].append((a, b))
            return out
        return step_fn(state, batch)

    # the first steps, kept for the comparison on the host, so that the
    # card holds only the program's memory
    prog = {'losses': []}
    init = {n: m.detach().to('cpu', copy=True)
            for n, m in state.params.items()}
    masters = list(tx.adamw.param_groups[0]['params'])

    def snapshot(step, state, batch):
        if step == 1:       # no moment: the optimizer took no step
            b1 = tx.cfg.adam_beta1
            st = tx.adamw.state
            prog['grad1'] = {n: (st[m]['exp_avg'] / (1.0 - b1)).cpu()
                             if m in st else torch.zeros(m.shape)
                             for n, m in zip(tx.names, masters)}
        if step == FIRST_STEPS:
            prog['delta3'] = {n: state.params[n].detach().cpu() - init[n]
                              for n in tx.names}

    state = train_loop(timed_step, state, timed_batch, rows_from(0),
                       start_step=0, max_train_steps=FIRST_STEPS,
                       global_batch=1, checkpoints=None,
                       write_row=lambda r: prog['losses'].append(
                           r['total_loss']),
                       learning_rate=t['learning_rate'], generator=gen,
                       after_step=snapshot)
    sync()
    setup_peak = (torch.cuda.max_memory_allocated(dev)
                  if dev.type == 'cuda' else 0)
    timing['batch_s'].clear()
    timing['step_events'].clear()

    # the window
    ends = []
    t0 = [0.0]

    def gate():
        k = len(ends)
        if k == 0:
            return True
        elapsed = time.perf_counter() - t0[0]
        return elapsed + elapsed / k <= ctx['seconds']

    timing['gate'] = gate
    log = ctx['launch_log']
    if dev.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.time() - ctx['t_process']
    gc2 = gc.get_stats()[2]['collections']
    with ctx['profile']() as prof, log.recording():
        with torch.profiler.record_function('window'):
            t0[0] = time.perf_counter()
            try:
                train_loop(timed_step, state, timed_batch,
                           rows_from(FIRST_STEPS), start_step=FIRST_STEPS,
                           max_train_steps=10 ** 9, global_batch=1,
                           checkpoints=None,
                           write_row=lambda r: ends.append(
                               time.perf_counter()),
                           learning_rate=t['learning_rate'], generator=gen)
            except WindowClosed:
                pass
    window_s = ends[-1] - t0[0]
    steps_s = [b - a for a, b in zip([t0[0]] + ends[:-1], ends)]
    print('window steps s ' + ' '.join(f'{x:.4f}' for x in steps_s)
          + f' gen2 collections {gc.get_stats()[2]["collections"] - gc2}',
          file=sys.stderr)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == 'cuda'
            else 0)
    step_ms = [a.elapsed_time(b) for a, b in timing['step_events']]
    steps = len(ends)

    # the program is freed before the reference runs; its module shared
    # the state dict's tensors and copied its masters into the trainable
    # ones, so these get their first values back
    del state, step_fn, make_batch, models, tx, masters
    common.free(dev)
    with torch.no_grad():
        for n, v in init.items():
            sd['dit.' + n].copy_(v)
    del init
    rows = [pool[i] for i in range(FIRST_STEPS)]
    gh, gw = tr['height'] // 8, tr['width'] // 8
    lat_shape = (1, (tr['frames'] - 1) // 4 + 1, gh, gw,
                 cfg['vae']['z_channels'])
    if dev.type == 'cuda':
        prims.set_fp32_matmul()
    shapes = {k: v.shape for k, v in sd.items()}
    t_ref = time.perf_counter()
    ref = reference_three_steps(prims.FP32, sd, cfg, rows, seed, dev,
                                lat_shape)
    ref_s = time.perf_counter() - t_ref
    numbers = compare(prog, ref)
    keep = list(ref['grad1'])
    for what in ('grad1', 'delta3'):
        for row in worst_leaves(prog[what], ref[what], keep):
            print(f'leaf {what} gap {row[0]} {row[1]} program {row[2]} '
                  f'reference {row[3]}', file=sys.stderr)
    print(f'losses program {prog["losses"]} reference {ref["losses"]}',
          file=sys.stderr)
    flops = model_flops(cfg, tr, shapes)
    return {
        'units': steps, 'window_s': window_s, 'setup_s': setup_s,
        'peak_bytes': peak, 'setup_peak_bytes': setup_peak,
        'attempted': steps, 'failed': 0, 'numbers': numbers,
        'reference_s': ref_s, 'profile': prof,
        'batch_s': timing['batch_s'], 'step_ms': step_ms,
        'model_flops_per_unit': flops,
        'e2e': {'train_step_s': window_s / steps},
        'compared': (prog, ref),
    }


def reference_three_steps(p, sd, cfg, rows, seed, device, lat_shape) -> dict:
    """The reference's first three steps: losses, the first (clipped)
    gradient and the masters' change, by the program's master names.
    Empties `sd` (the bf16 weights) as it goes."""
    draws = reference_draws(device, seed, lat_shape, len(rows))
    # each tower's bf16 weights leave `sd` as their float32 copy is made
    enc = {k: sd.pop(k).float() for k in list(sd)
           if k.startswith(('t5.', 'vae.'))}
    with torch.no_grad():
        batches = reference_batches(p, enc, cfg, rows, draws, device)
    del enc
    common.free(device)
    dit = {k: sd.pop(k).float() for k in list(sd) if k.startswith('dit.')}
    init = {n: dit[n].clone() for n in dit if cogvideox.is_trainable(n)}
    out = {}

    def on_step(step, masters, grads):
        if step == 1:
            out['grad1'] = {n[4:]: g for n, g in grads.items()}
        if step == len(rows):
            out['delta3'] = {n[4:]: (m.detach() - init[n])
                             for n, m in masters.items()}

    out['losses'] = cogvideox.train(p, dit, cfg['dit'], optimizer_of(cfg),
                                    batches, on_step)
    return out


def model_flops(cfg: dict, tr: dict, shapes: dict) -> float:
    """Model FLOPs of one step (the batch's T5 and two VAE encodes, the
    DiT's forward and backward without recompute), counted on the meta
    device from the reference at the cell's shapes."""
    meta = {k: torch.empty(v, device='meta', dtype=torch.float32)
            for k, v in shapes.items()}
    d, v, t = cfg['dit'], cfg['vae'], cfg['text']
    f, h, w = tr['frames'], tr['height'], tr['width']
    lat = (1, (f - 1) // 4 + 1, h // 8, w // 8, v['z_channels'])
    with FlopCount() as fc:
        with torch.no_grad():
            cogvideox.t5_encode(prims.FP32, prims.Weights(meta, 't5.'),
                                torch.zeros(1, d['text_length'],
                                            dtype=torch.long,
                                            device='meta'),
                                t['num_heads'], t['num_layers'])
            for _ in range(2):
                cogvideox.causal_vae_encode_moments(
                    prims.FP32, prims.Weights(meta, 'vae.encoder.'),
                    torch.empty(1, f, h, w, 3, device='meta'),
                    len(v['ch_mult']), v['num_res_blocks'])
        live = dict(meta)
        for n in live:
            if n.startswith('dit.') and cogvideox.is_trainable(n):
                live[n] = live[n].requires_grad_(True)
        x = torch.empty(lat[:-1] + (2 * lat[-1],), device='meta')
        y = torch.empty(1, d['text_length'], d['text_hidden_size'],
                        device='meta')
        out = cogvideox.dit_forward(prims.FP32, prims.Weights(live, 'dit.'),
                                    d, x, torch.zeros(1, dtype=torch.long,
                                                      device='meta'),
                                    y, remat=False, plain_attention=True)
        out.sum().backward()
    return fc.flops
