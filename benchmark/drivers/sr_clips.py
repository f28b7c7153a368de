"""Traffic kind `sr_clips`: one client in a closed loop sends distinct
clips to the I2VGen-XL super-resolution job loop
(star_tpu_torch.cli.inference_sr.run_jobs) with an in-memory loader and
saver.

The window runs from the first clip's start to the last clip's save. The
first clip always starts. Clip k >= 1 is decided when the job loop asks
for it: clip 1 at once, clip k >= 2 once clip k-2 is saved (run_jobs
saves a clip after queueing the next, and queueing a clip waits for the
card to finish the one before, so by then k clips have run). It starts
only while the elapsed time plus the mean clip time so far (the elapsed
time over the k clips started) stays within the window's seconds. Clip 1
is asked for before clip 0 has run, so it starts only while the elapsed
time plus two warm clips fits. Each clip's frames are made before its
decision, while the clip before runs, so that the window holds no work of
the harness's.

After the window one clip, drawn from the seed, is computed again by the
plain float32 reference from the same frames, tokens, weights and noise,
and the output is compared (`compare`)."""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..harness import common, inputs
from ..harness.weights import assign, make_weights, to_float32
from ..harness.work import FlopCount
from ..reference import prims, sr_pipeline


class ClipGate:
    """The window's clip queue with its admission rule."""

    def __init__(self, seconds: float, prior_s: float, max_clips: int,
                 clock=time.perf_counter):
        self.seconds, self.prior_s = seconds, prior_s
        self.max_clips, self.clock = max_clips, clock
        self.t0 = None
        self.saved: list[float] = []       # clock at each save
        self._cond = threading.Condition()

    def start(self) -> None:
        self.t0 = self.clock()

    def mark_saved(self) -> None:
        with self._cond:
            self.saved.append(self.clock())
            self._cond.notify_all()

    def admit(self, k: int) -> bool:
        """Whether clip k (k >= 1) starts, decided once clip k-2 is saved."""
        with self._cond:
            self._cond.wait_for(lambda: len(self.saved) >= k - 1)
            elapsed = self.clock() - self.t0
            if k == 1:      # asked for at once: clip 0, then clip 1
                return elapsed + 2 * self.prior_s <= self.seconds
            return elapsed + elapsed / k <= self.seconds

    def jobs(self, make=lambda k: k):
        """The window's jobs: clip k's is made before its decision, so that
        making it overlaps the clip before, and yielded if it starts."""
        yield make(0)
        for k in range(1, self.max_clips):
            job = make(k)
            if not self.admit(k):
                return
            yield job

    @property
    def window_s(self) -> float:
        return self.saved[-1] - self.t0


class Clip:
    """A job's source: the frames of clip k, made ahead of the window's
    need (the job loop logs a source by its name)."""

    def __init__(self, k: int, frames):
        self.k, self.frames = k, frames

    def __str__(self):
        return f'clip {self.k}'


class Recorder:
    """The pipeline as run_jobs sees it, with each clip's host start and
    (when the pipeline times its stages) its stage seconds noted."""

    def __init__(self, pipe, spans: bool):
        self.pipe, self.spans = pipe, spans
        self.clips: list[dict] = []

    def enhance_a_video_async(self, frames, prompt, seed=666, **kw):
        t0 = time.perf_counter()
        if self.spans:
            with torch.profiler.record_function('clip'):
                out = self.pipe.enhance_a_video_async(frames, prompt,
                                                      seed=seed, **kw)
        else:
            out = self.pipe.enhance_a_video_async(frames, prompt, seed=seed,
                                                  **kw)
        self.clips.append({'start': t0,
                           'stages': dict(self.pipe.stage_seconds)})
        return out


def build(cfg: dict, seed: int, device, dtype=torch.bfloat16):
    """The program's pipeline at the configuration's sizes, on weights
    drawn from the seed; returns (pipe, state dict)."""
    from star_tpu_torch.config import PipelineConfig, SamplerConfig
    from star_tpu_torch.models.clip.text import CLIPTextEncoder
    from star_tpu_torch.models.unet.unet import ControlledV2VUNet
    from star_tpu_torch.pipeline.video_sr import ModelBundle, STARPipeline
    from star_tpu_torch.vae.svd_vae import SVDTemporalVAE

    u, v, t, pl, sm = (cfg['unet'], cfg['vae'], cfg['text'],
                       cfg['pipeline'], cfg['sampler'])
    with torch.device('meta'):
        unet = ControlledV2VUNet(
            dim=u['dim'], dim_mult=tuple(u['dim_mult']),
            num_res_blocks=u['num_res_blocks'],
            attn_scales=tuple(u['attn_scales']), head_dim=u['head_dim'],
            num_heads_init_temporal=u['num_heads_init_temporal'],
            context_dim=u['context_dim'])
        vae = SVDTemporalVAE(
            block_out_channels=tuple(v['block_out_channels']),
            encoder_layers=v['encoder_layers'],
            decoder_layers=v['decoder_layers'],
            decode_window=pl['vae_decode_window'])
        text = CLIPTextEncoder(vocab_size=t['vocab_size'], width=t['width'],
                               heads=t['heads'], layers=t['layers'],
                               context_length=t['context_length'],
                               penultimate=t['penultimate'])
    towers = {'unet.': unet, 'vae.': vae, 'text.': text}
    sd = {}
    for i, (prefix, m) in enumerate(towers.items()):
        sd.update(make_weights(m, seed * 8 + i, device, dtype, prefix))
    for prefix, m in towers.items():
        assign(m, sd, prefix)
    config = PipelineConfig(
        sampler=SamplerConfig(
            steps=sm['steps'], solver=sm['solver'],
            solver_mode=sm['solver_mode'], guide_scale=sm['guide_scale'],
            guide_rescale=sm['guide_rescale'],
            total_noise_levels=sm['total_noise_levels'],
            discretization=sm['discretization'], eta=sm['eta'],
            s_noise=sm['s_noise']),
        upscale=pl['upscale'], max_chunk_len=pl['max_chunk_len'],
        chunk_overlap_ratio=pl['chunk_overlap_ratio'],
        vae_decode_window=pl['vae_decode_window'],
        color_fix=pl['color_fix'], positive_prompt=pl['positive_prompt'],
        negative_prompt=pl['negative_prompt'], pad_value=pl['pad_value'],
        pad_grid=tuple(pl['pad_grid']))
    tok = inputs.WordHashTokenizer(t['context_length'], t['vocab_size'])
    pipe = STARPipeline(ModelBundle(unet, vae, text, tok), config,
                        device=device)
    return pipe, sd


def draw_noise(device, seed: int, latent_shape, sde_draws: int) -> dict:
    """The numbers the pipeline draws from its job seed, in its order: the
    posterior's eps, the diffuse draw, one per SDE step (float32)."""
    g = torch.Generator(device=device).manual_seed(seed)
    draw = lambda: torch.randn(latent_shape, generator=g, device=device,
                               dtype=torch.float32)
    return {'enc_eps': draw(), 'diffuse': draw(),
            'sde': [draw() for _ in range(sde_draws)]}


def compare(out: np.ndarray, ref: torch.Tensor) -> dict:
    """The served clip (uint8) against the reference's (0..255 float):
    the mean and the 99.9th percentile of the absolute gap, in levels."""
    d = (torch.as_tensor(out, device=ref.device).float() - ref).abs()
    flat = d.flatten()
    k = max(1, int(round(flat.numel() * 0.001)))
    return {'mean_abs_gap': float(flat.mean()),
            'p999_abs_gap': float(flat.topk(k).values[-1]),
            'max_abs_gap': float(flat.max())}


def run(ctx: dict) -> dict:
    cfg, tr, dev = ctx['config'], ctx['traffic'], ctx['device']
    seed, trace = ctx['seed'], ctx['trace']
    f, h, w = tr['frames'], tr['height'], tr['width']
    caps = inputs.captions(seed, tr['captions'], tr['caption_words'])
    job_seed = seed % (1 << 63)

    pipe, sd = build(cfg, seed, dev)
    from star_tpu_torch.cli.inference_sr import run_jobs
    warm_s = pipe.warm(f, h, w)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == 'cuda' \
        else (lambda: None)
    sync()
    setup_peak = (torch.cuda.max_memory_allocated(dev)
                  if dev.type == 'cuda' else 0)

    gate = ClipGate(ctx['seconds'], warm_s, tr['max_clips'])
    saved = {}
    rec = Recorder(pipe, spans=trace)
    pipe.time_stages = trace

    def make(k):
        return (Clip(k, inputs.clip_frames(seed, k, f, h, w)),
                caps[k % len(caps)], k)

    def save(frames, name, fps):
        saved[name] = frames
        gate.mark_saved()
        return name

    jobs = gate.jobs(make)
    load = lambda clip: (clip.frames, tr['fps'])
    log = ctx['launch_log']
    if dev.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.time() - ctx['t_process']
    with ctx['profile']() as prof, log.recording():
        with torch.profiler.record_function('window'):
            gate.start()
            run_jobs(rec, jobs, load, save, seed=job_seed)
    window_s = gate.window_s
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == 'cuda'
            else 0)
    n_clips = len(saved)

    # the program's state is freed before the reference runs
    clips = rec.clips
    del pipe, rec
    common.free(dev)
    pick = int(np.random.default_rng([seed, 3]).integers(n_clips))
    tok = inputs.WordHashTokenizer(cfg['text']['context_length'],
                                   cfg['text']['vocab_size'])
    pl = cfg['pipeline']
    cond = torch.as_tensor(tok([caps[pick % len(caps)]
                                + pl['positive_prompt']]), device=dev)
    uncond = torch.as_tensor(tok([pl['negative_prompt']]), device=dev)
    gh, gw = pl['pad_grid']
    shape = (1, f, gh // 8, gw // 8, cfg['vae']['latent_channels'])
    noise = draw_noise(dev, job_seed, shape, sr_pipeline.sde_steps(
        cfg['sampler']['steps']))
    sd32 = to_float32(sd)
    del sd
    frames = torch.as_tensor(inputs.clip_frames(seed, pick, f, h, w),
                             device=dev)
    prims.set_fp32_matmul()
    t_ref = time.perf_counter()
    with torch.no_grad(), FlopCount() as fc:
        ref = sr_pipeline.enhance(prims.FP32, sd32, cfg, frames, cond,
                                  uncond, noise)
    ref_s = time.perf_counter() - t_ref
    numbers = compare(saved[pick], ref)
    return {
        'units': n_clips, 'frames': n_clips * f, 'window_s': window_s,
        'setup_s': setup_s, 'peak_bytes': peak,
        'setup_peak_bytes': setup_peak, 'warm_s': warm_s,
        'attempted': n_clips, 'failed': 0, 'numbers': numbers,
        'reference_s': ref_s, 'clips': clips, 'saved_at': list(gate.saved),
        't0': gate.t0, 'profile': prof,
        'model_flops_per_unit': fc.flops,
        'e2e': {'sr_frames_per_s': n_clips * f / window_s},
    }
