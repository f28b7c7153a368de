"""The slice as a whole: the port's tiny STARPipeline.enhance_a_video
against a JAX reference composed from star_tpu's public functions in the
order of STARPipeline's solve and decode graphs — upsample and pad, VAE
encode with a posterior sample, SDEdit diffuse to t=899, chunked CFG
denoising with DPM++(2M)-SDE over UNet+ControlNet (cfg_pair), windowed VAE
decode, unpad, AdaIN colour fix, uint8.

Both sides get the same numpy encoder eps and diffuse noise and s_noise=0
(the JAX pipeline draws its own SDE noise, so it is composed here rather
than called). The uint8 results may differ by one level where a value sits
on a rounding boundary; nothing else is allowed.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from star_tpu_torch.config import PipelineConfig, SamplerConfig
from star_tpu_torch.models.clip.text import CLIPTextEncoder
from star_tpu_torch.models.clip.tokenizer import HashTokenizer
from star_tpu_torch.models.unet.unet import ControlledV2VUNet
from star_tpu_torch.pipeline import ModelBundle, STARPipeline
from star_tpu_torch.vae.svd_vae import SVDTemporalVAE
from test_torch_harness import port, random_params, randn, rng

UNET_KW = dict(dim=32, dim_mult=(1, 2), num_res_blocks=1,
               attn_scales=(1.0, 0.5), head_dim=16,
               num_heads_init_temporal=2, context_dim=32)
VAE_CHS = (32, 32, 32, 32)
CLIP_KW = dict(vocab_size=1000, width=32, heads=2, layers=2)
CFG = PipelineConfig(
    sampler=SamplerConfig(steps=3, solver_mode='normal', s_noise=0.0),
    upscale=4, max_chunk_len=4, pad_grid=(80, 64))


class SmallVocabTok(HashTokenizer):
    def __call__(self, texts, context_length=77):
        return np.clip(super().__call__(texts, context_length) % 1000, 0,
                       999)


@pytest.fixture(scope='module')
def models():
    from star_tpu.models.clip.text import CLIPTextEncoder as JCLIP
    from star_tpu.models.unet.unet import ControlledV2VUNet as JUNet
    from star_tpu.vae import svd_vae as jsv

    class TinyVAE(jsv.SVDTemporalVAE):
        def setup(self):
            self.encoder = jsv.Encoder(block_out_channels=VAE_CHS,
                                       layers_per_block=1, name='encoder')
            self.decoder = jsv.TemporalDecoder(block_out_channels=VAE_CHS,
                                               layers_per_block=1,
                                               name='decoder')

    z = jnp.zeros((1, 2, 10, 8, 4))
    ju, jv, jt = JUNet(**UNET_KW), TinyVAE(), JCLIP(**CLIP_KW)
    up = random_params(ju, z, jnp.zeros((1,), jnp.int32),
                       jnp.zeros((1, 77, 32)), z, seed=20)
    vp = random_params(jv, jnp.zeros((1, 2, 16, 16, 3)), seed=21)
    tp = random_params(jt, jnp.zeros((1, 77), jnp.int32), seed=22)
    bundle = ModelBundle(
        unet=port(ControlledV2VUNet(**UNET_KW), up),
        vae=port(SVDTemporalVAE(VAE_CHS, encoder_layers=1,
                                decoder_layers=1), vp),
        text=port(CLIPTextEncoder(**CLIP_KW), tp),
        tokenizer=SmallVocabTok())
    return dict(jax=(ju, up, jv, vp, jt, tp), port=bundle)


def jit_o0(fn):
    """jax.jit compiled at XLA's lowest backend optimisation level, which
    halves the compile time of the UNet and the VAE decoder on the CPU."""
    compiled = {}

    def call(*args):
        key = tuple((a.shape, a.dtype) for a in args)
        if key not in compiled:
            compiled[key] = jax.jit(fn).lower(*args).compile(
                compiler_options={'xla_backend_optimization_level': 0})
        return compiled[key](*args)
    return call


def jax_reference(models, frames, prompt, enc_eps, diffuse_noise):
    """star_tpu's STARPipeline._build_run, composed from public functions
    with injected noise."""
    from star_tpu.diffusion import (DiffusionTables, build_sigma_ladder,
                                    default_star_schedule, denoise_to_x0,
                                    diffuse, sample_dpmpp_2m_sde)
    from star_tpu.ops.resize import pad_to_fit, resize_bilinear
    from star_tpu.pipeline.chunking import chunked_x0_fn, make_chunks
    from star_tpu.pipeline.color_fix import adain_color_fix
    ju, up, jv, vp, jt, tp = models['jax']
    tok = models['port'].tokenizer
    sc = CFG.sampler
    f, h, w, _ = frames.shape
    th, tw = h * CFG.upscale, w * CFG.upscale
    w1, w2, h1, h2 = pad_to_fit(th, tw, CFG.pad_grid)

    text = jax.jit(jt.apply)
    y_c = text(tp, tok([prompt + CFG.positive_prompt]))
    y_u = text(tp, tok([CFG.negative_prompt]))
    video = (jnp.asarray(frames, jnp.float32) / 255.0 - 0.5) / 0.5
    padded = jnp.pad(resize_bilinear(video, th, tw)[None],
                     ((0, 0), (0, 0), (h1, h2), (w1, w2), (0, 0)),
                     constant_values=CFG.pad_value)
    moments = jax.jit(lambda p, v: jv.apply(p, v, method=jv.encode_moments))(
        vp, padded)
    mean, logvar = jnp.split(moments, 2, axis=-1)
    std = jnp.exp(0.5 * jnp.clip(logvar, -30.0, 20.0))
    z = (mean + std * enc_eps) * 0.18215

    schedule = default_star_schedule()
    tables = DiffusionTables.from_schedule(schedule)
    noised = diffuse(tables, z, jnp.full((1,), sc.total_noise_levels - 1,
                                         jnp.int32), diffuse_noise)
    unet = jit_o0(lambda *a: ju.apply(up, *a, cfg_pair=True))

    def denoise_chunk(xt, hint, tt):
        bb = xt.shape[0]
        yp = jnp.concatenate([jnp.tile(y_c, (bb, 1, 1)),
                              jnp.tile(y_u, (bb, 1, 1))], axis=0)
        tfull = jnp.full((bb,), tt, jnp.int32)
        v_c, v_u = jnp.split(unet(xt, tfull, yp, hint), 2, axis=0)
        return denoise_to_x0(tables, xt, tfull, v_c, v_u,
                             guide_scale=sc.guide_scale,
                             guide_rescale=sc.guide_rescale)

    chunks = make_chunks(f, CFG.max_chunk_len)
    x0_fn = chunked_x0_fn(denoise_chunk, z, chunks)

    def model_fn(x, t):
        # the sampler scans its middle steps, and tracing the UNet into the
        # scan would compile it a second time (half a minute on one core);
        # a host callback runs the UNet compiled once above
        return jax.pure_callback(
            lambda x, t: np.asarray(x0_fn(jnp.asarray(x), jnp.asarray(t)),
                                    np.float32),
            jax.ShapeDtypeStruct(x.shape, jnp.float32), x, t)

    sigmas = build_sigma_ladder(schedule, steps=sc.steps,
                                t_max=sc.total_noise_levels - 1, t_min=0,
                                solver_mode=sc.solver_mode,
                                discretization=sc.discretization)
    gen = sample_dpmpp_2m_sde(model_fn, noised, schedule, sigmas,
                              jax.random.PRNGKey(0), s_noise=0.0)
    out = jit_o0(lambda g: jv.apply(vp, g, method=jv.decode))(gen)
    out = out[0, :, h1:h1 + th, w1:w1 + tw, :]
    out = jnp.clip(out * 0.5 + 0.5, 0.0, 1.0) * 255.0
    out = adain_color_fix(out, video)
    return np.asarray(jnp.round(jnp.clip(out, 0.0, 255.0)).astype(jnp.uint8))


def test_enhance_a_video_matches_star_tpu(models):
    r = rng(30)
    # 6 frames: two overlapping 4-frame chunks, two 3-frame decode windows;
    # 18x14 -> 72x56, padded to the 80x64 grid and cropped back
    frames = r.uniform(0, 255, (6, 18, 14, 3)).astype(np.uint8)
    enc_eps = randn(r, 1, 6, 10, 8, 4)
    noise = randn(r, 1, 6, 10, 8, 4)
    want = jax_reference(models, frames, 'a cat', enc_eps, noise)
    pipe = STARPipeline(models['port'], CFG, device='cpu')
    got = pipe.enhance_a_video(frames, 'a cat', noise={
        'enc_eps': torch.from_numpy(enc_eps),
        'diffuse': torch.from_numpy(noise)})
    assert got.shape == want.shape == (6, 72, 56, 3)
    assert got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert got.std() > 0


def test_enhance_is_deterministic_and_seeded(models):
    cfg = PipelineConfig(sampler=SamplerConfig(steps=2, solver_mode='normal'),
                         upscale=4, max_chunk_len=4, pad_grid=(80, 64))
    pipe = STARPipeline(models['port'], cfg, device='cpu')
    frames = rng(31).uniform(0, 255, (3, 18, 14, 3)).astype(np.uint8)
    a = pipe.enhance_a_video(frames, 'prompt', seed=123)
    b = pipe.enhance_a_video(frames, 'prompt', seed=123)
    c = pipe.enhance_a_video(frames, 'prompt', seed=124)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a.astype(int) - c.astype(int)).max() > 0
    assert set(pipe.stage_seconds) == set()   # time_stages is off


def test_pipeline_stages_are_timed_when_asked(models):
    cfg = PipelineConfig(sampler=SamplerConfig(steps=2, solver_mode='normal'),
                         upscale=4, max_chunk_len=4, pad_grid=(80, 64),
                         color_fix='wavelet')
    pipe = STARPipeline(models['port'], cfg, device='cpu', time_stages=True)
    frames = rng(32).uniform(0, 255, (3, 18, 14, 3)).astype(np.uint8)
    out = pipe.enhance_a_video(frames, 'prompt', seed=1)
    assert out.shape == (3, 72, 56, 3)
    assert set(pipe.stage_seconds) == {'text', 'vae_encode', 'denoise',
                                       'vae_decode', 'color_fix'}
