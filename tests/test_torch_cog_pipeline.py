"""The CogVideoX slice as a whole, and its diffusion math:

  * the ZeroSNR-DDPM ladder, the EDM and Legacy-DDPM ladders, the
    VideoScaling constants and the DynamicCFG schedule against star_tpu's
    (the same float64 numpy: equal to 1e-12);
  * the VPSDE and VPODE DPM++(2M) samplers against star_tpu's with a
    closed-form denoiser, the SDE with the very noises the JAX sampler
    draws, and against the vpsde_sampler / vpode_sampler goldens with zero
    noise at the JAX tests' atol 1e-4 (test_golden_parity.py);
  * the port's tiny CogVideoSRPipeline.enhance_a_video (the models of
    tests/test_cogvideo_pipeline.py, with a tiny T5) against star_tpu's
    own CogVideoSRPipeline: the port is handed the posterior eps, the
    initial noise and the per-step SDE noises that the JAX pipeline draws
    from its seed, so both compute the same function of the same numbers.
    uint8 within one level (a value on a rounding boundary may round
    either way in fp32).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from star_tpu_torch.diffusion import (EDMDiscretization,
                                      LegacyDDPMDiscretization,
                                      ZeroSNRDDPMDiscretization,
                                      dynamic_cfg_scale,
                                      sample_vpode_dpmpp_2m,
                                      sample_vpsde_dpmpp_2m, video_scaling,
                                      vpsde_dpmpp_2m_ladder)
from star_tpu_torch.models.dit.dit import CogVideoDiT
from star_tpu_torch.models.t5.encoder import T5Encoder
from star_tpu_torch.models.t5.tokenizer import T5HashTokenizer
from star_tpu_torch.pipeline import (CogModelBundle, CogSamplerConfig,
                                     CogVideoSRPipeline)
from star_tpu_torch.vae.causal_vae import CogVideoVAE
from test_torch_harness import port, random_params, randn, rng

GOLDENS = os.path.join(os.path.dirname(__file__), '..', 'goldens')


def _golden(name):
    path = os.path.join(GOLDENS, name)
    if not os.path.exists(path):
        pytest.skip(f'golden {name} not present')
    return np.load(path)


@pytest.mark.parametrize('shift', [1.0, 3.0])
def test_ladders_and_constants_match_star_tpu(shift):
    from star_tpu.diffusion import zero_snr as jz
    from star_tpu.diffusion.vpsde_sampler import vpsde_dpmpp_2m_ladder as jl
    for n in (50, 12, 1000):
        ours = ZeroSNRDDPMDiscretization(shift_scale=shift)
        theirs = jz.ZeroSNRDDPMDiscretization(shift_scale=shift)
        s, idx = ours.get_sqrt_alphas(n, return_idx=True)
        js, jidx = theirs.get_sqrt_alphas(n, return_idx=True)
        np.testing.assert_allclose(s, js, rtol=0, atol=1e-12)
        np.testing.assert_array_equal(idx, jidx)
        for a, b in zip(vpsde_dpmpp_2m_ladder(ours, min(n, 50)),
                        jl(theirs, min(n, 50))):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    np.testing.assert_allclose(EDMDiscretization()(10),
                               jz.EDMDiscretization()(10), atol=1e-12)
    np.testing.assert_allclose(LegacyDDPMDiscretization()(25, flip=True),
                               jz.LegacyDDPMDiscretization()(25, flip=True),
                               atol=1e-12)
    for a, b in zip(video_scaling(s), jz.video_scaling(s)):
        np.testing.assert_allclose(a, b, atol=1e-12)
    for i in (0.0, 17.0, 949.0):
        assert dynamic_cfg_scale(6.0, 5.0, 50, i) == \
            jz.dynamic_cfg_scale(6.0, 5.0, 50, i)


def _denoise_torch(x, t, a, scale):
    u = torch.tanh(x) * a - 0.2
    c = torch.tanh(x) * a + 0.3
    return u + scale * (c - u)


def _denoise_jax(x, t, a, scale):
    u = jnp.tanh(x) * a - 0.2
    c = jnp.tanh(x) * a + 0.3
    return u + scale * (c - u)


def test_vpsde_sampler_matches_star_tpu_with_its_noises():
    from star_tpu.diffusion import zero_snr as jz
    from star_tpu.diffusion.vpsde_sampler import sample_vpsde_dpmpp_2m as js
    n, shape = 8, (1, 3, 4, 5, 4)
    x0 = randn(rng(70), *shape)
    key = jax.random.PRNGKey(7)
    keys = jax.random.split(key, n)
    noises = [torch.from_numpy(np.array(jax.random.normal(
        keys[i], shape, jnp.float32))) for i in range(n - 1)]
    want = js(_denoise_jax, jnp.asarray(x0), jz.ZeroSNRDDPMDiscretization(),
              n, key)
    got = sample_vpsde_dpmpp_2m(_denoise_torch, torch.from_numpy(x0),
                                ZeroSNRDDPMDiscretization(), n,
                                noises=noises)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # the noise matters: without it the trajectory differs
    zero = sample_vpsde_dpmpp_2m(_denoise_torch, torch.from_numpy(x0),
                                 ZeroSNRDDPMDiscretization(), n,
                                 noises=[torch.zeros(shape)] * (n - 1))
    assert not torch.allclose(zero, got, atol=1e-3)


def test_vpsde_sampler_golden():
    data = _golden('vpsde_sampler.npz')
    n = int(data['num_steps'])
    disc = ZeroSNRDDPMDiscretization()
    ladder, t_for_step = vpsde_dpmpp_2m_ladder(disc, n)
    np.testing.assert_allclose(ladder, data['ladder'], atol=1e-6)
    np.testing.assert_array_equal(
        t_for_step, np.concatenate([[-1], data['timesteps']])[::-1][:n])
    x0 = torch.from_numpy(data['x0'])
    out = sample_vpsde_dpmpp_2m(_denoise_torch, x0, disc, n,
                                noises=[torch.zeros(x0.shape)] * (n - 1))
    np.testing.assert_allclose(out.numpy(), data['out'], atol=1e-4)


def test_vpode_sampler_golden_and_star_tpu():
    from star_tpu.diffusion import zero_snr as jz
    from star_tpu.diffusion.vpsde_sampler import sample_vpode_dpmpp_2m as jo
    data = _golden('vpode_sampler.npz')
    n = int(data['num_steps'])
    out = sample_vpode_dpmpp_2m(_denoise_torch, torch.from_numpy(data['x0']),
                                ZeroSNRDDPMDiscretization(), n)
    np.testing.assert_allclose(out.numpy(), data['out'], atol=1e-4)
    want = jo(_denoise_jax, jnp.asarray(data['x0']),
              jz.ZeroSNRDDPMDiscretization(), n)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(EDMDiscretization()(10), data['edm_sigmas'],
                               atol=1e-5)
    np.testing.assert_allclose(LegacyDDPMDiscretization()(25),
                               data['legacy_sigmas'], atol=1e-4)


# ------------------------------------------------------ the tiny pipeline

CTX, TEXT_LEN, STEPS = 32, 8, 4
DIT_KW = dict(hidden_size=64, num_layers=2, num_heads=4, patch_size=2,
              latent_channels=4, text_hidden_size=CTX, text_length=TEXT_LEN,
              time_embed_dim=16)
VAE_KW = dict(ch=32, ch_mult=(1, 1, 1, 1), num_res_blocks=1, z_channels=4)
T5_KW = dict(vocab_size=100, d_model=CTX, d_ff=48, num_heads=2, num_layers=2)
FRAMES = (17, 32, 48)     # 5 latent frames of 4x6: two decode windows


class Tok(T5HashTokenizer):
    def __call__(self, texts, max_length=TEXT_LEN):
        return super().__call__(texts, max_length) % T5_KW['vocab_size']


@pytest.fixture(scope='module')
def pipes():
    from star_tpu.models.dit.dit import CogVideoDiT as JDiT
    from star_tpu.models.t5.encoder import T5Encoder as JT5
    from star_tpu.pipeline.cogvideo_sr import CogModelBundle as JBundle
    from star_tpu.pipeline.cogvideo_sr import CogSamplerConfig as JCfg
    from star_tpu.pipeline.cogvideo_sr import CogVideoSRPipeline as JPipe
    from star_tpu.vae import causal_vae as jcv

    class TinyVAE(jcv.CogVideoVAE):
        def setup(self):
            self.encoder = jcv.CausalEncoder3D(**VAE_KW, name='encoder')
            self.decoder = jcv.CausalDecoder3D(**VAE_KW, name='decoder')

    dit, vae, t5 = JDiT(**DIT_KW), TinyVAE(), JT5(**T5_KW)
    dp = random_params(dit, jnp.zeros((2, 3, 4, 6, 8)),
                       jnp.zeros((2,), jnp.int32),
                       jnp.zeros((2, TEXT_LEN, CTX)), seed=71)
    vp = random_params(vae, jnp.zeros((1, 5, 16, 16, 3)), seed=72)
    tp = random_params(t5, jnp.zeros((1, TEXT_LEN), jnp.int32), seed=73)

    def vae_decode_window(p, latents, cache, first):
        variables = {'params': p['params'], **({'cache': cache} if cache
                                               else {})}
        out, mut = vae.apply(variables, latents, True, first,
                             method=TinyVAE.decode, mutable=['cache'])
        return out, mut['cache']

    jpipe = JPipe(JBundle(
        dit_apply=lambda p, x, t, c: dit.apply(p, x, t, c),
        vae_encode=lambda p, v, key: vae.apply(p, v, key,
                                               method=TinyVAE.encode),
        vae_decode_window=vae_decode_window,
        text_encode=lambda p, tok: t5.apply(p, tok), tokenizer=Tok(),
        params={'dit': dp, 'vae': vp, 'text': tp}), JCfg(num_steps=STEPS))
    bundle = CogModelBundle(port(CogVideoDiT(**DIT_KW), dp),
                            port(CogVideoVAE(**VAE_KW), vp),
                            port(T5Encoder(**T5_KW), tp), Tok())
    return jpipe, bundle


def jax_draws(seed, t_lat):
    """The numbers star_tpu's CogVideoSRPipeline draws from its seed."""
    k_enc, k_noise, k_solve = jax.random.split(jax.random.PRNGKey(seed), 3)
    shape = (1, t_lat, FRAMES[1] // 8, FRAMES[2] // 8, 4)
    keys = jax.random.split(k_solve, STEPS)
    as_t = lambda a: torch.from_numpy(np.array(a))
    return {'enc_eps': as_t(jax.random.normal(k_enc, shape, jnp.float32)),
            'init': as_t(jax.random.normal(k_noise, shape, jnp.float32)),
            'sde': [as_t(jax.random.normal(keys[i], shape, jnp.float32))
                    for i in range(STEPS - 1)]}


def test_enhance_a_video_matches_star_tpu(pipes):
    jpipe, bundle = pipes
    frames = rng(74).uniform(0, 255, (*FRAMES, 3)).astype(np.uint8)
    want = jpipe.enhance_a_video(frames, 'a boat', seed=3)
    pipe = CogVideoSRPipeline(bundle, CogSamplerConfig(num_steps=STEPS),
                              device='cpu', time_stages=True)
    got = pipe.enhance_a_video(frames, 'a boat', seed=3,
                               noise=jax_draws(3, 5))
    assert got.shape == want.shape == (*FRAMES, 3)
    assert got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert got.std() > 0
    assert set(pipe.stage_seconds) == {'text', 'vae_encode', 'denoise',
                                       'vae_decode', 'color_fix'}
    assert pipe.last_latents.shape == (1, 5, 4, 6, 4)


def test_enhance_is_deterministic_and_seeded(pipes):
    _, bundle = pipes
    pipe = CogVideoSRPipeline(bundle, CogSamplerConfig(num_steps=2),
                              device='cpu')
    frames = rng(75).uniform(0, 255, (9, 32, 48, 3)).astype(np.uint8)
    a = pipe.enhance_a_video(frames, 'prompt', seed=123)
    b = pipe.enhance_a_video(frames, 'prompt', seed=123)
    c = pipe.enhance_a_video(frames, 'prompt', seed=124)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a.astype(int) - c.astype(int)).max() > 0
    assert pipe.stage_seconds == {}          # time_stages is off
    for f in (21, 8):       # 6 latents (even); not 4k+1
        with pytest.raises(ValueError, match='4k\\+1'):
            pipe.enhance_a_video(np.zeros((f, 32, 48, 3), np.uint8), 'x')
