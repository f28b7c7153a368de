"""The port's plain operators and diffusion math against star_tpu's:
norms, resize and padding, the fused GN+SiLU+conv3x3 (the XLA route, with
statistics threading), the nearest-2x upsample convs, colour fixes,
chunking, schedules, v-prediction math and both samplers. fp32, tolerance
1e-4 of the reference magnitude (test_torch_harness.py).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from star_tpu_torch.diffusion import (DiffusionTables, build_sigma_ladder,
                                      default_star_schedule, denoise_to_x0,
                                      sample_dpmpp_2m_sde, sample_heun)
from star_tpu_torch.ops import conv3x3, norms, resize, upsample_conv
from star_tpu_torch.pipeline import chunking, color_fix
from test_torch_harness import assert_close, randn, rng, t

jnorms = importlib.import_module('star_tpu.ops.norms')
jresize = importlib.import_module('star_tpu.ops.resize')
jconv = importlib.import_module('star_tpu.ops.conv3x3')
jup = importlib.import_module('star_tpu.ops.upsample_conv')


def test_norms():
    r = rng(40)
    x = randn(r, 2, 3, 5, 64)
    sc, bi = randn(r, 64, scale=0.1) + 1, randn(r, 64, scale=0.1)
    g = np.abs(randn(r, 2, 3, 5, 1)) + 0.1
    gw = randn(r, 2)
    jx = jnp.asarray(x)
    assert_close(norms.group_norm(t(x), t(sc), t(bi), 32, 1e-6),
                 jnorms.group_norm(jx, sc, bi, 32, 1e-6))
    assert_close(norms.layer_norm(t(x), t(sc), t(bi)),
                 jnorms.layer_norm(jx, sc, bi))
    assert_close(norms.gated_layer_norm(t(x), t(sc), t(bi), t(g)),
                 jnorms.gated_layer_norm(jx, sc, bi, g))
    assert_close(norms.liem_layer_norm(t(x), t(sc), t(bi), t(gw)),
                 jnorms.liem_layer_norm(jx, sc, bi, gw))


@pytest.mark.parametrize('hw,grid', [((36, 16), (144, 64)),
                                     ((180, 320), (720, 1280)),
                                     ((800, 1300), (720, 1280))])
def test_pad_to_fit(hw, grid):
    assert resize.pad_to_fit(*hw, grid) == jresize.pad_to_fit(*hw, grid)


@pytest.mark.parametrize('hw', [(36, 28), (5, 3), (4, 12), (9, 7)],
                         ids=['up4x', 'down', 'mixed', 'identity'])
def test_resize_bilinear(hw):
    """Upscale, downscale on both axes (antialiased), one axis down and one
    up, and the identity, against jax.image.resize evaluated in float64 so
    that the reference carries no float32 rounding of its own (in float32
    it is off by ~1e-5 on a 2x upscale). Tolerance 1e-6 absolute on values
    under 4: the port's float32 output rounds by at most 2.4e-7."""
    x = randn(rng(41), 3, 9, 7, 3)
    got = resize.resize_bilinear(t(x), *hw)
    with jax.enable_x64(True):
        want = np.asarray(jresize.resize_bilinear(
            jnp.asarray(x, jnp.float64), *hw))
    assert got.dtype == torch.float32 and want.dtype == np.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize('cout,res', [(64, True), (8, False)])
def test_fused_gn_silu_conv3x3_and_stats_threading(cout, res):
    r = rng(42)
    x = randn(r, 2, 6, 8, 64)
    sc, bi = randn(r, 64, scale=0.1) + 1, randn(r, 64, scale=0.1)
    k = randn(r, 3, 3, 64, cout, scale=0.05)
    cb = randn(r, cout, scale=0.1)
    resid = randn(r, 2, 6, 8, cout) if res else None
    want, wst = jconv.fused_gn_silu_conv3x3(
        jnp.asarray(x), sc, bi, k, cb,
        residual=None if resid is None else jnp.asarray(resid),
        want_stats=True)
    got, gst = conv3x3.fused_gn_silu_conv3x3(
        t(x), t(sc), t(bi), t(k).permute(3, 2, 0, 1), t(cb),
        residual=None if resid is None else t(resid), want_stats=True)
    assert_close(got, want)
    assert_close(gst[0], wst[0])
    assert_close(gst[1], wst[1])
    fresh = conv3x3.channel_stats(got)
    assert_close(gst[1], fresh[1])


def test_upsample_convs():
    r = rng(43)
    x = randn(r, 2, 5, 6, 16)
    k = randn(r, 3, 3, 16, 8, scale=0.1)
    b = randn(r, 8, scale=0.1)
    w = t(k).permute(3, 2, 0, 1)
    got, st = upsample_conv.upsample_conv2x(t(x), w, t(b), want_stats=True)
    want, wst = jup.upsample_conv2x(jnp.asarray(x), k, b, want_stats=True)
    assert_close(got, want)
    assert_close(st[1], wst[1])
    assert_close(upsample_conv.upsample_conv2x_cropped(t(x), w, t(b)),
                 jup.upsample_conv2x_cropped(jnp.asarray(x), k, b))


def test_color_fixes():
    from star_tpu.pipeline import color_fix as jcf
    r = rng(44)
    target = r.uniform(0, 255, (2, 40, 36, 3)).astype(np.float32)
    source = r.uniform(-1, 1, (2, 40, 36, 3)).astype(np.float32)
    assert_close(color_fix.adain_color_fix(t(target), t(source)),
                 jcf.adain_color_fix(jnp.asarray(target), source))
    assert_close(color_fix.wavelet_color_fix(t(target), t(source)),
                 jcf.wavelet_color_fix(jnp.asarray(target), source))


@pytest.mark.parametrize('f,chunk', [(10, 4), (12, 4), (40, 32), (6, 4)])
def test_chunking(f, chunk):
    from star_tpu.pipeline import chunking as jch
    inds = chunking.make_chunks(f, chunk)
    assert inds == jch.make_chunks(f, chunk)
    assert chunking.stitch_slices(inds) == jch.stitch_slices(inds)


def _mock_pair(tables, jtables):
    """The same closed-form CFG denoiser in both frameworks."""
    from star_tpu.diffusion import denoise_to_x0 as jdenoise

    def ours(xt, hint, tt):
        tf = torch.full((xt.shape[0],), tt)
        v = lambda y: torch.tanh(xt) * (tt / 1000.0) + y + 0.05 * hint
        return denoise_to_x0(tables, xt, tf, v(0.3), v(-0.2), 7.5, 0.2)

    def theirs(xt, hint, tt):
        tf = jnp.full((xt.shape[0],), tt, jnp.int32)
        v = lambda y: jnp.tanh(xt) * (tf.astype(jnp.float32)
                                      / 1000.0)[:, None, None, None,
                                                None] + y + 0.05 * hint
        return jdenoise(jtables, xt, tf, v(0.3), v(-0.2), guide_scale=7.5,
                        guide_rescale=0.2)
    return ours, theirs


@pytest.mark.parametrize('solver', ['dpmpp_2m_sde', 'heun'])
def test_samplers_match_star_tpu(solver):
    from star_tpu import diffusion as jd
    from star_tpu.pipeline.chunking import chunked_x0_fn as jchunked
    schedule = default_star_schedule()
    np.testing.assert_array_equal(schedule.sigmas,
                                  jd.default_star_schedule().sigmas)
    sigmas = build_sigma_ladder(schedule, steps=6, t_max=899,
                                solver_mode='normal')
    np.testing.assert_array_equal(
        sigmas, jd.build_sigma_ladder(schedule, steps=6, t_max=899,
                                      solver_mode='normal'))
    r = rng(45)
    x = randn(r, 1, 10, 4, 4, 4)
    hint = randn(r, 1, 10, 4, 4, 4)
    ours, theirs = _mock_pair(DiffusionTables.from_schedule(schedule),
                              jd.DiffusionTables.from_schedule(schedule))
    inds = chunking.make_chunks(10, 4)
    fn_t = chunking.chunked_x0_fn(ours, t(hint), inds)
    fn_j = jchunked(theirs, jnp.asarray(hint), inds)
    if solver == 'heun':
        got = sample_heun(fn_t, t(x), schedule, sigmas)
        want = jd.sample_heun(fn_j, jnp.asarray(x), schedule, sigmas,
                              jax.random.PRNGKey(0))
    else:
        got = sample_dpmpp_2m_sde(fn_t, t(x), schedule, sigmas, s_noise=0.0)
        want = jd.sample_dpmpp_2m_sde(fn_j, jnp.asarray(x), schedule, sigmas,
                                      jax.random.PRNGKey(0), s_noise=0.0)
    assert_close(got, want)


def test_dpmpp_sde_noise_is_injectable_and_seeded():
    schedule = default_star_schedule()
    sigmas = build_sigma_ladder(schedule, steps=4, t_max=899,
                                solver_mode='normal')
    x = t(randn(rng(46), 1, 2, 4, 4, 4))
    fn = lambda xt, tt: torch.tanh(xt) * 0.5
    n = len(sigmas) - 1
    noises = [t(randn(rng(47 + i), 1, 2, 4, 4, 4)) for i in range(n)]
    a = sample_dpmpp_2m_sde(fn, x, schedule, sigmas, noises=noises)
    b = sample_dpmpp_2m_sde(fn, x, schedule, sigmas, noises=noises)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    torch.testing.assert_close(
        sample_dpmpp_2m_sde(fn, x, schedule, sigmas, g1),
        sample_dpmpp_2m_sde(fn, x, schedule, sigmas, g2), rtol=0, atol=0)
