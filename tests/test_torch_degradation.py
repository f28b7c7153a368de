"""The port's degradation engine (star_tpu_torch/data/degradation.py) against
star_tpu.data.degradation on the CPU, stage by stage and end to end, and the
setups of tests/test_degradation.py on the port.

The host parameter sampling is the same numpy/random code: equal bit for
bit. The device math is held to fp32 rounding (1e-5 or tighter, per
stage below). The noises take the JAX draws: the Gaussian normals of the
same key, and the Poisson counts the JAX sampler gives from the same key at
the port's rate. Where a stage rounds (the JPEG and codec proxy quantise
DCT coefficients, the final LQ is rounded to 1/255), a 1e-7 difference
before the rounding flips it now and then. Those stages are held to: all
but a stated fraction of the values within 1e-5, and none further off than
one quantisation step (the coarsest table entry / 255 for a coefficient;
1/255 for the output rounding, times the stages it passes through).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from star_tpu_torch.data import degradation as deg
from star_tpu_torch.ops.resize import resize_bilinear
from test_torch_harness import rel_err


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jd():
    from star_tpu.data import degradation
    return degradation


def frames(seed, f, h, w, smooth=True):
    """[f, h, w, 3] fp32 in [0, 1]: smooth moving content with mild
    texture (random noise alone is legitimately wiped out by a codec)."""
    r = np.random.RandomState(seed)
    if not smooth:
        return r.uniform(0, 1, (f, h, w, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([np.stack([np.sin(xx / (5 + c) + t) * 0.25 + yy / (2 * h)
                               + 0.2 + 0.1 * c for c in range(3)], -1)
                     for t in range(f)])
    return np.clip(base + r.uniform(-0.05, 0.05, base.shape), 0, 1) \
        .astype(np.float32)


def np32(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy()


def off_fraction(got, want, atol=1e-5):
    """(fraction of values further than atol apart, largest difference)."""
    d = np.abs(np32(got) - np32(want))
    return float((d > atol).mean()), float(d.max())


# ------------------------------------------------------- parameter sampling


@pytest.mark.parametrize('recipe', ['default', 'mid'])
def test_parameter_sampling_is_bit_for_bit(recipe):
    for seed in range(40):
        a = deg.sample_degradation_params(seed, recipe)
        b = jd().sample_degradation_params(seed, recipe)
        assert a.sinc_before_jpeg == b.sinc_before_jpeg
        assert np.array_equal(a.sinc_kernel, b.sinc_kernel)
        for sa, sb in ((a.stage1, b.stage1), (a.stage2, b.stage2)):
            for field in ('apply_blur', 'resize_scale', 'resize_mode',
                          'use_gaussian_noise', 'noise_sigma',
                          'poisson_scale', 'gray_noise', 'jpeg_quality'):
                assert getattr(sa, field) == getattr(sb, field), field
            assert sa.kernel.dtype == sb.kernel.dtype
            assert np.array_equal(sa.kernel, sb.kernel)


# ------------------------------------------------------------------ stages


@pytest.mark.parametrize('shape', [(2, 24, 40, 3), (1, 5, 7, 3)])
def test_filter2d_matches(shape):
    """Reflect padding with the depthwise kernel; (1, 5, 7): the 21-tap
    kernel's pad of 10 exceeds the frame, reflected as often as jnp.pad
    reflects. Within 1e-6 of the largest output."""
    x = frames(1, *shape[:3], smooth=False)
    k = jd().bivariate_gaussian(21, 2.5, 0.7, 0.4, False).astype(np.float32)
    want = jd().filter2d(jnp.asarray(x), jnp.asarray(k))
    got = deg.filter2d(torch.from_numpy(x), k)
    assert rel_err(got, want) <= 1e-6


def test_usm_sharpen_matches():
    """The separable 51-tap blur against the JAX 2-D filter: within 1e-5
    (the sums run in another order; the mask threshold flips no pixel
    here)."""
    x = frames(2, 2, 40, 48)
    want = jd().usm_sharpen(jnp.asarray(x))
    got = deg.usm_sharpen(torch.from_numpy(x))
    assert rel_err(got, want) <= 1e-5


@pytest.mark.parametrize('mode', ['bicubic', 'bilinear', 'area'])
@pytest.mark.parametrize('size', [(12, 20), (50, 70), (24, 55)])
def test_resize_matches_jax_image_resize(mode, size):
    """_resize in its three modes, shrinking, growing and both at once
    (24 -> 24 keeps its rows: that axis is left alone): jax.image.resize's
    Keys cubic and triangle kernels, renormalised at the borders; within
    1e-5 of the largest output. F.interpolate's bicubic misses it."""
    x = frames(3, 2, 24, 40, smooth=False)
    want = jd()._resize(jnp.asarray(x), *size, mode)
    got = deg._resize(torch.from_numpy(x), *size, mode)
    assert tuple(got.shape) == tuple(want.shape)
    assert rel_err(got, want) <= 1e-5
    if mode == 'bicubic' and size == (50, 70):
        torchs = torch.nn.functional.interpolate(
            torch.from_numpy(x).permute(0, 3, 1, 2), size=size,
            mode='bicubic', align_corners=False).permute(0, 2, 3, 1)
        assert rel_err(torchs, want) > 1e-2


@pytest.mark.parametrize('gray', [False, True])
def test_noises_with_injected_draws_match(gray):
    """The Gaussian noise with the JAX key's normals, and the Poisson noise
    with the counts jax.random.poisson gives at the port's rate: within
    1e-6 (the counts, drawn at the same rate, are equal)."""
    x = frames(4, 2, 16, 16)
    key = jax.random.PRNGKey(3)
    f, h, w, _ = x.shape
    normal = np.array(jax.random.normal(key, (f, h, w, 1) if gray
                                          else x.shape, jnp.float32))
    want = jd().add_gaussian_noise(jnp.asarray(x), key, 20.0, gray)
    got = deg.add_gaussian_noise(torch.from_numpy(x), 20.0, gray,
                                 normal=torch.from_numpy(normal))
    assert rel_err(got, want) <= 1e-6
    seen = []

    def counts(rate):
        seen.append(rate)
        return torch.from_numpy(np.asarray(jax.random.poisson(
            key, jnp.asarray(rate.numpy()), tuple(rate.shape)), np.float32))
    want = jd().add_poisson_noise(jnp.asarray(x), key, 2.0, gray)
    got = deg.add_poisson_noise(torch.from_numpy(x), 2.0, gray, counts)
    assert tuple(seen[0].shape) == ((f, h, w, 1) if gray else x.shape)
    assert rel_err(got, want) <= 1e-6


def test_noises_draw_from_the_generator():
    """Without injected draws the noises come from the generator: the same
    seed, the same output; gray noise is equal across channels."""
    x = torch.full((2, 16, 16, 3), 0.5)
    g = lambda: torch.Generator().manual_seed(5)
    a = deg.add_gaussian_noise(x, 20.0, True, generator=g())
    assert torch.equal(a, deg.add_gaussian_noise(x, 20.0, True,
                                                 generator=g()))
    assert torch.equal(a[..., 0], a[..., 1]) and float(a.std()) > 0.01
    p = deg.add_poisson_noise(x, 1.0, False, generator=g())
    assert torch.equal(p, deg.add_poisson_noise(x, 1.0, False,
                                                generator=g()))
    assert float(p.std()) > 0.001


@pytest.mark.parametrize('quality', [30.0, 62.5, 95.0])
def test_jpeg_compress_matches(quality):
    """All but 1% of the values within 1e-5, none further off than one
    quantisation step of the coarsest table entry (measured: no value
    apart, the largest difference 1.8e-7). 20x28 pads to 24x32 at the edge."""
    x = frames(5, 2, 20, 28)
    want = jd().jpeg_compress(jnp.asarray(x), quality)
    got = deg.jpeg_compress(torch.from_numpy(x), quality)
    frac, worst = off_fraction(got, want)
    scale = 5000.0 / quality if quality < 50 else 200.0 - 2.0 * quality
    step = min(255.0, np.floor((99 * scale + 50) / 100)) / 255.0
    assert frac <= 0.01 and worst <= step, (frac, worst)


@pytest.mark.parametrize('quality', [20.0, None])
def test_codec_proxy_matches(quality):
    """The 4:2:0 + I/P-frame DPCM proxy, its P-frames a loop on the device:
    the same tolerance as the JPEG round trip (1.6 x the table for the
    residuals). quality None draws it from random.Random(seed). Measured:
    no value apart, the largest difference 2.4e-7."""
    x = frames(6, 4, 30, 40)
    want = jd().codec_proxy(jnp.asarray(x), 3, quality)
    got = deg.codec_proxy(torch.from_numpy(x), 3, quality)
    frac, worst = off_fraction(got, want)
    q = quality or 18.0
    scale = 5000.0 / q if q < 50 else 200.0 - 2.0 * q
    step = 1.6 * min(255.0, np.floor((99 * scale + 50) / 100)) / 255.0
    assert frac <= 0.01 and worst <= step, (frac, worst)


def _draw(seed):
    """The JAX package's draws in degrade_video: stage k's noise from the
    k-th of four keys split from PRNGKey(seed)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), 4)

    def draw(stage, kind, arg):
        key = keys[stage - 1]
        if kind == 'normal':
            out = jax.random.normal(key, arg, jnp.float32)
        else:
            out = jax.random.poisson(key, jnp.asarray(arg.numpy()),
                                     tuple(arg.shape))
        return torch.from_numpy(np.array(out, np.float32))
    return draw


# (recipe, seed, codec), chosen from the sampled parameters to cover
# Poisson noise in colour (default 2, stage 1) and gray (default 5),
# Gaussian noise in colour (mid 1, stage 1) and gray (default 2, stage 2),
# all three resize modes, the sinc before (default 2) and after the JPEG,
# no stage-2 blur (mid 1), and the codec proxy at both codec stages. Each
# case costs about 10 s of eager JAX dispatch on one core.
E2E = [('default', 2, False), ('default', 5, True), ('mid', 1, True)]


@pytest.mark.parametrize('recipe,seed,codec', E2E)
def test_degrade_video_matches(recipe, seed, codec):
    """End to end with the JAX draws injected: gt_usm within 1e-5; the LQ
    (rounded to 1/255 at the end) with all but 2% of its values within
    1e-5 and none more than 3/255 off (a flipped rounding of a JPEG
    coefficient, and the final rounding). Measured: the LQ equal in all
    three cases, gt_usm 2.4e-7 apart."""
    gt = frames(seed, 3, 48, 64)
    want_lq, want_usm = jd().degrade_video(gt, scale=4, seed=seed,
                                           use_codec=codec, recipe=recipe)
    lq, usm = deg.degrade_video(gt, scale=4, seed=seed, use_codec=codec,
                                recipe=recipe, device='cpu',
                                draw=_draw(seed))
    assert tuple(lq.shape) == want_lq.shape == (3, 12, 16, 3)
    assert rel_err(usm, want_usm) <= 1e-5
    frac, worst = off_fraction(lq, want_lq)
    assert frac <= 0.02 and worst <= 3 / 255 + 1e-6, (frac, worst)


def test_image_pair_helpers_match():
    """augment_paired and paired_random_crop take the same RandomState
    draws and pick the same pixels; realesrgan_image_pair (no codec) with
    the JAX draws within the end-to-end tolerance."""
    a = np.arange(2 * 4 * 6 * 3, dtype=np.float32).reshape(2, 4, 6, 3)
    for seed in range(8):
        want = jd().augment_paired(np.random.RandomState(seed), a, a * 2)
        got = deg.augment_paired(np.random.RandomState(seed),
                                 torch.from_numpy(a), torch.from_numpy(a * 2))
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), w)
    gt = frames(7, 1, 64, 96)[0]
    lq = gt[::4, ::4]
    want = jd().paired_random_crop(np.random.RandomState(1), gt, lq, 32, 4)
    got = deg.paired_random_crop(np.random.RandomState(1),
                                 torch.from_numpy(gt), torch.from_numpy(lq),
                                 32, 4)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)
    img = frames(8, 1, 96, 128)[0]
    want = jd().realesrgan_image_pair(img, scale=4, gt_size=64, seed=5)
    got = deg.realesrgan_image_pair(img, scale=4, gt_size=64, seed=5,
                                    device='cpu', draw=_draw(5))
    assert np.array_equal(got[0].numpy(), want[0])
    assert rel_err(got[1], want[1]) <= 1e-5
    frac, worst = off_fraction(got[2], want[2])
    assert frac <= 0.02 and worst <= 3 / 255 + 1e-6, (frac, worst)


# ------------------------------------- tests/test_degradation.py on the port


def test_kernels_normalized():
    k = deg.bivariate_gaussian(21, 1.5, 1.5, 0.3, True)
    assert k.shape == (21, 21) and k.sum() == pytest.approx(1.0)
    ka = deg.bivariate_gaussian(21, 2.5, 0.5, 0.7, False)
    assert ka.sum() == pytest.approx(1.0)
    assert not np.allclose(ka, ka.T)
    ks = deg.circular_lowpass_kernel(np.pi / 2, 13, pad_to=21)
    assert ks.shape == (21, 21) and ks.sum() == pytest.approx(1.0)


def test_filter2d_identity_with_pulse_and_blur_smooths():
    x = torch.from_numpy(frames(0, 2, 16, 16, smooth=False))
    pulse = np.zeros((21, 21), np.float32)
    pulse[10, 10] = 1.0
    torch.testing.assert_close(deg.filter2d(x, pulse), x, rtol=0,
                               atol=1e-6)
    k = deg.bivariate_gaussian(21, 3.0, 3.0, 0.0).astype(np.float32)
    assert float(deg.filter2d(x, k).std()) < float(x.std())


def test_jpeg_quality_monotone():
    yy, xx = np.mgrid[0:32, 0:32] / 32.0
    img = np.stack([yy, xx, np.sin(4 * yy) * np.cos(3 * xx) * 0.5 + 0.5], -1)
    x = torch.from_numpy(img[None].astype(np.float32))
    errs = [float((deg.jpeg_compress(x, q) - x).abs().mean())
            for q in (95.0, 60.0, 30.0)]
    assert errs[0] < errs[1] < errs[2], errs


def test_usm_sharpen_increases_local_contrast():
    x = torch.from_numpy(np.random.RandomState(3).uniform(
        0.2, 0.8, (1, 32, 32, 3)).astype(np.float32))
    out = deg.usm_sharpen(x)
    assert out.shape == x.shape
    assert float(out.std()) >= float(x.std()) * 0.99


@pytest.mark.parametrize('recipe', ['default', 'mid'])
def test_degrade_video_end_to_end(recipe):
    """Shapes, range, a difference from a clean downsample, the generator's
    determinism, and the two recipes apart."""
    gt = frames(4, 2, 64, 64, smooth=False)
    lq, gt_usm = deg.degrade_video(gt, scale=4, seed=3, use_codec=False,
                                   recipe=recipe, device='cpu')
    assert lq.shape == (2, 16, 16, 3) and gt_usm.shape == gt.shape
    assert 0.0 <= float(lq.min()) and float(lq.max()) <= 1.0
    clean = resize_bilinear(torch.from_numpy(gt), 16, 16)
    assert float((lq - clean).abs().mean()) > 0.005
    again, _ = deg.degrade_video(gt, scale=4, seed=3, use_codec=False,
                                 recipe=recipe, device='cpu')
    assert torch.equal(lq, again)
    other, _ = deg.degrade_video(gt, scale=4, seed=3, use_codec=False,
                                 recipe='mid' if recipe == 'default'
                                 else 'default', device='cpu')
    assert not torch.allclose(lq, other)


def test_codec_proxy_blocks_and_smears():
    x = torch.from_numpy(frames(0, 4, 32, 48))
    out = deg.codec_proxy(x, seed=3, quality=20.0)
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    err = float((out - x).abs().mean())
    assert 0.005 < err < 0.2, err
    hi = deg.codec_proxy(x, seed=3, quality=90.0)
    assert float((hi - x).abs().mean()) < err
    x2 = x.clone()
    x2[0] = (x2[0] + 0.25).clamp(0, 1)
    out2 = deg.codec_proxy(x2, seed=3, quality=20.0)
    assert float((out2[1:] - out[1:]).abs().max()) > 1e-4
    rt = deg.codec_roundtrip(x, seed=3)        # no PyAV here: the proxy
    assert rt.shape == x.shape and float((rt - x).abs().mean()) > 0.003


def test_paired_random_crop_alignment_and_realesrgan_contract():
    gt = torch.from_numpy(frames(0, 1, 64, 96, smooth=False)[0])
    lq = gt[::4, ::4]
    gt_c, lq_c = deg.paired_random_crop(np.random.RandomState(1), gt, lq,
                                        32, 4)
    assert gt_c.shape == (32, 32, 3) and lq_c.shape == (8, 8, 3)
    torch.testing.assert_close(gt_c[::4, ::4], lq_c)
    with pytest.raises(ValueError):
        deg.paired_random_crop(np.random.RandomState(1), gt, lq[:-1], 32, 4)
    img = frames(0, 1, 96, 128, smooth=False)[0]
    gt_c, usm_c, lq_c = deg.realesrgan_image_pair(img, scale=4, gt_size=64,
                                                  seed=5, device='cpu')
    assert gt_c.shape == usm_c.shape == (64, 64, 3)
    assert lq_c.shape == (16, 16, 3)
    assert 0 <= float(lq_c.min()) and float(lq_c.max()) <= 1
    assert not torch.allclose(gt_c, usm_c)
    again = deg.realesrgan_image_pair(img, scale=4, gt_size=64, seed=5,
                                      device='cpu')
    assert all(torch.equal(a, b) for a, b in zip(again, (gt_c, usm_c,
                                                         lq_c)))
