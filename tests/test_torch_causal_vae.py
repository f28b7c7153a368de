"""The port's causal 3D VAE (star_tpu_torch/vae/causal_vae.py) against
star_tpu's CogVideoVAE at tiny widths (ch 32, mult (1, 2, 2): the channel
change exercises the 1x1x1 shortcuts, and two levels compress time), with
random non-zero parameters carried over through convert/from_flax.py:
encode, the posterior sample with an injected eps, the whole-clip decode,
the serial windowed decode with the causal convs' carried frames (first
window [0:3], then [3:5], against the JAX decode with mutable=['cache']),
the nearest resize at a ratio that is not an integer, and the causal_vae
golden at the JAX test's atol 5e-3 (test_golden_parity.py). fp32, 1e-4 of
the reference magnitude (test_torch_harness.py).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from star_tpu_torch.convert import load_flax
from star_tpu_torch.vae.causal_vae import (CausalDecoder3D, CausalEncoder3D,
                                           CogVideoVAE, interp_nearest_video)
from test_torch_harness import assert_close, port, random_params, randn, rng

KW = dict(ch=32, ch_mult=(1, 2, 2), num_res_blocks=1, z_channels=4)
GOLDEN = os.path.join(os.path.dirname(__file__), '..', 'goldens',
                      'causal_vae.npz')


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def vae():
    from star_tpu.vae import causal_vae as jcv

    class TinyVAE(jcv.CogVideoVAE):
        def setup(self):
            self.encoder = jcv.CausalEncoder3D(**KW, name='encoder')
            self.decoder = jcv.CausalDecoder3D(**KW, name='decoder')

    jm = TinyVAE()
    params = random_params(jm, jnp.zeros((1, 5, 16, 24, 3)), seed=60)
    return jm, params, port(CogVideoVAE(**KW), params)


def test_encode_and_posterior_sample_match_star_tpu(vae):
    jm, params, ours = vae
    r = rng(61)
    video = randn(r, 1, 9, 16, 24, 3)
    moments = jax.jit(lambda p, v: jm.apply(
        p, v, method=lambda m, x: m.encoder(x)))(params, video)
    got = ours.encode_moments(torch.from_numpy(video))
    assert got.shape == (1, 3, 4, 6, 8)
    assert_close(got, moments)
    # the JAX package draws eps inside encode; the same sample, composed
    mean, logvar = np.split(np.asarray(moments), 2, axis=-1)
    eps = randn(r, *mean.shape)
    want = (mean + np.exp(0.5 * np.clip(logvar, -30.0, 20.0)) * eps) * 0.7
    assert_close(ours.encode(torch.from_numpy(video),
                             eps=torch.from_numpy(eps)), want)


def test_decode_matches_star_tpu(vae):
    jm, params, ours = vae
    z = randn(rng(62), 1, 3, 4, 6, 4, scale=0.5)
    want = jax.jit(lambda p, v: jm.apply(p, v, method=jm.decode))(params, z)
    got = ours.decode(torch.from_numpy(z))
    assert got.shape == (1, 9, 16, 24, 3)
    assert_close(got, want)


def test_windowed_decode_with_carried_cache_matches_star_tpu(vae):
    jm, params, ours = vae
    z = randn(rng(63), 1, 5, 4, 6, 4, scale=0.5)

    def window(p, cache, zw, first):
        variables = {'params': p['params'], **({'cache': cache} if cache
                                               else {})}
        out, mut = jm.apply(variables, zw, True, first, method=jm.decode,
                            mutable=['cache'])
        return out, mut['cache']

    w1, c1 = jax.jit(lambda p, zw: window(p, None, zw, True))(
        params, z[:, 0:3])
    w2, _ = jax.jit(lambda p, c, zw: window(p, c, zw, False))(
        params, c1, z[:, 3:5])
    got1, cache = ours.decode_window(torch.from_numpy(z[:, 0:3]), {}, True)
    got2, _ = ours.decode_window(torch.from_numpy(z[:, 3:5]), cache, False)
    assert got1.shape == (1, 9, 16, 24, 3) and got2.shape == (1, 8, 16, 24, 3)
    assert_close(got1, w1)
    assert_close(got2, w2)
    # one entry per causal conv with a time extent, as the JAX collection
    n_jax = len(jax.tree_util.tree_leaves(c1))
    assert len(cache) == n_jax
    # the second window continues the first: alone it differs
    alone, _ = ours.decode_window(torch.from_numpy(z[:, 3:5]), {}, True)
    assert not torch.allclose(alone, got2, atol=1e-3)


@pytest.mark.parametrize('src,dst', [((3, 5, 7), (5, 12, 9)),
                                     ((4, 3, 5), (7, 8, 13)),
                                     ((1, 6, 4), (1, 4, 6))])
def test_nearest_resize_at_non_integer_ratios_matches_star_tpu(src, dst):
    """jax.image.resize 'nearest' samples at half-pixel centres (floor of
    (i + 0.5) * in / out); F.interpolate 'nearest' would floor i * in /
    out instead and pick other rows at these ratios."""
    from star_tpu.vae.causal_vae import _interp_nearest_video
    zq = randn(rng(64), 1, *src, 4)
    want = _interp_nearest_video(jnp.asarray(zq), *dst)
    got = interp_nearest_video(torch.from_numpy(zq), *dst)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_causal_vae_golden():
    if not os.path.exists(GOLDEN):
        pytest.skip('golden causal_vae.npz not present')
    from star_tpu.convert import convert_state_dict
    from star_tpu.convert.causal_vae_map import causal_vae_name_map
    data = np.load(GOLDEN)
    cfg = json.loads(str(data['config_json']))
    sd = {k[4:]: data[k] for k in data.files if k.startswith('sd::')}
    ch_mult = tuple(cfg['ch_mult'])
    params = convert_state_dict(sd, causal_vae_name_map(
        ch=cfg['ch'], ch_mult=ch_mult, num_res_blocks=cfg['num_res_blocks']))
    kw = dict(ch=cfg['ch'], ch_mult=ch_mult,
              num_res_blocks=cfg['num_res_blocks'],
              z_channels=cfg['z_channels'],
              temporal_compress_level=cfg['temporal_compress_level'])
    to_ours = lambda a: np.transpose(a, (0, 2, 3, 4, 1))   # BCTHW -> BTHWC
    enc = load_flax(CausalEncoder3D(**kw), params['encoder']).eval()
    dec = load_flax(CausalDecoder3D(**kw), params['decoder']).eval()
    with torch.no_grad():
        moments = enc(torch.from_numpy(to_ours(data['x'])))
        rec = dec(torch.from_numpy(to_ours(data['z'])))
    np.testing.assert_allclose(moments.numpy(), to_ours(data['moments']),
                               atol=5e-3)
    np.testing.assert_allclose(rec.numpy(), to_ours(data['rec']), atol=5e-3)
