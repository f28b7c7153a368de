"""The port's UNet+ControlNet against star_tpu's at tiny widths (cfg_pair
on and off), with random non-zero parameters carried over through
convert/from_flax.py; fp32, tolerance 1e-4 of the reference magnitude
(test_torch_harness.py).

The UNet is cut below the end-to-end test's tiny config to one down level
and one res block per level (every block type and both attention scales
stay), so the JAX side compiles in seconds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from star_tpu_torch.models.unet.unet import ControlledV2VUNet
from test_torch_harness import (assert_close, port, random_params, randn,
                                rng, t)

UNET_KW = dict(dim=32, dim_mult=(1, 2), num_res_blocks=1,
               attn_scales=(1.0, 0.5), head_dim=16,
               num_heads_init_temporal=2, context_dim=32)


@pytest.fixture(scope='module')
def unet_pair():
    from star_tpu.models.unet.unet import ControlledV2VUNet as JUNet
    jm = JUNet(**UNET_KW)
    z = jnp.zeros((1, 2, 10, 8, 4))
    params = random_params(jm, z, jnp.zeros((1,), jnp.int32),
                           jnp.zeros((1, 77, 32)), z, seed=1)
    return jm, params, port(ControlledV2VUNet(**UNET_KW), params)


@pytest.mark.parametrize('cfg_pair', [True, False])
def test_unet_controlnet_matches_star_tpu(unet_pair, cfg_pair):
    jm, params, ours = unet_pair
    r = rng(7)
    x = randn(r, 1, 4, 10, 8, 4)
    hint = randn(r, 1, 4, 10, 8, 4)
    y = randn(r, 2 if cfg_pair else 1, 77, 32)
    tt = np.array([640], np.int32)
    want = jax.jit(jm.apply, static_argnames='cfg_pair')(
        params, x, tt, y, hint, cfg_pair=cfg_pair)
    got = ours(t(x), t(tt), t(y), t(hint), cfg_pair=cfg_pair)
    assert got.shape == want.shape
    assert_close(got, want)


def test_unet_output_is_zero_at_zero_init():
    m = ControlledV2VUNet(**UNET_KW).eval()
    r = rng(8)
    x = t(randn(r, 1, 2, 10, 8, 4))
    with torch.no_grad():
        v = m(x, torch.tensor([500]), t(randn(r, 2, 77, 32)), x,
              cfg_pair=True)
        controls = m.controlnet(x, torch.tensor([500]),
                                t(randn(r, 1, 77, 32)), hint=x)
    assert v.shape == (2, 2, 10, 8, 4)
    assert float(v.abs().max()) == 0.0
    assert all(float(c.abs().max()) == 0.0 for c in controls)
