"""The port's CogVideoX DiT (star_tpu_torch/models/dit/dit.py) against
star_tpu's CogVideoDiT with its scanned layer stack (scan_layers=True),
random non-zero parameters carried over through convert/from_flax.py
(which unstacks the scan into the port's `layers`), and against the
dit_small golden.

The tiny config has 7 text tokens and 3 frames of 6x10 latents (patch 2:
a 3x5 token grid, so a swapped unpatchify axis shows): 52 real tokens,
carried padded to 64 with the dead tail masked by kv_valid. fp32, 1e-4 of
the reference magnitude (test_torch_harness.py); the golden at the JAX
test's atol 5e-3 (test_golden_parity.py).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from star_tpu_torch.convert import from_flax, load_flax
from star_tpu_torch.models.dit.dit import CogVideoDiT
from test_torch_harness import assert_close, port, random_params, randn, rng

KW = dict(hidden_size=128, num_layers=2, num_heads=2, patch_size=2,
          latent_channels=4, text_hidden_size=32, text_length=7,
          time_embed_dim=16)
GOLDEN = os.path.join(os.path.dirname(__file__), '..', 'goldens',
                      'dit_small.npz')


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('variant', ['liem', 'stock', 'lora'])
def test_dit_matches_star_tpu(variant):
    from star_tpu.models.dit.dit import CogVideoDiT as JDiT
    extra = {'liem': {}, 'stock': dict(liem=False),
             'lora': dict(lora_rank=4)}[variant]
    cin = 4 if variant == 'stock' else 8     # the SR model's noisy || LQ
    r = rng(40)
    x = randn(r, 2, 3, 6, 10, cin)
    ti = np.array([3, 900], np.int32)
    ctx = randn(r, 2, 7, 32)
    jm = JDiT(**KW, **extra, scan_layers=True)
    params = random_params(jm, x, ti, ctx, seed=41)
    assert 'layers' in params['params']
    if variant == 'lora':                   # lora_b carries non-zero values
        lb = params['params']['layers']['layer']['qkv']['lora_b']['kernel']
        assert float(np.abs(lb).max()) > 0
    want = jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(ti),
                             jnp.asarray(ctx))
    ours = port(CogVideoDiT(**KW, **extra), params)
    got = ours(torch.from_numpy(x), torch.from_numpy(ti),
               torch.from_numpy(ctx))
    assert got.shape == (2, 3, 6, 10, 4)
    assert_close(got, want)


def test_from_flax_unstacks_the_scanned_layers_and_checks_their_count():
    """layers/layer/<leaf>[i] lands on layers.{i}; a stack of another
    length than the port's layer count raises."""
    from star_tpu.models.dit.dit import CogVideoDiT as JDiT
    r = rng(42)
    args = (randn(r, 1, 1, 4, 4, 8), np.array([5], np.int32),
            randn(r, 1, 7, 32))
    params = random_params(JDiT(**KW), *args, seed=43)
    sd = from_flax(CogVideoDiT(**KW), params)
    stack = params['params']['layers']['layer']
    for i in range(KW['num_layers']):
        np.testing.assert_array_equal(
            sd[f'layers.{i}.q_ln_scale'].numpy(), stack['q_ln_scale'][i])
        np.testing.assert_array_equal(
            sd[f'layers.{i}.mlp_fc.weight'].numpy(),
            stack['mlp_fc']['kernel'][i].T)
    with pytest.raises(ValueError, match='stack of 2 layers'):
        from_flax(CogVideoDiT(**{**KW, 'num_layers': 3}), params)


def test_dit_golden():
    if not os.path.exists(GOLDEN):
        pytest.skip('golden dit_small.npz not present')
    from star_tpu.convert.tower_maps import convert_dit
    data = np.load(GOLDEN)
    cfg = json.loads(str(data['config_json']))
    sd = {k[4:]: data[k] for k in data.files if k.startswith('sd::')}
    params = convert_dit(sd, num_layers=cfg['num_layers'],
                         num_heads=cfg['num_attention_heads'])
    model = load_flax(CogVideoDiT(
        hidden_size=cfg['hidden_size'], num_layers=cfg['num_layers'],
        num_heads=cfg['num_attention_heads'], patch_size=cfg['patch_size'],
        latent_channels=cfg['in_channels'],
        text_hidden_size=cfg['text_hidden_size'],
        text_length=cfg['text_length'],
        time_embed_dim=cfg['time_embed_dim']), params).eval()
    to_ours = lambda a: np.transpose(a, (0, 1, 3, 4, 2))   # btchw -> bthwc
    with torch.no_grad():
        out = model(torch.from_numpy(to_ours(data['x'])),
                    torch.from_numpy(np.asarray(data['timesteps'])),
                    torch.from_numpy(data['context']))
    np.testing.assert_allclose(out.numpy(), to_ours(data['out']), atol=5e-3)


def _qk_ln_rope_turned(sign):
    """K9's plain version with its rotation scaled by `sign` (0: none)."""
    from star_tpu_torch.ops.qk_ln_rope import qk_ln_rope_plain

    def run(x, scale, bias, cos, sin, heads, eps=1e-6, fold_scale=1.0):
        cos = cos if sign else torch.ones_like(cos)
        return qk_ln_rope_plain(x, scale, bias, cos, sin * sign, heads, eps,
                                fold_scale)
    return run


@pytest.mark.parametrize('fault', ['none', 'no_rotation', 'reverse_rotation',
                                   'dead_keys_attended'])
def test_small_cog_tolerance_separates_faults_from_bf16(monkeypatch, fault):
    """chip_smoke.py holds its small DiT on the card (bf16) to COG_DIT_TOL of
    the host's fp32 output. On the host, the bf16 copy stays within a third
    of it, and a DiT whose K9 drops or reverses the rotation, or whose K1
    attends the dead key tail, misses it."""
    import copy

    import chip_smoke
    from star_tpu_torch.models.dit import dit as dit_mod
    from star_tpu_torch.ops import attention
    dit, args, _ = chip_smoke.small_cog_dit()
    with torch.no_grad():
        ref = dit(*args)
    if fault in ('no_rotation', 'reverse_rotation'):
        monkeypatch.setattr(dit_mod, 'qk_ln_rope', _qk_ln_rope_turned(
            0.0 if fault == 'no_rotation' else -1.0))
    elif fault == 'dead_keys_attended':
        packed = attention.flash_attention_packed
        monkeypatch.setattr(attention, 'flash_attention_packed',
                            lambda q, k, v, h, s, kv_valid=None, **kw:
                            packed(q, k, v, h, s, None, **kw))
    with torch.no_grad():
        out = copy.deepcopy(dit).to(torch.bfloat16)(*args)
    err = float((out.float() - ref).abs().max() / ref.abs().max())
    if fault == 'none':
        assert err <= chip_smoke.COG_DIT_TOL / 3, err
    else:
        assert err > chip_smoke.COG_DIT_TOL, err
