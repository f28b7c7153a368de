"""The dropout path of the port (star_tpu_torch/ops/temporal_conv.py and
the `deterministic=False` chains of models/unet/blocks.py) against
star_tpu on the CPU:

  * temporal_conv3 and temporal_conv3_video against
    star_tpu.ops.temporal_conv, fp32 and bf16. The JAX temporal_conv3
    switches spelling at 128 Mi elements; below the switch it is called
    as is, above it its conv spelling (star_tpu/ops/temporal_conv.py:47-50,
    conv_f32acc + the fp32 bias) is called on the same small input, since
    an input past the switch is 512 MB in fp32;
  * TemporalConvBlockV2, ResBlock and the tiny UNet+ControlNet with
    deterministic=False against the JAX modules applied with
    rngs={'dropout': key}: the masks the JAX run drew are recorded with
    flax.linen.intercept_methods around nn.Dropout (a kept value is
    non-zero) and handed to the port as a DropoutMasks, by flax path;
  * dropout 0, and deterministic=True with masks given, equal the fused
    K5 chain bit for bit; the unfused chain runs no K5.

fp32 tolerance: the harness's 1e-4 of the reference's largest magnitude;
bf16: two bf16 steps (2^-7) of it.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from star_tpu_torch.models.unet import blocks
from star_tpu_torch.models.unet.blocks import (DropoutMasks, ResBlock,
                                               TemporalConvBlockV2)
from star_tpu_torch.models.unet.unet import ControlledV2VUNet
from star_tpu_torch.ops.temporal_conv import (temporal_conv3,
                                              temporal_conv3_video)
from test_torch_harness import assert_close, port, randn, random_params, \
    rng, t

BF16_TOL = 2.0 ** -7
# the dropout sites are the ResBlocks and their temporal conv blocks: the
# transformers (which hold none) are left out to keep the JAX compile short
UNET_KW = dict(dim=32, dim_mult=(1,), num_res_blocks=1, attn_scales=(),
               head_dim=16, num_heads_init_temporal=2, context_dim=32)


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sow_masks(next_fun, args, kwargs, context):
    out = next_fun(*args, **kwargs)
    if isinstance(context.module, nn.Dropout):
        context.module.sow('intermediates', 'keep', out != 0)
    return out


def recorded_masks(module, params, args, seed, **kwargs):
    """module.apply(params, *args, deterministic=False, **kwargs) under
    jit, the dropout key PRNGKey(seed); returns (its output, {flax path:
    keep mask}) of every nn.Dropout it called (sown by an interceptor)."""
    def run(p, a, rngs):
        with nn.intercept_methods(_sow_masks):
            return module.apply(p, *a, deterministic=False, rngs=rngs,
                                mutable=['intermediates'], **kwargs)
    out, state = jax.jit(run)(params, args,
                              {'dropout': jax.random.PRNGKey(seed)})
    flat = jax.tree_util.tree_leaves_with_path(state['intermediates'])
    masks = {'.'.join(str(k.key) for k in path[:-2]):
             torch.from_numpy(np.array(v)) for path, v in flat}
    return out, masks


def _bf16(x):
    return jnp.asarray(x, jnp.bfloat16)


# ------------------------------------------------------------ the tap convs


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('spelling', ['gemm', 'conv'])
def test_temporal_conv3_matches_star_tpu(dtype, spelling):
    from star_tpu.ops import temporal_conv as jtc
    from star_tpu.ops.conv_acc import conv_f32acc
    r = rng(3)
    x = randn(r, 2, 5, 12, 16)
    kernel = randn(r, 3, 1, 16, 24, scale=0.25)
    bias = randn(r, 24, scale=0.1)
    xj = _bf16(x) if dtype == 'bfloat16' else jnp.asarray(x)
    if spelling == 'gemm':       # below the switch: the function itself
        want = jtc.temporal_conv3(xj, jnp.asarray(kernel), jnp.asarray(bias))
    else:                        # the spelling above the switch
        y = conv_f32acc(xj, jnp.asarray(kernel).astype(xj.dtype), (1, 1),
                        ((1, 1), (0, 0)), ('NHWC', 'HWIO', 'NHWC'))
        want = (y + jnp.asarray(bias)).astype(xj.dtype)
    xt = t(x).to(getattr(torch, dtype))
    got = temporal_conv3(xt, t(kernel), t(bias))
    assert got.dtype == xt.dtype and got.shape == (2, 5, 12, 24)
    assert_close(got, want.astype(jnp.float32),
                 BF16_TOL if dtype == 'bfloat16' else 1e-5)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_temporal_conv3_video_matches_star_tpu(dtype):
    from star_tpu.ops import temporal_conv as jtc
    r = rng(4)
    x = randn(r, 1, 6, 5, 7, 16)
    kernel = randn(r, 3, 1, 16, 8, scale=0.25)
    bias = randn(r, 8, scale=0.1)
    xj = _bf16(x) if dtype == 'bfloat16' else jnp.asarray(x)
    want = jtc.temporal_conv3_video(xj, jnp.asarray(kernel),
                                    jnp.asarray(bias))
    xt = t(x).to(getattr(torch, dtype))
    got = temporal_conv3_video(xt, t(kernel), t(bias))
    assert got.dtype == xt.dtype
    assert_close(got, want.astype(jnp.float32),
                 BF16_TOL if dtype == 'bfloat16' else 1e-5)


# ------------------------------------------------------------ the blocks


def test_temporal_conv_block_with_dropout_matches_star_tpu():
    from star_tpu.models.unet import blocks as jblocks
    jm = jblocks.TemporalConvBlockV2(32)
    x = randn(rng(5), 2, 4, 3, 5, 32)
    params = random_params(jm, jnp.asarray(x), seed=2)
    want, masks = recorded_masks(jm, params, (jnp.asarray(x),), 3)
    assert sorted(masks) == ['Dropout_0', 'Dropout_1', 'Dropout_2']
    ours = port(TemporalConvBlockV2(32), params)
    got = ours(t(x), DropoutMasks(masks=masks))
    assert_close(got, want)
    # the deterministic chain is another function (no dropout)
    assert float((ours(t(x)) - got).abs().max()) > 1e-3


def test_res_block_with_dropout_matches_star_tpu():
    from star_tpu.models.unet import blocks as jblocks
    jm = jblocks.ResBlock(64, dropout=0.1)
    r = rng(6)
    x, emb = randn(r, 6, 4, 5, 32), randn(r, 6, 24)
    init = types.SimpleNamespace(init=functools.partial(jm.init, frames=3))
    params = random_params(init, jnp.asarray(x), jnp.asarray(emb), seed=4)
    want, masks = recorded_masks(jm, params, (x, emb), 5, frames=3)
    assert sorted(masks) == ['Dropout_0', 'temporal_conv.Dropout_0',
                             'temporal_conv.Dropout_1',
                             'temporal_conv.Dropout_2']
    ours = port(ResBlock(32, 64, 24), params)
    assert_close(ours(t(x), t(emb), 3, DropoutMasks(masks=masks)), want)


@pytest.fixture(scope='module')
def unet_pair():
    from star_tpu.models.unet.unet import ControlledV2VUNet as JUNet
    jm = JUNet(**UNET_KW)
    z = jnp.zeros((1, 2, 10, 8, 4))
    params = random_params(jm, z, jnp.zeros((1,), jnp.int32),
                           jnp.zeros((1, 7, 32)), z, seed=7)
    return jm, params, port(ControlledV2VUNet(**UNET_KW), params)


def test_unet_controlnet_with_dropout_matches_star_tpu(unet_pair):
    """Every ResBlock and temporal conv block of both trunks drops: 32
    sites, each mask the JAX run's."""
    jm, params, ours = unet_pair
    r = rng(8)
    x, hint = randn(r, 1, 3, 10, 8, 4), randn(r, 1, 3, 10, 8, 4)
    y, tt = randn(r, 1, 7, 32), np.array([420], np.int32)
    want, masks = recorded_masks(jm, params, (x, tt, y, hint), 9)
    res = [n for n, m in ours.named_modules() if isinstance(m, ResBlock)]
    assert len(masks) == 4 * len(res) == 32
    assert set(masks) == {f'{n}.Dropout_0' for n in res} | {
        f'{n}.temporal_conv.Dropout_{i}' for n in res for i in range(3)}
    got = ours(t(x), t(tt), t(y), t(hint), deterministic=False,
               dropout_masks=DropoutMasks(masks=masks))
    assert_close(got, want)


def test_unet_dropout_masks_are_drawn_once_per_site_under_remat():
    """Drawn from a generator, under remat with grad: the recompute in the
    backward reuses each site's mask, so the gradient is that of the
    forward that ran (equal to the same masks injected without remat)."""
    kw = UNET_KW
    torch.manual_seed(0)
    ref = ControlledV2VUNet(**kw)
    with torch.no_grad():
        for p in ref.parameters():
            p.add_(0.01)
    r = rng(10)
    x, hint = t(randn(r, 1, 2, 10, 8, 4)), t(randn(r, 1, 2, 10, 8, 4))
    y, tt = t(randn(r, 1, 7, 32)), torch.tensor([300])
    grads = {}
    for remat in (True, False):
        m = ControlledV2VUNet(remat=remat, **kw)
        m.load_state_dict(ref.state_dict())
        masks = DropoutMasks(torch.Generator().manual_seed(11)) if remat \
            else DropoutMasks(masks=drawn.masks)
        m(x, tt, y, hint, deterministic=False,
          dropout_masks=masks).square().mean().backward()
        drawn = masks
        grads[remat] = {n: p.grad.clone() for n, p in m.named_parameters()}
    assert len(drawn.masks) == 4 * 8
    for n, g in grads[True].items():
        assert torch.allclose(g, grads[False][n], rtol=1e-5, atol=1e-7), n


def test_dropout_zero_and_deterministic_are_the_fused_chain(monkeypatch):
    """dropout 0 with masks, and deterministic=True with masks, run K5's
    chain bit for bit; the unfused chain launches no K5."""
    calls = []
    fused = blocks.fused_gn_silu_tconv3

    def counted(*a, **k):
        calls.append(1)
        return fused(*a, **k)
    monkeypatch.setattr(blocks, 'fused_gn_silu_tconv3', counted)
    x = t(randn(rng(12), 1, 4, 3, 5, 32))
    tcb = TemporalConvBlockV2(32).requires_grad_(False)
    with torch.no_grad():
        tcb.conv4.weight.normal_()
    masks = DropoutMasks(torch.Generator().manual_seed(0))
    want = tcb(x)
    assert len(calls) == 4
    tcb.dropout = 0.0
    assert torch.equal(tcb(x, masks), want) and len(calls) == 8
    tcb.dropout = 0.1
    assert not torch.equal(tcb(x, masks), want) and len(calls) == 8
    m = ControlledV2VUNet(**UNET_KW).requires_grad_(False)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(0.01)
    r = rng(13)
    args = (t(randn(r, 1, 2, 10, 8, 4)), torch.tensor([5]),
            t(randn(r, 1, 7, 32)), t(randn(r, 1, 2, 10, 8, 4)))
    calls.clear()
    want = m(*args)
    n_fused = len(calls)
    assert n_fused == 4 * 8 and torch.equal(
        m(*args, dropout_masks=DropoutMasks(masks={})), want)
    calls.clear()
    m(*args, deterministic=False, dropout_masks=masks)
    assert not calls


def test_dropout_launches_of_the_full_depth_unet(monkeypatch):
    """The full-depth UNet+ControlNet at narrow widths, one training call
    with dropout: no K5, 32 unfused chains (128 temporal_conv3 calls), as
    many chains as the deterministic call has K5 chains of 4 stages; a
    train step (forward and remat recompute) runs chip_smoke.py's
    UNFUSED_CHAINS_PER_TRAIN_STEP, and its K5 launches are the VAE
    decode's alone (DROPOUT_K5_PER_TRAIN_STEP)."""
    import chip_smoke as cs
    calls = {'k5': 0, 'tconv': 0}
    k5, tconv = blocks.fused_gn_silu_tconv3, blocks.temporal_conv3

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(blocks, 'fused_gn_silu_tconv3', count('k5', k5))
    monkeypatch.setattr(blocks, 'temporal_conv3', count('tconv', tconv))
    torch.manual_seed(0)
    m = ControlledV2VUNet(dim=32, head_dim=16, num_heads_init_temporal=2,
                          context_dim=16).requires_grad_(False)
    args = (torch.randn(1, 2, 10, 8, 4), torch.tensor([500]),
            torch.randn(1, 7, 16), torch.randn(1, 2, 10, 8, 4))
    m(*args)
    assert calls == {'k5': cs.K5_PER_CFG_STEP, 'tconv': 0}
    calls.update(k5=0)
    m(*args, deterministic=False,
      dropout_masks=DropoutMasks(torch.Generator().manual_seed(0)))
    assert calls == {'k5': 0, 'tconv': cs.K5_PER_CFG_STEP}
    assert cs.UNFUSED_CHAINS_PER_TRAIN_STEP == 2 * cs.K5_PER_CFG_STEP // 4
    assert cs.DROPOUT_K5_PER_TRAIN_STEP == 2 * cs.K5_PER_DECODE == 56
