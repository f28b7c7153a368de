"""K9's plain version (star_tpu_torch/ops/qk_ln_rope.py) against star_tpu's
Pallas kernel in interpret mode and its jnp reference, its backward's
closed form against autograd through the plain version, and the DiT's RoPE
tables against the JAX DiT's head-tiled ones.

The port takes [S, 64] tables (one row for every head) where the JAX
package takes them tiled across heads ([S, H*64]); the JAX side gets the
tiled copy of the same rows. fp32 at the JAX test's tolerance (atol 3e-5,
rtol 1e-4, tests/test_flash_attention.py); bf16 within one bf16 step of
the output, since both compute in fp32 and round once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from star_tpu_torch.ops.qk_ln_rope import (LOG2E, qk_ln_rope,
                                           qk_ln_rope_bwd_plain,
                                           qk_ln_rope_plain)
from test_torch_harness import randn, rng

B, S, H, D = 2, 84, 4, 64     # S pads to the Pallas kernel's 96-row block
TEXT, TAIL = 7, 3             # identity rows at the front and the tail


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def case(seed=0, dtype=np.float32):
    r = rng(seed)
    x = (randn(r, B, S, H * D) * 2 + 0.5).astype(dtype)
    scale = 1.0 + randn(r, D, scale=0.1)
    bias = randn(r, D, scale=0.1)
    ang = r.uniform(0, 3, (S, D)).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    for rows in (slice(0, TEXT), slice(S - TAIL, S)):
        cos[rows], sin[rows] = 1.0, 0.0
    return x, scale, bias, cos, sin


def jax_both(x, scale, bias, cos, sin, fold):
    """(Pallas kernel in interpret mode, jnp reference) on the head-tiled
    tables."""
    from star_tpu.ops.qk_ln_rope import qk_ln_rope as jk
    from star_tpu.ops.qk_ln_rope import qk_ln_rope_reference
    cos_t, sin_t = (jnp.asarray(np.tile(a, (1, H))) for a in (cos, sin))
    args = (jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), cos_t,
            sin_t, H)
    kern = jk(*args, fold_scale=fold, lane_chunk=128, interpret=True)
    ref = qk_ln_rope_reference(*args, fold_scale=fold)
    return np.asarray(kern, np.float32), np.asarray(ref, np.float32)


def port(x, scale, bias, cos, sin, fold):
    t = lambda a: torch.from_numpy(np.asarray(a))
    x_t = t(x.astype(np.float32)).to(torch.bfloat16) \
        if x.dtype == jnp.bfloat16 else t(x)
    out = qk_ln_rope(x_t, t(scale), t(bias), t(cos), t(sin), H,
                     fold_scale=fold)
    return out.float().numpy()


@pytest.mark.parametrize('fold', [1.0, LOG2E / 8.0])
def test_plain_matches_pallas_kernel_and_reference_fp32(fold):
    x, scale, bias, cos, sin = case(1)
    kern, ref = jax_both(x, scale, bias, cos, sin, fold)
    got = port(x, scale, bias, cos, sin, fold)
    np.testing.assert_allclose(got, kern, atol=3e-5, rtol=1e-4)
    np.testing.assert_allclose(got, ref, atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize('fold', [1.0, LOG2E / 8.0])
def test_plain_matches_pallas_kernel_and_reference_bf16(fold):
    x, scale, bias, cos, sin = case(2)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    kern, ref = jax_both(np.asarray(xb), scale, bias, cos, sin, fold)
    got = port(np.asarray(xb), scale, bias, cos, sin, fold)
    for want in (kern, ref):
        # one bf16 step (8 significant bits) of the reference value
        step = 2.0 ** (np.floor(np.log2(np.abs(want) + 1e-30)) - 7)
        assert np.all(np.abs(got - want) <= step), \
            np.max(np.abs(got - want) / step)


def test_identity_rows_pass_the_normalised_values_through():
    """Text and tail rows (cos 1, sin 0) come out as LN + affine alone."""
    x, scale, bias, cos, sin = case(3)
    t = torch.from_numpy
    got = qk_ln_rope_plain(t(x), t(scale), t(bias), t(cos), t(sin), H,
                           fold_scale=0.5)
    x4 = t(x).reshape(B, S, H, D)
    ln = torch.nn.functional.layer_norm(x4, (D,), t(scale), t(bias), 1e-6)
    want = (ln * 0.5).reshape(B, S, H * D)
    for rows in (slice(0, TEXT), slice(S - TAIL, S)):
        torch.testing.assert_close(got[:, rows], want[:, rows], atol=1e-5,
                                   rtol=1e-5)
    assert not torch.allclose(got[:, TEXT:S - TAIL], want[:, TEXT:S - TAIL])


@pytest.mark.parametrize('b, s, heads, fold, want_params, dtype', [
    (1, 13, 1, 1.0, True, torch.float32),
    (2, 13, 3, 0.18, True, torch.float32),
    (2, 13, 3, 0.18, False, torch.float32),
    (2, 13, 3, 1.0, True, torch.bfloat16),
    (1, 13, 3, 0.18, False, torch.bfloat16),
])
def test_bwd_plain_matches_autograd_of_the_plain_version(b, s, heads, fold,
                                                         want_params, dtype):
    """qk_ln_rope_bwd_plain (the CPU backward, and the backward kernel's
    plain version) against torch.autograd.grad of qk_ln_rope_plain, with
    identity table rows at the front and the tail (the DiT's text and pad
    rows). fp32 within 1e-5 of each gradient's largest; bf16 x and
    cotangent, dx rounded to bf16 once on both sides, within one bf16 step
    of each value, and the fp32 scale and bias gradients within 1e-5.
    Without `want_params` dx is the same, bit for bit, and no scale or bias
    gradient comes back."""
    r = rng(11)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    x = t(randn(r, b, s, heads * D) * 2 + 0.5).to(dtype)
    ct = t(randn(r, b, s, heads * D)).to(dtype)
    scale, bias = t(1.0 + randn(r, D, scale=0.1)), t(randn(r, D, scale=0.1))
    ang = r.uniform(0, 3, (s, D))
    cos, sin = t(np.cos(ang)), t(np.sin(ang))
    cos[:2], sin[:2], cos[-1:], sin[-1:] = 1.0, 0.0, 1.0, 0.0
    leaves = [a.clone().requires_grad_() for a in (x, scale, bias)]
    out = qk_ln_rope_plain(*leaves[:3], cos, sin, heads, fold_scale=fold)
    want = torch.autograd.grad(out, leaves, ct)
    got = qk_ln_rope_bwd_plain(x, ct, scale, bias, cos, sin, heads,
                               fold_scale=fold, want_params=want_params)
    assert got[0].dtype == dtype
    if dtype == torch.bfloat16:
        g, w = got[0].float(), want[0].float()
        step = 2.0 ** (torch.floor(torch.log2(w.abs() + 1e-30)) - 7)
        assert bool((g - w).abs().le(step).all()), \
            float(((g - w).abs() / step).max())
    else:
        assert rel_err(got[0], want[0]) <= 1e-5
    if want_params:
        for g, w in zip(got[1:], want[1:]):
            assert g.dtype == torch.float32 and rel_err(g, w) <= 1e-5
    else:
        assert got[1:] == (None, None)
        full = qk_ln_rope_bwd_plain(x, ct, scale, bias, cos, sin, heads,
                                    fold_scale=fold)
        assert torch.equal(got[0], full[0])


def rel_err(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def test_rope_tables_equal_the_jax_dits_head_tiled_tables():
    """The port DiT's [S, 64] rows, tiled across heads, are the JAX DiT's
    full-sequence tables: identity at the text rows and the pad tail, the
    3D RoPE between (7 frames of 30x45 latents, 226 text tokens, 9680
    rows)."""
    from star_tpu.models.dit.dit import rope_3d_tables as jax_rope
    from star_tpu_torch.models.dit.dit import rope_tables
    t, hp, wp, heads, tl, s_pad = 7, 30, 45, 48, 226, 9680
    c = heads * 64
    s_real = tl + t * hp * wp
    cos, sin = rope_tables(tl, t, hp, wp, s_pad, 64)
    cos_np, sin_np = jax_rope(t, hp, wp, 64)
    cos_full = np.ones((s_pad, c), np.float32)
    sin_full = np.zeros((s_pad, c), np.float32)
    cos_full[tl:s_real] = np.tile(cos_np, (1, heads))
    sin_full[tl:s_real] = np.tile(sin_np, (1, heads))
    np.testing.assert_array_equal(np.tile(cos, (1, heads)), cos_full)
    np.testing.assert_array_equal(np.tile(sin, (1, heads)), sin_full)
    assert cos.shape == (s_pad, 64) and cos.dtype == np.float32
