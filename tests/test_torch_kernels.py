"""The plain versions of the port's four kernel modules against the JAX
functions they replace, run both ways: the Pallas kernel in interpret mode
and the jnp/XLA fallback.

  K1 flash_attention_packed   odd head count (C=320), kv_valid, prescaled
  K2 flash_attention          d=512, one head
  K4 temporal_attention       F=8 and F=3
  K5 fused_gn_silu_tconv3     per-batch and per-frame statistics at F>3,
                              residual, the AlphaBlender fold (scaled taps)

fp32 throughout, tolerance 1e-4 of the reference magnitude (see
test_torch_harness.py); statistics sums are held to the same relative
tolerance.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest

from star_tpu_torch.ops import (flash_attention as fa,
                                fused_temporal_conv as ftc,
                                temporal_attention as ta)
from test_torch_harness import assert_close, randn, rng, t

jfa = importlib.import_module('star_tpu.ops.flash_attention')
jattn = importlib.import_module('star_tpu.ops.attention')
jta = importlib.import_module('star_tpu.ops.temporal_attention')
jftc = importlib.import_module('star_tpu.ops.fused_temporal_conv')


@pytest.mark.parametrize('b,s,c,heads,kv_valid,prescaled', [
    (2, 96, 320, 5, None, False),     # odd head count, whole-row blocks
    (2, 96, 320, 5, 77, False),       # dead key tail
    (1, 130, 128, 2, None, True),     # prescaled q, ragged seq
    (1, 130, 128, 2, 100, True),
])
def test_k1_packed_flash(b, s, c, heads, kv_valid, prescaled):
    r = rng(1)
    q, k, v = (randn(r, b, s, c) for _ in range(3))
    if prescaled:
        q = q * (0.125 * jfa.LOG2E)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    ours = fa.flash_attention_packed(t(q), t(k), t(v), heads,
                                     kv_valid=kv_valid, prescaled=prescaled)
    interp = jfa.flash_attention_packed(jq, jk, jv, heads, None, 32, 32,
                                        True, False, kv_valid, prescaled)
    xla = jattn.dot_product_attention_packed(jq, jk, jv, heads,
                                             kv_valid=kv_valid,
                                             prescaled=prescaled)
    assert_close(ours, interp)
    assert_close(ours, xla)


@pytest.mark.parametrize('s', [64, 100])
def test_k2_flash_d512(s):
    r = rng(2)
    q, k, v = (randn(r, 2, s, 1, 512) for _ in range(3))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    ours = fa.flash_attention(t(q), t(k), t(v))
    interp = jfa.flash_attention(jq, jk, jv, None, 32, 32, True)
    xla = jattn.dot_product_attention(jq, jk, jv)
    assert_close(ours, interp)
    assert_close(ours, xla)


def test_attention_routing_keeps_short_sequences_plain(monkeypatch):
    """Only Sq >= 512 and Sk >= 512 reach the flash kernels; the 77-token
    cross-attention and the 260-token mid scale stay plain."""
    attn = importlib.import_module('star_tpu_torch.ops.attention')
    calls = []
    monkeypatch.setattr(attn, 'flash_attention_packed',
                        lambda *a, **k: calls.append('flash') or a[0])
    r = rng(3)
    for sq, sk in ((600, 77), (260, 260), (600, 600)):
        q = t(randn(r, 1, sq, 128))
        k = t(randn(r, 1, sk, 128))
        attn.dot_product_attention_packed(q, k, k, 2)
    assert calls == ['flash']


@pytest.mark.parametrize('b,f,n,c,heads', [
    (2, 8, 24, 320, 5),
    (1, 3, 40, 128, 2),
])
def test_k4_temporal_attention(b, f, n, c, heads):
    r = rng(4)
    q, k, v = (randn(r, b, f, n, c) for _ in range(3))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    ours = ta.temporal_attention(t(q), t(k), t(v), heads)
    interp = jta.temporal_attention(jq, jk, jv, heads, None, None, True)
    xla = jta._xla_reference(jq, jk, jv, 1 / math.sqrt(c // heads), heads,
                             c // heads)
    assert_close(ours, interp)
    assert_close(ours, xla)


@pytest.mark.parametrize('b,f,n,c,cout,res,per_frame,alpha', [
    (2, 8, 64, 64, 64, False, False, None),   # UNet-like chain stage
    (2, 5, 48, 64, 64, True, True, 0.6),      # VAE conv2: fold + per-frame
    (1, 3, 40, 64, 32, True, False, None),    # channel change, F=3
])
def test_k5_fused_gn_silu_tconv3(b, f, n, c, cout, res, per_frame, alpha):
    r = rng(5)
    x = randn(r, b, f, n, c)
    sc = randn(r, c, scale=0.1) + 1.0
    bi = randn(r, c, scale=0.1)
    kern = randn(r, 3, 1, c, cout, scale=0.05)
    cb = randn(r, cout, scale=0.1)
    resid = randn(r, b, f, n, cout) if res else None
    if alpha is not None:
        kern, cb = kern * alpha, cb * alpha
    stats = (x.reshape(b, f * n, c).sum(1), (x ** 2).reshape(b, f * n, c)
             .sum(1))
    args = (x, sc, bi, kern, cb)
    ours, ost = ftc.fused_gn_silu_tconv3(
        *map(t, args), stats=tuple(map(t, stats)),
        residual=None if resid is None else t(resid), want_stats=True,
        stats_per_frame=per_frame)
    for interpret in (True, False):
        want, wst = jftc.fused_gn_silu_tconv3(
            *map(jnp.asarray, args), stats=tuple(map(jnp.asarray, stats)),
            residual=None if resid is None else jnp.asarray(resid),
            want_stats=True, interpret=interpret,
            stats_per_frame=per_frame)
        assert_close(ours, want)
        assert_close(ost[0], wst[0])
        assert_close(ost[1], wst[1])
    rows = b * f if per_frame else b
    assert tuple(ost[0].shape) == (rows, cout)


def test_k5_stats_thread_like_fresh_stats():
    """Threaded statistics equal the statistics of the stored output."""
    from star_tpu_torch.ops.conv3x3 import channel_stats
    r = rng(6)
    x = t(randn(r, 1, 4, 32, 64))
    sc, bi = t(np.ones(64, np.float32)), t(np.zeros(64, np.float32))
    kern = t(randn(r, 3, 1, 64, 64, scale=0.05))
    cb = t(np.zeros(64, np.float32))
    y, st = ftc.fused_gn_silu_tconv3(x, sc, bi, kern, cb, want_stats=True)
    fresh = channel_stats(y.reshape(1, -1, 64))
    assert_close(st[0], fresh[0])
    assert_close(st[1], fresh[1])
