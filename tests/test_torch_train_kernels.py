"""Gradients of the port's kernel modules against the JAX functions they
replace (the training path):

  K2 `with_l` + K3   the port's autograd attention (the lse forward and
                     `flash_bwd_plain`) against jax.grad of the Pallas
                     training forward and recompute backward in interpret
                     mode, and against jax.vjp of `_xla_reference`; ragged
                     S, a dead kv tail (zero dk/dv there), fp32 and bf16
  K4                 autograd through the frame attention against jax.grad
  K5                 autograd through a 4-stage threaded-statistics chain
                     against jax.grad of the same JAX chain, and a copy that
                     drops the statistics cotangent, which must not pass;
                     in fp32, and in bf16 through the recompute Function
                     the card runs (CUDA-looking tensors, the launchers
                     replaced by their plain versions on the host), whose
                     backward runs its tap products as bf16 GEMMs
                     (`_TapProduct`)

Inputs are seeded numpy arrays handed to both sides. Tolerances are
relative to the reference's largest magnitude, stated in each test.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from star_tpu_torch.ops import (flash_attention as fa,
                                fused_temporal_conv as ftc, norms as nm,
                                temporal_attention as ta)
from test_torch_harness import assert_close, randn, rel_err, rng, t

jfa = importlib.import_module('star_tpu.ops.flash_attention')
jta = importlib.import_module('star_tpu.ops.temporal_attention')
jftc = importlib.import_module('star_tpu.ops.fused_temporal_conv')


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grads(fn, ct, *xs):
    """Port gradients of sum(fn(*xs) * ct) w.r.t. xs (leaf copies)."""
    xs = [x.detach().clone().requires_grad_() for x in xs]
    out = fn(*xs)
    return out, torch.autograd.grad(out, xs, ct)


def test_lse_forward_and_flash_bwd_plain_match_jax():
    """The plain training forward (o and the natural lse) and
    flash_bwd_plain against jax.vjp of `_xla_reference`, fp32: within 1e-4
    of the reference magnitude (summation order only)."""
    r = rng(3)
    b, s, h, d = 2, 70, 2, 64
    q, k, v, ct = (randn(r, b, s, h * d) for _ in range(4))
    scale = d ** -0.5
    o, lse = fa.flash_attention_packed_plain(t(q), t(k), t(v), h, scale,
                                             return_lse=True)
    to4 = lambda x: jnp.asarray(x).reshape(b, s, h, d)
    want, vjp = jax.vjp(lambda *a: jfa._xla_reference(*a, scale),
                        to4(q), to4(k), to4(v))
    logits = jnp.einsum('bqhd,bkhd->bhqk', to4(q), to4(k)) * scale
    assert_close(o, np.asarray(want).reshape(b, s, h * d))
    assert_close(lse, jax.nn.logsumexp(logits, axis=-1))
    got = fa.flash_bwd_plain(t(q), t(k), t(v), o, lse, t(ct), h, scale)
    for ours, ref in zip(got, vjp(to4(ct))):
        assert_close(ours, np.asarray(ref).reshape(b, s, h * d))


@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_flash_attention_grad_matches_pallas_with_l_and_k3(dtype, tol):
    """Ragged S (100 against 64-row blocks), unpacked [B, S, H, D] entry:
    the port's autograd (lse forward + flash_bwd_plain) against jax.grad
    of flash_attention (Pallas `with_l` forward + K3 in interpret mode) and
    of `_xla_reference`. fp32: 1e-4. bf16: 2e-2 — both round P and dS to
    bf16 before the products, but the Pallas kernel rounds the unnormalised
    exp2 and dO/l, the port the normalised P: a few bf16 ulps (4e-3 to
    7e-3 measured here)."""
    r = rng(4)
    b, s, h, d = 1, 100, 2, 64
    q, k, v, ct = (randn(r, b, s, h, d) for _ in range(4))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jq, jk, jv, jct = (jnp.asarray(x, jdt) for x in (q, k, v, ct))
    scale = d ** -0.5
    loss = lambda f: lambda *a: jnp.sum(f(*a).astype(jnp.float32)
                                        * jct.astype(jnp.float32))
    want = jax.grad(loss(lambda *a: jfa.flash_attention(
        *a, None, 64, 64, True)), argnums=(0, 1, 2))(jq, jk, jv)
    want_xla = jax.grad(loss(lambda *a: jfa._xla_reference(*a, scale)),
                        argnums=(0, 1, 2))(jq, jk, jv)
    _, got = _grads(fa.flash_attention, t(ct).to(dtype),
                    *(t(x).to(dtype) for x in (q, k, v)))
    for ours, ref, ref_xla in zip(got, want, want_xla):
        assert ours.dtype == dtype
        assert_close(ours, ref, tol)
        assert_close(ours, ref_xla, tol)


def test_packed_grad_with_dead_kv_tail_matches_pallas():
    """flash_attention_packed with kv_valid=100 of 130 keys and 5 heads
    (the UNet's odd head count), fp32: against jax.grad of the Pallas
    packed VJP in interpret mode within 1e-4; the dead keys' dk/dv are
    exactly zero on both sides."""
    r = rng(5)
    b, s, c, h, kv = 1, 130, 320, 5, 100
    q, k, v, ct = (randn(r, b, s, c) for _ in range(4))
    jq, jk, jv, jct = map(jnp.asarray, (q, k, v, ct))
    want = jax.grad(lambda *a: jnp.sum(jfa.flash_attention_packed(
        *a, h, None, 64, 64, True, False, kv) * jct),
        argnums=(0, 1, 2))(jq, jk, jv)
    _, got = _grads(lambda *a: fa.flash_attention_packed(*a, h,
                                                         kv_valid=kv),
                    t(ct), t(q), t(k), t(v))
    for ours, ref in zip(got, want):
        assert_close(ours, ref)
    for ours, ref in zip(got[1:], want[1:]):
        assert float(ours[:, kv:].abs().max()) == 0.0
        assert float(jnp.abs(ref[:, kv:]).max()) == 0.0


def test_temporal_attention_grad_matches_jax():
    """K4's plain version under autograd against jax.grad of
    temporal_attention (its einsum-recompute VJP), fp32, F=5: 1e-4."""
    r = rng(6)
    b, f, n, c, h = 2, 5, 12, 128, 2
    q, k, v, ct = (randn(r, b, f, n, c) for _ in range(4))
    want = jax.grad(lambda *a: jnp.sum(jta.temporal_attention(*a, h)
                                       * jnp.asarray(ct)),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    _, got = _grads(lambda *a: ta.temporal_attention(*a, h), t(ct),
                    t(q), t(k), t(v))
    for ours, ref in zip(got, want):
        assert_close(ours, ref)


def _chain_inputs():
    r = rng(7)
    b, f, n, c = 2, 4, 24, 64
    x = randn(r, b, f, n, c)
    stages = [(1.0 + randn(r, c, scale=0.1), randn(r, c, scale=0.1),
               randn(r, 3, 1, c, c, scale=0.1), randn(r, c, scale=0.1))
              for _ in range(4)]
    return x, stages, randn(r, b, f, n, c)


def _port_chain(x, stages, drop_stats_cotangent=False):
    """TemporalConvBlockV2's chain: statistics thread from stage to stage,
    the residual folds into the last stage."""
    y, st = x, None
    for i, (sc, bi, kern, cb) in enumerate(stages):
        if drop_stats_cotangent and st is not None:
            st = (st[0].detach(), st[1].detach())
        y, st = ftc.fused_gn_silu_tconv3(y, sc, bi, kern, cb, stats=st,
                                         residual=x if i == 3 else None,
                                         want_stats=i < 3)
    return y


def _chain_vs_jax(dtype):
    """The seeded chain inputs rounded to `dtype` on both sides: jax.grad
    of the JAX chain (x, then each stage's GN scale/bias, kernel and bias,
    as fp32 numpy) and a function giving the port's gradients of the same
    leaves (`drop`: the statistics treated as constants)."""
    x, stages, ct = _chain_inputs()
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jx = lambda a: jnp.asarray(a).astype(jdt)

    def jax_chain(x, stages):
        y, st = x, None
        for i, (sc, bi, kern, cb) in enumerate(stages):
            y, st = jftc.fused_gn_silu_tconv3(
                y, sc, bi, kern, cb, stats=st,
                residual=x if i == 3 else None, want_stats=i < 3)
        return jnp.sum(y.astype(jnp.float32) * jx(ct).astype(jnp.float32))

    jstages = [tuple(map(jx, s)) for s in stages]
    want = jax.grad(jax_chain, argnums=(0, 1))(jx(x), jstages)
    want = [np.asarray(g.astype(jnp.float32))
            for g in [want[0]] + [g for st in want[1] for g in st]]

    def port_grads(drop, on_card=False):
        leaves = [t(a).to(dtype).requires_grad_()
                  for a in [x] + [a for s in stages for a in s]]
        if on_card:
            leaves[0] = _card(leaves[0].detach(), True)
        ps = [tuple(leaves[1 + 4 * i:5 + 4 * i]) for i in range(4)]
        y = _port_chain(leaves[0], ps, drop)
        return torch.autograd.grad(y, leaves, t(ct).to(dtype))

    return want, port_grads


class _FakeCuda(torch.Tensor):
    @property
    def is_cuda(self):
        return True


def _card(a, requires_grad=False):
    return torch.Tensor._make_subclass(_FakeCuda, a, requires_grad)


def _host(a):
    return a.as_subclass(torch.Tensor) if isinstance(a, torch.Tensor) else a


def _k5_on_card(monkeypatch):
    """K5's launcher and K13's statistics launcher replaced by their
    plain versions on the host: a chain on CUDA-looking tensors then runs
    as on the card, K5's recompute Function forward and backward."""
    real = ftc.tconv3_plain

    def launch(*a):
        y, st = real(*map(_host, a))
        return _card(y), st
    monkeypatch.setattr(ftc, '_launch', launch)
    monkeypatch.setattr(nm, '_launch_stats', lambda x3: (
        torch.sum(_host(x3), 1, dtype=torch.float32),
        torch.sum(_host(x3).float().square(), 1)))


def test_fused_tconv_chain_grad_matches_jax_and_needs_the_stats_cotangent():
    """K5 through a 4-stage threaded chain, fp32: gradients of x and of
    every stage's GN scale/bias, kernel and bias against jax.grad of the
    JAX chain within 1e-4. The same chain with the statistics treated as
    constants (their cotangent dropped) loses the mean and variance terms
    of each GroupNorm gradient and must miss by far more (> 1e-2)."""
    want, port_grads = _chain_vs_jax(torch.float32)
    for ours, ref in zip(port_grads(False), want):
        assert_close(ours, ref)
    worst = max(rel_err(ours, ref)
                for ours, ref in zip(port_grads(True), want))
    assert worst > 1e-2, worst


def _bf16_step(a) -> float:
    """One bf16 step (ulp) at the largest magnitude of a."""
    return 2.0 ** (np.frexp(float(np.abs(a).max()))[1] - 8)


def test_fused_tconv_chain_grad_bf16_matches_jax_and_needs_the_stats_cotangent(
        monkeypatch):
    """The chain above in bf16: the same seeded values rounded to bf16 on
    both sides, so that the port's backward multiplies them through
    `_TapProduct` (bf16 operands, fp32 accumulation, each gradient rounded
    once to bf16) and JAX through the VJP of its bf16 einsum. Every
    gradient is within 8 bf16 steps of its reference's largest value
    (measured: at most 5.5, the same with the port's earlier fp32
    products; the forward's bf16 roundings differ in order). Dropping the
    statistics cotangent misses by more than 50 steps (measured: 321).
    The chain runs on CUDA-looking tensors, through K5's recompute
    Function, as on the card."""
    want, port_grads = _chain_vs_jax(torch.bfloat16)
    _k5_on_card(monkeypatch)
    products = []
    real = ftc._TapProduct.apply
    monkeypatch.setattr(ftc._TapProduct, 'apply',
                        lambda *a: products.append(1) or real(*a))
    got = port_grads(False, on_card=True)
    # each stage's forward (the launcher's stand-in) and its backward's
    # recompute go through the bf16 product
    assert len(products) == 8
    for ours, ref in zip(got, want):
        assert ours.dtype == torch.bfloat16
        err = float(np.abs(_host(ours).float().numpy() - ref).max())
        assert err <= 8 * _bf16_step(ref), (err, _bf16_step(ref))
    worst = max(float(np.abs(_host(ours).float().numpy() - ref).max())
                / _bf16_step(ref)
                for ours, ref in zip(port_grads(True, on_card=True), want))
    assert worst > 50, worst
