"""K5's backward products in bf16 (star_tpu_torch/ops/fused_temporal_conv.py,
`_TapProduct`), held on the CPU without JAX:

  * the cotangent that reaches the tap product in a 4-stage bf16 K5 chain
    (threaded statistics, a residual) holds bf16 values exactly, so it
    passes to a bf16 GEMM without loss;
  * the chain's gradients through the bf16 products equal those of the
    fp32 products of the same bf16 values (the port's earlier backward)
    within one bf16 step of each gradient's largest value;
  * the forward is the fp32 product of the bf16 operands and each
    gradient one bf16 rounding of the exact product; fp32 inputs keep fp32
    products; the split-K setting is restored;
  * a `cuda` case (the tensor cores against the fp32 path) that skips here.

The chain against jax.grad, in fp32 and in bf16 (through `_TapProduct`),
is in tests/test_torch_train_kernels.py.
"""

import pytest
import torch

from star_tpu_torch.ops import fused_temporal_conv as ftc


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chain_inputs(dtype=torch.bfloat16, seed=11):
    g = torch.Generator().manual_seed(seed)
    b, f, n, c = 2, 4, 24, 64

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dtype)
    x = randn(b, f, n, c)
    stages = [(1.0 + randn(c, scale=0.1), randn(c, scale=0.1),
               randn(3, 1, c, c, scale=0.1), randn(c, scale=0.1))
              for _ in range(4)]
    return x, stages, randn(b, f, n, c)


def _chain_grads(x, stages, ct):
    """Gradients of sum(chain(x) * ct) w.r.t. x and every stage's leaves,
    through TemporalConvBlockV2's chain (statistics threaded from stage to
    stage, the residual folded into the last)."""
    leaves = [x.clone().requires_grad_()] + [
        a.clone().requires_grad_() for s in stages for a in s]
    y, st = leaves[0], None
    for i in range(4):
        sc, bi, kern, cb = leaves[1 + 4 * i:5 + 4 * i]
        y, st = ftc.fused_gn_silu_tconv3(
            y, sc, bi, kern, cb, stats=st,
            residual=leaves[0] if i == 3 else None, want_stats=i < 3)
    return torch.autograd.grad(y, leaves, ct)


def _fp32_products(ys, kb):
    """The earlier backward's products: fp32 GEMMs of the upcast bf16
    operands, whose gradients autograd rounds to bf16 at the casts."""
    return torch.matmul(ys.float(), kb.float())


def test_cotangent_reaching_the_tap_product_is_bf16(monkeypatch):
    seen = []
    real = ftc._TapProduct.backward

    def backward(ctx, ct):
        seen.append(ct)
        return real(ctx, ct)
    monkeypatch.setattr(ftc._TapProduct, 'backward', staticmethod(backward))
    x, stages, ct = _chain_inputs()
    _chain_grads(x, stages, ct)
    assert len(seen) == 4
    for c in seen:
        assert c.dtype == torch.float32 and float(c.abs().max()) > 0
        assert torch.equal(c.to(torch.bfloat16).float(), c)


def _bf16_step(t):
    """One bf16 step (ulp) at the largest magnitude of t."""
    big = float(t.float().abs().max())
    return 2.0 ** (torch.frexp(torch.tensor(big)).exponent.item() - 8)


def test_bf16_products_match_the_fp32_products_within_one_step(
        monkeypatch):
    x, stages, ct = _chain_inputs()
    ours = _chain_grads(x, stages, ct)
    with monkeypatch.context() as m:
        m.setattr(ftc._TapProduct, 'apply', _fp32_products)
        ref = _chain_grads(x, stages, ct)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype == torch.bfloat16
        assert float(b.float().abs().max()) > 0
        err = float((a.float() - b.float()).abs().max())
        assert err <= _bf16_step(b), (err, _bf16_step(b))


def test_tap_product_rounds_each_gradient_once():
    g = torch.Generator().manual_seed(3)
    ys = torch.randn(300, 192, generator=g).bfloat16()
    kb = (torch.randn(192, 48, generator=g) * 0.1).bfloat16()
    ct = torch.randn(300, 48, generator=g).bfloat16().float()
    a, b = ys.clone().requires_grad_(), kb.clone().requires_grad_()
    out = ftc._TapProduct.apply(a, b)
    assert out.dtype == torch.float32
    exact = ys.double() @ kb.double()
    torch.testing.assert_close(out.double(), exact, rtol=1e-6, atol=1e-5)
    dys, dkb = torch.autograd.grad(out, (a, b), ct)
    assert dys.dtype == dkb.dtype == torch.bfloat16
    # one rounding of the exact products: within one bf16 step of each
    # element (fp32 sums in another order may land on its neighbour)
    for got, want in ((dys, ct.double() @ kb.double().t()),
                      (dkb, ys.double().t() @ ct.double())):
        ulp = torch.ldexp(torch.ones_like(want),
                          torch.frexp(want).exponent - 8)
        assert bool(((got.double() - want).abs() <= ulp).all())


def test_fp32_inputs_keep_fp32_products(monkeypatch):
    def refuse(*a):
        raise AssertionError('fp32 operands went through the bf16 product')
    monkeypatch.setattr(ftc._TapProduct, 'apply', refuse)
    x, stages, ct = _chain_inputs(torch.float32)
    grads = _chain_grads(x, stages, ct)
    assert all(gr.dtype == torch.float32 for gr in grads)


def test_fp32_reductions_restore_the_setting():
    mm = torch.backends.cuda.matmul
    prev = mm.allow_bf16_reduced_precision_reduction
    try:
        for start in (True, False):
            mm.allow_bf16_reduced_precision_reduction = start
            with ftc._fp32_reductions():
                assert mm.allow_bf16_reduced_precision_reduction is False
            assert mm.allow_bf16_reduced_precision_reduction is start
    finally:
        mm.allow_bf16_reduced_precision_reduction = prev


@pytest.mark.cuda
def test_tensor_core_products_match_the_fp32_products_on_the_card(
        monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    x, stages, ct = _chain_inputs()
    x, ct = x.cuda(), ct.cuda()
    stages = [tuple(a.cuda() for a in s) for s in stages]
    ours = _chain_grads(x, stages, ct)
    with monkeypatch.context() as m:
        m.setattr(ftc._TapProduct, 'apply', _fp32_products)
        ref = _chain_grads(x, stages, ct)
    for a, b in zip(ours, ref):
        err = float((a.float() - b.float()).abs().max())
        assert err <= _bf16_step(b), (err, _bf16_step(b))
