"""K10 and K11's plain versions (star_tpu_torch/ops/fused_ln.py) against the
JAX package's Pallas kernels in interpret mode and their jnp references
(tools/negative_results/fused_ln.py and stream_fuse.py, loaded by path),
and against star_tpu's main-path norms; the autograd Functions' gradients
against jax.grad through the JAX custom VJPs; and the negative checks that
a K10 dropping the gate, or a K11 normalising y instead of y + resid, miss
chip_smoke.py's kernel tolerance.

The routed blocks (SpatialTransformerBlock with cfg_split on and off,
TemporalTransformerBlock) are held against star_tpu at random non-zero
parameters by tests/test_torch_unet.py (cfg_pair on and off), the DiT by
tests/test_torch_dit.py.

Tolerances: fp32 at the JAX kernel test's atol 2e-5, rtol 1e-5
(tools/negative_results/test_fused_ln.py); bf16 within 2 bf16 steps of
the output's largest magnitude (the Pallas kernels apply in bf16 with
several roundings, the port in fp32 with one; 2.0 steps is the largest
seen, at C=3072 gated); gradients fp32 at 1e-4 of the largest gradient
(tests/test_torch_harness.py).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from star_tpu_torch.ops import fused_ln as fl
from test_torch_harness import assert_close, rng

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..')
ROWS = (2, 32)      # 64 rows: both Pallas kernels take a block, not the
#                     jnp fallback


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name):
    path = os.path.join(ROOT, 'tools', 'negative_results', f'{name}.py')
    spec = importlib.util.spec_from_file_location(f'negative_results_{name}',
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JK10, JK11 = _load('fused_ln'), _load('stream_fuse')


def case(c, gated, resid=False, seed=0):
    """(x or y, resid, scale, bias, gate_w) as fp32 numpy: rows of
    different offsets, so that the gate varies from row to row, and of
    sizes log-uniform from 1e-3 to 1. A LayerNorm is blind to a per-row
    factor except through eps, so the gate (and the gradient of its
    weights) shows only on rows whose variance nears eps."""
    r = rng(seed)

    def rows():
        size = 10.0 ** r.uniform(-3, 0, ROWS + (1,))
        return ((r.standard_normal(ROWS + (c,)) * 1.7
                 + r.standard_normal(ROWS + (1,))) * size).astype(np.float32)
    x = rows()
    res = rows() if resid else None
    scale = (1.0 + 0.1 * r.standard_normal(c)).astype(np.float32)
    bias = (0.1 * r.standard_normal(c)).astype(np.float32)
    gw = r.standard_normal(2).astype(np.float32) if gated else None
    return x, res, scale, bias, gw


def jx(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a).astype(dtype)


def tx(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(np.array(
        a, np.float32)).to(dtype)


def f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                      np.float32)


def within_bf16_steps(got, want, steps=2.0):
    """|got - want| within `steps` bf16 steps (8 significant bits) of the
    largest |want|."""
    step = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    err = np.abs(got - want).max()
    assert err <= steps * step, f'{err / step:.2f} bf16 steps'


def check(got, want, dtype):
    if dtype == 'fp32':
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
    else:
        within_bf16_steps(got, want)


DTYPES = {'fp32': (jnp.float32, torch.float32),
          'bf16': (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
@pytest.mark.parametrize('gated', [False, True])
@pytest.mark.parametrize('c', [320, 640, 1280, 3072])
def test_k10_plain_matches_pallas_kernel_and_reference(c, gated, dtype):
    x, _, scale, bias, gw = case(c, gated, seed=c)
    jd, td = DTYPES[dtype]
    xj = jx(x, jd)
    kern = JK10.fused_ln(xj, jx(scale), jx(bias), 1e-5, gate_w=jx(gw),
                         interpret=True)
    ref = JK10.fused_ln_reference(xj, jx(scale), jx(bias), 1e-5, jx(gw))
    got = fl.fused_ln_plain(tx(xj, td), tx(scale), tx(bias), 1e-5, tx(gw))
    assert got.dtype == td
    for want in (kern, ref):
        check(f32(got), f32(want), dtype)


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
@pytest.mark.parametrize('gated', [False, True])
@pytest.mark.parametrize('resid', [False, True])
@pytest.mark.parametrize('c', [320, 1280])
def test_k11_plain_matches_pallas_kernel_and_reference(c, resid, gated,
                                                       dtype):
    y, res, scale, bias, gw = case(c, gated, resid, seed=c + 1)
    jd, td = DTYPES[dtype]
    yj, rj = jx(y, jd), jx(res, jd)
    kern = JK11.fused_resid_liem_ln(yj, jx(scale), jx(bias), resid=rj,
                                    gate_w=jx(gw), eps=1e-5, interpret=True)
    ref = JK11._reference(yj, rj, jx(gw), jx(scale), jx(bias), 1e-5)
    got = fl.fused_resid_ln_plain(tx(yj, td), tx(scale), tx(bias),
                                  tx(rj, td), tx(gw), 1e-5)
    for want in (kern, ref):
        check(f32(got[0]), f32(want[0]), dtype)
        if resid:      # xr is the same rounded add, bit for bit
            np.testing.assert_array_equal(f32(got[1]), f32(want[1]))
        else:
            assert got[1] is None and want[1] is None


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
@pytest.mark.parametrize('gated', [False, True])
def test_plain_versions_match_star_tpu_norms(gated, dtype):
    """K10 and K11 compute star_tpu's main-path layer_norm and
    liem_layer_norm (the latter after the residual add, for K11)."""
    from star_tpu.ops import norms as jnorms
    x, res, scale, bias, gw = case(640, gated, True, seed=5)
    jd, td = DTYPES[dtype]
    xj, rj = jx(x, jd), jx(res, jd)
    norm = (lambda a: jnorms.liem_layer_norm(a, jx(scale), jx(bias),
                                             jx(gw))) if gated else \
        (lambda a: jnorms.layer_norm(a, jx(scale), jx(bias)))
    got10 = fl.fused_ln_plain(tx(xj, td), tx(scale), tx(bias), 1e-5, tx(gw))
    check(f32(got10), f32(norm(xj)), dtype)
    got11, xr = fl.fused_resid_ln_plain(tx(xj, td), tx(scale), tx(bias),
                                        tx(rj, td), tx(gw), 1e-5)
    check(f32(got11), f32(norm(xj + rj)), dtype)
    np.testing.assert_array_equal(f32(xr), f32(xj + rj))


def test_k11_without_residual_is_k10():
    y, _, scale, bias, gw = case(320, True, seed=6)
    normed, xr = fl.fused_resid_ln(tx(y), tx(scale), tx(bias), gate_w=tx(gw))
    assert xr is None
    torch.testing.assert_close(normed, fl.fused_ln(tx(y), tx(scale),
                                                   tx(bias), gate_w=tx(gw)),
                               rtol=0, atol=0)


@pytest.mark.parametrize('kind', ['k10', 'k10_gated', 'k11', 'k11_gated'])
def test_function_gradients_match_jax_grad(kind, monkeypatch):
    """The recompute Function that K10 and K11 run under on the card,
    driven through CUDA-looking tensors (the launchers replaced by their
    plain versions on the host, so that no library is built), against
    jax.grad through the JAX custom VJPs: gradients of x (y), resid,
    scale, bias and gate_w under random cotangents of every output."""
    gated, resid = kind.endswith('gated'), kind.startswith('k11')
    x, res, scale, bias, gw = case(320, gated, resid, seed=7)
    r = rng(8)
    ct = r.standard_normal(x.shape).astype(np.float32)
    ct_xr = r.standard_normal(x.shape).astype(np.float32)
    args = [a for a in (x, res, scale, bias, gw) if a is not None]

    if resid:
        def jloss(*a):
            y_, r_, s_, b_ = a[:4]
            out, xr = JK11.fused_resid_liem_ln(
                y_, s_, b_, resid=r_, gate_w=a[4] if gated else None,
                eps=1e-5)
            return jnp.sum(out * ct) + jnp.sum(xr * ct_xr)
    else:
        def jloss(*a):
            return jnp.sum(JK10.fused_ln(a[0], a[1], a[2], 1e-5,
                                         gate_w=a[3] if gated else None)
                           * ct)
    want = jax.grad(jloss, argnums=tuple(range(len(args))))(
        *(jnp.asarray(a) for a in args))

    host = lambda t: t.as_subclass(torch.Tensor)
    card = lambda t: torch.Tensor._make_subclass(_FakeCuda, t)
    monkeypatch.setattr(fl, '_launch_ln', lambda x, *a: card(
        fl.fused_ln_plain(host(x), *a)))
    monkeypatch.setattr(fl, '_launch_resid_ln', lambda y, sc, bi, r, *a: tuple(
        map(card, fl.fused_resid_ln_plain(host(y), sc, bi, host(r), *a))))
    leaves = [torch.Tensor._make_subclass(_FakeCuda, tx(a), True)
              if a.ndim == 3 else tx(a).requires_grad_() for a in args]
    if resid:
        y_, r_, s_, b_ = leaves[:4]
        outs = fl.fused_resid_ln(y_, s_, b_, r_, leaves[4] if gated else None,
                                 1e-5)
        cts = [tx(ct), tx(ct_xr)]
    else:
        outs = [fl.fused_ln(leaves[0], leaves[1], leaves[2], 1e-5,
                            leaves[3] if gated else None)]
        cts = [tx(ct)]
    assert all(type(o.grad_fn).__name__ == '_RecomputeBackward'
               for o in outs)
    got = torch.autograd.grad(outs, leaves, cts)
    for g, w in zip(got, want):
        assert_close(g, w)
    if gated:
        assert float(got[-1].abs().max()) > 0


@pytest.mark.parametrize('fault', ['k10_drops_gate',
                                   'k11_normalises_y_not_xr'])
def test_faults_miss_the_card_tolerance(fault):
    """On chip_smoke.py's phase-2 inputs (rows of scales from 1e-3 to 1, so
    the gate shows where the row variance nears eps), at a small row count:
    a K10 that drops the LIEM gate and a K11 that normalises y instead of
    y + resid both fail `agrees`, while the bf16 plain version agrees with
    the fp32 one on the same inputs."""
    import chip_smoke
    g = torch.Generator().manual_seed(0)
    resid = fault.startswith('k11')
    x, r, sc, bi, gw = chip_smoke.ln_inputs((2, 8, 40, 320), True, resid,
                                            'cpu', g)
    if resid:
        ref, _ = fl.fused_resid_ln_plain(x, sc, bi, r, gw)
        ref32, _ = fl.fused_resid_ln_plain(x.float(), sc, bi, r.float(), gw)
        bad, _ = fl.fused_resid_ln_plain(x, sc, bi, None, gw)
    else:
        ref = fl.fused_ln_plain(x, sc, bi, 1e-5, gw)
        ref32 = fl.fused_ln_plain(x.float(), sc, bi, 1e-5, gw)
        bad = fl.fused_ln_plain(x, sc, bi, 1e-5, None)
    chip_smoke.agrees('bf16 plain vs fp32 plain', [(ref, ref32)])
    with pytest.raises(AssertionError):
        chip_smoke.agrees(fault, [(bad, ref)])


@pytest.mark.parametrize('c,path,per_lane,exact', [
    (320, 'pairs', 8, False), (512, 'pairs', 8, False),
    (640, 'pairs', 16, False), (960, 'pairs', 16, False),
    (1024, 'vec16', 4, True), (1280, 'vec16', 5, True),
    (3072, 'vec16', 12, True), (1088, 'vec16', 16, False),
    (2048, 'vec16', 16, False), (4096, 'vec16', 16, False)])
def test_launch_plan_path_by_width(c, path, per_lane, exact):
    """csrc/fused_ln.cu's choice by C: bf16x2 pairs in a bucket of 8 or 16
    below 1024; 16-byte vectors from 1024, the array sized to the exact C
    at 1024, 1280 and 3072 (C/256 vectors a lane) and generic (16, the
    vectors past C/8 skipped) at the other multiples of 64 up to 4096.
    One warp a row, 4 rows a block."""
    plan = fl.ln_launch_plan(19360, c)
    assert (plan['path'], plan['per_lane'], plan['exact']) == (
        path, per_lane, exact)
    assert plan['align'] == (16 if path == 'vec16' else 4)
    assert plan['threads'] == 128 and plan['blocks'] == 19360 // 4
    if exact:
        assert plan['per_lane'] * 256 == c
    elif path == 'vec16':
        assert plan['per_lane'] * 256 >= c
    else:
        assert plan['per_lane'] * 64 >= c


@pytest.mark.parametrize('c', [96, 4160, 0, 32])
def test_launch_plan_refuses_widths(c):
    with pytest.raises(ValueError):
        fl.ln_launch_plan(8, c)


class _FakeCuda(torch.Tensor):
    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize('c,offset', [(1280, 4), (3072, 12), (1024, 2)])
def test_wide_path_refuses_misaligned_rows(c, offset):
    """The 16-byte path needs 16-byte aligned tensors: a view `offset`
    elements (8, 24 or 4 bytes) into its storage raises before any
    build."""
    base = torch.zeros(2 * c + offset, dtype=torch.bfloat16)
    x = torch.Tensor._make_subclass(_FakeCuda, base[offset:].view(2, c))
    sc = torch.ones(c, dtype=torch.bfloat16)
    bi = torch.zeros(c, dtype=torch.bfloat16)
    assert x.data_ptr() % 16
    with pytest.raises(ValueError, match='aligned'):
        fl._launch_ln(x, sc, bi, 1e-5, None)
    with pytest.raises(ValueError, match='aligned'):
        fl._launch_resid_ln(x, sc, bi, x, None, 1e-5)
