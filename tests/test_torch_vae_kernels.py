"""The plain versions of the port's VAE conv kernels against the JAX
functions they replace, each Pallas form run in interpret mode:

  K6 fused_gn_silu_conv3x3   against impl='direct' (`_conv_kernel`),
                             'winoh' at h=12 (F(4,3)) and h=10 (F(2,3)),
                             'wino' (F(2x2,3x3)) and 'xla'; with and
                             without a residual, threaded or computed
                             statistics, C != Cout
  K7 upsample_conv2x         against upsample_conv2x_fused and the XLA
                             phase route; phase_weights against JAX's K_rs
  K8 interleave2x2           against the Pallas interleave

fp32 throughout. Tolerances: 1e-4 of the reference magnitude against the
direct kernel, the XLA routes and the interleave (test_torch_harness.py;
the interleave's values must match exactly). The Winograd forms are held
to the tolerances of the JAX package's own tests of them against its XLA
route (tests/test_conv3x3.py: 5e-4 for F(2x2,3x3), 2e-3 for H-Winograd,
where the direct kernel meets 2e-5): their fp32 input and output
transforms add and subtract scaled copies of the operands, so they round
more than the direct taps.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from star_tpu_torch.models.layers import Conv2d
from star_tpu_torch.ops import conv3x3, upsample_conv
from test_torch_harness import assert_close, port, randn, rng, t

jconv = importlib.import_module('star_tpu.ops.conv3x3')
jup = importlib.import_module('star_tpu.ops.upsample_conv')

# impl -> (output atol, rtol, statistics atol) of the JAX package's tests
WINOGRAD_TOL = {'wino': (5e-4, 1e-4, 2e-2), 'winoh': (2e-3, 1e-3, 5e-2)}


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _conv_weights(r, c, cout):
    """A flax Conv tree (HWIO kernel) and the port's Conv2d loaded from it
    through convert/from_flax.py (OIHW)."""
    tree = {'kernel': randn(r, 3, 3, c, cout, scale=0.05),
            'bias': randn(r, cout, scale=0.1)}
    conv = port(Conv2d(c, cout, 3, padding=1), tree)
    return tree, conv.weight, conv.bias


@pytest.mark.parametrize('impl,n,h,c,cout,res,thread_stats', [
    ('direct', 2, 12, 128, 128, True, True),
    ('winoh', 1, 12, 128, 128, True, False),     # F(4,3)
    ('winoh', 1, 10, 128, 256, False, True),     # F(2,3)
    ('wino', 1, 12, 128, 128, True, False),
])
def test_k6_fused_gn_silu_conv3x3(impl, n, h, c, cout, res, thread_stats):
    r = rng(60)
    w = 16
    x = randn(r, n, h, w, c)
    tree, weight, bias = _conv_weights(r, c, cout)
    sc = randn(r, c, scale=0.1) + 1.0
    bi = randn(r, c, scale=0.1)
    resid = randn(r, n, h, w, cout) if res else None
    stats = ((x.reshape(n, -1, c).sum(1), (x ** 2).reshape(n, -1, c).sum(1))
             if thread_stats else None)
    ours, ost = conv3x3.fused_gn_silu_conv3x3(
        t(x), t(sc), t(bi), weight, bias,
        stats=None if stats is None else tuple(map(t, stats)),
        residual=None if resid is None else t(resid), want_stats=True)
    assert tuple(ours.shape) == (n, h, w, cout)
    assert tuple(ost[0].shape) == (n, cout)
    kw = dict(stats=None if stats is None else tuple(map(jnp.asarray, stats)),
              residual=None if resid is None else jnp.asarray(resid),
              want_stats=True)
    args = (jnp.asarray(x), sc, bi, tree['kernel'], tree['bias'])
    # the Pallas form must really be taken for this shape (an unmet tiling
    # pick would fall back to XLA silently)
    if impl == 'wino':
        assert jconv._pick_hb_wino(h, w, c, cout) is not None
    elif impl == 'winoh':
        assert jconv._pick_hb_winoh(h, w, c, cout)[1] == (4 if h == 12 else 2)
    else:
        assert jconv._pick_hb(h, w, c, cout) is not None
    kern, kst = jconv.fused_gn_silu_conv3x3(*args, impl=impl,
                                            interpret=True, **kw)
    xla, xst = jconv.fused_gn_silu_conv3x3(*args, impl='xla', **kw)
    if impl == 'direct':
        assert_close(ours, kern)
        assert_close(ost[0], kst[0])
        assert_close(ost[1], kst[1])
    else:
        atol, rtol, satol = WINOGRAD_TOL[impl]
        np.testing.assert_allclose(ours.numpy(), np.asarray(kern),
                                   atol=atol, rtol=rtol)
        for i in range(2):
            np.testing.assert_allclose(ost[i].numpy(), np.asarray(kst[i]),
                                       atol=satol)
    assert_close(ours, xla)
    assert_close(ost[0], xst[0])
    assert_close(ost[1], xst[1])


def test_k6_without_stats_keeps_the_plain_route_for_narrow_outputs():
    """want_stats=False returns no statistics, and the encoder's conv_out
    shape (Cout = 8) computes the same function as the XLA route."""
    r = rng(61)
    x = randn(r, 1, 6, 8, 64)
    tree, weight, bias = _conv_weights(r, 64, 8)
    sc, bi = randn(r, 64, scale=0.1) + 1.0, randn(r, 64, scale=0.1)
    ours, ost = conv3x3.fused_gn_silu_conv3x3(t(x), t(sc), t(bi), weight,
                                              bias)
    want, _ = jconv.fused_gn_silu_conv3x3(jnp.asarray(x), sc, bi,
                                          tree['kernel'], tree['bias'],
                                          impl='xla')
    assert ost is None
    assert_close(ours, want)


def _jax_k_rs(kernel_hwio):
    ms = [jnp.asarray(m, jnp.float32) for m in jup._M]
    return jnp.stack([jnp.einsum('ap,bq,abio->pqio', ms[r], ms[s],
                                 jnp.asarray(kernel_hwio))
                      for r in (0, 1) for s in (0, 1)])


def test_k7_upsample_conv2x():
    r = rng(62)
    n, h, w, c, cout = 1, 3, 16, 128, 256
    x = randn(r, n, h, w, c)
    tree, weight, bias = _conv_weights(r, c, cout)
    k_rs = _jax_k_rs(tree['kernel'])
    assert_close(upsample_conv.phase_weights(weight), k_rs)
    ours, ost = upsample_conv.upsample_conv2x(t(x), weight, bias,
                                              want_stats=True)
    assert tuple(ours.shape) == (n, 2 * h, 2 * w, cout)
    assert jconv._pick_hb_upsample(h, w, c, cout) is not None
    fused, fst = jconv.upsample_conv2x_fused(jnp.asarray(x), k_rs,
                                             tree['bias'], want_stats=True,
                                             interpret=True)
    xla, xst = jup.upsample_conv2x(jnp.asarray(x), tree['kernel'],
                                   tree['bias'], want_stats=True)
    for want, wst in ((fused, fst), (xla, xst)):
        assert_close(ours, want)
        assert_close(ost[0], wst[0])
        assert_close(ost[1], wst[1])


@pytest.mark.parametrize('want_stats', [False, True])
def test_k8_interleave2x2(want_stats):
    r = rng(63)
    ps = [randn(r, 2, 6, 16, 128) for _ in range(4)]
    ours = upsample_conv.interleave2x2(*map(t, ps), want_stats=want_stats)
    want = jconv.interleave2x2(*map(jnp.asarray, ps), want_stats=want_stats,
                               interpret=True)
    if want_stats:
        (ours, ost), (want, wst) = ours, want
        assert_close(ost[0], wst[0])
        assert_close(ost[1], wst[1])
    np.testing.assert_array_equal(ours.numpy(), np.asarray(want))
