"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py),
and the tests of those helpers.

The JAX package is the reference: a flax module's parameter tree is filled
with random non-zero values (no zero-init leaf stays zero) and the same
tree is carried over to the port with convert/from_flax.py. Inputs are made
with numpy from a seed and handed to both frameworks as arrays.

Tolerances: fp32 modules are held to 1e-4 of the reference's largest
magnitude (`assert_close`). The two frameworks sum in different orders and
JAX's Pallas kernels use a fixed-reference softmax, so bit equality is not
expected; 1e-4 is two orders above the fp32 rounding seen at these sizes
and far below any semantic error (a wrong tap, mask or statistic moves
outputs by 1e-2 or more).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from star_tpu_torch.convert import from_flax, load_flax
from star_tpu_torch.models.layers import Conv2d, NormParams

RTOL = 1e-4


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rng(seed: int = 0) -> np.random.RandomState:
    return np.random.RandomState(seed)


def randn(r: np.random.RandomState, *shape, scale: float = 1.0):
    return (r.standard_normal(shape) * scale).astype(np.float32)


def random_params(module, *init_args, seed: int = 0):
    """Random non-zero parameters in the tree layout `module.init` would
    give, without running (or compiling) flax's initialisers: shapes come
    from jax.eval_shape, values from numpy. Kernels get std 1/sqrt(fan_in),
    norm scales 1 +- 0.1, every other leaf (biases, zero-init heads and
    zero convs included) std 0.1."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *init_args)
    r = rng(seed)

    def fill(path, s):
        name = str(path[-1].key)
        if name == 'scale':
            return 1.0 + randn(r, *s.shape, scale=0.1)
        if name == 'kernel' and len(s.shape) >= 2:
            fan_in = int(np.prod(s.shape[:-1]))
            return randn(r, *s.shape, scale=fan_in ** -0.5)
        return randn(r, *s.shape, scale=0.1)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32)


def rel_err(actual, expected) -> float:
    a, e = to_np(actual), to_np(expected)
    assert a.shape == e.shape, (a.shape, e.shape)
    return float(np.abs(a - e).max() / max(np.abs(e).max(), 1e-6))


def assert_close(actual, expected, rtol: float = RTOL):
    err = rel_err(actual, expected)
    assert err <= rtol, f'max error {err:.3e} of the reference magnitude'


def t(x) -> torch.Tensor:
    """numpy / jax array -> CPU torch tensor."""
    return torch.from_numpy(np.array(x))


def port(module: torch.nn.Module, tree) -> torch.nn.Module:
    """Load a flax tree into a port module (CPU, eval, no grad)."""
    return load_flax(module, tree).eval().requires_grad_(False)


# -------------------------------------------------------------- self-tests


def test_from_flax_layouts():
    """Dense [in,out] -> Linear [out,in]; Conv HWIO -> OIHW; scale ->
    weight; and the converted layers compute what flax computes."""
    from flax import linen as fnn

    class M(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            x = fnn.Conv(6, (3, 3), padding=1, name='conv')(x)
            return fnn.Dense(5, name='dense')(x)

    class P(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = Conv2d(4, 6, 3, padding=1)
            self.dense = torch.nn.Linear(6, 5)

        def forward(self, x):
            return self.dense(self.conv(x))

    x = randn(rng(1), 2, 5, 7, 4)
    params = random_params(M(), jnp.asarray(x))
    ours = port(P(), params)
    assert ours.conv.weight.shape == (6, 4, 3, 3)
    assert ours.dense.weight.shape == (5, 6)
    want = M().apply(params, jnp.asarray(x))
    assert_close(ours(t(x)), want)


def test_from_flax_rejects_mismatched_trees():
    class P(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.norm = NormParams(4)

    good = {'norm': {'scale': np.ones(4), 'bias': np.zeros(4)}}
    assert set(from_flax(P(), good)) == {'norm.weight', 'norm.bias'}
    with pytest.raises(KeyError):
        from_flax(P(), {'norm': {'scale': np.ones(4)}})
    with pytest.raises(KeyError):
        from_flax(P(), {**good, 'extra': {'kernel': np.ones(2)}})
    with pytest.raises(ValueError):
        from_flax(P(), {'norm': {'scale': np.ones(5), 'bias': np.zeros(5)}})
