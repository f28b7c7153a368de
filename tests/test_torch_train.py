"""The port's trainer (star_tpu_torch/train) against star_tpu's.

  loss_and_grads' loss and grad_norm and every trainable leaf's gradient
  against star_tpu's own train step, with the t and noise that step draws
  from its key injected into the port; frozen leaves unchanged and
  trainable leaves moved by train_step; remat on = off.
  (test_torch_train_losses.py holds the losses, the diffusion targets, the
  EMA and the optimizer chain.)

The UNet+ControlNet keeps the widths of tests/test_train.py's TinyControlled
(dim 32, head dim 16, context 32, frames of 10x8) and every block type,
cut to one resolution level with one res block, transformers only where
every trunk always has them (the initial temporal one and the middle's
spatial and temporal ones, LIEM gates included) and one video of 2
frames: compiling star_tpu's train step dominates this file, about 15 s on
one CPU core at XLA -O0 for this cut, where the gradient of
TinyControlled's two levels of two blocks took 103 s. The weights are
random (test_torch_harness.random_params), rounded to bf16-representable
values, and carried to the port with convert/from_flax.py; the JAX
reference is compiled once per module. fp32 on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from star_tpu_torch.convert import from_flax
from star_tpu_torch.diffusion import DiffusionTables, default_star_schedule
from star_tpu_torch.models.unet.unet import ControlledV2VUNet
from star_tpu_torch.train import (TrainConfig, make_train_state,
                                  make_train_step, trainable_mask)
from test_torch_harness import port, random_params, randn, rel_err, rng, t

KW = dict(dim=32, dim_mult=(1,), num_res_blocks=1, attn_scales=(),
          head_dim=16, num_heads_init_temporal=2, context_dim=32)
B, F, H, W = 1, 2, 10, 8


@pytest.fixture(scope='module')
def reference():
    """star_tpu's train step on random bf16-representable weights with a
    transformation that records the gradients in its state (updates 0):
    its metrics, its gradient tree, and the t and noise it drew."""
    from star_tpu.diffusion import DiffusionTables as JTables
    from star_tpu.models.unet.unet import ControlledV2VUNet as JUNet
    from star_tpu.train import TrainConfig as JConfig
    from star_tpu.train import TrainState as JState
    from star_tpu.train import make_train_step as jmake_step
    jm = JUNet(**KW)
    z = jnp.zeros((B, F, H, W, 4))
    params = random_params(jm, z, jnp.zeros((B,), jnp.int32),
                           jnp.zeros((B, 7, 32)), z, seed=2)
    params = jax.tree.map(
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32),
        params)
    r = rng(13)
    batch = {'gt_latent': randn(r, B, F, H, W, 4),
             'lq_latent': randn(r, B, F, H, W, 4),
             'y': randn(r, B, 7, 32)}
    key = jax.random.PRNGKey(4)
    kt, kn = jax.random.split(key)            # as star_tpu's train_step
    draws = dict(t=np.asarray(jax.random.randint(kt, (B,), 0, 1000)),
                 noise=np.asarray(jax.random.normal(kn, (B, F, H, W, 4))))
    record = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    step = jmake_step(JConfig(freq_loss=False),
                      lambda p, x, tt, y, hint: jm.apply(p, x, tt, y, hint),
                      JTables.from_schedule(default_star_schedule()), record)
    state = JState(jnp.zeros((), jnp.int32), params, record.init(params))
    run = jax.jit(step).lower(state, batch, key).compile(
        compiler_options={'xla_backend_optimization_level': 0})
    new_state, metrics = run(state, batch, key)
    return dict(params=params, batch=batch, draws=draws,
                metrics={k: float(v) for k, v in metrics.items()},
                grads=jax.tree.map(np.asarray, new_state.opt_state))


def _port_step(ref, cfg=TrainConfig(freq_loss=False), remat=False):
    model = port(ControlledV2VUNet(remat=remat, **KW), ref['params'])
    state, tx = make_train_state(cfg, model)
    step = make_train_step(
        cfg, model, DiffusionTables.from_schedule(default_star_schedule()),
        tx)
    batch = {k: t(v) for k, v in ref['batch'].items()}
    return model, state, step, batch


def _loss_and_grads(ref, remat=False):
    model, _, step, batch = _port_step(ref, remat=remat)
    metrics = step.loss_and_grads(batch, t=t(ref['draws']['t']),
                                  noise=t(ref['draws']['noise']))
    return model, metrics


def test_loss_and_grads_scalars_match_jax(reference):
    """Loss and pre-clip grad_norm with star_tpu's draws injected, fp32:
    within 1e-5 and 1e-4 relative (summation order through the UNet)."""
    _, metrics = _loss_and_grads(reference)
    want = reference['metrics']
    for k in ('loss_v', 'total_loss', 'grad_norm'):
        assert float(metrics[k]) == pytest.approx(
            want[k], rel=1e-4 if k == 'grad_norm' else 1e-5), k


def test_per_leaf_gradients_match_jax(reference):
    """Every trainable leaf's gradient (ControlNet + LIEM), fp32: within
    1e-5 of the largest gradient of all leaves, and, for each leaf whose
    largest gradient is at least 1e-2 of that, within 1e-4 of the leaf's
    own largest (measured: 7.7e-7 and 7.6e-6). Smaller leaves are fp32
    cancellation noise on both sides (a conv bias feeding a GroupNorm has a
    zero gradient in exact arithmetic). Frozen leaves get no gradient."""
    model, _ = _loss_and_grads(reference)
    want = from_flax(ControlledV2VUNet(**KW), reference['grads'])
    mask = trainable_mask(model)
    assert 0 < sum(mask.values()) < len(mask)
    top = max(float(want[n].abs().max()) for n in mask if mask[n])
    held = 0
    for n, p in model.named_parameters():
        if not mask[n]:
            assert p.grad is None and float(want[n].abs().max()) == 0.0, n
            continue
        leaf_max = float(want[n].abs().max())
        assert float((p.grad - want[n]).abs().max()) <= 1e-5 * top, n
        if leaf_max >= 1e-2 * top:
            assert rel_err(p.grad, want[n]) <= 1e-4, n
            held += 1
    assert held > sum(mask.values()) // 2, held


def test_train_step_moves_trainable_and_keeps_frozen(reference):
    """One train_step: frozen parameters bit-identical, the masters and the
    module's trainable parameters moved and equal to each other."""
    model, state, step, batch = _port_step(reference)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    masters = {n: m.clone() for n, m in state.params.items()}
    state, metrics = step(state, batch, torch.Generator().manual_seed(0))
    assert state.step == 1 and np.isfinite(float(metrics['total_loss']))
    moved = 0
    for n, p in model.named_parameters():
        if n in state.params:
            assert torch.equal(p, state.params[n]), n
            moved += int(not torch.equal(state.params[n], masters[n]))
        else:
            assert torch.equal(p, before[n]), n
    assert moved > 0.9 * len(state.params), (moved, len(state.params))


def test_remat_gives_the_same_gradients(reference):
    """remat recomputes each block in the backward: the same gradients
    within 1e-6 of each leaf's largest, and the same loss."""
    plain, m0 = _loss_and_grads(reference)
    remat, m1 = _loss_and_grads(reference, remat=True)
    assert float(m0['total_loss']) == float(m1['total_loss'])
    for (n, p), (_, q) in zip(plain.named_parameters(),
                              remat.named_parameters()):
        if p.grad is not None:
            assert rel_err(q.grad, p.grad) <= 1e-6, n
