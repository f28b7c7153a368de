"""The port's training losses, diffusion targets, EMA and optimizer chain
against star_tpu's (test_torch_train.py holds the train step itself).

fp32 throughout; inputs are seeded numpy arrays handed to both sides, and
each test states its tolerance relative to the reference's magnitude.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from star_tpu_torch.diffusion import (DiffusionTables, default_star_schedule,
                                      get_velocity, get_x0)
from star_tpu_torch.models.unet.unet import ControlledV2VUNet
from star_tpu_torch.train import (TrainConfig, cast_frozen, fourier_split,
                                  make_optimizer, make_train_state,
                                  make_train_step, star_sr_loss,
                                  trainable_mask, update_ema)
from test_torch_harness import assert_close, randn, rng, t


def test_fourier_split_and_star_sr_loss_match_jax():
    """fp32, 1e-4 of the reference magnitude (FFT rounding): the split of
    a [4, 48, 64, 3] batch (19008 magnitudes, cutoff from the strided 10k
    subsample) and of a [2, 16, 16, 3] one (exact quantile), and the full
    loss with the frequency term at t = 0 and 600."""
    from star_tpu.train import losses as jl
    r = rng(11)
    for shape in ((4, 48, 64, 3), (2, 16, 16, 3)):
        x = randn(r, *shape)
        for ours, ref in zip(fourier_split(t(x)),
                             jl.fourier_split(jnp.asarray(x))):
            assert_close(ours, ref)
    v, vt = randn(r, 1, 2, 6, 8, 4), randn(r, 1, 2, 6, 8, 4)
    pix, gt = randn(r, 1, 2, 32, 48, 3), randn(r, 1, 2, 32, 48, 3)
    for step in (0, 600):
        tt = np.array([step], np.int32)
        loss, m = star_sr_loss(t(v), t(vt), t(tt), t(pix), t(gt))
        jloss, jm = jl.star_sr_loss(*map(jnp.asarray, (v, vt, tt, pix, gt)))
        assert_close(loss, jloss)
        assert set(m) == set(jm)
        for k in m:
            assert_close(m[k], jm[k])


def test_diffusion_targets_and_ema_match_jax():
    """get_velocity / get_x0 on the default schedule and update_ema, fp32,
    1e-5 of the reference magnitude."""
    from star_tpu import diffusion as jd
    from star_tpu.train.ema import update_ema as jupdate
    r = rng(12)
    x0, xt, v = (randn(r, 3, 2, 4, 4, 4) for _ in range(3))
    tt = np.array([0, 417, 999], np.int32)
    ours = DiffusionTables.from_schedule(default_star_schedule())
    ref = jd.DiffusionTables.from_schedule(jd.default_star_schedule())
    assert_close(get_velocity(ours, t(x0), t(xt), t(tt)),
                 jd.get_velocity(ref, *map(jnp.asarray, (x0, xt, tt))), 1e-5)
    assert_close(get_x0(ours, t(v), t(xt), t(tt)),
                 jd.get_x0(ref, *map(jnp.asarray, (v, xt, tt))), 1e-5)
    e, p = {'a': randn(r, 5, 3)}, {'a': randn(r, 5, 3)}
    assert_close(update_ema({'a': t(e['a'])}, {'a': t(p['a'])}, 0.9)['a'],
                 jupdate(e, p, 0.9)['a'], 1e-5)


def test_optimizer_matches_optax():
    """clip_by_global_norm + AdamW with warmup over 3 steps on a synthetic
    tree, the clip active at every step (norm ~10 > 1) and weight decay
    on: the masters within 1e-6 relative of optax's parameters."""
    cfg = TrainConfig(learning_rate=1e-2, weight_decay=0.1, warmup_steps=2)
    r = rng(14)
    params = {'a': randn(r, 7, 5), 'b': randn(r, 11)}
    jtx = optax.chain(
        optax.clip_by_global_norm(cfg.max_grad_norm),
        optax.adamw(optax.linear_schedule(0.0, cfg.learning_rate,
                                          cfg.warmup_steps),
                    b1=cfg.adam_beta1, b2=cfg.adam_beta2, eps=cfg.adam_eps,
                    weight_decay=cfg.weight_decay))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jparams)
    masters = {k: t(v) for k, v in params.items()}
    tx = make_optimizer(cfg, masters)
    for count in range(3):
        grads = {k: randn(r, *v.shape, scale=3.0) for k, v in params.items()}
        upd, jstate = jtx.update({k: jnp.asarray(g) for k, g in
                                  grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        norm = tx.update({k: t(g) for k, g in grads.items()}, count)
        assert float(norm) == pytest.approx(
            float(optax.global_norm(grads)), rel=1e-6)
        for k in params:
            assert_close(masters[k], jparams[k], 1e-6)


def _tiny_unet():
    return ControlledV2VUNet(dim=32, dim_mult=(1,), num_res_blocks=1,
                             attn_scales=(), head_dim=16,
                             num_heads_init_temporal=2, context_dim=32)


def test_cast_frozen_then_make_train_state_keeps_fp32_masters():
    """cast_frozen holds the frozen set in bf16; make_train_state then
    takes the fp32 masters from the unrounded trainable weights and puts
    the module's trainable compute copies in the frozen set's dtype, with
    grad only on them; preview_x0 denoises without grad."""
    model = _tiny_unet()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.01)
    mask = trainable_mask(model)
    full = {n: p.detach().clone() for n, p in model.named_parameters()
            if mask[n]}
    state, tx = make_train_state(TrainConfig(freq_loss=False),
                                 cast_frozen(model))
    for n, p in model.named_parameters():
        assert p.dtype == torch.bfloat16 and p.requires_grad == mask[n], n
    assert set(state.params) == set(full) == set(tx.names)
    for n, m in state.params.items():
        assert m.dtype == torch.float32 and torch.equal(m, full[n]), n
    step = make_train_step(TrainConfig(freq_loss=False), model,
                           DiffusionTables.from_schedule(
                               default_star_schedule()), tx)
    g = torch.Generator().manual_seed(0)
    batch = {'gt_latent': torch.randn(1, 2, 10, 8, 4, generator=g),
             'lq_latent': torch.randn(1, 2, 10, 8, 4, generator=g),
             'y': torch.randn(1, 7, 32, generator=g)}
    x0 = step.preview_x0(batch, torch.Generator().manual_seed(1))
    assert x0.shape == (1, 2, 10, 8, 4) and not x0.requires_grad
    assert bool(torch.isfinite(x0).all())


def test_dropout_is_not_ported():
    """deterministic=False while dropout > 0 raises, naming the roadmap."""
    m = _tiny_unet()
    x = torch.zeros(1, 2, 10, 8, 4)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        m(x, torch.zeros(1, dtype=torch.long), torch.zeros(1, 7, 32), x,
          deterministic=False)


def test_small_train_check_fails_without_the_stats_cotangent(monkeypatch):
    """chip_smoke.py holds the small-width train step's gradients on the
    card to its host run within GRAD_LEAF_TOL / GRAD_ALL_TOL. A K5
    backward that treats the threaded statistics as constants (drops their
    cotangent) fails that check on the host alone, fp32 against fp32,
    while the unchanged run is exact against itself."""
    import copy

    import chip_smoke
    from star_tpu_torch.models.unet import blocks
    model, batch, tt, noise = chip_smoke.small_train_case()
    _, ref = chip_smoke.small_train_grads(copy.deepcopy(model), batch, tt,
                                          noise)
    real = blocks.fused_gn_silu_tconv3

    def stats_as_constants(*a, stats=None, **k):
        if stats is not None:
            stats = tuple(s.detach() for s in stats)
        return real(*a, stats=stats, **k)
    monkeypatch.setattr(blocks, 'fused_gn_silu_tconv3', stats_as_constants)
    _, bad = chip_smoke.small_train_grads(copy.deepcopy(model), batch, tt,
                                          noise)
    assert chip_smoke.grad_errors(ref, ref)[:2] == (0.0, 0.0)
    leaf, every, _ = chip_smoke.grad_errors(ref, bad)
    assert leaf > chip_smoke.GRAD_LEAF_TOL, leaf
    assert every > chip_smoke.GRAD_ALL_TOL, every
