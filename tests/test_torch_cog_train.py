"""The port's CogVideoX trainer (star_tpu_torch/train/cog_trainer.py), K9's
autograd Function and the DiT's per-layer remat, against star_tpu.

  * K9's gradients (x, scale, bias) against jax.grad of
    qk_ln_rope_reference, which is what the JAX package differentiates off
    the TPU (it defines no backward of its own), fp32 and bf16 inputs;
  * the DiT's remat on against off: the same loss and gradients;
  * loss_and_grads against star_tpu's make_cog_train_step on the DiT of
    tests/test_train_cli.py (hidden 64, 2 layers, 4 heads, LoRA 4), with
    the JAX step's idx and noise (its key split) replayed in the port and
    its gradients recorded by an optax transformation: loss, grad_norm and
    every trainable leaf; with the frequency loss through a tiny causal
    VAE's single-window decode as well;
  * a train_step that moves every trainable leaf and keeps every frozen
    one, the EMA following decay * ema + (1 - decay) * masters.

fp32 on both sides, on random bf16-representable weights; the JAX step is
compiled once for each loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from star_tpu_torch.convert import from_flax
from star_tpu_torch.models.dit.dit import CogVideoDiT
from star_tpu_torch.ops.qk_ln_rope import qk_ln_rope
from star_tpu_torch.train.cog_trainer import (CogTrainConfig,
                                              cog_trainable_mask,
                                              make_cog_train_state,
                                              make_cog_train_step)
from star_tpu_torch.vae.causal_vae import CogVideoVAE
from test_torch_harness import port, random_params, randn, rel_err, rng, t

KW = dict(hidden_size=64, num_layers=2, num_heads=4, patch_size=2,
          latent_channels=4, text_hidden_size=32, text_length=8,
          time_embed_dim=16, lora_rank=4)
VAE_KW = dict(ch=32, ch_mult=(1, 2, 2), num_res_blocks=1, z_channels=4)
B, T, H, W = 2, 3, 8, 8      # 56 tokens, carried as 64


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ K9


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_k9_gradients_match_jax_grad_of_the_reference(dtype):
    """The vjp of K9 for a random cotangent: x, scale and bias. fp32
    within 1e-5 of each gradient's largest; bf16 inputs (x and the
    cotangent bf16, so dx is rounded to bf16 once on both sides) within
    one bf16 step (2^-7) of dx's largest and 1e-3 of the fp32 scale/bias
    gradients' (summed over rows in another order)."""
    from star_tpu.ops.qk_ln_rope import qk_ln_rope_reference
    b, s, heads, d = 2, 24, 3, 64
    r = rng(7)
    x = randn(r, b, s, heads * d) * 2 + 0.5
    scale, bias = 1.0 + randn(r, d, scale=0.1), randn(r, d, scale=0.1)
    ang = r.uniform(0, 3, (s, d)).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    ct = randn(r, b, s, heads * d)
    fold = 0.18
    jdt = jnp.bfloat16 if dtype == 'bfloat16' else jnp.float32
    tdt = torch.bfloat16 if dtype == 'bfloat16' else torch.float32
    tiled = [jnp.asarray(np.tile(a, (1, heads))) for a in (cos, sin)]
    _, vjp = jax.vjp(lambda xx, sc, bi: qk_ln_rope_reference(
        xx, sc, bi, *tiled, heads, fold_scale=fold),
        jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias))
    want = vjp(jnp.asarray(ct, jdt))

    xt = t(x).to(tdt).requires_grad_()
    sc, bi = t(scale).requires_grad_(), t(bias).requires_grad_()
    out = qk_ln_rope(xt, sc, bi, t(cos), t(sin), heads, fold_scale=fold)
    assert out.dtype == tdt
    got = torch.autograd.grad(out, (xt, sc, bi), t(ct).to(tdt))
    assert got[0].dtype == tdt
    tols = (2.0 ** -7, 1e-3, 1e-3) if dtype == 'bfloat16' else (1e-5,) * 3
    for g, w, tol in zip(got, want, tols):
        assert rel_err(g, np.asarray(w, np.float32)) <= tol


# ------------------------------------------------------------ the DiT step


def _batch(r, freq: bool):
    batch = {'gt_latent': randn(r, B, T, H, W, 4),
             'lq_latent': randn(r, B, T, H, W, 4),
             'y': randn(r, B, 8, 32)}
    if freq:
        batch['gt_pixels'] = np.clip(randn(r, B, 9, 4 * H, 4 * W, 3), -1, 1)
    return batch


@pytest.fixture(scope='module')
def models():
    """Random bf16-representable weights of the JAX DiT (scanned layers,
    as the JAX training path runs it) and of a tiny causal VAE."""
    from star_tpu.models.dit.dit import CogVideoDiT as JDiT
    from star_tpu.vae import causal_vae as jcv

    class TinyVAE(jcv.CogVideoVAE):
        def setup(self):
            self.encoder = jcv.CausalEncoder3D(**VAE_KW, name='encoder')
            self.decoder = jcv.CausalDecoder3D(**VAE_KW, name='decoder')

    jdit = JDiT(**KW, scan_layers=True)
    bf16 = lambda tree: jax.tree.map(
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32), tree)
    params = bf16(random_params(
        jdit, jnp.zeros((B, T, H, W, 8)), jnp.zeros((B,), jnp.int32),
        jnp.zeros((B, 8, 32)), seed=21))
    jvae = TinyVAE()
    vparams = random_params(jvae, jnp.zeros((1, 5, 16, 16, 3)), seed=22)
    return dict(jdit=jdit, params=params, jvae=jvae, vparams=vparams)


def _jax_step(m, freq: bool):
    """star_tpu's Cog train step with a transformation that records the
    gradients (updates 0): its metrics, gradients and draws."""
    from star_tpu.train import TrainState as JState
    from star_tpu.train.cog_trainer import CogTrainConfig as JConfig
    from star_tpu.train.cog_trainer import make_cog_train_step as jmake
    jdit, jvae, params = m['jdit'], m['jvae'], m['params']

    def decode(z):      # the JAX CLI's single-window decode, cache cleared
        out, _ = jvae.apply({'params': m['vparams']['params']}, z, True, True,
                            method=jvae.decode, mutable=['cache'])
        return out
    record = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    step = jmake(JConfig(freq_loss=freq),
                 lambda p, x, i, y: jdit.apply(p, x, i, y), record,
                 vae_decode=decode if freq else None)
    batch = _batch(rng(23), freq)
    key = jax.random.PRNGKey(4)
    k_idx, k_noise = jax.random.split(key)    # as star_tpu's train_step
    draws = dict(idx=np.asarray(jax.random.randint(k_idx, (B,), 0, 1000)),
                 noise=np.asarray(jax.random.normal(
                     k_noise, (B, T, H, W, 4), jnp.float32)))
    state = JState(jnp.zeros((), jnp.int32), params, record.init(params))
    # compiled at XLA's default level: at -O0 this step's gradients come
    # out NaN on the CPU (its loss does not), eager and -O2 agree
    new_state, metrics = jax.jit(step)(state, batch, key)
    return dict(batch=batch, draws=draws,
                metrics={k: float(v) for k, v in metrics.items()},
                grads=jax.tree.map(np.asarray, new_state.opt_state))


@pytest.fixture(scope='module')
def reference(models):
    return _jax_step(models, freq=False)


def _port(m, cfg=CogTrainConfig(freq_loss=False), remat=True, freq=False):
    model = port(CogVideoDiT(**KW, remat=remat), m['params'])
    state, tx = make_cog_train_state(cfg, model)
    decode = None
    if freq:
        vae = port(CogVideoVAE(**VAE_KW), m['vparams'])
        decode = lambda z: vae.decode_window(z, {}, True)[0]
    return model, state, make_cog_train_step(cfg, model, tx, decode)


def _grads(model):
    return {n: p.grad for n, p in model.named_parameters()
            if p.grad is not None}


def _check_against_jax(model, metrics, ref, keys):
    """Loss terms within 1e-5 and grad_norm within 1e-4 relative; every
    trainable leaf within 1e-5 of its own largest gradient (fp32,
    summation order through the DiT; measured at most 7.1e-7, the LIEM
    gates' leaves 4e-5 of the largest gradient of all included); frozen
    leaves get no gradient, and theirs in JAX is zero."""
    for k in keys:
        assert float(metrics[k]) == pytest.approx(
            ref['metrics'][k], rel=1e-4 if k == 'grad_norm' else 1e-5), k
    want = from_flax(CogVideoDiT(**KW), ref['grads'])
    mask = cog_trainable_mask(model)
    assert 0 < sum(mask.values()) < len(mask)
    for n, p in model.named_parameters():
        if not mask[n]:
            assert p.grad is None and float(want[n].abs().max()) == 0.0, n
        else:
            assert float(want[n].abs().max()) > 0, n
            assert rel_err(p.grad, want[n]) <= 1e-5, n


def test_loss_and_grads_match_jax(models, reference):
    model, _, step = _port(models)
    batch = {k: t(v) for k, v in reference['batch'].items()}
    metrics = step.loss_and_grads(batch, idx=t(reference['draws']['idx']),
                                  noise=t(reference['draws']['noise']))
    assert set(metrics) == set(reference['metrics'])
    _check_against_jax(model, metrics, reference,
                       ('loss_v', 'total_loss', 'grad_norm'))


def test_freq_loss_matches_jax(models):
    """The frequency loss: pred-x0 decoded by the causal VAE in one window
    with a cleared cache (no gradient through it, freq_grad False), its
    Fourier terms weighted by the timestep, as star_tpu's step does."""
    ref = _jax_step(models, freq=True)
    model, _, step = _port(models, CogTrainConfig(), freq=True)
    batch = {k: t(v) for k, v in ref['batch'].items()}
    metrics = step.loss_and_grads(batch, idx=t(ref['draws']['idx']),
                                  noise=t(ref['draws']['noise']))
    assert set(metrics) == set(ref['metrics']) >= {'loss_low', 'loss_high'}
    assert metrics['total_loss'] > metrics['loss_v']
    _check_against_jax(model, metrics, ref,
                       ('loss_v', 'loss_low', 'loss_high', 'total_loss',
                        'grad_norm'))


def test_dit_remat_gives_the_same_gradients(models, reference):
    """Per-layer remat recomputes each layer in the backward: the same loss
    and gradients (within 1e-6 of each leaf's largest) as without; under
    no_grad the remat flag changes nothing."""
    batch = {k: t(v) for k, v in reference['batch'].items()}
    draws = {k: t(v) for k, v in reference['draws'].items()}
    out = []
    for remat in (False, True):
        model, _, step = _port(models, remat=remat)
        out.append((model, step.loss_and_grads(batch, **draws)))
    (plain, m0), (remat, m1) = out
    assert float(m0['total_loss']) == float(m1['total_loss'])
    g0, g1 = _grads(plain), _grads(remat)
    assert set(g0) == set(g1) and g0
    for n in g0:
        assert rel_err(g1[n], g0[n]) <= 1e-6, n
    x = torch.cat([draws['noise'], batch['lq_latent']], -1)
    with torch.no_grad():
        assert torch.equal(plain(x, draws['idx'], batch['y']),
                           remat(x, draws['idx'], batch['y']))


def test_train_step_moves_trainable_keeps_frozen_and_tracks_ema(models,
                                                                reference):
    """Two train_steps with an EMA: frozen parameters bit-identical; every
    master moved and equal to the module's parameter; the EMA after each
    step decay * ema + (1 - decay) * masters, from the initial masters."""
    cfg = CogTrainConfig(freq_loss=False, ema_decay=0.9)
    model, state, step = _port(models, cfg)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    ema = {n: m.clone() for n, m in state.params.items()}
    batch = {k: t(v) for k, v in reference['batch'].items()}
    g = torch.Generator().manual_seed(0)
    for i in range(2):
        state, metrics = step(state, batch, g)
        assert state.step == i + 1
        assert all(np.isfinite(float(v)) for v in metrics.values())
        ema = {n: e * 0.9 + state.params[n] * 0.1 for n, e in ema.items()}
        for n, e in ema.items():
            torch.testing.assert_close(state.ema_params[n], e, rtol=0,
                                       atol=1e-6)
    for n, p in model.named_parameters():
        if n in state.params:
            assert torch.equal(p, state.params[n]), n
            assert not torch.equal(p, before[n]), n
        else:
            assert torch.equal(p, before[n]), n
    for part in ('lora_a', 'lora_b', 'proj_sr', 'final_linear',
                 'final_adaln', 'spa_local', 'temp_local'):
        assert any(part in n for n in state.params), part


def test_optimizer_is_optax_adamw_default():
    """The JAX Cog step's optimizer is clip_by_global_norm +
    optax.adamw(lr) with optax's defaults: weight decay 1e-4, eps 1e-8,
    betas (0.9, 0.999), no warmup; three updates of the optimizer that
    make_cog_train_state builds equal optax's."""
    cfg = CogTrainConfig(learning_rate=1e-2, max_grad_norm=0.5)
    r = rng(3)
    p0 = randn(r, 6, 5) * 3
    grads = [randn(r, 6, 5) for _ in range(3)]
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adamw(1e-2))
    jp, js = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    model = torch.nn.Module()
    model.proj_sr = torch.nn.Linear(5, 6, bias=False)
    model.frozen = torch.nn.Linear(5, 6, bias=False)
    with torch.no_grad():
        model.proj_sr.weight.copy_(t(p0))
    state, opt = make_cog_train_state(cfg, model)
    assert list(state.params) == ['proj_sr.weight']
    for i, gr in enumerate(grads):
        upd, js = tx.update(jnp.asarray(gr), js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update({'proj_sr.weight': t(gr)}, i)
    np.testing.assert_allclose(state.params['proj_sr.weight'].numpy(),
                               np.asarray(jp), rtol=1e-5, atol=1e-6)


# ------------------------------------------- launches per step, on the CPU


def _count_launches(monkeypatch):
    """Count, on the CPU paths, the dispatches that launch a kernel on the
    card: K9's forward and backward and K10's (the plain versions their
    dispatch runs on the CPU in place of each launch: K10's is not
    recomputed there, autograd differentiates it), the training
    attention's forward (K2 `with_l`) and backward (K3) in its autograd
    Function, and any attention outside autograd (K1)."""
    import importlib
    qr = importlib.import_module('star_tpu_torch.ops.qk_ln_rope')
    fl = importlib.import_module('star_tpu_torch.ops.fused_ln')
    fa = importlib.import_module('star_tpu_torch.ops.flash_attention')
    counts = dict.fromkeys(('qk_ln_rope', 'qk_ln_rope_bwd', 'fused_ln',
                            'flash_packed_lse', 'flash_bwd', 'flash_packed'),
                           0)

    def counted(name, fn):
        def run(*a, **k):
            counts[name] += 1
            return fn(*a, **k)
        return run
    for mod, plain, name in ((qr, 'qk_ln_rope_plain', 'qk_ln_rope'),
                             (qr, 'qk_ln_rope_bwd_plain', 'qk_ln_rope_bwd'),
                             (fl, 'fused_ln_plain', 'fused_ln')):
        monkeypatch.setattr(mod, plain, counted(name, getattr(mod, plain)))
    fn = fa._FlashAttentionD64
    monkeypatch.setattr(fn, 'forward', staticmethod(
        counted('flash_packed_lse', fn.forward)))
    monkeypatch.setattr(fn, 'backward', staticmethod(
        counted('flash_bwd', fn.backward)))
    plain = fa.flash_attention_packed_plain

    def packed(*a, return_lse=False, **k):
        counts['flash_packed'] += not return_lse
        return plain(*a, return_lse=return_lse, **k)
    monkeypatch.setattr(fa, 'flash_attention_packed_plain', packed)
    qr.BACKWARDS = 0
    return counts, qr


@pytest.mark.parametrize('case', ['full_depth', 'small'])
def test_cog_train_step_launches_per_step(monkeypatch, case):
    """One loss_and_grads of the DiT under per-layer remat launches what
    chip_smoke.py asserts on the card: at full depth (42 layers, narrow,
    520 tokens so that attention takes the flash path) its
    COG_TRAIN_STEP_LAUNCHES and COG_TRAIN_K9_BACKWARDS; phase 2b's small
    LoRA DiT its SMALL_COG_TRAIN_LAUNCHES."""
    import chip_smoke
    counts, qr = _count_launches(monkeypatch)
    if case == 'full_depth':
        dit = CogVideoDiT(hidden_size=64, num_layers=42, num_heads=1,
                          patch_size=2, latent_channels=4,
                          text_hidden_size=32, text_length=8,
                          time_embed_dim=16, lora_rank=4)
        g = torch.Generator().manual_seed(0)
        shape = (1, 1, 32, 64, 4)               # 512 image tokens
        batch = {'gt_latent': torch.randn(shape, generator=g),
                 'lq_latent': torch.randn(shape, generator=g),
                 'y': torch.randn(1, 8, 32, generator=g)}
        idx, noise = torch.tensor([300]), torch.randn(shape, generator=g)
        want = dict(chip_smoke.COG_TRAIN_STEP_LAUNCHES)
        backwards = chip_smoke.COG_TRAIN_K9_BACKWARDS
    else:
        dit, batch, idx, noise = chip_smoke.small_cog_train_case()
        want = {**chip_smoke.SMALL_COG_TRAIN_LAUNCHES, 'flash_packed': 0}
        backwards = want['qk_ln_rope'] // 2
    cfg = CogTrainConfig(freq_loss=False)
    _, tx = make_cog_train_state(cfg, dit)
    make_cog_train_step(cfg, dit, tx).loss_and_grads(batch, idx=idx,
                                                     noise=noise)
    assert counts == want
    assert qr.BACKWARDS == backwards


def test_small_cog_train_tolerance_separates_a_wrong_k9_backward(
        monkeypatch):
    """chip_smoke.py holds phase 2b's small Cog train step on the card to
    COG_GRAD_LEAF_TOL and COG_GRAD_ALL_TOL of the host's fp32 gradients.
    On the host alone, a K9 backward that rotates the wrong way (its
    closed form, qk_ln_rope_bwd_plain, with sin negated) misses the
    per-leaf tolerance by more than 3x (measured 1.21, 10x), and the whole
    set's (whose largest gradients sit in the final layer, after every K9)
    by 0.8x: the per-leaf tolerance is the one that separates it."""
    import copy
    import importlib
    import chip_smoke
    qr = importlib.import_module('star_tpu_torch.ops.qk_ln_rope')
    dit, batch, idx, noise = chip_smoke.small_cog_train_case()
    _, ref = chip_smoke.small_cog_train_grads(copy.deepcopy(dit), batch, idx,
                                              noise)
    plain = qr.qk_ln_rope_bwd_plain

    def wrong_way(x, ct, scale, bias, cos, sin, *a, **k):
        return plain(x, ct, scale, bias, cos, -sin, *a, **k)
    monkeypatch.setattr(qr, 'qk_ln_rope_bwd_plain', wrong_way)
    _, bad = chip_smoke.small_cog_train_grads(dit, batch, idx, noise)
    leaf, every, _ = chip_smoke.grad_errors(ref, bad)
    assert leaf > 3 * chip_smoke.COG_GRAD_LEAF_TOL, leaf
    assert every > 0.5 * chip_smoke.COG_GRAD_ALL_TOL, every
