"""The frozen float32 reference against the program's CPU path at small
widths, on the same seeded weights: tower by tower, and the whole clip
to within the uint8 rounding."""

import numpy as np
import pytest
import torch

from benchmark.drivers import sr_clips
from benchmark.harness import inputs
from benchmark.harness.weights import to_float32
from benchmark.reference import i2vgen, prims, sr_pipeline
from benchmark.tests import tiny


@pytest.fixture(scope='module')
def built():
    cfg = tiny.tiny_i2vgen()
    pipe, sd = sr_clips.build(cfg, 11, torch.device('cpu'), torch.float32)
    return cfg, pipe, sd, to_float32(sd)


def rel(a, b):
    return float((a - b).abs().max().detach() / b.abs().max().detach())


def test_text_tower(built):
    cfg, pipe, _, sd32 = built
    tok = torch.as_tensor(inputs.WordHashTokenizer()(['a red boat']))
    got = pipe.models.text(tok)
    t = cfg['text']
    want = i2vgen.clip_text(prims.FP32, prims.Weights(sd32, 'text.'), tok,
                            t['heads'],
                            i2vgen.n_clip_blocks(t['layers'], True))
    assert rel(got, want) < 1e-5


def test_vae_encode_and_decode(built):
    cfg, pipe, _, sd32 = built
    g = torch.Generator().manual_seed(0)
    x = torch.rand(2, 32, 48, 3, generator=g) * 2 - 1
    v = cfg['vae']
    levels = len(v['block_out_channels'])
    got = pipe.models.vae.encode_moments(x[None])[0]
    want = i2vgen.vae_encode_moments(prims.FP32, prims.Weights(
        sd32, 'vae.encoder.'), x, levels, v['encoder_layers'])
    assert rel(got, want) < 1e-5
    z = torch.randn(1, 3, 4, 6, 4, generator=g)
    got = pipe.models.vae.decoder(z)
    want = i2vgen.vae_decode_window(prims.FP32, prims.Weights(
        sd32, 'vae.decoder.'), z, levels, v['decoder_layers'])
    assert rel(got, want) < 1e-5


def test_unet_controlnet_on_the_cfg_pair(built):
    cfg, pipe, _, sd32 = built
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, 8, 8, 12, 4, generator=g)
    hint = torch.randn(1, 8, 8, 12, 4, generator=g)
    y = torch.randn(2, 77, 64, generator=g)
    t = torch.tensor([650])
    got = pipe.models.unet(x, t, y, hint, cfg_pair=True)
    want = i2vgen.controlled_unet(prims.FP32, prims.Weights(sd32, 'unet.'),
                                  cfg['unet'], x, t, y, hint)
    assert got.shape == want.shape == (2, 8, 8, 12, 4)
    assert rel(got, want) < 1e-4


def test_whole_clip_within_rounding(built):
    cfg, pipe, _, sd32 = built
    f, h, w = 8, 16, 24
    frames = inputs.clip_frames(3, 0, f, h, w)
    cap = 'a dog running across the street'
    out = pipe.enhance_a_video_async(frames, cap, seed=9).numpy()
    tok = inputs.WordHashTokenizer()
    pl = cfg['pipeline']
    noise = sr_clips.draw_noise(torch.device('cpu'), 9, (1, f, 8, 12, 4),
                                sr_pipeline.sde_steps(15))
    ref = sr_pipeline.enhance(
        prims.FP32, sd32, cfg, torch.as_tensor(frames),
        torch.as_tensor(tok([cap + pl['positive_prompt']])),
        torch.as_tensor(tok([pl['negative_prompt']])), noise)
    gap = sr_clips.compare(out.astype(np.uint8), ref)
    assert gap['max_abs_gap'] <= 0.5 + 1e-2, gap


def test_sampler_ladder_is_the_fast_4_plus_11():
    sig = sr_pipeline.star_sigmas()
    ladder = sr_pipeline.sigma_ladder(sig, 15, 899)
    assert len(ladder) == 15 and ladder[-1] == 0.0
    assert np.all(np.diff(ladder) < 0)
    assert sr_pipeline.sde_steps(15) == 13


def test_fp8_control_rounds_to_e4m3():
    p = prims.Precision(fp8=True)
    x = torch.tensor([1.0, 1.0625, 448.0, -3.3])
    q = p.q(x)
    assert q[2] == 448.0 and q[0] == 1.0
    assert q[1] != 1.0625          # 3 mantissa bits: 1.0625 is not kept
    assert torch.equal(prims.FP32.q(x), x)


# ---------------------------------------------------------------- CogVideoX
from benchmark.drivers import lora_train  # noqa: E402
from benchmark.reference import cogvideox  # noqa: E402


@pytest.fixture(scope='module')
def cog_built():
    cfg = tiny.tiny_cog()
    models, sd = lora_train.build(cfg, 5, torch.device('cpu'),
                                  torch.float32)
    return cfg, models, to_float32(sd)


def test_t5_encoder(cog_built):
    cfg, models, sd32 = cog_built
    tok = torch.as_tensor(inputs.WordHashT5Tokenizer(16)(['a red boat']))
    t = cfg['text']
    want = cogvideox.t5_encode(prims.FP32, prims.Weights(sd32, 't5.'), tok,
                               t['num_heads'], t['num_layers'])
    assert rel(models.text(tok), want) < 1e-5


def test_causal_vae_encoder(cog_built):
    cfg, models, sd32 = cog_built
    x = torch.rand(1, 9, 64, 96, 3, generator=torch.Generator()
                   .manual_seed(2)) * 2 - 1
    v = cfg['vae']
    want = cogvideox.causal_vae_encode_moments(
        prims.FP32, prims.Weights(sd32, 'vae.encoder.'), x,
        len(v['ch_mult']), v['num_res_blocks'])
    assert want.shape == (1, 3, 8, 12, 32)
    assert rel(models.vae.encoder(x), want) < 1e-5


def test_dit_forward_and_gradients(cog_built):
    cfg, models, sd32 = cog_built
    g = torch.Generator().manual_seed(3)
    x = torch.randn(1, 3, 8, 12, 32, generator=g)
    y = torch.randn(1, 16, 64, generator=g)
    idx = torch.tensor([321])
    dit = models.dit
    name = 'layers.1.qkv.lora_a.weight'
    param = dict(dit.named_parameters())[name]
    param.requires_grad_(True)
    out = dit(x, idx, y)
    (gp,) = torch.autograd.grad(out.square().sum(), [param])
    live = dict(sd32)
    leaf = live['dit.' + name] = sd32['dit.' + name].clone().requires_grad_()
    want = cogvideox.dit_forward(prims.FP32, prims.Weights(live, 'dit.'),
                                 cfg['dit'], x, idx, y)
    (gr,) = torch.autograd.grad(want.square().sum(), [leaf])
    param.requires_grad_(False)
    assert rel(out, want) < 1e-5
    assert rel(gp, gr) < 1e-4


def test_block_attention_backward_is_exact():
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(1, 40, 128, generator=g, dtype=torch.float64)
               .requires_grad_() for _ in range(3))
    out = cogvideox.block_attention(prims.FP32, q, k, v, 2, 0.125,
                                    budget=2 * 40 * 7)
    plain = cogvideox._attend(prims.FP32, q, k, v, 2, 0.125, 0.0)
    do = torch.randn(out.shape, generator=g, dtype=torch.float64)
    ga = torch.autograd.grad(out, [q, k, v], do)
    gb = torch.autograd.grad(plain, [q, k, v], do)
    assert torch.allclose(out, plain, atol=1e-12)
    for a, b in zip(ga, gb):
        assert torch.allclose(a, b, atol=1e-10)


def test_three_training_steps_match_the_program(cog_built):
    cfg, _, _ = cog_built
    result, checks = __import__('benchmark.harness.cell', fromlist=['x']) \
        .run_cell(BENCH_JSON(), 'cog_lora_train_25f', 77, 1.0, False,
                  torch.device('cpu'), 0.0, config=cfg,
                  traffic=tiny.tiny_train_traffic())
    # the program's CPU path in float32 against the float32 reference
    for name, c in checks.items():
        assert c['value'] < 1e-5, (name, c)


def BENCH_JSON():
    from benchmark.harness import common
    import os
    return common.load_json(os.path.join(common.ROOT, 'BENCHMARK.json'))


def test_fp8_control_carries_the_gradient():
    """Under autograd the control's products give gradients near float32's
    (operands in e4m3, the output's gradient in e5m2), never nought."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(64, 96, generator=g)
    w = torch.randn(48, 96, generator=g) * 1e-3
    grads = []
    for p in (prims.FP32, prims.Precision(fp8=True)):
        xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
        (prims.linear(p, xs, ws) ** 2).sum().backward()
        grads.append((xs.grad, ws.grad))
    for ref, ctl in zip(*grads):
        rel = float((ctl - ref).norm() / ref.norm())
        assert 1e-3 < rel < 0.2, rel
