"""The comparisons that decide `correct` must fail what they guard
against. At a tiny size on the CPU: each cell's float8 control fails its
limits, and a run with the timed path broken underneath (the look for a
card skipped) comes out not correct, once for each fault the cell can
have. The SR cell: an answer altered where it is produced, a sampler step
that returns its state unchanged, half of the CFG batch left out. The
training cell: a step that returns its state, an update altered where it
is produced (one LoRA leaf's doubled). Both cells run on one card, so no
exchange between cards can be left out, and the training cell's batch is
one clip, which has no half to leave out."""

import os
import time

import torch

from benchmark import control
from benchmark.harness import cell, common
from benchmark.tests import tiny

BENCH = common.load_json(os.path.join(common.ROOT, 'BENCHMARK.json'))
CPU = torch.device('cpu')


def run_tiny(seed=4242):
    result, checks = cell.run_cell(
        BENCH, 'i2vgen_sr_8f', seed, 1.0, False, CPU, time.time(),
        config=tiny.tiny_i2vgen(), traffic=tiny.tiny_sr_traffic())
    return result['correct'], checks


def test_the_float8_control_fails_the_limits():
    limits = cell.limits_of('i2vgen_sr_8f')
    numbers, _ = control.sr_clips_readings(
        tiny.tiny_i2vgen(), tiny.tiny_sr_traffic(), 4242, CPU,
        clips_in_window=1)
    ok, checks = common.judge(numbers, limits)
    assert not ok, checks


def test_a_sound_tiny_run_is_correct():
    ok, checks = run_tiny()
    assert ok, checks


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    from star_tpu_torch.pipeline import video_sr
    real = video_sr.STARPipeline.decode

    def decode(self, *a, **k):
        out = real(self, *a, **k).clone()
        out[0] = 255 - out[0]
        return out

    monkeypatch.setattr(video_sr.STARPipeline, 'decode', decode)
    ok, checks = run_tiny()
    assert not ok, checks


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    from star_tpu_torch.pipeline import video_sr
    real = video_sr.sample_dpmpp_2m_sde

    def sampler(model_fn, x_init, *a, **k):
        calls = []

        def fn(x, t):
            calls.append(t)
            return x if len(calls) == 6 else model_fn(x, t)
        return real(fn, x_init, *a, **k)

    monkeypatch.setattr(video_sr, 'sample_dpmpp_2m_sde', sampler)
    ok, checks = run_tiny()
    assert not ok, checks


def test_half_the_cfg_batch_left_out(monkeypatch):
    from star_tpu_torch.models.unet import unet
    real = unet.ControlledV2VUNet.forward

    def forward(self, x, t, y, hint, cfg_pair=False, **k):
        if not cfg_pair:
            return real(self, x, t, y, hint, cfg_pair=False, **k)
        v = real(self, x, t, y[:y.shape[0] // 2], hint, cfg_pair=False, **k)
        return torch.cat([v, v])

    monkeypatch.setattr(unet.ControlledV2VUNet, 'forward', forward)
    ok, checks = run_tiny()
    assert not ok, checks


# ------------------------------------------------- the training cell

def run_tiny_train(seed=99):
    result, checks = cell.run_cell(
        BENCH, 'cog_lora_train_25f', seed, 1.0, False, CPU, time.time(),
        config=tiny.tiny_cog(), traffic=tiny.tiny_train_traffic())
    return result['correct'], checks


def test_the_float8_control_fails_the_training_limits(monkeypatch):
    """The cell's limits are set for its size on the card, where rounding
    reads larger than at this tiny size. So each limit is placed here as
    far above the program's reading (in bf16, as on the card) as the
    cell's limit lies above the card's lower reading."""
    from benchmark.drivers import lora_train
    real = lora_train.build
    monkeypatch.setattr(lora_train, 'build',
                        lambda cfg, seed, device, dtype:
                        real(cfg, seed, device, torch.bfloat16))
    prog, _ = control.program_readings(tiny.tiny_cog(),
                                       tiny.tiny_train_traffic(), 99, CPU)
    monkeypatch.setattr(lora_train, 'build', real)
    held = common.load_json(os.path.join(
        common.BENCH_DIR, 'limits', 'cog_lora_train_25f.json'))
    limits = {n: lim * prog[n] / held['lower'][n]
              for n, lim in held['limits'].items()}
    assert common.judge(prog, limits)[0]
    numbers, _ = control.lora_train_readings(
        tiny.tiny_cog(), tiny.tiny_train_traffic(), 99, CPU)
    ok, checks = common.judge(numbers, limits)
    assert not ok, checks


def test_a_train_step_that_returns_its_state(monkeypatch):
    from star_tpu_torch.train import cog_trainer

    def unchanged(cfg, state, tx, live, metrics):
        for p in live.values():
            p.grad = None
        metrics['grad_norm'] = torch.zeros(())
        return state._replace(step=state.step + 1), metrics

    monkeypatch.setattr(cog_trainer, 'apply_update', unchanged)
    ok, checks = run_tiny_train()
    assert not ok, checks


def test_an_update_altered_where_it_is_produced(monkeypatch):
    from star_tpu_torch.train import cog_trainer
    real = cog_trainer.apply_update

    def doubled(cfg, state, tx, live, metrics):
        name = next(n for n in tx.names if 'lora_' in n)
        before = state.params[name].clone()
        out = real(cfg, state, tx, live, metrics)
        with torch.no_grad():
            state.params[name].add_(state.params[name] - before)
            live[name].copy_(state.params[name])
        return out

    monkeypatch.setattr(cog_trainer, 'apply_update', doubled)
    ok, checks = run_tiny_train()
    assert not ok, checks
