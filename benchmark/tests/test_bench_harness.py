"""The harness on the CPU: a tiny configuration (defined here, not a
cell of BENCHMARK.json) through the traffic driver to one contract line,
the clip-start rule and the window arithmetic, the trace reduction, and a
measurement run that finds no card."""

import json
import os
import subprocess
import sys
import threading
import time

import pytest
import torch

from benchmark.drivers import sr_clips
from benchmark.harness import cell, common, trace
from benchmark.tests import tiny

BENCH = common.load_json(os.path.join(common.ROOT, 'BENCHMARK.json'))
CPU = torch.device('cpu')


def contract_line(capsys, traced):
    result, checks = cell.run_cell(
        BENCH, 'i2vgen_sr_8f', 2 ** 31 + 77, 1.0, traced, CPU, time.time(),
        config=tiny.tiny_i2vgen(), traffic=tiny.tiny_sr_traffic())
    common.emit(result, checks)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    return line, err


@pytest.mark.parametrize('traced', [False, True])
def test_sr_clips_prints_one_contract_line(capsys, traced):
    line, err = contract_line(capsys, traced)
    for key in ('correct', 'attempted', 'failed', 'metrics', 'device'):
        assert key in line
    assert list(line)[-1] == 'checks'
    assert line['attempted'] >= 1 and line['failed'] == 0
    assert line['correct'] is True, line['checks']
    names = set(line['metrics'])
    if traced:
        assert {'denoise_s.sr', 'vae_s.sr', 'loop_other_s.sr',
                'mfu.sr'} <= names
        assert 'breakdown' in line and 'window_s' in line['device']
        # no card: the device readers find nothing and stay silent
        assert 'k1_roofline.sr' not in names
    else:
        assert names == {'sr_frames_per_s', 'peak_mem_gb', 'setup_s'}
        m = line['metrics']['sr_frames_per_s']
        assert m['unit'] == 'frames/s' and m['value'] > 0
    tail = err.strip().splitlines()[-len(line['checks']):]
    assert all(t.startswith('check ') and ' limit ' in t for t in tail)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_clip_gate_admits_while_the_mean_clip_fits():
    clock = FakeClock()
    gate = sr_clips.ClipGate(seconds=45.0, prior_s=8.0, max_clips=64,
                             clock=clock)
    gate.start()
    jobs = gate.jobs()
    assert next(jobs) == 0                  # the first always starts
    assert next(jobs) == 1                  # 0 + 2 x 8 (warm clips) <= 45
    for k in range(2, 64):
        clock.t = 8.0 * k                   # clip k-1 ends, k-2 is saved
        gate.mark_saved()
        if clock.t + clock.t / k > 45.0:
            with pytest.raises(StopIteration):
                next(jobs)
            break
        assert next(jobs) == k
    # at 16, 24, 32 s clips 2..4 start (40 s + 8 s > 45 stops clip 5):
    # five clips of 8 s in a 45 s window
    assert k == 5 and clock.t == 40.0


def test_clip_gate_takes_one_long_clip():
    gate = sr_clips.ClipGate(seconds=45.0, prior_s=36.0, max_clips=64)
    gate.start()
    assert list(gate.jobs()) == [0]          # 0 + 2 x 36 > 45


def test_clip_gate_waits_for_the_save_two_clips_before():
    gate = sr_clips.ClipGate(seconds=100.0, prior_s=1.0, max_clips=4)
    gate.start()
    jobs = gate.jobs()
    assert [next(jobs), next(jobs)] == [0, 1]
    got = []
    t = threading.Thread(target=lambda: got.append(next(jobs)))
    t.start()
    t.join(0.2)
    assert t.is_alive() and not got         # clip 2 waits for save 0
    gate.mark_saved()
    t.join(5)
    assert not t.is_alive() and got == [2]


def test_window_arithmetic():
    clock = FakeClock()
    gate = sr_clips.ClipGate(10.0, 1.0, 8, clock=clock)
    clock.t = 100.0
    gate.start()
    for s in (102.5, 105.0, 107.5):
        clock.t = s
        gate.mark_saved()
    assert gate.window_s == 7.5             # first start to last save


def test_trace_reduction():
    tl = trace.Timeline(
        device=[('k_a', 0.0, 1.0), ('k_b', 0.5, 2.0), ('k_a', 3.0, 4.0),
                ('k_c', 9.0, 11.0)],
        host=[('window', 0.0, 10.0), ('clip', 0.0, 8.0),
              ('aten::copy_', 2.2, 2.9), ('save', 8.5, 9.5)],
        window=(0.0, 10.0))
    assert trace.busy_s(tl) == pytest.approx(4.0)    # [0,2] [3,4] [9,10]
    gaps = trace.idle_gaps(tl)
    assert gaps[0] == ['clip in window', pytest.approx(5.0)]   # [4, 9]
    assert gaps[1] == ['aten::copy_ in window', pytest.approx(1.0)]
    assert trace.kernel_seconds(tl, 'k_a') == (pytest.approx(2.0), 2)
    assert trace.top_ops(tl)[0][0] in ('k_a', 'k_b')


def test_a_run_without_a_card_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, os.path.join(common.ROOT, 'benchmark', 'run.py'),
         '--workload', 'i2vgen_sr_8f', '--seed', '5', '--seconds', '1',
         '--trace', '0'], capture_output=True, text=True, timeout=120,
        cwd=common.ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=''))
    assert out.returncode != 0
    assert '{' not in out.stdout
    assert 'CUDA card' in out.stderr


def test_every_metric_has_a_reader_and_every_cell_its_files():
    for m in BENCH['per_layer']:
        assert hasattr(common.metric_reader(m['name']), 'read')
    for w in BENCH['workloads']:
        _, c, tr = common.find_cell(BENCH, w['name'])
        assert os.path.exists(os.path.join(common.ROOT, c['file']))
        assert cell.limits_of(w['name'])
        assert 'setup_s' in cell.end_to_end_names(BENCH, w['name'])
        assert cell.per_layer_names(BENCH, w['name'])


def test_t5_query_is_drawn_at_t5s_scale():
    """T5 does not scale its logits: its query is drawn N(0, 1/(d_model
    d_kv)), every other product's weight N(0, 1/fan_in)."""
    from star_tpu_torch.models.t5.encoder import T5Encoder
    from benchmark.harness.weights import make_weights
    with torch.device('meta'):
        m = T5Encoder(vocab_size=64, d_model=256, d_ff=512, num_heads=4,
                      num_layers=2)
    sd = make_weights(m, 7, CPU, torch.float32)
    for i in range(2):
        q, k = sd[f'block_{i}.q.weight'], sd[f'block_{i}.k.weight']
        assert abs(float(q.std()) * (256 * 64) ** 0.5 - 1.0) < 0.02
        assert abs(float(k.std()) * 256 ** 0.5 - 1.0) < 0.02
