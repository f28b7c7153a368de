"""The port's spans (star_tpu_torch/utils/profiling.py and where they
open), on the CPU at tiny widths:

  * with no profiler running, neither a served clip (run_jobs) nor two
    steps of the Cog train loop enter a RecordFunction of the port's
    (torch's own optimizer range aside): entering one costs microseconds;
  * under torch.profiler the clip records its job-loop spans, the five
    `sr.*` stages and one `unet.call` per model call, each inside a
    `sampler.step` inside `sr.denoise`; the train loop records
    `train.batch` around the three `batch.*` spans, `train.step` and
    `train.row` once a step;
  * `gc_spans` turns a collection into one `gc` range under a profiler and
    into nothing without one;
  * each kernel launcher opens its `kernel.K*` range, the extension's
    entry points replaced by a stub (no kernel runs on the CPU);
  * K9's backward range keeps the name the benchmark reads;
  * `--trace_dir` writes a Chrome trace holding the spans.
"""

import gc
import json

import numpy as np
import pytest
import torch

from star_tpu_torch import ops
from star_tpu_torch.cli import inference_sr, train_cog
from star_tpu_torch.cli.inference_sr import run_jobs
from star_tpu_torch.cli.train_sr import train_loop
from star_tpu_torch.config import SamplerConfig
from star_tpu_torch.models.t5.tokenizer import default_t5_tokenizer
from star_tpu_torch.ops import _build
from star_tpu_torch.ops import conv3x3 as c3
from star_tpu_torch.ops import flash_attention as fa
from star_tpu_torch.ops import fused_ln as fl
from star_tpu_torch.ops import fused_temporal_conv as ftc
from star_tpu_torch.ops import geglu as gg
from star_tpu_torch.ops import norms as nm
from star_tpu_torch.ops import qk_ln_rope as qk
from star_tpu_torch.ops import temporal_attention as ta
from star_tpu_torch.ops import upsample_conv as uc
from star_tpu_torch.pipeline import build_pipeline
from star_tpu_torch.pipeline.build import CogModels, _init_random
from star_tpu_torch.train.cog_trainer import CogTrainConfig
from star_tpu_torch.utils import profiling
from test_torch_cli import (CLI_FLAGS, FRAMES, TINY_CFG,  # noqa: F401
                            clip_frames, tiny_star, tiny_star_models,
                            write_mp4)
from test_torch_train_cli import cog_main, cog_triplets
from torch_parallel_worker import cog_towers

CPU = torch.device('cpu')
SR_STAGES = ('sr.text', 'sr.vae_encode', 'sr.denoise', 'sr.vae_decode',
             'sr.color_fix')


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_record_functions(monkeypatch):
    """Entering a RecordFunction raises, except torch's own optimizer
    ranges, which torch.optim opens on every step and zero_grad."""
    real = torch.ops.profiler._record_function_enter_new

    def enter(name, args=None):
        if not name.startswith('Optimizer.'):
            raise AssertionError(f'RecordFunction {name!r} entered with no '
                                 'profiler running')
        return real(name, args)
    monkeypatch.setattr(torch.ops.profiler, '_record_function_enter_new',
                        enter)


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _spans(prof, prefix=''):
    """(name, start, end, thread) of the recorded events named `prefix*`."""
    return [(e.name, e.time_range.start, e.time_range.end, e.thread)
            for e in prof.events() if e.name.startswith(prefix)]


def _inside(inner, outers):
    return [o for o in outers if o[3] == inner[3] and o[1] <= inner[1]
            and inner[2] <= o[2]]


# ---------------------------------------------------------------- a clip

def _tiny_pipe():
    return build_pipeline(tiny_star_models(), TINY_CFG(
        sampler=SamplerConfig(steps=2, solver_mode='normal')),
        allow_hash_tokenizer=True, device='cpu')


def _serve(pipe, n=2):
    saved = {}
    jobs = [(k, f'clip {k}', f'c{k}') for k in range(n)]
    load = lambda k: (clip_frames(k, *FRAMES), 8.0)

    def save(frames, name, fps):
        saved[name] = frames
        return name
    run_jobs(pipe, jobs, load, save, seed=3)
    return saved


def _count_model_calls(pipe):
    calls = []
    real = pipe.models.unet.forward

    def forward(*a, **k):
        calls.append(1)
        return real(*a, **k)
    pipe.models.unet.forward = forward
    return calls


def test_a_served_clip_enters_no_record_function_unprofiled(
        no_record_functions):
    saved = _serve(_tiny_pipe())
    assert sorted(saved) == ['c0', 'c1']


def test_a_served_clip_records_its_spans_nested():
    pipe = _tiny_pipe()
    calls = _count_model_calls(pipe)
    with _profile() as prof:
        _serve(pipe)
    by = {}
    for s in _spans(prof):
        by.setdefault(s[0], []).append(s)
    for stage in SR_STAGES:
        assert len(by[stage]) == 2, stage
    # the loop asks for three items (two clips, then the end); the CPU
    # output needs no event, so nothing waits on one
    assert len(by['jobs.wait_input']) == 3
    assert len(by['jobs.to_host']) == len(by['jobs.save']) == 2
    assert 'jobs.wait_output' not in by
    assert len(calls) > 0 and len(by['unet.call']) == len(calls)
    assert len(by['sampler.step']) == len(calls)
    for call in by['unet.call']:
        (step,) = _inside(call, by['sampler.step'])
        assert len(_inside(step, by['sr.denoise'])) == 1


# ----------------------------------------------------------- train steps

def _tiny_trainer():
    gen = torch.Generator().manual_seed(5)
    build = cog_towers(4)
    models = CogModels(*_init_random(
        [build[k] for k in ('dit', 'causal_vae', 't5')], 0, torch.float32,
        CPU))
    state, step_fn, make_batch = train_cog.make_cog_trainer(
        models, CogTrainConfig(), CPU, gen,
        default_t5_tokenizer(allow_fallback=True))
    r = np.random.RandomState(0)
    rows = [{'gt': r.uniform(-1, 1, (9, 32, 48, 3)).astype(np.float32),
             'lq': r.uniform(-1, 1, (9, 32, 48, 3)).astype(np.float32),
             'text': f'a clip {i}'} for i in range(2)]
    return state, step_fn, make_batch, rows, gen


def _train(steps=2, after_step=None):
    state, step_fn, make_batch, rows, gen = _tiny_trainer()
    written = []
    train_loop(step_fn, state, make_batch, lambda: iter(rows), start_step=0,
               max_train_steps=steps, global_batch=1, checkpoints=None,
               write_row=written.append, learning_rate=1e-4, generator=gen,
               after_step=after_step)
    return written


def test_train_steps_enter_no_record_function_unprofiled(
        no_record_functions):
    written = _train()
    assert [r['step'] for r in written] == [1, 2]


def test_train_steps_record_their_spans_once_a_step():
    with _profile() as prof:
        _train(after_step=lambda *a: None)
    by = {}
    for s in _spans(prof):
        by.setdefault(s[0], []).append(s)
    for name in ('train.batch', 'train.step', 'train.after_step',
                 'train.row', 'batch.to_device', 'batch.vae_encode',
                 'batch.t5', 'dit.call'):
        assert len(by[name]) == 2, name
    assert 'train.checkpoint' not in by        # no manager: none saved
    for name in ('batch.to_device', 'batch.vae_encode', 'batch.t5'):
        for span in by[name]:
            assert len(_inside(span, by['train.batch'])) == 1, name
    for call in by['dit.call']:
        assert len(_inside(call, by['train.step'])) == 1


# -------------------------------------------------- garbage collections

@pytest.fixture
def collector_off():
    """No automatic collection in the test, so that the one it asks for
    is the only one."""
    was = gc.isenabled()
    gc.disable()
    yield
    if was:
        gc.enable()


def test_a_collection_is_one_gc_range_under_a_profiler(collector_off):
    hooks = list(gc.callbacks)
    with _profile() as prof:
        with profiling.gc_spans():
            gc.collect()
    assert gc.callbacks == hooks
    events = [e for e in prof.events() if e.name == 'gc']
    assert len(events) == 1


def test_a_collection_records_nothing_unprofiled(collector_off,
                                                 no_record_functions):
    hooks = list(gc.callbacks)
    with profiling.gc_spans():
        assert len(gc.callbacks) == len(hooks) + 1
        gc.collect()
    assert gc.callbacks == hooks
    assert profiling.annotate('x') is profiling.annotate('y')


# ---------------------------------------------------------- the launchers

class _FakeCuda(torch.Tensor):
    @property
    def is_cuda(self):
        return True


def _fake(*shape, dtype=torch.bfloat16):
    return torch.Tensor._make_subclass(_FakeCuda,
                                       torch.zeros(*shape, dtype=dtype))


class _Library:
    """The kernel library with every entry point a stub that succeeds."""

    def __getattr__(self, name):
        return lambda *args: 0


def _z(*shape):
    return torch.zeros(*shape)


LAUNCHERS = {
    'kernel.K1': lambda: fa._launch(_fake(1, 128, 128), _fake(1, 128, 128),
                                    _fake(1, 128, 128), 2, 64, 0.5, 128),
    'kernel.K2_with_l': lambda: fa._launch(
        _fake(1, 128, 128), _fake(1, 128, 128), _fake(1, 128, 128), 2, 64,
        0.5, 128, want_lse=True),
    'kernel.K2': lambda: fa._launch(_fake(1, 64, 1, 512),
                                    _fake(1, 64, 1, 512),
                                    _fake(1, 64, 1, 512), 1, 512, 0.25, 64),
    'kernel.K3': lambda: fa._launch_bwd(
        *(_fake(1, 128, 128) for _ in range(4)),
        _fake(1, 2, 128, dtype=torch.float32), _fake(1, 128, 128), 2, 0.125,
        128),
    'kernel.K4': lambda: ta._launch(*(_fake(1, 8, 16, 128) for _ in
                                      range(3)), 2, 0.125),
    'kernel.K5': lambda: ftc._launch(_fake(2, 2, 64, 32), _z(2, 32),
                                     _z(2, 32), _z(3, 32, 32), _z(32), None,
                                     True, True),
    'kernel.K6': lambda: c3._launch(_fake(1, 20, 24, 128), _z(1, 128),
                                    _z(1, 128), _z(256, 128, 3, 3), _z(256),
                                    None, True),
    'kernel.K7': lambda: uc._launch_upsample(_fake(1, 16, 16, 64),
                                             _z(4, 2, 2, 64, 128), _z(128),
                                             True),
    'kernel.K8': lambda: uc._launch_interleave(
        *(_fake(1, 4, 4, 8) for _ in range(4)), True),
    'kernel.K9': lambda: qk._launch(_fake(1, 16, 128), _z(64), _z(64),
                                    _z(16, 64), _z(16, 64), 2, 1e-6, 1.0),
    'kernel.K10': lambda: fl._launch_ln(_fake(4, 320), _z(320), _z(320),
                                        1e-5, None),
    'kernel.K11': lambda: fl._launch_resid_ln(_fake(4, 320), _z(320),
                                              _z(320), _fake(4, 320), None,
                                              1e-5),
    'kernel.K12': lambda: gg._launch(_fake(2, 5, 2 * 1280)),
    'kernel.K13': lambda: nm._launch_stats(_fake(2, 5, 320),
                                           (_z(320), _z(320), 32, 1e-6)),
}


@pytest.mark.parametrize('span', sorted(LAUNCHERS))
def test_each_launcher_opens_its_kernel_range(monkeypatch, span):
    monkeypatch.setattr(_build, 'lib', lambda: _Library())
    monkeypatch.setattr(_build, 'stream_ptr', lambda device: 0)
    monkeypatch.setattr(_build, 'sm_count', lambda device: 132)
    before = sum(ops.launch_counts().values())
    with _profile() as prof:
        LAUNCHERS[span]()
    assert sum(ops.launch_counts().values()) == before + 1
    names = [e.name for e in prof.events() if e.name.startswith('kernel.')]
    assert names == [span]


def test_k9_backward_keeps_its_range_name():
    """benchmark/metrics/k9_bwd_roofline.train.py reads the device time
    inside `qk_ln_rope_backward`."""
    x = torch.randn(1, 16, 128, requires_grad=True)
    scale = torch.ones(64, requires_grad=True)
    bias = torch.zeros(64, requires_grad=True)
    cos, sin = torch.ones(16, 64), torch.zeros(16, 64)
    with _profile() as prof:
        qk.qk_ln_rope(x, scale, bias, cos, sin, 2).sum().backward()
    names = [e.name for e in prof.events()]
    assert names.count('qk_ln_rope_backward') == 1


def test_k9_backward_kernel_launches_directly_in_its_range(monkeypatch):
    """On a CUDA tensor (the library stubbed) the backward kernel's entry
    point is called directly inside the one `qk_ln_rope_backward` range
    and opens no `kernel.*` range: kineto projects a range onto the
    kernels launched directly in it, which is what
    k9_bwd_roofline.train reads."""
    class Library(_Library):
        def star_qk_ln_rope_bwd(self, *args):
            with torch.profiler.record_function('entry'):
                return 0
    monkeypatch.setattr(_build, 'lib', Library)
    monkeypatch.setattr(_build, 'stream_ptr', lambda device: 0)
    x = _fake(1, 16, 128).requires_grad_()
    before = ops.launch_counts()['qk_ln_rope_bwd']
    with _profile() as prof:
        out = qk.qk_ln_rope(x, _z(64), _z(64), _z(16, 64), _z(16, 64), 2)
        torch.autograd.grad(out, x, torch.ones_like(out))
    assert ops.launch_counts()['qk_ln_rope_bwd'] == before + 1
    events = list(prof.events())
    entry, = [e for e in events if e.name == 'entry']
    assert entry.cpu_parent.name == 'qk_ln_rope_backward'
    assert [e.name for e in events if e.name == 'qk_ln_rope_backward'] \
        == ['qk_ln_rope_backward']
    assert [e.name for e in events if e.name.startswith('kernel.')] \
        == ['kernel.K9']


# --------------------------------------------------------- --trace_dir

def test_inference_sr_trace_dir_writes_the_spans(tiny_star, tmp_path):
    src = write_mp4(tmp_path / 'in.mp4', clip_frames(3, *FRAMES))
    inference_sr.main(['--input_path', src, '--save_dir',
                       str(tmp_path / 'out'), '--model_path',
                       str(tmp_path / 'none'), '--allow_random_weights',
                       '--trace_dir', str(tmp_path / 'tr')] + CLI_FLAGS)
    trace = json.loads((tmp_path / 'tr' / 'trace.json').read_text())
    names = {e.get('name') for e in trace['traceEvents']}
    assert set(SR_STAGES) | {'jobs.wait_input', 'jobs.to_host',
                             'jobs.save', 'unet.call',
                             'sampler.step'} <= names


def test_train_cog_trace_dir_writes_the_spans(monkeypatch, tmp_path):
    monkeypatch.setattr(train_cog, 'towers', cog_towers)
    cog_main(cog_triplets(tmp_path), tmp_path / 'o',
             '--allow_random_weights', '--max_train_steps', '1',
             '--trace_dir', str(tmp_path / 'tr'))
    trace = json.loads((tmp_path / 'tr' / 'trace.json').read_text())
    names = {e.get('name') for e in trace['traceEvents']}
    assert {'train.batch', 'batch.to_device', 'batch.vae_encode',
            'batch.t5', 'train.step', 'dit.call', 'train.checkpoint',
            'train.row'} <= names
