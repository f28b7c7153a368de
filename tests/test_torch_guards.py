"""Guards of the port's contract:

  * no module of star_tpu_torch/, and not chip_smoke.py, imports jax, flax,
    orbax, star_tpu or tools (AST scan), and the golden tests of the port's
    own conversion (tests/test_torch_convert.py, and the sample_sr golden)
    import nothing of star_tpu or jax either;
  * the entry points raise without a CUDA card unless given device="cpu":
    the random-weight models, the pipelines, load_star_models /
    load_cog_models, setup_seed and the main of inference_sr, sample_sr,
    sample_t2v and serve; warm_cache needs nvcc, not a card;
  * the kernel contract (star_tpu_torch/ops/_contract.py), over one table
    with a row per public op path (ROWS): a CUDA tensor reaches its
    launchers (here counting stand-ins) and never a plain version; a CPU
    tensor runs the plain version and never a launcher; under autograd the
    declared backward runs (a backward kernel, the plain version
    recomputed only inside the backward, or a refusal by the launcher),
    and only the inputs that need a gradient get one; the launch counts
    reset; and the launchers the benchmark's LaunchLog replaces on their
    modules are the ones the public ops call;
  * the collectives of parallel/ refuse a tensor their backend does not
    take (NCCL takes CUDA tensors, gloo CPU ones) and let a failed
    collective raise: no fallback to another backend or to the host;
  * tests that need the card run there and skip here.
"""

import ast
import collections
import importlib
import os

import numpy as np
import pytest
import torch

from star_tpu_torch import ops
from star_tpu_torch.ops import _build
from star_tpu_torch.ops import conv3x3 as c3
from star_tpu_torch.ops import flash_attention as fa
from star_tpu_torch.ops import fused_ln as fl
from star_tpu_torch.ops import fused_temporal_conv as ftc
from star_tpu_torch.ops import geglu as gg
from star_tpu_torch.ops import norms as nm
from star_tpu_torch.ops import qk_ln_rope as qr
from star_tpu_torch.ops import temporal_attention as ta
from star_tpu_torch.ops import upsample_conv as uc

ROOT = os.path.join(os.path.dirname(__file__), '..')
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'star_tpu', 'tools')


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_sources():
    pkg = os.path.join(ROOT, 'star_tpu_torch')
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, 'chip_smoke.py')


def test_port_imports_nothing_of_jax_or_star_tpu():
    offenders = []
    sources = list(_port_sources())
    parallel = {os.path.basename(p) for p in sources
                if os.sep + 'parallel' + os.sep in p}
    assert parallel >= {'__init__.py', 'mesh.py', 'sharding.py', 'zero.py',
                        'ulysses.py', 'context_parallel.py',
                        'distributed.py'}, parallel
    for path in sources:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or '']
            else:
                continue
            for n in names:
                if n.split('.')[0] in FORBIDDEN:
                    offenders.append(f'{os.path.relpath(path, ROOT)}: {n}')
    assert not offenders, offenders


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch, tmp_path):
    from star_tpu_torch.cli import (inference_sr, sample_sr, sample_t2v,
                                    serve, warm_cache)
    from star_tpu_torch.ops import _build
    from star_tpu_torch.config import PipelineConfig
    from star_tpu_torch.convert.load import load_cog_models, load_star_models
    from star_tpu_torch.pipeline import (ModelBundle, STARPipeline,
                                         init_random_models)
    from star_tpu_torch.utils.device import resolve_device
    from star_tpu_torch.utils.seed import setup_seed
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        resolve_device()
    with pytest.raises(RuntimeError, match='CUDA'):
        init_random_models()
    bundle = ModelBundle(None, None, None, None)
    with pytest.raises(RuntimeError, match='CUDA'):
        STARPipeline(bundle, PipelineConfig())
    assert STARPipeline(bundle, PipelineConfig(),
                        device='cpu').device.type == 'cpu'
    # the loaders and the CLIs refuse before they read a file or build a
    # model: the paths here do not exist
    for load in (load_star_models, load_cog_models):
        with pytest.raises(RuntimeError, match='CUDA'):
            load(str(tmp_path))
    with pytest.raises(RuntimeError, match='CUDA'):
        setup_seed(0)
    assert setup_seed(0, device='cpu').device.type == 'cpu'
    video = str(tmp_path / 'in.mp4')
    with pytest.raises(RuntimeError, match='CUDA'):
        inference_sr.main(['--input_path', video, '--allow_random_weights'])
    with pytest.raises(RuntimeError, match='CUDA'):
        sample_sr.main(['--input_path', video, '--allow_random_weights'])
    with pytest.raises(FileNotFoundError, match='in.mp4'):
        inference_sr.main(['--input_path', video, '--allow_random_weights',
                           '--device', 'cpu'])
    with pytest.raises(RuntimeError, match='CUDA'):
        sample_t2v.main(['--prompt', 'x', '--allow_random_weights'])
    queue = tmp_path / 'q'
    with pytest.raises(RuntimeError, match='CUDA'):
        serve.main(['--queue_dir', str(queue), '--allow_random_weights'])
    assert not queue.exists()          # refused before it made the queue
    # warm_cache needs nvcc, not a card: here, with neither and no built
    # library, it raises before it builds anything
    monkeypatch.setattr(_build, 'BUILD_DIR', str(tmp_path / 'kernels'))
    monkeypatch.setenv('PATH', str(tmp_path))
    monkeypatch.delenv('NVCC', raising=False)
    with pytest.raises(RuntimeError, match='nvcc not found.*CUDA'):
        warm_cache.main([])
    assert not (tmp_path / 'kernels').exists()


def test_clis_start_and_answer_help_without_jax():
    """convert.cli and the serving CLIs import and print their help in a
    process with no jax (tests/conftest.py imports it into this one)."""
    import subprocess
    import sys
    code = (
        'import runpy, sys\n'
        'for m in ("star_tpu_torch.convert.cli", '
        '"star_tpu_torch.cli.inference_sr", "star_tpu_torch.cli.sample_sr", '
        '"star_tpu_torch.cli.sample_t2v", "star_tpu_torch.cli.serve", '
        '"star_tpu_torch.cli.web", "star_tpu_torch.cli.warm_cache"):\n'
        '    sys.argv = [m, "--help"]\n'
        '    try:\n'
        '        runpy.run_module(m, run_name="__main__")\n'
        '    except SystemExit as e:\n'
        '        assert e.code == 0, (m, e.code)\n'
        'bad = sorted(k for k in sys.modules if k.split(".")[0] in '
        + repr(FORBIDDEN) + ')\n'
        'assert not bad, bad\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    for flag in ('--merge-lora', '--trust-pickle', '--prompt_file',
                 '--sampling_num_frames', '--device', '--num_frames',
                 '--queue_dir', '--warm', '--upload_dir', '--decode_window'):
        assert flag in out.stdout, flag


TRAINING_MODULES = (
    'star_tpu_torch.cli.make_paired_data', 'star_tpu_torch.cli.train_sr',
    'star_tpu_torch.cli.train_cog', 'star_tpu_torch.data.captions',
    'star_tpu_torch.data.dataset', 'star_tpu_torch.data.webds',
    'star_tpu_torch.data.degradation', 'star_tpu_torch.train.cog_trainer',
    'star_tpu_torch.train.checkpoint', 'star_tpu_torch.utils.metrics')


def test_training_entry_points_need_a_card_unless_told_cpu(monkeypatch,
                                                           tmp_path):
    """make_paired_data, train_sr and train_cog refuse without a card
    before they read a file or build a model; with --device cpu they go on
    (here to the missing CSV or data). So do the degradation's entry points
    on host frames, unless given device='cpu'."""
    from star_tpu_torch.cli import make_paired_data, train_cog, train_sr
    from star_tpu_torch.data.degradation import (degrade_video,
                                                 realesrgan_image_pair)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    frames = np.zeros((1, 16, 16, 3), np.float32)
    with pytest.raises(RuntimeError, match='CUDA'):
        degrade_video(frames, use_codec=False)
    with pytest.raises(RuntimeError, match='CUDA'):
        realesrgan_image_pair(frames[0], gt_size=8)
    assert degrade_video(frames, use_codec=False,
                         device='cpu')[0].device.type == 'cpu'
    csv = str(tmp_path / 'rows.csv')
    data = ['--data_root', str(tmp_path / 'none'), '--output_dir',
            str(tmp_path / 'out'), '--allow_random_weights']
    with pytest.raises(RuntimeError, match='CUDA'):
        make_paired_data.main(['--csv', csv, '--save_dir', str(tmp_path)])
    for cli in (train_sr, train_cog):
        with pytest.raises(RuntimeError, match='CUDA'):
            cli.main(data)
    assert not (tmp_path / 'out').exists()
    with pytest.raises(FileNotFoundError, match='rows.csv'):
        make_paired_data.main(['--csv', csv, '--save_dir', str(tmp_path),
                               '--device', 'cpu'])


def test_collectives_refuse_what_their_backend_does_not_take(monkeypatch):
    """In a one-process gloo world: a tensor on another device than the
    CPU (a meta tensor stands in for a CUDA one here) handed to a gloo
    group raises, as a CPU tensor handed to an NCCL group does; a
    collective on a group that is gone raises out of the port's code."""
    import socket

    import torch.distributed as dist
    from star_tpu_torch.parallel import mesh as pmesh
    from star_tpu_torch.parallel.context_parallel import ring_from_previous
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        port = sock.getsockname()[1]
    dist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{port}',
                            world_size=1, rank=0)
    try:
        g = dist.new_group([0])
        with pytest.raises(ValueError, match='meta tensor handed to a gloo'):
            pmesh.collective(torch.zeros(2, device='meta'), g)
        pmesh.collective(torch.zeros(2), g)
        monkeypatch.setattr(pmesh.dist, 'get_backend', lambda group: 'nccl')
        with pytest.raises(ValueError, match='cpu tensor handed to a nccl'):
            pmesh.collective(torch.zeros(2), g)
        monkeypatch.undo()
        dist.destroy_process_group(g)
        with pytest.raises(Exception):
            ring_from_previous(torch.zeros(2, 1), g)
    finally:
        dist.destroy_process_group()


def test_training_modules_import_no_codec_or_html_parser():
    """The training CLIs answer --help in a process with no jax, and the
    new training and data modules import nothing of jax, star_tpu, tools
    or orbax, nor cv2, bs4 or av, when imported (the card's machine has
    none of the last three; they are imported where a file is decoded or
    a caption cleaned)."""
    import subprocess
    import sys
    code = (
        'import importlib, runpy, sys\n'
        'for m in ' + repr(TRAINING_MODULES) + ':\n'
        '    importlib.import_module(m)\n'
        'for m in ' + repr(TRAINING_MODULES[:3]) + ':\n'
        '    sys.argv = [m, "--help"]\n'
        '    try:\n'
        '        runpy.run_module(m, run_name="__main__")\n'
        '    except SystemExit as e:\n'
        '        assert e.code == 0, (m, e.code)\n'
        'bad = sorted(k for k in sys.modules if k.split(".")[0] in '
        + repr(FORBIDDEN + ('cv2', 'bs4', 'av')) + ')\n'
        'assert not bad, bad\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    for flag in ('--csv', '--recipe', '--no_codec', '--image_data',
                 '--frozen_bf16', '--sample_every', '--lora_rank',
                 '--freq_loss', '--clean_captions', '--resume', '--device'):
        assert flag in out.stdout, flag


def _imports(nodes):
    """The top-level package of every import under the AST nodes."""
    for node in nodes:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Import):
                yield from (a.name.split('.')[0] for a in sub.names)
            elif isinstance(sub, ast.ImportFrom) and sub.level == 0:
                yield (sub.module or '').split('.')[0]


def test_golden_cases_of_the_port_import_nothing_of_star_tpu():
    """The goldens reach the port through its own convert/: the module
    tests/test_torch_convert.py imports nothing of star_tpu or jax at its
    top level, nor does any of its golden tests (star_tpu is imported
    only inside the tests that compare with it), and likewise the
    sample_sr golden of tests/test_torch_goldens.py."""
    cases = {'test_torch_convert.py': 'golden', 'test_torch_goldens.py':
             'test_sample_sr_golden'}
    found = 0
    for name, marker in cases.items():
        path = os.path.join(ROOT, 'tests', name)
        tree = ast.parse(open(path).read(), path)
        goldens = [n for n in tree.body if isinstance(n, ast.FunctionDef)
                   and n.name.startswith('test_') and marker in n.name]
        found += len(goldens)
        top = [n for n in tree.body
               if isinstance(n, (ast.Import, ast.ImportFrom))]
        helpers = [n for n in tree.body if isinstance(n, ast.FunctionDef)
                   and n.name.startswith('_')]
        nodes = goldens + helpers
        if name == 'test_torch_convert.py':    # and its top-level imports
            nodes += top
        bad = [p for p in _imports(nodes) if p in ('star_tpu', 'jax')]
        assert not bad, f'{name}: {bad}'
    assert found == 7, found


class FakeCuda(torch.Tensor):
    """A CPU tensor that answers is_cuda=True, to drive each wrapper's
    CUDA branch without a card."""

    @property
    def is_cuda(self):
        return True


def _fake(x, requires_grad=False):
    return torch.Tensor._make_subclass(FakeCuda, x, requires_grad)


def _refuse(*a, **k):
    raise AssertionError('a CUDA tensor reached a plain version')


# ------------------------------------------------------- the kernel contract
#
# One row per public op path: how to call it, what it launches on a CUDA
# tensor, and its declared backward (star_tpu_torch/ops/_contract.py):
# 'kernel' (a backward kernel in the op's own Function), 'recompute' (the
# shared Function: the plain version recomputed in the backward),
# 'refuse' (the launcher raises under grad) or 'plain' (channel_stats:
# the plain sums under grad, which K5's recompute differentiates).


class _Make:
    """The tensors of one call: `dev` ones CUDA-looking (FakeCuda) when
    `cuda`, the others plain CPU tensors; of the `grad` candidates, none,
    all, every other one from the first, or the first alone (`which`)
    require grad."""

    def __init__(self, cuda, which=None, dtype=torch.float32):
        self.cuda, self.which, self.dtype = cuda, which, dtype
        self.g = torch.Generator().manual_seed(0)
        self.n = 0

    def __call__(self, *shape, dev=False, grad=False, dtype=None):
        t = torch.randn(*shape, generator=self.g).to(dtype or self.dtype)
        need = grad and {'all': True, 'every_other': self.n % 2 == 0,
                         'first': self.n == 0}.get(self.which, False)
        self.n += bool(grad)
        return _fake(t, need) if dev and self.cuda else t.requires_grad_(need)


def _tconv_chain(t):
    x = t(1, 4, 8, 64, dev=True, grad=True)
    sc, bi = t(64, grad=True), t(64, grad=True)
    w, b = t(3, 1, 64, 64, grad=True), t(64, grad=True)
    y, st = ftc.fused_gn_silu_tconv3(x, sc, bi, w, b, want_stats=True)
    out, _ = ftc.fused_gn_silu_tconv3(y, sc, bi, w, b, stats=st, residual=y)
    return (out,), (x, sc, bi, w, b)


def _qkv(t, *shape):
    return tuple(t(*shape, dev=True, grad=True) for _ in range(3))


def _ln(t, gated, resid):
    y = t(2, 5, 128, dev=True, grad=True)
    r = t(2, 5, 128, dev=True, grad=True) if resid else None
    sc, bi = t(128, grad=True), t(128, grad=True)
    gw = t(2, grad=True) if gated else None
    inputs = tuple(a for a in (y, r, sc, bi, gw) if a is not None)
    if resid:
        return fl.fused_resid_ln(y, sc, bi, r, gw), inputs
    return (fl.fused_ln(y, sc, bi, gate_w=gw),), inputs


def _gn(t, silu):
    x = t(2, 3, 4, 64, dev=True, grad=True, dtype=torch.bfloat16)
    sc, bi = t(64, grad=True), t(64, grad=True)
    return (nm.group_norm(x, sc, bi, 32, 1e-6, silu),), (x, sc, bi)


def _qk(t):
    x, sc, bi = t(1, 5, 128, dev=True, grad=True), t(64, grad=True), \
        t(64, grad=True)
    out = qr.qk_ln_rope(x, sc, bi, t(5, 64), t(5, 64), 2, fold_scale=0.5)
    return (out,), (x, sc, bi)


def _packed(t):
    q, k, v = _qkv(t, 1, 8, 128)
    return (fa.flash_attention_packed(q, k, v, 2, kv_valid=6),), (q, k, v)


def _d64(t):
    q, k, v = _qkv(t, 1, 8, 2, 64)
    return (fa.flash_attention(q, k, v),), (q, k, v)


def _temporal(t):
    q, k, v = _qkv(t, 1, 4, 8, 64)
    return (ta.temporal_attention(q, k, v, 1),), (q, k, v)


def _geglu(t):
    p = t(3, 16, dev=True, grad=True)
    return (gg.geglu(p),), (p,)


def _d512(t):
    q = t(1, 8, 1, 512, dev=True, grad=True)
    return (fa.flash_attention(q, q, q),), (q,)


def _conv3x3(t):
    x = t(1, 5, 8, 128, dev=True, grad=True)
    return c3.fused_gn_silu_conv3x3(x, t(128), t(128), t(256, 128, 3, 3),
                                    t(256), want_stats=True), (x,)


def _upsample(t, c, cout):
    x = t(1, 3, 4, c, dev=True, grad=True)
    return (uc.upsample_conv2x(x, t(cout, c, 3, 3), t(cout)),), (x,)


def _interleave(t):
    p = t(1, 4, 8, 16, dev=True, grad=True)
    return uc.interleave2x2(p, p, p, p, want_stats=True), (p,)


def _channel_stats(t):
    x = t(2, 4, 6, 64, dev=True, grad=True)
    return nm.channel_stats(x), (x,)


Row = collections.namedtuple(
    'Row', 'call launches backward grad_launches op cpu_plain')
TCONV = ['gn_stats', 'fused_gn_silu_tconv3', 'fused_gn_silu_tconv3']
GN = ['gn_stats', 'group_norm']

ROWS = {
    'packed': Row(_packed, ['flash_packed'], 'kernel',
                  (['flash_packed_lse'], ['flash_bwd']), None,
                  (fa, 'flash_attention_packed_plain')),
    'd64': Row(_d64, ['flash_packed'], 'kernel',
               (['flash_packed_lse'], ['flash_bwd']), None,
               (fa, 'attention_plain')),
    'd512': Row(_d512, ['flash_d512'], 'refuse', None, None,
                (fa, 'attention_plain')),
    'temporal': Row(_temporal, ['temporal_attention'], 'recompute',
                    (['temporal_attention'], ['temporal_attention_plain']),
                    (ta, '_K4'), (ta, 'temporal_attention_plain')),
    # x's statistics (K13), then two stages, the second on the first's
    # threaded statistics; the backward recomputes each stage once
    'tconv': Row(_tconv_chain, TCONV, 'recompute',
                 (TCONV, ['_stage_plain', 'tconv3_plain'] * 2),
                 (ftc, '_K5'), (ftc, 'tconv3_plain')),
    # x's statistics (K13), then K6
    'conv3x3': Row(_conv3x3, ['gn_stats', 'conv3x3'], 'refuse', None, None,
                   (c3, 'conv3x3_plain')),
    'upsample_conv2x': Row(lambda t: _upsample(t, 64, 128),
                           ['upsample_conv2x'], 'refuse', None, None,
                           (uc, 'interleave2x2_plain')),
    # widths K7 does not take: the phase convs, then K8
    'upsample_phases': Row(lambda t: _upsample(t, 32, 32), ['interleave2x2'],
                           'refuse', None, None, (uc, 'interleave2x2_plain')),
    'interleave2x2': Row(_interleave, ['interleave2x2'], 'refuse', None,
                         None, (uc, 'interleave2x2_plain')),
    'qk_ln_rope': Row(_qk, ['qk_ln_rope'], 'kernel',
                      (['qk_ln_rope'], ['qk_ln_rope_bwd']), None,
                      (qr, 'qk_ln_rope_plain')),
    'fused_ln': Row(lambda t: _ln(t, False, False), ['fused_ln'],
                    'recompute', (['fused_ln'], ['fused_ln_plain']),
                    (fl, '_K10'), (fl, 'fused_ln_plain')),
    'fused_ln_gated': Row(lambda t: _ln(t, True, False), ['fused_ln'],
                          'recompute', (['fused_ln'], ['fused_ln_plain']),
                          (fl, '_K10'), (fl, 'fused_ln_plain')),
    'fused_resid_ln': Row(lambda t: _ln(t, False, True), ['fused_resid_ln'],
                          'recompute', (['fused_resid_ln'],
                                        ['fused_resid_ln_plain']),
                          (fl, '_K11'), (fl, 'fused_resid_ln_plain')),
    'fused_resid_ln_gated': Row(lambda t: _ln(t, True, True),
                                ['fused_resid_ln'], 'recompute',
                                (['fused_resid_ln'],
                                 ['fused_resid_ln_plain']),
                                (fl, '_K11'), (fl, 'fused_resid_ln_plain')),
    'geglu': Row(_geglu, ['geglu'], 'recompute', (['geglu'], ['geglu_plain']),
                 (gg, '_K12'), (gg, 'geglu_plain')),
    # K13: statistics with the fold, then the apply
    'group_norm': Row(lambda t: _gn(t, False), GN, 'recompute',
                      (GN, ['group_norm_plain']), (nm, '_K13'),
                      (nm, 'group_norm_plain')),
    'group_norm_silu': Row(lambda t: _gn(t, True), GN, 'recompute',
                           (GN, ['group_norm_plain']), (nm, '_K13'),
                           (nm, 'group_norm_plain')),
    # K13's statistics alone
    'channel_stats': Row(_channel_stats, ['gn_stats'], 'plain', ([], []),
                         None, None),
}
DIFFERENTIABLE = [k for k, r in ROWS.items() if r.backward != 'refuse']
RECOMPUTED = [k for k, r in ROWS.items() if r.backward == 'recompute']

# every plain version a kernel module dispatches to
PLAINS = ((fa, 'attention_plain'), (fa, 'flash_attention_packed_plain'),
          (fa, 'flash_bwd_plain'), (ta, 'temporal_attention_plain'),
          (ftc, 'tconv3_plain'), (ftc, '_stage_plain'),
          (c3, 'conv3x3_plain'), (uc, 'upsample_conv2x_plain'),
          (uc, 'interleave2x2_plain'), (qr, 'qk_ln_rope_plain'),
          (qr, 'qk_ln_rope_bwd_plain'), (fl, 'fused_ln_plain'),
          (fl, 'fused_resid_ln_plain'), (gg, 'geglu_plain'),
          (nm, 'group_norm_plain'))


def _host(t):
    return t.as_subclass(torch.Tensor) if isinstance(t, torch.Tensor) else t


def _card(out):
    if isinstance(out, tuple):
        return tuple(_card(o) for o in out)
    return _fake(out) if isinstance(out, torch.Tensor) else out


def _stand_ins(events):
    """Each launcher replaced by a stand-in that notes its counter's name
    and returns what the kernel would, computed by the real plain version
    on the host tensors (zeros for the flash kernels and K7), as CUDA-
    looking tensors."""
    def computed(name, fn):
        def launch(*a):
            events.append(name)
            return _card(fn(*map(_host, a)))
        return launch

    def flash(q, k, v, heads, d, c, kv_valid, want_lse=False):
        events.append('flash_d512' if d == 512 else 'flash_packed_lse'
                      if want_lse else 'flash_packed')
        out = _fake(torch.zeros(q.shape))
        return (out, torch.zeros(q.shape[0], heads, q.shape[1])) \
            if want_lse else out

    def flash_bwd(q, k, v, o, lse, do, heads, scale, kv_valid):
        events.append('flash_bwd')
        return tuple(torch.zeros(t.shape) for t in (q, k, v))

    def upsample(x, k_rs, bias, want_stats):
        events.append('upsample_conv2x')
        n, h, w, _ = x.shape
        return _fake(torch.zeros(n, 2 * h, 2 * w, k_rs.shape[-1]))

    def gn_stats(x3, fold=None):
        events.append('gn_stats')
        n, _, c = x3.shape
        if fold is None:
            return (torch.sum(_host(x3), 1, dtype=torch.float32),
                    torch.sum(_host(x3).float().square(), 1))
        return tuple(torch.ones(n, c, dtype=x3.dtype) for _ in range(3))

    def gn_apply(x3, mean, a, b, silu):
        events.append('group_norm')
        return _fake(_host(x3).clone())
    return {(fa, '_launch'): flash, (fa, '_launch_bwd'): flash_bwd,
            (ta, '_launch'): computed('temporal_attention',
                                      ta.temporal_attention_plain),
            (ftc, '_launch'): computed('fused_gn_silu_tconv3',
                                       ftc.tconv3_plain),
            (c3, '_launch'): computed('conv3x3', c3.conv3x3_plain),
            (uc, '_launch_upsample'): upsample,
            (uc, '_launch_interleave'): computed('interleave2x2',
                                                 uc.interleave2x2_plain),
            (qr, '_launch'): computed('qk_ln_rope', qr.qk_ln_rope_plain),
            (qr, '_launch_bwd'): computed('qk_ln_rope_bwd',
                                          qr.qk_ln_rope_bwd_plain),
            (fl, '_launch_ln'): computed('fused_ln', fl.fused_ln_plain),
            (fl, '_launch_resid_ln'): computed('fused_resid_ln',
                                               fl.fused_resid_ln_plain),
            (gg, '_launch'): computed('geglu', gg.geglu_plain),
            (nm, '_launch_stats'): gn_stats,
            (nm, '_launch_apply'): gn_apply}


def _stub(monkeypatch, events):
    for (mod, name), fn in _stand_ins(events).items():
        monkeypatch.setattr(mod, name, fn)


@pytest.mark.parametrize('name', list(ROWS))
def test_cuda_tensors_never_reach_plain_versions(monkeypatch, name):
    """A CUDA tensor reaches its launchers (here counting stand-ins) in
    the row's order and never a plain version."""
    launched = []
    _stub(monkeypatch, launched)
    for mod, plain in PLAINS:
        monkeypatch.setattr(mod, plain, _refuse)
    ROWS[name].call(_Make(cuda=True))
    assert launched == ROWS[name].launches


@pytest.mark.parametrize('name', list(ROWS))
def test_cpu_tensors_run_the_plain_version(monkeypatch, name):
    """A CPU tensor runs the row's plain version, and never a launcher or
    the kernel library; under grad too, where autograd differentiates the
    plain version directly (no recompute Function), or the op's own
    Function runs its backward kernel's plain version."""
    for (mod, fn) in _stand_ins([]):
        monkeypatch.setattr(mod, fn, _refuse)
    monkeypatch.setattr(_build, 'lib', _refuse)
    monkeypatch.setattr(_build, 'build', _refuse)
    row, ran = ROWS[name], []
    if row.cpu_plain is not None:
        mod, plain = row.cpu_plain
        real = getattr(mod, plain)
        monkeypatch.setattr(mod, plain, lambda *a, **k: (
            ran.append(plain), real(*a, **k))[1])
    outs, _ = row.call(_Make(cuda=False))
    if row.cpu_plain is None:       # channel_stats: the plain sums
        x = _Make(cuda=False)(2, 4, 6, 64).reshape(2, -1, 64)
        assert not ran and torch.equal(outs[1], torch.sum(x.square(), 1))
    else:
        assert ran and set(ran) == {row.cpu_plain[1]}
    if name not in DIFFERENTIABLE:
        return
    outs, inputs = row.call(_Make(cuda=False, which='all'))
    live = [o for o in outs if o is not None]
    assert all(type(o.grad_fn).__name__ != '_RecomputeBackward'
               for o in live)
    grads = torch.autograd.grad([o.float().sum() for o in live],
                                [i for i in inputs if i is not None])
    assert all(g is not None for g in grads)


@pytest.mark.parametrize('name', DIFFERENTIABLE)
def test_differentiable_kernels_launch_forward_and_backward(monkeypatch,
                                                            name):
    """A recorded call on CUDA tensors runs its declared backward: a
    backward kernel (K1/K2-d64: K2 `with_l` then K3; K9: its backward
    kernel) with no plain version anywhere; or the forward kernels, then
    the plain version only inside the backward, once for each recorded
    call, with the gradients of eager autograd through the plain version,
    bit for bit (K4, K5 through its threaded statistics, K10, K11, K12,
    K13); channel_stats takes the plain sums."""
    row = ROWS[name]
    events, phase = [], ['forward']
    _stub(monkeypatch, events)
    for mod, plain in PLAINS:
        real = getattr(mod, plain)

        def run(*a, _real=real, _name=plain, **k):
            assert row.backward == 'recompute', f'{_name} ran'
            assert phase[0] == 'backward', f'{_name} ran in the forward'
            events.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(mod, plain, run)
    outs, inputs = row.call(_Make(cuda=True, which='all'))
    live = [o for o in outs if o is not None]
    cts = [torch.randn(o.shape, generator=torch.Generator().manual_seed(i))
           for i, o in enumerate(live)]
    fwd = list(events)
    phase[0] = 'backward'
    grads = torch.autograd.grad(live, inputs, cts, allow_unused=True)
    bwd = events[len(fwd):]
    assert (fwd, bwd) == row.grad_launches
    assert all(g is None or g.shape == a.shape
               for g, a in zip(grads, inputs))
    if row.backward != 'recompute':
        return
    monkeypatch.undo()
    outs, inputs = row.call(_Make(cuda=False, which='all'))
    want = torch.autograd.grad([o for o in outs if o is not None], inputs,
                               cts, allow_unused=True)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize('name', RECOMPUTED + ['qk_ln_rope',
                                              'qk_ln_rope_frozen_norm'])
def test_only_the_inputs_that_need_a_gradient_get_one(monkeypatch, name):
    """Every other input requires grad, from the first: the recompute
    differentiates the plain version with respect to exactly the inputs
    whose needs_input_grad is set (what each tensor argument of the launch
    required, in each Function of the call, the last first), and K9's
    backward kernel computes the scale and bias gradients only when one of
    them requires grad: asked for them with bias requiring grad, and not
    with x alone (the frozen norm of a LoRA step), on the card's launcher
    and in the CPU's plain version alike; the gradients asked for come
    back."""
    k9 = name.startswith('qk_ln_rope')
    row, seen = ROWS['qk_ln_rope' if k9 else name], {'launch': [],
                                                     'plain': []}
    _stub(monkeypatch, [])
    if k9:
        for kind, fn in (('launch', '_launch_bwd'),
                         ('plain', 'qk_ln_rope_bwd_plain')):
            real = getattr(qr, fn)
            monkeypatch.setattr(qr, fn, lambda *a, _real=real, _kind=kind: (
                seen[_kind].append(a[-1]), _real(*a))[1])
    else:
        op = getattr(*row.op)
        for kind in ('launch', 'plain'):
            real = getattr(op.module, getattr(op, kind))

            def spy(*a, _real=real, _kind=kind):
                seen[_kind].append([t.requires_grad for t in a
                                    if isinstance(t, torch.Tensor)])
                return _real(*a)
            monkeypatch.setattr(op.module, getattr(op, kind), spy)
    which = 'first' if name == 'qk_ln_rope_frozen_norm' else 'every_other'
    for cuda in (True, False) if k9 else (True,):
        outs, inputs = row.call(_Make(cuda=cuda, which=which))
        need = [t for t in inputs if t.requires_grad]
        assert 0 < len(need) and (len(need) < len(inputs) or name == 'geglu')
        grads = torch.autograd.grad(
            [o.float().sum() for o in outs
             if o is not None and o.requires_grad], need)
        assert all(g.shape == t.shape for g, t in zip(grads, need))
    if k9:      # x needs a gradient; bias too, or neither scale nor bias
        want = name == 'qk_ln_rope'
        assert seen == {'launch': [want], 'plain': [want]}
    else:
        assert seen['launch'] and seen['plain'] == seen['launch'][::-1]


@pytest.mark.parametrize('name', [k for k, r in ROWS.items()
                                  if r.backward == 'refuse']
                         + ['qk_ln_rope_launcher'])
def test_kernels_without_backward_refuse_grad(monkeypatch, name):
    """K2 d=512, K6, K7 and K8 (and K9's forward launcher, which its
    Function wraps) on CUDA tensors that require grad, with grad mode on:
    the real launcher raises before building anything."""
    monkeypatch.setattr(_build, 'lib', _refuse)
    with pytest.raises(RuntimeError, match='no backward kernel'):
        if name == 'qk_ln_rope_launcher':
            x = _fake(torch.zeros(1, 5, 128, dtype=torch.bfloat16), True)
            qr._launch(*_k9_args(x), 1e-6, 1.0)
        else:
            ROWS[name].call(_Make(cuda=True, which='all',
                                  dtype=torch.bfloat16))


def test_launch_counts_reset():
    """One counter: every kernel of ops.KERNELS in launch_counts(), zeros
    included; reset_launch_counts() clears it and K9's backward count."""
    from star_tpu_torch.ops import _contract
    assert set(ops.launch_counts()) == set(ops.KERNELS) \
        == set(_contract.COUNTS)
    assert len(ops.KERNELS) == 16
    _contract.COUNTS['flash_packed'] += 3
    _contract.COUNTS['conv3x3'] += 5
    qr.BACKWARDS += 1
    counts = ops.launch_counts()
    assert counts['flash_packed'] >= 3 and counts['conv3x3'] >= 5
    counts['geglu'] = 7                 # a copy: the counter is not touched
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0} and qr.BACKWARDS == 0


@pytest.mark.parametrize('name', ['packed', 'd64', 'tconv', 'qk_ln_rope'])
def test_benchmark_seams_are_called_through_their_modules(monkeypatch, name):
    """benchmark/harness/work.LaunchLog replaces fa._launch, fa._launch_bwd,
    ftc._launch and qk._launch on their modules after import and calls
    the launchers it found there positionally: the public ops call its
    replacements, and it reads K9's backward calls from BACKWARDS."""
    from benchmark.harness.work import LaunchLog
    _stub(monkeypatch, [])
    log = LaunchLog()
    with log.recording():
        outs, inputs = ROWS[name].call(_Make(cuda=True, which='all'))
        torch.autograd.grad([o.float().sum() for o in outs], inputs,
                            allow_unused=True)
    want = {'packed': ([(1, 2, 8, 6, 64, True)], [(1, 2, 8, 6, 64)], [], [],
                       0),
            'd64': ([(1, 2, 8, 8, 64, True)], [(1, 2, 8, 8, 64)], [], [], 0),
            'tconv': ([], [], [(1, 4, 8, 64, 64, False, True, False),
                               (1, 4, 8, 64, 64, True, False, False)], [],
                      0),
            'qk_ln_rope': ([], [], [], [(5, 5, 128)], 1)}[name]
    assert (log.flash, log.flash_bwd, log.tconv3, log.qk,
            log.qk_backwards) == want


@pytest.mark.parametrize('device', ['cuda', 'cpu'])
def test_qk_ln_rope_backwards_counts_a_backward(monkeypatch, device):
    """K9's BACKWARDS counts each call of its autograd backward, on either
    device: the backward kernel's launch on the card, its plain version on
    the CPU."""
    _stub(monkeypatch, [])
    ops.reset_launch_counts()
    for _ in range(2):
        outs, inputs = _qk(_Make(cuda=device == 'cuda', which='all'))
        torch.autograd.grad(outs[0].sum(), inputs)
    assert qr.BACKWARDS == 2
    assert ops.launch_counts()['qk_ln_rope_bwd'] == 0   # the stand-ins


def test_launchers_refuse_what_the_kernels_do_not_take():
    """The real launchers check device, dtype and shape before building
    anything (on a CPU tensor they raise rather than fall back)."""
    fa = importlib.import_module('star_tpu_torch.ops.flash_attention')
    ta = importlib.import_module('star_tpu_torch.ops.temporal_attention')
    ftc = importlib.import_module('star_tpu_torch.ops.fused_temporal_conv')
    q = torch.randn(1, 8, 128)
    with pytest.raises(ValueError):
        fa._launch(q, q, q, 2, 64, 1.0, 8)          # not a CUDA tensor
    with pytest.raises(ValueError):
        fa._launch(q, q, q, 4, 32, 1.0, 8)          # head_dim 32
    x = torch.randn(1, 17, 8, 64)
    with pytest.raises(ValueError):
        ta._launch(x, x, x, 1, 0.125)               # F > 16
    with pytest.raises(ValueError):
        ftc._launch(torch.randn(1, 3, 8, 48), None, None,
                    torch.zeros(3, 48, 48), None, None, False, False)


def test_vae_resnet_block_reaches_the_conv3x3_launcher_twice(monkeypatch):
    """A 128-channel VAE ResnetBlock2D on a CUDA tensor runs both of its
    3x3 convs through the K6 launcher, never the plain version; the first
    GroupNorm's statistics are K13's, the second's K6's own."""
    from star_tpu_torch.ops import conv3x3 as c3
    from star_tpu_torch.ops import norms as nm
    from star_tpu_torch.vae.svd_vae import ResnetBlock2D
    calls = []
    monkeypatch.setattr(nm, '_launch_stats', lambda x3: (
        calls.append(('gn_stats', tuple(x3.shape))),
        (torch.zeros(x3.shape[0], x3.shape[2]),) * 2)[1])

    def launch(x, a, b, weight, bias, residual, want_stats):
        calls.append((tuple(weight.shape), residual is not None))
        out = _fake(torch.zeros(*x.shape[:3], weight.shape[0]))
        st = (torch.zeros(x.shape[0], weight.shape[0]),) * 2
        return out, (st if want_stats else None)
    monkeypatch.setattr(c3, 'conv3x3_plain', _refuse)
    monkeypatch.setattr(c3, '_launch', launch)
    block = ResnetBlock2D(128, 128).requires_grad_(False)
    with torch.no_grad():
        out, st = block(_fake(torch.randn(2, 5, 8, 128)), want_stats=True)
    assert calls == [('gn_stats', (2, 40, 128)), ((128, 128, 3, 3), False),
                     ((128, 128, 3, 3), True)]
    assert out.shape == (2, 5, 8, 128) and st[0].shape == (2, 128)


def _vae_launch_case(case):
    """(launcher, args) of one input the VAE kernels do not take."""
    c3 = importlib.import_module('star_tpu_torch.ops.conv3x3')
    uc = importlib.import_module('star_tpu_torch.ops.upsample_conv')
    bf = lambda *s: _fake(torch.zeros(*s, dtype=torch.bfloat16))
    ab = torch.zeros(1, 128), torch.zeros(1, 128)
    w, bias = torch.zeros(128, 128, 3, 3), torch.zeros(128)
    k_rs = torch.zeros(4, 2, 2, 128, 128)
    p = bf(1, 4, 8, 16)
    return {
        'conv3x3_cpu': (c3._launch, (torch.zeros(1, 4, 8, 128), *ab, w, bias,
                                     None, True)),
        'conv3x3_fp32': (c3._launch, (_fake(torch.zeros(1, 4, 8, 128)), *ab,
                                      w, bias, None, True)),
        'conv3x3_strided': (c3._launch, (bf(1, 8, 4, 128).transpose(1, 2),
                                         *ab, w, bias, None, True)),
        'conv3x3_c48': (c3._launch, (bf(1, 4, 8, 48), *ab,
                                     torch.zeros(128, 48, 3, 3), bias, None,
                                     True)),
        'conv3x3_cout64': (c3._launch, (bf(1, 4, 8, 128), *ab,
                                        torch.zeros(64, 128, 3, 3),
                                        torch.zeros(64), None, True)),
        'conv3x3_residual_fp32': (c3._launch, (bf(1, 4, 8, 128), *ab, w,
                                               bias, torch.zeros(1, 4, 8, 128),
                                               True)),
        'upsample_fp32': (uc._launch_upsample, (
            _fake(torch.zeros(1, 4, 8, 128)), k_rs, bias, True)),
        'upsample_cout64': (uc._launch_upsample, (
            bf(1, 4, 8, 128), torch.zeros(4, 2, 2, 128, 64),
            torch.zeros(64), True)),
        'interleave_c12': (uc._launch_interleave, (*[bf(1, 4, 8, 12)] * 4,
                                                   True)),
        'interleave_shapes': (uc._launch_interleave, (p, p, p, bf(1, 4, 9, 16),
                                                      True)),
        'interleave_fp32': (uc._launch_interleave, (
            *[_fake(torch.zeros(1, 4, 8, 16))] * 4, False)),
    }[case]


@pytest.mark.parametrize('case', [
    'conv3x3_cpu', 'conv3x3_fp32', 'conv3x3_strided', 'conv3x3_c48',
    'conv3x3_cout64', 'conv3x3_residual_fp32', 'upsample_fp32',
    'upsample_cout64', 'interleave_c12', 'interleave_shapes',
    'interleave_fp32'])
def test_vae_launchers_refuse_what_the_kernels_do_not_take(case):
    """The K6/K7/K8 launchers check device, dtype, contiguity and widths
    before building anything (a CUDA-looking CPU tensor gets that far)."""
    launch, args = _vae_launch_case(case)
    with pytest.raises(ValueError):
        launch(*args)


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    """Run on a machine with a card: each kernel against its plain version
    at small shapes (chip_smoke.py does this at the main path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from star_tpu_torch.ops import (flash_attention as fa,
                                    fused_temporal_conv as ftc,
                                    temporal_attention as ta)
    from star_tpu_torch.ops.norms import channel_stats, gn_coeffs
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device='cuda').manual_seed(0)
    bf = lambda *s: torch.randn(s, generator=g, device='cuda').bfloat16()

    def agree(a, b):
        # relative to the plain output with no floor (attention outputs
        # here are near 0.05): largest error within 2e-2 of its largest
        # magnitude, RMS error within 1e-2 of its RMS (a bf16 rounding alone
        # gives about 2e-3)
        a, b = a.float(), b.float()
        return bool((a - b).abs().max() <= 2e-2 * b.abs().max()
                    and (a - b).norm() <= 1e-2 * b.norm())
    q, k, v = bf(2, 600, 320), bf(2, 700, 320), bf(2, 700, 320)
    assert agree(fa.flash_attention_packed(q, k, v, 5, kv_valid=650),
                 fa.flash_attention_packed_plain(q, k, v, 5, 0.125, 650))
    q, k, v = bf(1, 530, 1, 512), bf(1, 530, 1, 512), bf(1, 530, 1, 512)
    assert agree(fa.flash_attention(q, k, v),
                 fa.attention_plain(q, k, v, 512 ** -0.5))
    q, k, v = bf(2, 8, 100, 320), bf(2, 8, 100, 320), bf(2, 8, 100, 320)
    assert agree(ta.temporal_attention(q, k, v, 5),
                 ta.temporal_attention_plain(q, k, v, 5, 0.125))
    x = bf(2, 5, 100, 64)
    sc, bi = torch.ones(64, device='cuda'), torch.zeros(64, device='cuda')
    w = torch.randn(3, 1, 64, 64, generator=g, device='cuda') * 0.1
    cb = torch.zeros(64, device='cuda')
    st = channel_stats(x.reshape(2, -1, 64))
    y, sty = ftc.fused_gn_silu_tconv3(x, sc, bi, w, cb, stats=st,
                                      residual=x, want_stats=True,
                                      stats_per_frame=True)
    a, b = gn_coeffs(st, 5 * 100 * 2, sc, bi, 32, 1e-5)
    yr, str_ = ftc.tconv3_plain(x, a, b, w[:, 0], cb, x, True, True)
    assert agree(y, yr)
    assert float((sty[1] - str_[1]).abs().max()
                 / str_[1].abs().max()) < 2e-2

    # statistics within 2e-2 of the largest sum of squares (bf16 outputs,
    # atomic adds in a varying order)
    def stats_agree(st, st_ref):
        return all(float((st[i] - st_ref[i]).abs().max()
                         / st_ref[1].abs().max()) < 2e-2 for i in range(2))
    from star_tpu_torch.ops import conv3x3 as c3, upsample_conv as uc
    torch.backends.cudnn.allow_tf32 = False
    # K6: ragged H and W (11 x 21 against the 8 x 16 patch), C != Cout,
    # residual, statistics
    x = bf(2, 11, 21, 128)
    sc = torch.rand(128, generator=g, device='cuda') + 0.5
    bi = torch.randn(128, generator=g, device='cuda') * 0.1
    w = torch.randn(256, 128, 3, 3, generator=g, device='cuda') * 0.03
    cb = torch.randn(256, generator=g, device='cuda') * 0.1
    res = bf(2, 11, 21, 256)
    y, sty = c3.fused_gn_silu_conv3x3(x, sc, bi, w, cb, residual=res,
                                      want_stats=True)
    a, b = gn_coeffs(channel_stats(x), 11 * 21 * 4, sc, bi, 32, 1e-6)
    yr, str_ = c3.conv3x3_plain(x, a, b, w, cb, res, True)
    assert agree(y, yr) and stats_agree(sty, str_)
    # K7 at a width it takes, with statistics
    x = bf(2, 5, 9, 64)
    w = torch.randn(128, 64, 3, 3, generator=g, device='cuda') * 0.05
    cb = torch.randn(128, generator=g, device='cuda') * 0.1
    y, sty = uc.upsample_conv2x(x, w, cb, want_stats=True)
    yr, str_ = uc.upsample_conv2x_plain(x, uc.phase_weights(w), cb, True)
    assert agree(y, yr) and stats_agree(sty, str_)
    # K8 at a width K7 does not take (C = 40), with statistics
    ps = [bf(3, 5, 7, 40) for _ in range(4)]
    y, sty = uc.interleave2x2(*ps, want_stats=True)
    yr, str_ = uc.interleave2x2_plain(*ps, want_stats=True)
    assert torch.equal(y, yr) and stats_agree(sty, str_)
    # K2 `with_l` (output and lse) and K3: ragged S, 5 heads, a dead kv
    # tail whose dk/dv stay zero; lse within 1e-3 (natural log units)
    q, do = bf(2, 200, 320), bf(2, 200, 320)
    k, v = bf(2, 230, 320), bf(2, 230, 320)
    o, lse = fa._launch(q, k, v, 5, 64, 0.125 * fa.LOG2E, 210,
                        want_lse=True)
    o_ref, lse_ref = fa.flash_attention_packed_plain(q, k, v, 5, 0.125, 210,
                                                     return_lse=True)
    assert agree(o, o_ref)
    assert float((lse - lse_ref).abs().max()) <= 1e-3
    got = fa._launch_bwd(q, k, v, o, lse, do, 5, 0.125, 210)
    want = fa.flash_bwd_plain(q, k[:, :210], v[:, :210], o, lse, do, 5,
                              0.125)
    assert agree(got[0], want[0])
    for g_, w_ in zip(got[1:], want[1:]):
        assert agree(g_[:, :210], w_)
        assert float(g_[:, 210:].abs().max()) == 0.0


# ------------------------------------------------------------------ K9


def _k9_args(x, heads=2, s=None, table_width=64):
    s = x.shape[1] if s is None else s
    return (x, torch.ones(64), torch.zeros(64), torch.ones(s, table_width),
            torch.zeros(s, table_width), heads)


@pytest.mark.parametrize('case', ['cpu', 'fp32', 'strided_x', 'strided_ct',
                                  'head_dim_32', 'ct_shape', 'table_32'])
def test_qk_ln_rope_backward_launcher_refuses_what_the_kernel_does_not_take(
        case):
    qr = importlib.import_module('star_tpu_torch.ops.qk_ln_rope')
    bf = lambda *s: _fake(torch.zeros(*s, dtype=torch.bfloat16))
    x, strided = bf(1, 5, 128), bf(1, 128, 5).transpose(1, 2)
    xs, ct, heads, width = {
        'cpu': (torch.zeros(1, 5, 128, dtype=torch.bfloat16),
                torch.zeros(1, 5, 128, dtype=torch.bfloat16), 2, 64),
        'fp32': (_fake(torch.zeros(1, 5, 128)), _fake(torch.zeros(1, 5, 128)),
                 2, 64),
        'strided_x': (strided, x, 2, 64),
        'strided_ct': (x, strided, 2, 64),
        'head_dim_32': (x, x, 4, 64),
        'ct_shape': (x, bf(1, 6, 128), 2, 64),
        'table_32': (x, x, 2, 32),
    }[case]
    sc, bi = torch.ones(64), torch.zeros(64)
    cos, sin = torch.ones(5, width), torch.zeros(5, width)
    with pytest.raises(ValueError):
        qr._launch_bwd(xs, ct, sc, bi, cos, sin, heads, 1e-6, 1.0, True)


@pytest.mark.parametrize('case', ['cpu', 'fp32', 'strided', 'head_dim_32',
                                  'tiled_table', 'short_table'])
def test_qk_ln_rope_launcher_refuses_what_the_kernel_does_not_take(case):
    qr = importlib.import_module('star_tpu_torch.ops.qk_ln_rope')
    bf = lambda *s: _fake(torch.zeros(*s, dtype=torch.bfloat16))
    args = {
        'cpu': _k9_args(torch.zeros(1, 5, 128, dtype=torch.bfloat16)),
        'fp32': _k9_args(_fake(torch.zeros(1, 5, 128))),
        'strided': _k9_args(bf(1, 128, 5).transpose(1, 2)),
        'head_dim_32': _k9_args(bf(1, 5, 128), heads=4),
        'tiled_table': _k9_args(bf(1, 5, 128), table_width=128),
        'short_table': _k9_args(bf(1, 5, 128), s=4),
    }[case]
    with pytest.raises(ValueError):
        qr._launch(*args, 1e-6, 1.0)


def test_dit_layer_reaches_k9_twice_and_k1_once(monkeypatch):
    """A DiT layer on CUDA tensors at >= 512 tokens: K9 on q (softmax scale
    * log2(e) folded in) and on k (fold 1), then K1 prescaled with the dead
    tail masked by kv_valid — no plain version; and K10 for input_ln over
    the whole stream and for post_ln on the image and text segments."""
    qr = importlib.import_module('star_tpu_torch.ops.qk_ln_rope')
    fa = importlib.import_module('star_tpu_torch.ops.flash_attention')
    fl = importlib.import_module('star_tpu_torch.ops.fused_ln')
    from star_tpu_torch.models.dit.dit import DiTLayer, rope_tables
    calls = []
    monkeypatch.setattr(qr, 'qk_ln_rope_plain', _refuse)
    monkeypatch.setattr(fa, 'flash_attention_packed_plain', _refuse)
    monkeypatch.setattr(fa, 'attention_plain', _refuse)
    monkeypatch.setattr(fl, 'fused_ln_plain', _refuse)
    monkeypatch.setattr(fl, '_launch_ln', lambda x, sc, bi, eps, gw: (
        calls.append(('k10', x.shape[1])), x)[1])
    monkeypatch.setattr(qr, '_launch', lambda x, sc, bi, cos, sin, h, eps,
                        fold: (calls.append(('k9', fold)), x)[1])
    monkeypatch.setattr(fa, '_launch', lambda q, k, v, h, d, c, kv,
                        want_lse=False: (calls.append(('k1', c, kv)), q)[1])
    layer = DiTLayer(128, 2, 8, 16).requires_grad_(False)
    grid, s_pad = (1, 16, 32), 528          # 8 + 512 tokens, padded to 528
    cos, sin = (torch.from_numpy(a) for a in rope_tables(8, *grid, s_pad, 64))
    with torch.no_grad():
        out = layer(_fake(torch.randn(2, s_pad, 128)), torch.randn(2, 16),
                    cos, sin, grid)
    assert calls == [('k10', s_pad), ('k9', fa.LOG2E / 8.0), ('k9', 1.0),
                     ('k1', 1.0, 520), ('k10', s_pad - 8), ('k10', 8)]
    assert out.shape == (2, s_pad, 128)


@pytest.mark.cuda
def test_qk_ln_rope_on_the_card():
    """On a card: K9 agrees with its plain version (relative, as
    chip_smoke.py holds it), and its wrapper raises on fp32 or
    non-contiguous input instead of falling back."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    qr = importlib.import_module('star_tpu_torch.ops.qk_ln_rope')
    g = torch.Generator(device='cuda').manual_seed(0)
    x = (torch.randn(2, 300, 6 * 64, generator=g, device='cuda') * 2 + 0.5
         ).bfloat16()
    sc = torch.randn(64, generator=g, device='cuda') * 0.1 + 1
    bi = torch.randn(64, generator=g, device='cuda') * 0.1
    ang = torch.rand(300, 64, generator=g, device='cuda') * 3
    cos, sin = ang.cos(), ang.sin()
    got = qr.qk_ln_rope(x, sc, bi, cos, sin, 6, fold_scale=0.18)
    want = qr.qk_ln_rope_plain(x, sc, bi, cos, sin, 6, fold_scale=0.18)
    a, b = got.float(), want.float()
    assert (a - b).abs().max() <= 2e-2 * b.abs().max()
    assert (a - b).norm() <= 1e-2 * b.norm()
    with pytest.raises(ValueError):
        qr.qk_ln_rope(x.float(), sc, bi, cos, sin, 6)
    with pytest.raises(ValueError):
        qr.qk_ln_rope(x.transpose(0, 1).contiguous().transpose(0, 1), sc,
                      bi, cos, sin, 6)


@pytest.mark.cuda
def test_qk_ln_rope_backward_on_the_card():
    """On a card: K9's backward kernel agrees with qk_ln_rope_bwd_plain
    (relative, as chip_smoke.py holds it) at the DiT's [1, 9680, 3072]
    with dx alone, and at a ragged [2, 37, 192] with the scale and bias
    gradients, which come out the same bit for bit on a second call; under
    the autograd Function a backward is one launch."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from star_tpu_torch import ops
    qr = importlib.import_module('star_tpu_torch.ops.qk_ln_rope')
    g = torch.Generator(device='cuda').manual_seed(1)
    rnd = lambda *s: torch.randn(*s, generator=g, device='cuda')

    def agree(a, b):
        a, b = a.float(), b.float()
        return bool((a - b).abs().max() <= 2e-2 * b.abs().max()
                    and (a - b).norm() <= 1e-2 * b.norm())
    for b, s, heads, want in ((1, 9680, 48, False), (2, 37, 3, True)):
        x = (rnd(b, s, heads * 64) * 2 + 0.5).bfloat16()
        ct = rnd(b, s, heads * 64).bfloat16()
        sc, bi = rnd(64) * 0.1 + 1, rnd(64) * 0.1
        ang = torch.rand(s, 64, generator=g, device='cuda') * 3
        cos, sin = ang.cos(), ang.sin()
        cos[:2], sin[:2] = 1.0, 0.0
        args = (x, ct, sc, bi, cos, sin, heads, 1e-6, 0.18, want)
        got, ref = qr._launch_bwd(*args), qr.qk_ln_rope_bwd_plain(*args)
        assert got[0].dtype == torch.bfloat16 and agree(got[0], ref[0])
        if want:
            assert all(agree(a, r) for a, r in zip(got[1:], ref[1:]))
            again = qr._launch_bwd(*args)
            assert all(torch.equal(a, r) for a, r in zip(got, again))
        else:
            assert got[1:] == (None, None)
    ops.reset_launch_counts()
    xg = x.requires_grad_()
    torch.autograd.grad(qr.qk_ln_rope(xg, sc, bi, cos, sin, heads), xg, ct)
    assert ops.launch_counts()['qk_ln_rope_bwd'] == 1 == qr.BACKWARDS


# ------------------------------------------------------------- K10, K11


def _fused_ln_launch_case(case):
    """(launcher, args) of one input K10/K11 do not take."""
    fl = importlib.import_module('star_tpu_torch.ops.fused_ln')
    bf = lambda *s: _fake(torch.zeros(*s, dtype=torch.bfloat16))
    p = lambda c: (torch.ones(c), torch.zeros(c))
    return {
        'cpu': (fl._launch_ln, (torch.zeros(2, 5, 128, dtype=torch.bfloat16),
                                *p(128), 1e-5, None)),
        'fp32': (fl._launch_ln, (_fake(torch.zeros(2, 5, 128)), *p(128),
                                 1e-5, None)),
        'strided': (fl._launch_ln, (bf(2, 128, 5).transpose(1, 2), *p(5),
                                    1e-5, None)),
        'c96': (fl._launch_ln, (bf(2, 5, 96), *p(96), 1e-5, None)),
        'c4160': (fl._launch_ln, (bf(2, 5, 4160), *p(4160), 1e-5, None)),
        'scale_shape': (fl._launch_ln, (bf(2, 5, 128), *p(64), 1e-5, None)),
        'gate_3': (fl._launch_ln, (bf(2, 5, 128), *p(128), 1e-5,
                                   torch.zeros(3))),
        'resid_shape': (fl._launch_resid_ln, (bf(2, 5, 128), *p(128),
                                              bf(2, 4, 128), None, 1e-5)),
        'resid_fp32': (fl._launch_resid_ln, (
            bf(2, 5, 128), *p(128), _fake(torch.zeros(2, 5, 128)), None,
            1e-5)),
    }[case]


@pytest.mark.parametrize('case', ['cpu', 'fp32', 'strided', 'c96', 'c4160',
                                  'scale_shape', 'gate_3', 'resid_shape',
                                  'resid_fp32'])
def test_fused_ln_launchers_refuse_what_the_kernels_do_not_take(case):
    """The K10/K11 launchers check device, dtype, contiguity, widths and
    parameter shapes before building anything."""
    launch, args = _fused_ln_launch_case(case)
    with pytest.raises(ValueError):
        launch(*args)


@pytest.mark.parametrize('block', ['temporal', 'spatial', 'spatial_cfg_split'])
def test_unet_transformer_blocks_reach_k10_and_k11(monkeypatch, block):
    """On CUDA tensors: a TemporalTransformerBlock runs K10 gated (norm1),
    K11 gated with the residual (norm2) and K11 with the residual (norm3);
    a SpatialTransformerBlock K11 twice (norm2, norm3), the first at the
    half batch under cfg_split. No plain version of either. Each block's
    feed-forward then runs K12 once, on the whole batch."""
    fl = importlib.import_module('star_tpu_torch.ops.fused_ln')
    ta = importlib.import_module('star_tpu_torch.ops.temporal_attention')
    gg = importlib.import_module('star_tpu_torch.ops.geglu')
    from star_tpu_torch.models.unet.blocks import (SpatialTransformerBlock,
                                                   TemporalTransformerBlock)
    calls = []
    monkeypatch.setattr(fl, 'fused_ln_plain', _refuse)
    monkeypatch.setattr(fl, 'fused_resid_ln_plain', _refuse)
    monkeypatch.setattr(fl, '_launch_ln', lambda x, sc, bi, eps, gw: (
        calls.append(('k10', gw is not None, x.shape[0])), x)[1])
    monkeypatch.setattr(fl, '_launch_resid_ln', lambda y, sc, bi, r, gw,
                        eps: (calls.append(('k11', gw is not None,
                                            y.shape[0])), (y, y + r))[1])
    monkeypatch.setattr(ta, '_launch', lambda q, k, v, h, scale: q)
    monkeypatch.setattr(gg, 'geglu_plain', _refuse)
    monkeypatch.setattr(gg, '_launch', lambda p: (
        calls.append(('k12', p.numel() // p.shape[-1] // p.shape[-2])),
        p[..., :p.shape[-1] // 2])[1])
    with torch.no_grad():
        if block == 'temporal':
            m = TemporalTransformerBlock(64, 1, 64)
            out = m(_fake(torch.randn(2, 4, 6, 64)))
            assert out.shape == (2, 4, 6, 64)
            want = [('k10', True, 2), ('k11', True, 2), ('k11', False, 2),
                    ('k12', 2 * 4)]
        else:
            split = block == 'spatial_cfg_split'
            m = SpatialTransformerBlock(64, 1, 64, 32)
            out = m(_fake(torch.randn(3, 12, 64)),
                    torch.randn(6 if split else 3, 7, 32), 3, 4,
                    cfg_split=split)
            assert out.shape == (6 if split else 3, 12, 64)
            want = [('k11', False, 3), ('k11', False, 6 if split else 3),
                    ('k12', 6 if split else 3)]
    assert calls == want


@pytest.mark.cuda
def test_fused_ln_on_the_card():
    """On a card: K10 and K11 agree with their plain versions (relative, as
    chip_smoke.py holds them; xr bit for bit), gated and not, with bf16 and
    fp32 parameters; a wrong dtype or width raises instead of falling back;
    and an input requiring grad goes through the Function, whose gradients
    match autograd through the plain version."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    fl = importlib.import_module('star_tpu_torch.ops.fused_ln')
    g = torch.Generator(device='cuda').manual_seed(0)
    size = lambda *s: torch.exp(torch.rand(*s, 1, generator=g,
                                           device='cuda') * -7)
    bf = lambda *s: (torch.randn(*s, generator=g, device='cuda')
                     * size(*s[:-1])).bfloat16()

    def agree(a, b):
        a, b = a.float(), b.float()
        return bool((a - b).abs().max() <= 2e-2 * b.abs().max()
                    and (a - b).norm() <= 1e-2 * b.norm())
    for c, pdt in ((320, torch.bfloat16), (1280, torch.float32),
                   (3072, torch.bfloat16), (640, torch.float32)):
        x, r = bf(3, 37, c), bf(3, 37, c)
        sc = (torch.rand(c, generator=g, device='cuda') + 0.5).to(pdt)
        bi = (torch.randn(c, generator=g, device='cuda') * 0.1).to(pdt)
        for gw in (None, torch.tensor([1.5, -2.0], device='cuda').to(pdt)):
            assert agree(fl.fused_ln(x, sc, bi, 1e-5, gw),
                         fl.fused_ln_plain(x, sc, bi, 1e-5, gw))
            out, xr = fl.fused_resid_ln(x, sc, bi, r, gw)
            ref, xr_ref = fl.fused_resid_ln_plain(x, sc, bi, r, gw)
            assert agree(out, ref) and torch.equal(xr, xr_ref)
    with pytest.raises(ValueError):
        fl.fused_ln(x.float(), sc, bi)
    with pytest.raises(ValueError):
        fl.fused_ln(bf(2, 5, 96), torch.ones(96, device='cuda'),
                    torch.zeros(96, device='cuda'))
    before = ops.launch_counts()['fused_resid_ln']
    leaves = [t.detach().clone().requires_grad_()
              for t in (x, r, sc.float(), bi.float(), gw.float())]
    got = torch.autograd.grad(fl.fused_resid_ln(
        leaves[0], leaves[2], leaves[3], leaves[1], leaves[4])[0].float()
        .square().sum(), leaves)
    assert ops.launch_counts()['fused_resid_ln'] == before + 1
    want = torch.autograd.grad(fl.fused_resid_ln_plain(
        leaves[0], leaves[2], leaves[3], leaves[1], leaves[4])[0].float()
        .square().sum(), leaves)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all() and agree(a, b)
