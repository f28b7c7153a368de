"""Guards of the port's contract:

  * no module of star_tpu_torch/, and not chip_smoke.py, imports jax, flax,
    orbax, star_tpu or tools (AST scan), and the golden tests of the port's
    own conversion (tests/test_torch_convert.py, and the sample_sr golden)
    import nothing of star_tpu or jax either;
  * the entry points raise without a CUDA card unless given device="cpu":
    the random-weight models, the pipelines, load_star_models /
    load_cog_models, setup_seed and the main of inference_sr, sample_sr,
    sample_t2v and serve; warm_cache needs nvcc, not a card;
  * a CUDA tensor never reaches a kernel's plain version: each wrapper
    launches (here a counting stand-in for the launcher) or raises;
  * under autograd the differentiable kernels launch forward and backward
    (K2 `with_l` then K3; K4 and K5 launch forward and recompute their
    plain version only inside the backward), and the kernels with no
    backward (K2 d=512, K6, K7, K8) raise instead of returning a result
    cut off from autograd;
  * the collectives of parallel/ refuse a tensor their backend does not
    take (NCCL takes CUDA tensors, gloo CPU ones) and let a failed
    collective raise: no fallback to another backend or to the host;
  * tests that need the card run there and skip here.
"""

import ast
import importlib
import os

import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize('name', ['packed', 'd512', 'temporal', 'tconv',
                                  'conv3x3', 'upsample_conv2x',
                                  'interleave2x2', 'upsample_phases',
                                  'group_norm', 'channel_stats'])
def test_cuda_tensors_never_reach_plain_versions(monkeypatch, name):
    fa = importlib.import_module('star_tpu_torch.ops.flash_attention')
    ta = importlib.import_module('star_tpu_torch.ops.temporal_attention')
    ftc = importlib.import_module('star_tpu_torch.ops.fused_temporal_conv')
    c3 = importlib.import_module('star_tpu_torch.ops.conv3x3')
    uc = importlib.import_module('star_tpu_torch.ops.upsample_conv')
    nm = importlib.import_module('star_tpu_torch.ops.norms')
    launched = []
    want = [name]

    def launcher(kind, returns_stats):
        def launch(*a, **k):
            launched.append(kind)
            return (a[0], None) if returns_stats else a[0]
        return launch
    for mod, plain in ((fa, 'attention_plain'),
                       (fa, 'flash_attention_packed_plain'),
                       (fa, 'flash_bwd_plain'),
                       (ta, 'temporal_attention_plain'),
                       (ftc, 'tconv3_plain'),
                       (c3, 'conv3x3_plain'),
                       (uc, 'upsample_conv2x_plain'),
                       (uc, 'interleave2x2_plain')):
        monkeypatch.setattr(mod, plain, _refuse)
    for mod, fn, kind, pair in (
            (fa, '_launch', name, False), (ta, '_launch', name, False),
            (ftc, '_launch', name, True), (c3, '_launch', name, True),
            (uc, '_launch_upsample', 'upsample_conv2x', False),
            (uc, '_launch_interleave', 'interleave2x2', False)):
        monkeypatch.setattr(mod, fn, launcher(kind, pair))
    monkeypatch.setattr(nm, 'group_norm_plain', _refuse)
    monkeypatch.setattr(nm, '_launch_stats', lambda x3, fold=None: (
        launched.append('gn_stats'), (x3[:, 0],) * (2 if fold is None
                                                    else 3))[1])
    monkeypatch.setattr(nm, '_launch_apply', lambda x3, m, a, b, silu: (
        launched.append('group_norm'), x3)[1])
    x = _fake(torch.randn(1, 4, 8, 64))
    xb = _fake(torch.randn(2, 4, 8, 64).bfloat16())
    if name == 'group_norm':            # K13: statistics, then the apply
        nm.group_norm(xb, torch.ones(64), torch.zeros(64), silu=True)
        want = ['gn_stats', 'group_norm']
    elif name == 'channel_stats':       # K13's statistics alone
        c3.channel_stats(xb)
        want = ['gn_stats']
    elif name == 'conv3x3':
        c3.fused_gn_silu_conv3x3(_fake(torch.randn(1, 5, 8, 128)),
                                 torch.ones(128), torch.zeros(128),
                                 torch.zeros(256, 128, 3, 3),
                                 torch.zeros(256), want_stats=True)
        want = ['gn_stats', 'conv3x3']  # x's statistics, then K6
    elif name == 'upsample_conv2x':     # K7 widths
        uc.upsample_conv2x(_fake(torch.randn(1, 3, 4, 64)),
                           torch.zeros(128, 64, 3, 3), torch.zeros(128))
    elif name == 'interleave2x2':
        uc.interleave2x2(x, x, x, x, want_stats=True)
    elif name == 'upsample_phases':     # narrow: phase convs, then K8
        uc.upsample_conv2x(_fake(torch.randn(1, 3, 4, 32)),
                           torch.zeros(32, 32, 3, 3), torch.zeros(32))
        want = ['interleave2x2']
    elif name == 'packed':
        fa.flash_attention_packed(_fake(torch.randn(1, 8, 128)),
                                  _fake(torch.randn(1, 8, 128)),
                                  _fake(torch.randn(1, 8, 128)), 2)
    elif name == 'd512':
        q = _fake(torch.randn(1, 8, 1, 512))
        fa.flash_attention(q, q, q)
    elif name == 'temporal':
        ta.temporal_attention(x, x, x, 1)
    else:
        ftc.fused_gn_silu_tconv3(x, torch.ones(64), torch.zeros(64),
                                 torch.zeros(3, 1, 64, 64), torch.zeros(64),
                                 want_stats=True)
        want = ['gn_stats', 'tconv']    # x's statistics, then K5
    assert launched == want


@pytest.mark.parametrize('name', ['packed', 'd64', 'temporal', 'tconv'])
def test_differentiable_kernels_launch_forward_and_backward(monkeypatch,
                                                            name):
    """A recorded call on CUDA tensors: K1/K2-d64 launch the lse forward
    and K3 (flash_bwd_plain never runs); K4 and K5 launch their forward
    and run their plain version only inside the backward (the recompute
    the JAX package also does), K5 through threaded statistics, the first
    stage's from K13's statistics launch."""
    fa = importlib.import_module('star_tpu_torch.ops.flash_attention')
    ta = importlib.import_module('star_tpu_torch.ops.temporal_attention')
    ftc = importlib.import_module('star_tpu_torch.ops.fused_temporal_conv')
    nm = importlib.import_module('star_tpu_torch.ops.norms')
    events, phase = [], ['forward']

    def launch_fwd(q, k, v, heads, d, c, kv_valid, want_lse=False):
        events.append(('flash_fwd', want_lse))
        return torch.zeros_like(q), torch.zeros(q.shape[0], heads,
                                                q.shape[1])

    def launch_bwd(q, k, v, o, lse, do, heads, scale, kv_valid):
        events.append(('flash_bwd', q.is_cuda))
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)

    def in_backward(mod, plain):
        real = getattr(mod, plain)

        def run(*a, **k):
            assert phase[0] == 'backward', f'{plain} ran in the forward'
            events.append((plain, 'backward'))
            return real(*a, **k)
        monkeypatch.setattr(mod, plain, run)

    for mod, plain in ((fa, 'attention_plain'),
                       (fa, 'flash_attention_packed_plain'),
                       (fa, 'flash_bwd_plain')):
        monkeypatch.setattr(mod, plain, _refuse)
    monkeypatch.setattr(fa, '_launch', launch_fwd)
    monkeypatch.setattr(fa, '_launch_bwd', launch_bwd)
    monkeypatch.setattr(ta, '_launch', lambda q, *a: (
        events.append(('temporal_fwd',)), torch.zeros_like(q))[1])
    monkeypatch.setattr(ftc, '_launch', lambda x, a, b, k3, bias, res, ws,
                        pf: (events.append(('tconv_fwd', ws)),
                             (_fake(torch.zeros(*x.shape[:3], k3.shape[-1])),
                              (torch.ones(x.shape[0], k3.shape[-1]),) * 2
                              if ws else None))[1])
    monkeypatch.setattr(nm, '_launch_stats', lambda x3: (
        events.append(('gn_stats',)),
        (torch.sum(x3, 1, dtype=torch.float32),
         torch.sum(x3.float().square(), 1)))[1])
    in_backward(ta, 'temporal_attention_plain')
    in_backward(ftc, 'tconv3_plain')
    leaf = lambda *shape: _fake(torch.randn(*shape), requires_grad=True)
    if name == 'packed':
        q, k, v = (leaf(1, 8, 128) for _ in range(3))
        out = fa.flash_attention_packed(q, k, v, 2, kv_valid=6)
        inputs = (q, k, v)
        want = [('flash_fwd', True), ('flash_bwd', True)]
    elif name == 'd64':
        q, k, v = (leaf(1, 8, 2, 64) for _ in range(3))
        out = fa.flash_attention(q, k, v)
        inputs = (q, k, v)
        want = [('flash_fwd', True), ('flash_bwd', True)]
    elif name == 'temporal':
        q, k, v = (leaf(1, 4, 8, 64) for _ in range(3))
        out = ta.temporal_attention(q, k, v, 1)
        inputs = (q, k, v)
        want = [('temporal_fwd',), ('temporal_attention_plain', 'backward')]
    else:
        x = leaf(1, 4, 8, 64)
        w = torch.zeros(3, 1, 64, 64, requires_grad=True)
        y, st = ftc.fused_gn_silu_tconv3(x, torch.ones(64), torch.zeros(64),
                                         w, torch.zeros(64), want_stats=True)
        out, _ = ftc.fused_gn_silu_tconv3(y, torch.ones(64), torch.zeros(64),
                                          w, torch.zeros(64), stats=st)
        want = [('gn_stats',), ('tconv_fwd', True), ('tconv_fwd', False),
                ('tconv3_plain', 'backward'), ('tconv3_plain', 'backward')]
        inputs = (x, w)
    phase[0] = 'backward'
    grads = torch.autograd.grad(out.float().sum(), inputs)
    assert events == want
    assert all(g.shape == a.shape for g, a in zip(grads, inputs))


@pytest.mark.parametrize('case', ['d512', 'conv3x3', 'upsample_conv2x',
                                  'interleave2x2'])
def test_kernels_without_backward_refuse_grad(case):
    """K2 d=512, K6, K7 and K8 on CUDA tensors that require grad, with grad
    mode on: the launcher raises before building anything."""
    fa = importlib.import_module('star_tpu_torch.ops.flash_attention')
    c3 = importlib.import_module('star_tpu_torch.ops.conv3x3')
    uc = importlib.import_module('star_tpu_torch.ops.upsample_conv')
    bf = lambda *s: _fake(torch.zeros(*s, dtype=torch.bfloat16), True)
    with pytest.raises(RuntimeError, match='no backward kernel'):
        if case == 'd512':
            q = bf(1, 8, 1, 512)
            fa.flash_attention(q, q, q)
        elif case == 'conv3x3':
            c3.fused_gn_silu_conv3x3(bf(1, 5, 8, 128), torch.ones(128),
                                     torch.zeros(128),
                                     torch.zeros(128, 128, 3, 3),
                                     torch.zeros(128))
        elif case == 'upsample_conv2x':
            uc.upsample_conv2x(bf(1, 3, 4, 64), torch.zeros(128, 64, 3, 3),
                               torch.zeros(128))
        else:
            p = bf(1, 4, 8, 16)
            uc.interleave2x2(p, p, p, p)


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


def test_launch_counts_reset():
    from star_tpu_torch import ops
    ops.flash_attention.PACKED_LAUNCHES = 3
    ops.fused_temporal_conv.LAUNCHES = 2
    ops.conv3x3.LAUNCHES = 5
    ops.upsample_conv.INTERLEAVE_LAUNCHES = 1
    assert ops.launch_counts()['flash_packed'] == 3
    assert ops.launch_counts()['conv3x3'] == 5
    assert ops.launch_counts()['interleave2x2'] == 1
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0}
    assert set(ops.launch_counts()) == set(ops.KERNELS)


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    """Run on a machine with a card: each kernel against its plain version
    at small shapes (chip_smoke.py does this at the main path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from star_tpu_torch.ops import (flash_attention as fa,
                                    fused_temporal_conv as ftc,
                                    temporal_attention as ta)
    from star_tpu_torch.ops.conv3x3 import channel_stats, gn_coeffs
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


def test_qk_ln_rope_launches_for_cuda_tensors_and_plain_for_cpu(monkeypatch):
    """K9's wrapper: a CUDA tensor reaches the launcher and never the plain
    version; a CPU tensor gets the plain version and never the launcher."""
    qr = importlib.import_module('star_tpu_torch.ops.qk_ln_rope')
    launched = []
    monkeypatch.setattr(qr, '_launch', lambda x, *a: (launched.append(a[-1]),
                                                      x)[1])
    monkeypatch.setattr(qr, 'qk_ln_rope_plain', _refuse)
    qr.qk_ln_rope(*_k9_args(_fake(torch.randn(1, 5, 128))), fold_scale=0.5)
    assert launched == [0.5]
    monkeypatch.undo()
    monkeypatch.setattr(qr, '_launch', _refuse)
    x = torch.randn(1, 5, 128)
    got = qr.qk_ln_rope(*_k9_args(x))
    torch.testing.assert_close(got, qr.qk_ln_rope_plain(*_k9_args(x)))


def test_qk_ln_rope_refuses_grad():
    """K9's forward launcher records no backward: on CUDA tensors that
    require grad, with grad mode on, it raises before building anything
    (the wrapper goes through the autograd Function instead, whose
    backward launches the backward kernel, below)."""
    qr = importlib.import_module('star_tpu_torch.ops.qk_ln_rope')
    x = _fake(torch.zeros(1, 5, 128, dtype=torch.bfloat16), True)
    with pytest.raises(RuntimeError, match='no backward kernel'):
        qr._launch(*_k9_args(x), 1e-6, 1.0)


def test_qk_ln_rope_under_grad_launches_both_kernels_on_cuda_and_plain_on_cpu(
        monkeypatch):
    """An input requiring grad goes through K9's autograd Function. On a
    CUDA tensor the forward kernel launches (under the Function, where
    grad mode is off, so the launcher's refusal does not fire) and the
    backward launches the backward kernel, asking for the scale and bias
    gradients only when they require grad; no plain version runs. On a CPU
    tensor the backward is qk_ln_rope_bwd_plain. The gradients reach x,
    scale and bias but not the tables, and BACKWARDS counts the backward
    on both devices."""
    qr = importlib.import_module('star_tpu_torch.ops.qk_ln_rope')
    events = []

    def launch(x, *a):
        assert not qr._build.needs_grad(x), 'the launcher would refuse'
        events.append('k9')
        return _fake(torch.zeros(x.shape))

    def launch_bwd(x, ct, sc, bi, cos, sin, heads, eps, fold, want_params):
        events.append(('k9_bwd', want_params))
        return torch.zeros(x.shape), torch.zeros(64), torch.zeros(64)
    monkeypatch.setattr(qr, '_launch', launch)
    monkeypatch.setattr(qr, '_launch_bwd', launch_bwd)
    monkeypatch.setattr(qr, 'qk_ln_rope_plain', _refuse)
    monkeypatch.setattr(qr, 'qk_ln_rope_bwd_plain', _refuse)
    x = _fake(torch.randn(1, 5, 128), requires_grad=True)
    sc, bi = torch.ones(64, requires_grad=True), torch.zeros(
        64, requires_grad=True)
    cos, sin = torch.ones(5, 64), torch.zeros(5, 64)
    qr.BACKWARDS = 0
    out = qr.qk_ln_rope(x, sc, bi, cos, sin, 2, fold_scale=0.5)
    grads = torch.autograd.grad(out.float().sum(), (x, sc, bi))
    assert events == ['k9', ('k9_bwd', True)] and qr.BACKWARDS == 1
    assert [g.shape for g in grads] == [x.shape, (64,), (64,)]

    monkeypatch.undo()
    monkeypatch.setattr(qr, '_launch', _refuse)
    monkeypatch.setattr(qr, '_launch_bwd', _refuse)
    real = qr.qk_ln_rope_bwd_plain

    def bwd_plain(*a):
        events.append(('bwd_plain', a[-1]))
        return real(*a)
    monkeypatch.setattr(qr, 'qk_ln_rope_bwd_plain', bwd_plain)
    x = torch.randn(1, 5, 128, requires_grad=True)
    out = qr.qk_ln_rope(x, torch.ones(64), torch.zeros(64), cos, sin, 2)
    assert torch.autograd.grad(out.sum(), x)[0].shape == x.shape
    assert events[2:] == [('bwd_plain', False)] and qr.BACKWARDS == 2


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


def _ln_args(x, gated, resid):
    """(y, scale, bias, resid, gate_w) of one K10/K11 call."""
    c = x.shape[-1]
    return (x, torch.ones(c), torch.zeros(c),
            torch.ones_like(x) if resid else None,
            torch.tensor([0.5, -0.5]) if gated else None)


@pytest.mark.parametrize('kind', ['k10', 'k10_gated', 'k11', 'k11_gated'])
def test_fused_ln_launches_for_cuda_tensors_and_plain_for_cpu(monkeypatch,
                                                              kind):
    """K10's and K11's wrappers: a CUDA tensor reaches its launcher and
    never a plain version; a CPU tensor gets the plain version and never
    builds or loads the kernel library."""
    fl = importlib.import_module('star_tpu_torch.ops.fused_ln')
    from star_tpu_torch.ops import _build
    gated, resid = kind.endswith('gated'), kind.startswith('k11')
    launched = []
    monkeypatch.setattr(fl, '_launch_ln', lambda x, sc, bi, eps, gw: (
        launched.append(('k10', gw is not None)), x)[1])
    monkeypatch.setattr(fl, '_launch_resid_ln', lambda y, r, sc, bi, eps,
                        gw: (launched.append(('k11', gw is not None)),
                             (y, y))[1])
    monkeypatch.setattr(fl, 'fused_ln_plain', _refuse)
    monkeypatch.setattr(fl, 'fused_resid_ln_plain', _refuse)
    y, sc, bi, r, gw = _ln_args(_fake(torch.randn(2, 5, 128)), gated, resid)
    if resid:
        fl.fused_resid_ln(y, sc, bi, _fake(r), gw)
    else:
        fl.fused_ln(y, sc, bi, gate_w=gw)
    assert launched == [(kind[:3], gated)]
    monkeypatch.undo()
    for fn in ('_launch_ln', '_launch_resid_ln'):
        monkeypatch.setattr(fl, fn, _refuse)
    monkeypatch.setattr(_build, 'lib', _refuse)
    monkeypatch.setattr(_build, 'build', _refuse)
    y, sc, bi, r, gw = _ln_args(torch.randn(2, 5, 128), gated, resid)
    if resid:
        got = fl.fused_resid_ln(y, sc, bi, r, gw)
        want = fl.fused_resid_ln_plain(y, sc, bi, r, gw)
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
        got, want = got[0], want[0]
    else:
        got = fl.fused_ln(y, sc, bi, gate_w=gw)
        want = fl.fused_ln_plain(y, sc, bi, gate_w=gw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize('kind', ['k10', 'k11'])
def test_fused_ln_under_grad_launches_forward_and_recomputes_plain(
        monkeypatch, kind):
    """An input requiring grad goes through the autograd Function: the
    kernel launches in the forward, and the plain version runs only in
    the backward (the recompute the JAX custom VJPs do), giving gradients
    to every input, the gate weights included."""
    fl = importlib.import_module('star_tpu_torch.ops.fused_ln')
    events, phase = [], ['forward']
    monkeypatch.setattr(fl, '_launch_ln', lambda x, sc, bi, eps, gw: (
        events.append('k10'), _fake(torch.zeros(x.shape)))[1])
    monkeypatch.setattr(fl, '_launch_resid_ln', lambda y, r, sc, bi, eps,
                        gw: (events.append('k11'),
                             (_fake(torch.zeros(y.shape)),
                              _fake(torch.zeros(y.shape))))[1])
    for plain in ('fused_ln_plain', 'fused_resid_ln_plain'):
        real = getattr(fl, plain)

        def run(*a, _real=real, _name=plain, **k):
            assert phase[0] == 'backward', f'{_name} ran in the forward'
            events.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(fl, plain, run)
    leaf = lambda t: _fake(t, requires_grad=True) if t.ndim == 3 else \
        t.requires_grad_()
    y, sc, bi, r, gw = (None if t is None else leaf(t) for t in _ln_args(
        torch.randn(2, 5, 128), True, kind == 'k11'))
    if kind == 'k11':
        out, xr = fl.fused_resid_ln(y, sc, bi, r, gw)
        outs, inputs = [out, xr], (y, r, sc, bi, gw)
    else:
        outs, inputs = [fl.fused_ln(y, sc, bi, gate_w=gw)], (y, sc, bi, gw)
    phase[0] = 'backward'
    grads = torch.autograd.grad([o.float().sum() for o in outs], inputs)
    assert events == ([kind, 'fused_resid_ln_plain'] if kind == 'k11'
                      else [kind, 'fused_ln_plain'])
    assert all(g.shape == a.shape for g, a in zip(grads, inputs))


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
        'resid_shape': (fl._launch_resid_ln, (bf(2, 5, 128), bf(2, 4, 128),
                                              *p(128), 1e-5, None)),
        'resid_fp32': (fl._launch_resid_ln, (
            bf(2, 5, 128), _fake(torch.zeros(2, 5, 128)), *p(128), 1e-5,
            None)),
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
    monkeypatch.setattr(fl, '_launch_resid_ln', lambda y, r, sc, bi, eps,
                        gw: (calls.append(('k11', gw is not None,
                                           y.shape[0])), (y, y + r))[1])
    monkeypatch.setattr(ta, '_launch', lambda q, k, v, h, scale: q)
    monkeypatch.setattr(gg, 'geglu_plain', _refuse)
    monkeypatch.setattr(gg, '_launch', lambda p, inner: (
        calls.append(('k12', p.shape[-1] == 2 * inner,
                      p.numel() // p.shape[-1] // p.shape[-2])),
        p[..., :inner])[1])
    with torch.no_grad():
        if block == 'temporal':
            m = TemporalTransformerBlock(64, 1, 64)
            out = m(_fake(torch.randn(2, 4, 6, 64)))
            assert out.shape == (2, 4, 6, 64)
            want = [('k10', True, 2), ('k11', True, 2), ('k11', False, 2),
                    ('k12', True, 2 * 4)]
        else:
            split = block == 'spatial_cfg_split'
            m = SpatialTransformerBlock(64, 1, 64, 32)
            out = m(_fake(torch.randn(3, 12, 64)),
                    torch.randn(6 if split else 3, 7, 32), 3, 4,
                    cfg_split=split)
            assert out.shape == (6 if split else 3, 12, 64)
            want = [('k11', False, 3), ('k11', False, 6 if split else 3),
                    ('k12', True, 6 if split else 3)]
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
    before = fl.RESID_LN_LAUNCHES
    leaves = [t.detach().clone().requires_grad_()
              for t in (x, r, sc.float(), bi.float(), gw.float())]
    got = torch.autograd.grad(fl.fused_resid_ln(
        leaves[0], leaves[2], leaves[3], leaves[1], leaves[4])[0].float()
        .square().sum(), leaves)
    assert fl.RESID_LN_LAUNCHES == before + 1
    want = torch.autograd.grad(fl.fused_resid_ln_plain(
        leaves[0], leaves[2], leaves[3], leaves[1], leaves[4])[0].float()
        .square().sum(), leaves)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all() and agree(a, b)
