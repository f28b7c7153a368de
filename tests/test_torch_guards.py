"""Guards of the port's contract:

  * no module of star_tpu_torch/, and not chip_smoke.py, imports jax, flax
    or star_tpu (AST scan);
  * the entry points raise without a CUDA card unless given device="cpu";
  * a CUDA tensor never reaches a kernel's plain version: each wrapper
    launches (here a counting stand-in for the launcher) or raises;
  * tests that need the card run there and skip here.
"""

import ast
import importlib
import os

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), '..')
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'star_tpu')


def _port_sources():
    pkg = os.path.join(ROOT, 'star_tpu_torch')
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, 'chip_smoke.py')


def test_port_imports_nothing_of_jax_or_star_tpu():
    offenders = []
    for path in _port_sources():
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


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    from star_tpu_torch.config import PipelineConfig
    from star_tpu_torch.pipeline import (ModelBundle, STARPipeline,
                                         init_random_models)
    from star_tpu_torch.utils.device import resolve_device
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


class FakeCuda(torch.Tensor):
    """A CPU tensor that answers is_cuda=True, to drive each wrapper's
    CUDA branch without a card."""

    @property
    def is_cuda(self):
        return True


def _fake(x):
    return torch.Tensor._make_subclass(FakeCuda, x)


def _refuse(*a, **k):
    raise AssertionError('a CUDA tensor reached a plain version')


@pytest.mark.parametrize('name', ['packed', 'd512', 'temporal', 'tconv'])
def test_cuda_tensors_never_reach_plain_versions(monkeypatch, name):
    fa = importlib.import_module('star_tpu_torch.ops.flash_attention')
    ta = importlib.import_module('star_tpu_torch.ops.temporal_attention')
    ftc = importlib.import_module('star_tpu_torch.ops.fused_temporal_conv')
    launched = []
    launch = lambda *a, **k: launched.append(name) or (
        (a[0], None) if name == 'tconv' else a[0])
    for mod, plain in ((fa, 'attention_plain'),
                       (fa, 'flash_attention_packed_plain'),
                       (ta, 'temporal_attention_plain'),
                       (ftc, 'tconv3_plain')):
        monkeypatch.setattr(mod, plain, _refuse)
    for mod in (fa, ta, ftc):
        monkeypatch.setattr(mod, '_launch', launch)
    x = _fake(torch.randn(1, 4, 8, 64))
    if name == 'packed':
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
    assert launched == [name]


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


def test_launch_counts_reset():
    from star_tpu_torch import ops
    ops.flash_attention.PACKED_LAUNCHES = 3
    ops.fused_temporal_conv.LAUNCHES = 2
    assert ops.launch_counts()['flash_packed'] == 3
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
