"""K13, the GroupNorm kernel (star_tpu_torch/ops/norms.py,
csrc/group_norm.cu): the plain version against the expression the models
ran before, the launchers' arguments and refusals with a fake library (the
routing of CUDA-looking and CPU tensors and the recompute backward are
rows of the kernel contract's table, tests/test_torch_guards.py), the
launches per shape from the full-depth models at narrow widths
(chip_smoke.py's tables), and, on a card, the kernel against the eager
passes. No JAX: the `cuda` cases run on the card with
--noconftest."""

import sys

import pytest
import torch
import torch.nn.functional as F

import chip_smoke as cs
from star_tpu_torch import ops
from star_tpu_torch.models.layers import GroupNorm
from star_tpu_torch.models.unet.blocks import silu32
from star_tpu_torch.ops import _build
from star_tpu_torch.ops import norms as nm


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _old_group_norm(x, scale, bias, num_groups=32, eps=1e-5):
    """ops/norms.group_norm as the models ran it before K13."""
    c = x.shape[-1]
    n = x.shape[0]
    dtype = x.dtype
    xg = x.reshape(n, -1, num_groups, c // num_groups)
    mean = torch.mean(xg, dim=(1, 3), keepdim=True, dtype=torch.float32)
    mean2 = torch.mean(xg.float().square(), dim=(1, 3), keepdim=True,
                       dtype=torch.float32)
    inv = torch.rsqrt(mean2 - mean.square() + eps)
    a = inv * scale.float().reshape(num_groups, c // num_groups)
    bshape = (n,) + (1,) * (x.ndim - 2) + (c,)
    mean_b = mean.expand(n, 1, num_groups, c // num_groups).reshape(bshape)
    a = a.expand(n, 1, num_groups, c // num_groups).reshape(bshape)
    return (x - mean_b.to(dtype)) * a.to(dtype) + bias.to(dtype)


def _inputs(shape, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    c = shape[-1]
    x = torch.randn(*shape, generator=g) * 2 + torch.randn(c, generator=g)
    scale = 1 + 0.5 * torch.randn(c, generator=g)
    bias = 0.5 * torch.randn(c, generator=g)
    return x.to(dtype), scale.to(dtype), bias.to(dtype)


# ------------------------------------------------------------------ CPU

@pytest.mark.parametrize('silu', [False, True])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', [(3, 5, 7, 64), (2, 3, 4, 5, 96)])
def test_plain_version_is_the_old_expression(shape, dtype, silu):
    """group_norm_plain is the old expression, and with `silu` the old
    expression followed by silu32, bit for bit; group_norm on the CPU is
    the plain version."""
    x, scale, bias = _inputs(shape, dtype)
    want = _old_group_norm(x, scale, bias, 32, 1e-6)
    if silu:
        want = silu32(want)
    got = nm.group_norm_plain(x, scale, bias, 32, 1e-6, silu)
    assert got.dtype == dtype and got.shape == shape
    assert torch.equal(got, want)
    assert torch.equal(nm.group_norm(x, scale, bias, 32, 1e-6, silu), want)


def test_groupnorm_module_passes_the_silu():
    m = GroupNorm(64, 32, eps=1e-6)
    with torch.no_grad():
        m.weight.normal_()
        m.bias.normal_()
    x = _inputs((2, 3, 4, 64), torch.bfloat16)[0]
    with torch.no_grad():
        assert torch.equal(m(x, silu=True), silu32(m(x)))
        assert torch.equal(m(x), _old_group_norm(x, m.weight, m.bias, 32,
                                                 1e-6))


@pytest.mark.parametrize('c,k', [(8, 256), (128, 16), (256, 8), (320, 6),
                                 (512, 4), (640, 3), (960, 2), (1280, 2),
                                 (1920, 1), (2560, 1), (8192, 1)])
def test_launch_plan_fills_a_block_of_whole_rows(c, k):
    plan = nm.gn_launch_plan(c)
    assert plan == dict(k=k, threads=c // 8 * k)
    assert plan['threads'] <= 1024


class _FakeCuda(torch.Tensor):
    @property
    def is_cuda(self):
        return True


def _fake(*shape, dtype=torch.bfloat16, requires_grad=False):
    return torch.Tensor._make_subclass(
        _FakeCuda, torch.randn(*shape).to(dtype), requires_grad)


def _refuse(*a, **k):
    raise AssertionError('a CUDA tensor reached the plain version')


class _Library:
    def __init__(self):
        self.calls = []

    def star_gn_stats(self, *args):
        self.calls.append(('stats', args))
        return 0

    def star_gn_apply(self, *args):
        self.calls.append(('apply', args))
        return 0


@pytest.fixture
def library(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(_build, 'lib', lambda: lib)
    monkeypatch.setattr(_build, 'stream_ptr', lambda device: 7)
    monkeypatch.setattr(_build, 'sm_count', lambda device: 132)
    return lib


@pytest.mark.parametrize('n,r,c,groups', [(16, 37, 320, 32),
                                          (1, 100, 128, 32),
                                          (3, 5, 2560, 32), (2, 9, 40, 5)])
def test_stats_launcher_hands_the_entry_point_its_shape(library, n, r, c,
                                                        groups):
    """N, R, C, groups, eps, the block's row lanes, the scratch's slabs
    (one wave of at most 2048 / threads blocks an SM, split over the n, at
    most R) and the SMs; with a fold the scale and bias (fp32 copies where
    they are not both bf16) and three bf16 coefficient outputs, without it
    the fp32 sums and null pointers."""
    x = _fake(n, r, c)
    scale, bias = torch.randn(c).bfloat16(), torch.randn(c)
    plan = nm.gn_launch_plan(c)
    slabs = max(1, min(r, 132 * (2048 // plan['threads']) // n))
    before = ops.launch_counts()
    mean, a, b = nm._launch_stats(x, (scale, bias, groups, 1e-6))
    s, s2 = nm._launch_stats(x)
    (k1, args1), (k2, args2) = library.calls
    assert (k1, k2) == ('stats', 'stats')
    for t in (mean, a, b):
        assert t.shape == (n, c) and t.dtype == torch.bfloat16
    for t in (s, s2):
        assert t.shape == (n, c) and t.dtype == torch.float32
    assert args1[0] == x.data_ptr() and args1[7:10] == tuple(
        t.data_ptr() for t in (mean, a, b))
    assert args1[2:4] == (None, None)
    assert None not in args1[4:6] and args1[6] == 0
    assert args1[10:] == (n, r, c, groups, 1e-6, plan['k'], slabs, 132, 7)
    assert args2[2:4] == (s.data_ptr(), s2.data_ptr())
    assert args2[4:10] == (None, None, 0, None, None, None)
    assert args2[10:] == (n, r, c, 1, 0.0, plan['k'], slabs, 132, 7)
    after = ops.launch_counts()
    assert after['gn_stats'] == before['gn_stats'] + 2
    assert after['group_norm'] == before['group_norm']


def test_stats_launcher_hands_bf16_parameters_over_as_they_are(library):
    x = _fake(2, 5, 64)
    scale, bias = torch.randn(64).bfloat16(), torch.randn(64).bfloat16()
    nm._launch_stats(x, (scale, bias, 32, 1e-5))
    (_, args), = library.calls
    assert args[4:7] == (scale.data_ptr(), bias.data_ptr(), 1)


def test_groups_wider_than_the_kernel_takes_run_the_plain_version(library):
    """A group wider than GN_MAX_GROUP channels: the kernel does not take
    it, and group_norm raises on a CUDA tensor (no plain route on the
    card)."""
    x = _fake(2, 3, 2048)
    assert nm.kernel_takes(x) and nm.kernel_takes(x, 2)
    assert not nm.kernel_takes(x, 1)
    with pytest.raises(ValueError):
        nm.group_norm(x, torch.ones(2048), torch.zeros(2048), 1)
    assert library.calls == []


def test_apply_launcher_hands_the_entry_point_its_shape(library):
    x = _fake(4, 33, 320)
    coeffs = [_fake(4, 320) for _ in range(3)]
    before = ops.launch_counts()['group_norm']
    y = nm._launch_apply(x, *coeffs, True)
    nm._launch_apply(x, *coeffs, False)
    (k1, args1), (_, args2) = library.calls
    assert k1 == 'apply' and y.shape == x.shape and y.dtype == x.dtype
    assert args1 == (x.data_ptr(), *(t.data_ptr() for t in coeffs),
                     y.data_ptr(), 4, 33, 320, 6, 1, 132, 7)
    assert args2[-4:-2] == (6, 0)
    assert ops.launch_counts()['group_norm'] == before + 2


def _refusal_case(case):
    base = torch.zeros(3 * 64 + 4, dtype=torch.bfloat16)
    return {
        'cpu': torch.zeros(2, 3, 64, dtype=torch.bfloat16),
        'fp32': _fake(2, 3, 64, dtype=torch.float32),
        'strided': _fake(2, 64, 3).transpose(1, 2),
        'c12': _fake(2, 3, 12),
        'c8200': _fake(1, 2, 8200),
        'misaligned': torch.Tensor._make_subclass(
            _FakeCuda, base[4:].view(1, 3, 64)),
        'two_dims': _fake(3, 64),
    }[case]


@pytest.mark.parametrize('case', ['cpu', 'fp32', 'strided', 'c12', 'c8200',
                                  'misaligned', 'two_dims'])
def test_launchers_refuse_what_the_kernel_does_not_take(library, case):
    x = _refusal_case(case)
    c = x.shape[-1]
    with pytest.raises(ValueError):
        nm._launch_stats(x)
    coeffs = [_fake(x.shape[0], c) for _ in range(3)]
    with pytest.raises(ValueError):
        nm._launch_apply(x, *coeffs, True)
    assert library.calls == []


@pytest.mark.parametrize('grad', [False, True])
@pytest.mark.parametrize('case', ['fp32', 'strided', 'c12', 'c8200',
                                  'misaligned'])
def test_group_norm_and_channel_stats_raise_on_what_the_kernel_does_not_take(
        library, monkeypatch, case, grad):
    """A CUDA tensor K13 does not take: group_norm raises, under grad
    too, and never runs the plain version; channel_stats raises outside
    autograd where its [N, R, C] view is still refused (a strided x is
    copied by the reshape, which the kernel takes)."""
    monkeypatch.setattr(nm, 'group_norm_plain', _refuse)
    x = _refusal_case(case)
    if grad:
        x = torch.Tensor._make_subclass(_FakeCuda, x, True)
    c = x.shape[-1]
    with pytest.raises(ValueError):
        nm.group_norm(x, torch.ones(c), torch.zeros(c), 4)
    if case != 'strided' and not grad:
        with pytest.raises(ValueError):
            nm.channel_stats(x)
    assert library.calls == []


def test_apply_launcher_refuses_coefficients_of_another_shape(library):
    x = _fake(2, 3, 64)
    with pytest.raises(ValueError):
        nm._launch_apply(x, _fake(2, 64), _fake(2, 64),
                         _fake(2, 64, dtype=torch.float32), False)
    with pytest.raises(ValueError):
        nm._launch_apply(x, _fake(2, 64), _fake(1, 64), _fake(2, 64), False)
    assert library.calls == []


def _stub_launchers(monkeypatch, events):
    """K13's launchers replaced by stand-ins that record the call and
    compute what the kernel would from plain expressions."""
    def stats(x3, fold=None):
        events.append(('stats', tuple(x3.shape), fold is not None))
        if fold is None:
            return (torch.sum(x3, 1, dtype=torch.float32),
                    torch.sum(x3.float().square(), 1))
        scale, bias, groups, eps = fold
        n, r, c = x3.shape
        xg = x3.float().reshape(n, r, groups, c // groups)
        mean = xg.mean((1, 3))
        inv = torch.rsqrt(xg.square().mean((1, 3)) - mean.square() + eps)
        rep = lambda t: t.repeat_interleave(c // groups, 1)
        return (rep(mean).to(x3.dtype),
                (rep(inv) * scale.float()).to(x3.dtype),
                bias.to(x3.dtype).expand(n, c).contiguous())

    def apply(x3, mean, a, b, silu):
        events.append(('apply', tuple(x3.shape), silu))
        y = (x3 - mean[:, None]) * a[:, None] + b[:, None]
        return F.silu(y.float()).to(y.dtype) if silu else y
    monkeypatch.setattr(nm, '_launch_stats', stats)
    monkeypatch.setattr(nm, '_launch_apply', apply)


def test_apply_launcher_opens_the_kernel_range(library):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        nm._launch_apply(_fake(2, 5, 320), *(_fake(2, 320) for _ in
                                             range(3)), True)
    names = [e.name for e in prof.events() if e.name.startswith('kernel.')]
    assert names == ['kernel.K13']


# ------------------------------------- launches from the full-depth models

@pytest.fixture
def recorded(monkeypatch):
    """K13's launches by shape while on: the models' group_norm and
    channel_stats run as on the card, each input seen as a CUDA tensor (on
    the autograd graph) and the outputs handed back as plain tensors; the
    kernel's conditions but the device and dtype (the models run in fp32 on
    the CPU), the launchers replaced by the stand-ins. The statistics that
    the plain versions of K6, K7 and K8 take of their own outputs on the
    CPU are left out: those kernels emit them on the card. K5 runs as on
    the card too, through its recompute Function under grad, its launcher
    replaced by the plain version on the host tensors (whose output
    statistics stay on the host): it takes its input's statistics itself,
    in the Function's forward, where grad is off."""
    from star_tpu_torch.models import layers
    from star_tpu_torch.models.unet import blocks
    from star_tpu_torch.ops import fused_temporal_conv, upsample_conv
    from star_tpu_torch.vae import svd_vae
    events = []
    _stub_launchers(monkeypatch, events)
    real_stats = nm._launch_stats

    def stats(x3, fold=None):
        # frame 1 is channel_stats, frame 2 its stand-in below, frame 3
        # the function that called it (K6-K8's plain versions)
        if (fold is None
                and sys._getframe(3).f_code.co_name.endswith('_plain')):
            return (torch.sum(x3, 1, dtype=torch.float32),
                    torch.sum(x3.float().square(), 1))
        return real_stats(x3, fold)
    monkeypatch.setattr(nm, '_launch_stats', stats)

    def on_card(fn):
        back = lambda t: t.as_subclass(torch.Tensor)

        def call(x, *a, **k):
            out = fn(x.as_subclass(_FakeCuda), *a, **k)
            return tuple(map(back, out)) if isinstance(out, tuple) \
                else back(out)
        return call
    for mod in (layers, blocks):
        monkeypatch.setattr(mod, 'group_norm', on_card(nm.group_norm))
    tconv3_plain = fused_temporal_conv.tconv3_plain

    def tconv_launch(*a):
        y, st = tconv3_plain(*(t.as_subclass(torch.Tensor)
                               if isinstance(t, torch.Tensor) else t
                               for t in a))
        return y.as_subclass(_FakeCuda), st
    monkeypatch.setattr(fused_temporal_conv, '_launch', tconv_launch)
    k5 = fused_temporal_conv.fused_gn_silu_tconv3

    def k5_on_card(x, *a, **k):
        y, st = k5(x.as_subclass(_FakeCuda), *a, **k)
        return y.as_subclass(torch.Tensor), st
    for mod in (blocks, svd_vae):
        monkeypatch.setattr(mod, 'fused_gn_silu_tconv3', k5_on_card)
    stats_on_card = on_card(nm.channel_stats)
    for mod in (nm, upsample_conv, svd_vae):
        monkeypatch.setattr(mod, 'channel_stats', stats_on_card)
    monkeypatch.setattr(nm, 'kernel_takes', lambda x, num_groups=None: (
        x.ndim >= 2 and x.shape[-1] % 8 == 0
        and (num_groups is None or x.shape[-1] % num_groups == 0)))
    return events


def _table(events, kind, rows, widths, with_silu=True):
    got = {}
    for ev in events:
        if ev[0] != kind:
            continue
        n, r, c = ev[1]
        key = (n, rows(n, r), widths[c])
        if with_silu:
            key += (ev[2],)
        got[key] = got.get(key, 0) + 1
    return got


def test_launches_per_shape_from_the_full_depth_models(recorded):
    """The full-depth UNet+ControlNet at narrow widths (32 channels for
    320, tokens 18x24 for 90x160) and the causal-VAE encoder (32 channels
    for 128, 25 frames of 16x24 for 480x720), every K13 launch recorded and
    mapped to full size: chip_smoke.py's tables of a CFG call (113
    GroupNorms, 32 statistics alone), of an encode (29) and of a decode
    window (37); the SVD VAE's encode and decoder calls; a remat train
    step's UNet+ControlNet."""
    from star_tpu_torch.models.unet.unet import ControlledV2VUNet
    from star_tpu_torch.vae import svd_vae
    from star_tpu_torch.vae.causal_vae import CausalEncoder3D
    torch.manual_seed(0)
    unet = ControlledV2VUNet(dim=32, head_dim=16, num_heads_init_temporal=2,
                             context_dim=16).eval()
    x, hint = torch.randn(1, 8, 18, 24, 4), torch.randn(1, 8, 18, 24, 4)
    with torch.no_grad():
        unet(x, torch.tensor([500]), torch.randn(2, 77, 16), hint,
             cfg_pair=True)
    tokens = {432: 14400, 120: 3600, 36: 920, 12: 240}
    # per frame (N frames of a level's tokens) or per video (8 frames)
    rows = lambda n, r: tokens[r] if r in tokens else 8 * tokens[r // 8]
    widths = {c: 10 * c for c in (32, 64, 96, 128, 192, 256)}
    applies = [e for e in recorded if e[0] == 'apply']
    folds = [e for e in recorded if e[0] == 'stats' and e[2]]
    alone = [e for e in recorded if e[0] == 'stats' and not e[2]]
    assert _table(applies, 'apply', rows, widths) == cs.GN_PER_CFG_CALL
    assert len(folds) == len(applies) == 113
    assert _table(alone, 'stats', rows, widths, False) == \
        cs.GN_STATS_PER_CFG_CALL
    assert cs.GN_PER_CFG_STEP == {'group_norm': 113, 'gn_stats': 145}
    assert {s[:3] for s in cs.GN_TIMED_SHAPES} <= {
        k[:3] for k in cs.GN_PER_CFG_CALL} | {
        (1, r, c) for r, c in cs.GN_PER_CAUSAL_ENCODE}

    recorded.clear()
    enc = CausalEncoder3D(ch=32).eval()
    with torch.no_grad():
        enc(torch.randn(1, 25, 16, 24, 3))
    assert all(e[1][0] == 1 and e[2] for e in recorded)
    got = {}
    for e in recorded:
        if e[0] == 'apply':
            key = (e[1][1] * 900, 4 * e[1][2])
            got[key] = got.get(key, 0) + 1
    assert got == cs.GN_PER_CAUSAL_ENCODE
    assert len(recorded) == 2 * 29 == 2 * sum(got.values())
    assert cs.GN_PER_COG_TRAIN_STEP == {'group_norm': 58, 'gn_stats': 58}
    from star_tpu_torch.vae.causal_vae import CogVideoVAE
    vae3d = CogVideoVAE(ch=32).eval()
    recorded.clear()
    with torch.no_grad():
        vae3d.decode_window(torch.randn(1, 3, 2, 3, 16), {}, True)
    assert [e[2] for e in recorded if e[0] == 'apply'] == \
        [False] * cs.GN_PER_DECODE_WINDOW
    assert len(recorded) == 2 * cs.GN_PER_DECODE_WINDOW
    assert cs.cog_gn_launches(1, 3) == {'group_norm': 140, 'gn_stats': 140}

    vae = svd_vae.SVDTemporalVAE((32, 64, 128, 128)).eval()
    for call, want in ((lambda: vae.encode_moments(
            torch.rand(1, 8, 32, 32, 3)), cs.GN_PER_VAE_ENCODE),
            (lambda: vae.decode(torch.randn(1, 8, 4, 4, 4)),
             {k: 2 * v for k, v in cs.GN_PER_DECODE_CALL.items()})):
        recorded.clear()
        with torch.no_grad():
            call()
        assert {'group_norm': sum(e[0] == 'apply' for e in recorded),
                'gn_stats': sum(e[0] == 'stats' for e in recorded)} == want

    recorded.clear()
    train = ControlledV2VUNet(dim=32, head_dim=16, num_heads_init_temporal=2,
                              context_dim=16, remat=True).train()
    out = train(x, torch.tensor([500]), torch.randn(1, 77, 16), hint)
    out.float().sum().backward()
    assert {'group_norm': sum(e[0] == 'apply' for e in recorded),
            'gn_stats': sum(e[0] == 'stats' for e in recorded)} == \
        cs.GN_PER_TRAIN_UNET == {'group_norm': 225, 'gn_stats': 289}


# ------------------------------------------------------------------ card

def _card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')


_CARD_SHAPES = sorted({k[:3] + (True,) for k in cs.GN_PER_CFG_CALL}
                      | {(1, r, c, True) for r, c in cs.GN_PER_CAUSAL_ENCODE}
                      | {(3, 1001, 8, False), (2, 77, 40, False),
                         (5, 3, 2560, True)})


@pytest.mark.cuda
@pytest.mark.parametrize('n,r,c,silu', _CARD_SHAPES)
def test_apply_is_the_eager_passes_bit_for_bit_on_the_card(n, r, c, silu):
    """Given the same coefficients, K13's apply is the eager bf16 passes and
    silu32 bit for bit, at every UNet and causal-VAE shape."""
    _card()
    g = torch.Generator(device='cuda').manual_seed(n * r + c)
    x, scale, bias = cs.gn_inputs(n, r, c, 'cuda', g)
    groups = 32 if c % 32 == 0 else c // 8
    coeffs = nm._launch_stats(x, (scale, bias, groups, 1e-6))
    for s in (False, True) if silu else (False,):
        out = nm._launch_apply(x, *coeffs, s)
        assert torch.equal(out, cs.gn_apply_eager(x, *coeffs, s))


@pytest.mark.cuda
@pytest.mark.parametrize('n,r,c', [(16, 14400, 320), (1, 8640000, 128),
                                   (16, 920, 2560), (3, 1001, 8)])
def test_statistics_and_the_whole_group_norm_on_the_card(n, r, c):
    """The statistics against float64 sums to 1e-6; the whole
    group_norm(silu=True) against the plain version within chip_smoke's
    GN_DIFF_SHARE of values, each within GN_DIFF_ULPS of its own value;
    two runs bit for bit."""
    _card()
    g = torch.Generator(device='cuda').manual_seed(r + c)
    x, scale, bias = cs.gn_inputs(n, r, c, 'cuda', g)
    groups = 32 if c % 32 == 0 else 1
    assert cs.gn_stats_err(x, nm.channel_stats(x)) <= 1e-6
    out = nm.group_norm(x, scale, bias, groups, 1e-6, silu=True)
    ref = nm.group_norm_plain(x, scale, bias, groups, 1e-6, silu=True)
    n_diff, ulps = cs.gn_ulps(out, ref)
    assert n_diff <= cs.GN_DIFF_SHARE * out.numel(), n_diff
    assert ulps <= cs.GN_DIFF_ULPS, ulps
    assert torch.equal(out, nm.group_norm(x, scale, bias, groups, 1e-6,
                                          silu=True))


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['fp32', 'strided', 'c12'])
def test_launchers_and_group_norm_raise_on_the_card(case):
    _card()
    x = {'fp32': torch.zeros(2, 3, 64, device='cuda'),
         'strided': torch.zeros(2, 64, 3, dtype=torch.bfloat16,
                                device='cuda').transpose(1, 2),
         'c12': torch.zeros(2, 3, 12, dtype=torch.bfloat16, device='cuda'),
         }[case]
    before = ops.launch_counts()
    with pytest.raises(ValueError):
        nm._launch_stats(x)
    with pytest.raises(ValueError):
        nm.group_norm(x, torch.ones(x.shape[-1], device='cuda'),
                      torch.zeros(x.shape[-1], device='cuda'), 4)
    assert ops.launch_counts() == before
