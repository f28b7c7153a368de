"""The launch arithmetic of K3 (csrc/flash_bwd_sm90.cu, the d=64 backward)
and of K2 at d=512 (csrc/flash_fwd_d512_sm90.cu), both wgmma kernels fed by
TMA, held on the CPU through `k3_launch_plan` and `d512_launch_plan`: the
3-D tensor maps over the natural [B, S, H*D] layout (dims and boxes
innermost first, strides in bytes), the grids, K3's query tiles and
workspace, the live key tiles, kv_valid clipped to the keys, and the
refusals of what the kernels do not take; and that `_launch_bwd` and
`_launch` hand the C entry points what the plans say. The `cuda` cases
hold both kernels against their plain versions at the edges of their
tiles on a card (python -m pytest tests/test_torch_flash_bwd_sm90.py -m
cuda --noconftest); they skip here.

Agreement on the card is chip_smoke.py's: max error within 2e-2 of the
plain output's largest magnitude and RMS error within 1e-2 of its RMS,
relative with no floor.
"""

import math

import pytest
import torch

from star_tpu_torch.ops import _build, flash_attention as fa


def _bwd_workspace(bh, sq):
    tiles = math.ceil(sq / 64)
    return 4 * (bh * tiles * 64 * 66 + bh * tiles)


# (B, S, H): the train step's three attention scales (8 frames), the DiT's
@pytest.mark.parametrize('bsz,s,heads', [(8, 14400, 5), (8, 3680, 10),
                                         (8, 960, 20), (2, 9680, 48)])
def test_k3_plan_at_main_path_shapes(bsz, s, heads):
    plan = fa.k3_launch_plan(bsz, heads, s, s, s)
    pitch, batch = heads * 64 * 2, s * heads * 64 * 2
    for t in ('q', 'do'):
        assert plan[t] == dict(dims=(heads * 64, s, bsz),
                               strides=(pitch, batch), box=(64, 64, 1))
    for t in ('k', 'v'):
        assert plan[t] == dict(dims=(heads * 64, s, bsz),
                               strides=(pitch, batch), box=(64, 128, 1))
    assert plan['grid'] == (math.ceil(s / 128), bsz * heads)
    assert plan['threads'] == 384
    assert plan['query_tiles'] == math.ceil(s / 64)
    assert plan['sq_pad'] == plan['query_tiles'] * 64
    assert plan['workspace_bytes'] == _bwd_workspace(bsz * heads, s)
    assert plan['live_tiles'] == plan['grid'][0] == math.ceil(s / 128)


def test_k3_plan_at_the_dit_dead_tail():
    """[2, 9680, 3072], 48 heads, kv_valid 9676: the K/V maps end at the
    live keys (rows past them read as zero), 76 key blocks; the query side
    keeps all 9680 rows in 152 tiles of 64 (no padding)."""
    plan = fa.k3_launch_plan(2, 48, 9680, 9680, 9676)
    assert plan['k']['dims'] == plan['v']['dims'] == (3072, 9676, 2)
    assert plan['k']['strides'] == (6144, 9680 * 6144)
    assert plan['q']['dims'] == (3072, 9680, 2)
    assert plan['grid'] == (76, 96) and plan['kv_valid'] == 9676
    assert plan['query_tiles'] == 152 and plan['sq_pad'] == 9728


@pytest.mark.parametrize('sq,sk,kv,tiles,blocks', [
    (1000, 1000, 777, 16, 7), (1000, 1000, 768, 16, 6), (100, 100, 100, 2, 1),
    (64, 64, 64, 1, 1), (65, 65, 65, 2, 1), (1000, 1000, 1, 16, 1),
    (700, 1000, 5000, 11, 8)])
def test_k3_plan_tiles_and_kv_clipping(sq, sk, kv, tiles, blocks):
    plan = fa.k3_launch_plan(2, 5, sq, sk, kv)
    live = min(kv, sk)
    assert plan['kv_valid'] == live
    assert plan['query_tiles'] == tiles and plan['sq_pad'] == 64 * tiles
    assert plan['grid'] == (blocks, 10) and plan['live_tiles'] == blocks
    assert plan['k']['dims'][1] == plan['v']['dims'][1] == live
    assert plan['k']['strides'][1] == sk * 640      # Sk rows a batch
    assert plan['q']['dims'][1] == plan['do']['dims'][1] == sq
    assert plan['workspace_bytes'] == _bwd_workspace(10, sq)


@pytest.mark.parametrize('case', ['head_dim_32', 'head_dim_128',
                                  'no_live_keys', 'too_many_heads',
                                  'empty_batch', 'empty_query'])
def test_k3_plan_refuses_what_the_kernel_does_not_take(case):
    args = dict(bsz=2, heads=5, sq=100, sk=100, kv_valid=100)
    args.update({
        'head_dim_32': dict(head_dim=32), 'head_dim_128': dict(head_dim=128),
        'no_live_keys': dict(kv_valid=0),
        'too_many_heads': dict(bsz=2048, heads=48),
        'empty_batch': dict(bsz=0), 'empty_query': dict(sq=0)}[case])
    with pytest.raises(ValueError):
        fa.k3_launch_plan(**args)


# (B, S): the VAE encoder's 8 frames, the decoder's two 3-frame windows
# folded together and its last 2 frames, phase 2b's small VAE
@pytest.mark.parametrize('bsz,s', [(8, 14400), (6, 14400), (2, 14400),
                                   (3, 576)])
def test_d512_plan_at_main_path_shapes(bsz, s):
    plan = fa.d512_launch_plan(bsz, 1, s, s, s)
    pitch, batch = 1024, s * 1024
    assert plan['q'] == dict(dims=(512, s, bsz), strides=(pitch, batch),
                             box=(64, 64, 1))
    for t in ('k', 'v'):
        assert plan[t] == dict(dims=(512, s, bsz), strides=(pitch, batch),
                               box=(64, 32, 1))
    assert plan['panels'] == 8 and plan['threads'] == 384
    assert plan['grid'] == (math.ceil(s / 64), bsz)
    assert plan['live_tiles'] == math.ceil(s / 32) and plan['kv_valid'] == s


@pytest.mark.parametrize('sq,sk,kv,tiles', [
    (1000, 1000, 777, 25), (1000, 1000, 768, 24), (20, 20, 20, 1),
    (1000, 800, 5000, 25), (33, 33, 33, 2)])
def test_d512_plan_live_tiles_and_kv_clipping(sq, sk, kv, tiles):
    plan = fa.d512_launch_plan(2, 1, sq, sk, kv)
    assert plan['kv_valid'] == min(kv, sk) and plan['live_tiles'] == tiles
    assert plan['k']['dims'] == (512, min(kv, sk), 2)
    assert plan['k']['strides'] == (1024, sk * 1024)
    assert plan['q']['dims'] == (512, sq, 2)
    assert plan['grid'] == (math.ceil(sq / 64), 2)


@pytest.mark.parametrize('case', ['head_dim_64', 'no_live_keys',
                                  'too_many_heads', 'empty_batch',
                                  'row_too_short', 'pitch_not_16'])
def test_d512_plan_refuses_what_the_kernel_does_not_take(case):
    args = dict(bsz=2, heads=1, sq=100, sk=100, kv_valid=100)
    args.update({
        'head_dim_64': dict(head_dim=64), 'no_live_keys': dict(kv_valid=0),
        'too_many_heads': dict(bsz=65536), 'empty_batch': dict(bsz=0),
        'row_too_short': dict(row_stride=504),
        'pitch_not_16': dict(row_stride=516)}[case])
    with pytest.raises(ValueError):
        fa.d512_launch_plan(**args)


class _FakeCuda(torch.Tensor):
    @property
    def is_cuda(self):
        return True


class _Recorder:
    def __init__(self):
        self.calls = []

    def star_flash_bwd_d64(self, *args):
        self.calls.append(args)
        return 0

    def star_flash_fwd_d512(self, *args):
        self.calls.append(args)
        return 0


def _fake(*shape, dtype=torch.bfloat16):
    return torch.Tensor._make_subclass(_FakeCuda,
                                       torch.ones(*shape, dtype=dtype))


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(_build, 'lib', lambda: rec)
    monkeypatch.setattr(_build, 'stream_ptr', lambda device: 0)
    return rec


@pytest.mark.parametrize('kv', [777, 1000, 5000])
def test_launch_bwd_passes_the_plan_to_the_entry_point(recorder, kv):
    """`_launch_bwd` hands star_flash_bwd_d64 the clipped kv_valid, the
    packed strides, the scale and a workspace of the plan's size; dk/dv
    rows past the live keys are zero (the kernel writes the live rows)."""
    q, o, do = (_fake(2, 700, 320) for _ in range(3))
    k, v = _fake(2, 1000, 320), _fake(2, 1000, 320)
    lse = _fake(2, 5, 700, dtype=torch.float32)
    before = fa.BWD_LAUNCHES
    dq, dk, dv = fa._launch_bwd(q, k, v, o, lse, do, 5, 0.125, kv)
    (args,) = recorder.calls
    live = min(kv, 1000)
    assert args[10:15] == (2, 5, 700, 1000, live)
    assert args[15:19] == (700 * 320, 1000 * 320, 320, 0.125)
    assert (args[6], args[7], args[8]) == (dq.data_ptr(), dk.data_ptr(),
                                           dv.data_ptr())
    assert fa.BWD_LAUNCHES == before + 1
    assert dq.shape == q.shape and dk.shape == k.shape
    for t in (dk, dv):
        assert float(t[:, live:].abs().sum()) == 0.0


def test_launch_bwd_allocates_the_plans_workspace(recorder, monkeypatch):
    sizes = []
    real_empty = torch.empty

    def empty(*shape, **kw):
        if kw.get('dtype') is torch.uint8:
            sizes.append(shape[0])
        return real_empty(*shape, **kw)
    monkeypatch.setattr(torch, 'empty', empty)
    q, o, do, k, v = (_fake(3, 130, 640) for _ in range(5))
    lse = _fake(3, 10, 130, dtype=torch.float32)
    fa._launch_bwd(q, k, v, o, lse, do, 10, 0.125, 130)
    assert sizes == [fa.k3_launch_plan(3, 10, 130, 130,
                                       130)['workspace_bytes']]
    assert sizes[0] == _bwd_workspace(30, 130)


def test_launch_bwd_refuses_through_the_plan(recorder):
    q, o, do, k, v = (_fake(1, 64, 320) for _ in range(5))
    lse = _fake(1, 5, 64, dtype=torch.float32)
    with pytest.raises(ValueError):          # kv_valid 0: no live keys
        fa._launch_bwd(q, k, v, o, lse, do, 5, 0.125, 0)
    with pytest.raises(ValueError):          # head_dim 32
        fa._launch_bwd(q, k, v, o, lse, do, 10, 0.125, 64)
    assert recorder.calls == []


@pytest.mark.parametrize('kv', [777, 5000])
def test_launch_d512_passes_the_plan_to_the_entry_point(recorder, kv):
    """`_launch` at d=512 hands star_flash_fwd_d512 the clipped kv_valid,
    the strides of [B, S, 1, 512] and c, and counts one d=512 launch."""
    q = _fake(2, 700, 1, 512)
    k, v = _fake(2, 1000, 1, 512), _fake(2, 1000, 1, 512)
    before = fa.D512_LAUNCHES
    out = fa._launch(q, k, v, 1, 512, 0.25, kv)
    (args,) = recorder.calls
    assert args[4:9] == (2, 1, 700, 1000, min(kv, 1000))
    assert args[9:18] == (700 * 512, 1000 * 512, 1000 * 512, 700 * 512,
                          512, 512, 512, 512, 0.25)
    assert args[3] == out.data_ptr() and out.shape == q.shape
    assert fa.D512_LAUNCHES == before + 1
    with pytest.raises(ValueError):          # kv_valid 0: the plan refuses
        fa._launch(q, k, v, 1, 512, 0.25, 0)
    assert len(recorder.calls) == 1


def _agree(a, b):
    a, b = a.float(), b.float()
    return bool((a - b).abs().max() <= 2e-2 * b.abs().max()
                and (a - b).norm() <= 1e-2 * b.norm())


# (B, S, H*64, kv_valid): ragged S (not a multiple of the 64-row query
# tile), S below one tile, kv_valid in the last 128-key tile, B*H = 65535
K3_EDGES = [(2, 1000, 320, 1000), (1, 50, 128, 50), (2, 1000, 320, 995),
            (13107, 64, 320, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize('bsz,s,c,kv', K3_EDGES)
def test_k3_edges_on_the_card(bsz, s, c, kv):
    """K3 against flash_bwd_plain at the edges of its tiles; dead dk/dv
    rows exactly zero; a CUDA tensor never falls back."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    g = torch.Generator(device='cuda').manual_seed(s + c + kv)
    bf = lambda n: torch.randn(bsz, n, c, generator=g,
                               device='cuda').bfloat16()
    q, do, k, v = bf(s), bf(s), bf(s), bf(s)
    h = c // 64
    o, lse = fa._launch(q, k, v, h, 64, 0.125 * fa.LOG2E, kv, want_lse=True)
    before = fa.BWD_LAUNCHES
    got = fa._launch_bwd(q, k, v, o, lse, do, h, 0.125, kv)
    assert fa.BWD_LAUNCHES == before + 1
    want = fa.flash_bwd_plain(q, k[:, :kv], v[:, :kv], o, lse, do, h, 0.125)
    assert _agree(got[0], want[0])
    for g_, w_ in zip(got[1:], want[1:]):
        assert _agree(g_[:, :kv], w_)
        if kv < s:
            assert float(g_[:, kv:].abs().max()) == 0.0


# (B, S, kv_valid): ragged S with a dead key tail, S below one tile, B at
# the grid's limit
D512_EDGES = [(2, 1000, 777), (3, 20, 20), (65535, 8, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize('bsz,s,kv', D512_EDGES)
def test_d512_edges_on_the_card(bsz, s, kv):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    g = torch.Generator(device='cuda').manual_seed(s + kv)
    q, k, v = (torch.randn(bsz, s, 1, 512, generator=g,
                           device='cuda').bfloat16() for _ in range(3))
    before = fa.D512_LAUNCHES
    out = fa._launch(q, k, v, 1, 512, fa.LOG2E / math.sqrt(512), kv)
    assert fa.D512_LAUNCHES == before + 1
    ref = fa.attention_plain(q, k[:, :kv], v[:, :kv], 1 / math.sqrt(512))
    assert _agree(out, ref)
