"""K1's launch arithmetic (csrc/flash_fwd_sm90.cu, the d=64 forward on wgmma
fed by TMA), held on the CPU through `k1_launch_plan`: the 3-D tensor maps
over the natural [B, S, H*64] layout (dims and boxes innermost first,
strides in bytes), the grid of 128-row query blocks, the live key tiles
ceil(kv_valid / 128), kv_valid clipped to S, and the refusals of what the
kernel does not take; and that `_launch` hands the C entry point what the
plan says. The `cuda` cases hold the kernel against its plain version at
the edges of its tiles on a card (python -m pytest
tests/test_torch_flash_sm90.py -m cuda --noconftest); they skip here.

Agreement on the card is chip_smoke.py's: max error within 2e-2 of the
plain output's largest magnitude and RMS error within 1e-2 of its RMS,
relative with no floor; the lse within 1e-3 in natural-log units.
"""

import math

import pytest
import torch

from star_tpu_torch import ops
from star_tpu_torch.ops import _build, flash_attention as fa

# (B, S, H*64, kv_valid or None, prescaled): S not a multiple of 128, S
# below one tile, kv_valid inside a tile and on a tile boundary, 5 to 48
# heads, the DiT's 9680 tokens with its dead tail
EDGE_CASES = [(2, 1000, 320, 777, False), (2, 1000, 320, 768, False),
              (2, 100, 320, None, False), (2, 1000, 640, None, True),
              (2, 1000, 1280, 999, False), (1, 1000, 3072, 777, True),
              (1, 9680, 320, 9676, True)]


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_plan_at_the_dit_shape():
    """q/k/v [2, 9680, 3072], 48 heads, kv_valid 9676: maps of
    {3072, rows, 2} with 6144-byte rows, K/V ending at the live keys, boxes
    of 64 columns (one 128-byte swizzled row) by 128 rows (64 for O, one
    consumer warpgroup's rows), 76 query blocks for each of 96 heads."""
    plan = fa.k1_launch_plan(2, 48, 9680, 9680, 9676)
    pitch, batch = 3072 * 2, 9680 * 3072 * 2
    assert plan['q'] == dict(dims=(3072, 9680, 2), strides=(pitch, batch),
                             box=(64, 128, 1))
    for t in 'kv':
        assert plan[t] == dict(dims=(3072, 9676, 2), strides=(pitch, batch),
                               box=(64, 128, 1))
    assert plan['o'] == dict(dims=(3072, 9680, 2), strides=(pitch, batch),
                             box=(64, 64, 1))
    assert plan['grid'] == (76, 96) and plan['threads'] == 384
    assert plan['kv_valid'] == 9676 and plan['live_tiles'] == 76


@pytest.mark.parametrize('s,kv,tiles', [
    (1000, 777, 7), (1000, 768, 6), (100, 100, 1), (14400, 14400, 113),
    (3680, 3680, 29), (960, 960, 8), (128, 128, 1), (129, 129, 2),
    (1000, 1, 1)])
def test_plan_live_key_tiles(s, kv, tiles):
    plan = fa.k1_launch_plan(2, 5, s, s, kv)
    assert plan['live_tiles'] == tiles == math.ceil(kv / 128)
    assert plan['kv_valid'] == kv
    assert plan['k']['dims'][1] == plan['v']['dims'][1] == kv
    assert plan['q']['dims'][1] == plan['o']['dims'][1] == s


@pytest.mark.parametrize('kv', [1001, 5000])
def test_plan_clips_kv_valid_to_the_keys(kv):
    plan = fa.k1_launch_plan(1, 5, 700, 1000, kv)
    assert plan['kv_valid'] == 1000 and plan['live_tiles'] == 8
    assert plan['k']['dims'] == (320, 1000, 1)
    assert plan['k']['strides'] == (640, 1000 * 640)   # Sk rows a batch
    assert plan['q']['strides'] == (640, 700 * 640)


@pytest.mark.parametrize('bsz,heads,s', [(16, 5, 14400), (16, 10, 3680),
                                         (16, 20, 960), (2, 48, 9680),
                                         (2, 5, 100)])
def test_plan_grid(bsz, heads, s):
    plan = fa.k1_launch_plan(bsz, heads, s, s, s)
    assert plan['grid'] == (math.ceil(s / 128), bsz * heads)
    assert plan['q']['dims'] == (heads * 64, s, bsz)


@pytest.mark.parametrize('case', ['head_dim_32', 'head_dim_128',
                                  'pitch_not_16', 'row_too_short',
                                  'no_live_keys', 'too_many_heads',
                                  'empty_batch'])
def test_plan_refuses_what_the_kernel_does_not_take(case):
    args = dict(bsz=2, heads=5, sq=100, sk=100, kv_valid=100)
    args.update({
        'head_dim_32': dict(head_dim=32), 'head_dim_128': dict(head_dim=128),
        'pitch_not_16': dict(row_stride=5 * 64 + 4),     # 648-byte rows
        'row_too_short': dict(row_stride=5 * 64 - 8),
        'no_live_keys': dict(kv_valid=0),
        'too_many_heads': dict(bsz=2048, heads=48),
        'empty_batch': dict(bsz=0)}[case])
    with pytest.raises(ValueError):
        fa.k1_launch_plan(**args)


def test_plan_takes_a_padded_row_pitch():
    """A row stride above H*64 whose pitch is a multiple of 16 bytes is
    taken: the maps keep H*64 columns and stride by the pitch."""
    plan = fa.k1_launch_plan(1, 5, 100, 100, 100, row_stride=5 * 64 + 8)
    assert plan['q']['dims'] == (320, 100, 1)
    assert plan['q']['strides'] == (656, 100 * 656)


class _FakeCuda(torch.Tensor):
    @property
    def is_cuda(self):
        return True


class _Recorder:
    def __init__(self):
        self.calls = []

    def star_flash_fwd_d64(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize('kv,want_lse', [(5000, False), (777, True)])
def test_launch_passes_the_plan_to_the_entry_point(monkeypatch, kv,
                                                   want_lse):
    """`_launch` refuses through the plan and hands star_flash_fwd_d64 the
    clipped kv_valid, the packed strides, c and (with_l) an lse of
    [B, H, Sq] fp32."""
    rec = _Recorder()
    monkeypatch.setattr(_build, 'lib', lambda: rec)
    monkeypatch.setattr(_build, 'stream_ptr', lambda device: 0)
    fake = lambda *s: torch.Tensor._make_subclass(
        _FakeCuda, torch.zeros(*s, dtype=torch.bfloat16))
    q, k, v = fake(2, 700, 320), fake(2, 1000, 320), fake(2, 1000, 320)
    name = 'flash_packed_lse' if want_lse else 'flash_packed'
    before = ops.launch_counts()[name]
    res = fa._launch(q, k, v, 5, 64, 0.5, kv, want_lse=want_lse)
    (args,) = rec.calls
    assert args[5:10] == (2, 5, 700, 1000, min(kv, 1000))
    assert args[10:19] == (700 * 320, 1000 * 320, 1000 * 320, 700 * 320,
                           320, 320, 320, 320, 0.5)
    if want_lse:
        out, lse = res
        assert lse.shape == (2, 5, 700) and lse.dtype == torch.float32
        assert args[4] == lse.data_ptr()
    else:
        out = res
        assert args[4] is None
    assert ops.launch_counts()[name] == before + 1
    assert out.shape == q.shape and args[3] == out.data_ptr()
    with pytest.raises(ValueError):      # kv_valid 0: the plan refuses
        fa._launch(q, k, v, 5, 64, 0.5, 0)
    assert len(rec.calls) == 1


@pytest.mark.cuda
@pytest.mark.parametrize('bsz,s,c,kv,pre', EDGE_CASES)
def test_k1_edges_on_the_card(bsz, s, c, kv, pre):
    """K1 and its `with_l` mode against their plain versions at the edges
    of the 128 x 128 tiles; a CUDA tensor never falls back."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    g = torch.Generator(device='cuda').manual_seed(s + c)
    bf = lambda: torch.randn(bsz, s, c, generator=g,
                             device='cuda').bfloat16()
    q, k, v = bf(), bf(), bf()
    if pre:
        q = (q.float() * (0.125 * fa.LOG2E)).bfloat16()
    h = c // 64

    def agree(a, b):
        a, b = a.float(), b.float()
        return bool((a - b).abs().max() <= 2e-2 * b.abs().max()
                    and (a - b).norm() <= 1e-2 * b.norm())
    before = ops.launch_counts()['flash_packed']
    out = fa.flash_attention_packed(q, k, v, h, kv_valid=kv, prescaled=pre)
    assert ops.launch_counts()['flash_packed'] == before + 1
    ref = fa.flash_attention_packed_plain(q, k, v, h, 0.125, kv, pre)
    assert agree(out, ref)
    out, lse = fa._launch(q, k, v, h, 64, 1.0 if pre else 0.125 * fa.LOG2E,
                          s if kv is None else kv, want_lse=True)
    ref, lse_ref = fa.flash_attention_packed_plain(q, k, v, h, 0.125, kv,
                                                   pre, return_lse=True)
    assert agree(out, ref)
    assert float((lse - lse_ref).abs().max()) <= 1e-3


@pytest.mark.cuda
def test_k1_refuses_on_the_card():
    """A misaligned or odd-width CUDA input raises; it never reaches the
    plain version."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    q = torch.zeros(1, 64, 328, device='cuda', dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention_packed(q, q, q, 4)           # head_dim 82
    base = torch.zeros(1 * 64 * 320 + 4, device='cuda', dtype=torch.bfloat16)
    q = base[4:].view(1, 64, 320)                       # 8-byte offset
    with pytest.raises(ValueError):
        fa.flash_attention_packed(q, q, q, 5)

