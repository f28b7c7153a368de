"""The launch arithmetic of K5 (csrc/fused_tconv3_sm90.cu, fused GN + SiLU
+ (3,1,1) temporal conv) and K6 (csrc/conv3x3_sm90.cu, fused GN + SiLU +
3x3 conv), both wgmma kernels fed by TMA, held on the CPU:

  * `tconv3_launch_plan` and `conv3x3_launch_plan` at the main paths'
    shapes: tensor maps (dims and boxes innermost first, strides in
    bytes), P, FT and NW, the grid, threads and shared memory, and the
    refusals of what the kernels do not take;
  * an emulation of each kernel's tile schedule, in torch, that gathers
    every tile's operand by the plan's index arithmetic (K5: the slab of
    FT + 2 frames from f0 - 1, zeros over the frames outside [0, F) after
    the activation, taps at slab rows 0, P and 2P, pixel tails, rows
    grouped by P for per-frame statistics; K6: the 18x18 halo in the
    plain core-matrix layout, each tap's A operand walked from the
    plan's descriptor bytes), with NaN in every byte a tile must not
    read, against the plain versions;
  * that `_launch` hands the C entry points what the plans say;
  * `cuda` cases at the edges of the tiles, which skip here (on a card:
    python -m pytest tests/test_torch_conv_sm90.py -m cuda --noconftest).
"""

import math

import pytest
import torch
import torch.nn.functional as F

import chip_smoke as cs
from star_tpu_torch.ops import _build, conv3x3 as c3
from star_tpu_torch.ops import fused_temporal_conv as ftc


# K5 on the main paths: the UNet's four levels (CFG pair, 8 frames), the
# train step's batch of 1, the VAE decoder's windows of 3 frames (two
# folded into the batch) and its tail window of 2
K5_SHAPES = [(2, 8, 14400, 320, 320), (2, 8, 3600, 640, 640),
             (2, 8, 920, 1280, 1280), (2, 8, 240, 1280, 1280),
             (1, 8, 14400, 320, 320), (2, 3, 921600, 128, 128),
             (1, 2, 921600, 128, 128), (2, 3, 5000, 512, 512)]


@pytest.mark.parametrize('bsz,f,n,c,cout', K5_SHAPES)
def test_k5_plan_at_main_path_shapes(bsz, f, n, c, cout):
    plan = ftc.tconv3_launch_plan(bsz, f, n, c, cout)
    p, ft, nw = plan['p'], plan['ft'], plan['nw']
    assert p % 8 == 0 and ft * p <= 128 and ft == min(f, 16)
    assert (p, ft) == {8: (16, 8), 3: (40, 3), 2: (64, 2)}[f]
    assert nw == {320: 160, 640: 160, 1280: 128, 128: 64, 512: 128}[cout]
    assert cout % (2 * nw) == 0          # no ragged column tile here
    assert plan['x'] == dict(dims=(c, n, f, bsz),
                             strides=(2 * c, 2 * n * c, 2 * f * n * c),
                             box=(64, p, ft + 2, 1), swizzle=128)
    assert plan['w'] == dict(dims=(c, cout, 3),
                             strides=(2 * c, 2 * cout * c),
                             box=(64, nw, 1), swizzle=128)
    bw = 64 if nw % 64 == 0 else 32 if nw % 32 == 0 else 16
    assert nw % bw == 0
    assert plan['out'] == plan['res'] == dict(
        dims=(cout, n, f, bsz), strides=(2 * cout, 2 * n * cout,
                                         2 * f * n * cout),
        box=(bw, p, ft, 1), swizzle=2 * bw)
    tiles = (cout // (2 * nw), math.ceil(n / p), 1, bsz)
    assert plan['tiles'] == tiles and plan['threads'] == 384
    # persistent: one block an SM (132 on the H100), or one a tile
    assert plan['grid'] == (min(132, math.prod(tiles)),)
    assert ftc.tconv3_launch_plan(bsz, f, n, c, cout,
                                  sms=7)['grid'] == (7,)
    # the third tap's second 64-row block reads slab rows up to 2P + 127
    assert plan['slab_bytes'] == (2 * p + 128) * 128
    assert plan['slab_bytes'] >= (ft + 2) * p * 128
    assert plan['slab_bytes'] % 1024 == 0
    # three slabs, two staging tiles [128][NW], the barriers, and as many
    # weight stages [2 NW][128 B] as fit, at most 6
    fixed = 1024 + 3 * plan['slab_bytes'] + 2 * 128 * nw * 2 + 256
    assert 2 <= plan['wstages'] <= 6
    assert plan['smem'] == fixed + plan['wstages'] * 2 * nw * 128 <= 232448
    assert (plan['wstages'] == 6
            or plan['smem'] + 2 * nw * 128 > 232448)
    assert plan['tap_rows'] == (0, p, 2 * p)
    assert plan['chunks'] == math.ceil(c / 64)


def test_k5_plan_frame_windows_and_narrow_widths():
    """31 frames (a long chunk): windows of 16 frames of 8 pixels, two
    frame tiles; 32 output channels: 2 x 16 columns."""
    plan = ftc.tconv3_launch_plan(1, 31, 100, 64, 32)
    assert (plan['p'], plan['ft'], plan['nw']) == (8, 16, 16)
    assert plan['tiles'] == (1, 13, 2, 1)
    assert plan['x']['box'] == (64, 8, 18, 1)
    assert ftc.tconv3_tiles(1) == (64, 1) and ftc.tconv3_tiles(5) == (24, 5)
    assert ftc.tconv3_width(96) == 16 and ftc.tconv3_width(256) == 128
    assert plan['grid'] == (26,)        # fewer tiles than SMs


@pytest.mark.parametrize('c,cout', [(36, 64), (64, 36), (4, 64), (64, 0)])
def test_k5_plan_refuses_widths(c, cout):
    with pytest.raises(ValueError):
        ftc.tconv3_launch_plan(1, 8, 100, c, cout)


def test_k5_plan_refuses_empty_and_unbuilt_widths():
    with pytest.raises(ValueError):
        ftc.tconv3_launch_plan(1, 0, 100, 64, 64)
    with pytest.raises(ValueError):
        ftc.tconv3_launch_plan(1, 8, 100, 64, 64, nw=48)


# K6 on the main path: the VAE encoder's first two levels, the decoder's
# two upper levels, and the ragged 90-row level of the 512-channel blocks
K6_SHAPES = [(8, 720, 1280, 128, 128), (8, 360, 640, 128, 256),
             (6, 720, 1280, 256, 128), (6, 360, 640, 256, 256),
             (6, 90, 160, 512, 512)]


@pytest.mark.parametrize('n,h,w,c,cout', K6_SHAPES)
def test_k6_plan_at_main_path_shapes(n, h, w, c, cout):
    plan = c3.conv3x3_launch_plan(n, h, w, c, cout)
    assert plan['x'] == dict(dims=(c, w, h, n),
                             strides=(2 * c, 2 * w * c, 2 * h * w * c),
                             box=(8, 18, 18, 1), swizzle=0)
    assert plan['w'] == dict(dims=(c, 9, cout), strides=(2 * c, 18 * c),
                             box=(64, 1, 128), swizzle=128)
    assert plan['out'] == plan['res'] == dict(
        dims=(cout, w, h, n), strides=(2 * cout, 2 * w * cout,
                                       2 * h * w * cout),
        box=(64, 8, 16, 1), swizzle=128)
    tiles = (cout // 128, math.ceil(w / 16), math.ceil(h / 16), n)
    assert plan['tiles'] == tiles
    assert plan['grid'] == (min(132, math.prod(tiles)),)
    assert plan['threads'] == 384 and plan['chunks'] == c // 64
    # two halo stages of 8 groups, four weight stages of 128 x 128 bytes,
    # two staging tiles of 128 pixels x 128 channels, the barriers
    assert plan['smem'] == (1024 + 2 * 8 * 5248 + 4 * 128 * 128
                            + 2 * 128 * 128 * 2 + 256) <= 232448
    # a group holds the 324 halo pixels, 16 bytes each, padded to a
    # 128-byte multiple (TMA's destination alignment)
    assert plan['lbo'] == 5248 and plan['lbo'] % 128 == 0
    assert plan['lbo'] >= 18 * 18 * 16
    assert plan['sbo'] == 18 * 16 and plan['mblock'] == 8 * 18 * 16
    assert plan['tap_bytes'] == tuple(16 * (18 * ty + tx) for ty in range(3)
                                      for tx in range(3))


@pytest.mark.parametrize('c,cout', [(96, 128), (32, 128), (128, 64),
                                    (128, 192)])
def test_k6_plan_refuses_widths(c, cout):
    with pytest.raises(ValueError):
        c3.conv3x3_launch_plan(1, 20, 24, c, cout)


# --------------------------------------------------------------------------
# emulations of the tile schedules

def _silu_round(t, dtype):
    return F.silu(t).to(dtype).float()


def _emulate_tconv3(x, a, b, w, bias, residual, want_stats, per_frame,
                    plan, zero_frames=True):
    """K5's schedule on the CPU: one tile at a time, decoded from its index
    as the kernel decodes it, with the slab, taps, epilogue and statistics
    indexed as the kernel indexes them; the rows a tile must not read are
    NaN. Without `zero_frames` the frames outside [0, F) keep the
    activation of TMA's zeros, silu(b), as a kernel that skipped them
    would."""
    bsz, f, n, c = x.shape
    cout = w.shape[-1]
    p, ft, nw = plan['p'], plan['ft'], plan['nw']
    nct, npt, nft, _ = plan['tiles']
    slab_rows = plan['slab_bytes'] // 128
    kpad = plan['chunks'] * 64
    wk = torch.zeros(3, kpad, nct * 2 * nw)     # zero past C and Cout (TMA)
    wk[:, :c, :cout] = w.float()
    out = torch.full((bsz, f, n, cout), float('nan'))
    srows = bsz * f if per_frame else bsz
    s1, s2 = torch.zeros(srows, cout), torch.zeros(srows, cout)
    ap = F.pad(a.float(), (0, kpad - c))
    bp = F.pad(b.float(), (0, kpad - c))
    for tile in range(math.prod(plan['tiles'])):
        ct, rest = tile % nct, tile // nct
        pt, rest = rest % npt, rest // npt
        ftile, bb = rest % nft, rest // nft
        n0, f0, col0 = pt * p, ftile * ft, ct * 2 * nw
        slab = torch.full((slab_rows, kpad), float('nan'))
        for r in range((ft + 2) * p):
            fr, px = f0 - 1 + r // p, n0 + r % p
            raw = torch.zeros(kpad)              # TMA: zero outside x
            if 0 <= fr < f and px < n:
                raw[:c] = x[bb, fr, px].float()
            slab[r] = (_silu_round(raw * ap[bb] + bp[bb], x.dtype)
                       if 0 <= fr < f or not zero_frames else 0.0)
        acc = sum(slab[t0:t0 + 128] @ wk[t, :, col0:col0 + 2 * nw]
                  for t, t0 in enumerate(plan['tap_rows']))
        rows = ft * p
        for r in range(rows):
            fr, px = f0 + r // p, n0 + r % p
            if fr >= f or px >= n:               # clipped by the store
                continue
            cols = slice(col0, min(col0 + 2 * nw, cout))
            v = (acc[r, :cols.stop - col0] + bias[cols].float()).to(x.dtype)
            if residual is not None:
                v = v + residual[bb, fr, px, cols]
            out[bb, fr, px, cols] = v.float()
            srow = bb * f + fr if per_frame else bb
            s1[srow, cols] += v.float()
            s2[srow, cols] += v.float().square()
    return out, ((s1, s2) if want_stats else None)


def _tconv3_inputs(bsz, f, n, c, cout, dtype, residual, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(bsz, f, n, c, generator=g).to(dtype)
    a = torch.rand(bsz, c, generator=g) + 0.5
    b = torch.randn(bsz, c, generator=g) * 0.3
    w = (torch.randn(3, c, cout, generator=g) / math.sqrt(3 * c)).to(dtype)
    bias = torch.randn(cout, generator=g) * 0.1
    r = torch.randn(bsz, f, n, cout, generator=g).to(dtype) \
        if residual else None
    return x, a, b, w, bias, r


# (B, F, N, C, Cout, residual, per_frame): the UNet's 8 frames with pixel
# tails of N = 920 and 240 at P = 16 (and 3680 in the VAE's 3-frame
# windows at P = 40), per-frame statistics at F = 3 and 2, a 20-frame
# chunk (windows of 16 + a tail of 4), C below one 64-channel chunk, a
# ragged column tile
K5_EMULATED = [(2, 8, 920, 16, 16, True, False),
               (1, 8, 240, 16, 32, False, True),
               (2, 3, 3680, 8, 16, True, True),
               (1, 2, 100, 72, 64, True, True),
               (1, 20, 20, 16, 16, False, True),
               (1, 8, 20, 64, 96, True, False)]


@pytest.mark.parametrize('bsz,f,n,c,cout,res,pf', K5_EMULATED)
def test_k5_schedule_reproduces_the_plain_version(bsz, f, n, c, cout, res,
                                                  pf):
    x, a, b, w, bias, r = _tconv3_inputs(bsz, f, n, c, cout, torch.float32,
                                         res, seed=f * n + c)
    plan = ftc.tconv3_launch_plan(bsz, f, n, c, cout)
    got, gst = _emulate_tconv3(x, a, b, w, bias, r, True, pf, plan)
    want, wst = ftc.tconv3_plain(x, a, b, w, bias, r, True, pf)
    assert not torch.isnan(got).any()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for s_got, s_want in zip(gst, wst):
        torch.testing.assert_close(s_got, s_want, rtol=1e-4, atol=1e-3)


def test_k5_schedule_in_bf16_agrees_within_the_card_tolerance():
    """In bf16 the kernel activates in fp32 and rounds once, the plain
    version in bf16: they agree within chip_smoke.py's tolerance."""
    x, a, b, w, bias, r = _tconv3_inputs(1, 8, 50, 64, 64, torch.bfloat16,
                                         True, seed=7)
    plan = ftc.tconv3_launch_plan(1, 8, 50, 64, 64)
    got, _ = _emulate_tconv3(x, a, b, w, bias, r, False, False, plan)
    want, _ = ftc.tconv3_plain(x, a, b, w, bias, r, False)
    assert _agree(got, want)


def test_k5_schedule_without_the_zero_frames_fails():
    """Frames outside [0, F) that kept silu(b) (the activation of TMA's
    zero fill) instead of zeros would miss the plain version."""
    x, a, b, w, bias, _ = _tconv3_inputs(1, 3, 40, 16, 16, torch.float32,
                                         False, seed=3)
    plan = ftc.tconv3_launch_plan(1, 3, 40, 16, 16)
    want, _ = ftc.tconv3_plain(x, a, b, w, bias, None, False)
    got, _ = _emulate_tconv3(x, a, b, w, bias, None, False, False, plan,
                             zero_frames=False)
    assert not torch.allclose(got, want, atol=1e-3)


def _emulate_conv3x3(x, a, b, wt, bias, residual, want_stats, plan):
    """K6's schedule on the CPU: per tile, the halo of each 64-channel
    chunk in the [group][pixel][8] core-matrix layout (NaN in the padding
    pixels), each tap's A operand walked from the plan's descriptor bytes
    (start, sbo between core matrices, lbo between the halves of a k-step,
    16 bytes a row), the accumulator rows mapped to the patch as the
    epilogue maps them."""
    n, h, w, c = x.shape
    cout = wt.shape[0]
    nct, tiles_w, tiles_h, _ = plan['tiles']
    lbo, sbo, mblock = plan['lbo'], plan['sbo'], plan['mblock']
    gpix = lbo // 16
    wk = wt.float().permute(2, 3, 1, 0).reshape(9, c, cout)   # [tap, C, Cout]
    out = torch.full((n, h, w, cout), float('nan'))
    s1, s2 = torch.zeros(n, cout), torch.zeros(n, cout)
    # byte offsets of a 64 x 16 A operand: row r, k element e
    r_i = torch.arange(64)[:, None]
    e_i = torch.arange(16)[None, :]
    rel = (r_i // 8) * sbo + (r_i % 8) * 16 + (e_i // 8) * lbo \
        + (e_i % 8) * 2
    for tile in range(math.prod(plan['tiles'])):
        ct, rest = tile % nct, tile // nct
        twi, rest = rest % tiles_w, rest // tiles_w
        thi, nn = rest % tiles_h, rest // tiles_h
        h0, w0, col0 = thi * 16, twi * 16, ct * 128
        acc = torch.zeros(2, 2, 64, 128)                 # [group, mb, row]
        for k in range(plan['chunks']):
            halo = torch.full((8, gpix, 8), float('nan'))
            for px in range(18 * 18):
                ih, iw = h0 - 1 + px // 18, w0 - 1 + px % 18
                if 0 <= ih < h and 0 <= iw < w:
                    t = x[nn, ih, iw, k * 64:(k + 1) * 64].float() \
                        * a[nn, k * 64:(k + 1) * 64] \
                        + b[nn, k * 64:(k + 1) * 64]
                    halo[:, px] = _silu_round(t, x.dtype).reshape(8, 8)
                else:
                    halo[:, px] = 0.0
            flat = halo.reshape(-1)                      # 2 bytes an element
            for t in range(9):
                wtap = wk[t, k * 64:(k + 1) * 64, col0:col0 + 128]
                for grp in range(2):
                    for mb in range(2):
                        for kk in range(4):
                            start = (plan['tap_bytes'][t]
                                     + plan['group_bytes'][grp]
                                     + mb * mblock + 2 * kk * lbo)
                            a_op = flat[(start + rel) // 2]
                            acc[grp, mb] += a_op @ wtap[16 * kk:16 * kk + 16]
        for grp in range(2):
            for mb in range(2):
                for r in range(64):
                    oh, ow = h0 + 8 * mb + r // 8, w0 + 8 * grp + r % 8
                    if oh >= h or ow >= w:
                        continue
                    cols = slice(col0, col0 + 128)
                    v = (acc[grp, mb, r] + bias[cols].float()).to(x.dtype)
                    if residual is not None:
                        v = v + residual[nn, oh, ow, cols]
                    out[nn, oh, ow, cols] = v.float()
                    s1[nn, cols] += v.float()
                    s2[nn, cols] += v.float().square()
    return out, ((s1, s2) if want_stats else None)


def _conv_inputs(n, h, w, c, cout, dtype, residual, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, h, w, c, generator=g).to(dtype)
    a = torch.rand(n, c, generator=g) + 0.5
    b = torch.randn(n, c, generator=g) * 0.3
    wt = (torch.randn(cout, c, 3, 3, generator=g)
          / math.sqrt(9 * c)).to(dtype)
    bias = torch.randn(cout, generator=g) * 0.1
    r = torch.randn(n, h, w, cout, generator=g).to(dtype) \
        if residual else None
    return x, a, b, wt, bias, r


# (N, H, W, C, Cout, residual): a ragged H (20 = 16 + 4) and W (24 = 16 +
# 8), two chunks and two column tiles, and a patch wider than the image
@pytest.mark.parametrize('n,h,w,c,cout,res', [(1, 20, 24, 64, 128, True),
                                              (2, 5, 7, 128, 256, False)])
def test_k6_schedule_reproduces_the_plain_version(n, h, w, c, cout, res):
    torch.backends.cudnn.allow_tf32 = False
    x, a, b, wt, bias, r = _conv_inputs(n, h, w, c, cout, torch.float32, res,
                                        seed=h * w + c)
    plan = c3.conv3x3_launch_plan(n, h, w, c, cout)
    got, gst = _emulate_conv3x3(x, a, b, wt, bias, r, True, plan)
    want, wst = c3.conv3x3_plain(x, a, b, wt, bias, r, True)
    assert not torch.isnan(got).any()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    for s_got, s_want in zip(gst, wst):
        torch.testing.assert_close(s_got, s_want, rtol=1e-4, atol=1e-2)


def test_k6_schedule_with_a_swapped_lbo_and_sbo_fails():
    """The descriptor walk is what the test holds: the halo pixels and the
    channel halves swapped in the descriptor miss the plain version."""
    x, a, b, wt, bias, _ = _conv_inputs(1, 16, 16, 64, 128, torch.float32,
                                        False, seed=1)
    plan = c3.conv3x3_launch_plan(1, 16, 16, 64, 128)
    want, _ = c3.conv3x3_plain(x, a, b, wt, bias, None, False)
    bad = dict(plan, lbo=plan['sbo'], sbo=plan['lbo'])
    bad['mblock'] = 8 * bad['sbo']
    with pytest.raises((IndexError, AssertionError)):  # outside, or wrong
        got, _ = _emulate_conv3x3(x, a, b, wt, bias, None, False, bad)
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


# --------------------------------------------------------------------------
# `_launch` hands the entry points what the plans say

class _FakeCuda(torch.Tensor):
    @property
    def is_cuda(self):
        return True


def _fake(*shape, dtype=torch.bfloat16):
    return torch.Tensor._make_subclass(_FakeCuda,
                                       torch.ones(*shape, dtype=dtype))


class _Recorder:
    def __init__(self):
        self.calls = []

    def star_fused_gn_silu_tconv3(self, *args):
        self.calls.append(args)
        return 0

    def star_conv3x3(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(_build, 'lib', lambda: rec)
    monkeypatch.setattr(_build, 'stream_ptr', lambda device: 0)
    return rec


@pytest.mark.parametrize('f,n,c,cout,pf', [(8, 920, 320, 320, False),
                                           (3, 700, 128, 128, True),
                                           (2, 64, 32, 32, True)])
def test_k5_launch_passes_the_plan(recorder, monkeypatch, f, n, c, cout, pf):
    """star_fused_gn_silu_tconv3 gets the shapes, the flags and the plan's
    P, FT, NW, slab bytes and shared memory; the weights it reads are the
    K-major [3, Cout, C] taps; one launch is counted."""
    seen = []
    real = torch.Tensor.contiguous

    def contiguous(t, *a, **k):
        out = real(t, *a, **k)
        seen.append(out)
        return out
    monkeypatch.setattr(torch.Tensor, 'contiguous', contiguous)
    x = _fake(2, f, n, c)
    k3 = torch.randn(3, c, cout)
    before = ftc.LAUNCHES
    out, st = ftc._launch(x, torch.ones(2, c), torch.zeros(2, c), k3,
                          torch.zeros(cout), _fake(2, f, n, cout), True, pf)
    (args,) = recorder.calls
    plan = ftc.tconv3_launch_plan(2, f, n, c, cout)
    assert args[9:16] == (2, f, n, c, cout, 1, int(pf))
    assert args[16:23] == (plan['p'], plan['ft'], plan['nw'],
                           plan['slab_bytes'], plan['wstages'],
                           plan['grid'][0], plan['smem'])
    wk = next(t for t in seen if t.data_ptr() == args[3])
    assert wk.shape == (3, cout, c) and wk.dtype == torch.bfloat16
    assert torch.equal(wk, k3.transpose(1, 2).bfloat16())
    assert args[6] == out.data_ptr() and out.shape == (2, f, n, cout)
    assert st[0].shape == ((2 * f if pf else 2), cout)
    assert ftc.LAUNCHES == before + 1


@pytest.mark.parametrize('case', ['cpu', 'fp32', 'strided', 'c36', 'cout20',
                                  'residual_fp32'])
def test_k5_launch_refuses_before_building(recorder, case):
    x, k3, r = _fake(1, 8, 16, 64), torch.zeros(3, 64, 64), None
    if case == 'cpu':
        x = torch.zeros(1, 8, 16, 64, dtype=torch.bfloat16)
    elif case == 'fp32':
        x = _fake(1, 8, 16, 64, dtype=torch.float32)
    elif case == 'strided':
        x = _fake(1, 16, 8, 64).transpose(1, 2)
    elif case == 'c36':
        x, k3 = _fake(1, 8, 16, 36), torch.zeros(3, 36, 64)
    elif case == 'cout20':
        k3 = torch.zeros(3, 64, 20)
    else:
        r = _fake(1, 8, 16, 64, dtype=torch.float32)
    c, cout = x.shape[-1], k3.shape[-1]
    with pytest.raises(ValueError):
        ftc._launch(x, torch.ones(1, c), torch.zeros(1, c), k3,
                    torch.zeros(cout), r, True, False)
    assert recorder.calls == []


@pytest.mark.parametrize('n,h,w,c,cout', K6_SHAPES[-1:] + [(1, 20, 24, 128,
                                                           256)])
def test_k6_launch_passes_the_plan(recorder, n, h, w, c, cout):
    x = _fake(n, h, w, c)
    before = c3.LAUNCHES
    out, st = c3._launch(x, torch.ones(n, c), torch.zeros(n, c),
                         torch.zeros(cout, c, 3, 3), torch.zeros(cout),
                         None, True)
    (args,) = recorder.calls
    plan = c3.conv3x3_launch_plan(n, h, w, c, cout)
    assert args[9:16] == (n, h, w, c, cout, 1, plan['grid'][0])
    assert args[5] is None and args[6] == out.data_ptr()
    assert st[0].shape == (n, cout)
    assert c3.LAUNCHES == before + 1


def test_k6_launch_refuses_through_the_plan(recorder):
    with pytest.raises(ValueError):          # C = 96: not whole chunks
        c3._launch(_fake(1, 4, 8, 96), torch.ones(1, 96), torch.zeros(1, 96),
                   torch.zeros(128, 96, 3, 3), torch.zeros(128), None, True)
    assert recorder.calls == []


# --------------------------------------------------------------------------
# on the card

def _agree(a, b):
    a, b = a.float(), b.float()
    return bool((a - b).abs().max() <= 2e-2 * b.abs().max()
                and (a - b).norm() <= 1e-2 * b.norm())


def _stats_agree(st, ref):
    return all(float((st[i] - ref[i]).abs().max())
               <= 2e-2 * float(ref[1].abs().max()) for i in range(2))


# (B, F, N, C, Cout, residual, per_frame): a pixel tail (N = 20 at P = 16),
# C = 32 below one chunk (the small VAE's), a 20-frame chunk in windows of
# 16, F = 1, a ragged column tile (Cout = 96), the grid over 2^16 blocks
K5_EDGES = [(1, 8, 20, 64, 64, True, False), (1, 3, 576, 32, 32, False, True),
            (1, 20, 100, 64, 128, True, True), (2, 1, 300, 128, 128, True,
                                                 False),
            (1, 8, 50, 64, 96, False, False), (1, 2, 4200000, 8, 16, False,
                                               True)]


@pytest.mark.cuda
@pytest.mark.parametrize('bsz,f,n,c,cout,res,pf', K5_EDGES)
def test_k5_edges_on_the_card(bsz, f, n, c, cout, res, pf):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    x, a, b, w, bias, r = (None if t is None else t.cuda() for t in
                           _tconv3_inputs(bsz, f, n, c, cout, torch.bfloat16,
                                          res, seed=n + c))
    before = ftc.LAUNCHES
    y, st = ftc._launch(x, a, b, w, bias, r, True, pf)
    assert ftc.LAUNCHES == before + 1
    yr, sr = ftc.tconv3_plain(x, a, b, w, bias, r, True, pf)
    assert _agree(y, yr) and _stats_agree(st, sr)


# (N, H, W, C, Cout, residual): ragged H and W, a patch wider than the
# image, two column tiles, eight chunks
K6_EDGES = [(1, 20, 24, 64, 128, True), (2, 5, 7, 128, 256, False),
            (1, 33, 47, 512, 128, True)]


@pytest.mark.cuda
@pytest.mark.parametrize('n,h,w,c,cout,res', K6_EDGES)
def test_k6_edges_on_the_card(n, h, w, c, cout, res):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    torch.backends.cudnn.allow_tf32 = False
    x, a, b, wt, bias, r = (None if t is None else t.cuda() for t in
                            _conv_inputs(n, h, w, c, cout, torch.bfloat16,
                                         res, seed=h * w + c))
    before = c3.LAUNCHES
    y, st = c3._launch(x, a, b, wt, bias, r, True)
    assert c3.LAUNCHES == before + 1
    yr, sr = c3.conv3x3_plain(x, a, b, wt, bias, r, True)
    assert _agree(y, yr) and _stats_agree(st, sr)


# --------------------------------------------------------------------------
# launches per shape, from the models' structure

def _record(monkeypatch, module, name, calls, kind):
    real = getattr(module, name)

    def rec(x, *a, **k):
        w = a[2]
        cout = w.shape[-1] if kind == 'k5' else w.shape[0]
        calls.append((kind, tuple(x.shape[:-1]), x.shape[-1], cout,
                      k.get('residual') is not None))
        return real(x, *a, **k)
    monkeypatch.setattr(module, name, rec)


def test_k5_and_k6_launches_per_shape_from_the_full_depth_models(
        monkeypatch):
    """The full-depth UNet+ControlNet and SVD VAE at narrow widths on the
    CPU (channels 32 for 320 or 128), every K5 and K6 call recorded with
    its shape and mapped to full width: chip_smoke.py's tables, from which
    it asserts the launches of each path and sums their bounds. Totals:
    128 K5
    launches a CFG call (28 at each of the first three levels, 44 at the
    fourth); 20 K6 launches to encode 8 frames (its 8-channel conv_out is
    not a K6 shape); 28 K5 and 28 K6 a decoder call."""
    from star_tpu_torch.models.unet import blocks
    from star_tpu_torch.models.unet.unet import ControlledV2VUNet
    from star_tpu_torch.vae import svd_vae
    calls = []
    _record(monkeypatch, blocks, 'fused_gn_silu_tconv3', calls, 'k5')
    _record(monkeypatch, svd_vae, 'fused_gn_silu_tconv3', calls, 'k5')
    _record(monkeypatch, svd_vae, 'fused_gn_silu_conv3x3', calls, 'k6')

    def table(kind, lead, grids, widths):
        got = {}
        for k, shape, c, cout, res in calls:
            if k != kind or (kind == 'k6' and cout % 32):
                continue                     # not a K6 shape at full width
            key = (shape[:lead], grids[shape[lead:]], widths[c],
                   widths[cout], res)
            got[key] = got.get(key, 0) + 1
        return got

    torch.manual_seed(0)
    unet = ControlledV2VUNet(dim=32, head_dim=16, num_heads_init_temporal=2,
                             context_dim=16).eval()
    x, hint = torch.randn(1, 8, 18, 24, 4), torch.randn(1, 8, 18, 24, 4)
    with torch.no_grad():
        unet(x, torch.tensor([500]), torch.randn(2, 77, 16), hint,
             cfg_pair=True)
    # the latent grid 18x24 here, 90x160 at full width; 32 channels a mult
    grids = {(432,): (90, 160), (120,): (45, 80), (36,): (23, 40),
             (12,): (12, 20)}
    widths = {32: 320, 64: 640, 128: 1280}
    assert table('k5', 2, grids, widths) == cs.UNET_K5_PER_CFG_CALL
    assert sum(cs.UNET_K5_PER_CFG_CALL.values()) == 128

    vae = svd_vae.SVDTemporalVAE((32, 64, 128, 128)).eval()
    vgrids = {(32, 32): (720, 1280), (16, 16): (360, 640), (8, 8): (180, 320),
              (4, 4): (90, 160)}
    vwidths = {32: 128, 64: 256, 128: 512}
    calls.clear()
    with torch.no_grad():
        vae.encode_moments(torch.rand(1, 8, 32, 32, 3))
    assert table('k6', 1, vgrids, vwidths) == cs.VAE_K6_PER_ENCODE
    assert sum(cs.VAE_K6_PER_ENCODE.values()) == 20
    calls.clear()
    with torch.no_grad():
        vae.decode(torch.randn(1, 8, 4, 4, 4))
    k5_23, k6_23 = cs.vae_decode_per_call(2, 3)
    k5_12, k6_12 = cs.vae_decode_per_call(1, 2)
    sgrids = {(n,): g for n, g in ((16, (90, 160)), (64, (180, 320)),
                                   (256, (360, 640)), (1024, (720, 1280)))}
    assert table('k5', 2, sgrids, vwidths) == {**k5_23, **k5_12}
    assert table('k6', 1, vgrids, vwidths) == {**k6_23, **k6_12}
    assert sum(k5_23.values()) == sum(k6_23.values()) == 28
    assert (cs.K5_PER_CFG_STEP, cs.K5_PER_DECODE, cs.K6_PER_DECODE,
            cs.K6_PER_ENCODE) == (128, 28, 28, 20)
