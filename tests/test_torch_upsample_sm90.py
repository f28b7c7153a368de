"""The launch arithmetic of K7 (csrc/upsample_conv_sm90.cu, fused nearest-2x
upsample + 3x3 conv as four phase 2x2 convs, a wgmma kernel fed by TMA)
held on the CPU:

  * `upsample_conv2x_launch_plan` at every main-path shape (the decoder's
    three upsamples, on 6 and on 2 frames): the halo map of x, the
    [Cout, 16, C] weights, one strided output map per phase, the tiles,
    grid, threads, shared memory and the 16 tap offsets, and its refusals;
  * an emulation of the tile schedule in torch (phase tiles, each tap's A
    operand walked from the plan's descriptor bytes into one 18x18 halo in
    the plain core-matrix layout with NaN in every byte a tile must not
    read, the phase stores through the plan's strided maps clipped at the
    small grid's edges, statistics of the stored pixels) against
    `upsample_conv2x_plain`, in fp32 and in bf16, and the negative cases
    that must miss it (a swapped tap offset, a store without its s*Cout
    shift);
  * that `_launch_upsample` hands the C entry point what the plan says:
    the phase maps' offsets and strides, the tap offsets and the grid,
    which the kernel uses as given;
  * the launches per shape of the full-depth decoder (chip_smoke.py's
    table);
  * `cuda` cases at the edges of the tiles, which skip here (on a card:
    python -m pytest tests/test_torch_upsample_sm90.py -m cuda --noconftest).
"""

import math

import pytest
import torch

import chip_smoke as cs
from star_tpu_torch.ops import _build, upsample_conv as uc

# K7 on the main path: the decoder's three upsamples, on the two 3-frame
# windows folded into a batch of 6 and on the last 2 frames
K7_SHAPES = [(n, h, w, c) for n in (6, 2)
             for h, w, c in ((90, 160, 512), (180, 320, 512),
                             (360, 640, 256))]


@pytest.mark.parametrize('n,h,w,c', K7_SHAPES)
def test_k7_plan_at_main_path_shapes(n, h, w, c):
    cout = c
    plan = uc.upsample_conv2x_launch_plan(n, h, w, c, cout)
    assert plan['x'] == dict(dims=(c, w, h, n),
                             strides=(2 * c, 2 * w * c, 2 * h * w * c),
                             box=(8, 18, 18, 1), swizzle=0)
    assert plan['w'] == dict(dims=(c, 16, cout), strides=(2 * c, 32 * c),
                             box=(64, 1, 128), swizzle=128)
    # phase (r, s) of out [n, 2h, 2w, cout]: element (n, 2i+r, 2j+s, col)
    # is offset + col + j * 2 cout + i * 4 w cout + n * 4 h w cout
    for ph, m in enumerate(plan['out']):
        r, s = divmod(ph, 2)
        assert m == dict(dims=(cout, w, h, n),
                         strides=(4 * cout, 8 * w * cout, 8 * h * w * cout),
                         box=(64, 8, 16, 1), swizzle=128,
                         offset=(2 * w * r + s) * cout)
        # TMA: 16-byte aligned base and strides
        assert (2 * m['offset']) % 16 == 0
        assert all(st % 16 == 0 for st in m['strides'])
    tiles = (cout // 128, 4, math.ceil(w / 16), math.ceil(h / 16), n)
    assert plan['tiles'] == tiles
    assert plan['grid'] == (min(132, math.prod(tiles)),)
    assert uc.upsample_conv2x_launch_plan(n, h, w, c, cout,
                                          sms=7)['grid'] == (7,)
    assert plan['threads'] == 384 and plan['chunks'] == c // 64
    # K6's buffers: two halo stages of 8 groups, four weight stages of
    # 128 x 128 bytes, two staging tiles of 128 pixels x 128 channels
    assert plan['smem'] == (1024 + 2 * 8 * 5248 + 4 * 128 * 128
                            + 2 * 128 * 128 * 2 + 256) <= 232448
    assert plan['lbo'] == 5248 and plan['lbo'] >= 18 * 18 * 16
    assert plan['sbo'] == 18 * 16 and plan['mblock'] == 8 * 18 * 16
    # tap (p, q) of phase (r, s) reads halo cell (r + p, s + q): the 16
    # offsets are nine distinct cells, K6's tap offsets
    taps = plan['tap_bytes']
    assert len(taps) == 16
    assert taps == tuple(16 * (18 * (r + p) + s + q) for r in (0, 1)
                         for s in (0, 1) for p in (0, 1) for q in (0, 1))
    assert sorted(set(taps)) == sorted(16 * (18 * ty + tx)
                                       for ty in range(3) for tx in range(3))
    assert plan['group_bytes'] == (0, 128)


def test_k7_phase_maps_cover_the_output_once():
    """The four phase maps at a ragged shape address every element of out
    exactly once: no two phases write the same row, and none is missed."""
    n, h, w, cout = 2, 5, 7, 128
    plan = uc.upsample_conv2x_launch_plan(n, h, w, 64, cout)
    hits = torch.zeros(n * 2 * h * 2 * w * cout, dtype=torch.int32)
    col = torch.arange(cout)
    for m in plan['out']:
        s0, s1, s2 = (st // 2 for st in m['strides'])
        for nn in range(n):
            for i in range(h):
                for j in range(w):
                    hits[m['offset'] + col + j * s0 + i * s1 + nn * s2] += 1
    assert bool((hits == 1).all())


@pytest.mark.parametrize('c,cout', [(96, 128), (32, 128), (512, 64),
                                    (256, 192), (0, 128)])
def test_k7_plan_refuses_widths(c, cout):
    assert not uc.k7_takes(c, cout)
    with pytest.raises(ValueError):
        uc.upsample_conv2x_launch_plan(1, 20, 24, c, cout)


def test_k7_plan_refuses_empty_and_huge_launches():
    with pytest.raises(ValueError):
        uc.upsample_conv2x_launch_plan(0, 20, 24, 64, 128)
    with pytest.raises(ValueError):       # more tiles than an int holds
        uc.upsample_conv2x_launch_plan(2 ** 20, 4096, 4096, 64, 128)
    # every full-width decoder upsample qualifies; the small VAE's 32- and
    # 64-channel ones take the phase convs and K8
    assert all(uc.k7_takes(c, c) for c in (512, 256))
    assert not uc.k7_takes(32, 32) and not uc.k7_takes(64, 64)


# --------------------------------------------------------------------------
# an emulation of the tile schedule

def _emulate_upsample(x, k_rs, bias, want_stats, plan):
    """K7's schedule on the CPU: per tile (column tile, phase, patch), the
    halo of each 64-channel chunk in the [group][pixel][8] core-matrix
    layout (zeros outside the image, NaN in the padding pixels), each of
    the phase's four taps walked from the plan's descriptor bytes (start,
    sbo between core matrices, lbo between the halves of a k-step, 16
    bytes a row), the accumulator rows mapped to the patch as the epilogue
    maps them, and the rounded values stored through the phase's map into
    a flat out full of NaN, clipped at the small grid's edges."""
    n, h, w, c = x.shape
    cout = k_rs.shape[-1]
    nct, phases, tiles_w, tiles_h, _ = plan['tiles']
    lbo, sbo, mblock = plan['lbo'], plan['sbo'], plan['mblock']
    gpix = lbo // 16
    wk = uc.k7_weights(k_rs, 'cpu', x.dtype).float()     # [Cout, 16, C]
    out = torch.full((n * 2 * h * 2 * w * cout,), float('nan'))
    s1, s2 = torch.zeros(n, cout), torch.zeros(n, cout)
    r_i = torch.arange(64)[:, None]
    e_i = torch.arange(16)[None, :]
    rel = (r_i // 8) * sbo + (r_i % 8) * 16 + (e_i // 8) * lbo \
        + (e_i % 8) * 2
    xp = torch.zeros(n, h + 34, w + 34, c)
    xp[:, 1:h + 1, 1:w + 1] = x.float()
    for tile in range(math.prod(plan['tiles'])):
        ct, rest = tile % nct, tile // nct
        phase, rest = rest % phases, rest // phases
        twi, rest = rest % tiles_w, rest // tiles_w
        thi, nn = rest % tiles_h, rest // tiles_h
        h0, w0, col0 = thi * 16, twi * 16, ct * 128
        acc = torch.zeros(2, 2, 64, 128)                 # [group, mb, row]
        for k in range(plan['chunks']):
            halo = torch.full((8, gpix, 8), float('nan'))
            patch = xp[nn, h0:h0 + 18, w0:w0 + 18, k * 64:(k + 1) * 64]
            halo[:, :324] = patch.reshape(324, 8, 8).transpose(0, 1)
            flat = halo.reshape(-1)                      # 2 bytes an element
            for tap in range(4):
                wtap = wk[col0:col0 + 128, 4 * phase + tap,
                          k * 64:(k + 1) * 64].t()
                for grp in range(2):
                    for mb in range(2):
                        for kk in range(4):
                            start = (plan['tap_bytes'][4 * phase + tap]
                                     + plan['group_bytes'][grp]
                                     + mb * mblock + 2 * kk * lbo)
                            a_op = flat[(start + rel) // 2]
                            acc[grp, mb] += a_op @ wtap[16 * kk:16 * kk + 16]
        m = plan['out'][phase]
        st0, st1, st2 = (st // 2 for st in m['strides'])
        cols = torch.arange(col0, col0 + 128)
        for grp in range(2):
            for mb in range(2):
                for r in range(64):
                    i, j = h0 + 8 * mb + r // 8, w0 + 8 * grp + r % 8
                    if i >= m['dims'][2] or j >= m['dims'][1]:
                        continue                          # clipped
                    v = (acc[grp, mb, r] + bias[col0:col0 + 128].float()
                         ).to(x.dtype).float()
                    out[m['offset'] + cols + j * st0 + i * st1
                        + nn * st2] = v
                    s1[nn, col0:col0 + 128] += v
                    s2[nn, col0:col0 + 128] += v.square()
    out = out.reshape(n, 2 * h, 2 * w, cout)
    return out, ((s1, s2) if want_stats else None)


def _inputs(n, h, w, c, cout, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, h, w, c, generator=g).to(dtype)
    wt = (torch.randn(cout, c, 3, 3, generator=g)
          / math.sqrt(9 * c)).to(dtype)
    bias = torch.randn(cout, generator=g) * 0.1
    return x, uc.phase_weights(wt), bias


# (N, H, W, C, Cout): a ragged H (20 = 16 + 4) and W (24 = 16 + 8), two
# chunks and two column tiles with a patch wider than the image, and the
# decoder's ragged H = 90 (five patches and a 10-row one)
K7_EMULATED = [(1, 20, 24, 64, 128), (2, 5, 7, 128, 256),
               (1, 90, 20, 64, 128)]


@pytest.mark.parametrize('n,h,w,c,cout', K7_EMULATED)
def test_k7_schedule_reproduces_the_plain_version(n, h, w, c, cout):
    torch.backends.cudnn.allow_tf32 = False
    x, k_rs, bias = _inputs(n, h, w, c, cout, torch.float32, seed=h * w + c)
    plan = uc.upsample_conv2x_launch_plan(n, h, w, c, cout)
    got, gst = _emulate_upsample(x, k_rs, bias, True, plan)
    want, wst = uc.upsample_conv2x_plain(x, k_rs, bias, True)
    assert not torch.isnan(got).any()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    for s_got, s_want in zip(gst, wst):
        torch.testing.assert_close(s_got, s_want, rtol=1e-4, atol=1e-2)


def _agree(a, b):
    """chip_smoke.py's tolerance (relative, no floor)."""
    a, b = a.float(), b.float()
    return bool((a - b).abs().max() <= cs.MAX_TOL * b.abs().max()
                and (a - b).norm() <= cs.RMS_TOL * b.norm())


def _stats_agree(st, ref):
    return all(float((st[i] - ref[i]).abs().max())
               <= 2e-2 * float(ref[1].abs().max()) for i in range(2))


def test_k7_schedule_in_bf16_agrees_within_the_card_tolerance():
    x, k_rs, bias = _inputs(1, 20, 24, 64, 128, torch.bfloat16, seed=3)
    plan = uc.upsample_conv2x_launch_plan(1, 20, 24, 64, 128)
    got, gst = _emulate_upsample(x, k_rs, bias, True, plan)
    want, wst = uc.upsample_conv2x_plain(x, k_rs, bias, True)
    assert _agree(got, want) and _stats_agree(gst, wst)


@pytest.mark.parametrize('fault', ['swapped_tap', 'no_s_shift'])
def test_k7_schedule_faults_miss_the_plain_version(fault):
    """The tap offsets and the phase stores are what the emulation holds:
    phase (0, 1) with the offsets of its taps (0, 0) and (0, 1) swapped,
    or storing without its s * Cout shift (onto phase (0, 0)'s pixels),
    misses the plain version."""
    x, k_rs, bias = _inputs(1, 16, 16, 64, 128, torch.float32, seed=1)
    plan = uc.upsample_conv2x_launch_plan(1, 16, 16, 64, 128)
    want = uc.upsample_conv2x_plain(x, k_rs, bias)
    bad = dict(plan)
    if fault == 'swapped_tap':
        taps = list(plan['tap_bytes'])
        taps[4], taps[5] = taps[5], taps[4]
        bad['tap_bytes'] = tuple(taps)
    else:
        bad['out'] = (plan['out'][0], dict(plan['out'][1], offset=0),
                      *plan['out'][2:])
    got, _ = _emulate_upsample(x, k_rs, bias, False, bad)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3,
                                   equal_nan=False)


# --------------------------------------------------------------------------
# `_launch_upsample` hands the entry point what the plan says

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

    def star_upsample_conv2x(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(_build, 'lib', lambda: rec)
    monkeypatch.setattr(_build, 'stream_ptr', lambda device: 0)
    return rec


@pytest.mark.parametrize('n,h,w,c', K7_SHAPES[:3] + [(1, 20, 24, 64)])
def test_k7_launch_passes_the_plan(recorder, monkeypatch, n, h, w, c):
    """star_upsample_conv2x gets the shapes, want_stats, the plan's phase
    map offsets and strides, its 16 tap offsets and its grid; the weights
    it reads are K_rs rounded to bf16 in the [Cout, 16, C] layout (row
    4 * phase + 2p + q); one launch is counted."""
    seen = []
    real = torch.Tensor.contiguous

    def contiguous(t, *a, **k):
        out = real(t, *a, **k)
        seen.append(out)
        return out
    monkeypatch.setattr(torch.Tensor, 'contiguous', contiguous)
    cout = 128 if c == 64 else c
    k_rs = torch.randn(4, 2, 2, c, cout)
    before = uc.UPSAMPLE_LAUNCHES
    out, st = uc._launch_upsample(_fake(n, h, w, c), k_rs,
                                  torch.zeros(cout), True)
    (args,) = recorder.calls
    plan = uc.upsample_conv2x_launch_plan(n, h, w, c, cout)
    assert args[6:12] == (n, h, w, c, cout, 1)
    assert list(args[12]) == [m['offset'] for m in plan['out']]
    assert all(tuple(args[13]) == m['strides'] for m in plan['out'])
    assert tuple(args[14]) == plan['tap_bytes']
    assert args[15] == plan['grid'][0]
    assert args[3] == out.data_ptr() and out.shape == (n, 2 * h, 2 * w,
                                                       cout)
    wk = next(t for t in seen if t.data_ptr() == args[1])
    assert wk.shape == (cout, 16, c) and wk.dtype == torch.bfloat16
    for ph in range(4):
        for tap in range(4):
            assert torch.equal(wk[:, 4 * ph + tap],
                               k_rs[ph, tap // 2, tap % 2].t().bfloat16())
    assert st[0].shape == (n, cout)
    assert uc.UPSAMPLE_LAUNCHES == before + 1


def test_k7_plan_args_refuse_phase_maps_of_other_strides():
    """The entry point takes one stride triple for the four phase maps: a
    plan whose maps differ is refused, not half passed on."""
    plan = uc.upsample_conv2x_launch_plan(1, 16, 16, 64, 128)
    offsets, strides, taps = uc.k7_plan_args(plan)
    assert list(offsets) == [0, 128, 32 * 128, 33 * 128]
    assert tuple(strides) == (4 * 128, 8 * 16 * 128, 8 * 16 * 16 * 128)
    assert len(taps) == 16
    m1 = dict(plan['out'][1],
              strides=(2 * 128,) + plan['out'][1]['strides'][1:])
    with pytest.raises(ValueError):
        uc.k7_plan_args(dict(plan, out=(plan['out'][0], m1, *plan['out'][2:])))


@pytest.mark.parametrize('case', ['cpu', 'fp32', 'strided', 'c96', 'cout64',
                                  'k_rs'])
def test_k7_launch_refuses_before_building(recorder, case):
    x, k_rs = _fake(1, 4, 8, 64), torch.zeros(4, 2, 2, 64, 128)
    if case == 'cpu':
        x = torch.zeros(1, 4, 8, 64, dtype=torch.bfloat16)
    elif case == 'fp32':
        x = _fake(1, 4, 8, 64, dtype=torch.float32)
    elif case == 'strided':
        x = _fake(1, 8, 4, 64).transpose(1, 2)
    elif case == 'c96':
        x, k_rs = _fake(1, 4, 8, 96), torch.zeros(4, 2, 2, 96, 128)
    elif case == 'cout64':
        k_rs = torch.zeros(4, 2, 2, 64, 64)
    else:
        k_rs = torch.zeros(4, 3, 3, 64, 128)
    with pytest.raises(ValueError):
        uc._launch_upsample(x, k_rs, torch.zeros(k_rs.shape[-1]), True)
    assert recorder.calls == []


def test_k7_routing_keeps_narrow_widths_on_the_phase_convs(monkeypatch):
    """upsample_conv2x launches K7 where it takes the widths, and runs the
    phase convs and K8 where it does not."""
    routed = []
    monkeypatch.setattr(uc, '_launch_upsample',
                        lambda *a: routed.append('k7') or 'k7')
    monkeypatch.setattr(uc, 'interleave2x2',
                        lambda *a, **k: routed.append('k8') or 'k8')
    monkeypatch.setattr(uc, '_phase_convs', lambda *a: [None] * 4)
    assert uc.upsample_conv2x(_fake(1, 4, 8, 512), torch.zeros(512, 512, 3, 3),
                              torch.zeros(512)) == 'k7'
    assert uc.upsample_conv2x(_fake(1, 4, 8, 64), torch.zeros(64, 64, 3, 3),
                              torch.zeros(64)) == 'k8'
    assert routed == ['k7', 'k8']


# --------------------------------------------------------------------------
# launches per shape, from the decoder's structure

def test_k7_launches_per_shape_from_the_full_depth_decoder(monkeypatch):
    """The full-depth SVD VAE decoder at narrow widths on the CPU (channels
    32 for 128), every upsample_conv2x call recorded with its shape and
    mapped to full width: chip_smoke.py's table, from which it asserts
    K7's launches per shape in the clip and in the train step. One decoder
    call upsamples three times, on the bsz * f images of its windows."""
    from star_tpu_torch.vae import svd_vae
    calls = []
    real = svd_vae.upsample_conv2x

    def rec(x, weight, bias, **k):
        calls.append((tuple(x.shape[:-1]), x.shape[-1], weight.shape[0]))
        return real(x, weight, bias, **k)
    monkeypatch.setattr(svd_vae, 'upsample_conv2x', rec)
    torch.manual_seed(0)
    vae = svd_vae.SVDTemporalVAE((32, 64, 128, 128)).eval()
    grids = {(4, 4): (90, 160), (8, 8): (180, 320), (16, 16): (360, 640)}
    widths = {32: 128, 64: 256, 128: 512}
    for bsz, f in ((2, 3), (1, 2)):
        calls.clear()
        with torch.no_grad():
            vae.decode(torch.randn(bsz, f, 4, 4, 4))
        got = {}
        for shape, c, cout in calls:
            key = (shape[:1], grids[shape[1:]], widths[c], widths[cout])
            got[key] = got.get(key, 0) + 1
        assert got == cs.vae_decode_k7_per_call(bsz, f)
    full = cs.vae_decode_k7_per_call(2, 3)
    assert all(uc.k7_takes(c, cout) for _, _, c, cout in full)
    assert cs.K7_PER_CLIP == cs.K7_PER_TRAIN_STEP == 6


# --------------------------------------------------------------------------
# on the card

# (N, H, W, C, Cout): ragged H and W, a patch wider than the image, two
# column tiles, eight chunks, the decoder's ragged H = 90
K7_EDGES = [(1, 20, 24, 64, 128), (2, 5, 7, 128, 256),
            (1, 33, 47, 512, 128), (2, 90, 40, 256, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize('n,h,w,c,cout', K7_EDGES)
def test_k7_edges_on_the_card(n, h, w, c, cout):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    torch.backends.cudnn.allow_tf32 = False
    x, k_rs, bias = (t.cuda() for t in _inputs(n, h, w, c, cout,
                                                torch.bfloat16,
                                                seed=h * w + c))
    before = uc.UPSAMPLE_LAUNCHES
    y, st = uc._launch_upsample(x, k_rs, bias, True)
    assert uc.UPSAMPLE_LAUNCHES == before + 1
    yr, sr = uc.upsample_conv2x_plain(x, k_rs, bias, True)
    assert _agree(y, yr) and _stats_agree(st, sr)
