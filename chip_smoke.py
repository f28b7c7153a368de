"""On-card smoke test of the PyTorch/H100 port (star_tpu_torch).

    python3 chip_smoke.py            # everything, on one CUDA card

1. prints the card's name and power limit and builds the CUDA kernels of
   star_tpu_torch/csrc with nvcc (timed);
2. holds each kernel (K1 packed flash, K2 d=512 flash, K2 `with_l` (the
   d=64 training forward writing the log-sum-exp), K3 flash backward, K4
   frame attention, K5 fused GN+SiLU+temporal conv, K6 fused GN+SiLU+3x3
   conv, K7 fused nearest-2x+3x3 conv, K8 2x2 phase interleave, K9 fused
   qk-LayerNorm+RoPE, K10 LayerNorm (optionally LIEM-gated), K11 residual
   add + LayerNorm; K1 also at the CogVideoX DiT's 48 heads, 9680
   tokens, dead key tail and prescaled q, and at the edges of its tiles;
   K2 `with_l` and K3 also at the DiT's 9680 tokens and 48 heads; K10 and
   K11 at C = 320, 640, 1280 and 3072) against its plain PyTorch
   version at the shapes the main paths give it, and times kernel, plain
   version and one PyTorch library call with CUDA events; then runs a
   small-width UNet+ControlNet and VAE, and a small CogVideoX DiT and
   causal VAE, on the card (bf16, kernels) against the same weights on the
   host (fp32, plain versions), and the small UNet+ControlNet's
   `loss_and_grads` likewise;
3. builds the full-width models with seeded random bf16 weights on the card
   and runs STARPipeline.enhance_a_video on 8 frames of 180x320 -> 720x1280,
   with every kernel's launch count reset just before and read just after;
4. times one CFG UNet+ControlNet step at the bench shape (8 frames on the
   90x160 latent grid, cfg_pair, bf16);
5. trains: the same full-width UNet+ControlNet as the compute copy, fp32
   masters of the ControlNet+LIEM set, remat, the frequency loss on, a
   batch built as the training CLI builds it (VAE-encoded synthetic 720p
   pixels, hash-tokenised text) of 8 frames on the 90x160 latent grid; one
   warm-up step and six timed steps through make_train_step, all with the
   same injected t and noise, the launch counts reset before and read
   after each step;
6. frees the I2VGen models, builds the CogVideoX-5B SR models (42-layer
   DiT, T5-XXL, causal VAE) with seeded random bf16 weights on the card
   and runs CogVideoSRPipeline.enhance_a_video on 25 frames of 480x720 (50
   DiT calls), the launch counts reset just before and read just after;
   then times one DiT CFG step at tools/bench_cog.py's shape;
7. prints one JSON line of kernel results, the card line, and as the last
   line {"ok": true, "device": {...}}.

Any failure exits non-zero before the last line is printed. Without a CUDA
card, or without the star_tpu_torch package beside it, it fails.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12    # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12        # H100 SXM HBM3
MAIN_PATH_KERNELS = ('flash_packed', 'flash_d512', 'temporal_attention',
                     'fused_gn_silu_tconv3', 'conv3x3', 'upsample_conv2x',
                     'fused_ln', 'fused_resid_ln')
# K10 and K11 launches, from the models' structure. One UNet+ControlNet
# call runs 25 temporal transformer blocks (K10 gated at norm1, K11 at
# norm2 and norm3) and 23 spatial ones (K11 at norm2 and norm3; the two at
# the middle run no K1, whence K1's 21); a train step runs them forward and
# again in the remat recompute. A CLIP text encode runs 23 blocks (ln_1,
# ln_2) and ln_final, two prompts a clip. A DiT call runs 42 layers
# (input_ln over the whole stream, post_ln on the text and image segments)
# and the two final norms over the stream.
LN_PER_CFG_STEP = {'fused_ln': 25, 'fused_resid_ln': 96}
LN_PER_TRAIN_STEP = {'fused_ln': 50, 'fused_resid_ln': 192}
LN_PER_TEXT_ENCODE = 47
LN_PER_DIT_STEP = {'fused_ln': 42 * 3 + 2}
# the CogVideoX SR clip's kernels, with their launches in one clip (50 DiT
# calls of 42 layers: K9 on q and on k, K1 once, K10 three times; and the
# two final norms)
COG_PATH_LAUNCHES = {'qk_ln_rope': 4200, 'flash_packed': 2100,
                     'fused_ln': 50 * LN_PER_DIT_STEP['fused_ln']}
# K2 at d=512 in one I2VGen clip: the VAE encode of the 8 frames in one
# call; the decode of their two 3-frame windows folded into one batch, then
# of the last 2 frames (the train step's frequency loss decodes the same)
D512_PER_CLIP = 3
# the attention kernels of a train step: the training forward of the 21
# spatial self-attentions twice (forward and remat recompute), K3 once
# each, and the VAE decode of pred-x0
ATTN_PER_TRAIN_STEP = {'flash_packed_lse': 42, 'flash_bwd': 21,
                       'flash_d512': 2}
# K5 and K6 launches by shape, from the models' structure (derived on the
# CPU from the full-depth models at narrow widths and held there by
# tests/test_torch_conv_sm90.py), at full width: (kernel, leading dims,
# latent or pixel grid, C, Cout, with a residual) -> launches. One
# UNet+ControlNet CFG call (8 frames on the 90x160 latent grid, the CFG
# pair; the ControlNet's first level runs on the unpaired x); a VAE encode
# of 8 frames of 720x1280; one VAE decoder call on windows (B, F), as the
# two calls of a clip's decode run it on (2, 3) and (1, 2).
UNET_K5_PER_CFG_CALL = {
    ((2, 8), (90, 160), 320, 320, False): 15,
    ((2, 8), (90, 160), 320, 320, True): 5,
    ((1, 8), (90, 160), 320, 320, False): 6,
    ((1, 8), (90, 160), 320, 320, True): 2,
    ((2, 8), (45, 80), 640, 640, False): 21,
    ((2, 8), (45, 80), 640, 640, True): 7,
    ((2, 8), (23, 40), 1280, 1280, False): 21,
    ((2, 8), (23, 40), 1280, 1280, True): 7,
    ((2, 8), (12, 20), 1280, 1280, False): 33,
    ((2, 8), (12, 20), 1280, 1280, True): 11}
VAE_K6_PER_ENCODE = {
    ((8,), (720, 1280), 128, 128, False): 2,
    ((8,), (720, 1280), 128, 128, True): 2,
    ((8,), (360, 640), 128, 256, False): 1,
    ((8,), (360, 640), 256, 256, False): 1,
    ((8,), (360, 640), 256, 256, True): 2,
    ((8,), (180, 320), 256, 512, False): 1,
    ((8,), (180, 320), 512, 512, False): 1,
    ((8,), (180, 320), 512, 512, True): 2,
    ((8,), (90, 160), 512, 512, False): 4,
    ((8,), (90, 160), 512, 512, True): 4}


def vae_decode_per_call(bsz, f):
    """K5 and K6 launches of one decoder call on `bsz` windows of `f`
    frames (the 3x3 convs run on the bsz*f images)."""
    k5, k6 = {}, {}
    for grid, c, n5, n6 in (((90, 160), 512, 5, 5), ((180, 320), 512, 3, 3),
                            ((360, 640), 256, 3, 2), ((720, 1280), 128, 3,
                                                      2)):
        k5[((bsz, f), grid, c, c, False)] = n5
        k5[((bsz, f), grid, c, c, True)] = n5   # the alpha fold, per frame
        k6[((bsz * f,), grid, c, c, False)] = n6
        k6[((bsz * f,), grid, c, c, True)] = n5
    # the up blocks' first conv halves the channels
    k6[((bsz * f,), (360, 640), 512, 256, False)] = 1
    k6[((bsz * f,), (720, 1280), 256, 128, False)] = 1
    return k5, k6


def vae_decode_k7_per_call(bsz, f):
    """K7 launches of one decoder call on `bsz` windows of `f` frames: its
    three upsamples, each on the bsz*f images, (images, small grid, C,
    Cout) -> launches."""
    return {((bsz * f,), grid, c, c): 1
            for grid, c in (((90, 160), 512), ((180, 320), 512),
                            ((360, 640), 256))}


K5_PER_CFG_STEP = sum(UNET_K5_PER_CFG_CALL.values())        # 128
K5_PER_DECODE = sum(vae_decode_per_call(2, 3)[0].values())   # 28
K6_PER_DECODE = sum(vae_decode_per_call(2, 3)[1].values())   # 28
K6_PER_ENCODE = sum(VAE_K6_PER_ENCODE.values())              # 20
# a clip's decode and a train step's decode of pred-x0 are the same two
# decoder calls: two 3-frame windows folded into a batch, the last 2 frames
DECODE_K7 = (vae_decode_k7_per_call(2, 3), vae_decode_k7_per_call(1, 2))
K7_BY_SHAPE = {**DECODE_K7[0], **DECODE_K7[1]}
K7_PER_CLIP = K7_PER_TRAIN_STEP = sum(K7_BY_SHAPE.values())  # 6


def unet_k5(batch: int) -> dict:
    """K5 launches of one UNet+ControlNet call on `batch` (the CFG pair:
    2, with the ControlNet's first level on 1; training: 1)."""
    out = {}
    for (lead, *rest), n in UNET_K5_PER_CFG_CALL.items():
        key = ((min(lead[0], batch), lead[1]), *rest)
        out[key] = out.get(key, 0) + n
    return out


def k7_work(n, h, w, c, cout) -> tuple[float, float]:
    """K7's FLOPs and bytes on x [n, h, w, c]: four phase 2x2 convs on the
    small grid; x read once, the [16, C, Cout] bf16 weights, the 2x output
    written once, the fp32 bias and statistics."""
    flops = 2.0 * n * 4 * h * w * 4 * c * cout
    nbytes = (2 * (n * h * w * c + 16 * c * cout + 4 * n * h * w * cout)
              + 4 * cout + 8 * n * cout)
    return flops, nbytes


def bound_sum_ms(kind: str, *tables: dict) -> float:
    """Sum over shapes of launches x bound (bound_ms) of K5, K6 or K7."""
    total = 0.0
    for table in tables:
        for key, n in table.items():
            if kind == 'k7':
                (imgs,), (h, w), c, cout = key
                total += n * bound_ms(*k7_work(imgs, h, w, c, cout))[0]
                continue
            lead, grid, c, cout, res = key
            m = math.prod(lead) * grid[0] * grid[1]
            flops = 2.0 * m * (3 if kind == 'k5' else 9) * c * cout
            nbytes = 2 * (m * c + m * cout * (2 if res else 1)
                          + (3 if kind == 'k5' else 9) * c * cout)
            total += n * bound_ms(flops, nbytes)[0]
    return total


# the bound of each path's K5 and K6 launches (ms): a CFG step, a train
# step (forward and remat recompute, the decode of pred-x0), a clip (14
# CFG steps, the encode of 8 frames, the two decoder calls)
DECODE_K5 = (vae_decode_per_call(2, 3)[0], vae_decode_per_call(1, 2)[0])
DECODE_K6 = (vae_decode_per_call(2, 3)[1], vae_decode_per_call(1, 2)[1])
TRAIN_TIMED_STEPS = 6
# the train step's kernels: the UNet's under autograd, and the VAE decode of
# pred-x0 for the frequency loss (no grad)
TRAIN_PATH_KERNELS = ('flash_packed_lse', 'flash_bwd', 'flash_d512',
                      'temporal_attention', 'fused_gn_silu_tconv3',
                      'conv3x3', 'upsample_conv2x', 'fused_ln',
                      'fused_resid_ln')


def log(msg: str) -> None:
    print(f'[chip_smoke {time.strftime("%H:%M:%S")}] {msg}', flush=True)


def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f'nvidia-smi failed: {out.stderr}')
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5, warmup: int = 1, graph: bool = False) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events. With `graph`,
    `reps` calls are captured in one CUDA graph and its replay is timed, so
    that a kernel shorter than its wrapper's host work is timed on the
    device and not at the rate the host enqueues it."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    run = lambda: [fn() for _ in range(reps)]
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        run = g.replay
        run()
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def k7_shapes():
    """Counts K7's launches by (images, small grid, C, Cout) while on, in
    the keys of vae_decode_k7_per_call."""
    from star_tpu_torch.ops import upsample_conv as uc
    real, seen = uc._launch_upsample, {}

    def launch(x, k_rs, bias, want_stats):
        key = ((x.shape[0],), tuple(x.shape[1:3]), x.shape[3],
               k_rs.shape[-1])
        seen[key] = seen.get(key, 0) + 1
        return real(x, k_rs, bias, want_stats)
    uc._launch_upsample = launch
    try:
        yield seen
    finally:
        uc._launch_upsample = real


def assert_launches(what: str, counts: dict, want: dict) -> None:
    """The exact launches of the kernels in `want`."""
    got = {k: counts.get(k, 0) for k in want}
    assert got == want, f'{what}: launches {got}, want {want}'


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops = flops / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            'operations' if t_ops >= t_bytes else 'bytes')


# A bf16 kernel agrees with its plain version when its largest error is
# within MAX_TOL of the plain output's largest magnitude (3 to 5 bf16 ulps
# there) and its RMS error within RMS_TOL of the plain output's RMS (one
# bf16 rounding alone gives about 2e-3). Both are relative with no floor:
# attention outputs at these shapes are near 0.01 in size, so an absolute
# floor would pass a softmax 20% off or a lost key tile.
MAX_TOL, RMS_TOL = 2e-2, 1e-2


def agrees(what: str, pairs) -> tuple[float, float, float]:
    """pairs of (kernel output, plain output) -> (max |kernel - plain|,
    max |plain|, rms(kernel - plain) / rms(plain)); raises on disagreement."""
    import torch
    err = mag = sq_err = sq_ref = 0.0
    for out, ref in pairs:
        ref = ref.float()
        diff = out.float() - ref
        err = max(err, diff.abs().max().item())
        mag = max(mag, ref.abs().max().item())
        sq_err += torch.linalg.vector_norm(diff).item() ** 2
        sq_ref += torch.linalg.vector_norm(ref).item() ** 2
        del diff, ref
    rel = math.sqrt(sq_err / sq_ref)
    log(f'{what}: max err {err:.3e} (tol {MAX_TOL * mag:.3e}), rms err '
        f'{rel:.3e} of rms (tol {RMS_TOL:.0e})')
    if not (err <= MAX_TOL * mag and rel <= RMS_TOL):
        raise AssertionError(f'{what} disagrees with its plain version')
    return err, mag, rel


# --------------------------------------------------------------------------
# phase 2: each kernel against its plain version at main-path shapes


# K1's edge shapes: (B, S, H*64, kv_valid or None, prescaled)
K1_EDGE_CASES = ((2, 1000, 320, 777, False), (2, 1000, 320, 768, False),
                 (2, 1000, 320, None, True), (2, 100, 320, None, False),
                 (2, 1000, 640, None, False), (2, 1000, 1280, 999, False),
                 (1, 1000, 3072, 777, True), (1, 9680, 320, 9676, True))


def check_kernels(dev) -> dict[str, dict]:
    import torch
    import torch.nn.functional as F
    from star_tpu_torch.ops import (flash_attention as fa,
                                    fused_temporal_conv as ftc,
                                    temporal_attention as ta)
    from star_tpu_torch.ops.conv3x3 import channel_stats, gn_coeffs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s, scale=1.0: (torch.randn(
        s, generator=g, device=dev) * scale).to(torch.bfloat16)
    results = {}

    def record(name, route, source, replaces, agree, ms, plain_ms, flops,
               nbytes, library_ms, shape):
        err, mag, rel = agree
        b_ms, b_by = bound_ms(flops, nbytes)
        results[name] = dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=0, max_abs_err=err, tol=MAX_TOL * mag,
            rel_rms_err=rel, rel_rms_tol=RMS_TOL, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
            shape=shape)
        log(f'{name} {shape}: kernel {ms:.3f} ms plain {plain_ms:.3f} ms '
            f'library '
            f'{library_ms if library_ms is None else round(library_ms, 3)} '
            f'ms bound {b_ms:.3f} ms ({b_by})')

    # K1: UNet spatial self-attention, 320 channels (5 heads of 64) at
    # 90x160 tokens, 16 frames (cfg pair); the other scales are checked
    # for agreement only
    for (bsz, s, c) in ((16, 3680, 640), (16, 960, 1280), (2, 700, 320)):
        h = c // 64
        q, k, v = (randn(bsz, s, c) for _ in range(3))
        agrees(f'K1 [{bsz},{s},{c}]', [(
            fa.flash_attention_packed(q, k, v, h),
            fa.flash_attention_packed_plain(q, k, v, h, 0.125))])
    # the edges of K1's tiles (128 query rows a block, 128 keys a tile):
    # S not a multiple of 128, S below one tile, kv_valid inside a tile and
    # on a tile boundary, 5 to 48 heads, and a prescaled q
    for (bsz, s, c, kv, pre) in K1_EDGE_CASES:
        h = c // 64
        q, k, v = (randn(bsz, s, c) for _ in range(3))
        if pre:
            q = (q.float() * (0.125 * fa.LOG2E)).to(torch.bfloat16)
        agrees(f'K1 [{bsz},{s},{c}] kv_valid={kv} prescaled={pre}', [(
            fa.flash_attention_packed(q, k, v, h, kv_valid=kv,
                                      prescaled=pre),
            fa.flash_attention_packed_plain(q, k, v, h, 0.125, kv_valid=kv,
                                            prescaled=pre))])

    bsz, s, c, h = 16, 14400, 320, 5
    q, k, v = (randn(bsz, s, c) for _ in range(3))
    out = fa.flash_attention_packed(q, k, v, h)
    # plain logits of one frame take 4 GB in fp32: two frames are compared
    agree = agrees(f'K1 [{bsz},{s},{c}] frames 0 and {bsz - 1}', (
        (out[bi:bi + 1], fa.flash_attention_packed_plain(
            q[bi:bi + 1], k[bi:bi + 1], v[bi:bi + 1], h, 0.125))
        for bi in (0, bsz - 1)))
    ms = cuda_ms(lambda: fa.flash_attention_packed(q, k, v, h))

    def plain_k1():
        for bi in range(bsz):
            fa.flash_attention_packed_plain(q[bi:bi + 1], k[bi:bi + 1],
                                            v[bi:bi + 1], h, 0.125)
    plain_ms = cuda_ms(plain_k1, reps=1)
    to4 = lambda t: t.view(bsz, s, h, 64).transpose(1, 2)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        to4(q), to4(k), to4(v)))
    record('flash_packed', 'cuda', 'star_tpu_torch/csrc/flash_fwd_sm90.cu',
           'star_tpu/ops/flash_attention.py:419', agree, ms, plain_ms,
           4.0 * bsz * h * s * s * 64, 4 * q.numel() * 2, lib_ms,
           [bsz, s, c])
    del q, k, v, out

    # K2 at d=512: the SVD-VAE mid attention, one head of 512 on the
    # 90x160 latent grid. Held at the decoder's shape (its two 3-frame
    # windows decode together), at a ragged S with a dead key tail, and at
    # phase 2b's small VAE (3 frames of 24x24); then at the encoder's 8
    # frames, which is also timed.
    sc512 = 1 / math.sqrt(512)
    for (bsz, s, kv) in ((6, 14400, 14400), (2, 1000, 777), (3, 576, 576)):
        q, k, v = (randn(bsz, s, 1, 512) for _ in range(3))
        agrees(f'K2 d=512 [{bsz},{s},1,512] kv_valid={kv}', [(
            fa._launch(q, k, v, 1, 512, sc512 * fa.LOG2E, kv),
            fa.attention_plain(q, k[:, :kv], v[:, :kv], sc512))])
        del q, k, v
    bsz, s, d = 8, 14400, 512
    q, k, v = (randn(bsz, s, 1, d) for _ in range(3))
    agree = agrees(f'K2 d=512 [{bsz},{s},1,{d}]', [(
        fa.flash_attention(q, k, v), fa.attention_plain(q, k, v, sc512))])
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v))
    plain_ms = cuda_ms(lambda: fa.attention_plain(q, k, v, sc512), reps=1)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)))
    flops = 4.0 * bsz * s * s * d
    log(f'K2 d=512 [{bsz},{s},1,{d}]: {flops / ms / 1e9:.0f} TFLOP/s, SDPA '
        f'{flops / lib_ms / 1e9:.0f} TFLOP/s')
    record('flash_d512', 'cuda', 'star_tpu_torch/csrc/flash_fwd_d512_sm90.cu',
           'star_tpu/ops/flash_attention.py:256', agree, ms, plain_ms,
           flops, 4 * q.numel() * 2, lib_ms, [bsz, s, 1, d])
    results['flash_d512']['tflops'] = flops / ms / 1e9
    del q, k, v

    # K4: UNet temporal attention, 8 frames, 320 channels (5 heads) at
    # 90x160, cfg pair; plus the init-temporal 8-head scale and F=3
    for (bsz, f, n, c) in ((2, 8, 3680, 512), (1, 3, 960, 1280)):
        q, k, v = (randn(bsz, f, n, c) for _ in range(3))
        agrees(f'K4 [{bsz},{f},{n},{c}]', [(
            ta.temporal_attention(q, k, v, c // 64),
            ta.temporal_attention_plain(q, k, v, c // 64, 0.125))])
    bsz, f, n, c = 2, 8, 14400, 320
    h = c // 64
    q, k, v = (randn(bsz, f, n, c) for _ in range(3))
    agree = agrees(f'K4 [{bsz},{f},{n},{c}]', [(
        ta.temporal_attention(q, k, v, h),
        ta.temporal_attention_plain(q, k, v, h, 0.125))])
    ms = cuda_ms(lambda: ta.temporal_attention(q, k, v, h), reps=20)
    plain_ms = cuda_ms(lambda: ta.temporal_attention_plain(q, k, v, h,
                                                           0.125), reps=2)
    tb = lambda t: t.view(bsz, f, n, h, 64).permute(0, 2, 3, 1, 4)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        tb(q), tb(k), tb(v)), reps=5)
    record('temporal_attention', 'cuda',
           'star_tpu_torch/csrc/temporal_attention.cu',
           'star_tpu/ops/temporal_attention.py:142', agree, ms, plain_ms,
           4.0 * bsz * h * f * f * n * 64, 4 * q.numel() * 2, lib_ms,
           [bsz, f, n, c])
    del q, k, v

    # K5 at every shape of the main paths: the UNet's TemporalConvBlockV2
    # stages at its four levels (16 frames as a cfg pair of 8; the first
    # with a residual), the train step's batch of 1, and the VAE decoder's
    # alpha-folded conv2 at 128 channels (two 3-frame windows of 720x1280,
    # then the 2-frame tail) with per-frame statistics
    def k5_case(bsz, f, n, c, cout, residual, per_frame, timed):
        x = randn(bsz, f, n, c)
        sc = torch.rand(c, generator=g, device=dev) * 0.2 + 0.9
        bi = torch.randn(c, generator=g, device=dev) * 0.1
        w = torch.randn(3, 1, c, cout, generator=g, device=dev) \
            / math.sqrt(3 * c)
        cb = torch.randn(cout, generator=g, device=dev) * 0.1
        r = randn(bsz, f, n, cout) if residual else None
        st = channel_stats(x.reshape(bsz, f * n, c))
        y, sty = ftc.fused_gn_silu_tconv3(x, sc, bi, w, cb, stats=st,
                                          residual=r, want_stats=True,
                                          stats_per_frame=per_frame)
        a, b = gn_coeffs(st, f * n * (c // 32), sc, bi, 32, 1e-5)
        yr, str_ = ftc.tconv3_plain(x, a, b, w[:, 0], cb, r, True, per_frame)
        what = f'K5 [{bsz},{f},{n},{c}->{cout}]'
        agree = agrees(what, [(y, yr)])
        del y, yr
        stats_agree(what, sty, str_)
        if not timed:
            return None
        ms = cuda_ms(lambda: ftc.fused_gn_silu_tconv3(
            x, sc, bi, w, cb, stats=st, residual=r, want_stats=True,
            stats_per_frame=per_frame), reps=5)
        plain_ms = cuda_ms(lambda: ftc.tconv3_plain(
            x, a, b, w[:, 0], cb, r, True, per_frame), reps=2)
        yp = F.pad(x, (0, 0, 0, 0, 1, 1))
        ys = torch.cat([yp[:, t:t + f] for t in range(3)], dim=-1)
        wb = w[:, 0].reshape(3 * c, cout).to(torch.bfloat16)
        lib_ms = cuda_ms(lambda: torch.matmul(ys, wb), reps=5)
        m = bsz * f * n
        nbytes = 2 * (x.numel() + m * cout * (2 if residual else 1)
                      + w.numel()) + 8 * st[0].numel() + 8 * sty[0].numel()
        return agree, ms, plain_ms, 2.0 * m * 3 * c * cout, nbytes, lib_ms

    # edges: C and Cout not whole 128-column tiles, a 3-frame window with
    # a pixel tail
    k5_case(1, 8, 3680, 640, 640, False, False, False)
    k5_case(1, 3, 3680, 256, 256, True, True, False)
    k5_case(2, 3, 5000, 512, 512, True, True, False)
    # the main paths' shapes, each timed: the UNet's four levels (CFG
    # pair), the train step's batch of 1, the VAE decoder's windows
    k5 = k5_case(2, 8, 14400, 320, 320, True, False, True)
    record('fused_gn_silu_tconv3', 'cuda',
           'star_tpu_torch/csrc/fused_tconv3_sm90.cu',
           'star_tpu/ops/fused_temporal_conv.py:225', k5[0], *k5[1:],
           [2, 8, 14400, 320])
    shapes = []
    for shape, res, pf in (((2, 8, 3600, 640, 640), False, False),
                           ((2, 8, 920, 1280, 1280), False, False),
                           ((2, 8, 240, 1280, 1280), False, False),
                           ((1, 8, 14400, 320, 320), True, False),
                           ((2, 3, 921600, 128, 128), True, True),
                           ((1, 2, 921600, 128, 128), True, True)):
        k5 = k5_case(*shape, res, pf, True)
        shapes.append(sub_record(list(shape[:4]), k5[0], *k5[1:],
                                 residual=res, per_frame=pf))
    results['fused_gn_silu_tconv3']['shapes'] = shapes
    torch.cuda.synchronize()
    check_vae_kernels(dev, g, randn, record, results)
    check_train_kernels(dev, randn, record, results)
    check_dit_kernels(dev, g, randn, record, results)
    check_ln_kernels(dev, g, record, results)
    return results


def sub_record(shape, agree, ms, plain_ms, flops, nbytes, library_ms,
               **extra) -> dict:
    """A second timed shape of a kernel, logged and kept under its row."""
    b_ms, b_by = bound_ms(flops, nbytes)
    log(f'{shape}: kernel {ms:.3f} ms plain {plain_ms:.3f} ms library '
        f'{library_ms:.3f} ms bound {b_ms:.3f} ms ({b_by})')
    return dict(shape=shape, max_abs_err=agree[0], rel_rms_err=agree[2],
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=b_ms, bound_by=b_by, **extra)


def stats_agree(what, st, st_ref) -> float:
    """Output statistics of a kernel against its plain version, relative
    to the largest sum of squares: the stored bf16 values may round
    differently, and the atomic adds run in a varying order."""
    err = max(((st[i] - st_ref[i]).abs().max()
               / st_ref[1].abs().max()).item() for i in range(2))
    log(f'{what} stats err {err:.3e} of the largest sum of squares '
        f'(tol 2e-2)')
    assert err <= 2e-2, (what, err)
    return err


def check_vae_kernels(dev, g, randn, record, results) -> None:
    """K6, K7 and K8 at the full-width VAE's shapes (encoder on 8 frames
    of 720x1280, decoder calls of 6 and 2 frames)."""
    import torch
    import torch.nn.functional as F
    from star_tpu_torch.ops import conv3x3 as c3, upsample_conv as uc

    # K6: the plain version's fp32 conv must not run in TF32 (set above)
    def k6_case(n, h, w, c, cout, residual, timed):
        x = randn(n, h, w, c)
        sc = torch.rand(c, generator=g, device=dev) * 0.2 + 0.9
        bi = torch.randn(c, generator=g, device=dev) * 0.1
        wt = (torch.randn(cout, c, 3, 3, generator=g, device=dev)
              / math.sqrt(9 * c)).to(torch.bfloat16)
        cb = torch.randn(cout, generator=g, device=dev) * 0.1
        r = randn(n, h, w, cout) if residual else None
        st = c3.channel_stats(x)
        what = f'K6 [{n},{h},{w},{c}->{cout}]{" +res" if residual else ""}'
        y, sty = c3.fused_gn_silu_conv3x3(x, sc, bi, wt, cb, stats=st,
                                          residual=r, want_stats=True)
        a, b = c3.gn_coeffs(st, h * w * (c // 32), sc, bi, 32, 1e-6)
        yr, str_ = c3.conv3x3_plain(x, a, b, wt, cb, r, True)
        agree = agrees(what, [(y, yr)])
        stats_agree(what, sty, str_)
        del y, yr
        if not timed:
            return None
        ms = cuda_ms(lambda: c3.fused_gn_silu_conv3x3(
            x, sc, bi, wt, cb, stats=st, residual=r, want_stats=True))
        plain_ms = cuda_ms(lambda: c3.conv3x3_plain(x, a, b, wt, cb, r,
                                                    True), reps=1)
        # library: one cuDNN conv of the pre-activated channels_last input
        ya = F.silu(x * a.to(x.dtype)[:, None, None]
                    + b.to(x.dtype)[:, None, None]).permute(0, 3, 1, 2)
        cb16 = cb.to(torch.bfloat16)
        lib_ms = cuda_ms(lambda: F.conv2d(ya, wt, cb16, 1, 1))
        m = n * h * w
        nbytes = (2 * (x.numel() + m * cout * (2 if residual else 1)
                       + 9 * c * cout) + 8 * n * c + 8 * n * cout)
        return agree, ms, plain_ms, 2.0 * m * 9 * c * cout, nbytes, lib_ms

    k6 = k6_case(8, 720, 1280, 128, 128, True, True)     # encoder down_0
    record('conv3x3', 'cuda', 'star_tpu_torch/csrc/conv3x3_sm90.cu',
           'star_tpu/ops/conv3x3.py:278', k6[0], *k6[1:],
           [8, 720, 1280, 128, 128])
    k6b = k6_case(6, 360, 640, 256, 256, True, True)      # decoder up_2
    results['conv3x3']['k6b'] = sub_record(
        [6, 360, 640, 256, 256], k6b[0], *k6b[1:],
        replaces='star_tpu/ops/conv3x3.py:904')
    shapes = []
    for shape, res in (((8, 360, 640, 128, 256), False),  # encoder down_1
                       ((6, 720, 1280, 256, 128), True),  # decoder up_3
                       ((6, 90, 160, 512, 512), False)):  # ragged H = 90
        k6 = k6_case(*shape, res, True)
        shapes.append(sub_record(list(shape), k6[0], *k6[1:], residual=res))
    results['conv3x3']['shapes'] = shapes
    results['conv3x3']['k6c'] = dict(
        replaces='star_tpu/ops/conv3x3.py:656',
        computed_by='the same kernel (csrc/conv3x3_sm90.cu)')
    torch.cuda.synchronize()

    # K7: the three decoder upsamples, with statistics, each timed. The
    # plain version rounds K_rs to bf16 as the kernel does; the library
    # call (nearest upsample + cuDNN conv with the bf16 3x3 weights) shows
    # what that rounding costs against the un-decomposed conv.
    def k7_case(n, h, w, c):
        x = randn(n, h, w, c)
        wt = (torch.randn(c, c, 3, 3, generator=g, device=dev)
              / math.sqrt(9 * c)).to(torch.bfloat16)
        cb = torch.randn(c, generator=g, device=dev) * 0.1
        what = f'K7 [{n},{h},{w},{c}] -> [{n},{2 * h},{2 * w},{c}]'
        y, sty = uc.upsample_conv2x(x, wt, cb, want_stats=True)
        k_rs = uc.phase_weights(wt)
        yr, str_ = uc.upsample_conv2x_plain(x, k_rs, cb, True)
        agree = agrees(what, [(y, yr)])
        stats_agree(what, sty, str_)
        del yr
        x_nchw, cb16 = x.permute(0, 3, 1, 2), cb.to(torch.bfloat16)
        library = lambda: F.conv2d(F.interpolate(
            x_nchw, scale_factor=2.0, mode='nearest'), wt, cb16, 1, 1)
        agrees(what + ' vs interpolate + 3x3 conv',
               [(y, library().permute(0, 2, 3, 1))])
        del y
        ms = cuda_ms(lambda: uc.upsample_conv2x(x, wt, cb, want_stats=True))
        plain_ms = cuda_ms(lambda: uc.upsample_conv2x_plain(x, k_rs, cb,
                                                            True), reps=1)
        lib_ms = cuda_ms(library)
        return agree, ms, plain_ms, *k7_work(n, h, w, c, c), lib_ms

    k7s = [k7_case(6, 90, 160, 512), k7_case(6, 180, 320, 512)]
    k7 = k7_case(6, 360, 640, 256)
    record('upsample_conv2x', 'cuda',
           'star_tpu_torch/csrc/upsample_conv_sm90.cu',
           'star_tpu/ops/conv3x3.py:1117', k7[0], *k7[1:],
           [6, 360, 640, 256, 256])
    results['upsample_conv2x']['library'] = (
        'two calls: F.interpolate(nearest) + F.conv2d')
    results['upsample_conv2x']['shapes'] = [
        sub_record([6, h, w, 512, 512], k[0], *k[1:])
        for (h, w), k in zip(((90, 160), (180, 320)), k7s)]
    torch.cuda.synchronize()

    # K8 at the phase shapes of the 256-channel upsample, with statistics
    n, h, w, c = 6, 360, 640, 256
    ps = [randn(n, h, w, c) for _ in range(4)]
    y, sty = uc.interleave2x2(*ps, want_stats=True)
    yr, str_ = uc.interleave2x2_plain(*ps, want_stats=True)
    what = f'K8 4x[{n},{h},{w},{c}]'
    agree = agrees(what, [(y, yr)])
    assert torch.equal(y, yr), 'K8 moved a value'
    stats_agree(what, sty, str_)
    del y, yr
    ms = cuda_ms(lambda: uc.interleave2x2(*ps, want_stats=True), reps=10)
    plain_ms = cuda_ms(lambda: uc.interleave2x2_plain(*ps, want_stats=True),
                       reps=2)
    record('interleave2x2', 'cuda', 'star_tpu_torch/csrc/interleave2x2.cu',
           'star_tpu/ops/conv3x3.py:1216', agree, ms, plain_ms, 0.0,
           2 * 2 * 4 * n * h * w * c, None, [n, h, w, c])
    results['interleave2x2']['library'] = (
        'none: no single PyTorch call interleaves four tensors')
    del ps
    torch.cuda.synchronize()


def bwd_plain_chunked(q, k, v, o, lse, do, heads: int, scale: float):
    """flash_bwd_plain one (batch, head) at a time: its [S, S] fp32
    temporaries of one head at 14400 tokens take 0.8 GB each."""
    import torch
    from star_tpu_torch.ops import flash_attention as fa
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    for bi in range(q.shape[0]):
        for hi in range(heads):
            cols = slice(hi * 64, (hi + 1) * 64)
            got = fa.flash_bwd_plain(
                *(t[bi:bi + 1, :, cols] for t in (q, k, v, o)),
                lse[bi:bi + 1, hi:hi + 1], do[bi:bi + 1, :, cols], 1, scale)
            for out, g in zip((dq, dk, dv), got):
                out[bi:bi + 1, :, cols] = g
    return dq, dk, dv


def check_train_kernels(dev, randn, record, results) -> None:
    """K2 `with_l` (output and lse) and K3 (dq, dk, dv) against their plain
    versions at the UNet's three attention scales of a train step (8
    frames: 14400, 3680 and 960 tokens), a dead kv tail and a prescaled q;
    both timed at [8, 14400, 320]; and gradients through the autograd
    Function against torch.autograd through attention_plain."""
    import torch
    import torch.nn.functional as F
    from star_tpu_torch.ops import flash_attention as fa

    def lse_fwd(q, k, v, h, kv=None, c=0.125 * fa.LOG2E):
        return fa._launch(q, k, v, h, 64, c, k.shape[1] if kv is None else kv,
                          want_lse=True)

    def lse_agrees(what, lse, lse_ref):
        # natural-log units: one bf16 rounding of the largest logit would
        # move it by about 1e-2; the kernel's fp32 sums stay near 1e-5
        err = (lse - lse_ref).abs().max().item()
        log(f'{what} lse: max err {err:.3e} (tol 1e-3)')
        assert err <= 1e-3, (what, err)
        return err

    for (bsz, s, c) in ((1, 14400, 320), (2, 3680, 640), (2, 960, 1280)):
        h = c // 64
        q, k, v, do = (randn(bsz, s, c) for _ in range(4))
        what = f'[{bsz},{s},{c}]'
        o, lse = lse_fwd(q, k, v, h)
        o_ref, lse_ref = fa.flash_attention_packed_plain(
            q, k, v, h, 0.125, return_lse=True)
        agrees(f'K2 with_l {what}', [(o, o_ref)])
        lse_agrees(f'K2 with_l {what}', lse, lse_ref)
        del o_ref, lse_ref
        got = fa._launch_bwd(q, k, v, o, lse, do, h, 0.125, s)
        want = bwd_plain_chunked(q, k, v, o, lse, do, h, 0.125)
        for name, a, b in zip(('dq', 'dk', 'dv'), got, want):
            agrees(f'K3 {name} {what}', [(a, b)])
        del q, k, v, do, o, lse, got, want
    # dead kv tail and prescaled q
    q, k, v, do = (randn(2, 1000, 320) for _ in range(4))
    for what, qq, c, scale in (
            ('kv_valid=777', q, 0.125 * fa.LOG2E, 0.125),
            ('kv_valid=777 prescaled',
             (q.float() * (0.125 * fa.LOG2E)).to(torch.bfloat16), 1.0,
             fa.LN2)):
        o, lse = lse_fwd(qq, k, v, 5, 777, c)
        o_ref, lse_ref = fa.flash_attention_packed_plain(
            qq, k, v, 5, scale, 777, return_lse=True)
        agrees(f'K2 with_l {what} [2,1000,320]', [(o, o_ref)])
        lse_agrees(f'K2 with_l {what}', lse, lse_ref)
        got = fa._launch_bwd(qq, k, v, o, lse, do, 5, scale, 777)
        want = fa.flash_bwd_plain(qq, k[:, :777], v[:, :777], o, lse, do,
                                  5, scale)
        agrees(f'K3 {what} [2,1000,320]', [(got[0], want[0]),
                                           (got[1][:, :777], want[1]),
                                           (got[2][:, :777], want[2])])
        assert all(float(t[:, 777:].abs().max()) == 0.0 for t in got[1:])
    # the DiT's attention shape: 9680 tokens, 48 heads, the dead key tail
    # of its padded stream, a prescaled q (the plain versions one head or 8
    # heads at a time: the fp32 logits of 48 heads would take 18 GB)
    s, c, h, kv = 9680, 3072, 48, 9676
    q, k, v, do = (randn(2, s, c) for _ in range(4))
    q = (q.float() * (0.125 * fa.LOG2E)).to(torch.bfloat16)
    what = f'[2,{s},{c}] 48 heads kv_valid={kv} prescaled'
    o, lse = lse_fwd(q, k, v, h, kv, c=1.0)
    o_ref, lse_ref = packed_plain_chunked(q, k, v, h, kv, prescaled=True,
                                          return_lse=True)
    agrees(f'K2 with_l {what}', [(o, o_ref)])
    lse_agrees(f'K2 with_l {what}', lse, lse_ref)
    del o_ref, lse_ref
    got = fa._launch_bwd(q, k, v, o, lse, do, h, fa.LN2, kv)
    want = bwd_plain_chunked(q, k[:, :kv], v[:, :kv], o, lse, do, h, fa.LN2)
    agrees(f'K3 {what}', [(got[0], want[0]), (got[1][:, :kv], want[1]),
                          (got[2][:, :kv], want[2])])
    assert all(float(t[:, kv:].abs().max()) == 0.0 for t in got[1:])
    del q, k, v, do, o, lse, got, want
    # the autograd Function end to end against autograd through the plain
    # attention
    q, k, v, do = (randn(2, 3680, 640) for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(fa.flash_attention_packed(*leaves, 10),
                              leaves, do)
    to4 = lambda t: t.view(2, 3680, 10, 64)
    ref_out = fa.attention_plain(*(to4(t) for t in leaves), 0.125)
    want = torch.autograd.grad(ref_out, leaves, to4(do))
    agrees('autograd flash_attention_packed [2,3680,640] vs autograd '
           'through attention_plain', list(zip(got, want)))
    del q, k, v, do, leaves, got, want, ref_out
    torch.cuda.synchronize()

    # timing at the train step's 14400-token scale, 8 frames, 5 heads
    bsz, s, c, h = 8, 14400, 320, 5
    q, k, v, do = (randn(bsz, s, c) for _ in range(4))
    o, lse = lse_fwd(q, k, v, h)
    agree_f = agrees(f'K2 with_l [{bsz},{s},{c}] frame {bsz - 1}', [(
        o[-1:], fa.flash_attention_packed_plain(
            q[-1:], k[-1:], v[-1:], h, 0.125))])
    fwd_ms = cuda_ms(lambda: lse_fwd(q, k, v, h))
    k1_ms = cuda_ms(lambda: fa.flash_attention_packed(q, k, v, h))

    def plain_fwd():
        for bi in range(bsz):
            fa.flash_attention_packed_plain(q[bi:bi + 1], k[bi:bi + 1],
                                            v[bi:bi + 1], h, 0.125,
                                            return_lse=True)
    plain_fwd_ms = cuda_ms(plain_fwd, reps=1)
    to4 = lambda t: t.view(bsz, s, h, 64).transpose(1, 2)
    qg, kg, vg = (to4(t).detach().requires_grad_() for t in (q, k, v))
    with torch.enable_grad():   # SDPA's training forward saves its lse
        lib_fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qg, kg, vg))
    log(f'lse forward [{bsz},{s},{c}]: {fwd_ms:.3f} ms against K1 without '
        f'lse {k1_ms:.3f} ms in the same call')
    record('flash_packed_lse', 'cuda',
           'star_tpu_torch/csrc/flash_fwd_sm90.cu',
           'star_tpu/ops/flash_attention.py:256', agree_f, fwd_ms,
           plain_fwd_ms, 4.0 * bsz * h * s * s * 64,
           4 * q.numel() * 2 + 4 * bsz * h * s, lib_fwd_ms, [bsz, s, c])
    results['flash_packed_lse'].update(
        mode='K2 with_l: the d=64 forward writing the natural log-sum-exp',
        k1_ms_same_call=k1_ms)

    got = fa._launch_bwd(q, k, v, o, lse, do, h, 0.125, s)
    want = bwd_plain_chunked(q[-1:], k[-1:], v[-1:], o[-1:], lse[-1:],
                             do[-1:], h, 0.125)
    agree = agrees(f'K3 [{bsz},{s},{c}] frame {bsz - 1}',
                   [(a[-1:], b) for a, b in zip(got, want)])
    # the dQ adds land in no fixed order: how far two launches differ
    dq2 = fa._launch_bwd(q, k, v, o, lse, do, h, 0.125, s)[0]
    dq_spread = float((got[0].float() - dq2.float()).abs().max())
    log(f'K3 [{bsz},{s},{c}] dq of two launches: max |dq1 - dq2| '
        f'{dq_spread:.3e} (max |dq| {float(got[0].abs().max()):.3e})')
    del got, want, dq2
    ms = cuda_ms(lambda: fa._launch_bwd(q, k, v, o, lse, do, h, 0.125, s),
                 reps=3)
    plain_ms = cuda_ms(lambda: bwd_plain_chunked(q, k, v, o, lse, do, h,
                                                 0.125), reps=1, warmup=0)
    out = F.scaled_dot_product_attention(qg, kg, vg)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(
        out, (qg, kg, vg), to4(do), retain_graph=True), reps=3)
    flops = 10.0 * bsz * h * s * s * 64
    log(f'K3 [{bsz},{s},{c}]: {flops / ms / 1e9:.0f} TFLOP/s, SDPA backward '
        f'{flops / lib_ms / 1e9:.0f} TFLOP/s')
    # bytes: q, k, v, o, dO read, lse read, dq, dk, dv written
    record('flash_bwd', 'cuda', 'star_tpu_torch/csrc/flash_bwd_sm90.cu',
           'star_tpu/ops/flash_attention.py:592', agree, ms, plain_ms,
           flops, 8 * q.numel() * 2 + 4 * bsz * h * s, lib_ms, [bsz, s, c])
    results['flash_bwd'].update(
        library='the backward of F.scaled_dot_product_attention',
        tflops=flops / ms / 1e9, dq_run_to_run_max_abs=dq_spread)
    del q, k, v, do, o, lse, qg, kg, vg, out
    torch.cuda.synchronize()


def packed_plain_chunked(q, k, v, heads: int, kv_valid: int,
                         prescaled: bool = True, return_lse: bool = False):
    """flash_attention_packed_plain (of a prescaled q by default), one batch
    row and 8 heads at a time: the fp32 logits of all 48 heads of one row
    at 9680 tokens would take 18 GB. With `return_lse` also the lse
    [B, heads, Sq]."""
    import torch
    from star_tpu_torch.ops import flash_attention as fa
    head_chunk = 8
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[0], heads, q.shape[1], device=q.device)
    for bi in range(q.shape[0]):
        for h0 in range(0, heads, head_chunk):
            cols = slice(h0 * 64, (h0 + head_chunk) * 64)
            res = fa.flash_attention_packed_plain(
                *(t[bi:bi + 1, :, cols] for t in (q, k, v)), head_chunk,
                0.125, kv_valid=kv_valid, prescaled=prescaled,
                return_lse=return_lse)
            if return_lse:
                res, lse[bi:bi + 1, h0:h0 + head_chunk] = res
            out[bi:bi + 1, :, cols] = res
    return (out, lse) if return_lse else out


def check_dit_kernels(dev, g, randn, record, results) -> None:
    """K9 (qk-LayerNorm + RoPE) and K1 at the CogVideoX DiT's attention
    shape: q/k/v [2, 9680, 3072], 48 heads, the DiT's RoPE tables (identity
    rows 0-225 and 9676-9679, 3D RoPE between), K9 on q with the softmax
    scale * log2(e) folded in and on k with 1; then K1 prescaled with
    kv_valid=9676 on K9's outputs."""
    import torch
    import torch.nn.functional as F
    from star_tpu_torch.models.dit.dit import rope_tables
    from star_tpu_torch.ops import flash_attention as fa, qk_ln_rope as qr

    b, s, heads, valid = 2, 9680, 48, 9676
    c = heads * 64
    cos, sin = (torch.from_numpy(a).to(dev)
                for a in rope_tables(226, 7, 30, 45, s, 64))
    fold_q = qr.LOG2E / 8.0
    qkv = []
    for what, fold in (('q', fold_q), ('k', 1.0)):
        x = (torch.randn(b, s, c, generator=g, device=dev) * 2 + 0.5) \
            .to(torch.bfloat16)
        sc = torch.randn(64, generator=g, device=dev) * 0.1 + 1.0
        bi = torch.randn(64, generator=g, device=dev) * 0.1
        out = qr.qk_ln_rope(x, sc, bi, cos, sin, heads, fold_scale=fold)
        agree = agrees(f'K9 {what} [{b},{s},{c}] fold {fold:.4f}', [(
            out, qr.qk_ln_rope_plain(x, sc, bi, cos, sin, heads,
                                     fold_scale=fold))])
        qkv.append(out)
    ms = cuda_ms(lambda: qr.qk_ln_rope(x, sc, bi, cos, sin, heads), reps=20)
    plain_ms = cuda_ms(lambda: qr.qk_ln_rope_plain(x, sc, bi, cos, sin,
                                                   heads), reps=2)
    x4, sc16, bi16 = x.view(b, s, heads, 64), sc.bfloat16(), bi.bfloat16()
    lib_ms = cuda_ms(lambda: F.layer_norm(x4, (64,), sc16, bi16, 1e-6),
                     reps=20)
    # bytes: x read and the output written once (bf16), the [S, 64] fp32
    # tables and the [64] scale and bias read once
    record('qk_ln_rope', 'cuda', 'star_tpu_torch/csrc/qk_ln_rope.cu',
           'star_tpu/ops/qk_ln_rope.py:140', agree, ms, plain_ms,
           10.0 * b * s * c, 2 * 2 * x.numel() + 2 * 4 * cos.numel() + 4 * 128,
           lib_ms, [b, s, c])
    results['qk_ln_rope']['library'] = (
        'partial: F.layer_norm over the [B, S, H, 64] view, no rotation')
    del x, x4, out
    torch.cuda.synchronize()

    q, k = qkv
    v = randn(b, s, c)
    out = fa.flash_attention_packed(q, k, v, heads, kv_valid=valid,
                                    prescaled=True)
    agree = agrees(f'K1 DiT [{b},{s},{c}] 48 heads kv_valid={valid} '
                   'prescaled', [(out, packed_plain_chunked(q, k, v, heads,
                                                           valid))])
    del out
    ms = cuda_ms(lambda: fa.flash_attention_packed(
        q, k, v, heads, kv_valid=valid, prescaled=True), reps=5)
    plain_ms = cuda_ms(lambda: packed_plain_chunked(q, k, v, heads, valid),
                       reps=1)
    to4 = lambda t: t[:, :valid].view(b, valid, heads, 64).transpose(1, 2)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        to4(q), to4(k), to4(v), scale=fa.LN2), reps=5)
    results['flash_packed']['dit'] = sub_record(
        [b, s, c], agree, ms, plain_ms, 4.0 * b * heads * s * valid * 64,
        2 * (3 * b * s * c + b * s * c) - 2 * 2 * b * (s - valid) * c,
        lib_ms, heads=heads, kv_valid=valid, prescaled=True,
        library='F.scaled_dot_product_attention on [2, 9676, 48, 64]')
    del q, k, v, qkv
    torch.cuda.synchronize()


def ln_inputs(shape, gated: bool, resid: bool, dev, g, param_dtype=None):
    """Inputs of K10 (resid False) or K11 at `shape`: (x or y, resid or
    None, scale, bias, gate_w or None), the activations bf16. Each row has
    its own scale, log-uniform from 1e-3 to 1, and its own offset: a
    LayerNorm is blind to a per-row factor except through eps, so the LIEM
    gate shows only on rows whose variance comes near eps (1e-5), and a
    kernel that drops the gate must fail there. The parameters are bf16 as
    the bf16 modules hold them, or `param_dtype`."""
    import torch

    def rows():
        lead = tuple(shape[:-1]) + (1,)
        size = torch.exp(torch.rand(lead, generator=g, device=dev)
                         * math.log(1e-3))
        off = torch.randn(lead, generator=g, device=dev)
        return ((torch.randn(tuple(shape), generator=g, device=dev) + off)
                * size).to(torch.bfloat16)
    c = shape[-1]
    pdt = param_dtype or torch.bfloat16
    x = rows()
    r = rows() if resid else None
    scale = (torch.rand(c, generator=g, device=dev) * 0.4 + 0.8).to(pdt)
    bias = (torch.randn(c, generator=g, device=dev) * 0.1).to(pdt)
    gw = (torch.randn(2, generator=g, device=dev) * 2).to(pdt) \
        if gated else None
    return x, r, scale, bias, gw


def check_ln_kernels(dev, g, record, results) -> None:
    """K10 and K11 against their plain versions at the shapes the paths give
    them: the UNet's temporal stream at its three levels ([2,8,N,C], cfg
    pair: K10 gated at norm1, K11 gated with the residual at norm2 and plain
    with the residual at norm3), the spatial stream at the top level
    ([16,14400,320], K11 plain with the residual), CLIP's [2,77,1024] and
    the DiT's stream [2,9680,3072] (K10 plain). K11's xr must equal the
    plain version's y + resid bit for bit. Timed at each UNet level and
    at the DiT's shape."""
    import torch
    import torch.nn.functional as F
    from star_tpu_torch.ops import fused_ln as fl

    def case(shape, gated, resid, timed, pdt=None, eps=1e-5):
        x, r, sc, bi, gw = ln_inputs(shape, gated, resid, dev, g, pdt)
        what = (f'{"K11" if resid else "K10"} {list(shape)}'
                f'{" gated" if gated else ""}{" +resid" if resid else ""}'
                f'{" fp32 params" if pdt else ""}')
        if resid:
            run = lambda: fl.fused_resid_ln(x, sc, bi, r, gw, eps)
            plain = lambda: fl.fused_resid_ln_plain(x, sc, bi, r, gw, eps)
            (out, xr), (ref, xr_ref) = run(), plain()
            assert torch.equal(xr, xr_ref), f'{what}: xr is not y + resid'
            # partial yardstick: the add and F.layer_norm, no gate
            library = lambda: F.layer_norm(x + r, (shape[-1],), sc, bi, eps)
        else:
            run = lambda: fl.fused_ln(x, sc, bi, eps, gw)
            plain = lambda: fl.fused_ln_plain(x, sc, bi, eps, gw)
            out, ref = run(), plain()
            library = lambda: F.layer_norm(x, (shape[-1],), sc, bi, eps)
        agree = agrees(what, [(out, ref)])
        del out, ref
        if not timed:
            return None
        # the kernel and the library call in CUDA graphs: at 1280 channels
        # and above the kernel takes less time than its wrapper's checks
        ms = cuda_ms(run, reps=20, graph=True)
        plain_ms = cuda_ms(plain, reps=3)
        lib_ms = cuda_ms(library, reps=20, graph=True)
        # bytes: each bf16 input read once and each output written once
        n = x.numel()
        nbytes = (4 if resid else 2) * 2 * n
        return agree, ms, plain_ms, 8.0 * n, nbytes, lib_ms

    k10 = case((2, 8, 14400, 320), True, False, True)
    record('fused_ln', 'cuda', 'star_tpu_torch/csrc/fused_ln.cu',
           'tools/negative_results/fused_ln.py:140', k10[0], *k10[1:],
           [2, 8, 14400, 320])
    results['fused_ln'].update(
        mode='LIEM-gated (temporal norm1)',
        library='partial: F.layer_norm without the gate')
    dit = case((2, 9680, 3072), False, False, True)
    results['fused_ln']['dit'] = sub_record(
        [2, 9680, 3072], dit[0], *dit[1:], mode='plain (DiT LayerNorms)',
        library='F.layer_norm: the same function')
    k11 = case((2, 8, 14400, 320), True, True, True)
    record('fused_resid_ln', 'cuda', 'star_tpu_torch/csrc/fused_ln.cu',
           'tools/negative_results/stream_fuse.py:161', k11[0], *k11[1:],
           [2, 8, 14400, 320])
    results['fused_resid_ln'].update(
        mode='LIEM-gated with the residual (temporal norm2)',
        library='partial: y + resid, then F.layer_norm without the gate')
    sp = case((16, 14400, 320), False, True, True)
    results['fused_resid_ln']['spatial'] = sub_record(
        [16, 14400, 320], sp[0], *sp[1:],
        mode='plain with the residual (spatial norm2/norm3)',
        library='y + resid, then F.layer_norm: the same function in two '
        'calls')
    dit = case((2, 9680, 3072), False, True, True)
    results['fused_resid_ln']['dit'] = sub_record(
        [2, 9680, 3072], dit[0], *dit[1:], mode='plain with the residual',
        library='y + resid, then F.layer_norm: the same function in two '
        'calls')
    for n, c in ((3600, 640), (920, 1280)):
        shape = [2, 8, n, c]
        lvl = case(shape, True, False, True)
        results['fused_ln'][f'c{c}'] = sub_record(shape, lvl[0], *lvl[1:],
                                                  mode='LIEM-gated')
        lvl = case(shape, False, False, True)
        results['fused_ln'][f'c{c}_plain'] = sub_record(
            shape, lvl[0], *lvl[1:], mode='plain',
            library='F.layer_norm: the same function')
        lvl = case(shape, True, True, True)
        results['fused_resid_ln'][f'c{c}'] = sub_record(
            shape, lvl[0], *lvl[1:], mode='LIEM-gated with the residual')
        case(shape, False, True, False, pdt=torch.float32)
    case((2, 77, 1024), False, False, False)
    case((2, 9680, 3072), False, False, False, eps=1e-6)
    torch.cuda.synchronize()


# --------------------------------------------------------------------------
# phase 2b: small models, kernels on the card vs plain versions on the host


def randomised(m, g):
    """m re-initialised from host generator g as flax initialises, then
    every parameter nudged so that no zero-init head or zero conv stays
    zero; eval mode, no grad."""
    import torch
    from star_tpu_torch.pipeline.build import init_like_flax
    init_like_flax(m, g)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.02)
    return m.eval().requires_grad_(False)


def card_vs_host(dev, name, ref, fn, *args, tol: float = 5e-2, **kw):
    """fn on the card (bf16 module, kernels) against the host's fp32 `ref`
    (plain versions): the largest error relative to the largest |ref|,
    held to `tol`, and the kernel launches of the call."""
    import torch
    from star_tpu_torch import ops
    on_card = [a.to(dev) for a in args]
    ops.reset_launch_counts()
    with torch.no_grad():
        out = fn(*on_card, **kw)
    torch.cuda.synchronize()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    err = ((out.float().cpu() - ref).abs().max()
           / ref.abs().max().clamp_min(1e-6)).item()
    log(f'small {name}: card (bf16, kernels) vs host (fp32, plain) '
        f'error {err:.3e} of max |ref| (tol {tol:.0e}); launches {counts}')
    assert math.isfinite(err) and err <= tol, (name, err)
    return err, counts


def check_small_models(dev) -> dict:
    """Widths small enough for the host but large enough that every kernel
    fires (d=64 heads and >=512 tokens for K1, d=512 and >=512 tokens for
    K2): the port on the card in bf16 (kernels) against the same weights on
    the host in fp32 (plain versions). Tolerance 5e-2 of the reference's
    largest magnitude: bf16 keeps 8 bits and the error compounds over a
    dozen blocks."""
    import copy
    import torch
    from star_tpu_torch.models.unet.unet import ControlledV2VUNet
    from star_tpu_torch.vae.svd_vae import SVDTemporalVAE

    g = torch.Generator().manual_seed(3)

    unet = randomised(ControlledV2VUNet(
        dim=64, dim_mult=(1, 2), num_res_blocks=1, attn_scales=(1.0, 0.5),
        head_dim=64, num_heads_init_temporal=1, context_dim=64), g)
    x, hint = (torch.randn(1, 8, 26, 24, 4, generator=g) for _ in range(2))
    y = torch.randn(2, 77, 64, generator=g)
    tt = torch.tensor([500])
    with torch.no_grad():
        ref = unet(x, tt, y, hint, cfg_pair=True)
    card = copy.deepcopy(unet).to(dev, torch.bfloat16)
    e_unet, c_unet = card_vs_host(dev, 'UNet+ControlNet [1,8,26,24]', ref,
                                  card, x, tt, y, hint, cfg_pair=True)
    for k in ('flash_packed', 'temporal_attention', 'fused_gn_silu_tconv3',
              'fused_ln', 'fused_resid_ln'):
        assert c_unet.get(k, 0) > 0, (k, c_unet)

    vae = randomised(SVDTemporalVAE((32, 32, 64, 512), encoder_layers=1,
                                    decoder_layers=1), g)
    video = torch.rand(1, 3, 192, 192, 3, generator=g) * 2 - 1
    z = torch.randn(1, 3, 24, 24, 4, generator=g) * 0.5
    with torch.no_grad():
        ref_m = vae.encode_moments(video)
        ref_d = vae.decode(z)
    card = copy.deepcopy(vae).to(dev, torch.bfloat16)
    e_enc, c_enc = card_vs_host(dev, 'VAE encode [1,3,192,192]', ref_m,
                                card.encode_moments, video)
    e_dec, c_dec = card_vs_host(dev, 'VAE decode [1,3,24,24]', ref_d,
                                card.decode, z)
    assert c_enc.get('flash_d512', 0) > 0 and c_dec.get('flash_d512', 0) > 0
    assert c_dec.get('fused_gn_silu_tconv3', 0) > 0
    # the 512-channel blocks run K6 and the 512-channel upsample K7; the
    # 64- and 32-channel upsamples are narrower than K7 takes and run the
    # phase convs and K8
    assert c_enc.get('conv3x3', 0) > 0 and c_dec.get('conv3x3', 0) > 0
    assert c_dec.get('upsample_conv2x', 0) > 0
    assert c_dec.get('interleave2x2', 0) > 0
    return dict(unet=e_unet, vae_encode=e_enc, vae_decode=e_dec)


# The small CogVideoX models, card (bf16, kernels) against host (fp32,
# plain versions), as a fraction of the largest |host output|: the DiT's
# and the causal VAE's. Set from the first two chip runs (DiT 8.8e-3 before
# its attention was sharpened, see small_cog_dit, and 9.8e-3 after; encode
# 1.9e-2 and windowed decode 1.5e-2 both times) with a margin of 3x; on the
# host, a K9 without its rotation misses the DiT's by 5.6x, a K9 rotating
# the wrong way by 6.6x and a K1 that attends the dead key tail by 1.75x
# (tests/test_torch_dit.py).
COG_DIT_TOL, COG_VAE_TOL = 3e-2, 6e-2


def small_cog_dit():
    """Phase 2b's small CogVideoX DiT on the host (fp32) and its inputs:
    hidden 256, 4 heads of 64, 2 layers, patch 2, 4 latent channels, 8
    text tokens of width 32, 3 latent frames of 24x32 (576 image + 8 text
    tokens = 584, carried as 592 with kv_valid 584, so K9 and K1 fire).
    The qk-LN scales are tripled: random q and k give a flat softmax whose
    output is about the mean of v, which neither the rotation nor the key
    mask moves; sharper logits make both show in the output. Returns the
    DiT, its inputs (x, t, context) and the generator, which the causal
    VAE's draws continue."""
    import torch
    from star_tpu_torch.models.dit.dit import CogVideoDiT
    g = torch.Generator().manual_seed(11)
    dit = randomised(CogVideoDiT(
        hidden_size=256, num_layers=2, num_heads=4, patch_size=2,
        latent_channels=4, text_hidden_size=32, text_length=8,
        time_embed_dim=64), g)
    with torch.no_grad():
        for layer in dit.layers:
            layer.q_ln_scale.mul_(3.0)
            layer.k_ln_scale.mul_(3.0)
    args = (torch.randn(2, 3, 24, 32, 8, generator=g),
            torch.tensor([300, 700]), torch.randn(2, 8, 32, generator=g))
    return dit, args, g


def check_small_cog(dev) -> dict:
    """The small CogVideoX DiT of small_cog_dit, and a small causal VAE (ch
    32, mult (1, 2, 2, 4), z 4): encode of 9 frames of 64x96 and the serial
    decode of 5 latent frames in the pipeline's two windows with the
    carried cache; the card in bf16 against the same weights on the host
    in fp32."""
    import copy
    import torch
    from star_tpu_torch.vae.causal_vae import CogVideoVAE

    dit, args, g = small_cog_dit()
    with torch.no_grad():
        ref = dit(*args)
    card = copy.deepcopy(dit).to(dev, torch.bfloat16)
    e_dit, c_dit = card_vs_host(dev, 'Cog DiT [2,3,24,32] 592 tokens', ref,
                                card, *args, tol=COG_DIT_TOL)
    assert c_dit == {'qk_ln_rope': 4, 'flash_packed': 2, 'fused_ln': 8}, \
        c_dit

    vae = randomised(CogVideoVAE(ch=32, ch_mult=(1, 2, 2, 4),
                                 num_res_blocks=1, z_channels=4), g)
    video = torch.rand(1, 9, 64, 96, 3, generator=g) * 2 - 1
    z = torch.randn(1, 5, 8, 12, 4, generator=g)

    def windows(vae_, z_):
        out1, cache = vae_.decode_window(z_[:, :3], {}, True)
        out2, _ = vae_.decode_window(z_[:, 3:5], cache, False)
        return torch.cat([out1, out2], dim=1)
    with torch.no_grad():
        ref_m = vae.encode_moments(video)
        ref_d = windows(vae, z)
    card = copy.deepcopy(vae).to(dev, torch.bfloat16)
    e_enc, _ = card_vs_host(dev, 'causal VAE encode [1,9,64,96]', ref_m,
                            card.encode_moments, video, tol=COG_VAE_TOL)
    e_dec, _ = card_vs_host(dev, 'causal VAE windowed decode [1,5,8,12]',
                            ref_d, lambda zz: windows(card, zz), z,
                            tol=COG_VAE_TOL)
    return dict(dit=e_dit, vae_encode=e_enc, vae_decode=e_dec)


# The small-width train step, card (bf16, kernels) against host (fp32,
# plain versions) on the same bf16-representable weights and draws. Leaves
# whose largest gradient is below 1e-2 of the largest of all leaves are
# cancellation noise in either precision (a conv bias feeding a GroupNorm
# has a zero gradient in exact arithmetic), so every leaf is held to
# GRAD_ALL_TOL of the largest gradient of all, and the others also to
# GRAD_LEAF_TOL of their own largest; loss and grad_norm to LOSS_TOL. Set
# from the first two runs on an H100 (worst leaf 6.3e-2 and 8.1e-2 — the
# order of K5's atomic statistics adds varies — all leaves 1.1e-2 both
# times, grad_norm 2.1e-3 and 5.8e-4, loss 9e-5 and 6e-5) with a margin of
# at least 3x, 2.7x and 4.8x; a K5 backward that drops the statistics
# cotangent misses the first two by 7.6x and 3x on the host alone
# (tests/test_torch_train_losses.py).
GRAD_LEAF_TOL, GRAD_ALL_TOL, LOSS_TOL = 0.25, 0.03, 1e-2


def grad_errors(ref: dict, got: dict) -> tuple[float, float, str]:
    """(worst error of a leaf holding >= 1e-2 of the largest gradient,
    relative to its own largest; worst error of any leaf relative to the
    largest gradient of all; the name of the first)."""
    top = max(float(r.abs().max()) for r in ref.values())
    leaf, every, name = 0.0, 0.0, ''
    for n, r in ref.items():
        r = r.float()
        err = float((got[n].float().cpu() - r).abs().max())
        every = max(every, err / top)
        big = float(r.abs().max())
        if big >= 1e-2 * top and err / big > leaf:
            leaf, name = err / big, n
    return leaf, every, name


def small_train_grads(model, batch, t, noise):
    """loss_and_grads of the small ControlNet+LIEM train step: (metrics,
    {trainable name: gradient})."""
    from star_tpu_torch.diffusion import DiffusionTables, default_star_schedule
    from star_tpu_torch.train import (TrainConfig, make_train_state,
                                      make_train_step)
    cfg = TrainConfig(freq_loss=False)
    dev = batch['gt_latent'].device
    _, tx = make_train_state(cfg, model)
    step = make_train_step(cfg, model, DiffusionTables.from_schedule(
        default_star_schedule(), dev), tx)
    metrics = step.loss_and_grads(batch, t=t, noise=noise)
    grads = {n: p.grad for n, p in model.named_parameters()
             if n in tx.names}
    return {k: float(v) for k, v in metrics.items()}, grads


def small_train_case(seed: int = 5):
    """The small-width train step's model (fp32, bf16-representable random
    weights, every zero-init layer non-zero), batch and draws, on the
    host: 8 frames of 26x24 latents, head dim 64, so that K1's training
    forward and K3 run at the top scale (624 tokens)."""
    import torch
    from star_tpu_torch.models.unet.unet import ControlledV2VUNet
    from star_tpu_torch.pipeline.build import init_like_flax
    g = torch.Generator().manual_seed(seed)
    model = ControlledV2VUNet(dim=64, dim_mult=(1, 2), num_res_blocks=1,
                              attn_scales=(1.0, 0.5), head_dim=64,
                              num_heads_init_temporal=1, context_dim=64)
    init_like_flax(model, g)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.02)
            p.copy_(p.to(torch.bfloat16).float())
    shape = (1, 8, 26, 24, 4)
    batch = {'gt_latent': torch.randn(shape, generator=g),
             'lq_latent': torch.randn(shape, generator=g),
             'y': torch.randn(1, 77, 64, generator=g)}
    return model, batch, torch.tensor([600]), torch.randn(shape, generator=g)


def check_small_train(dev) -> dict:
    """loss_and_grads of the small UNet+ControlNet on the card (bf16
    module, fp32 masters, kernels: K2 with_l, K3, K4, K5) against the host
    (fp32, plain versions)."""
    import copy
    import torch
    from star_tpu_torch import ops
    model, batch, t, noise = small_train_case()
    ref_m, ref_g = small_train_grads(copy.deepcopy(model), batch, t, noise)
    card = copy.deepcopy(model).to(dev, torch.bfloat16)
    ops.reset_launch_counts()
    m, grads = small_train_grads(
        card, {k: v.to(dev) for k, v in batch.items()}, t.to(dev),
        noise.to(dev))
    torch.cuda.synchronize()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    leaf, every, name = grad_errors(ref_g, grads)
    loss_err = abs(m['total_loss'] - ref_m['total_loss']) \
        / ref_m['total_loss']
    norm_err = abs(m['grad_norm'] - ref_m['grad_norm']) / ref_m['grad_norm']
    log(f'small train step [1,8,26,24]: card (bf16, kernels) vs host (fp32, '
        f'plain): loss {m["total_loss"]:.6f} vs {ref_m["total_loss"]:.6f} '
        f'(rel {loss_err:.3e}), grad_norm {m["grad_norm"]:.6f} vs '
        f'{ref_m["grad_norm"]:.6f} (rel {norm_err:.3e}); worst leaf error '
        f'{leaf:.3e} of its largest ({name}; tol {GRAD_LEAF_TOL}), worst '
        f'error {every:.3e} of the largest gradient (tol {GRAD_ALL_TOL}); '
        f'launches {counts}')
    for k in ('flash_packed_lse', 'flash_bwd', 'temporal_attention',
              'fused_gn_silu_tconv3', 'fused_ln', 'fused_resid_ln'):
        assert counts.get(k, 0) > 0, (k, counts)
    assert loss_err <= LOSS_TOL and norm_err <= LOSS_TOL, (loss_err,
                                                           norm_err)
    assert leaf <= GRAD_LEAF_TOL and every <= GRAD_ALL_TOL, (leaf, every,
                                                             name)
    return dict(loss_rel_err=loss_err, grad_norm_rel_err=norm_err,
                worst_leaf_err=leaf, worst_leaf=name, worst_all_err=every,
                launches=counts)


# --------------------------------------------------------------------------
# phases 3-4: the port's main path at full width


def run_pipeline(dev) -> dict:
    """Full-width random bf16 models, enhance_a_video on 8 frames of
    180x320 -> 720x1280 with the default sampler (the fast 4+11 ladder);
    returns launches, UNet calls, stage seconds and checks."""
    import numpy as np
    import torch
    from star_tpu_torch import ops
    from star_tpu_torch.config import PipelineConfig
    from star_tpu_torch.pipeline import build_pipeline, init_random_models

    t0 = time.perf_counter()
    models = init_random_models(seed=0, dtype=torch.bfloat16, device=dev)
    with torch.no_grad():   # non-degenerate outputs: bump the zero-init head
        for p in models.unet.unet.head_conv.parameters():
            p.add_(0.01)
    torch.cuda.synchronize()
    n_params = {k: sum(p.numel() for p in getattr(models, k).parameters())
                for k in ('unet', 'vae', 'text')}
    log(f'full-width random models on the card in '
        f'{time.perf_counter() - t0:.1f} s: {n_params}')
    pipe = build_pipeline(models, PipelineConfig(),
                          allow_hash_tokenizer=True, device=dev)
    pipe.time_stages = True
    frames = np.random.RandomState(0).uniform(
        0, 255, (8, 180, 320, 3)).astype(np.uint8)

    torch.cuda.reset_peak_memory_stats(dev)
    unet_calls = []
    hook = models.unet.register_forward_pre_hook(
        lambda *_: unet_calls.append(1))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with k7_shapes() as k7_seen:
        out = pipe.enhance_a_video(frames, 'a good video', seed=666)
    clip_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    hook.remove()
    latents = pipe.last_latents
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f'enhance_a_video 8x180x320 -> {out.shape} {out.dtype} in '
        f'{clip_s:.2f} s ({len(unet_calls)} UNet calls); stages '
        + ', '.join(f'{k} {v:.3f} s' for k, v in pipe.stage_seconds.items())
        + f'; peak memory {peak_gb:.1f} GB; launches {launches}')
    assert out.shape == (8, 720, 1280, 3), out.shape
    assert out.dtype == np.uint8, out.dtype
    assert bool(torch.isfinite(latents).all()), 'non-finite latents'
    assert float(out.std()) > 0.0, 'constant output'
    # K8 is not on this path: K7 takes every full-width decoder upsample
    # (phase 2b requires K8 on the small-width VAE instead)
    missing = [k for k in MAIN_PATH_KERNELS if launches[k] <= 0]
    assert not missing, f'kernels not launched on the main path: {missing}'
    log(f'VAE kernels on the main path: conv3x3 {launches["conv3x3"]} '
        f'(expected 76: encoder 20 + two decoder calls of 28), '
        f'upsample_conv2x {launches["upsample_conv2x"]} (expected '
        f'{K7_PER_CLIP}), '
        f'interleave2x2 {launches["interleave2x2"]} (expected 0)')
    # K10/K11: every UNet call, and CLIP on the prompt and the negative one
    n = len(unet_calls)
    assert_launches('clip', launches, {
        'fused_ln': n * LN_PER_CFG_STEP['fused_ln'] + 2 * LN_PER_TEXT_ENCODE,
        'fused_resid_ln': n * LN_PER_CFG_STEP['fused_resid_ln'],
        'flash_d512': D512_PER_CLIP,
        'fused_gn_silu_tconv3': n * K5_PER_CFG_STEP + 2 * K5_PER_DECODE,
        'conv3x3': K6_PER_ENCODE + 2 * K6_PER_DECODE,
        'upsample_conv2x': K7_PER_CLIP})
    assert k7_seen == K7_BY_SHAPE, f'clip: K7 launches by shape {k7_seen}'
    return dict(models=models, pipe=pipe, launches=launches, clip_s=clip_s,
                stages=dict(pipe.stage_seconds), unet_calls=len(unet_calls),
                peak_gb=peak_gb, out_mean=float(out.mean()),
                out_std=float(out.std()))


def time_cfg_step(dev, models, profile: str | None) -> dict:
    """One CFG UNet+ControlNet call at the bench shape: 8 frames on the
    90x160 latent grid, cfg_pair (x/hint once, y as the pair), bf16."""
    import torch
    from star_tpu_torch import ops
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(1, 8, 90, 160, 4, generator=g, device=dev)
    hint = torch.randn(1, 8, 90, 160, 4, generator=g,
                       device=dev).to(torch.bfloat16)
    y = torch.randn(2, 77, 1024, generator=g, device=dev).to(torch.bfloat16)
    tt = torch.full((1,), 500, device=dev)
    step = lambda: models.unet(x, tt, y, hint, cfg_pair=True)
    with torch.no_grad():
        step()
        ops.reset_launch_counts()
        step()
        torch.cuda.synchronize()
        per_step = ops.launch_counts()
        ms = cuda_ms(step, reps=3, warmup=0)
        res = dict(ms=ms, launches=per_step)
        log(f'CFG UNet+ControlNet step [8f, 90x160, cfg_pair, bf16]: '
            f'{ms:.1f} ms; launches per step {per_step}')
        assert_launches('CFG step', per_step, {
            **LN_PER_CFG_STEP, 'fused_gn_silu_tconv3': K5_PER_CFG_STEP})
        if profile:
            res['profile'] = profile_step(step, profile, bounds={
                'K5 fused GN+SiLU+tconv': bound_sum_ms('k5', unet_k5(2))})
    return res


# kernel families of a profile, by a substring of the kernel's name; the
# first family that matches takes it, and the rest is 'other'
KERNEL_FAMILIES = (
    ('K1/K2 flash forward', ('flash_fwd',)),
    ('K3 flash backward', ('flash_bwd',)),
    ('K4 frame attention', ('temporal_attention_kernel',)),
    ('K5 fused GN+SiLU+tconv', ('fused_tconv3',)),
    ('K6 fused GN+SiLU+3x3 conv', ('conv3x3_sm90',)),
    ('K7 fused upsample+conv', ('upsample_conv_sm90',)),
    ('K8 interleave', ('interleave2x2',)),
    ('K9 qk-LN+RoPE', ('qk_ln_rope',)),
    ('K10 LayerNorm', ('star_ln_kernel',)),
    ('K11 residual add + LayerNorm', ('star_resid_ln_kernel',)),
    ('GEMMs and library convs', ('nvjet', 'gemm', 'gemv', 'xmma', 'cutlass',
                                 'convolve', 'cudnn')),
    ('reductions', ('reduce_kernel',)),
    ('elementwise and copies', ('elementwise', 'copy', 'CatArray', 'Memset',
                                'Fill')),
)


def kernel_family(name: str) -> str:
    for family, keys in KERNEL_FAMILIES:
        if any(k in name for k in keys):
            return family
    return 'other'


GEMM_OPS = ('aten::mm', 'aten::addmm', 'aten::bmm', 'aten::baddbmm')
# cuBLAS kernels of fp32 GEMMs on the SIMT path (FFMA): the xmma ones
# name their types, the CUTLASS ones are sgemm, the small ones gemmSN
FP32_GEMM_KERNELS = ('f32f32_f32f32', 'sgemm', 'gemmSN')
# the UNet's K5 widths: the backward's tap products are [M, 3C] x [3C, C]
# (the recompute), [M, C] x [C, 3C] (dys) and [3C, M] x [M, C] (dkb)
K5_WIDTHS = (320, 640, 1280)


def is_k5_product(shapes) -> bool:
    """An mm of K5's tap product or one of its gradients, by shape."""
    if len(shapes) != 2 or len(shapes[0]) != 2 or len(shapes[1]) != 2:
        return False
    (m, k), (k2, n) = shapes
    return k == k2 and any((k, n) in ((3 * c, c), (c, 3 * c))
                           or (m, n) == (3 * c, c) for c in K5_WIDTHS)


def fp32_k5_products(prof) -> list:
    """The GEMM ops of a profile with K5's tap-product shapes that ran an
    fp32 SIMT kernel: (op, shapes, kernel) for each."""
    out = []
    for ev in prof.events():
        if ev.name not in GEMM_OPS or not is_k5_product(ev.input_shapes):
            continue
        for k in ev.kernels:
            if any(key in k.name for key in FP32_GEMM_KERNELS):
                out.append((ev.name, ev.input_shapes, k.name[:80]))
    return out


def profile_step(step, path: str, gemm_sources: bool = False,
                 bounds: dict | None = None) -> dict:
    """Device time by kernel over one step (torch.profiler), summed by
    kernel family, the busy share, and the top kernels; the full table is
    written to `path`. With `gemm_sources` the GEMM ops (mm, addmm, bmm)
    are also grouped by input shapes and Python stack, with the device
    time of the kernels under each, into `path` with _gemms before its
    extension: the backward's GEMMs have no Python stack, and their shapes
    name them. `bounds` maps a family to the bound of its launches in the
    step (ms), logged beside the family's time."""
    import os
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=gemm_sources,
                 with_stack=gemm_sources) as prof:
        step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:   # kernels only, not ops
            continue
        dev_us = getattr(ev, 'self_device_time_total', None)
        if dev_us is None:
            dev_us = getattr(ev, 'self_cuda_time_total', 0.0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    families: dict[str, float] = {}
    for ms, _, key in rows:
        fam = kernel_family(key)
        families[fam] = families.get(fam, 0.0) + ms
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, 'w') as fh:
        fh.write(f'wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms\n')
        for fam, ms in sorted(families.items(), key=lambda kv: -kv[1]):
            fh.write(f'family {ms:10.3f} ms {100 * ms / busy_ms:5.1f}%  '
                     f'{fam}\n')
        for ms, n, key in rows:
            fh.write(f'{ms:10.3f} ms {n:6d}  {key}\n')
    top = [dict(ms=round(ms, 3), count=n, kernel=key[:80])
           for ms, n, key in rows[:12]]
    for fam, b in (bounds or {}).items():
        ms = families.get(fam, 0.0)
        log(f'{fam}: {ms:.1f} ms against a bound of {b:.1f} ms for its '
            f'launches (lost {ms - b:.1f} ms)')
    gemms = k5_fp32 = None
    if gemm_sources:
        root, ext = os.path.splitext(path)
        gemms = gemm_table(prof, f'{root}_gemms{ext or ".txt"}')
        k5_fp32 = fp32_k5_products(prof)
        log(f'GEMMs of K5 tap-product shapes on an fp32 SIMT kernel: '
            f'{len(k5_fp32)} {k5_fp32[:3]}')
    log(f'profiled step: wall {wall_ms:.1f} ms (profiler on), device busy '
        f'{busy_ms:.1f} ms; top: '
        + '; '.join(f"{r['kernel'][:40]} {r['ms']} ms x{r['count']}"
                    for r in top[:6]))
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, families=families,
                top=top, bounds=bounds, gemms=gemms, k5_fp32=k5_fp32)


def gemm_table(prof, path: str) -> list:
    """The GEMM ops of a profile by (op, input shapes, innermost frames of
    the port on the Python stack): count and device ms, written to `path`;
    returns the twelve largest."""
    entries = []
    for ev in prof.key_averages(group_by_input_shape=True,
                                group_by_stack_n=16):
        if ev.key not in GEMM_OPS:
            continue
        dev_us = getattr(ev, 'device_time_total', None)
        if dev_us is None:
            dev_us = getattr(ev, 'cuda_time_total', 0.0)
        frames = [f for f in (ev.stack or []) if 'star_tpu_torch' in f]
        entries.append((dev_us / 1e3, ev.count, ev.key,
                        str(ev.input_shapes), ' < '.join(frames[:3])))
    entries.sort(reverse=True)
    with open(path, 'w') as fh:
        fh.write(f'GEMM ops: {sum(e[0] for e in entries):.1f} device ms\n')
        for ms, n, key, shapes, where in entries:
            fh.write(f'{ms:10.3f} ms {n:6d}  {key} {shapes}  '
                     f'{where or "(no Python stack: autograd)"}\n')
    top = [dict(ms=round(ms, 3), count=n, op=key, shapes=shapes[:120],
                where=where[:160]) for ms, n, key, shapes, where in
           entries[:12]]
    log('GEMM ops of the step by shape and source: '
        + '; '.join(f"{t['op']} {t['shapes'][:60]} {t['ms']} ms x{t['count']}"
                    f" [{t['where'][:60] or 'autograd'}]" for t in top[:8]))
    return top


# --------------------------------------------------------------------------
# phase 5: the train step at full width


def gpu_state() -> str:
    """The card's SM clock, power draw and temperature now (nvidia-smi)."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=clocks.sm,power.draw,temperature.gpu',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else '?'


def run_train(dev, models, profile: str | None = None) -> dict:
    """ControlNet+LIEM fine-tune steps on the full-width models: the bf16
    UNet+ControlNet of phase 3 as the compute copy, fp32 masters, remat,
    TrainConfig() (frequency loss on), 8 frames on the 90x160 latent grid
    built as the training CLI builds its batch. One warm-up step and
    TRAIN_TIMED_STEPS timed ones, every step with the same t and noise (so
    each does the same work); checks finiteness, a gradient at the
    ControlNet's conv_in, moved masters, bit-identical frozen parameters
    and the exact launches of each step. Beside each step's CUDA-event
    time it logs the host time, the Python garbage collector's time inside
    the step, the allocator's cudaMalloc/cudaFree calls and retries, and
    the card's clock, power and temperature after it."""
    import gc
    import os
    import statistics
    import torch
    from star_tpu_torch import ops
    from star_tpu_torch.diffusion import DiffusionTables, default_star_schedule
    from star_tpu_torch.models.clip.tokenizer import default_tokenizer
    from star_tpu_torch.train import (TrainConfig, make_train_state,
                                      make_train_step)

    unet, vae = models.unet, models.vae
    g = torch.Generator(device=dev).manual_seed(7)
    with torch.no_grad():
        # real runs start from converted non-zero weights; zero-init layers
        # would stop every gradient short of the ControlNet's interior
        for mod in unet.modules():
            if getattr(mod, 'zero_init', False):
                for p in mod.parameters(recurse=False):
                    fan_in = p[0].numel() if p.ndim > 1 else 1
                    p.copy_(torch.randn(p.shape, generator=g, device=dev)
                            * (0.1 / math.sqrt(fan_in)))
        # the batch, as cli/train_sr.py builds it: a sampled latent for gt,
        # the posterior mode for lq, the text through the tokenizer
        gt, lq = (torch.rand(1, 8, 720, 1280, 3, generator=g, device=dev)
                  * 2 - 1 for _ in range(2))
        gt_lat = vae.encode(gt, generator=g)
        lq_lat = vae.encode(lq, eps=torch.zeros(gt_lat.shape, device=dev))
        tokens = torch.as_tensor(default_tokenizer(allow_fallback=True)(
            ['a good video']), device=dev)
        batch = {'gt_latent': gt_lat, 'lq_latent': lq_lat,
                 'y': models.text(tokens), 'gt_pixels': gt}
    unet.unet.remat = unet.controlnet.remat = True
    cfg = TrainConfig()
    state, tx = make_train_state(cfg, unet)
    step = make_train_step(cfg, unet, DiffusionTables.from_schedule(
        default_star_schedule(), dev), tx, vae_decode=vae.decode)
    # one t and one noise draw for every step: the same work in each
    t = torch.randint(0, cfg.num_timesteps, (1,), generator=g, device=dev)
    noise = torch.randn(gt_lat.shape, generator=g, device=dev)
    named = dict(unet.named_parameters())
    frozen = {n: p.detach().clone() for n, p in named.items()
              if n not in state.params}
    masters0 = {n: m.clone() for n, m in state.params.items()}
    log(f'train: {sum(m.numel() for m in masters0.values())} trainable '
        f'(fp32 masters), {sum(p.numel() for p in frozen.values())} frozen '
        f'(bf16) parameters; batch {tuple(gt_lat.shape)}; t {int(t)}')

    m = step.loss_and_grads(batch, t=t, noise=noise)
    conv_in = named['controlnet.conv_in.weight'].grad
    assert conv_in is not None and float(conv_in.abs().max()) > 0, \
        'no gradient reached the ControlNet conv_in'
    log(f'loss_and_grads: total_loss {float(m["total_loss"]):.5f} '
        f'grad_norm {float(m["grad_norm"]):.5f}; ControlNet conv_in '
        f'gradient max {float(conv_in.abs().max()):.3e}')

    gc_ms = [0.0]
    gc_t0 = [0.0]

    def gc_timer(phase, info):
        if phase == 'start':
            gc_t0[0] = time.perf_counter()
        else:
            gc_ms[0] += (time.perf_counter() - gc_t0[0]) * 1e3
    gc.callbacks.append(gc_timer)
    # Python's cyclic collector: a full collection walks every object the
    # process holds (models, tokenizer, optimizer state) and stalled the
    # step it fell in by 0.5-0.9 s. Everything built so far is frozen out
    # of its collections.
    gc.collect()
    gc.freeze()
    torch.cuda.reset_peak_memory_stats(dev)
    times, per_step, steps = [], [], []
    try:
        for i in range(1 + TRAIN_TIMED_STEPS):
            ops.reset_launch_counts()
            mem0 = torch.cuda.memory_stats(dev)
            gc_ms[0] = 0.0
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            h0 = time.perf_counter()
            start.record()
            with k7_shapes() as k7_seen:
                state, m = step(state, batch, t=t, noise=noise)
            end.record()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - h0) * 1e3
            mem1 = torch.cuda.memory_stats(dev)
            counts = ops.launch_counts()
            ms = start.elapsed_time(end)
            m = {k: float(v) for k, v in m.items()}
            delta = {k: mem1.get(k, 0) - mem0.get(k, 0)
                     for k in ('num_device_alloc', 'num_device_free',
                               'num_alloc_retries')}
            card = gpu_state()
            log(f'train step {i}{" (warm-up)" if i == 0 else ""}: {ms:.1f} '
                f'ms (host {host_ms:.1f} ms, gc {gc_ms[0]:.1f} ms, '
                f'allocator {delta}, after: {card}); '
                + ' '.join(f'{k} {v:.5f}' for k, v in m.items())
                + f'; launches {counts}')
            assert all(math.isfinite(v) for v in m.values()), m
            assert m['grad_norm'] > 0, m
            missing = [k for k in TRAIN_PATH_KERNELS if counts[k] <= 0]
            assert not missing, f'kernels not launched in the train step: ' \
                f'{missing}'
            assert_launches(f'train step {i}', counts, {
                **LN_PER_TRAIN_STEP, **ATTN_PER_TRAIN_STEP,
                # forward and remat recompute, and the decode of pred-x0
                'fused_gn_silu_tconv3': 2 * K5_PER_CFG_STEP
                + 2 * K5_PER_DECODE,
                'conv3x3': 2 * K6_PER_DECODE,
                'upsample_conv2x': K7_PER_TRAIN_STEP})
            assert k7_seen == K7_BY_SHAPE, f'train step {i}: K7 launches ' \
                f'by shape {k7_seen}'
            if i:
                times.append(ms)
                per_step.append(counts)
                steps.append(dict(ms=ms, host_ms=host_ms, gc_ms=gc_ms[0],
                                  allocator=delta, card=card))
    finally:
        gc.callbacks.remove(gc_timer)
        gc.unfreeze()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    moved = {n: float((state.params[n] - m0).abs().sum())
             for n, m0 in masters0.items()}
    assert sum(moved.values()) > 0 and moved['controlnet.conv_in.weight'] > 0
    changed = [n for n, p in frozen.items() if not torch.equal(named[n], p)]
    assert not changed, f'frozen parameters changed: {changed[:5]}'
    step_ms = statistics.median(times)
    log(f'train step [1, 8, 90x160, remat, frequency loss, bf16 + fp32 '
        f'masters]: median {step_ms:.1f} ms of {[round(x, 1) for x in times]}'
        f' (spread {max(times) - min(times):.1f} ms); peak memory '
        f'{peak_gb:.1f} GB; masters moved: '
        f'{sum(v > 0 for v in moved.values())} of {len(moved)} leaves; '
        f'frozen bit-identical: {len(frozen)} leaves')
    res = dict(step_ms=step_ms, steps_ms=times, steps=steps,
               peak_gb=peak_gb, launches=per_step[-1], losses=m)
    if profile:
        root, ext = os.path.splitext(profile)

        def one_step():
            nonlocal state
            state, _ = step(state, batch, t=t, noise=noise)
        res['profile'] = profile_step(
            one_step, f'{root}_train{ext or ".txt"}', gemm_sources=True,
            bounds={'K5 fused GN+SiLU+tconv': bound_sum_ms(
                'k5', unet_k5(1), unet_k5(1), *DECODE_K5),
                'K6 fused GN+SiLU+3x3 conv': bound_sum_ms('k6', *DECODE_K6),
                'K7 fused upsample+conv': bound_sum_ms('k7', *DECODE_K7)})
        # K5's backward multiplies bf16 operands on the tensor cores, as
        # the JAX function does: none of its products may run in fp32
        assert not res['profile']['k5_fp32'], res['profile']['k5_fp32'][:3]
    return res


# --------------------------------------------------------------------------
# phase 6: the CogVideoX SR path at full width


def run_cog(dev) -> dict:
    """The published CogVideoX-5B SR models (DiT 42x3072, T5-XXL, causal
    VAE 128) with seeded random bf16 weights made on the card;
    CogVideoSRPipeline.enhance_a_video on 25 synthetic frames of 480x720
    (7 latent frames of 60x90, 9676 tokens carried as 9680) with the
    default sampler (50 VPSDE-DPM++(2M) steps, DynamicCFG 6 / 5)."""
    import numpy as np
    import torch
    from star_tpu_torch import ops
    from star_tpu_torch.pipeline import (build_cog_pipeline,
                                         init_random_cog_models)

    t0 = time.perf_counter()
    models = init_random_cog_models(seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = {k: sum(p.numel() for p in getattr(models, k).parameters())
                for k in ('dit', 'vae', 'text')}
    log(f'CogVideoX models (random bf16) on the card in {init_s:.1f} s: '
        f'{n_params}; memory allocated '
        f'{torch.cuda.memory_allocated(dev) / 1e9:.1f} GB')
    pipe = build_cog_pipeline(models, allow_hash_tokenizer=True, device=dev,
                              time_stages=True)
    frames = np.random.RandomState(0).uniform(
        0, 255, (25, 480, 720, 3)).astype(np.uint8)

    torch.cuda.reset_peak_memory_stats(dev)
    dit_calls = []
    hook = models.dit.register_forward_pre_hook(
        lambda *_: dit_calls.append(1))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = pipe.enhance_a_video(frames, 'a good video', seed=42)
    clip_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    hook.remove()
    latents = pipe.last_latents
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f'Cog enhance_a_video 25x480x720 -> {out.shape} {out.dtype} in '
        f'{clip_s:.2f} s ({len(dit_calls)} DiT calls); stages '
        + ', '.join(f'{k} {v:.3f} s' for k, v in pipe.stage_seconds.items())
        + f'; peak memory {peak_gb:.1f} GB; launches {launches}')
    assert out.shape == (25, 480, 720, 3), out.shape
    assert out.dtype == np.uint8, out.dtype
    assert tuple(latents.shape) == (1, 7, 60, 90, 16), latents.shape
    assert bool(torch.isfinite(latents).all()), 'non-finite latents'
    assert float(out.std()) > 0.0, 'constant output'
    assert len(dit_calls) == 50, len(dit_calls)
    want = {k: COG_PATH_LAUNCHES.get(k, 0) for k in launches}
    assert launches == want, f'Cog clip launches {launches}, want {want}'
    return dict(models=models, launches=launches, clip_s=clip_s,
                stages=dict(pipe.stage_seconds), dit_calls=len(dit_calls),
                init_s=init_s, peak_gb=peak_gb, out_mean=float(out.mean()),
                out_std=float(out.std()))


def time_dit_step(dev, models, profile: str | None) -> dict:
    """One DiT call on the CFG pair at tools/bench_cog.py's shape: x
    [2, 7, 60, 90, 32] (noisy || LQ latents), t = 499, context
    [2, 226, 4096], bf16."""
    import os
    import torch
    from star_tpu_torch import ops
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(2, 7, 60, 90, 32, generator=g, device=dev).bfloat16()
    ctx = torch.randn(2, 226, 4096, generator=g, device=dev).bfloat16()
    tt = torch.full((2,), 499, device=dev)
    step = lambda: models.dit(x, tt, ctx)
    with torch.no_grad():
        step()
        ops.reset_launch_counts()
        step()
        torch.cuda.synchronize()
        per_step = {k: v for k, v in ops.launch_counts().items() if v}
        ms = cuda_ms(step, reps=3, warmup=0)
        res = dict(ms=ms, launches=per_step)
        log(f'DiT CFG step [2, 7, 60, 90, 32], 9680 tokens, bf16: '
            f'{ms:.1f} ms; launches per step {per_step}')
        assert_launches('DiT step', per_step, LN_PER_DIT_STEP)
        if profile:
            root, ext = os.path.splitext(profile)
            res['profile'] = profile_step(step, f'{root}_dit{ext or ".txt"}')
    return res


# --------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--phase', choices=('all', 'kernels'), default='all',
                    help='kernels: build and check the kernels only')
    ap.add_argument('--profile', metavar='FILE',
                    help='also trace one CFG step with torch.profiler and '
                    'write its device time by kernel to FILE, one train '
                    'step to FILE with _train before its extension, and '
                    'one DiT CFG step to FILE with _dit before it')
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script runs the port on '
              'the card', file=sys.stderr)
        return 2
    from star_tpu_torch.ops import _build

    card = card_line()
    log(f'card: {card}')
    dev = torch.device('cuda', 0)
    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.lib()
    log(f'kernels built in {time.perf_counter() - t0:.1f} s')

    results = check_kernels(dev)
    if args.phase == 'kernels':
        print(json.dumps({'kernels': list(results.values())}))
        print(card)
        return 0
    small = check_small_models(dev)
    small['train'] = check_small_train(dev)
    small['cog'] = check_small_cog(dev)
    run = run_pipeline(dev)
    step = time_cfg_step(dev, run['models'], args.profile)
    train = run_train(dev, run['models'], args.profile)
    # the I2VGen models go before the CogVideoX ones come, so that the Cog
    # clip's peak memory is its own
    del run['models'], run['pipe']
    gc.collect()
    torch.cuda.empty_cache()
    log(f'I2VGen models freed: {torch.cuda.memory_allocated(dev) / 1e9:.2f} '
        'GB still allocated')
    cog = run_cog(dev)
    dit_step = time_dit_step(dev, cog.pop('models'), args.profile)
    for name, rec in results.items():
        # each kernel's launches on the path it belongs to: the training
        # forward and backward in the train step, K9 in the Cog clip, the
        # others in the I2VGen clip
        on_train = name in ('flash_packed_lse', 'flash_bwd')
        rec['launches'] = (train if on_train else cog if name == 'qk_ln_rope'
                           else run)['launches'][name]
        rec['launches_per_cfg_step'] = step['launches'][name]
        rec['launches_per_train_step'] = train['launches'][name]
        rec['launches_cog_clip'] = cog['launches'][name]
        rec['launches_per_dit_step'] = dit_step['launches'].get(name, 0)
    log('summary ' + json.dumps(dict(
        small_model_errors=small, clip_s=run['clip_s'],
        unet_calls=run['unet_calls'],
        stages=run['stages'], peak_gb=run['peak_gb'], cfg_step_ms=step['ms'],
        profile=step.get('profile'), train_step_ms=train['step_ms'],
        train_steps_ms=train['steps_ms'], train_steps=train['steps'],
        train_peak_gb=train['peak_gb'], train_losses=train['losses'],
        train_profile=train.get('profile'), cog_clip_s=cog['clip_s'],
        cog_dit_calls=cog['dit_calls'], cog_stages=cog['stages'],
        cog_init_s=cog['init_s'], cog_peak_gb=cog['peak_gb'],
        cog_out_mean=cog['out_mean'], cog_out_std=cog['out_std'],
        dit_step_ms=dit_step['ms'], dit_profile=dit_step.get('profile'))))
    print(json.dumps({'kernels': list(results.values())}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
