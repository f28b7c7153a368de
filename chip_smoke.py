"""On-card smoke test of the PyTorch/H100 port (star_tpu_torch).

    python3 chip_smoke.py            # everything, on one CUDA card

1. prints the card's name and power limit and builds the CUDA kernels of
   star_tpu_torch/csrc with nvcc (timed);
2. holds each kernel (K1 packed flash, K2 d=512 flash, K2 `with_l` (the
   d=64 training forward writing the log-sum-exp), K3 flash backward, K4
   frame attention, K5 fused GN+SiLU+temporal conv, K6 fused GN+SiLU+3x3
   conv, K7 fused nearest-2x+3x3 conv, K8 2x2 phase interleave, K9 fused
   qk-LayerNorm+RoPE and its backward, K10 LayerNorm (optionally
   LIEM-gated), K11 residual add + LayerNorm, K12 the UNet's GEGLU (bit
   for bit but for the GELU's last bit), K13 GroupNorm (its statistics
   against float64 sums, its apply bit for bit given the same
   coefficients, with and without the SiLU); K1 also at the CogVideoX
   DiT's 48 heads, 9680 tokens, dead key tail and prescaled q, and at the
   edges of its tiles;
   K2 `with_l` and K3 also at the DiT's 9680 tokens and 48 heads; K10 and
   K11 at C = 320, 640, 1280 and 3072; K1, K9 and K10 also at the
   text-to-video DiT's 17776 tokens) against its plain PyTorch
   version at the shapes the main paths give it, and times kernel, plain
   version and one PyTorch library call with CUDA events; then runs a
   small-width UNet+ControlNet and VAE, and a small CogVideoX DiT and
   causal VAE, on the card (bf16, kernels) against the same weights on the
   host (fp32, plain versions), and the small UNet+ControlNet's and a
   small LoRA DiT's `loss_and_grads` likewise;
3. builds the full-width models with seeded random bf16 weights on the card,
   writes them as reference-named state dicts (the inverse of the port's
   name maps), converts those files with star_tpu_torch.convert.cli, loads
   the result with load_star_models and holds every tensor bit for bit to
   the original; then runs the loaded models through inference_sr's job
   loop on 8 frames of 180x320 -> 720x1280 (in-memory frames and saver),
   with every kernel's launch count reset just before and read just after;
3b. serves: the same pipeline behind the port's daemon (cli/serve.py's
   serve_loop in a thread, cli/web.py's front-end on a loopback port):
   warms the 8x180x320 bucket, enqueues two clips and one request whose
   input does not exist over HTTP, reads the three done files back over
   HTTP and shuts the daemon down; each request's launches are reset just
   before its clip and read just after, and must be exact;
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
   DiT, T5-XXL, causal VAE) with seeded random bf16 weights on the card,
   carries each through the inverse of its name map and back through
   convert_state_dict on the card (bit for bit), and runs the converted
   models through sample_sr's job loop on 25 frames of 480x720 (50 DiT
   calls), the launch counts reset just before and read just after; then
   times one DiT CFG step at tools/bench_cog.py's shape;
7. frees the SR DiT, builds the stock CogVideoX-5B DiT (liem=False, 16
   input channels) with seeded random bf16 weights on the card beside
   phase 6's T5-XXL and causal VAE, runs sample_t2v's job loop on one
   prompt with the CLI's defaults (49 frames of 480x720: 13 latent frames,
   17776 tokens; 50 DiT calls), the launch counts reset just before and
   read just after, and times one stock-DiT CFG step;
5c. (after phase 5, on its models) trains with dropout active
   (deterministic=False, rate 0.1, the masks drawn from a seeded
   generator): one warm-up and three timed steps, the UNet's temporal conv
   chains unfused (no K5 in the UNet), each step's launches exact;
5b. (after phase 5c, on its models) runs cli/train_sr.py's loop: an
   in-memory iterator of two synthetic 8-frame 720x1280 triplets, 3 steps
   with checkpoints at steps 1 and 2 (torch files under build/), the
   step-2 file held bit for bit to the run's state at step 2, then a run
   resumed from it to step 3 held to the continued run's step 3; each
   step's launches reset just before and read just after;
6b. (after phase 7) frees the stock DiT, builds CogVideoDiT(lora_rank=512)
   with LIEM at full width beside phase 6's T5-XXL and causal VAE, runs
   cli/train_cog.py's loop on synthetic 25-frame 480x720 triplets (one
   warm-up and three timed steps, each step's launches exact, K9's
   backward counted), then one step with the frequency loss;
8. runs cli/make_paired_data.py's per-clip function on a synthetic
   32-frame 720x1280 clip on the card, recipes default and mid, the codec
   stage on;
9. (after phase 6b, on its models) the distributed path at world size 1
   over NCCL, in this process (init_distributed, a loopback rendezvous):
   Ulysses attention at the DiT's shape against a direct K1 call, bit for
   bit; cp_decode of 7 latent frames against the serial decoder; one step
   of train_cog's loop through the data-parallel and ZeRO path against
   the same step without the group; the group destroyed after;
10. prints one JSON line of kernel results, the card line, and as the last
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
                     'fused_ln', 'fused_resid_ln', 'geglu', 'group_norm',
                     'gn_stats')
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
# K12 launches by shape, from the models' structure (derived on the CPU
# from the full-depth models at narrow widths and held there by
# tests/test_torch_geglu.py): the feed-forward of each of a UNet+ControlNet
# call's 48 transformer blocks, (rows, inner) -> launches, at 16 frames
# (the CFG pair) of each level's tokens but for the two init temporal
# transformers, which run before the split at 8. A train step runs each
# twice (the forward and the remat recompute; the backward recomputes the
# plain version).
GEGLU_PER_CFG_CALL = {(230400, 1280): 14, (115200, 1280): 2,
                      (57600, 2560): 14, (14720, 5120): 14, (3840, 5120): 4}
GEGLU_PER_CFG_STEP = {'geglu': sum(GEGLU_PER_CFG_CALL.values())}      # 48
GEGLU_PER_TRAIN_STEP = {'geglu': 2 * GEGLU_PER_CFG_STEP['geglu']}
# the shapes K12 is timed at (PERF.md §6): one a level
GEGLU_TIMED_SHAPES = ((230400, 1280), (57600, 2560), (14720, 5120),
                      (3840, 5120))
# K13 launches by shape, from the models' structure (derived on the CPU
# from the full-depth models at narrow widths and held there by
# tests/test_torch_group_norm.py). A UNet+ControlNet CFG call runs 113
# GroupNorms (64 ResBlock norms and the head norm with the SiLU fused, 48
# transformer norms without), each one statistics launch and one apply,
# by (N, R, C, silu) of x [N, R, C]: per frame at 16 frames (8 for the
# ControlNet's first level), per video at N = 2 for the temporal
# transformers (1 for the ControlNet's first); and 32 statistics alone,
# the first stages of its temporal conv blocks (K5 threads the rest), by
# (N, R, C).
GN_PER_CFG_CALL = {
    (16, 14400, 320, True): 8, (16, 14400, 320, False): 5,
    (8, 14400, 320, True): 4, (8, 14400, 320, False): 2,
    (2, 115200, 320, False): 7, (1, 115200, 320, False): 2,
    (16, 14400, 640, True): 2, (16, 14400, 960, True): 1,
    (16, 3600, 320, True): 2, (16, 3600, 640, True): 9,
    (16, 3600, 640, False): 7, (16, 3600, 960, True): 1,
    (16, 3600, 1280, True): 1, (16, 3600, 1920, True): 1,
    (2, 28800, 640, False): 7,
    (16, 920, 640, True): 2, (16, 920, 1280, True): 9,
    (16, 920, 1280, False): 7, (16, 920, 1920, True): 1,
    (16, 920, 2560, True): 2, (2, 7360, 1280, False): 7,
    (16, 240, 1280, True): 19, (16, 240, 1280, False): 2,
    (16, 240, 2560, True): 3, (2, 1920, 1280, False): 2}
GN_STATS_PER_CFG_CALL = {(2, 115200, 320): 5, (1, 115200, 320): 2,
                         (2, 28800, 640): 7, (2, 7360, 1280): 7,
                         (2, 1920, 1280): 11}
GN_PER_CFG_STEP = {
    'group_norm': sum(GN_PER_CFG_CALL.values()),                  # 113
    'gn_stats': sum(GN_PER_CFG_CALL.values())
    + sum(GN_STATS_PER_CFG_CALL.values())}                        # 145
# a causal-VAE encode of 25 frames of 480x720 (the Cog train step's two):
# 29 GroupNorms with the SiLU, at N = 1, by (R, C)
GN_PER_CAUSAL_ENCODE = {(8640000, 128): 6, (1123200, 128): 1,
                        (1123200, 256): 5, (151200, 256): 6,
                        (37800, 256): 1, (37800, 512): 10}
GN_PER_COG_TRAIN_STEP = {'group_norm': 2 * 29, 'gn_stats': 2 * 29}
# a window of the causal VAE's serial decode: 37 GroupNorms without the
# SiLU, inside SpatialNorm3D (two a block of the decoder's mid and up
# blocks, and its norm_out)
GN_PER_DECODE_WINDOW = 37


def cog_gn_launches(encodes: int, windows: int) -> dict:
    """K13's launches in a CogVideoX clip of `encodes` causal-VAE
    encodes and `windows` decode windows (a Cog SR clip: 1 and 3, the 7
    latent frames in windows [0:3], [3:5], [5:7]; a T2V clip: 0 and 6)."""
    n = (encodes * sum(GN_PER_CAUSAL_ENCODE.values())
         + windows * GN_PER_DECODE_WINDOW)
    return {'group_norm': n, 'gn_stats': n}
# the SVD VAE: an encode runs the mid attention's GroupNorm and five K6
# stages that start without threaded statistics; a decoder call the mid
# attention's and two such stages
GN_PER_VAE_ENCODE = {'group_norm': 1, 'gn_stats': 1 + 5}
GN_PER_DECODE_CALL = {'group_norm': 1, 'gn_stats': 1 + 2}
# a train step's UNet+ControlNet, forward and remat recompute (the head
# norm runs once), under autograd: K13 forward, the plain version in the
# backward, which also recomputes K5's statistics from x
GN_PER_TRAIN_UNET = {'group_norm': 2 * 113 - 1,
                     'gn_stats': 2 * 113 - 1 + 2 * 32}
# the shapes K13 is timed at (PERF.md §6): (N, R, C, silu)
GN_TIMED_SHAPES = ((16, 14400, 320, True), (16, 14400, 320, False),
                   (16, 920, 2560, True), (1, 8640000, 128, True),
                   (1, 1123200, 256, True))
LN_PER_DIT_STEP = {'fused_ln': 42 * 3 + 2}
# the kernels of one DiT call, SR or stock (42 layers: K9 on q and on k,
# K1 once, K10 three times; and the two final norms)
LAUNCHES_PER_DIT_STEP = {'qk_ln_rope': 84, 'flash_packed': 42,
                         **LN_PER_DIT_STEP}
# the CogVideoX clips' kernels, SR and text-to-video, with their launches
# in one clip of 50 DiT calls (T5 and the causal VAE launch none)
COG_PATH_LAUNCHES = {k: 50 * v for k, v in LAUNCHES_PER_DIT_STEP.items()}
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


def geglu_work(rows, inner) -> tuple[float, float]:
    """K12's FLOPs (about 12 a value: the GELU and the product) and bytes
    (h and the gate read, out written: 6 a value) on p [rows, 2*inner]."""
    n = rows * inner
    return 12.0 * n, 6.0 * n


def gn_work(n, r, c, silu=True) -> tuple[float, float]:
    """K13's FLOPs (about 4 a value for the statistics, 4 for the apply,
    about 12 more for the SiLU) and bytes (x read by each pass, y written:
    6 a value) on x [n, r, c]."""
    v = n * r * c
    return (20.0 if silu else 8.0) * v, 6.0 * v


def gn_bound_ms(table: dict, stats_table: dict = None) -> float:
    """The bound of K13's launches in a table of GN_PER_CFG_CALL's keys,
    and of the statistics alone (2 bytes a value) in one of
    GN_STATS_PER_CFG_CALL's."""
    total = sum(k * bound_ms(*gn_work(*key))[0] for key, k in table.items())
    for (n, r, c), k in (stats_table or {}).items():
        total += k * bound_ms(4.0 * n * r * c, 2.0 * n * r * c)[0]
    return total


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
# phase 5c: with dropout active every temporal conv block of the UNet and
# the ControlNet runs the unfused chain (32 a call, 64 a train step with
# the remat recompute; tests/test_torch_dropout.py derives them on the
# CPU), so the train step's K5 launches are the VAE decode's alone
DROPOUT_TIMED_STEPS = 3
UNFUSED_CHAINS_PER_TRAIN_STEP = 2 * 32
DROPOUT_K5_PER_TRAIN_STEP = 2 * K5_PER_DECODE
# the keys of a training CLI's metrics.jsonl row: the train step's metrics
# and step, lr, sec_per_step (tests/test_torch_train_cli.py holds them to
# the JAX CLIs' rows)
TRAIN_SR_ROW_KEYS = {'loss_v', 'loss_low', 'loss_high', 'loss_t',
                     'total_loss', 'grad_norm', 'step', 'lr', 'sec_per_step'}
TRAIN_COG_ROW_KEYS = {'loss_v', 'total_loss', 'grad_norm', 'step', 'lr',
                      'sec_per_step'}
TRAIN_COG_FREQ_ROW_KEYS = TRAIN_COG_ROW_KEYS | {'loss_low', 'loss_high'}
# the train step's kernels: the UNet's under autograd, and the VAE decode of
# pred-x0 for the frequency loss (no grad)
TRAIN_PATH_KERNELS = ('flash_packed_lse', 'flash_bwd', 'flash_d512',
                      'temporal_attention', 'fused_gn_silu_tconv3',
                      'conv3x3', 'upsample_conv2x', 'fused_ln',
                      'fused_resid_ln', 'geglu', 'group_norm', 'gn_stats')


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
    from star_tpu_torch.ops.norms import channel_stats, gn_coeffs

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
    check_k9_backward(dev, g, record, results)
    check_ln_kernels(dev, g, record, results)
    check_geglu(dev, record, results)
    check_group_norm(dev, record, results)
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
    from star_tpu_torch.ops import conv3x3 as c3, norms, upsample_conv as uc

    # K6: the plain version's fp32 conv must not run in TF32 (set above)
    def k6_case(n, h, w, c, cout, residual, timed):
        x = randn(n, h, w, c)
        sc = torch.rand(c, generator=g, device=dev) * 0.2 + 0.9
        bi = torch.randn(c, generator=g, device=dev) * 0.1
        wt = (torch.randn(cout, c, 3, 3, generator=g, device=dev)
              / math.sqrt(9 * c)).to(torch.bfloat16)
        cb = torch.randn(cout, generator=g, device=dev) * 0.1
        r = randn(n, h, w, cout) if residual else None
        st = norms.channel_stats(x)
        what = f'K6 [{n},{h},{w},{c}->{cout}]{" +res" if residual else ""}'
        y, sty = c3.fused_gn_silu_conv3x3(x, sc, bi, wt, cb, stats=st,
                                          residual=r, want_stats=True)
        a, b = norms.gn_coeffs(st, h * w * (c // 32), sc, bi, 32, 1e-6)
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


def packed_plain_chunked(q, k, v, heads: int, kv_valid: int | None,
                         prescaled: bool = True, return_lse: bool = False,
                         head_chunk: int = 8):
    """flash_attention_packed_plain (of a prescaled q by default), one batch
    row and `head_chunk` heads at a time: the fp32 logits of all 48 heads
    of one row at 9680 tokens would take 18 GB. With `return_lse` also the
    lse [B, heads, Sq]."""
    import torch
    from star_tpu_torch.ops import flash_attention as fa
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


# the DiT's attention shapes: (what, latent frames, tokens carried, live
# tokens or None, head chunk of the plain K1): the SR clip's 7 latent
# frames of 30x45 patches (9676 tokens carried as 9680) and the
# text-to-video clip's 13 (17776 tokens, a multiple of 16: no dead tail)
DIT_SHAPES = (('sr', 7, 9680, 9676, 8), ('t2v', 13, 17776, None, 4))


def dit_attention_case(dev, g, randn, t_lat, s, valid, head_chunk):
    """K9 on q (the softmax scale * log2(e) folded in) and on k, then K1
    prescaled on K9's outputs (with kv_valid where the stream has a dead
    tail), at q/k/v [2, s, 3072], 48 heads, with the DiT's RoPE tables for
    `t_lat` latent frames of 30x45 patches (identity rows for the text and
    the tail, 3D RoPE between). Returns the (agree, ms, plain ms, FLOPs,
    bytes, library ms) of K9 and of K1."""
    import torch
    import torch.nn.functional as F
    from star_tpu_torch.models.dit.dit import rope_tables
    from star_tpu_torch.ops import flash_attention as fa, qk_ln_rope as qr

    b, heads = 2, 48
    c = heads * 64
    cos, sin = (torch.from_numpy(a).to(dev)
                for a in rope_tables(226, t_lat, 30, 45, s, 64))
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
    k9 = (agree, ms, plain_ms, 10.0 * b * s * c,
          2 * 2 * x.numel() + 2 * 4 * cos.numel() + 4 * 128, lib_ms)
    del x, x4, out
    torch.cuda.synchronize()

    q, k = qkv
    v = randn(b, s, c)
    live = valid or s
    out = fa.flash_attention_packed(q, k, v, heads, kv_valid=valid,
                                    prescaled=True)
    agree = agrees(f'K1 DiT [{b},{s},{c}] 48 heads kv_valid={valid} '
                   'prescaled', [(out, packed_plain_chunked(
                       q, k, v, heads, valid, head_chunk=head_chunk))])
    del out
    ms = cuda_ms(lambda: fa.flash_attention_packed(
        q, k, v, heads, kv_valid=valid, prescaled=True), reps=5)
    plain_ms = cuda_ms(lambda: packed_plain_chunked(
        q, k, v, heads, valid, head_chunk=head_chunk), reps=1)
    to4 = lambda t: t[:, :live].view(b, live, heads, 64).transpose(1, 2)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        to4(q), to4(k), to4(v), scale=fa.LN2), reps=5)
    k1 = (agree, ms, plain_ms, 4.0 * b * heads * s * live * 64,
          2 * (3 * b * s * c + b * s * c) - 2 * 2 * b * (s - live) * c,
          lib_ms)
    del q, k, v, qkv
    torch.cuda.synchronize()
    return k9, k1


def check_dit_kernels(dev, g, randn, record, results) -> None:
    """K9 (qk-LayerNorm + RoPE) and K1 at the CogVideoX DiT's attention
    shapes (DIT_SHAPES): the SR clip's [2, 9680, 3072] (kv_valid 9676) is
    each kernel's DiT record, the text-to-video clip's [2, 17776, 3072]
    (no dead tail) a sub-record under it."""
    for what, t_lat, s, valid, head_chunk in DIT_SHAPES:
        k9, k1 = dit_attention_case(dev, g, randn, t_lat, s, valid,
                                    head_chunk)
        shape = [2, s, 3072]
        if what == 'sr':
            record('qk_ln_rope', 'cuda', 'star_tpu_torch/csrc/qk_ln_rope.cu',
                   'star_tpu/ops/qk_ln_rope.py:140', k9[0], *k9[1:], shape)
            results['qk_ln_rope']['library'] = (
                'partial: F.layer_norm over the [B, S, H, 64] view, no '
                'rotation')
            key = 'dit'
        else:
            results['qk_ln_rope'][what] = sub_record(
                shape, k9[0], *k9[1:], t_lat=t_lat)
            key = what
        live = valid or s
        results['flash_packed'][key] = sub_record(
            shape, k1[0], *k1[1:], heads=48, kv_valid=valid, prescaled=True,
            library=f'F.scaled_dot_product_attention on [2, {live}, 48, 64]')


def check_k9_backward(dev, g, record, results) -> None:
    """K9's backward kernel against its plain version (the closed form):
    at the Cog train step's [1, 9680, 3072] with dx alone (the DiT's q/k
    scale and bias are frozen), the record, timed beside its plain version
    and autograd through F.layer_norm (a partial yardstick: the backward of
    the normalisation alone, no rotation); and at a ragged [2, 37, 192]
    (the last block part-filled) with the scale and bias gradients, which
    must come out the same bit for bit on a second call."""
    import torch
    import torch.nn.functional as F
    from star_tpu_torch.models.dit.dit import rope_tables
    from star_tpu_torch.ops import qk_ln_rope as qr

    def case(b, s, heads, tables):
        x = (torch.randn(b, s, heads * 64, generator=g, device=dev) * 2
             + 0.5).to(torch.bfloat16)
        ct = torch.randn(b, s, heads * 64, generator=g,
                         device=dev).to(torch.bfloat16)
        sc = torch.randn(64, generator=g, device=dev) * 0.1 + 1.0
        bi = torch.randn(64, generator=g, device=dev) * 0.1
        return (x, ct, sc, bi, *tables, heads, 1e-6, qr.LOG2E / 8.0)

    ang = torch.rand(37, 64, generator=g, device=dev) * 3
    args = case(2, 37, 3, (ang.cos(), ang.sin())) + (True,)
    got, ref = qr._launch_bwd(*args), qr.qk_ln_rope_bwd_plain(*args)
    for what, a, r in zip(('dx', 'dscale', 'dbias'), got, ref):
        agrees(f'K9 backward [2,37,192] {what}', [(a, r)])
    again = qr._launch_bwd(*args)
    assert all(torch.equal(a, r) for a, r in zip(got, again)), \
        'K9 backward: the scale and bias gradients differ between calls'

    b, s, heads = 1, 9680, 48
    cos, sin = (torch.from_numpy(a).to(dev)
                for a in rope_tables(226, 7, 30, 45, s, 64))
    args = case(b, s, heads, (cos, sin)) + (False,)
    got = qr._launch_bwd(*args)
    agree = agrees(f'K9 backward [{b},{s},{heads * 64}] dx', [(
        got[0], qr.qk_ln_rope_bwd_plain(*args)[0])])
    assert got[1:] == (None, None)
    ms = cuda_ms(lambda: qr._launch_bwd(*args), reps=20)
    plain_ms = cuda_ms(lambda: qr.qk_ln_rope_bwd_plain(*args), reps=2)
    x, ct, sc, bi = args[:4]
    x4 = x.view(b, s, heads, 64).detach().requires_grad_()
    y = F.layer_norm(x4, (64,), sc.bfloat16(), bi.bfloat16(), 1e-6)
    ct4 = ct.view(b, s, heads, 64)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(y, x4, ct4,
                                                 retain_graph=True), reps=20)
    # bytes as harness/work.qk_ln_rope_bwd_work counts them: x and ct read
    # and dx written once (bf16), the [S, 64] fp32 tables read once
    record('qk_ln_rope_bwd', 'cuda', 'star_tpu_torch/csrc/qk_ln_rope.cu',
           'none: jax.grad of star_tpu/ops/qk_ln_rope.py '
           'qk_ln_rope_reference', agree, ms, plain_ms, 20.0 * x.numel(),
           3 * 2 * x.numel() + 2 * 4 * cos.numel(), lib_ms,
           [b, s, heads * 64])
    results['qk_ln_rope_bwd']['library'] = (
        'partial: autograd of F.layer_norm over the [B, S, H, 64] view, '
        'its backward alone, no rotation')
    del x, ct, x4, y, ct4, got, args
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
    for key, s in (('dit', 9680), ('t2v', 17776)):
        dit = case((2, s, 3072), False, False, True)
        results['fused_ln'][key] = sub_record(
            [2, s, 3072], dit[0], *dit[1:], mode='plain (DiT LayerNorms)',
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


def geglu_ulps(out, p) -> int:
    """K12's output against the plain version: bit for bit, except where
    the kernel's tanhf (the libdevice of the toolkit that built it) and
    PyTorch's (that of the toolkit PyTorch was built with) round the GELU
    to neighbouring bf16 values; there the output must be h times one of
    the plain GELU's two bf16 neighbours, rounded. Returns how many values
    differ; raises on any other difference."""
    import torch
    import torch.nn.functional as F
    from star_tpu_torch.ops.geglu import geglu_plain
    diff = out != geglu_plain(p)
    n = int(diff.sum())
    if n == 0:
        return 0
    h, gate = (t[diff] for t in p.chunk(2, dim=-1))
    bits = F.gelu(gate.float(), approximate='tanh').to(
        torch.bfloat16).view(torch.int16)
    got = out[diff]
    near = [(h.float() * (bits + d).view(torch.bfloat16).float()).to(
        torch.bfloat16) for d in (-1, 1)]
    if not bool(((got == near[0]) | (got == near[1])).all()):
        raise AssertionError('K12 differs from its plain version by more '
                             'than the GELU\'s last bit')
    return n


def check_geglu(dev, record, results) -> None:
    """K12 against its plain version at the GEGLU shapes of a CFG call,
    one a level, and at a ragged M: bit for bit but for the GELU's last bf16
    bit where the two tanhf differ (geglu_ulps). Timed at each, beside the
    plain version (the four passes the UNet ran before) and, as the library
    yardstick, PyTorch's bf16 GELU of the gate view times h: the same
    function (its GELU computed in fp32 and rounded once) in two passes."""
    import torch
    import torch.nn.functional as F
    from star_tpu_torch.ops import geglu as gg
    g = torch.Generator(device=dev).manual_seed(12)
    shapes = []
    for rows, inner in (*GEGLU_TIMED_SHAPES, (1001, 1280), (77, 40)):
        p = (torch.randn(rows, 2 * inner, generator=g, device=dev) * 3
             ).to(torch.bfloat16)
        what = f'K12 [{rows},{2 * inner}]'
        out = gg.geglu(p)
        ulps = geglu_ulps(out, p)
        agree = agrees(what, [(out, gg.geglu_plain(p))])
        log(f'{what}: {ulps} of {out.numel()} values one GELU bit off the '
            f'plain version')
        del out
        if (rows, inner) not in GEGLU_TIMED_SHAPES:
            continue
        h, gate = p.chunk(2, dim=-1)
        library = lambda: F.gelu(gate, approximate='tanh') * h
        lib_same = torch.equal(library(), gg.geglu_plain(p))
        ms = cuda_ms(lambda: gg.geglu(p), reps=20, graph=True)
        plain_ms = cuda_ms(lambda: gg.geglu_plain(p), reps=5)
        lib_ms = cuda_ms(library, reps=20, graph=True)
        work = geglu_work(rows, inner)
        if not shapes:
            record('geglu', 'cuda', 'star_tpu_torch/csrc/geglu.cu',
                   'none: XLA fuses star_tpu/models/unet/blocks.py:108',
                   agree, ms, plain_ms, *work, lib_ms, [rows, 2 * inner])
        shapes.append(sub_record([rows, 2 * inner], agree, ms, plain_ms,
                                 *work, lib_ms, gelu_bit_off=ulps,
                                 library_bit_for_bit=lib_same))
        del p, h, gate
    results['geglu'].update(
        shapes=shapes, library='F.gelu of the bf16 gate view times h: the '
        'same function in two passes')
    torch.cuda.synchronize()


def gn_inputs(n, r, c, dev, g):
    """x [n, r, c] bf16 with a mean and spread of its own in each channel
    (so that mean and variance both matter), scale and bias bf16 [c]."""
    import torch
    mu = torch.randn(n, 1, c, generator=g, device=dev)
    sd = torch.rand(n, 1, c, generator=g, device=dev) * 2 + 0.25
    x = torch.empty(n, r, c, device=dev, dtype=torch.bfloat16)
    for i in range(n):      # in steps, so that no fp32 copy of x is made
        x[i] = (torch.randn(r, c, generator=g, device=dev) * sd[i]
                + mu[i]).to(torch.bfloat16)
    scale = (1 + 0.5 * torch.randn(c, generator=g, device=dev)).to(
        torch.bfloat16)
    bias = (0.5 * torch.randn(c, generator=g, device=dev)).to(
        torch.bfloat16)
    return x, scale, bias


def gn_stats_err(x3, st) -> float:
    """K13's statistics against float64 sums: the largest error of the
    sum relative to the channel's sum of |x|, and of the sum of squares
    relative to itself."""
    import torch
    err = 0.0
    for i in range(x3.shape[0]):       # a float64 copy of one n at a time
        xd = x3[i].double()
        s, a1, s2 = xd.sum(0), xd.abs().sum(0), xd.square().sum(0)
        err = max(err, ((st[0][i].double() - s).abs() / a1).max().item(),
                  ((st[1][i].double() - s2).abs() / s2).max().item())
        del xd
    return err


def gn_apply_eager(x3, mean, a, b, silu):
    """group_norm_plain's apply given bf16 coefficients [N, C]: the
    broadcast bf16 passes, then silu32's expression."""
    import torch.nn.functional as F
    y = (x3 - mean[:, None]) * a[:, None] + b[:, None]
    return F.silu(y.float()).to(y.dtype) if silu else y


def gn_ulps(out, ref) -> tuple[int, float]:
    """Values of `out` that differ from `ref`, and the largest difference
    in bf16 ulps at the value's scale: the spacing of bf16 at the larger of
    |ref| and the RMS of ref over the tensor (a value near zero moves with
    its group's mean, which is of the output's size, not its own)."""
    import torch
    diff = out != ref
    n = int(diff.sum())
    if n == 0:
        return 0, 0.0
    rms = torch.linalg.vector_norm(ref.float()).item() / ref.numel() ** 0.5
    r = ref[diff].float()
    spacing = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(rms))) - 7)
    return n, ((out[diff].float() - r).abs() / spacing).max().item()


# K13's whole GroupNorm against the plain version: its statistics are
# summed in another order than PyTorch's reductions, so where a group's
# fp32 mean or a lies at a bf16 rounding boundary the two round the
# coefficient to neighbouring values, and the group's values move by up to
# that coefficient's last bit times their spread. Measured on an H100:
# 3.2e-05 of the values at [16,920,2560] with the SiLU, by at most 4 ulps
# at their scale (gn_ulps), none at the other timed shapes; held with a
# margin of 30x and 2x
GN_DIFF_SHARE, GN_DIFF_ULPS = 1e-3, 8.0


def check_group_norm(dev, record, results) -> None:
    """K13 at the timed shapes (GN_TIMED_SHAPES) and at ragged ones: its
    statistics against float64 sums (to 1e-6), its apply given the same
    coefficients bit for bit against the eager passes, the whole
    group_norm against group_norm_plain (GN_DIFF_SHARE, GN_DIFF_ULPS), and
    two runs bit for bit. Timed at each timed shape beside the plain
    version and, as the library yardstick, F.group_norm (+ F.silu) on the
    channels-last view."""
    import torch
    import torch.nn.functional as F
    from star_tpu_torch.ops import norms
    g = torch.Generator(device=dev).manual_seed(13)
    shapes = []
    cases = (*GN_TIMED_SHAPES, (3, 1001, 8, True), (2, 77, 40, False),
             (5, 3, 2560, True), (1, 999, 1920, True))
    for n, r, c, silu in cases:
        groups = 32 if c % 32 == 0 else c // 8
        x, scale, bias = gn_inputs(n, r, c, dev, g)
        what = f'K13 [{n},{r},{c}]{" +SiLU" if silu else ""}'
        st = norms._launch_stats(x)
        st_err = gn_stats_err(x, st)
        del st
        coeffs = norms._launch_stats(x, (scale, bias, groups, 1e-6))
        out = norms._launch_apply(x, *coeffs, silu)
        same = torch.equal(out, gn_apply_eager(x, *coeffs, silu))
        del coeffs
        ref = norms.group_norm_plain(x, scale, bias, groups, 1e-6, silu)
        n_diff, max_ulps = gn_ulps(out, ref)
        agree = agrees(what, [(out, ref)])
        again = norms.group_norm(x, scale, bias, groups, 1e-6, silu)
        repeat = torch.equal(again, out)
        share = n_diff / out.numel()
        log(f'{what}: statistics {st_err:.2e} of float64; apply given the '
            f'coefficients bit for bit {same}; {n_diff} of {out.numel()} '
            f'values off the plain version ({share:.2e}), at most '
            f'{max_ulps:.2f} ulps; second run bit for bit {repeat}')
        assert st_err <= 1e-6, (what, st_err)
        assert same, f'{what}: the apply differs from the eager passes'
        assert share <= GN_DIFF_SHARE and max_ulps <= GN_DIFF_ULPS, (
            what, share, max_ulps)
        assert repeat, f'{what}: two runs differ'
        del again, ref, out
        if (n, r, c, silu) not in GN_TIMED_SHAPES:
            del x
            continue
        xv = x.permute(0, 2, 1)          # [N, C, R], channels-last strides

        def library():
            y = F.group_norm(xv, groups, scale, bias, 1e-6)
            return F.silu(y) if silu else y
        ms = cuda_ms(lambda: norms.group_norm(x, scale, bias, groups, 1e-6,
                                              silu), reps=10, graph=True)
        fold = (scale, bias, groups, 1e-6)
        coeffs = norms._launch_stats(x, fold)
        stats_ms = cuda_ms(lambda: norms._launch_stats(x, fold), reps=10,
                           graph=True)
        apply_ms = cuda_ms(lambda: norms._launch_apply(x, *coeffs, silu),
                           reps=10, graph=True)
        y = torch.empty_like(x)
        copy_ms = cuda_ms(lambda: y.copy_(x), reps=10, graph=True)
        del y, coeffs
        plain_ms = cuda_ms(lambda: norms.group_norm_plain(
            x, scale, bias, groups, 1e-6, silu), reps=3)
        lib_ms = cuda_ms(library, reps=5)
        work = gn_work(n, r, c, silu)
        shape = [n, r, c, 'silu' if silu else 'no silu']
        if not shapes:
            record('group_norm', 'cuda', 'star_tpu_torch/csrc/group_norm.cu',
                   'none: XLA fuses star_tpu/models/unet/blocks.py:419-427',
                   agree, ms, plain_ms, *work, lib_ms, shape)
        shapes.append(sub_record(shape, agree, ms, plain_ms, *work, lib_ms,
                                 stats_err=st_err, values_off=n_diff,
                                 max_ulps=max_ulps, stats_ms=stats_ms,
                                 apply_ms=apply_ms, copy_ms=copy_ms,
                                 pct_of_bound=100 * bound_ms(*work)[0] / ms))
        log(f'{what}: {100 * bound_ms(*work)[0] / ms:.1f}% of its bound, '
            f'{lib_ms / ms:.2f}x faster than the library; statistics '
            f'{stats_ms:.4f} ms, apply {apply_ms:.4f} ms, a copy of x '
            f'{copy_ms:.4f} ms')
        del x, xv
    results['group_norm'].update(
        shapes=shapes, library='F.group_norm (+ F.silu) on the channels-last '
        'view [N, C, R]')
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
              'fused_ln', 'fused_resid_ln', 'geglu'):
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
              'fused_gn_silu_tconv3', 'fused_ln', 'fused_resid_ln', 'geglu'):
        assert counts.get(k, 0) > 0, (k, counts)
    assert loss_err <= LOSS_TOL and norm_err <= LOSS_TOL, (loss_err,
                                                           norm_err)
    assert leaf <= GRAD_LEAF_TOL and every <= GRAD_ALL_TOL, (leaf, every,
                                                             name)
    return dict(loss_rel_err=loss_err, grad_norm_rel_err=norm_err,
                worst_leaf_err=leaf, worst_leaf=name, worst_all_err=every,
                launches=counts)


# The small-width Cog train step (phase 2b), card (bf16, kernels) against
# host (fp32, plain versions) on the same bf16-representable weights and
# draws, held as the UNet's is: every leaf within COG_GRAD_ALL_TOL of the
# largest gradient of all, the leaves holding >= 1e-2 of that also within
# COG_GRAD_LEAF_TOL of their own largest, loss and grad_norm within
# COG_LOSS_TOL. Set from five runs on an H100, which read the same (worst
# leaf 3.82e-2, all leaves 6.75e-3, grad_norm 2.96e-4, loss 1.85e-4), with
# margins of 3.1x, 3x and 3.4x; on the host, a K9 backward that rotates
# the wrong way misses the per-leaf one by 10x
# (tests/test_torch_cog_train.py).
COG_GRAD_LEAF_TOL, COG_GRAD_ALL_TOL, COG_LOSS_TOL = 0.12, 0.02, 1e-3
# the small DiT's launches in one loss_and_grads (2 layers, remat): K9 on q
# and k forward and again in the recompute, its backward kernel once for q
# and once for k a layer, K2 `with_l` likewise, K3 once a layer, K10 three
# times a layer twice and the two final norms once
SMALL_COG_TRAIN_LAUNCHES = {'qk_ln_rope': 8, 'qk_ln_rope_bwd': 4,
                            'flash_packed_lse': 4, 'flash_bwd': 2,
                            'fused_ln': 14}


def small_cog_train_case(seed: int = 13):
    """small_cog_dit's DiT with LoRA rank 16 (every zero-init layer made
    non-zero, weights bf16-representable), on the host in fp32, and a
    batch: gt and lq latents [1, 3, 24, 32, 4], context [1, 8, 32], one
    index and noise."""
    import torch
    from star_tpu_torch.models.dit.dit import CogVideoDiT
    g = torch.Generator().manual_seed(seed)
    dit = randomised(CogVideoDiT(
        hidden_size=256, num_layers=2, num_heads=4, patch_size=2,
        latent_channels=4, text_hidden_size=32, text_length=8,
        time_embed_dim=64, lora_rank=16), g)
    with torch.no_grad():
        for layer in dit.layers:
            layer.q_ln_scale.mul_(3.0)
            layer.k_ln_scale.mul_(3.0)
        for p in dit.parameters():
            p.copy_(p.to(torch.bfloat16).float())
    shape = (1, 3, 24, 32, 4)
    batch = {'gt_latent': torch.randn(shape, generator=g),
             'lq_latent': torch.randn(shape, generator=g),
             'y': torch.randn(1, 8, 32, generator=g)}
    return dit, batch, torch.tensor([700]), torch.randn(shape, generator=g)


def small_cog_train_grads(dit, batch, idx, noise):
    """loss_and_grads of the Cog train step: (metrics, {trainable name:
    gradient})."""
    from star_tpu_torch.train.cog_trainer import (CogTrainConfig,
                                                  make_cog_train_state,
                                                  make_cog_train_step)
    cfg = CogTrainConfig(freq_loss=False)
    _, tx = make_cog_train_state(cfg, dit)
    step = make_cog_train_step(cfg, dit, tx)
    metrics = step.loss_and_grads(batch, idx=idx, noise=noise)
    grads = {n: p.grad for n, p in dit.named_parameters() if n in tx.names}
    return {k: float(v) for k, v in metrics.items()}, grads


def check_small_cog_train(dev) -> dict:
    """loss_and_grads of the small LoRA DiT on the card (bf16 module, fp32
    masters, kernels: K9 and its backward, K2 with_l, K3, K10) against the
    host (fp32, plain versions)."""
    import copy
    import torch
    from star_tpu_torch import ops
    from star_tpu_torch.ops import qk_ln_rope
    dit, batch, idx, noise = small_cog_train_case()
    ref_m, ref_g = small_cog_train_grads(copy.deepcopy(dit), batch, idx,
                                         noise)
    card = copy.deepcopy(dit).to(dev, torch.bfloat16)
    ops.reset_launch_counts()
    m, grads = small_cog_train_grads(
        card, {k: v.to(dev) for k, v in batch.items()}, idx.to(dev),
        noise.to(dev))
    torch.cuda.synchronize()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    backwards = qk_ln_rope.BACKWARDS
    leaf, every, name = grad_errors(ref_g, grads)
    loss_err = abs(m['total_loss'] - ref_m['total_loss']) \
        / ref_m['total_loss']
    norm_err = abs(m['grad_norm'] - ref_m['grad_norm']) / ref_m['grad_norm']
    log(f'small Cog train step [1,3,24,32] 592 tokens: card (bf16, kernels)'
        f' vs host (fp32, plain): loss {m["total_loss"]:.6f} vs '
        f'{ref_m["total_loss"]:.6f} (rel {loss_err:.3e}), grad_norm '
        f'{m["grad_norm"]:.6f} vs {ref_m["grad_norm"]:.6f} (rel '
        f'{norm_err:.3e}); worst leaf error {leaf:.3e} of its largest '
        f'({name}; tol {COG_GRAD_LEAF_TOL}), worst error {every:.3e} of the '
        f'largest gradient (tol {COG_GRAD_ALL_TOL}); launches {counts}, K9 '
        f'backwards {backwards}')
    assert counts == SMALL_COG_TRAIN_LAUNCHES, counts
    assert backwards == SMALL_COG_TRAIN_LAUNCHES['qk_ln_rope'] // 2
    assert loss_err <= COG_LOSS_TOL and norm_err <= COG_LOSS_TOL, (
        loss_err, norm_err)
    assert leaf <= COG_GRAD_LEAF_TOL and every <= COG_GRAD_ALL_TOL, (
        leaf, every, name)
    return dict(loss_rel_err=loss_err, grad_norm_rel_err=norm_err,
                worst_leaf_err=leaf, worst_leaf=name, worst_all_err=every,
                launches=counts)


# --------------------------------------------------------------------------
# phases 3 and 6: reference checkpoints through the port's convert/


def to_reference(name_map, state_dict) -> dict:
    """A port state dict -> the reference-named state dict the name map
    reads: its renames, and the inverse of its few reshapes."""
    import dataclasses
    import numpy as np
    from star_tpu_torch.convert import layout
    from star_tpu_torch.convert.tower_maps import HeadPerm
    out = {}
    for key, (src, fn) in name_map.items():
        t = state_dict[key]
        if fn is layout.conv3d_t11_kernel:   # [kt, 1, in, out] -> Conv3d
            t = t[:, 0].permute(2, 1, 0)[..., None, None]
        elif fn is layout.conv1d_as_linear:
            t = t[..., None]
        elif isinstance(fn, HeadPerm):
            t = dataclasses.replace(
                fn, perm=tuple(int(i) for i in np.argsort(fn.perm)))(t)
        elif fn not in (None, layout.as_vector):
            raise ValueError(f'{key}: no inverse for {fn}')
        out[src] = t
    return out


def assert_same_weights(what: str, got, want) -> None:
    """Every tensor of module `got` equals module `want`'s, bit for bit,
    in the same dtype."""
    import torch
    a, b = got.state_dict(), want.state_dict()
    assert set(a) == set(b), f'{what}: keys differ'
    bad = [k for k in b if a[k].dtype != b[k].dtype
           or not torch.equal(a[k], b[k])]
    assert not bad, f'{what}: {len(bad)} tensors differ, first {bad[:3]}'


def convert_through_files(models, dev):
    """phase 3: the I2VGen towers written as reference-named bf16 state
    dicts, converted by the port's convert.cli, loaded by load_star_models
    and held bit for bit to `models`; returns the loaded models and the
    seconds and GB of each step. The files go in a directory under build/
    that is deleted afterwards."""
    import os
    import shutil
    import tempfile
    import torch
    from star_tpu_torch.convert import cli, load
    os.makedirs('build', exist_ok=True)
    root = tempfile.mkdtemp(prefix='convert_', dir='build')
    rec = dict(write_s=0.0, convert_s=0.0)
    try:
        ref_dir = os.path.join(root, 'reference')
        os.makedirs(ref_dir)
        for kind, attr in (('unet', 'unet'), ('vae', 'vae'), ('clip', 'text')):
            _, name_map = load.tower(kind)
            src = os.path.join(ref_dir, f'{kind}.pt')
            t0 = time.perf_counter()
            torch.save(to_reference(name_map,
                                    getattr(models, attr).state_dict()), src)
            t1 = time.perf_counter()
            cli.main([kind, src, os.path.join(root, f'{kind}.pt')])
            rec['write_s'] += t1 - t0
            rec['convert_s'] += time.perf_counter() - t1
        size = lambda d: sum(os.path.getsize(os.path.join(d, f'{k}.pt'))
                             for k in ('unet', 'vae', 'clip')) / 1e9
        rec['gb'], rec['reference_gb'] = size(root), size(ref_dir)
        t0 = time.perf_counter()
        loaded = load.load_star_models(root, dtype=torch.bfloat16, device=dev)
        torch.cuda.synchronize()
        rec['load_s'] = time.perf_counter() - t0
    finally:
        shutil.rmtree(root)
    for attr in ('unet', 'vae', 'text'):
        assert_same_weights(attr, getattr(loaded, attr), getattr(models, attr))
    log(f'I2VGen towers through convert.cli: reference files '
        f'{rec["reference_gb"]:.3f} GB written in {rec["write_s"]:.2f} s, '
        f'converted to {rec["gb"]:.3f} GB in {rec["convert_s"]:.2f} s, '
        f'loaded onto the card in {rec["load_s"]:.2f} s; every tensor bit '
        'for bit')
    return loaded, rec


def convert_in_memory(models, dev) -> dict:
    """phase 6: each CogVideoX tower's state dict through the inverse of
    its name map and back through convert_state_dict on the card, one
    tower at a time; the converted module replaces the original in
    `models` (held bit for bit to it), and the original and its reference
    copy are freed. Returns the seconds of each tower."""
    import torch
    from star_tpu_torch.convert import convert_state_dict, load
    secs = {}
    for kind, attr in (('dit', 'dit'), ('t5', 'text'),
                       ('causal_vae', 'vae')):
        build, name_map = load.tower(kind)
        original = getattr(models, attr)
        ref = to_reference(name_map, original.state_dict())
        t0 = time.perf_counter()
        sd = convert_state_dict(ref, name_map, load.on_meta(build))
        model = load.module_from_state_dict(build, sd, torch.bfloat16, dev)
        torch.cuda.synchronize()
        secs[kind] = time.perf_counter() - t0
        assert_same_weights(kind, model, original)
        setattr(models, attr, model)
        del original, ref, sd, model
        gc.collect()
        torch.cuda.empty_cache()
    log('Cog towers through convert_state_dict on the card, bit for bit: '
        + ', '.join(f'{k} {v:.2f} s' for k, v in secs.items()))
    return secs


class MemoryVideos:
    """The CLIs' job loops' loader and saver on in-memory frames (the
    card's machine has no video codec): load(source) -> (frames, fps),
    save(frames, name, fps) -> name."""

    def __init__(self, **videos):
        self.videos, self.saved = videos, {}

    def load(self, source):
        return self.videos[source], 16.0

    def save(self, frames, name, fps):
        self.saved[name] = frames
        return name


# --------------------------------------------------------------------------
# phases 3-4: the port's main path at full width


def clip_launches(unet_calls: int, text_encodes: int) -> dict:
    """The exact launches of K2 d=512, K5-K7 and K10-K13 in one I2VGen
    clip of 8 frames of 180x320 with `unet_calls` UNet calls and
    `text_encodes` CLIP encodes: two in a fresh pipeline (the prompt and
    the negative one), none for a prompt in the pipeline's text cache."""
    n = unet_calls
    return {
        'fused_ln': n * LN_PER_CFG_STEP['fused_ln']
        + text_encodes * LN_PER_TEXT_ENCODE,
        'fused_resid_ln': n * LN_PER_CFG_STEP['fused_resid_ln'],
        'geglu': n * GEGLU_PER_CFG_STEP['geglu'],
        **{k: n * GN_PER_CFG_STEP[k] + GN_PER_VAE_ENCODE[k]
           + 2 * GN_PER_DECODE_CALL[k] for k in GN_PER_CFG_STEP},
        'flash_d512': D512_PER_CLIP,
        'fused_gn_silu_tconv3': n * K5_PER_CFG_STEP + 2 * K5_PER_DECODE,
        'conv3x3': K6_PER_ENCODE + 2 * K6_PER_DECODE,
        'upsample_conv2x': K7_PER_CLIP}


def run_pipeline(dev) -> dict:
    """Full-width random bf16 models through the port's convert.cli and
    load_star_models, then inference_sr's job loop on 8 frames of 180x320
    -> 720x1280 with the default sampler (the fast 4+11 ladder); returns
    launches, UNet calls, stage seconds, conversion seconds and checks."""
    import numpy as np
    import torch
    from star_tpu_torch import ops
    from star_tpu_torch.cli import inference_sr
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
    models, conversion = convert_through_files(models, dev)
    gc.collect()
    torch.cuda.empty_cache()
    pipe = build_pipeline(models, PipelineConfig(),
                          allow_hash_tokenizer=True, device=dev)
    pipe.time_stages = True
    videos = MemoryVideos(clip=np.random.RandomState(0).uniform(
        0, 255, (8, 180, 320, 3)).astype(np.uint8))

    torch.cuda.reset_peak_memory_stats(dev)
    unet_calls = []
    hook = models.unet.register_forward_pre_hook(
        lambda *_: unet_calls.append(1))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with k7_shapes() as k7_seen:
        saved = inference_sr.run_jobs(
            pipe, [('clip', 'a good video', 'clip.mp4')], videos.load,
            videos.save, seed=666)
    clip_s = time.perf_counter() - t0
    assert saved == ['clip.mp4'], saved
    out = videos.saved['clip.mp4']
    launches = ops.launch_counts()
    hook.remove()
    latents = pipe.last_latents
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f'inference_sr job loop 8x180x320 -> {out.shape} {out.dtype} in '
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
    assert_launches('clip', launches, clip_launches(len(unet_calls), 2))
    assert k7_seen == K7_BY_SHAPE, f'clip: K7 launches by shape {k7_seen}'
    return dict(models=models, pipe=pipe, launches=launches, clip_s=clip_s,
                stages=dict(pipe.stage_seconds), unet_calls=len(unet_calls),
                peak_gb=peak_gb, out_mean=float(out.mean()),
                out_std=float(out.std()), conversion=conversion)


# --------------------------------------------------------------------------
# phase 3b: the resident daemon at full width


def http_json(url: str, body: dict | None = None) -> tuple[int, dict]:
    """(status, JSON body) of a GET, or of a POST of `body` as JSON, to the
    web front-end on this machine's loopback address."""
    import urllib.error
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={'Content-Type': 'application/json'})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def run_serve(dev, pipe, clip_counts: dict) -> dict:
    """Phase 3's pipeline behind the port's daemon: web.serve_web on a
    free loopback port; pipe.warm(8, 180, 320); three requests enqueued
    over HTTP (two 8x180x320 clips held in memory, one whose input does not
    exist); serve.serve_loop in a thread with an in-memory loader and
    saver; the done files read back over HTTP, then the shutdown sentinel.
    Each request's launches are reset by the loader, just before its clip,
    and read by the saver, just after; they must equal the clip's
    (`clip_counts`, two CLIP encodes) with K10 adjusted by 47 a CLIP encode
    (the first prompt is in the text cache, the second is not)."""
    import os
    import shutil
    import tempfile
    import threading
    import numpy as np
    import torch
    from star_tpu_torch import ops
    from star_tpu_torch.cli import serve, web

    os.makedirs('build', exist_ok=True)
    root = tempfile.mkdtemp(prefix='serve_', dir='build')
    qdir, save_dir = os.path.join(root, 'q'), os.path.join(root, 'out')
    srv = web.serve_web(qdir, save_dir, os.path.join(root, 'up'), port=0)
    web_thread = threading.Thread(target=srv.serve_forever, daemon=True)
    web_thread.start()
    base = f'http://127.0.0.1:{srv.server_address[1]}'
    r = np.random.RandomState(1)
    clips = {f'mem://{k}': r.uniform(0, 255, (8, 180, 320, 3))
             .astype(np.uint8) for k in ('a', 'b')}
    unet_calls, text_calls, per_request, outputs = [], [], [], {}

    def load(path):
        ops.reset_launch_counts()
        unet_calls.clear()
        text_calls.clear()
        return clips[path], 16.0

    def save(frames, save_dir, name, fps=16.0):
        per_request.append((ops.launch_counts(), len(unet_calls),
                            len(text_calls)))
        outputs[name] = frames
        return os.path.join(save_dir, name)

    hooks = [pipe.models.unet.register_forward_pre_hook(
        lambda *_: unet_calls.append(1)),
        pipe.models.text.register_forward_pre_hook(
        lambda *_: text_calls.append(1))]
    daemon = None
    try:
        warm_s = pipe.warm(8, 180, 320)
        log(f'serve: warm(8, 180, 320) {warm_s:.2f} s')
        jobs = []
        for body in ({'input_path': 'mem://a', 'prompt': 'a good video',
                      'output_name': 'a.mp4'},
                     {'input_path': 'mem://b', 'prompt': 'a city at night',
                      'seed': 7, 'output_name': 'b.mp4'},
                     {'input_path': 'mem://missing'}):
            time.sleep(0.002)         # job names are milliseconds, in order
            status, res = http_json(f'{base}/enqueue', body)
            assert status == 200, (status, res)
            jobs.append(res['job'])
        assert jobs == sorted(jobs), jobs
        daemon = threading.Thread(target=serve.serve_loop, args=(
            pipe, qdir, save_dir, 0.05), kwargs=dict(load=load, save=save))
        daemon.start()
        deadline = time.time() + 300
        done = {}
        while time.time() < deadline and len(done) < len(jobs):
            for job in jobs:
                if job not in done:
                    status, res = http_json(f'{base}/result/{job}')
                    if status == 200:
                        done[job] = res
            time.sleep(0.1)
        late_counts = ops.launch_counts()
        with open(os.path.join(qdir, 'shutdown'), 'w'):
            pass
        daemon.join(timeout=60)
        assert not daemon.is_alive(), 'the daemon did not shut down'
        left = sorted(os.listdir(qdir))
    finally:
        for h in hooks:
            h.remove()
        srv.shutdown()
        srv.server_close()
        web_thread.join(timeout=10)
        shutil.rmtree(root)
    assert len(done) == 3, f'done {sorted(done)} of {jobs}'
    a, b, bad = (done[j] for j in jobs)
    log(f'serve: done files {a}, {b}, {bad}')
    assert a['ok'] and b['ok'], (a, b)
    assert a['output'].endswith('a.mp4') and b['output'].endswith('b.mp4')
    assert not bad['ok'] and bad['error'] == "KeyError: 'mem://missing'", bad
    assert not [f for f in left if f.endswith('.working')], left
    assert left == sorted(f'{j}.done.json' for j in jobs), left
    # the failing request launched nothing after its loader reset the counts
    assert not any(late_counts.values()), late_counts
    for name in ('a.mp4', 'b.mp4'):
        out = outputs[name]
        assert out.shape == (8, 720, 1280, 3), out.shape
        assert out.dtype == np.uint8, out.dtype
        assert float(out.std()) > 0.0, f'{name}: constant output'
    assert [n for _, n, _ in per_request] == [14, 14], per_request
    assert [t for _, _, t in per_request] == [0, 1], per_request
    for (launches, n_unet, n_text), job in zip(per_request, jobs):
        want = dict(clip_counts)
        want['fused_ln'] += (n_text - 2) * LN_PER_TEXT_ENCODE
        assert launches == want, f'{job}: launches {launches}, want {want}'
        assert_launches(job, launches, clip_launches(n_unet, n_text))
    log(f'serve: request seconds {a["seconds"]}, {b["seconds"]}; failed '
        f'request {bad["seconds"]} s; launches per request '
        f'{[p[0] for p in per_request]}')
    return dict(warm_s=warm_s, request_s=[a['seconds'], b['seconds']],
                failed_s=bad['seconds'],
                launches=[p[0] for p in per_request])


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
            **LN_PER_CFG_STEP, **GEGLU_PER_CFG_STEP, **GN_PER_CFG_STEP,
            'fused_gn_silu_tconv3': K5_PER_CFG_STEP})
        if profile:
            res['profile'] = profile_step(step, profile, bounds={
                'K5 fused GN+SiLU+tconv': bound_sum_ms('k5', unet_k5(2)),
                'K12 GEGLU': sum(n * bound_ms(*geglu_work(*shape))[0]
                                 for shape, n in
                                 GEGLU_PER_CFG_CALL.items()),
                'K13 GroupNorm': gn_bound_ms(GN_PER_CFG_CALL,
                                             GN_STATS_PER_CFG_CALL)})
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
    ('K9 backward', ('qk_ln_rope_bwd',)),
    ('K9 qk-LN+RoPE', ('qk_ln_rope',)),
    ('K10 LayerNorm', ('star_ln_kernel',)),
    ('K11 residual add + LayerNorm', ('star_resid_ln_kernel',)),
    ('K12 GEGLU', ('geglu_kernel',)),
    ('K13 GroupNorm', ('gn_partials_kernel', 'gn_fold_kernel',
                       'gn_apply_kernel')),
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
                 bounds: dict | None = None,
                 ranges: tuple[str, ...] = ()) -> dict:
    """Device time by kernel over one step (torch.profiler), summed by
    kernel family, the busy share, and the top kernels; the full table is
    written to `path`. With `gemm_sources` the GEMM ops (mm, addmm, bmm)
    are also grouped by input shapes and Python stack, with the device
    time of the kernels under each, into `path` with _gemms before its
    extension: the backward's GEMMs have no Python stack, and their shapes
    name them. `bounds` maps a family to the bound of its launches in the
    step (ms), logged beside the family's time. `ranges` names
    torch.profiler.record_function ranges (K9's backward) whose device
    time, the span of the kernels launched inside them on the device's
    timeline, is reported on its own line (the host-side range's device
    time misses the kernels launched through ctypes)."""
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
        # kernels only: not ops, and not the device-side spans of the
        # record_function ranges, which cover kernels counted already
        if ev.device_type != DeviceType.CUDA or ev.key in ranges:
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
    in_ranges = {}
    for ev in prof.key_averages():
        if ev.key in ranges and ev.device_type == DeviceType.CUDA:
            dev_us = getattr(ev, 'self_device_time_total', None)
            if dev_us is None:
                dev_us = getattr(ev, 'self_cuda_time_total', 0.0)
            in_ranges[ev.key] = dict(ms=dev_us / 1e3, count=ev.count)
    with open(path, 'a') as fh:
        for key, r in in_ranges.items():
            fh.write(f'range {r["ms"]:10.3f} ms {r["count"]:6d}  {key}\n')
    for key, r in in_ranges.items():
        log(f'range {key}: {r["ms"]:.1f} ms of device time in {r["count"]} '
            'calls')
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
                top=top, bounds=bounds, gemms=gemms, k5_fp32=k5_fp32,
                ranges=in_ranges)


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
                **GEGLU_PER_TRAIN_STEP,
                **{k: v + 2 * GN_PER_DECODE_CALL[k]
                   for k, v in GN_PER_TRAIN_UNET.items()},
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
# phase 5c: the train step with dropout active


def run_train_dropout(dev, models) -> dict:
    """Phase 5's train step with the UNet's dropout active
    (deterministic=False, rate 0.1): the same full-width models, batch
    shape, TrainConfig() and injected t and noise, the masks drawn from a
    seeded generator in every step. One warm-up and DROPOUT_TIMED_STEPS
    timed steps; finite loss, grad_norm > 0, every master moved, frozen
    parameters bit-identical, the launches of each step exact (K5 only in
    the VAE decode of pred-x0)."""
    import statistics
    import torch
    from star_tpu_torch import ops
    from star_tpu_torch.diffusion import DiffusionTables, default_star_schedule
    from star_tpu_torch.models.clip.tokenizer import default_tokenizer
    from star_tpu_torch.train import (TrainConfig, make_train_state,
                                      make_train_step)

    unet, vae = models.unet, models.vae
    g = torch.Generator(device=dev).manual_seed(17)
    with torch.no_grad():
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
        default_star_schedule(), dev), tx, vae_decode=vae.decode,
        deterministic=False)
    t = torch.randint(0, cfg.num_timesteps, (1,), generator=g, device=dev)
    noise = torch.randn(gt_lat.shape, generator=g, device=dev)
    named = dict(unet.named_parameters())
    frozen = {n: fingerprint(p) for n, p in named.items()
              if n not in state.params}
    masters0 = {n: fingerprint(m) for n, m in state.params.items()}
    gc.collect()
    gc.freeze()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    try:
        for i in range(1 + DROPOUT_TIMED_STEPS):
            ops.reset_launch_counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, m = step(state, batch, g, t=t, noise=noise)
            end.record()
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            ms = start.elapsed_time(end)
            m = {k: float(v) for k, v in m.items()}
            log(f'dropout train step {i}{" (warm-up)" if i == 0 else ""}: '
                f'{ms:.1f} ms; ' + ' '.join(f'{k} {v:.5f}'
                                            for k, v in m.items())
                + f'; launches {counts}')
            assert all(math.isfinite(v) for v in m.values()), m
            assert m['grad_norm'] > 0, m
            assert_launches(f'dropout train step {i}', counts, {
                **LN_PER_TRAIN_STEP, **ATTN_PER_TRAIN_STEP,
                **GEGLU_PER_TRAIN_STEP,
                'fused_gn_silu_tconv3': DROPOUT_K5_PER_TRAIN_STEP,
                'conv3x3': 2 * K6_PER_DECODE,
                'upsample_conv2x': K7_PER_TRAIN_STEP})
            if i:
                times.append(ms)
    finally:
        gc.unfreeze()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    unmoved = [n for n, m in state.params.items()
               if fingerprint(m) == masters0[n]]
    changed = [n for n, f in frozen.items() if fingerprint(named[n]) != f]
    assert not unmoved, f'masters that did not move: {unmoved[:5]}'
    assert not changed, f'frozen parameters changed: {changed[:5]}'
    step_ms = statistics.median(times)
    log(f'dropout train step [1, 8, 90x160, remat, frequency loss, '
        f'dropout 0.1, {UNFUSED_CHAINS_PER_TRAIN_STEP} unfused temporal '
        f'conv chains]: median {step_ms:.1f} ms of '
        f'{[round(x, 1) for x in times]}; peak memory {peak_gb:.1f} GB; '
        f'{len(masters0)} masters all moved, frozen bit-identical')
    res = dict(step_ms=step_ms, steps_ms=times, peak_gb=peak_gb,
               launches=counts, losses=m)
    del state, step, tx, batch
    gc.collect()
    torch.cuda.empty_cache()
    return res


# --------------------------------------------------------------------------
# phase 5b: train_sr's loop at full width


# one train_sr step's kernels: phase 5's train step, the VAE encodes of gt
# and lq (8 frames of 720x1280: K6, K13 and K2 d=512 each) and one CLIP
# encode
SR_CLI_STEP_LAUNCHES = {
    'fused_ln': LN_PER_TRAIN_STEP['fused_ln'] + LN_PER_TEXT_ENCODE,
    'fused_resid_ln': LN_PER_TRAIN_STEP['fused_resid_ln'],
    **GEGLU_PER_TRAIN_STEP,
    **{k: v + 2 * GN_PER_DECODE_CALL[k] + 2 * GN_PER_VAE_ENCODE[k]
       for k, v in GN_PER_TRAIN_UNET.items()},
    'flash_packed_lse': ATTN_PER_TRAIN_STEP['flash_packed_lse'],
    'flash_bwd': ATTN_PER_TRAIN_STEP['flash_bwd'],
    'flash_d512': ATTN_PER_TRAIN_STEP['flash_d512'] + 2,
    'fused_gn_silu_tconv3': 2 * K5_PER_CFG_STEP + 2 * K5_PER_DECODE,
    'conv3x3': 2 * K6_PER_DECODE + 2 * K6_PER_ENCODE,
    'upsample_conv2x': K7_PER_TRAIN_STEP, 'flash_packed': 0}
# the resumed run's step-3 masters against the continued run's: both start
# step 3 from bit-identical state and draws, so they differ by the card's
# run-to-run rounding only (K3's dQ and K5's statistics are atomic adds in
# no fixed order) passed through one AdamW update. Held as the norm of the
# difference over the norm of the continued run's step-3 update, to
# RESUME_TOL: measured 7.4e-4 to 1.06e-3 in five runs on an H100, held
# with a margin of 4.7x; a resume with other draws or data moves the
# update by about its own size.
RESUME_TOL = 5e-3


def synthetic_triplets(n: int, frames: int, h: int, w: int, seed: int):
    """n in-memory training samples as the datasets yield them: gt and lq
    fp32 in [-1, 1] [frames, h, w, 3] (lq a smoothed, noisier gt), and a
    caption."""
    import numpy as np
    r = np.random.RandomState(seed)
    out = []
    for i in range(n):
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        gt = np.stack([np.stack([np.sin(xx / (40 + 9 * c) + t / 3 + i)
                                 * np.cos(yy / (30 + 7 * c)) for c in
                                 range(3)], -1) for t in range(frames)])
        gt = (gt * 0.8 + r.uniform(-0.1, 0.1, gt.shape)).astype(np.float32)
        lq = (gt * 0.7 + r.uniform(-0.2, 0.2, gt.shape)).astype(np.float32)
        out.append({'gt': gt.clip(-1, 1), 'lq': lq.clip(-1, 1),
                    'text': f'a good video {i}'})
    return out


def run_train_sr_cli(dev, models) -> dict:
    """cli/train_sr.py's loop (train_loop over make_trainer) on phase 5's
    full-width models: TrainConfig() with the frequency loss, an in-memory
    iterator of two synthetic 8-frame 720x1280 triplets (8 frames, not the
    CLI's default of 32: 32 do not fit one card without parallel/), batch
    1, 3 steps with checkpointing_steps 2 into build/ckpt_train_sr; the
    step-2 checkpoint reloaded and held bit for bit to the state the run
    had at step 2; then a run resumed from it to step 3, held to the
    continued run's step 3 within RESUME_TOL."""
    import os
    import shutil
    import statistics
    import torch
    from star_tpu_torch import ops
    from star_tpu_torch.cli import train_sr
    from star_tpu_torch.models.clip.tokenizer import default_tokenizer
    from star_tpu_torch.train import TrainConfig
    from star_tpu_torch.train.checkpoint import CheckpointManager

    ckpt_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            'build', 'ckpt_train_sr')
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    g = torch.Generator(device=dev).manual_seed(11)
    cfg = TrainConfig()
    state, step_fn, make_batch, _ = train_sr.make_trainer(
        models, cfg, dev, g, default_tokenizer(allow_fallback=True))
    samples = synthetic_triplets(2, 8, 720, 1280, seed=3)
    make_it = lambda: iter(samples)
    rows, counts, snap = [], [], {}
    adamw = state.opt_state.adamw

    save_s = {}

    class TimedCheckpoints(CheckpointManager):
        def save(self, step, st, generator=None):
            t0 = time.perf_counter()
            done = super().save(step, st, generator)
            save_s[step] = time.perf_counter() - t0
            return done

    def write_row(row):
        """Reads the step's launches; at step 2 copies the state to the
        host (its seconds are taken off step 3's)."""
        torch.cuda.synchronize()
        counts.append(ops.launch_counts())
        ops.reset_launch_counts()
        rows.append(row)
        log(f'train_sr step {row["step"]}: ' + ' '.join(
            f'{k} {v:.5g}' for k, v in row.items()) + f'; launches '
            f'{ {k: v for k, v in counts[-1].items() if v} }')
        if row['step'] == 2:
            t0 = time.perf_counter()
            host = lambda t: t.to('cpu', copy=True)
            snap.update(
                params={n: host(m) for n, m in state.params.items()},
                moments={i: {k: host(v) for k, v in st.items()} for i, st
                         in adamw.state_dict()['state'].items()})
            snap['seconds'] = time.perf_counter() - t0

    ckpt = TimedCheckpoints(ckpt_dir, max_to_keep=3, save_interval_steps=2)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    state = train_sr.train_loop(
        step_fn, state, make_batch, make_it, start_step=0, max_train_steps=3,
        global_batch=1, checkpoints=ckpt, write_row=write_row,
        learning_rate=cfg.learning_rate, generator=g)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    assert ckpt.all_steps() == [1, 2], ckpt.all_steps()
    for i, (row, c) in enumerate(zip(rows, counts)):
        assert set(row) == TRAIN_SR_ROW_KEYS, sorted(row)
        assert all(math.isfinite(v) for v in row.values()), row
        assert_launches(f'train_sr step {i + 1}', c, SR_CLI_STEP_LAUNCHES)
    # the step-2 checkpoint, bit for bit
    blob = torch.load(ckpt.path(2), map_location='cpu', weights_only=True)
    assert blob['step'] == 2
    for n, m in snap['params'].items():
        assert torch.equal(blob['params'][n], m), n
    for i, st in snap['moments'].items():
        for k, v in st.items():
            assert torch.equal(blob['opt']['state'][i][k], v), (i, k)
    del blob
    step3 = {n: m.to('cpu', copy=True) for n, m in state.params.items()}
    # resume from step 2 to step 3, as --resume does; the two samples are
    # one epoch, so the data past steps 1-2 starts a new one (the CLIs'
    # datasets skip to it)
    state = ckpt.restore(2, state, models.unet, g)
    ops.reset_launch_counts()
    resumed_rows = []
    state = train_sr.train_loop(
        step_fn, state, make_batch, make_it, start_step=2, max_train_steps=3,
        global_batch=1, checkpoints=None, write_row=resumed_rows.append,
        learning_rate=cfg.learning_rate, generator=g)
    diff = upd = 0.0
    for n, m in step3.items():
        diff += float((state.params[n].cpu() - m).double().square().sum())
        upd += float((m - snap['params'][n]).double().square().sum())
    worst = math.sqrt(diff / upd)
    log(f'train_sr resumed at step 2: step-3 masters off the continued '
        f'run by {worst:.3e} of its step-3 update (tol {RESUME_TOL}); loss '
        f'{resumed_rows[0]["total_loss"]:.6f} vs {rows[2]["total_loss"]:.6f}')
    assert state.step == 3 and resumed_rows[0]['step'] == 3
    assert worst <= RESUME_TOL, worst
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    # each step's seconds without its checkpoint write (steps 1 and 2) and
    # the host copy of the state (step 3)
    secs = [r['sec_per_step'] - save_s.get(r['step'], 0.0)
            - (snap['seconds'] if r['step'] == 3 else 0.0) for r in rows]
    log(f'train_sr loop [1, 8 frames of 720x1280 -> 90x160 latents, '
        f'frequency loss, bf16 + fp32 masters]: seconds per step '
        f'{[round(x, 3) for x in secs]} (the first with the warm-up; '
        f'checkpoint writes {save_s} s taken off), peak {peak_gb:.2f} GB')
    return dict(sec_per_step=secs, median_s=statistics.median(secs[1:]),
                checkpoint_s=save_s, peak_gb=peak_gb, resume_rel_err=worst,
                rows=rows, launches=counts[-1])


# --------------------------------------------------------------------------
# phase 6: the CogVideoX SR path at full width


def run_cog(dev) -> dict:
    """The published CogVideoX-5B SR models (DiT 42x3072, T5-XXL, causal
    VAE 128) with seeded random bf16 weights made on the card and carried
    through the port's name maps and back (convert_in_memory);
    sample_sr's job loop on 25 synthetic frames of 480x720 (7 latent
    frames of 60x90, 9676 tokens carried as 9680) with the default sampler
    (50 VPSDE-DPM++(2M) steps, DynamicCFG 6 / 5)."""
    import numpy as np
    import torch
    from star_tpu_torch import ops
    from star_tpu_torch.cli import sample_sr
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
    convert_s = convert_in_memory(models, dev)
    log(f'memory allocated after the conversion '
        f'{torch.cuda.memory_allocated(dev) / 1e9:.1f} GB')
    pipe = build_cog_pipeline(models, allow_hash_tokenizer=True, device=dev,
                              time_stages=True)
    videos = MemoryVideos(clip=np.random.RandomState(0).uniform(
        0, 255, (25, 480, 720, 3)).astype(np.uint8))

    torch.cuda.reset_peak_memory_stats(dev)
    dit_calls = []
    hook = models.dit.register_forward_pre_hook(
        lambda *_: dit_calls.append(1))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    saved = sample_sr.run_jobs(pipe, [('clip', 'a good video', 'clip.mp4')],
                               videos.load, videos.save, seed=42)
    clip_s = time.perf_counter() - t0
    assert saved == ['clip.mp4'], saved
    out = videos.saved['clip.mp4']
    launches = ops.launch_counts()
    hook.remove()
    latents = pipe.last_latents
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f'Cog sample_sr job loop 25x480x720 -> {out.shape} {out.dtype} in '
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
    want.update(cog_gn_launches(1, 3))
    assert launches == want, f'Cog clip launches {launches}, want {want}'
    return dict(models=models, launches=launches, clip_s=clip_s,
                stages=dict(pipe.stage_seconds), dit_calls=len(dit_calls),
                init_s=init_s, peak_gb=peak_gb, out_mean=float(out.mean()),
                out_std=float(out.std()), convert_s=convert_s)


def time_dit_step(dev, dit, x_shape, profile: str | None = None) -> dict:
    """One DiT call on the CFG pair: x `x_shape` (the SR DiT's
    [2, 7, 60, 90, 32], noisy || LQ latents, at tools/bench_cog.py's
    shape; the stock DiT's [2, 13, 60, 90, 16]), t = 499, context
    [2, 226, 4096], bf16; CUDA events, mean of 3 after a warm-up."""
    import os
    import torch
    from star_tpu_torch import ops
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(*x_shape, generator=g, device=dev).bfloat16()
    ctx = torch.randn(2, 226, 4096, generator=g, device=dev).bfloat16()
    tt = torch.full((2,), 499, device=dev)
    step = lambda: dit(x, tt, ctx)
    tokens = 226 + x_shape[1] * (x_shape[2] // 2) * (x_shape[3] // 2)
    with torch.no_grad():
        step()
        ops.reset_launch_counts()
        step()
        torch.cuda.synchronize()
        per_step = {k: v for k, v in ops.launch_counts().items() if v}
        ms = cuda_ms(step, reps=3, warmup=0)
        res = dict(ms=ms, launches=per_step)
        log(f'DiT CFG step {list(x_shape)}, {tokens} tokens, bf16: '
            f'{ms:.1f} ms; launches per step {per_step}')
        assert per_step == LAUNCHES_PER_DIT_STEP, (
            f'DiT step: launches {per_step}, want {LAUNCHES_PER_DIT_STEP}')
        if profile:
            root, ext = os.path.splitext(profile)
            res['profile'] = profile_step(step, f'{root}_dit{ext or ".txt"}')
    return res


# --------------------------------------------------------------------------
# phase 7: the CogVideoX text-to-video path at full width


def run_t2v(dev, models) -> dict:
    """The stock CogVideoX-5B DiT (42x3072, 16 input channels, no LIEM)
    made on the card with seeded random bf16 weights in place of phase 6's
    SR DiT, beside phase 6's T5-XXL and causal VAE; sample_t2v's job loop
    on one prompt with the CLI's defaults (49 frames: 13 latent frames of
    60x90, 17776 tokens, none padded; 50 VPSDE-DPM++(2M) steps with
    DynamicCFG 6 / 5) and an in-memory saver."""
    import numpy as np
    import torch
    from star_tpu_torch import ops
    from star_tpu_torch.cli import sample_t2v
    from star_tpu_torch.models.dit.dit import CogVideoDiT
    from star_tpu_torch.models.t5.tokenizer import default_t5_tokenizer
    from star_tpu_torch.pipeline import CogModelBundle
    from star_tpu_torch.pipeline.build import _init_random
    from star_tpu_torch.pipeline.cogvideo_t2v import CogVideoT2VPipeline

    models.dit = None
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dit, = _init_random([lambda: CogVideoDiT(liem=False)], 1,
                        torch.bfloat16, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    log(f'stock DiT (random bf16, liem=False) on the card in {init_s:.1f} '
        f's: {sum(p.numel() for p in dit.parameters())} parameters; memory '
        f'allocated {torch.cuda.memory_allocated(dev) / 1e9:.1f} GB')
    pipe = CogVideoT2VPipeline(
        CogModelBundle(dit, models.vae, models.text,
                       default_t5_tokenizer(allow_fallback=True)),
        device=dev, time_stages=True)
    videos = MemoryVideos()

    torch.cuda.reset_peak_memory_stats(dev)
    dit_calls = []
    hook = dit.register_forward_pre_hook(lambda *_: dit_calls.append(1))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    saved = sample_t2v.run_jobs(pipe, [('a good video', '', 't2v.mp4', 42)],
                                videos.save)
    clip_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    hook.remove()
    assert saved == ['t2v.mp4'], saved
    out = videos.saved['t2v.mp4']
    latents = pipe.last_latents
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f'sample_t2v job loop, 49 frames -> {out.shape} {out.dtype} in '
        f'{clip_s:.2f} s ({len(dit_calls)} DiT calls); stages '
        + ', '.join(f'{k} {v:.3f} s' for k, v in pipe.stage_seconds.items())
        + f'; peak memory {peak_gb:.1f} GB; launches {launches}')
    assert out.shape == (49, 480, 720, 3), out.shape
    assert out.dtype == np.uint8, out.dtype
    assert tuple(latents.shape) == (1, 13, 60, 90, 16), latents.shape
    assert bool(torch.isfinite(latents).all()), 'non-finite latents'
    assert float(out.std()) > 0.0, 'constant output'
    assert len(dit_calls) == 50, len(dit_calls)
    want = {k: COG_PATH_LAUNCHES.get(k, 0) for k in launches}
    want.update(cog_gn_launches(0, 6))
    assert launches == want, f'T2V clip launches {launches}, want {want}'
    return dict(dit=dit, launches=launches, clip_s=clip_s,
                stages=dict(pipe.stage_seconds), dit_calls=len(dit_calls),
                init_s=init_s, peak_gb=peak_gb, out_mean=float(out.mean()),
                out_std=float(out.std()))


# --------------------------------------------------------------------------
# phase 6b: train_cog's loop at full width


# one Cog train step's kernels (batch 1, 7 latent frames of 60x90, 9680
# tokens): the 42 DiT layers run forward and again in their remat
# recompute (K9 on q and k, K2 `with_l`, K10 three times each), K3 once a
# layer in the backward, the two final norms once; T5 and the causal VAE
# launch none, and no K1 runs under grad (tests/test_torch_cog_train.py
# derives these on the CPU). K9's backward kernel launches once a backward
# call, one for each of K9's forward launches outside the recompute. K13
# runs in the two causal-VAE encodes (GN_PER_COG_TRAIN_STEP; the frequency
# loss's decode adds its own).
COG_TRAIN_STEP_LAUNCHES = {'qk_ln_rope': 2 * 84, 'qk_ln_rope_bwd': 84,
                           'flash_packed_lse': 2 * 42, 'flash_bwd': 42,
                           'fused_ln': 2 * 42 * 3 + 2, 'flash_packed': 0}
COG_TRAIN_K9_BACKWARDS = 84
COG_TRAIN_TIMED_STEPS = 3


def fingerprint(p) -> int:
    """An exact integer fingerprint of a tensor's bits (its 16- or 32-bit
    words, each weighted by its position mod 65521 plus 1), to check that a
    parameter did or did not change without holding a copy of it."""
    import torch
    words = p.detach().reshape(-1).view(
        torch.int16 if p.element_size() == 2 else torch.int32).long()
    w = torch.arange(words.numel(), device=p.device) % 65521 + 1
    return int((words * w).sum())


def run_train_cog_cli(dev, models, profile: str | None = None) -> dict:
    """cli/train_cog.py's loop (train_loop over make_cog_trainer) at full
    width: CogVideoDiT(lora_rank=512) with LIEM (42 x 3072, 48 heads) made
    on the card with seeded random bf16 weights (its zero-init LoRA B and
    heads made non-zero, as converted weights are, so that every gradient
    flows) beside phase 6's T5-XXL and causal VAE; synthetic 25-frame
    480x720 triplets (the CLI's defaults: 7 latent frames, 9680 tokens),
    batch 1; one warm-up step and COG_TRAIN_TIMED_STEPS timed ones, then
    one step with the frequency loss (pred-x0 decoded in one window of 7
    latent frames; at 9 frames if that does not fit the card)."""
    import os
    import statistics
    import torch
    from star_tpu_torch import ops
    from star_tpu_torch.cli import train_cog, train_sr
    from star_tpu_torch.models.dit.dit import CogVideoDiT
    from star_tpu_torch.models.t5.tokenizer import default_t5_tokenizer
    from star_tpu_torch.ops import qk_ln_rope
    from star_tpu_torch.pipeline.build import _init_random
    from star_tpu_torch.train.cog_trainer import (CogTrainConfig,
                                                  cog_is_trainable)

    models.dit = None
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dit, = _init_random([lambda: CogVideoDiT(lora_rank=512)], 2,
                        torch.bfloat16, dev)
    g = torch.Generator(device=dev).manual_seed(5)
    with torch.no_grad():
        for mod in dit.modules():
            if getattr(mod, 'zero_init', False):
                for p in mod.parameters(recurse=False):
                    fan_in = p[0].numel() if p.ndim > 1 else 1
                    p.copy_(torch.randn(p.shape, generator=g, device=dev)
                            * (0.1 / math.sqrt(fan_in)))
    torch.cuda.synchronize()
    models.dit = dit
    init_s = time.perf_counter() - t0
    tokenizer = default_t5_tokenizer(allow_fallback=True)

    step_ms = []

    def loop(cfg, samples, steps, time_steps=False):
        """train_loop over a fresh trainer; returns (state, rows, launches
        of each step, K9 backwards of each step, step_fn, make_batch). With
        time_steps, CUDA events around each train step append its ms to
        step_ms."""
        state, step_fn, make_batch = train_cog.make_cog_trainer(
            models, cfg, dev, g, tokenizer)
        rows, counts, backs = [], [], []

        def timed(st, batch):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = step_fn(st, batch)
            end.record()
            torch.cuda.synchronize()
            step_ms.append(start.elapsed_time(end))
            return out

        def write_row(row):
            torch.cuda.synchronize()
            counts.append(ops.launch_counts())
            backs.append(qk_ln_rope.BACKWARDS)
            ops.reset_launch_counts()
            rows.append(row)
        ops.reset_launch_counts()
        state = train_sr.train_loop(
            timed if time_steps else step_fn, state, make_batch,
            lambda: iter(samples), start_step=0, max_train_steps=steps,
            global_batch=1, checkpoints=None, write_row=write_row,
            learning_rate=cfg.learning_rate, generator=g)
        return state, rows, counts, backs, step_fn, make_batch

    named = dict(dit.named_parameters())
    samples = synthetic_triplets(2, 25, 480, 720, seed=4)
    # the frozen parameters' bits, and the masters' (fp32 copies of the
    # trainable ones) as make_cog_train_state will take them
    before = {n: fingerprint(p.float() if cog_is_trainable(n) else p)
              for n, p in named.items()}
    gc.collect()
    gc.freeze()
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        state, rows, counts, backs, step_fn, make_batch = loop(
            CogTrainConfig(freq_loss=False), samples,
            1 + COG_TRAIN_TIMED_STEPS, time_steps=True)
    finally:
        gc.unfreeze()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    n_train = sum(m.numel() for m in state.params.values())
    log(f'Cog train (LoRA 512, 42 x 3072, random bf16): {n_train} '
        f'trainable (fp32 masters), built in {init_s:.1f} s; steps '
        + '; '.join(f'{ms:.1f} ms (loop {r["sec_per_step"]:.3f} s, loss '
                    f'{r["total_loss"]:.5f}, grad_norm {r["grad_norm"]:.5f})'
                    for ms, r in zip(step_ms, rows))
        + f'; launches {counts[-1]}; K9 backwards {backs}')
    for i, (row, c, b) in enumerate(zip(rows, counts, backs)):
        assert set(row) == TRAIN_COG_ROW_KEYS, sorted(row)
        assert all(math.isfinite(v) for v in row.values()), row
        assert row['grad_norm'] > 0, row
        assert_launches(f'Cog train step {i + 1}', c,
                        {**COG_TRAIN_STEP_LAUNCHES, **GN_PER_COG_TRAIN_STEP})
        assert b == COG_TRAIN_K9_BACKWARDS, (i, b)
    frozen_changed = [n for n, p in named.items() if n not in state.params
                      and fingerprint(p) != before[n]]
    unmoved = [n for n, m in state.params.items()
               if fingerprint(m) == before[n]]
    assert not frozen_changed, f'frozen parameters changed: ' \
        f'{frozen_changed[:5]}'
    assert not unmoved, f'masters that did not move: {unmoved[:5]}'
    timed_ms = step_ms[1:]
    res = dict(step_ms=statistics.median(timed_ms), steps_ms=step_ms,
               loop_s=[r['sec_per_step'] for r in rows], peak_gb=peak_gb,
               init_s=init_s, trainable=n_train, launches=counts[-1],
               k9_backwards=backs[-1], losses=rows[-1])
    log(f'Cog train step [1, 7 x 60 x 90 latents, 9680 tokens, remat, '
        f'bf16 + fp32 masters]: median {res["step_ms"]:.1f} ms of '
        f'{[round(x, 1) for x in timed_ms]} (spread '
        f'{max(timed_ms) - min(timed_ms):.1f} ms); loop seconds '
        f'{[round(x, 3) for x in res["loop_s"]]}; peak {peak_gb:.2f} GB; '
        f'{n_train} masters all moved, frozen bit-identical')
    if profile:
        root, ext = os.path.splitext(profile)
        batch = make_batch(samples[:1])

        def one_step():
            nonlocal state
            state, _ = step_fn(state, batch)
        res['profile'] = profile_step(
            one_step, f'{root}_cog_train{ext or ".txt"}', gemm_sources=True,
            ranges=('qk_ln_rope_backward',))
        del batch
    del state, step_fn, make_batch
    gc.collect()
    torch.cuda.empty_cache()

    # one step with the frequency loss: the single-window decode
    freq = dict(frames=25)
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        _, frows, fcounts, fbacks, *_ = loop(CogTrainConfig(), samples[:1], 1)
    except torch.cuda.OutOfMemoryError as e:
        # a finding, not a failure: the step runs again at 9 frames, with
        # the cut recorded beside its numbers
        freq = dict(frames=9, oom_at_25=str(e).splitlines()[0])
    if freq['frames'] == 9:
        log(f'Cog train step with the frequency loss at 25 frames does not '
            f'fit the card ({freq["oom_at_25"]}); again at 9 frames')
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        _, frows, fcounts, fbacks, *_ = loop(
            CogTrainConfig(), synthetic_triplets(1, 9, 480, 720, seed=6), 1)
    freq.update(peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                loop_s=frows[0]['sec_per_step'], row=frows[0])
    assert set(frows[0]) == TRAIN_COG_FREQ_ROW_KEYS, sorted(frows[0])
    assert all(math.isfinite(v) for v in frows[0].values()), frows[0]
    # the decode (one window, outside autograd) launches no kernel but
    # K13: the same others as without it, and K13 a window's more
    assert_launches('Cog train step with the frequency loss', fcounts[0], {
        **COG_TRAIN_STEP_LAUNCHES,
        **{k: v + GN_PER_DECODE_WINDOW
           for k, v in GN_PER_COG_TRAIN_STEP.items()}})
    assert fbacks[0] == COG_TRAIN_K9_BACKWARDS
    log(f'Cog train step with the frequency loss ({freq["frames"]} frames, '
        f'one-window decode): loop {freq["loop_s"]:.3f} s, peak '
        f'{freq["peak_gb"]:.2f} GB; ' + ' '.join(
            f'{k} {v:.5g}' for k, v in frows[0].items()))
    res['freq'] = freq
    del named      # the LoRA DiT stays in models.dit for phase 9
    gc.collect()
    torch.cuda.empty_cache()
    return res


# --------------------------------------------------------------------------
# phase 8: make_paired_data's per-clip work on the card


def run_make_pairs(dev) -> dict:
    """cli/make_paired_data.py's per-clip function on one synthetic clip at
    the CLI's defaults (32 frames of 720x1280, frame_interval already
    applied), recipe default and then mid, the codec stage on (PyAV is not
    on the card's machine: the device-side codec proxy); an in-memory saver
    that is the first to copy to the host. No kernel of the port runs."""
    import numpy as np
    import torch
    from star_tpu_torch import ops
    from star_tpu_torch.cli import make_paired_data
    r = np.random.RandomState(8)
    yy, xx = np.mgrid[0:720, 0:1280].astype(np.float32)
    frames = np.stack([np.stack([np.sin(xx / (50 + 11 * c) + t / 4)
                                 * np.cos(yy / (40 + 7 * c)) for c in
                                 range(3)], -1) * 100 + 128
                       + r.uniform(-20, 20, (720, 1280, 3))
                       for t in range(32)]).clip(0, 255).astype(np.uint8)
    saved, res = {}, {}

    def save(name, text, fps, gt, lq):
        assert gt.is_cuda and lq.is_cuda, 'a tensor left the card early'
        saved[name] = (gt.cpu().numpy(), lq.cpu().numpy())
        return name
    for recipe in ('default', 'mid'):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gt, lq, lq01 = make_paired_data.make_pair(
            frames, index=0, frame_interval=1, seed=1, recipe=recipe,
            device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        assert lq01.is_cuda and gt.is_cuda and lq.is_cuda
        assert tuple(lq01.shape) == (32, 180, 320, 3), lq01.shape
        save(recipe, 'a clip', 16.0, gt, lq)
        g_np, l_np = saved[recipe]
        assert g_np.shape == l_np.shape == (32, 720, 1280, 3)
        assert g_np.dtype == l_np.dtype == np.uint8
        assert float(l_np.std()) > 0 and bool(torch.isfinite(lq01).all())
        assert np.array_equal(g_np, frames), 'gt is not the clip'
        assert not launches, launches
        res[recipe] = dict(seconds=secs, lq_mean=float(l_np.mean()),
                           lq_std=float(l_np.std()),
                           lq_vs_gt=float(np.abs(l_np.astype(np.float32)
                                                 - g_np).mean()))
        log(f'make_paired_data pair, recipe {recipe}, 32 x 720 x 1280 with '
            f'the codec proxy: {secs:.2f} s; LQ [32,180,320,3] -> '
            f'[32,720,1280,3] uint8, mean |lq - gt| '
            f'{res[recipe]["lq_vs_gt"]:.2f}')
    return res


# --------------------------------------------------------------------------
# phase 9: the distributed path over NCCL


def run_distributed(dev, models) -> dict:
    """The port's torch.distributed path over NCCL, in this process: a
    world of one rank (init_distributed with a loopback MASTER_ADDR and a
    free port), or under `torchrun --nproc_per_node W` (`--phase
    distributed`) W ranks, one card each. Every axis of a mesh is a group
    (of one rank at W = 1), so every collective runs. (a) Ulysses
    attention at the DiT's [2, 9680, 48, 64], kv_valid 9676, over W
    context ranks against a direct K1 call on the whole sequence, bit for
    bit, with one K1 launch a rank; (b) cp_decode of 7 latent frames over
    W context ranks against the serial decoder (`models.vae`), within
    COG_VAE_TOL; (c) one step of train_cog's loop on `models.dit` (LoRA)
    through the data-parallel and ZeRO path over W data ranks
    (make_cog_trainer with the mesh) against the same step in one process
    at the global batch of W: the same row (exactly at W = 1; within
    1e-2 at W > 1, whose bf16 batch sums run in another order), the
    masters within what one step's gradient noise moves them (K3's dQ
    order varies from run to run). Each part timed; the group destroyed
    after."""
    import os
    import socket
    import torch
    import torch.distributed as dist
    from star_tpu_torch import ops
    from star_tpu_torch.cli import train_cog, train_sr
    from star_tpu_torch.models.t5.tokenizer import default_t5_tokenizer
    from star_tpu_torch.ops.attention import dot_product_attention_packed
    from star_tpu_torch.parallel import init_distributed, make_mesh
    from star_tpu_torch.parallel.ulysses import ulysses_attention_global
    from star_tpu_torch.train.cog_trainer import (CogTrainConfig,
                                                  cog_is_trainable)
    from star_tpu_torch.vae.causal_vae import cp_decode

    own = 'WORLD_SIZE' not in os.environ     # not started by torchrun
    if own:
        with socket.socket() as sock:
            sock.bind(('127.0.0.1', 0))
            port = sock.getsockname()[1]
        os.environ.update(MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port),
                          RANK='0', WORLD_SIZE='1', LOCAL_RANK='0')
    res = {}
    t0 = time.perf_counter()
    rank, world = init_distributed(device=dev)
    res.update(world=world, init_s=time.perf_counter() - t0)
    say = lambda msg: log(f'phase 9 [rank {rank} of {world}] {msg}')
    try:
        # (a) Ulysses at the DiT's attention shape
        ctx = make_mesh(context=world)
        assert dist.get_backend(ctx.group('context')) == 'nccl'
        g = torch.Generator(device=dev).manual_seed(31)
        q, k, v = (torch.randn(2, 9680, 48, 64, generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ops.reset_launch_counts()
        got = ulysses_attention_global(q, k, v, ctx, kv_valid=9676,
                                       prescaled=True)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        res['ulysses_s'] = time.perf_counter() - t0
        pack = lambda x: x.reshape(2, 9680, 48 * 64)
        want = dot_product_attention_packed(pack(q), pack(k), pack(v), 48,
                                            kv_valid=9676, prescaled=True)
        assert counts['flash_packed'] == 1 and sum(counts.values()) == 1, \
            counts
        assert torch.equal(pack(got), want), \
            float((pack(got) - want).abs().max())
        say(f'(a) ulysses_attention [2,9680,48,64] kv_valid 9676 over '
            f'{world} context rank(s): {res["ulysses_s"]:.3f} s, bit for '
            f'bit with the direct K1 call, launches {counts}')
        del q, k, v, got, want

        # (b) the context-parallel decode of 7 latent frames
        z = torch.randn(1, 7, 60, 90, 16, generator=g, device=dev) \
            .to(torch.bfloat16)
        with torch.no_grad():
            want = models.vae.decoder(z)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = cp_decode(models.vae, z, ctx)
            torch.cuda.synchronize()
        res['cp_decode_s'] = time.perf_counter() - t0
        err = float((got.float() - want.float()).abs().max()
                    / want.float().abs().max())
        res['cp_decode_rel_err'] = err
        say(f'(b) cp_decode [1,7,60,90,16] -> {tuple(got.shape)} over '
            f'{world} context rank(s): {res["cp_decode_s"]:.2f} s, error '
            f'{err:.3e} of the serial decoder\'s largest value (tolerance '
            f'{COG_VAE_TOL})')
        assert got.shape == want.shape and err <= COG_VAE_TOL, err
        del z, got, want
        gc.collect()
        torch.cuda.empty_cache()

        # (c) one train_cog step through the DP/ZeRO path
        dit = models.dit
        tokenizer = default_t5_tokenizer(allow_fallback=True)
        samples = synthetic_triplets(world, 25, 480, 720, seed=8)
        start = {n: p.detach().clone() for n, p in dit.named_parameters()
                 if cog_is_trainable(n)}
        cfg = CogTrainConfig(freq_loss=False)

        def one_step(m):
            with torch.no_grad():
                for n, p in dit.named_parameters():
                    if n in start:
                        p.copy_(start[n])
            gen = torch.Generator(device=dev).manual_seed(21)
            state, step_fn, make_batch = train_cog.make_cog_trainer(
                models, cfg, dev, gen, tokenizer, mesh=m)
            rows = []
            t1 = time.perf_counter()
            state = train_sr.train_loop(
                step_fn, state, make_batch, lambda: iter(samples),
                start_step=0, max_train_steps=1, global_batch=world,
                checkpoints=None, write_row=rows.append,
                learning_rate=cfg.learning_rate, generator=gen)
            torch.cuda.synchronize()
            return state.params, rows[0], time.perf_counter() - t1

        ref, ref_row, ref_s = one_step(None)
        got, row, res['train_cog_step_s'] = one_step(make_mesh(data=world))
        moved = max(float((got[n] - start[n].float()).abs().max())
                    for n in got)
        diff = max(float((got[n] - ref[n]).abs().max()) for n in got)
        res.update(train_cog_master_diff=diff, train_cog_master_moved=moved,
                   train_cog_row=row, train_cog_ref_row=ref_row,
                   train_cog_ref_step_s=ref_s)
        say(f'(c) train_cog step over {world} data rank(s) (ZeRO moments) '
            f'{res["train_cog_step_s"]:.2f} s, one process at the global '
            f'batch {ref_s:.2f} s; loss {row["total_loss"]:.6f} against '
            f'{ref_row["total_loss"]:.6f}, grad_norm {row["grad_norm"]:.6f} '
            f'against {ref_row["grad_norm"]:.6f}; masters apart by at most '
            f'{diff:.3e} (moved by up to {moved:.3e})')
        if world == 1:
            assert row['total_loss'] == ref_row['total_loss'], (row, ref_row)
        else:
            assert abs(row['total_loss'] - ref_row['total_loss']) \
                <= 1e-2 * abs(ref_row['total_loss']), (row, ref_row)
        assert abs(row['grad_norm'] - ref_row['grad_norm']) \
            <= 1e-2 * ref_row['grad_norm'], (row, ref_row)
        # one AdamW step moves an element by at most about lr; run-to-run
        # noise in the gradient can at most flip a step's direction
        assert diff <= 2.5 * cfg.learning_rate, diff
        del ref, got, start
    finally:
        dist.destroy_process_group()
        if own:
            for key in ('MASTER_ADDR', 'MASTER_PORT', 'RANK', 'WORLD_SIZE',
                        'LOCAL_RANK'):
                os.environ.pop(key, None)
    gc.collect()
    torch.cuda.empty_cache()
    return res


def distributed_models(dev):
    """Phase 9's models made on the card alone (`--phase distributed`):
    phase 6b's LoRA-512 DiT (zero-init layers made non-zero), T5-XXL and
    the causal VAE, seeded random bf16."""
    import torch
    from star_tpu_torch.models.dit.dit import CogVideoDiT
    from star_tpu_torch.models.t5.encoder import T5Encoder
    from star_tpu_torch.pipeline.build import CogModels, _init_random
    from star_tpu_torch.vae.causal_vae import CogVideoVAE
    dit, vae, t5 = _init_random([lambda: CogVideoDiT(lora_rank=512),
                                 CogVideoVAE, T5Encoder], 2,
                                torch.bfloat16, dev)
    g = torch.Generator(device=dev).manual_seed(5)
    with torch.no_grad():
        for mod in dit.modules():
            if getattr(mod, 'zero_init', False):
                for p in mod.parameters(recurse=False):
                    fan_in = p[0].numel() if p.ndim > 1 else 1
                    p.copy_(torch.randn(p.shape, generator=g, device=dev)
                            * (0.1 / math.sqrt(fan_in)))
    return CogModels(dit, vae, t5)


# --------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--phase', choices=('all', 'kernels', 'distributed'),
                    default='all',
                    help='kernels: build and check the kernels only; '
                    'distributed: phase 9 alone, on its own models, at the '
                    'world torchrun gives (build the kernels first, in one '
                    'process)')
    ap.add_argument('--profile', metavar='FILE',
                    help='also trace one CFG step with torch.profiler and '
                    'write its device time by kernel to FILE, one train '
                    'step to FILE with _train before its extension, one '
                    'DiT CFG step to FILE with _dit before it, and one Cog '
                    'train step to FILE with _cog_train before it')
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script runs the port on '
              'the card', file=sys.stderr)
        return 2
    from star_tpu_torch.ops import _build

    card = card_line()
    log(f'card: {card}')
    if args.phase == 'distributed':
        import os
        dev = torch.device('cuda', int(os.environ.get('LOCAL_RANK', 0)))
        torch.cuda.set_device(dev)
        _build.lib()
        res = run_distributed(dev, distributed_models(dev))
        log('distributed ' + json.dumps(res))
        return 0
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
    small['cog_train'] = check_small_cog_train(dev)
    run = run_pipeline(dev)
    served = run_serve(dev, run['pipe'], run['launches'])
    step = time_cfg_step(dev, run['models'], args.profile)
    train = run_train(dev, run['models'], args.profile)
    dropout = run_train_dropout(dev, run['models'])
    train_cli = run_train_sr_cli(dev, run['models'])
    # the I2VGen models go before the CogVideoX ones come, so that the Cog
    # clip's peak memory is its own
    del run['models'], run['pipe']
    gc.collect()
    torch.cuda.empty_cache()
    log(f'I2VGen models freed: {torch.cuda.memory_allocated(dev) / 1e9:.2f} '
        'GB still allocated')
    cog = run_cog(dev)
    cog_models = cog.pop('models')
    dit_step = time_dit_step(dev, cog_models.dit, (2, 7, 60, 90, 32),
                             args.profile)
    t2v = run_t2v(dev, cog_models)
    t2v_step = time_dit_step(dev, t2v.pop('dit'), (2, 13, 60, 90, 16))
    cog_train = run_train_cog_cli(dev, cog_models, args.profile)
    distributed = run_distributed(dev, cog_models)
    del cog_models
    pairs = run_make_pairs(dev)
    for name, rec in results.items():
        # each kernel's launches on the path it belongs to: the training
        # forward and backward in the train step, K9 in the Cog clip, its
        # backward in the Cog train step, the others in the I2VGen clip
        on_train = name in ('flash_packed_lse', 'flash_bwd')
        rec['launches'] = (
            train if on_train else cog if name == 'qk_ln_rope'
            else cog_train if name == 'qk_ln_rope_bwd' else run
        )['launches'][name]
        rec['launches_per_cfg_step'] = step['launches'][name]
        rec['launches_per_train_step'] = train['launches'][name]
        rec['launches_per_dropout_train_step'] = dropout['launches'][name]
        rec['launches_cog_clip'] = cog['launches'][name]
        rec['launches_per_dit_step'] = dit_step['launches'].get(name, 0)
        rec['launches_t2v_clip'] = t2v['launches'][name]
        rec['launches_per_sr_cli_step'] = train_cli['launches'][name]
        rec['launches_per_cog_train_step'] = cog_train['launches'][name]
    log('summary ' + json.dumps(dict(
        small_model_errors=small, clip_s=run['clip_s'],
        unet_calls=run['unet_calls'],
        stages=run['stages'], peak_gb=run['peak_gb'], cfg_step_ms=step['ms'],
        profile=step.get('profile'), train_step_ms=train['step_ms'],
        train_steps_ms=train['steps_ms'], train_steps=train['steps'],
        train_peak_gb=train['peak_gb'], train_losses=train['losses'],
        train_profile=train.get('profile'),
        dropout_train_step_ms=dropout['step_ms'],
        dropout_train_steps_ms=dropout['steps_ms'],
        dropout_train_peak_gb=dropout['peak_gb'],
        dropout_train_losses=dropout['losses'], distributed=distributed,
        cog_clip_s=cog['clip_s'],
        cog_dit_calls=cog['dit_calls'], cog_stages=cog['stages'],
        cog_init_s=cog['init_s'], cog_peak_gb=cog['peak_gb'],
        conversion=run['conversion'], cog_convert_s=cog['convert_s'],
        cog_out_mean=cog['out_mean'], cog_out_std=cog['out_std'],
        dit_step_ms=dit_step['ms'], dit_profile=dit_step.get('profile'),
        serve_warm_s=served['warm_s'], serve_request_s=served['request_s'],
        serve_failed_request_s=served['failed_s'], t2v_clip_s=t2v['clip_s'],
        t2v_dit_calls=t2v['dit_calls'], t2v_stages=t2v['stages'],
        t2v_init_s=t2v['init_s'], t2v_peak_gb=t2v['peak_gb'],
        t2v_out_mean=t2v['out_mean'], t2v_out_std=t2v['out_std'],
        t2v_dit_step_ms=t2v_step['ms'],
        train_sr_cli_sec_per_step=train_cli['sec_per_step'],
        train_sr_cli_checkpoint_s=train_cli['checkpoint_s'],
        train_sr_cli_peak_gb=train_cli['peak_gb'],
        train_sr_cli_resume_rel_err=train_cli['resume_rel_err'],
        cog_train_step_ms=cog_train['step_ms'],
        cog_train_steps_ms=cog_train['steps_ms'],
        cog_train_loop_s=cog_train['loop_s'],
        cog_train_peak_gb=cog_train['peak_gb'],
        cog_train_init_s=cog_train['init_s'],
        cog_train_k9_backwards=cog_train['k9_backwards'],
        cog_train_profile=cog_train.get('profile'),
        cog_train_freq=cog_train['freq'], make_pairs=pairs)))
    print(json.dumps({'kernels': list(results.values())}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
