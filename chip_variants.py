"""Time design variants of the port's hand-written kernels on one CUDA card.

    python3 chip_variants.py            # K1, K10/K11, K3, K2 d=512, K5-K7
    python3 chip_variants.py k5 k6      # or only some families

Each variant is a committed source (star_tpu_torch/csrc/) with a few lines
replaced, every replacement checked to match: a deeper or shallower ring,
another block size, or one stage of the kernel replaced by a stand-in to
see what bounds it. Each is built by its own nvcc (all in parallel) into
build/variants/, loaded with ctypes, and timed with CUDA events in turn
with the unmodified source, twice (in one order, then the reverse), in one
process: the numbers compare designs within one call. Variants marked
`timing only` change what the kernel computes and are not checked; the
others are held to the plain version with chip_smoke.py's tolerance.
Some K5 variants change no source but an argument that the launch plan
gives the entry point (the column width NW, the weight ring's depth): they
run the unmodified build. Prints one line per (variant, shape) and, last,
one JSON object.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import subprocess
import sys

import chip_smoke as cs

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(ROOT, 'star_tpu_torch', 'csrc')
OUT = os.path.join(ROOT, 'build', 'variants')

K1_SRC = 'flash_fwd_sm90.cu'
EX2 = '''  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));
  return y;'''
# 2^x for x <= 0 on the FMA pipe: n = round(x) by the 1.5 * 2^23 trick,
# 2^f on [-0.5, 0.5] by a degree-3 fit with p(0) = 1 (relative error
# 1.0e-4), n added into the exponent; x <= -127 gives exactly 0
POLY = '''
__device__ __forceinline__ float ex2_poly(float x) {
  x = fmaxf(x, -127.f);
  const float t = x + 12582912.f;
  const float f = x - (t - 12582912.f);
  float p = fmaf(0.05500893294811249f, f, 0.2422109693288803f);
  p = fmaf(p, f, 0.6932829022407532f);
  p = fmaf(p, f, 1.0f);
  return __int_as_float(__float_as_int(p) + (__float_as_int(t) << 23));
}
'''
EXP_LOOP = '''      s[4 * i] = ex2(fmaf(s[4 * i], c, -n0));
      s[4 * i + 1] = ex2(fmaf(s[4 * i + 1], c, -n0));
      s[4 * i + 2] = ex2(fmaf(s[4 * i + 2], c, -n1));
      s[4 * i + 3] = ex2(fmaf(s[4 * i + 3], c, -n1));'''
LOAD = '''        mbar_wait(&sm.k_empty[st], free_parity);
        mbar_expect_tx(&sm.k_full[st], TILE);'''
LOAD_ONCE = '''        if (j >= STAGES) {   // the stages keep their first tiles
          mbar_wait(&sm.k_empty[st], free_parity);
          mbar_arrive(&sm.k_full[st]);
          mbar_wait(&sm.v_empty[st], free_parity);
          mbar_arrive(&sm.v_full[st]);
          continue;
        }
''' + LOAD


def poly_every(n: int) -> list[tuple[str, str]]:
    """exp2 by the polynomial on every n-th block of 4 logits."""
    mixed = (f'      if (i % {n} == {n - 1}) {{\n'
             + EXP_LOOP.replace('ex2(', 'ex2_poly(') + '\n      } else {\n'
             + EXP_LOOP + '\n      }')
    return [('typedef __nv_bfloat16 bf16;\n',
             'typedef __nv_bfloat16 bf16;\n' + POLY), (EXP_LOOP, mixed)]


NO_EXP2 = [(EX2, '  return fmaf(x, 0.001f, 1.f);')]
STAGES = 'BK = 128, STAGES = 3;'
# name -> (source, [(old, new)], checked)
K1_VARIANTS = {
    'stages2': (K1_SRC, [(STAGES, 'BK = 128, STAGES = 2;')], True),
    'stages4': (K1_SRC, [(STAGES, 'BK = 128, STAGES = 4;')], True),
    'three_groups': (K1_SRC, [('constexpr int NWG = 2;',
                               'constexpr int NWG = 3;')], True),
    'poly_exp2_1of8': (K1_SRC, poly_every(8), True),
    'poly_exp2_1of4': (K1_SRC, poly_every(4), True),
    'poly_exp2_1of2': (K1_SRC, poly_every(2), True),
    'no_exp2 (timing only)': (K1_SRC, NO_EXP2, False),
    'loads_once (timing only)': (K1_SRC, [(LOAD, LOAD_ONCE)], False),
    'no_exp2_loads_once (timing only)': (
        K1_SRC, NO_EXP2 + [(LOAD, LOAD_ONCE)], False),
}
K3_SRC = 'flash_bwd_sm90.cu'
K3_TILES = 'BQ = 64, STAGES = 2;'
K3_VARIANTS = {
    'stages3': (K3_SRC, [(K3_TILES, 'BQ = 64, STAGES = 3;')], True),
    'bq128': (K3_SRC, [(K3_TILES, 'BQ = 128, STAGES = 2;')], True),
    'ordered_dq': (K3_SRC, [('constexpr bool ORDERED_DQ = false;',
                             'constexpr bool ORDERED_DQ = true;')], True),
    'no_exp2 (timing only)': (K3_SRC, NO_EXP2, False),
    'no_dq_adds (timing only)': (K3_SRC, [(
        '      bulk_reduce_add(dqacc +', '      if (kb < 0) bulk_reduce_add(dqacc +')],
        False),
}
D512_SRC = 'flash_fwd_d512_sm90.cu'
# K1's order: S_j issued before P_{j-1} V_{j-1}, the softmax under it
OVERLAP_S_O = [(
    '    fence_op();\n    wgmma_fence();\n    issue_o(pst);\n'
    '    wgmma_wait<0>();                       // P_{j-1} V_{j-1} has retired\n'
    '    fence_op();\n    if (lane == 0) release(&sm.v_empty[pst]);\n'
    '    wgmma_fence();\n    issue_s(st);\n'
    '    wgmma_wait<0>();                       // S_j has landed\n'
    '    fence_s();\n    if (lane == 0) release(&sm.k_empty[st]);\n'
    '    if (SPLIT_S) exchange(j);\n    softmax(j, a0, a1);\n',
    '    fence_op();\n    wgmma_fence();\n    issue_s(st);\n    issue_o(pst);\n'
    '    wgmma_wait<1>();                       // S_j has landed\n'
    '    fence_s();\n    if (lane == 0) release(&sm.k_empty[st]);\n'
    '    if (SPLIT_S) exchange(j);\n    softmax(j, a0, a1);\n'
    '    wgmma_wait<0>();                       // P_{j-1} V_{j-1} has retired\n'
    '    fence_op();\n    if (lane == 0) release(&sm.v_empty[pst]);\n')]
D512_TILES = 'BK = 32, STAGES = 2;'
D512_VARIANTS = {
    'full_s': (D512_SRC, [('constexpr bool SPLIT_S = true;',
                           'constexpr bool SPLIT_S = false;')], True),
    'cluster2': (D512_SRC, [('constexpr int CLUSTER = 1;',
                             'constexpr int CLUSTER = 2;')], True),
    'cluster2_full_s': (D512_SRC, [
        ('constexpr int CLUSTER = 1;', 'constexpr int CLUSTER = 2;'),
        ('constexpr bool SPLIT_S = true;',
         'constexpr bool SPLIT_S = false;')], True),
    'bk64_one_stage': (D512_SRC, [(D512_TILES, 'BK = 64, STAGES = 1;'),
                                  ('constexpr int XBUF = 2;',
                                   'constexpr int XBUF = 1;')], True),
    'o_two_n128': (D512_SRC, [(
        '      wgmma_rs<256, 1>(acc, p + 4 * kk, dv + 128 * kk, 1);',
        '      {\n'
        '        wgmma_rs<128, 1>(*reinterpret_cast<float(*)[64]>(acc),\n'
        '                         p + 4 * kk, dv + 128 * kk, 1);\n'
        '        wgmma_rs<128, 1>(*reinterpret_cast<float(*)[64]>(acc + 64),\n'
        '                         p + 4 * kk, dv + 128 * kk + KPANEL / 4, 1);\n'
        '      }')], True),
    'desc_chain': (D512_SRC, [(
        '      const int pn = pd0 + (kk >> 2);\n'
        '      wgmma_ss<BK, 0, 0>(s, desc_sw128(sm.q[pn], 16, 1024) + 2 * (kk & 3),\n'
        '                         desc_sw128(sm.k[st][pn], 16, 1024) + 2 * (kk & 3),\n'
        '                         kk);\n',
        '      wgmma_ss<BK, 0, 0>(s, qd, kd, kk);\n'
        '      const uint64_t dq_ = (kk & 3) == 3 ? QPANEL / 8 - 6 : 2;\n'
        '      const uint64_t dk_ = (kk & 3) == 3 ? KPANEL / 8 - 6 : 2;\n'
        '      asm volatile("add.s64 %0, %0, %1;" : "+l"(qd) : "l"(dq_));\n'
        '      asm volatile("add.s64 %0, %0, %1;" : "+l"(kd) : "l"(dk_));\n'),
        ('  auto issue_s = [&](int st) {            // s = Q K^T over SPAN panels\n',
         '  auto issue_s = [&](int st) {\n'
         '    uint64_t qd = desc_sw128(sm.q[pd0], 16, 1024);\n'
         '    uint64_t kd = desc_sw128(sm.k[st][pd0], 16, 1024);\n')], True),
    'overlap_s_o': (D512_SRC, OVERLAP_S_O, True),
    'regs_240': (D512_SRC, [('PRODUCER_REGS = 40, CONSUMER_REGS = 232;',
                             'PRODUCER_REGS = 24, CONSUMER_REGS = 240;')],
                 True),
    'no_exp2 (timing only)': (D512_SRC, NO_EXP2, False),
}
LN_SRC = 'fused_ln.cu'


def ln_threads(n: int) -> list[tuple[str, str]]:
    return [('__launch_bounds__(128)', f'__launch_bounds__({n})'),
            ('constexpr int kThreads = 128;', f'constexpr int kThreads = {n};')]


LN_VARIANTS = {
    'threads256': (LN_SRC, ln_threads(256), True),
    'threads512': (LN_SRC, ln_threads(512), True),
}


K5_SRC = 'fused_tconv3_sm90.cu'
SILU = '  return __fdividef(t, 1.f + __expf(-t));'
K5_STATS = '    if (p.want_stats && 2 * tid < NW && cg0 + 2 * tid < p.Cout) {'
K5_PRODUCTS = ('        for (int kk = 0; kk < 4; ++kk) {\n'
               '          const int sc = (kc | tap | kk) != 0;\n'
               '          wgmma_ss<NW')
K5_WLOAD = (
    '            mbar_wait(&bars.w_empty[ws], ((i / W) & 1) ^ 1);\n'
    '            mbar_expect_tx(&bars.w_full[ws], WST_BYTES);')
K5_EPILOGUE = ('    if (p.has_res) mbar_wait(&bars.res_full[c], n & 1);\n'
               '#pragma unroll\n'
               '    for (int mb = 0; mb < 2; ++mb)')
# SLABS = 2 deadlocks: the consumers wait for slab k+1 before releasing
# slab k-1, which slab k+1 would reuse
K5_VARIANTS = {
    'no_silu (timing only)': (K5_SRC, [(SILU, '  return t;')], False),
    'no_transform (timing only)': (K5_SRC, [(
        '      const int r = r0 + 32 * u;\n      if (r >= srows) break;',
        '      const int r = r0 + 32 * u;\n      if (r >= 0) break;')],
        False),
    'no_stats (timing only)': (K5_SRC, [(K5_STATS, K5_STATS.replace(
        'p.want_stats', 'false'))], False),
    'no_epilogue (timing only)': (K5_SRC, [
        (K5_STATS, K5_STATS.replace('p.want_stats', 'false')),
        (K5_EPILOGUE, K5_EPILOGUE.replace('mb < 2; ++mb)', 'mb < 0; ++mb)'))],
        False),
    'no_products (timing only)': (K5_SRC, [(K5_PRODUCTS, K5_PRODUCTS.replace(
        'kk < 4', 'kk < 0'))], False),
    # the weight ring keeps its first W stages: no weight traffic from L2
    'weights_once (timing only)': (K5_SRC, [(K5_WLOAD, K5_WLOAD.replace(
        '            mbar_expect_tx(', '            if (i >= W) {\n'
        '              mbar_arrive(&bars.w_full[ws]);\n'
        '              continue;\n            }\n'
        '            mbar_expect_tx('))], False),
}
# K5 variants of the plan, not the source, on the unmodified build: name
# -> plan overrides (a width the plan would not pick at that shape)
K5_PLAN_VARIANTS = {'nw128': dict(nw=128), 'nw160': dict(nw=160),
                    'wstages2': dict(wstages=2)}
K6_SRC = 'conv3x3_sm90.cu'
K6_WLOAD = (
    '            mbar_wait(&bars.w_empty[ws], ((i / WSTAGES) & 1) ^ 1);\n'
    '            mbar_expect_tx(&bars.w_full[ws], WST_BYTES);')
K6_HLOAD = (
    '          mbar_wait(&bars.act_empty[s], ((k / ASTAGES) & 1) ^ 1);\n'
    '          mbar_expect_tx(&bars.act_full[s], 8 * HPIX * 16);')
K6_VARIANTS = {
    'wstages2': (K6_SRC, [('constexpr int ASTAGES = 2, WSTAGES = 4;',
                           'constexpr int ASTAGES = 2, WSTAGES = 2;')], True),
    'astages3_wstages2': (K6_SRC, [(
        'constexpr int ASTAGES = 2, WSTAGES = 4;',
        'constexpr int ASTAGES = 3, WSTAGES = 2;')], True),
    'no_silu (timing only)': (K6_SRC, [(
        '          e[j] = __float2bfloat16(__fdividef(x, 1.f + __expf(-x)));',
        '          e[j] = __float2bfloat16(x);')], False),
    'no_transform (timing only)': (K6_SRC, [(
        '      if (px >= HPIX) break;',
        '      if (px >= 0) break;')], False),
    'no_stats (timing only)': (K6_SRC, [(
        '    if (p.want_stats) {\n      // thread: columns',
        '    if (false) {\n      // thread: columns')], False),
    'no_products (timing only)': (K6_SRC, [(
        '        for (int kk = 0; kk < 4; ++kk) {\n          const int sc',
        '        for (int kk = 0; kk < 0; ++kk) {\n          const int sc')],
        False),
    'weights_once (timing only)': (K6_SRC, [(K6_WLOAD, K6_WLOAD.replace(
        '            mbar_expect_tx(', '            if (i >= WSTAGES) {\n'
        '              mbar_arrive(&bars.w_full[ws]);\n'
        '              continue;\n            }\n'
        '            mbar_expect_tx('))], False),
    # the halo ring keeps its first stages: no activation traffic
    'halos_once (timing only)': (K6_SRC, [(K6_HLOAD, K6_HLOAD.replace(
        '          mbar_expect_tx(', '          if (k >= ASTAGES) {\n'
        '            mbar_arrive(&bars.act_full[s]);\n'
        '            continue;\n          }\n'
        '          mbar_expect_tx('))], False),
}

K7_SRC = 'upsample_conv_sm90.cu'
K7_WLOAD = (
    '            mbar_wait(&bars.w_empty[ws], ((i / WSTAGES) & 1) ^ 1);\n'
    '            mbar_expect_tx(&bars.w_full[ws], WST_BYTES);')
K7_HLOAD = (
    '          mbar_wait(&bars.act_empty[s], ((k / ASTAGES) & 1) ^ 1);\n'
    '          mbar_expect_tx(&bars.act_full[s], 8 * HPIX * 16);')
K7_ORDER = ('  r.col0 = (t % p.nct) * BN;\n  t /= p.nct;\n'
            '  r.phase = t % PHASES;\n  t /= PHASES;\n')
K7_VARIANTS = {
    'astages3_wstages2': (K7_SRC, [(
        'constexpr int ASTAGES = 2, WSTAGES = 4;',
        'constexpr int ASTAGES = 3, WSTAGES = 2;')], True),
    'wstages2': (K7_SRC, [('constexpr int ASTAGES = 2, WSTAGES = 4;',
                           'constexpr int ASTAGES = 2, WSTAGES = 2;')], True),
    # the phase fastest in the walk, then the column tile
    'phase_fastest': (K7_SRC, [(K7_ORDER, (
        '  r.phase = t % PHASES;\n  t /= PHASES;\n'
        '  r.col0 = (t % p.nct) * BN;\n  t /= p.nct;\n'))], True),
    'no_stats (timing only)': (K7_SRC, [(
        '    if (p.want_stats) {\n      // thread: columns',
        '    if (false) {\n      // thread: columns')], False),
    'no_stores (timing only)': (K7_SRC, [(
        '    if (tid == 0)\n      for (int u = 0; u < 2; ++u)\n'
        '        tma_store_4d(',
        '    if (tid < 0)\n      for (int u = 0; u < 2; ++u)\n'
        '        tma_store_4d(')], False),
    # no staging, stores or statistics: what the products and loads take
    'no_epilogue (timing only)': (K7_SRC, [(
        '    // epilogue: staging is two',
        '    if (t >= 0) continue;\n    // epilogue: staging is two')], False),
    'no_products (timing only)': (K7_SRC, [(
        '        for (int kk = 0; kk < 4; ++kk) {\n          const int sc',
        '        for (int kk = 0; kk < 0; ++kk) {\n          const int sc')],
        False),
    'weights_once (timing only)': (K7_SRC, [(K7_WLOAD, K7_WLOAD.replace(
        '            mbar_expect_tx(', '            if (i >= WSTAGES) {\n'
        '              mbar_arrive(&bars.w_full[ws]);\n'
        '              continue;\n            }\n'
        '            mbar_expect_tx('))], False),
    'halos_once (timing only)': (K7_SRC, [(K7_HLOAD, K7_HLOAD.replace(
        '          mbar_expect_tx(', '          if (k >= ASTAGES) {\n'
        '            mbar_arrive(&bars.act_full[s]);\n'
        '            continue;\n          }\n'
        '          mbar_expect_tx('))], False),
}


# headers written into a variant's source, so that its replacements reach
# the code they hold (the shared kernel body of K6 and K7)
INLINED = ('halo_conv_sm90.cuh',)


def variant_source(src: str, subs) -> str:
    with open(os.path.join(CSRC, src)) as fh:
        text = fh.read()
    for name in INLINED:
        include = f'#include "{name}"\n'
        if include in text:
            with open(os.path.join(CSRC, name)) as fh:
                text = text.replace(
                    include, fh.read().replace('#pragma once\n', ''))
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f'{src}: variant text not found: {old[:60]!r}')
        text = text.replace(old, new)
    return text


def build(variants: dict) -> dict:
    """name -> loaded library; the unmodified source as 'base'."""
    from star_tpu_torch.ops import _build
    os.makedirs(OUT, exist_ok=True)
    nvcc = _build.nvcc_path()
    src0 = next(iter(variants.values()))[0]
    jobs = {'base': (src0, [])}
    jobs.update({k: (v[0], v[1]) for k, v in variants.items()})
    procs = {}
    for i, (name, (src, subs)) in enumerate(jobs.items()):
        cu = os.path.join(OUT, f'v{i}_{src}')
        with open(cu, 'w') as fh:     # beside the originals' headers
            fh.write(variant_source(src, subs))
        so = cu[:-3] + '.so'
        procs[name] = (so, subprocess.Popen(
            [nvcc, *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, '-Xptxas=-v',
             '-I', CSRC, '-shared', cu, '-o', so],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f'{name}: nvcc failed\n{out[-3000:]}')
        regs = [ln.split(': ')[-1].strip() for ln in out.splitlines()
                if 'Used' in ln or 'spill stores' in ln]
        cs.log(f'{name}: {"; ".join(sorted(set(regs)))[:160]}; '
               f'{wgmma_waits(so)}')
        lib = ctypes.CDLL(so)
        for fn, sig in _build._SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = sig
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def wgmma_waits(so: str) -> str:
    """In the SASS of each wgmma kernel of `so` (cuobjdump): its wgmma
    instructions (HGMMA), the waits on them (WARPGROUP.DEPBAR) and its
    highest register. As many waits as products means ptxas serialised
    them."""
    import re
    from star_tpu_torch.ops import _build
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()),
                             'cuobjdump')
    sass = subprocess.run([cuobjdump, '-sass', so], capture_output=True,
                          text=True).stdout
    out = []
    for fn in re.split(r'\n\s*Function : ', sass)[1:]:
        if 'HGMMA' not in fn:
            continue
        regs = [int(r) for r in re.findall(r'\bR(\d+)\b', fn)]
        out.append(f'{fn.split(chr(10), 1)[0].strip()[:24]}: '
                   f'{fn.count("HGMMA")} HGMMA, '
                   f'{fn.count("WARPGROUP.DEPBAR")} waits, R{max(regs)}')
    return '; '.join(out)


def in_turn(libs: dict, run, reps: int) -> dict:
    """name -> [ms, ms]: every library timed once in order, then again in
    the reverse order."""
    res = {n: [] for n in libs}
    for order in (list(libs), list(reversed(list(libs)))):
        for n in order:
            res[n].append(cs.cuda_ms(lambda: run(libs[n]), reps=reps,
                                     warmup=2))
    return res


def k1(dev, g) -> list[dict]:
    import torch
    import torch.nn.functional as F
    from star_tpu_torch.ops import _build, flash_attention as fa
    libs = build(K1_VARIANTS)
    checked = {'base'} | {k for k, v in K1_VARIANTS.items() if v[2]}
    randn = lambda *s: torch.randn(s, generator=g, device=dev).bfloat16()

    def call(lib, q, k, v, h, c, kv, lse):
        b, sq, row = q.shape
        sk = k.shape[1]
        o = torch.empty_like(q)
        ls = torch.empty(b, h, sq, device=dev) if lse else None
        err = lib.star_flash_fwd_d64(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if ls is None else ls.data_ptr(), b, h, sq, sk, kv,
            sq * row, sk * row, sk * row, sq * row, row, row, row, row,
            float(c), _build.stream_ptr(dev))
        _build.check(err, 'star_flash_fwd_d64')
        return o, ls

    q, k, v = (randn(2, 1000, 320) for _ in range(3))
    ref, lref = fa.flash_attention_packed_plain(q, k, v, 5, 0.125, 777,
                                                return_lse=True)
    for name in sorted(checked):
        o, ls = call(libs[name], q, k, v, 5, 0.125 * fa.LOG2E, 777, True)
        cs.agrees(f'{name} [2,1000,320] kv_valid=777', [(o, ref)])
        assert float((ls - lref).abs().max()) <= 1e-3, name
    rows = []
    for (bsz, s, c, kv, pre, lse) in ((16, 14400, 320, 14400, False, False),
                                      (2, 9680, 3072, 9676, True, False),
                                      (8, 14400, 320, 14400, False, True)):
        h = c // 64
        q, k, v = (randn(bsz, s, c) for _ in range(3))
        cc = 1.0 if pre else 0.125 * fa.LOG2E
        res = in_turn(libs, lambda lib: call(lib, q, k, v, h, cc, kv, lse),
                      reps=10)
        to4 = lambda t: t[:, :kv].view(bsz, kv, h, 64).transpose(1, 2)
        q4 = q.view(bsz, s, h, 64).transpose(1, 2)
        sdpa = [cs.cuda_ms(lambda: F.scaled_dot_product_attention(
            q4, to4(k), to4(v), scale=fa.LN2 if pre else None), reps=10,
            warmup=2) for _ in range(2)]
        flops = 4.0 * bsz * h * s * kv * 64
        for name, ms in list(res.items()) + [('SDPA', sdpa)]:
            rows.append(dict(kernel='K1', variant=name,
                             shape=[bsz, s, c], kv_valid=kv, lse=lse,
                             ms=ms, tflops=flops / min(ms) / 1e9))
            cs.log(f'K1 {name:34s} [{bsz},{s},{c}] lse={lse}: '
                   + ' '.join(f'{m:.3f}' for m in ms)
                   + f' ms, {rows[-1]["tflops"]:.0f} TFLOP/s')
        del q, k, v
    return rows


def ln(dev, g) -> list[dict]:
    import torch
    from star_tpu_torch.ops import _build, fused_ln as fl
    libs = build(LN_VARIANTS)
    st = _build.stream_ptr(dev)

    def call(lib, x, r, sc, bi, gw):
        c = x.shape[-1]
        rows = x.numel() // c
        out = torch.empty_like(x)
        gp = None if gw is None else gw.data_ptr()
        if r is None:
            err = lib.star_fused_ln(x.data_ptr(), sc.data_ptr(),
                                    bi.data_ptr(), gp, 1, out.data_ptr(),
                                    rows, c, 1e-5, st)
            _build.check(err, 'star_fused_ln')
            return out
        xr = torch.empty_like(x)
        err = lib.star_fused_resid_ln(x.data_ptr(), r.data_ptr(),
                                      sc.data_ptr(), bi.data_ptr(), gp, 1,
                                      out.data_ptr(), xr.data_ptr(), rows,
                                      c, 1e-5, st)
        _build.check(err, 'star_fused_resid_ln')
        return out

    rows = []
    for shape, gated, resid in (((2, 8, 14400, 320), True, False),
                                ((2, 8, 14400, 320), True, True),
                                ((16, 14400, 320), False, True),
                                ((2, 8, 3600, 640), True, False),
                                ((2, 8, 3600, 640), True, True),
                                ((2, 8, 920, 1280), True, False),
                                ((2, 8, 920, 1280), True, True),
                                ((2, 9680, 3072), False, False)):
        x, r, sc, bi, gw = cs.ln_inputs(shape, gated, resid, dev, g)
        ref = (fl.fused_resid_ln_plain(x, sc, bi, r, gw)[0] if resid
               else fl.fused_ln_plain(x, sc, bi, 1e-5, gw))
        for name, lib in libs.items():
            cs.agrees(f'{name} {list(shape)}', [(call(lib, x, r, sc, bi,
                                                     gw), ref)])
        res = in_turn(libs, lambda lib: call(lib, x, r, sc, bi, gw),
                      reps=50)
        n = x.numel()
        bound = (4 if resid else 2) * 2 * n / cs.PEAK_BYTES * 1e3
        for name, ms in res.items():
            rows.append(dict(kernel='K11' if resid else 'K10',
                             variant=name, shape=list(shape), gated=gated,
                             ms=ms, bound_ms=bound))
            cs.log(f'{"K11" if resid else "K10"} {name:10s} {list(shape)} '
                   f'gated={gated}: ' + ' '.join(f'{m:.4f}' for m in ms)
                   + f' ms, bound {bound:.4f} ms')
    return rows


def k3(dev, g) -> list[dict]:
    import torch
    import torch.nn.functional as F
    from star_tpu_torch.ops import _build, flash_attention as fa
    libs = build(K3_VARIANTS)
    checked = {'base'} | {k for k, v in K3_VARIANTS.items() if v[2]}
    randn = lambda *s: torch.randn(s, generator=g, device=dev).bfloat16()

    def call(lib, q, k, v, o, lse, do, h, scale, kv):
        b, sq, c = q.shape
        sk = k.shape[1]
        # room for the largest query tile of the variants (128 rows)
        ws = torch.empty(max(
            4 * b * h * (-(-sq // t) * t * (fa.K3_D + 2) + -(-sq // t))
            for t in (64, 128)), dtype=torch.uint8, device=dev)
        dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
        err = lib.star_flash_bwd_d64(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), ws.data_ptr(), b, h, sq, sk, kv, sq * c, sk * c,
            c, float(scale), _build.stream_ptr(dev))
        _build.check(err, 'star_flash_bwd_d64')
        return dq, dk, dv

    q, k, v, do = (randn(2, 1000, 320) for _ in range(4))
    o, lse = fa._launch(q, k, v, 5, 64, 0.125 * fa.LOG2E, 777, want_lse=True)
    want = fa.flash_bwd_plain(q, k[:, :777], v[:, :777], o, lse, do, 5,
                              0.125)
    for name in sorted(checked):
        got = call(libs[name], q, k, v, o, lse, do, 5, 0.125, 777)
        cs.agrees(f'K3 {name} [2,1000,320] kv_valid=777', [
            (got[0], want[0]), (got[1][:, :777], want[1]),
            (got[2][:, :777], want[2])])
        assert all(float(t[:, 777:].abs().max()) == 0.0 for t in got[1:])
    rows = []
    for (bsz, s, c) in ((8, 14400, 320), (8, 3680, 640)):
        h = c // 64
        q, k, v, do = (randn(bsz, s, c) for _ in range(4))
        o, lse = fa._launch(q, k, v, h, 64, 0.125 * fa.LOG2E, s,
                            want_lse=True)
        res = in_turn(libs, lambda lib: call(lib, q, k, v, o, lse, do, h,
                                             0.125, s), reps=3)
        to4 = lambda t: t.view(bsz, s, h, 64).transpose(1, 2)
        qg, kg, vg = (to4(t).detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qg, kg, vg)
        sdpa = [cs.cuda_ms(lambda: torch.autograd.grad(
            out, (qg, kg, vg), to4(do), retain_graph=True), reps=3,
            warmup=1) for _ in range(2)]
        flops = 10.0 * bsz * h * s * s * 64
        for name, ms in list(res.items()) + [('SDPA backward', sdpa)]:
            rows.append(dict(kernel='K3', variant=name, shape=[bsz, s, c],
                             ms=ms, tflops=flops / min(ms) / 1e9))
            cs.log(f'K3 {name:24s} [{bsz},{s},{c}]: '
                   + ' '.join(f'{m:.3f}' for m in ms)
                   + f' ms, {rows[-1]["tflops"]:.0f} TFLOP/s')
        del q, k, v, do, o, lse, qg, kg, vg, out
    return rows


def d512(dev, g) -> list[dict]:
    import math
    import torch
    import torch.nn.functional as F
    from star_tpu_torch.ops import _build, flash_attention as fa
    libs = build(D512_VARIANTS)
    checked = {'base'} | {k for k, v in D512_VARIANTS.items() if v[2]}
    randn = lambda *s: torch.randn(s, generator=g, device=dev).bfloat16()
    c = fa.LOG2E / math.sqrt(512)

    def call(lib, q, k, v, kv):
        b, sq = q.shape[:2]
        sk = k.shape[1]
        o = torch.empty_like(q)
        err = lib.star_flash_fwd_d512(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, 1, sq,
            sk, kv, sq * 512, sk * 512, sk * 512, sq * 512, 512, 512, 512,
            512, c, _build.stream_ptr(dev))
        _build.check(err, 'star_flash_fwd_d512')
        return o

    for (bsz, s, kv) in ((2, 1000, 777), (3, 150, 150)):
        q, k, v = (randn(bsz, s, 1, 512) for _ in range(3))
        ref = fa.attention_plain(q, k[:, :kv], v[:, :kv], 1 / math.sqrt(512))
        for name in sorted(checked):
            cs.agrees(f'K2 d=512 {name} [{bsz},{s},1,512] kv_valid={kv}',
                      [(call(libs[name], q, k, v, kv), ref)])
    rows = []
    bsz, s = 8, 14400
    q, k, v = (randn(bsz, s, 1, 512) for _ in range(3))
    res = in_turn(libs, lambda lib: call(lib, q, k, v, s), reps=5)
    tr = lambda t: t.transpose(1, 2)
    sdpa = [cs.cuda_ms(lambda: F.scaled_dot_product_attention(
        tr(q), tr(k), tr(v)), reps=5, warmup=1) for _ in range(2)]
    flops = 4.0 * bsz * s * s * 512
    for name, ms in list(res.items()) + [('SDPA', sdpa)]:
        rows.append(dict(kernel='K2 d=512', variant=name,
                         shape=[bsz, s, 1, 512], ms=ms,
                         tflops=flops / min(ms) / 1e9))
        cs.log(f'K2 d=512 {name:24s} [{bsz},{s},1,512]: '
               + ' '.join(f'{m:.3f}' for m in ms)
               + f' ms, {rows[-1]["tflops"]:.0f} TFLOP/s')
    return rows


def _gn_inputs(g, dev, c, cout, nb, taps_shape):
    import math
    import torch
    a = torch.rand(nb, c, generator=g, device=dev) * 0.5 + 0.75
    b = torch.randn(nb, c, generator=g, device=dev) * 0.3
    w = (torch.randn(*taps_shape, generator=g, device=dev)
         / math.sqrt(taps_shape[0] * c)).bfloat16()
    bias = torch.randn(cout, generator=g, device=dev) * 0.1
    return a, b, w, bias


def k5(dev, g) -> list[dict]:
    """K5 at the UNet's levels and the VAE's 3-frame windows: the source
    variants, and the plan variants on the unmodified build."""
    import torch
    from star_tpu_torch.ops import _build, fused_temporal_conv as ftc
    libs = build(K5_VARIANTS)
    checked = {'base'} | {k for k, v in K5_VARIANTS.items() if v[2]}
    randn = lambda *s: torch.randn(s, generator=g, device=dev).bfloat16()

    def plan_of(shape, over):
        plan = ftc.tconv3_launch_plan(*shape, nw=over.get('nw'))
        if 'wstages' in over:
            plan = dict(plan, wstages=over['wstages'], smem=plan['smem']
                        + (over['wstages'] - plan['wstages']) * 256
                        * plan['nw'])
        return plan

    def call(lib, x, a, b, wt, bias, r, pf, plan):
        bsz, f, n, c = x.shape
        cout = wt.shape[1]
        out = torch.empty(bsz, f, n, cout, device=dev, dtype=torch.bfloat16)
        nrow = bsz * f if pf else bsz
        s1 = torch.zeros(nrow, cout, device=dev)
        s2 = torch.zeros(nrow, cout, device=dev)
        err = lib.star_fused_gn_silu_tconv3(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), wt.data_ptr(),
            bias.data_ptr(), None if r is None else r.data_ptr(),
            out.data_ptr(), s1.data_ptr(), s2.data_ptr(), bsz, f, n, c, cout,
            1, int(pf), plan['p'], plan['ft'], plan['nw'],
            plan['slab_bytes'], plan['wstages'], plan['grid'][0],
            plan['smem'], _build.stream_ptr(dev))
        _build.check(err, f'star_fused_gn_silu_tconv3 {list(x.shape)} '
                     f'Cout {cout} {plan}')
        return out, (s1, s2)

    rows = []
    for shape, res, pf in (((2, 8, 14400, 320, 320), True, False),
                           ((2, 8, 3600, 640, 640), False, False),
                           ((2, 8, 920, 1280, 1280), False, False),
                           ((2, 3, 921600, 128, 128), True, True)):
        bsz, f, n, c, cout = shape
        x = randn(bsz, f, n, c)
        a, b, w3, bias = _gn_inputs(g, dev, c, cout, bsz, (3, c, cout))
        wt = w3.transpose(1, 2).contiguous()
        r = randn(bsz, f, n, cout) if res else None
        runs = {name: (lib, {}) for name, lib in libs.items()}
        base_plan = ftc.tconv3_launch_plan(*shape)
        for name, over in K5_PLAN_VARIANTS.items():
            try:
                plan = plan_of(shape, over)
            except ValueError:               # does not fit at this shape
                continue
            if plan['nw'] != base_plan['nw'] or 'wstages' in over:
                runs[name] = (libs['base'], over)
        ref, sref = ftc.tconv3_plain(x, a, b, w3, bias, r, True, pf)
        for name, (lib, over) in runs.items():
            if name in checked or name in K5_PLAN_VARIANTS:
                out, st = call(lib, x, a, b, wt, bias, r, pf,
                               plan_of(shape, over))
                cs.agrees(f'K5 {name} {list(shape)}', [(out, ref)])
                cs.stats_agree(f'K5 {name} {list(shape)}', st, sref)
                del out, st
        del ref, sref
        ms = {name: [] for name in runs}
        for order in (list(runs), list(reversed(list(runs)))):
            for name in order:
                lib, over = runs[name]
                plan = plan_of(shape, over)
                ms[name].append(cs.cuda_ms(
                    lambda: call(lib, x, a, b, wt, bias, r, pf, plan),
                    reps=10, warmup=2))
        flops = 2.0 * bsz * f * n * 3 * c * cout
        for name, t in ms.items():
            rows.append(dict(kernel='K5', variant=name, shape=list(shape),
                             ms=t, tflops=flops / min(t) / 1e9))
            cs.log(f'K5 {name:28s} {list(shape)}: '
                   + ' '.join(f'{m:.3f}' for m in t)
                   + f' ms, {rows[-1]["tflops"]:.0f} TFLOP/s')
        del x, r
    return rows


def k6(dev, g) -> list[dict]:
    """K6 at the VAE's widest level and at its 256-channel level."""
    import torch
    from star_tpu_torch.ops import _build, conv3x3 as c3
    libs = build(K6_VARIANTS)
    checked = {'base'} | {k for k, v in K6_VARIANTS.items() if v[2]}
    randn = lambda *s: torch.randn(s, generator=g, device=dev).bfloat16()

    def call(lib, x, a, b, wk, bias, r):
        n, h, w, c = x.shape
        cout = wk.shape[0]
        plan = c3.conv3x3_launch_plan(n, h, w, c, cout)
        out = torch.empty(n, h, w, cout, device=dev, dtype=torch.bfloat16)
        s1 = torch.zeros(n, cout, device=dev)
        s2 = torch.zeros(n, cout, device=dev)
        err = lib.star_conv3x3(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), wk.data_ptr(),
            bias.data_ptr(), None if r is None else r.data_ptr(),
            out.data_ptr(), s1.data_ptr(), s2.data_ptr(), n, h, w, c, cout,
            1, plan['grid'][0], _build.stream_ptr(dev))
        _build.check(err, 'star_conv3x3')
        return out, (s1, s2)

    rows = []
    for shape, res in (((8, 720, 1280, 128, 128), True),
                       ((6, 360, 640, 256, 256), True)):
        n, h, w, c, cout = shape
        x = randn(n, h, w, c)
        a, b, wt, bias = _gn_inputs(g, dev, c, cout, n, (cout, c, 3, 3))
        wk = wt.permute(0, 2, 3, 1).contiguous()
        r = randn(n, h, w, cout) if res else None
        ref, sref = c3.conv3x3_plain(x, a, b, wt, bias, r, True)
        for name in sorted(checked):
            out, st = call(libs[name], x, a, b, wk, bias, r)
            cs.agrees(f'K6 {name} {list(shape)}', [(out, ref)])
            cs.stats_agree(f'K6 {name} {list(shape)}', st, sref)
            del out, st
        del ref, sref
        ms = in_turn(libs, lambda lib: call(lib, x, a, b, wk, bias, r),
                     reps=5)
        flops = 2.0 * n * h * w * 9 * c * cout
        for name, t in ms.items():
            rows.append(dict(kernel='K6', variant=name, shape=list(shape),
                             ms=t, tflops=flops / min(t) / 1e9))
            cs.log(f'K6 {name:28s} {list(shape)}: '
                   + ' '.join(f'{m:.3f}' for m in t)
                   + f' ms, {rows[-1]["tflops"]:.0f} TFLOP/s')
        del x, r
    return rows


def k7(dev, g) -> list[dict]:
    """K7 at the decoder's three upsamples (6 images, with statistics)."""
    import torch
    from star_tpu_torch.ops import _build, upsample_conv as uc
    libs = build(K7_VARIANTS)
    checked = {'base'} | {k for k, v in K7_VARIANTS.items() if v[2]}
    randn = lambda *s: torch.randn(s, generator=g, device=dev).bfloat16()

    def call(lib, x, wk, bias):
        n, h, w, c = x.shape
        cout = wk.shape[0]
        plan = uc.upsample_conv2x_launch_plan(n, h, w, c, cout)
        out = torch.empty(n, 2 * h, 2 * w, cout, device=dev,
                          dtype=torch.bfloat16)
        s1 = torch.zeros(n, cout, device=dev)
        s2 = torch.zeros(n, cout, device=dev)
        err = lib.star_upsample_conv2x(
            x.data_ptr(), wk.data_ptr(), bias.data_ptr(), out.data_ptr(),
            s1.data_ptr(), s2.data_ptr(), n, h, w, c, cout, 1,
            *uc.k7_plan_args(plan), plan['grid'][0], _build.stream_ptr(dev))
        _build.check(err, 'star_upsample_conv2x')
        return out, (s1, s2)

    rows = []
    for shape in ((6, 360, 640, 256), (6, 180, 320, 512), (6, 90, 160, 512)):
        n, h, w, c = shape
        x = randn(n, h, w, c)
        wt = (torch.randn(c, c, 3, 3, generator=g, device=dev)
              / math.sqrt(9 * c)).bfloat16()
        bias = torch.randn(c, generator=g, device=dev) * 0.1
        k_rs = uc.phase_weights(wt)
        wk = uc.k7_weights(k_rs, dev)
        ref, sref = uc.upsample_conv2x_plain(x, k_rs, bias, True)
        for name in sorted(checked):
            out, st = call(libs[name], x, wk, bias)
            cs.agrees(f'K7 {name} {list(shape)}', [(out, ref)])
            cs.stats_agree(f'K7 {name} {list(shape)}', st, sref)
            del out, st
        del ref, sref
        ms = in_turn(libs, lambda lib: call(lib, x, wk, bias), reps=5)
        flops, nbytes = cs.k7_work(n, h, w, c, c)
        bound = cs.bound_ms(flops, nbytes)[0]
        for name, t in ms.items():
            rows.append(dict(kernel='K7', variant=name, shape=list(shape),
                             ms=t, tflops=flops / min(t) / 1e9,
                             bound_ms=bound))
            cs.log(f'K7 {name:28s} {list(shape)}: '
                   + ' '.join(f'{m:.3f}' for m in t)
                   + f' ms, {rows[-1]["tflops"]:.0f} TFLOP/s, '
                   f'{100 * bound / min(t):.0f}% of the bound')
        del x
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_variants: no CUDA device', file=sys.stderr)
        return 2
    which = sys.argv[1:] or ['k1', 'ln', 'k3', 'd512', 'k5', 'k6', 'k7']
    card = cs.card_line()
    cs.log(f'card: {card}')
    dev = torch.device('cuda', 0)
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    if 'k1' in which:
        rows += k1(dev, g)
    if 'ln' in which:
        rows += ln(dev, g)
    if 'k3' in which:
        rows += k3(dev, g)
    if 'd512' in which:
        rows += d512(dev, g)
    if 'k5' in which:
        rows += k5(dev, g)
    if 'k6' in which:
        rows += k6(dev, g)
    if 'k7' in which:
        rows += k7(dev, g)
    clocks = subprocess.run(
        ['nvidia-smi', '--query-gpu=clocks.sm,power.draw',
         '--format=csv,noheader'], capture_output=True, text=True).stdout
    print(json.dumps(dict(card=card, clocks_power_after=clocks.strip(),
                          rows=rows)))
    return 0


if __name__ == '__main__':
    sys.exit(main())
