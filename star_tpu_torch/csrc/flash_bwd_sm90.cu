// Flash-attention backward at d=64 for Hopper (sm_90a) on wgmma + TMA: K3
// of the port.
//
// Replaces the Pallas recompute backward of star_tpu/ops/flash_attention.py
// (`_flash_bwd_kernel` via `_flash_bwd`, :592), the gradient of the
// training forward that saves the softmax statistic (K2's `with_l` mode;
// csrc/flash_fwd_sm90.cu writes the natural log-sum-exp `lse` [B*H, Sq]).
// d=64 heads are read in place from the natural [B, S, H*64] layout of the
// projections (row stride rs, head h at column h*64), as the forward reads
// them. With P = exp(scale q k^T - lse) and D = rowsum(dO o):
//   dS = P (dO v^T - D),  dV = P^T dO,  dK = scale dS^T q,  dQ = scale dS k.
// P and dS are rounded to bf16 before the products, as the Pallas kernel
// rounds them; every product accumulates in fp32; dq/dk/dv are bf16.
//
// What bounds it on the H100: tensor-core operations, 10*S^2*d FLOPs a
// head (five products of 2*S^2*d) against a few bytes a token; the
// [S, S] tiles never reach device memory. One pass computes all five
// (FlashAttention-3's form; the kernel this replaced ran two passes and 14).
//
// Three launches, one call (`star_flash_bwd_d64`):
//  1. `flash_bwd_prep`: D = rowsum(dO o) in fp32 and the lse in the log2
//     domain, both [B*H, Sq_pad] (Sq rounded up to the query tile; the pad
//     rows get D = 0 and lse = +inf, so P = 0 there), and zeroes the fp32
//     dQ workspace (B*H*Sq_pad*64; with ORDERED_DQ the tile semaphores).
//  2. `flash_bwd_d64_sm90`, one block per (128-key tile, batch*head):
//     - warp specialised: warpgroup 0 is the producer (one thread issues
//       TMA; setmaxnreg hands its registers to the consumers), warpgroups
//       1 and 2 are consumers owning 64 keys each. K and V arrive once;
//       dK and dV (64x64 fp32 each) stay in registers over the whole
//       query loop;
//     - the producer streams query tiles of BQ rows through a ring of
//       STAGES full/empty mbarriers: q and dO by 3-D tensor maps over the
//       natural layout (a 64-column box at x = h*64, 128-byte swizzle),
//       the tile's lse and D by bulk copies;
//     - per query tile, in each consumer: S^T = K q^T and dP^T = V dO^T by
//       wgmma from shared memory; P^T = exp2(S^T c - lse) and
//       dS^T = P^T (dP^T - D) in registers; dV += P^T dO and dK += dS^T q
//       by wgmma with A from registers (the fp32 accumulators pack
//       pairwise into the A layout, as K1 packs P); dS^T goes to shared
//       memory in bf16, and after a named barrier over both consumers each
//       issues its half of dQ_tile = dS K from there (32 of the 64
//       columns, against K^T, transposed into shared memory once per
//       block);
//     - each consumer stages its fp32 dQ half in shared memory in its
//       register order and one thread adds it into the workspace by one
//       bulk reduce (cp.reduce.async.bulk .add.f32, 8 KB), in no fixed
//       order between key tiles (with ORDERED_DQ, in key-tile order
//       behind a semaphore per query tile). 16-byte atomics from the
//       registers in its place (4 a thread and tile) made the kernel 13%
//       slower at [8,14400,320] (chip_variants.py, H100 SXM).
//  3. `flash_bwd_dq`: dq = bf16(scale * workspace) in q's layout, reading
//     the workspace in the consumers' order.
// Dead keys (>= kv_valid): the K/V maps end there, so they read as zero
// (their dQ terms vanish with K) and their dK/dV rows are not stored; no
// key tile past kv_valid is launched. Ragged query rows read as zero
// (q, dO) with P = 0 (lse = +inf), so they add nothing to dK and dV.

#include <math.h>

#include "sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace k3 {
constexpr int NWG = 2;                    // consumer warpgroups, 64 keys each
constexpr int D = 64, BK = 64 * NWG, BQ = 64, STAGES = 2;
constexpr bool ORDERED_DQ = false;        // dQ adds in key-tile order
constexpr int THREADS = 128 * (NWG + 1);  // + the producer warpgroup
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int KTILE = BK * D * 2;         // bytes of the K or V tile
constexpr int QTILE = BQ * D * 2;         // bytes of a q or dO tile
constexpr int NS = BQ / 2;                // fp32 a thread of S^T [64 x BQ]
constexpr int NP = BQ / 4;                // their bf16 pairs (A fragments)
// dQ of a query tile over the block's keys, [BQ x 64]: at BQ = 64 each
// group computes 32 of its columns, at BQ = 128 its own 64 query rows
constexpr int DQN = BQ == 64 ? 32 : 64;
constexpr int DQ_TILE = DQN / 8 * 512;    // fp32 of a group's dQ part
constexpr int DQBUF = BQ == 64 ? 2 : 1;   // its staging buffers
// named barriers (0: syncthreads): both consumers; DQ_BAR + group: one
constexpr int DS_BAR = 1, DQ_BAR = 2;
constexpr int PREP_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

struct Smem {                             // every tile 1024-byte aligned
  bf16 k[BK * D];                         // group w's keys at rows 64w..
  bf16 v[BK * D];
  bf16 kt[BK * D];                        // K^T: per group [64 dims][64 keys]
  bf16 q[STAGES][BQ * D];
  bf16 dout[STAGES][BQ * D];
  bf16 ds[2][BK * BQ];                    // dS^T: BQ/64 panels [BK keys][64]
  float dqs[NWG][DQBUF][DQ_TILE];         // dQ parts on their way out
  float lse[STAGES][BQ];                  // log2 domain, +inf past Sq
  float dd[STAGES][BQ];                   // D, 0 past Sq
  uint64_t kv_full;
  uint64_t full[STAGES], empty[STAGES];
};
constexpr int SMEM = sizeof(Smem) + 1024;  // + room to align the base
}  // namespace k3

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D, the log2-domain lse and the zeroed workspace; one thread per 8 dims
// of one (batch*head, padded query row)
__global__ void __launch_bounds__(k3::PREP_THREADS)
flash_bwd_prep(const bf16* __restrict__ o, const bf16* __restrict__ dout,
               const float* __restrict__ lse, float* __restrict__ dqacc,
               float* __restrict__ dd, float* __restrict__ lse2,
               int* __restrict__ sem, int H, int Sq, int sq_pad,
               long long q_bs, int rs) {
  using namespace k3;
  const long long t = blockIdx.x * (long long)PREP_THREADS + threadIdx.x;
  const int chunk = (int)(t & 7);
  const long long row = t >> 3;            // bh * sq_pad + query
  const int bh = (int)(row / sq_pad), qi = (int)(row - (long long)bh * sq_pad);
  const int b = bh / H, h = bh - b * H;
  float acc = 0.f;
  if (qi < Sq) {
    const long long off = b * q_bs + (long long)qi * rs + h * D + chunk * 8;
    const uint4 a = *reinterpret_cast<const uint4*>(o + off);
    const uint4 g = *reinterpret_cast<const uint4*>(dout + off);
    const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* pg = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(pa[e]), y = __bfloat1622float2(pg[e]);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  }
#pragma unroll
  for (int off = 1; off <= 4; off <<= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  float4* z = reinterpret_cast<float4*>(dqacc + row * D + chunk * 8);
  z[0] = make_float4(0.f, 0.f, 0.f, 0.f);
  z[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (chunk == 0) {
    dd[row] = acc;
    lse2[row] = qi < Sq ? lse[(long long)bh * Sq + qi] * LOG2E : INFINITY;
    if (ORDERED_DQ && qi % BQ == 0) sem[row / BQ] = 0;
  }
}

// dq = bf16(scale * workspace): one thread per 8 dims of a live query row.
// The workspace holds each group's dQ part of each query tile as the
// consumer wrote it, [bh][tile][group][column block i][thread][4]: element
// e of thread 32*warp + 4*g + t of block i is row 16*warp + g (+ 8 for
// e >= 2) and column 8i + 2t + (e & 1) of the part (rows of the tile and
// columns 32*group.. at BQ = 64; rows 64*group.. and all columns at 128).
__global__ void __launch_bounds__(k3::PREP_THREADS)
flash_bwd_dq(const float* __restrict__ dqacc, bf16* __restrict__ dq, int H,
             int Sq, int nq, long long q_bs, int rs, long long total,
             float scale) {
  using namespace k3;
  const long long t = blockIdx.x * (long long)PREP_THREADS + threadIdx.x;
  if (t >= total) return;
  const int chunk = (int)(t & 7);
  const long long row = t >> 3;            // bh * Sq + query
  const int bh = (int)(row / Sq), qi = (int)(row - (long long)bh * Sq);
  const int b = bh / H, h = bh - b * H;
  const int j = qi / BQ, r = qi % BQ;
  const int wg = BQ == 64 ? chunk / 4 : r / 64;       // the part's group
  const int rr = r % 64, i = BQ == 64 ? chunk % 4 : chunk;
  const int e0 = (rr & 15) >= 8 ? 2 : 0;
  const float* src = dqacc + ((long long)(bh * nq + j) * NWG + wg) * DQ_TILE +
                     i * 512 + ((rr >> 4) * 32 + (rr & 7) * 4) * 4 + e0;
  uint4 out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int t4 = 0; t4 < 4; ++t4) {         // columns 2*t4, 2*t4 + 1
    const float2 x = *reinterpret_cast<const float2*>(src + t4 * 4);
    o[t4] = pack_bf16(x.x * scale, x.y * scale);
  }
  *reinterpret_cast<uint4*>(dq + b * q_bs + (long long)qi * rs + h * D +
                            chunk * 8) = out;
}

// One consumer warpgroup: 64 keys against every query tile.
// Accumulator layout (wgmma m64nN): warp w of the group holds rows
// 16w + g and 16w + g + 8 (g = lane / 4); register 4i + e holds column
// 8i + 2*(lane % 4) + (e & 1) of row g (e < 2) or g + 8 (e >= 2). Rows are
// keys and columns queries in S^T, dP^T, dK and dV (columns: dims there).
__device__ __forceinline__ void k3_consumer(
    k3::Smem& sm, int wg, float* __restrict__ dqacc, int* __restrict__ sem,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int bh, int b, int h,
    int kb, int nq, int kv_valid, long long k_bs, int rs,
    float c, float scale) {
  using namespace k3;
  using namespace sm90;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  float adk[32], adv[32];   // dK, dV: 64 keys x 64 dims
  float s[NS], dp[NS];      // S^T then P^T; dP^T then dS^T
  float dq[DQN / 2];        // this group's part of the tile's dQ
  uint32_t p[NP], ds[NP];   // P^T and dS^T in bf16, A fragments
#pragma unroll
  for (int i = 0; i < 32; ++i) adk[i] = adv[i] = 0.f;

  // K^T: this group's 64 keys, transposed into its panel of kt (rows are
  // dims, keys contiguous, 128-byte swizzle): the K-major B of dQ = dS K
  mbar_wait(&sm.kv_full, 0);
  {
    const unsigned char* ks =
        reinterpret_cast<const unsigned char*>(sm.k + wg * 64 * D);
    unsigned char* kt = reinterpret_cast<unsigned char*>(sm.kt + wg * 64 * D);
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int idx = tid + 128 * it, key = idx >> 3, ch = idx & 7;
      const uint4 val = *reinterpret_cast<const uint4*>(
          ks + key * 128 + ((ch ^ (key & 7)) << 4));
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int d = ch * 8 + x;
        *reinterpret_cast<bf16*>(kt + d * 128 +
                                 (((key >> 3) ^ (d & 7)) << 4) +
                                 (key & 7) * 2) = e[x];
      }
    }
    fence_proxy_async();   // before the wgmma reads of kt (async proxy)
  }

  const uint64_t ka = desc_sw128(sm.k + wg * 64 * D, 16, 1024);
  const uint64_t va = desc_sw128(sm.v + wg * 64 * D, 16, 1024);
  const int dq_panel = BQ == 64 ? 0 : wg;   // dS^T query panel of the dQ
  const int dq_col = BQ == 64 ? 32 * wg : 0;
  // B of dQ: kt rows dq_col.. (dims); keys 0-63 in panel 0, 64-127 in 1
  const uint64_t ktb = desc_sw128(sm.kt + dq_col * 64, 16, 1024);
  const int key_row = wg * 64 + warp * 16 + g;   // this thread's key rows

  // S^T = K q^T and dP^T = V dO^T of tile j (both operands K-major), two
  // groups
  auto issue_s = [&](int j) {
    const int st = j % STAGES;
    mbar_wait(&sm.full[st], (j / STAGES) & 1);
    const uint64_t qk = desc_sw128(sm.q[st], 16, 1024);
    const uint64_t dok = desc_sw128(sm.dout[st], 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<BQ, 0, 0>(s, ka + 2 * kk, qk + 2 * kk, kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<BQ, 0, 0>(dp, va + 2 * kk, dok + 2 * kk, kk);
    wgmma_commit();
  };
  // the fp32 dQ part of tile j into the workspace: this group stages it in
  // shared memory in its register order and one thread adds the whole part
  // into the workspace by a bulk reduce (no order between key tiles; with
  // ORDERED_DQ, key tile kb adds after kb - 1, a semaphore per query tile
  // counting the groups that have added)
  auto add_dq = [&](int j) {
#pragma unroll
    for (int i = 0; i < DQN / 2; ++i) fence_reg(dq[i]);
    // the add that last read this buffer is done reading: its thread
    // waited for that before the DS_BAR barrier of this tile
    float* buf = sm.dqs[wg][j % DQBUF];
#pragma unroll
    for (int i = 0; i < DQN / 8; ++i)
      *reinterpret_cast<float4*>(buf + i * 512 + tid * 4) =
          make_float4(dq[4 * i], dq[4 * i + 1], dq[4 * i + 2],
                      dq[4 * i + 3]);
    fence_proxy_async();
    bar_sync(DQ_BAR + wg, 128);
    if (tid == 0) {
      volatile int* sp = sem + (long long)bh * nq + j;
      if (ORDERED_DQ) {
        uint32_t tries = 0;
        while (*sp < NWG * kb)
          if (++tries == (1u << 26)) __trap();
        __threadfence();
      }
      bulk_reduce_add(dqacc + ((long long)(bh * nq + j) * NWG + wg) * DQ_TILE,
                      buf, DQ_TILE * 4);
      bulk_wait_read<DQBUF - 1>();   // the next write's buffer is free
      if (ORDERED_DQ) {
        bulk_wait<0>();
        __threadfence();
        atomicAdd(const_cast<int*>(sp), 1);
      }
    }
  };

  // The products of tile j are committed as S^T_j, dP^T_j, (dV, dK)_j and
  // dQ_j: the tensor cores run dP^T_j while P^T_j is computed, and the two
  // consumer groups' products interleave.
  for (int j = 0; j < nq; ++j) {
    const int st = j % STAGES;
    issue_s(j);
    wgmma_wait<1>();                       // S^T_j has landed
#pragma unroll
    for (int i = 0; i < NS; ++i) fence_reg(s[i]);
    const float* ls = sm.lse[st];
    const float* dvec = sm.dd[st];
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i) {
      const float2 l = *reinterpret_cast<const float2*>(ls + 8 * i + 2 * t4);
      s[4 * i] = ex2(fmaf(s[4 * i], c, -l.x));
      s[4 * i + 1] = ex2(fmaf(s[4 * i + 1], c, -l.y));
      s[4 * i + 2] = ex2(fmaf(s[4 * i + 2], c, -l.x));
      s[4 * i + 3] = ex2(fmaf(s[4 * i + 3], c, -l.y));
    }
#pragma unroll
    for (int i = 0; i < NP; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
    wgmma_wait<0>();                       // dP^T_j has landed
#pragma unroll
    for (int i = 0; i < NS; ++i) fence_reg(dp[i]);
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i) {
      const float2 x = *reinterpret_cast<const float2*>(dvec + 8 * i + 2 * t4);
      dp[4 * i] = s[4 * i] * (dp[4 * i] - x.x);
      dp[4 * i + 1] = s[4 * i + 1] * (dp[4 * i + 1] - x.y);
      dp[4 * i + 2] = s[4 * i + 2] * (dp[4 * i + 2] - x.x);
      dp[4 * i + 3] = s[4 * i + 3] * (dp[4 * i + 3] - x.y);
    }
#pragma unroll
    for (int i = 0; i < NP; ++i) ds[i] = pack_bf16(dp[2 * i], dp[2 * i + 1]);
    // dS^T -> shared memory: row = key, queries contiguous in 64-query
    // panels of 128-byte rows, chunk i of row r at chunk i ^ (r % 8)
    {
      unsigned char* base = reinterpret_cast<unsigned char*>(sm.ds[j & 1]);
#pragma unroll
      for (int i = 0; i < BQ / 8; ++i) {
        unsigned char* pb =
            base + (i >> 3) * (BK * 128) + (((i & 7) ^ g) << 4) + 4 * t4;
        *reinterpret_cast<uint32_t*>(pb + key_row * 128) = ds[2 * i];
        *reinterpret_cast<uint32_t*>(pb + (key_row + 8) * 128) = ds[2 * i + 1];
      }
    }
    fence_proxy_async();
    // dV += P^T dO, dK += dS^T q: q and dO as MN-major B
    const uint64_t dov = desc_sw128(sm.dout[st], 8192, 1024);
    const uint64_t qv = desc_sw128(sm.q[st], 8192, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs<64, 1>(adv, p + 4 * kk, dov + 128 * kk, 1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs<64, 1>(adk, ds + 4 * kk, qv + 128 * kk, 1);
    wgmma_commit();
    // both groups' dS^T (and, the first time, K^T) are in place
    bar_sync(DS_BAR, 256);
    // dQ = dS K over the block's 128 keys: A = dS^T (MN-major), B = K^T
    const uint64_t dsa =
        desc_sw128(sm.ds[j & 1] + dq_panel * (BK * 64), BK * 128, 1024);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_ss<DQN, 1, 0>(dq, dsa + 128 * kk,
                          ktb + (kk >> 2) * 512 + (kk & 3) * 2, kk);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      fence_reg(adk[i]);
      fence_reg(adv[i]);
    }
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      fence_reg(p[i]);
      fence_reg(ds[i]);
    }
    if (lane == 0) mbar_arrive(&sm.empty[st]);   // q and dO are read
    add_dq(j);
  }

  if (tid == 0) bulk_wait<0>();   // the adds are done with shared memory

  // dK (times scale) and dV of this group's live keys, bf16
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = kb * BK + key_row + 8 * half;
    if (key < kv_valid) {
      const long long off = b * k_bs + (long long)key * rs + h * D + 2 * t4;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        *reinterpret_cast<uint32_t*>(dk + off + 8 * i) =
            pack_bf16(adk[4 * i + 2 * half] * scale,
                      adk[4 * i + 2 * half + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * i) =
            pack_bf16(adv[4 * i + 2 * half], adv[4 * i + 2 * half + 1]);
      }
    }
  }
}

__global__ void __launch_bounds__(k3::THREADS, 1)
flash_bwd_d64_sm90(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   float* __restrict__ dqacc, const float* __restrict__ dd,
                   const float* __restrict__ lse2, int* __restrict__ sem,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                   int sq_pad, int kv_valid, long long k_bs, int rs, float c,
                   float scale) {
  using namespace k3;
  using namespace sm90;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int kb = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int nq = sq_pad / BQ;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&sm.full[st], 1);
      mbar_init(&sm.empty[st], 4 * NWG);   // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(&sm.kv_full, 2 * KTILE);
      tma_load_3d(sm.k, &tk, &sm.kv_full, h * D, kb * BK, b);
      tma_load_3d(sm.v, &tv, &sm.kv_full, h * D, kb * BK, b);
      const long long row0 = (long long)bh * sq_pad;
      for (int j = 0; j < nq; ++j) {
        const int st = j % STAGES;
        mbar_wait(&sm.empty[st], ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(&sm.full[st], 2 * QTILE + 2 * BQ * 4);
        tma_load_3d(sm.q[st], &tq, &sm.full[st], h * D, j * BQ, b);
        tma_load_3d(sm.dout[st], &tdo, &sm.full[st], h * D, j * BQ, b);
        bulk_load(sm.lse[st], lse2 + row0 + j * BQ, BQ * 4, &sm.full[st]);
        bulk_load(sm.dd[st], dd + row0 + j * BQ, BQ * 4, &sm.full[st]);
      }
    }
  } else {
    reg_alloc<CONSUMER_REGS>();
    k3_consumer(sm, wg - 1, dqacc, sem, dk, dv, bh, b, h, kb, nq, kv_valid,
                k_bs, rs, c, scale);
  }
}

// q, o, dout, dq: bf16 [B, Sq, H*64] (batch stride q_bs, row stride rs);
// k, v, dk, dv: [B, Sk, H*64] (batch stride k_bs, row stride rs); lse: fp32
// [B*H, Sq], natural; ws: the workspace, 4 * (B*H*Sq_pad*66 + B*H*nq)
// bytes with Sq_pad = nq * BQ the query rows rounded up to the query tile
// (the fp32 dQ, D, the log2 lse, the tile semaphores). Rows of dk/dv at or
// past kv_valid (clipped to Sk) are not written. The launch arithmetic is
// `k3_launch_plan` in star_tpu_torch/ops/flash_attention.py.
extern "C" int star_flash_bwd_d64(const void* q, const void* k, const void* v,
                                  const void* o, const void* dout,
                                  const void* lse, void* dq, void* dk,
                                  void* dv, void* ws, int B, int H, int Sq,
                                  int Sk, int kv_valid, long long q_bs,
                                  long long k_bs, int rs, float scale,
                                  void* stream) {
  using namespace k3;
  if (kv_valid > Sk) kv_valid = Sk;
  if (kv_valid < 1 || Sq < 1 || B < 1 || H < 1 || B * H > 65535 ||
      rs < H * D || (rs * 2) % 16 || (q_bs * 2) % 16 || (k_bs * 2) % 16)
    return (int)cudaErrorInvalidValue;
  const void* ptr[9] = {q, k, v, o, dout, dq, dk, dv, ws};
  for (int i = 0; i < 9; ++i)
    if (((uintptr_t)ptr[i]) % 16) return (int)cudaErrorInvalidValue;
  const int BH = B * H, nq = (Sq + BQ - 1) / BQ, sq_pad = nq * BQ;
  const uint64_t w = (uint64_t)H * D;
  // a runtime call before the driver's tensor-map encoder: it binds this
  // host thread to the device's context (autograd runs the backward on a
  // thread of its own, where the encoder otherwise finds none)
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_d64_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tq, tk, tv, tdo;
  if (!sm90::encode_bf16_3d(&tq, q, w, Sq, B, rs * 2, q_bs * 2, BQ) ||
      !sm90::encode_bf16_3d(&tdo, dout, w, Sq, B, rs * 2, q_bs * 2, BQ) ||
      !sm90::encode_bf16_3d(&tk, k, w, kv_valid, B, rs * 2, k_bs * 2, BK) ||
      !sm90::encode_bf16_3d(&tv, v, w, kv_valid, B, rs * 2, k_bs * 2, BK))
    return (int)cudaErrorInvalidValue;
  float* dqacc = (float*)ws;
  float* dd = dqacc + (long long)BH * sq_pad * D;
  float* lse2 = dd + (long long)BH * sq_pad;
  int* sem = (int*)(lse2 + (long long)BH * sq_pad);
  cudaStream_t st = (cudaStream_t)stream;

  const long long prep = (long long)BH * sq_pad * 8;   // a multiple of 512
  flash_bwd_prep<<<(unsigned)(prep / PREP_THREADS), PREP_THREADS, 0, st>>>(
      (const bf16*)o, (const bf16*)dout, (const float*)lse, dqacc, dd, lse2,
      sem, H, Sq, sq_pad, q_bs, rs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float c = scale * LOG2E;
  dim3 grid((kv_valid + BK - 1) / BK, BH);
  flash_bwd_d64_sm90<<<grid, THREADS, SMEM, st>>>(
      tq, tk, tv, tdo, dqacc, dd, lse2, sem, (bf16*)dk, (bf16*)dv, H, sq_pad,
      kv_valid, k_bs, rs, c, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long conv = (long long)BH * Sq * 8;
  flash_bwd_dq<<<(unsigned)((conv + PREP_THREADS - 1) / PREP_THREADS),
                 PREP_THREADS, 0, st>>>(dqacc, (bf16*)dq, H, Sq, nq, q_bs,
                                        rs, conv, scale);
  return (int)cudaGetLastError();
}
