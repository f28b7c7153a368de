// Flash-attention backward for Hopper (sm_90a): K3 of the port.
//
// Replaces the Pallas recompute backward of star_tpu/ops/flash_attention.py
// (`_flash_bwd_kernel` via `_flash_bwd`), the gradient of the training
// forward that saves the softmax statistic (K2's `with_l` mode;
// csrc/flash_fwd.cu writes the natural log-sum-exp `lse` [B*H, Sq]).
// d=64 heads are read in place from the natural [B, S, H*64] layout of the
// projections (row stride rs, head offset h*64), as the forward reads them.
//
// With P = exp(scale*q k^T - lse), D = rowsum(dO o) (computed by the
// caller, as the JAX package computes it outside its Pallas body):
//   dS = P (dO v^T - D),  dV = P^T dO,  dK = scale dS^T q,  dQ = scale dS k.
// P and dS are rounded to bf16 before the three products, as the Pallas
// kernel rounds them; every product accumulates in fp32, and dq/dk/dv are
// stored in bf16.
//
// What bounds it on the H100: tensor-core operations (10*S^2*d FLOPs per
// head for the gradient; these two passes do 14, see below) against a few
// bytes per token; the [S, S] logits never reach device memory.
//
// Design: two deterministic passes, each FlashAttention-2 style on
// mma.sync m16n8k16 with ldmatrix fragment loads and cp.async double
// buffering (the style of csrc/flash_fwd.cu); no atomics.
//  * `flash_bwd_dkdv_kernel`: one block per (batch*head, 64-key tile); each
//    of its 4 warps keeps 16 keys of K and V as A fragments in registers
//    and loops over the query tiles, computing S^T = K q^T and
//    dP^T = V dO^T in registers. Their accumulator layout is the A layout
//    of the next products, so P^T and dS^T never leave registers:
//    dV += P^T dO and dK += dS^T q accumulate in registers over the whole
//    query loop.
//  * `flash_bwd_dq_kernel`: one block per (batch*head, 64-query tile);
//    each warp keeps 16 rows of q and dO in registers and loops over the
//    key tiles: S = q K^T, dP = dO V^T, then dQ += dS K.
// The second pass recomputes S and dP (4 of the 14 S^2 d FLOPs) in place of
// atomic dQ adds across key tiles. Dead keys (>= kv_valid) are never loaded
// by the dQ pass and masked in its last tile; their dK/dV rows are not
// stored. Ragged query rows load as zeros (q, dO, lse and D), which gives
// them dS = 0 and a zero contribution to dV.
// Not yet used: wgmma, TMA, warp specialisation — later work for speed.

#include <math.h>

#include "mma_sm80.cuh"

using fa2::bf16;

namespace fb {
constexpr int D = 64, BQ = 64, BK = 64, THREADS = 128;
constexpr int DP = D + 8;  // 144-byte rows: an ldmatrix hits 8 bank groups
constexpr int TILE = 64 * DP;                       // one [64][DP] tile
constexpr int SMEM_DKDV = 6 * TILE * 2 + 4 * BQ * 4;  // K, V, 2x q, 2x dO,
                                                      // 2x lse, 2x D
constexpr int SMEM_DQ = 6 * TILE * 2;               // q, dO, 2x K, 2x V
constexpr float LOG2E = 1.4426950408889634f;
}  // namespace fb

__global__ void __launch_bounds__(fb::THREADS)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dvec, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int H, int Sq, int kv_valid,
                      long long q_bs, long long k_bs, int rs, float scale) {
  using namespace fa2;
  using namespace fb;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // [BK][DP]
  bf16* sV = sK + TILE;                            // [BK][DP]
  bf16* sQ = sV + TILE;                            // [2][BQ][DP]
  bf16* sO = sQ + 2 * TILE;                        // [2][BQ][DP] (dO)
  float* sL = reinterpret_cast<float*>(sO + 2 * TILE);  // [2][BQ] lse
  float* sD = sL + 2 * BQ;                               // [2][BQ] D

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;       // mma fragment row / pair
  const int lm = lane >> 3, lr = lane & 7;      // ldmatrix matrix / row
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.x * BK;
  const float c = scale * LOG2E;
  const bf16* qb = q + b * q_bs + (long long)h * D;
  const bf16* ob = dout + b * q_bs + (long long)h * D;
  const bf16* kb = k + b * k_bs + (long long)h * D;
  const bf16* vb = v + b * k_bs + (long long)h * D;
  const float* lb = lse + (long long)bh * Sq;
  const float* db = dvec + (long long)bh * Sq;

  for (int i = tid; i < BK * 8; i += THREADS) {
    const int r = i >> 3, cv = (i & 7) * 8;
    const bool ok = k0 + r < kv_valid;
    const long long row = ok ? k0 + r : 0;
    cp16(sK + r * DP + cv, kb + row * rs + cv, ok);
    cp16(sV + r * DP + cv, vb + row * rs + cv, ok);
  }
  auto load_q = [&](int stage, int q0) {
    bf16* tq = sQ + stage * TILE;
    bf16* to = sO + stage * TILE;
    for (int i = tid; i < BQ * 8; i += THREADS) {
      const int r = i >> 3, cv = (i & 7) * 8;
      const bool ok = q0 + r < Sq;
      const long long row = ok ? q0 + r : 0;
      cp16(tq + r * DP + cv, qb + row * rs + cv, ok);
      cp16(to + r * DP + cv, ob + row * rs + cv, ok);
    }
    if (tid < BQ) {
      const bool ok = q0 + tid < Sq;
      const long long row = ok ? q0 + tid : 0;
      cp4(sL + stage * BQ + tid, lb + row, ok);
      cp4(sD + stage * BQ + tid, db + row, ok);
    }
  };
  const int n_tiles = (Sq + BQ - 1) / BQ;
  load_q(0, 0);
  cp_commit();                 // K, V and the first q/dO tile

  uint32_t kf[4][4], vf[4][4];  // this warp's 16 keys of K and V
  float adk[8][4], adv[8][4];   // dK, dV: 8 blocks of 8 head dims
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[i][e] = adv[i][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load_q((j + 1) & 1, (j + 1) * BQ);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int off = (warp * 16 + lr + (lm & 1) * 8) * DP + kk * 16 +
                        (lm >> 1) * 8;
        ldsm_x4(kf[kk], sK + off);
        ldsm_x4(vf[kk], sV + off);
      }
    }
    const bf16* cQ = sQ + (j & 1) * TILE;
    const bf16* cO = sO + (j & 1) * TILE;
    const float* cL = sL + (j & 1) * BQ;
    const float* cD = sD + (j & 1) * BQ;

    // S^T = K q^T and dP^T = V dO^T: 16 keys x 64 queries per warp
    float st[8][4], dpt[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[i][e] = dpt[i][e] = 0.f;
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int off = (nb * 16 + lr + (lm >> 1) * 8) * DP + kk * 16 +
                        (lm & 1) * 8;
        uint32_t bq[4], bo[4];
        ldsm_x4(bq, cQ + off);
        ldsm_x4(bo, cO + off);
        mma(st[2 * nb], kf[kk], bq[0], bq[1]);
        mma(st[2 * nb + 1], kf[kk], bq[2], bq[3]);
        mma(dpt[2 * nb], vf[kk], bo[0], bo[1]);
        mma(dpt[2 * nb + 1], vf[kk], bo[2], bo[3]);
      }
    }
    // P^T and dS^T in place; the column of an element is its query
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = i * 8 + 2 * t4 + (e & 1);
        const float p = exp2f(st[i][e] * c - cL[col] * LOG2E);
        st[i][e] = p;
        dpt[i][e] = p * (dpt[i][e] - cD[col]);
      }
    }
    // dV += P^T dO and dK += dS^T q, with bf16 P^T and dS^T as A fragments
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(st[2 * kk][0], st[2 * kk][1]),
                              pack_bf16(st[2 * kk][2], st[2 * kk][3]),
                              pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                              pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
      const uint32_t sa[4] = {
          pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
          pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
          pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
          pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        const int off = (kk * 16 + lr + (lm & 1) * 8) * DP + dp * 16 +
                        (lm >> 1) * 8;
        uint32_t bo[4], bq[4];
        ldsm_x4_t(bo, cO + off);
        ldsm_x4_t(bq, cQ + off);
        mma(adv[2 * dp], pa, bo[0], bo[1]);
        mma(adv[2 * dp + 1], pa, bo[2], bo[3]);
        mma(adk[2 * dp], sa, bq[0], bq[1]);
        mma(adk[2 * dp + 1], sa, bq[2], bq[3]);
      }
    }
    __syncthreads();   // this stage is refilled two iterations on
  }
  cp_wait<0>();

  const int r0 = k0 + warp * 16 + g, r1 = r0 + 8;
  bf16* dkb = dk + b * k_bs + (long long)h * D;
  bf16* dvb = dv + b * k_bs + (long long)h * D;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = i * 8 + 2 * t4;
    if (r0 < kv_valid) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (long long)r0 * rs + col) =
          __floats2bfloat162_rn(adk[i][0] * scale, adk[i][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (long long)r0 * rs + col) =
          __floats2bfloat162_rn(adv[i][0], adv[i][1]);
    }
    if (r1 < kv_valid) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (long long)r1 * rs + col) =
          __floats2bfloat162_rn(adk[i][2] * scale, adk[i][3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (long long)r1 * rs + col) =
          __floats2bfloat162_rn(adv[i][2], adv[i][3]);
    }
  }
}

__global__ void __launch_bounds__(fb::THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dvec, bf16* __restrict__ dq,
                    int H, int Sq, int kv_valid, long long q_bs,
                    long long k_bs, int rs, float scale) {
  using namespace fa2;
  using namespace fb;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [BQ][DP]
  bf16* sO = sQ + TILE;                            // [BQ][DP] (dO)
  bf16* sK = sO + TILE;                            // [2][BK][DP]
  bf16* sV = sK + 2 * TILE;                        // [2][BK][DP]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * BQ;
  const float c = scale * LOG2E;
  const bf16* qb = q + b * q_bs + (long long)h * D;
  const bf16* ob = dout + b * q_bs + (long long)h * D;
  const bf16* kb = k + b * k_bs + (long long)h * D;
  const bf16* vb = v + b * k_bs + (long long)h * D;

  for (int i = tid; i < BQ * 8; i += THREADS) {
    const int r = i >> 3, cv = (i & 7) * 8;
    const bool ok = q0 + r < Sq;
    const long long row = ok ? q0 + r : 0;
    cp16(sQ + r * DP + cv, qb + row * rs + cv, ok);
    cp16(sO + r * DP + cv, ob + row * rs + cv, ok);
  }
  auto load_kv = [&](int stage, int k0) {
    bf16* tk = sK + stage * TILE;
    bf16* tv = sV + stage * TILE;
    for (int i = tid; i < BK * 8; i += THREADS) {
      const int r = i >> 3, cv = (i & 7) * 8;
      const bool ok = k0 + r < kv_valid;
      const long long row = ok ? k0 + r : 0;
      cp16(tk + r * DP + cv, kb + row * rs + cv, ok);
      cp16(tv + r * DP + cv, vb + row * rs + cv, ok);
    }
  };
  const int n_tiles = (kv_valid + BK - 1) / BK;
  load_kv(0, 0);
  cp_commit();                 // q, dO and the first K/V tile

  // log2-domain lse and D of this thread's rows g and g+8; ragged rows 0
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const float* lb = lse + (long long)bh * Sq;
  const float* db = dvec + (long long)bh * Sq;
  const float L0 = r0 < Sq ? lb[r0] * LOG2E : 0.f;
  const float L1 = r1 < Sq ? lb[r1] * LOG2E : 0.f;
  const float D0 = r0 < Sq ? db[r0] : 0.f;
  const float D1 = r1 < Sq ? db[r1] : 0.f;

  uint32_t qf[4][4], of[4][4];  // this warp's 16 rows of q and dO
  float adq[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[i][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load_kv((j + 1) & 1, (j + 1) * BK);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int off = (warp * 16 + lr + (lm & 1) * 8) * DP + kk * 16 +
                        (lm >> 1) * 8;
        ldsm_x4(qf[kk], sQ + off);
        ldsm_x4(of[kk], sO + off);
      }
    }
    const bf16* cK = sK + (j & 1) * TILE;
    const bf16* cV = sV + (j & 1) * TILE;

    float s[8][4], dp[8][4];     // S and dP: 16 rows x 64 keys
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int off = (nb * 16 + lr + (lm >> 1) * 8) * DP + kk * 16 +
                        (lm & 1) * 8;
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, cK + off);
        ldsm_x4(bv, cV + off);
        mma(s[2 * nb], qf[kk], bk[0], bk[1]);
        mma(s[2 * nb + 1], qf[kk], bk[2], bk[3]);
        mma(dp[2 * nb], of[kk], bv[0], bv[1]);
        mma(dp[2 * nb + 1], of[kk], bv[2], bv[3]);
      }
    }
    const int k0 = j * BK;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + i * 8 + 2 * t4 + (e & 1);
        const float p =
            key < kv_valid ? exp2f(s[i][e] * c - (e < 2 ? L0 : L1)) : 0.f;
        s[i][e] = p * (dp[i][e] - (e < 2 ? D0 : D1));   // dS
      }
    }
    // dQ += dS K, with bf16 dS as the A fragment and K read transposed
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t sa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dpb = 0; dpb < 4; ++dpb) {
        uint32_t bk[4];
        ldsm_x4_t(bk, cK + (kk * 16 + lr + (lm & 1) * 8) * DP + dpb * 16 +
                          (lm >> 1) * 8);
        mma(adq[2 * dpb], sa, bk[0], bk[1]);
        mma(adq[2 * dpb + 1], sa, bk[2], bk[3]);
      }
    }
    __syncthreads();   // this stage is refilled two iterations on
  }
  cp_wait<0>();

  bf16* dqb = dq + b * q_bs + (long long)h * D;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = i * 8 + 2 * t4;
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (long long)r0 * rs + col) =
          __floats2bfloat162_rn(adq[i][0] * scale, adq[i][1] * scale);
    if (r1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (long long)r1 * rs + col) =
          __floats2bfloat162_rn(adq[i][2] * scale, adq[i][3] * scale);
  }
}

// q, dout, dq: [B, Sq, rs] rows (batch stride q_bs); k, v, dk, dv: [B, Sk,
// rs] rows (batch stride k_bs); head h at column h*64. lse (natural) and
// dvec = rowsum(dO o): fp32 [B*H, Sq]. Only key rows < kv_valid of dk/dv
// are written. scale: the natural softmax scale (ln 2 for a prescaled q).
extern "C" int star_flash_bwd_d64(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* dvec, void* dq, void* dk,
                                  void* dv, int B, int H, int Sq, int Sk,
                                  int kv_valid, long long q_bs,
                                  long long k_bs, int rs, float scale,
                                  void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      fb::SMEM_DKDV);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             fb::SMEM_DQ);
  if (err != cudaSuccess) return (int)err;
  if (kv_valid > Sk) kv_valid = Sk;
  cudaStream_t st = (cudaStream_t)stream;
  if (kv_valid > 0) {
    dim3 grid_kv((kv_valid + fb::BK - 1) / fb::BK, B * H);
    flash_bwd_dkdv_kernel<<<grid_kv, fb::THREADS, fb::SMEM_DKDV, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
        (const float*)lse, (const float*)dvec, (bf16*)dk, (bf16*)dv, H, Sq,
        kv_valid, q_bs, k_bs, rs, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid_q((Sq + fb::BQ - 1) / fb::BQ, B * H);
  flash_bwd_dq_kernel<<<grid_q, fb::THREADS, fb::SMEM_DQ, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)dvec, (bf16*)dq, H, Sq, kv_valid, q_bs,
      k_bs, rs, scale);
  return (int)cudaGetLastError();
}
