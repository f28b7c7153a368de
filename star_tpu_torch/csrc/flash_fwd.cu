// Flash-attention forward at d=512 for Hopper (sm_90a): K2 of the port.
//
// Replaces the Pallas kernel `_flash_kernel` of
// star_tpu/ops/flash_attention.py (via `_flash_fwd` / `flash_attention`),
// forward only: the SVD-VAE mid attention, one head of d=512 over
// [B, S, 1, 512]. (The d=64 forward, K1 and K2's `with_l` mode, is
// csrc/flash_fwd_sm90.cu.)
//
// Softmax: max-subtracted online softmax in fp32 (log2 domain: the logits
// are multiplied by c = scale*log2(e)). The Pallas kernel's fixed-reference
// exp2(min(s,120)) with no row max is a TPU shortcut; the port computes the
// true softmax.
//
// What bounds it on the H100: tensor-core operations. At the VAE's 14400
// tokens the logits are 14400x14400 per frame, 4*S^2*d FLOPs against
// 4*S*d*2 bytes, far above the card's 295 FLOP/byte balance. The [S, S]
// logits never reach device memory. Dead key rows (>= kv_valid) are
// skipped whole-tile and masked in the last tile; ragged query rows are
// zero-filled on load and not stored.
//
// FlashAttention-2 style on mma.sync m16n8k16 (bf16 in, fp32 accumulate)
// with fragments loaded by ldmatrix and K/V tiles streamed through shared
// memory in two cp.async stages. A 16x512 fp32 accumulator does not fit in
// one warp's registers, so four warps share 16 query rows with 128 head
// dims each, and sum their partial S tiles through shared memory before
// the softmax. The S accumulator's layout equals the A-operand layout of
// the P V product, so P never leaves registers.

#include <math.h>

#include "mma_sm80.cuh"

using fa2::bf16;

// ---------------------------------------------------------------------------
// d=512: the same register-resident scheme with the head dims split across
// warps. A warp's 16x512 fp32 accumulator would need 256 registers a
// thread, so four warps share 16 query rows, each owning 128 head dims of
// Q and of O; their partial S = Q K^T tiles are summed through shared
// memory, and each warp runs the (identical) softmax and its slice of
// O += P V. Two such groups of four make a block of 32 query rows.

namespace fa2_512 {
constexpr int D = 512, BQ = 32, BK = 32, THREADS = 256, SLICE = 128;
constexpr int DP = D + 8;  // 1040-byte rows: an ldmatrix hits 8 bank groups
constexpr int SMEM = (BQ + 4 * BK) * DP * 2     // Q + 2 stages of K and V
                     + 8 * 16 * 32 * 4;         // partial S of each warp
}  // namespace fa2_512

__global__ void __launch_bounds__(fa2_512::THREADS)
flash_fwd_d512_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o, int H,
                      int Sq, int kv_valid, long long q_bs, long long k_bs,
                      long long v_bs, long long o_bs, int q_rs, int k_rs,
                      int v_rs, int o_rs, float c) {
  using namespace fa2;
  using fa2_512::BK;
  using fa2_512::BQ;
  using fa2_512::D;
  using fa2_512::DP;
  using fa2_512::SLICE;
  using fa2_512::THREADS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [BQ][DP]
  bf16* sK = sQ + BQ * DP;                         // [2][BK][DP]
  bf16* sV = sK + 2 * BK * DP;                     // [2][BK][DP]
  float* sS = reinterpret_cast<float*>(sV + 2 * BK * DP);  // [8][16][32]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = warp >> 2, ds = warp & 3;      // row group, head-dim slice
  const int g = lane >> 2, t4 = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * BQ;
  const bf16* qb = q + b * q_bs + (long long)h * D;
  const bf16* kb = k + b * k_bs + (long long)h * D;
  const bf16* vb = v + b * v_bs + (long long)h * D;
  bf16* ob = o + b * o_bs + (long long)h * D;

  for (int i = tid; i < BQ * (D / 8); i += THREADS) {
    const int r = i / (D / 8), cv = (i % (D / 8)) * 8;
    const bool ok = q0 + r < Sq;
    cp16(sQ + r * DP + cv, qb + (long long)(ok ? q0 + r : 0) * q_rs + cv, ok);
  }
  auto load_kv = [&](int stage, int k0) {
    bf16* dk = sK + stage * BK * DP;
    bf16* dv = sV + stage * BK * DP;
    for (int i = tid; i < BK * (D / 8); i += THREADS) {
      const int r = i / (D / 8), cv = (i % (D / 8)) * 8;
      const bool ok = k0 + r < kv_valid;
      const long long row = ok ? k0 + r : 0;
      cp16(dk + r * DP + cv, kb + row * k_rs + cv, ok);
      cp16(dv + r * DP + cv, vb + row * v_rs + cv, ok);
    }
  };
  const int n_tiles = (kv_valid + BK - 1) / BK;
  load_kv(0, 0);
  cp_commit();

  uint32_t qf[8][4];           // this warp's 128 head dims of Q
  float acc[16][4];            // this warp's 128 head dims of O
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const int d0 = ds * SLICE;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load_kv((j + 1) & 1, (j + 1) * BK);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        ldsm_x4(qf[kk], sQ + (rg * 16 + lr + (lm & 1) * 8) * DP + d0 +
                            kk * 16 + (lm >> 1) * 8);
    }
    const bf16* cK = sK + (j & 1) * BK * DP;
    const bf16* cV = sV + (j & 1) * BK * DP;

    // partial S over this warp's head dims, 4 blocks of 8 keys
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        uint32_t bk[4];
        ldsm_x4(bk, cK + (nb * 16 + lr + (lm >> 1) * 8) * DP + d0 + kk * 16 +
                        (lm & 1) * 8);
        mma(s[2 * nb], qf[kk], bk[0], bk[1]);
        mma(s[2 * nb + 1], qf[kk], bk[2], bk[3]);
      }
    }
    // sum the four slices' partials (same fragment layout in every warp)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sS[(warp * 16 + i * 4 + e) * 32 + lane] = s[i][e];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float t = 0.f;
#pragma unroll
        for (int w = 0; w < 4; ++w)
          t += sS[((rg * 4 + w) * 16 + i * 4 + e) * 32 + lane];
        s[i][e] = t;
      }

    const int k0 = j * BK;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + i * 8 + 2 * t4 + (e & 1);
        s[i][e] = key < kv_valid ? s[i][e] * c : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[i][0], s[i][1]));
      mx1 = fmaxf(mx1, fmaxf(s[i][2], s[i][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - n0), a1 = exp2f(m1 - n1);
    m0 = n0;
    m1 = n1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[i][0] = exp2f(s[i][0] - n0);
      s[i][1] = exp2f(s[i][1] - n0);
      s[i][2] = exp2f(s[i][2] - n1);
      s[i][3] = exp2f(s[i][3] - n1);
      sum0 += s[i][0] + s[i][1];
      sum1 += s[i][2] + s[i][3];
    }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      acc[i][0] *= a0;
      acc[i][1] *= a0;
      acc[i][2] *= a1;
      acc[i][3] *= a1;
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < 8; ++dp) {
        uint32_t bv[4];
        ldsm_x4_t(bv, cV + (kk * 16 + lr + (lm & 1) * 8) * DP + d0 +
                          dp * 16 + (lm >> 1) * 8);
        mma(acc[2 * dp], pa, bv[0], bv[1]);
        mma(acc[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();   // stage and partial-S buffers are rewritten next
  }
  cp_wait<0>();

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
  const int r0 = q0 + rg * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int col = d0 + i * 8 + 2 * t4;
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r0 * o_rs + col) =
          __floats2bfloat162_rn(acc[i][0] * i0, acc[i][1] * i0);
    if (r1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r1 * o_rs + col) =
          __floats2bfloat162_rn(acc[i][2] * i1, acc[i][3] * i1);
  }
}

extern "C" int star_flash_fwd_d512(const void* q, const void* k,
                                   const void* v, void* o, int B, int H,
                                   int Sq, int Sk, int kv_valid,
                                   long long q_bs, long long k_bs,
                                   long long v_bs, long long o_bs, int q_rs,
                                   int k_rs, int v_rs, int o_rs, float c,
                                   void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_d512_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      fa2_512::SMEM);
  if (err != cudaSuccess) return (int)err;
  if (kv_valid > Sk) kv_valid = Sk;
  dim3 grid((Sq + fa2_512::BQ - 1) / fa2_512::BQ, B * H);
  flash_fwd_d512_kernel<<<grid, fa2_512::THREADS, fa2_512::SMEM,
                          (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, H, Sq,
      kv_valid, q_bs, k_bs, v_bs, o_bs, q_rs, k_rs, v_rs, o_rs, c);
  return (int)cudaGetLastError();
}
