// Flash-attention forward at d=64 for Hopper (sm_90a) on wgmma + TMA: K1
// and K2's `with_l` mode of the port.
//
// Replaces the Pallas kernels of star_tpu/ops/flash_attention.py:
//   K1 `_flash_packed_kernel` (via `_packed_fwd_impl`, :419): d=64 heads
//      read in place from the natural [B, S, H*64] projection output (row
//      stride H*64, head h at column h*64): no head transpose.
//   K2 `with_l` (`_flash_fwd(..., with_l=True)`, :256, the training forward
//      of `_fwd`): the same kernel with an optional fp32 output `lse`
//      [B*H, Sq], the natural log-sum-exp m + log l of each row's
//      max-subtracted softmax, which K3 (csrc/flash_bwd_sm90.cu) reads. A null
//      `lse` is the inference path.
// The softmax is the max-subtracted online softmax in fp32, in the log2
// domain (logits times c = scale*log2(e), or 1 for a prescaled q); keys at
// or past kv_valid get no weight; the output is bf16.
//
// What bounds it on the H100: tensor-core operations, and at d=64 equally
// the exponentials. Each logit costs 2*64 FLOPs in Q K^T and 2*64 in P V
// and one exp2: at 989 TFLOP/s that is 3.9e12 logits a second, and the
// SFUs give about 16 exp2 a clock per SM, 132 * 16 * ~1.8 GHz = 3.8e12 a
// second. A kernel that runs the softmax and the products one after the
// other cannot pass about half the tensor bound, so the design overlaps
// them:
//
// - Warp specialisation. A block is 3 warpgroups: warpgroup 0 is the
//   producer (one thread issues every TMA load; setmaxnreg gives its
//   registers to the others), warpgroups 1 and 2 are consumers that own
//   64 query rows each (BQ = 128) and only compute.
// - TMA. Q once per block, K and V tiles of BK = 128 keys through a ring
//   of STAGES stages, each with full/empty mbarriers (K and V apart, so a
//   K stage is refilled while its V is still being read). A d=64 bf16 row
//   is 128 bytes, so every tile lands under the 128-byte swizzle that the
//   wgmma descriptors name. The tensor maps are 3-D over the natural
//   layout, {H*64, S, B} with boxes {64, rows, 1} at x = h*64; the K/V
//   maps end at kv_valid, so key tiles wholly past it are never loaded
//   and the rows of the one tile that holds it read as zero (and are
//   masked). Query rows past Sq read as zero and the TMA store of O clips
//   them.
// - Products. S = Q K^T is wgmma m64n128k16 from shared memory (4 k-steps
//   of 16 over d); O += P V is wgmma m64n64k16 with P from registers: the
//   fp32 S accumulator packs pairwise into the bf16 A-fragment layout, so
//   P never leaves registers; V is the MN-major B operand (transpose bit).
// - Overlap inside a warpgroup: S_{j+1} = Q K_{j+1}^T is issued, then
//   O += P_j V_j, both committed as separate groups; the softmax of
//   S_{j+1} runs while P_j V_j is still on the tensor cores, and O is
//   rescaled only after that product has retired.
// - Overlap across the two warpgroups: they take turns issuing their
//   products (two named barriers, a ping-pong), so one warpgroup's
//   softmax runs while the other's products occupy the tensor cores.
// Measured (chip_variants.py, H100 SXM): about 465 TFLOP/s; replacing the
// exp2s by an FMA gains 3-7% and loading each K/V stage once at most 1%,
// so what remains is the softmax's other instructions and the turns.
// Three stages beat two by 5-7%; a polynomial exp2 on the FMA pipe for
// part of the logits and a third consumer warpgroup (ptxas then caps the
// kernel at 128 registers and spills) were slower.

#include <math.h>

#include "sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace k1 {
constexpr int NWG = 2;                   // consumer warpgroups, 64 rows each
constexpr int D = 64, BQ = 64 * NWG, BK = 128, STAGES = 3;
constexpr int THREADS = 128 * (NWG + 1); // + the producer warpgroup
// registers a thread after setmaxnreg: the producer's go to the consumers
// (NWG * 128 * CONSUMER_REGS + 128 * PRODUCER_REGS <= 65536)
constexpr int PRODUCER_REGS = NWG == 2 ? 40 : 32;
constexpr int CONSUMER_REGS = NWG == 2 ? 232 : 160;
constexpr int TILE = BK * D * 2;         // bytes of a K or V tile
constexpr int QTILE = BQ * D * 2;        // bytes of the Q tile
constexpr int SCHED = 1, EPI = 1 + NWG;  // named barrier ids (0: syncthreads)
constexpr float LN2 = 0.6931471805599453f;

struct Smem {                            // every tile 1024-byte aligned
  bf16 q[BQ * D];
  bf16 k[STAGES][BK * D];
  bf16 v[STAGES][BK * D];
  uint64_t q_full;
  uint64_t k_full[STAGES], k_empty[STAGES];
  uint64_t v_full[STAGES], v_empty[STAGES];
};
constexpr int SMEM = sizeof(Smem) + 1024;  // + room to align the base
}  // namespace k1

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One consumer warpgroup: 64 query rows against every live key tile.
// Accumulator layout (wgmma m64nN): warp w of the group holds rows
// 16w + g and 16w + g + 8 (g = lane / 4); register 4i + e holds column
// 8i + 2*(lane % 4) + (e & 1) of row g (e < 2) or g + 8 (e >= 2).
__device__ __forceinline__ void k1_consumer(k1::Smem& sm, int wg,
                                            const CUtensorMap* to,
                                            float* __restrict__ lse, int bh,
                                            int b, int h, int q0, int Sq,
                                            int kv_valid, float c) {
  using namespace k1;
  using namespace sm90;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int n = (kv_valid + BK - 1) / BK;          // live key tiles, >= 1
  const bool ragged = (kv_valid % BK) != 0;
  const int me = SCHED + wg, next = SCHED + (wg + 1) % NWG;

  float s[64];        // S tile: 64 rows x 128 keys
  float o[32];        // O: 64 rows x 64 dims
  uint32_t p[32];     // P in bf16, the A fragments of 8 k-steps
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;   // running max (scaled, log2)
  float l0 = 0.f, l1 = 0.f;               // this thread's share of the sums

  const uint64_t dq = desc_sw128(sm.q + wg * 64 * D, 16, 1024);
  auto issue_s = [&](int st) {            // s = Q K^T
    const uint64_t dk = desc_sw128(sm.k[st], 16, 1024);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<128, 0, 0>(s, dq + 2 * kk, dk + 2 * kk, kk);
    wgmma_commit();
  };
  auto issue_o = [&](int st) {            // o += P V
    const uint64_t dv = desc_sw128(sm.v[st], 8192, 1024);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_rs<64, 1>(o, p + 4 * kk, dv + 128 * kk, 1);
    wgmma_commit();
  };
  // online softmax of tile j in place: s becomes P (fp32); returns the
  // factors that rescale the earlier O and l of rows g and g + 8
  auto softmax = [&](int j, float& a0, float& a1) {
    if (ragged && j == n - 1) {
      const int k0 = j * BK + 2 * t4;
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * i + (e & 1) >= kv_valid) s[4 * i + e] = -INFINITY;
    }
    float mx0 = s[0], mx1 = s[2];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // c > 0, so max(s) * c is the max of the scaled logits; the first key
    // of every live tile is live, so both maxima are finite
    const float n0 = fmaxf(m0, mx0 * c), n1 = fmaxf(m1, mx1 * c);
    a0 = ex2(m0 - n0);
    a1 = ex2(m1 - n1);
    m0 = n0;
    m1 = n1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      s[4 * i] = ex2(fmaf(s[4 * i], c, -n0));
      s[4 * i + 1] = ex2(fmaf(s[4 * i + 1], c, -n0));
      s[4 * i + 2] = ex2(fmaf(s[4 * i + 2], c, -n1));
      s[4 * i + 3] = ex2(fmaf(s[4 * i + 3], c, -n1));
      sum0 += s[4 * i] + s[4 * i + 1];
      sum1 += s[4 * i + 2] + s[4 * i + 3];
    }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
  };
  // P's A fragment of k-step kk is S key blocks 2kk and 2kk + 1
  auto pack_p = [&]() {
#pragma unroll
    for (int i = 0; i < 32; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
  };
  auto fence_s = [&]() {
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_reg(s[i]);
  };
  auto fence_op = [&]() {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      fence_reg(o[i]);
      fence_reg(p[i]);
    }
  };

  // Turns: turn 0 issues S_0; turn j (1 <= j < n) issues S_j and P_{j-1}
  // V_{j-1}; turn n issues P_{n-1} V_{n-1}. The groups take their turns in
  // a ring, group 0 first; after each turn a group hands the next to the
  // next group, except the last group after its last turn (so every
  // arrival is waited on).
  if (wg == NWG - 1) bar_arrive(SCHED, 256);
  mbar_wait(&sm.q_full, 0);
  float a0, a1;
  mbar_wait(&sm.k_full[0], 0);
  bar_sync(me, 256);
  wgmma_fence();
  issue_s(0);
  bar_arrive(next, 256);
  wgmma_wait<0>();
  fence_s();
  if (lane == 0) mbar_arrive(&sm.k_empty[0]);
  softmax(0, a0, a1);
  pack_p();

  for (int j = 1; j < n; ++j) {
    const int st = j % STAGES, pst = (j - 1) % STAGES;
    mbar_wait(&sm.k_full[st], (j / STAGES) & 1);
    mbar_wait(&sm.v_full[pst], ((j - 1) / STAGES) & 1);
    bar_sync(me, 256);
    fence_op();
    wgmma_fence();
    issue_s(st);
    issue_o(pst);
    bar_arrive(next, 256);
    wgmma_wait<1>();                       // S_j has landed
    fence_s();
    if (lane == 0) mbar_arrive(&sm.k_empty[st]);
    softmax(j, a0, a1);
    wgmma_wait<0>();                       // P_{j-1} V_{j-1} has retired
    fence_op();
    if (lane == 0) mbar_arrive(&sm.v_empty[pst]);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      o[4 * i] *= a0;
      o[4 * i + 1] *= a0;
      o[4 * i + 2] *= a1;
      o[4 * i + 3] *= a1;
    }
    pack_p();
  }
  {
    const int pst = (n - 1) % STAGES;
    mbar_wait(&sm.v_full[pst], ((n - 1) / STAGES) & 1);
    bar_sync(me, 256);
    fence_op();
    wgmma_fence();
    issue_o(pst);
    if (wg != NWG - 1) bar_arrive(next, 256);
    wgmma_wait<0>();
    fence_op();
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float i0 = 1.f / l0, i1 = 1.f / l1;       // l >= 1: the max's term
  const int r = warp * 16 + g;                     // row in this group
  const int row0 = q0 + wg * 64 + r;
  if (lse != nullptr && t4 == 0) {
    // ln(sum exp(scale*qk)) = (m + log2 l) * ln2 in the log2 domain here
    float* lb = lse + (long long)bh * Sq;
    if (row0 < Sq) lb[row0] = (m0 + log2f(l0)) * LN2;
    if (row0 + 8 < Sq) lb[row0 + 8] = (m1 + log2f(l1)) * LN2;
  }
  // O through this group's (finished) Q rows, under the 128-byte swizzle:
  // the 16-byte chunk i of row r sits at chunk i ^ (r % 8)
  unsigned char* ob = reinterpret_cast<unsigned char*>(sm.q + wg * 64 * D);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int off = ((i ^ (r & 7)) << 4) + 4 * t4;
    *reinterpret_cast<uint32_t*>(ob + r * 128 + off) =
        pack_bf16(o[4 * i] * i0, o[4 * i + 1] * i0);
    *reinterpret_cast<uint32_t*>(ob + (r + 8) * 128 + off) =
        pack_bf16(o[4 * i + 2] * i1, o[4 * i + 3] * i1);
  }
  fence_proxy_async();
  bar_sync(EPI + wg, 128);
  if (tid == 0 && q0 + wg * 64 < Sq) {
    tma_store_3d(to, ob, h * D, q0 + wg * 64, b);
    bulk_wait_read<0>();
  }
}

__global__ void __launch_bounds__(k1::THREADS, 1)
flash_fwd_d64_sm90(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap to,
                   float* __restrict__ lse, int H, int Sq, int kv_valid,
                   float c) {
  using namespace k1;
  using namespace sm90;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * BQ;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&sm.k_full[st], 1);
      mbar_init(&sm.v_full[st], 1);
      mbar_init(&sm.k_empty[st], 4 * NWG);  // lane 0 of each consumer warp
      mbar_init(&sm.v_empty[st], 4 * NWG);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      const int n = (kv_valid + BK - 1) / BK;
      mbar_expect_tx(&sm.q_full, QTILE);
      tma_load_3d(sm.q, &tq, &sm.q_full, h * D, q0, b);
      for (int j = 0; j < n; ++j) {
        const int st = j % STAGES;
        const uint32_t free_parity = ((j / STAGES) & 1) ^ 1;
        mbar_wait(&sm.k_empty[st], free_parity);
        mbar_expect_tx(&sm.k_full[st], TILE);
        tma_load_3d(sm.k[st], &tk, &sm.k_full[st], h * D, j * BK, b);
        mbar_wait(&sm.v_empty[st], free_parity);
        mbar_expect_tx(&sm.v_full[st], TILE);
        tma_load_3d(sm.v[st], &tv, &sm.v_full[st], h * D, j * BK, b);
      }
    }
  } else {
    reg_alloc<CONSUMER_REGS>();
    k1_consumer(sm, wg - 1, &to, lse, bh, b, h, q0, Sq, kv_valid, c);
  }
}

// q, k, v, o: bf16 with head h at column h*64 of rows of stride q_rs ...
// (elements) and batch strides q_bs ...; lse: null, or fp32 [B*H, Sq] for
// the natural log-sum-exp of each row. Keys at or past kv_valid (clipped
// to Sk, at least 1) get no weight. The launch arithmetic is
// `k1_launch_plan` in star_tpu_torch/ops/flash_attention.py.
extern "C" int star_flash_fwd_d64(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int B, int H, int Sq,
                                  int Sk, int kv_valid, long long q_bs,
                                  long long k_bs, long long v_bs,
                                  long long o_bs, int q_rs, int k_rs, int v_rs,
                                  int o_rs, float c, void* stream) {
  using namespace k1;
  if (kv_valid > Sk) kv_valid = Sk;
  if (kv_valid < 1 || Sq < 1 || B < 1 || H < 1 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const long long rs[4] = {q_rs, k_rs, v_rs, o_rs};
  const long long bs[4] = {q_bs, k_bs, v_bs, o_bs};
  const void* ptr[4] = {q, k, v, o};
  for (int i = 0; i < 4; ++i)   // TMA: 16-byte aligned base and pitches
    if ((rs[i] * 2) % 16 || (bs[i] * 2) % 16 || rs[i] < (long long)H * D ||
        ((uintptr_t)ptr[i]) % 16)
      return (int)cudaErrorInvalidValue;
  // a runtime call before the driver's tensor-map encoder: it binds this
  // host thread to the device's context (the remat recompute runs on
  // autograd's own thread)
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_d64_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tq, tk, tv, to;
  const uint64_t w = (uint64_t)H * D;
  if (!sm90::encode_bf16_3d(&tq, q, w, Sq, B, q_rs * 2, q_bs * 2, BQ) ||
      !sm90::encode_bf16_3d(&tk, k, w, kv_valid, B, k_rs * 2, k_bs * 2, BK) ||
      !sm90::encode_bf16_3d(&tv, v, w, kv_valid, B, v_rs * 2, v_bs * 2, BK) ||
      !sm90::encode_bf16_3d(&to, o, w, Sq, B, o_rs * 2, o_bs * 2, 64))
    return (int)cudaErrorInvalidValue;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_d64_sm90<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      tq, tk, tv, to, (float*)lse, H, Sq, kv_valid, c);
  return (int)cudaGetLastError();
}
