// Flash-attention forward at d=512 for Hopper (sm_90a) on wgmma + TMA: K2
// of the port (the SVD-VAE mid attention, one head of 512 over
// [B, S, 1, 512]).
//
// Replaces the Pallas kernel `_flash_kernel` of
// star_tpu/ops/flash_attention.py (via `_flash_fwd`, :256, with the d > 64
// block caps of :648-665), forward only. The softmax is the
// max-subtracted online softmax in fp32, in the log2 domain (logits times
// c = scale*log2(e)); keys at or past kv_valid get no weight; the output
// is bf16. (The Pallas kernel's fixed-reference exp2(min(s, 120)) is a TPU
// shortcut; the port computes the true softmax. The d=64 forward, K1 and
// K2's `with_l` mode, is csrc/flash_fwd_sm90.cu.)
//
// What bounds it on the H100: tensor-core operations, 4*S^2*512 FLOPs a
// frame against 8*S*512 bytes. Registers and shared memory shape it:
// - Registers. A 64x512 fp32 O is 256 registers a thread in one
//   warpgroup, so two consumer warpgroups share BQ = 64 query rows and
//   each owns 256 of O's columns (128 registers a thread):
//   O_w += P V[:, 256w:256w+256] is wgmma m64n256k16 with P from
//   registers (the S accumulator packs pairwise into the A layout).
// - S = Q K^T. With SPLIT_S each group computes the partial over its half
//   of d and the two exchange partials through shared memory behind a
//   named barrier, so no product is computed twice (a + b equals b + a in
//   fp32, so both groups hold the same S and run the same softmax);
//   without it each group computes the whole S (1.5x the FLOPs, no
//   exchange).
// - Shared memory. Q is 64 KB (8 panels of 64 columns, each 64 rows of
//   128 bytes under the 128-byte swizzle); K and V at BK = 32 are 32 KB a
//   stage each, through a ring of STAGES stages with full/empty mbarriers
//   (K and V apart, so a K stage is refilled while its V is still read).
//   Two stages, Q and the double-buffered exchange: 224 KB of the 227 KB.
// - Intensity. A block loads 64 FLOPs per byte of K/V tile from L2. With
//   CLUSTER = 2, two CTAs on neighbouring query tiles share each K/V tile:
//   each loads half of its panels by TMA multicast into both, which halves
//   the L2 traffic per FLOP; a stage is refilled only when the consumers
//   of both CTAs have released it. It measured 6-7% slower, so 1.
// - One product group in flight at a time: O += P_{j-1} V_{j-1} is issued
//   and waited on, then S_j, then the exchange and softmax of S_j; the two
//   consumer groups interleave. K1's order (S_j issued before
//   P_{j-1} V_{j-1}, the softmax under the product) took 1.16-1.26x the
//   time here.
// The tensor maps are 3-D over [B, S, H*512] with boxes of 64 columns;
// the K/V maps end at kv_valid (the tile that holds it reads zeros past it
// and is masked; no tile past it is loaded); query rows past Sq read as
// zero and are not stored.
// Measured (chip_variants.py, H100 SXM): about 323 TFLOP/s at
// [8,14400,1,512], 2.7x SDPA's speed. ptxas serialises every wgmma of this
// kernel (its C7512, "insufficient register resources": the SASS waits
// after each of the 36 products) at 179 registers of the 232, with 56
// bytes spilled. Computing S twice, the 2-CTA multicast, BK = 64 with one
// stage, two n128 products for O and 240 registers each left that as it
// was, and none was faster.

#include <math.h>

#include "sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace k2 {
constexpr int D = 512, BQ = 64, BK = 32, STAGES = 2;
constexpr bool SPLIT_S = true;            // exchange the halves of S
constexpr int XBUF = 2;                   // exchange buffers
constexpr int CLUSTER = 1;                // CTAs sharing each K/V tile
constexpr int NWG = 2, THREADS = 128 * (NWG + 1);
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int PANELS = D / 64;            // 64-column panels of a row
constexpr int QPANEL = BQ * 64, KPANEL = BK * 64;   // elements
constexpr int QBYTES = PANELS * QPANEL * 2;
constexpr int KTILE = PANELS * KPANEL * 2;          // bytes of a K or V tile
constexpr int NS = BK / 2;                // fp32 a thread of S [64 x BK]
constexpr int SPAN = SPLIT_S ? PANELS / NWG : PANELS;  // d panels of S
constexpr int XCH = SPLIT_S ? NS * 128 : 1;
constexpr int X_BAR = 1, X_BAR2 = 2;      // named barriers (0: syncthreads)

struct Smem {                             // every tile 1024-byte aligned
  bf16 q[PANELS][QPANEL];
  bf16 k[STAGES][PANELS][KPANEL];
  bf16 v[STAGES][PANELS][KPANEL];
  float xch[XBUF][NWG][XCH];              // partial S, [register][thread]
  uint64_t q_full;
  uint64_t k_full[STAGES], k_empty[STAGES];
  uint64_t v_full[STAGES], v_empty[STAGES];
};
constexpr int SMEM = sizeof(Smem) + 1024;  // + room to align the base
}  // namespace k2

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// releases a K or V stage: one arrival from this warp in every CTA of the
// cluster (their producers multicast into this CTA's stage too)
__device__ __forceinline__ void release(uint64_t* bar) {
  if constexpr (k2::CLUSTER == 1) {
    sm90::mbar_arrive(bar);
  } else {
#pragma unroll
    for (int r = 0; r < k2::CLUSTER; ++r) sm90::mbar_arrive_cluster(bar, r);
  }
}

// One consumer warpgroup: O[:, 256wg : 256wg + 256] of the block's 64
// query rows against every live key tile. Accumulator layout (wgmma
// m64nN): warp w of the group holds rows 16w + g and 16w + g + 8
// (g = lane / 4); register 4i + e holds column 8i + 2*(lane % 4) + (e & 1)
// of row g (e < 2) or g + 8 (e >= 2).
__device__ __forceinline__ void d512_consumer(k2::Smem& sm, int wg,
                                              bf16* __restrict__ o, int b,
                                              int h, int q0, int Sq,
                                              int kv_valid, long long o_bs,
                                              int o_rs, float c) {
  using namespace k2;
  using namespace sm90;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int n = (kv_valid + BK - 1) / BK;          // live key tiles, >= 1
  const bool ragged = (kv_valid % BK) != 0;

  float s[NS];          // S tile: 64 rows x BK keys
  float acc[128];       // this group's O: 64 rows x 256 dims
  uint32_t p[NS / 2];   // P in bf16, the A fragments of BK/16 k-steps
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;   // running max (scaled, log2)
  float l0 = 0.f, l1 = 0.f;               // this thread's share of the sums

  const int pd0 = SPLIT_S ? SPAN * wg : 0;  // first d panel of this S
  auto issue_s = [&](int st) {            // s = Q K^T over SPAN panels
#pragma unroll
    for (int kk = 0; kk < SPAN * 4; ++kk) {
      const int pn = pd0 + (kk >> 2);
      wgmma_ss<BK, 0, 0>(s, desc_sw128(sm.q[pn], 16, 1024) + 2 * (kk & 3),
                         desc_sw128(sm.k[st][pn], 16, 1024) + 2 * (kk & 3),
                         kk);
    }
    wgmma_commit();
  };
  auto issue_o = [&](int st) {            // acc += P V[:, this half]
    const uint64_t dv = desc_sw128(sm.v[st][4 * wg], KPANEL * 2, 1024);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<256, 1>(acc, p + 4 * kk, dv + 128 * kk, 1);
    wgmma_commit();
  };
  // S = this group's partial + the other's (SPLIT_S)
  auto exchange = [&](int j) {
    float* mine = sm.xch[j % XBUF][wg];
    const float* theirs = sm.xch[j % XBUF][wg ^ 1];
#pragma unroll
    for (int i = 0; i < NS; ++i) mine[i * 128 + tid] = s[i];
    bar_sync(X_BAR, 256);
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] += theirs[i * 128 + tid];
    if (XBUF == 1) bar_sync(X_BAR2, 256);   // both have read before a rewrite
  };
  // online softmax of tile j in place: s becomes P (fp32); returns the
  // factors that rescale the earlier O and l of rows g and g + 8
  auto softmax = [&](int j, float& a0, float& a1) {
    if (ragged && j == n - 1) {
      const int k0 = j * BK + 2 * t4;
#pragma unroll
      for (int i = 0; i < NS / 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * i + (e & 1) >= kv_valid) s[4 * i + e] = -INFINITY;
    }
    float mx0 = s[0], mx1 = s[2];
#pragma unroll
    for (int i = 0; i < NS / 4; ++i) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // c > 0, and the first key of every live tile is live: both maxima
    // are finite
    const float n0 = fmaxf(m0, mx0 * c), n1 = fmaxf(m1, mx1 * c);
    a0 = ex2(m0 - n0);
    a1 = ex2(m1 - n1);
    m0 = n0;
    m1 = n1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < NS / 4; ++i) {
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
  auto pack_p = [&]() {
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
  };
  auto fence_s = [&]() {
#pragma unroll
    for (int i = 0; i < NS; ++i) fence_reg(s[i]);
  };
  auto fence_op = [&]() {
#pragma unroll
    for (int i = 0; i < 128; ++i) fence_reg(acc[i]);
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) fence_reg(p[i]);
  };

  float a0, a1;
  mbar_wait(&sm.q_full, 0);
  mbar_wait(&sm.k_full[0], 0);
  wgmma_fence();
  issue_s(0);
  wgmma_wait<0>();
  fence_s();
  if (lane == 0) release(&sm.k_empty[0]);
  if (SPLIT_S) exchange(0);
  softmax(0, a0, a1);
  pack_p();

  for (int j = 1; j < n; ++j) {
    const int st = j % STAGES, pst = (j - 1) % STAGES;
    mbar_wait(&sm.k_full[st], (j / STAGES) & 1);
    mbar_wait(&sm.v_full[pst], ((j - 1) / STAGES) & 1);
    fence_op();
    wgmma_fence();
    issue_o(pst);
    wgmma_wait<0>();                       // P_{j-1} V_{j-1} has retired
    fence_op();
    if (lane == 0) release(&sm.v_empty[pst]);
    wgmma_fence();
    issue_s(st);
    wgmma_wait<0>();                       // S_j has landed
    fence_s();
    if (lane == 0) release(&sm.k_empty[st]);
    if (SPLIT_S) exchange(j);
    softmax(j, a0, a1);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      acc[4 * i] *= a0;
      acc[4 * i + 1] *= a0;
      acc[4 * i + 2] *= a1;
      acc[4 * i + 3] *= a1;
    }
    pack_p();
  }
  {
    const int pst = (n - 1) % STAGES;
    mbar_wait(&sm.v_full[pst], ((n - 1) / STAGES) & 1);
    fence_op();
    wgmma_fence();
    issue_o(pst);
    wgmma_wait<0>();
    fence_op();
    if (lane == 0) release(&sm.v_empty[pst]);
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float i0 = 1.f / l0, i1 = 1.f / l1;       // l >= 1: the max's term
  const int row0 = q0 + warp * 16 + g;
  bf16* ob = o + b * o_bs + (long long)h * D + 256 * wg + 2 * t4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    const float inv = half ? i1 : i0;
    if (row < Sq) {
      bf16* orow = ob + (long long)row * o_rs;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        *reinterpret_cast<uint32_t*>(orow + 8 * i) =
            pack_bf16(acc[4 * i + 2 * half] * inv,
                      acc[4 * i + 2 * half + 1] * inv);
    }
  }
}

__global__ void __launch_bounds__(k2::THREADS, 1)
flash_fwd_d512_sm90(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    bf16* __restrict__ o, int H, int Sq, int kv_valid,
                    long long o_bs, int o_rs, float c) {
  using namespace k2;
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
      // lane 0 of each consumer warp of every CTA of the cluster
      mbar_init(&sm.k_empty[st], 4 * NWG * CLUSTER);
      mbar_init(&sm.v_empty[st], 4 * NWG * CLUSTER);
    }
    fence_barrier_init();
  }
  if constexpr (CLUSTER == 1) {
    __syncthreads();
  } else {
    cluster_sync();   // the peers' barriers exist before any multicast
  }

  if (wg == 0) {
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      const int n = (kv_valid + BK - 1) / BK;
      mbar_expect_tx(&sm.q_full, QBYTES);
#pragma unroll
      for (int pn = 0; pn < PANELS; ++pn)
        tma_load_3d(sm.q[pn], &tq, &sm.q_full, h * D + 64 * pn, q0, b);
      // with a cluster, this CTA loads panels [p0, p0 + PANELS / CLUSTER)
      // of each tile into every CTA of it
      const int p0 = CLUSTER == 1 ? 0 : (int)cluster_rank() * (PANELS / CLUSTER);
      auto load = [&](bf16 (*dst)[KPANEL], const CUtensorMap* map,
                      uint64_t* bar, int j) {
#pragma unroll
        for (int pn = p0; pn < p0 + PANELS / CLUSTER; ++pn) {
          if constexpr (CLUSTER == 1)
            tma_load_3d(dst[pn], map, bar, h * D + 64 * pn, j * BK, b);
          else
            tma_load_3d_multicast(dst[pn], map, bar, h * D + 64 * pn, j * BK,
                                  b, (uint16_t)((1u << CLUSTER) - 1));
        }
      };
      for (int j = 0; j < n; ++j) {
        const int st = j % STAGES;
        const uint32_t free_parity = ((j / STAGES) & 1) ^ 1;
        mbar_wait(&sm.k_empty[st], free_parity);
        mbar_expect_tx(&sm.k_full[st], KTILE);
        load(sm.k[st], &tk, &sm.k_full[st], j);
        mbar_wait(&sm.v_empty[st], free_parity);
        mbar_expect_tx(&sm.v_full[st], KTILE);
        load(sm.v[st], &tv, &sm.v_full[st], j);
      }
    }
    if constexpr (CLUSTER > 1) {   // no CTA leaves while a peer needs it
      __syncwarp();
      cluster_sync();
    }
  } else {
    reg_alloc<CONSUMER_REGS>();
    d512_consumer(sm, wg - 1, o, b, h, q0, Sq, kv_valid, o_bs, o_rs, c);
    if constexpr (CLUSTER > 1) cluster_sync();
  }
}

// q, k, v, o: bf16 with head h at column h*512 of rows of stride q_rs ...
// (elements) and batch strides q_bs ...; keys at or past kv_valid (clipped
// to Sk, at least 1) get no weight. The launch arithmetic is
// `d512_launch_plan` in star_tpu_torch/ops/flash_attention.py.
extern "C" int star_flash_fwd_d512(const void* q, const void* k,
                                   const void* v, void* o, int B, int H,
                                   int Sq, int Sk, int kv_valid,
                                   long long q_bs, long long k_bs,
                                   long long v_bs, long long o_bs, int q_rs,
                                   int k_rs, int v_rs, int o_rs, float c,
                                   void* stream) {
  using namespace k2;
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
  // host thread to the device's context
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_d512_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tq, tk, tv;
  const uint64_t w = (uint64_t)H * D;
  if (!sm90::encode_bf16_3d(&tq, q, w, Sq, B, q_rs * 2, q_bs * 2, BQ) ||
      !sm90::encode_bf16_3d(&tk, k, w, kv_valid, B, k_rs * 2, k_bs * 2, BK) ||
      !sm90::encode_bf16_3d(&tv, v, w, kv_valid, B, v_rs * 2, v_bs * 2, BK))
    return (int)cudaErrorInvalidValue;
  const int blocks = (Sq + BQ - 1) / BQ;
  dim3 grid((blocks + CLUSTER - 1) / CLUSTER * CLUSTER, B * H);
  if constexpr (CLUSTER == 1) {
    flash_fwd_d512_sm90<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
        tq, tk, tv, (bf16*)o, H, Sq, kv_valid, o_bs, o_rs, c);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = SMEM;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, flash_fwd_d512_sm90, tq, tk, tv, (bf16*)o,
                             H, Sq, kv_valid, o_bs, o_rs, c);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
