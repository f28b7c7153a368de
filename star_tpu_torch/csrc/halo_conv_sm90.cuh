// The halo conv of Hopper (sm_90a) on wgmma + TMA, shared by K6
// (conv3x3_sm90.cu: GroupNorm-apply + SiLU + 3x3 SAME conv, + residual)
// and K7 (upsample_conv_sm90.cu: nearest-2x upsample + 3x3 SAME conv as
// four phase 2x2 convs on the small grid). Each of those files holds its
// kernel, a thin instantiation of `body<Form>`, and its C entry point.
//
// Design. A tile is (128 output channels, phase, 16x16 patch of the input
// grid, image), walked with the output channels fastest, then the phase
// (K7's four; K6 has one), so the tiles of a patch run on neighbouring SMs
// at once and their halos hit in L2. Two consumer warpgroups each own 8 of
// the patch's 16 columns (128 pixels, two 64-row wgmma blocks) and all 128
// channels. Per 64-channel chunk:
// - eight 4-D TMA loads bring the 18x18 halo from (h0 - 1, w0 - 1), one
//   8-channel group each, into the plain (unswizzled) K-major layout of
//   wgmma's core matrices, [8 groups][18*18 pixels, padded to 328][8
//   channels], 16 bytes a pixel; pixels outside the image read as zero;
// - K6 only (Form::GN_SILU): the consumer warpgroups apply silu(x*a + b)
//   in fp32 IN PLACE, once per halo element, rounded once to bf16, and
//   write zeros over the pixels outside the image (SAME padding after the
//   activation); they do it for chunk k+1 while chunk k's products run, a
//   sixth after each of taps 3-8. K7 leaves the halo as loaded: TMA's
//   zeros are the SAME padding of the upsampled grid;
// - each tap of the tile's phase is a shifted view of that halo: a core
//   matrix is 8 consecutive pixels of one patch row, 128 contiguous bytes,
//   so the tap's A operand is one descriptor `tap_bytes` on (K6's tap
//   (ty, tx): 16*(18*ty + tx); K7's tap (p, q) of phase (r, s): halo cell
//   (r+p, s+q)), 288 bytes (one halo row) between core matrices and 5248
//   (one channel group) between the two halves of a k-step. No copy per
//   tap, no operand in registers. The offsets are the launch plan's,
//   handed to the entry point and kept in shared memory;
// - the weights of each (chunk, phase, tap), [128 Cout][64 C] K-major
//   under the 128-byte swizzle, stream through a TMA ring from the
//   [Cout, PHASES*TAPS, C] layout the wrapper makes.
// Two producer threads issue the TMA loads through mbarrier rings (one the
// halos, one the weights: full / empty), so the loads run ahead of the
// products and neither waits behind the other. The grid is persistent: one
// block an SM walks the tiles t = blockIdx.x, + gridDim.x, ..., and the
// rings run on across tiles, so the next tile's loads (and K6's transform)
// run under this tile's epilogue.
// Epilogue (each consumer group): + bias, one rounding, + K6's residual
// (TMA-loaded into the group's staging tile when the tile starts), round;
// staged under the 128-byte swizzle in two 64-channel halves so that the
// accumulator's rows land on distinct banks; two TMA stores through the
// phase's map of the output (K7's phase (r, s): out[n, 2i+r, 2j+s] as a
// strided [N][H][W][Cout] view, `offset` elements on), clipped at the
// grid's edges; then the statistics of the staged values, two columns a
// thread, pixels outside the image left out, one atomicAdd per (tile half,
// channel) into zeroed [N, Cout] buffers: their order varies between runs.

#pragma once

#include "sm90.cuh"

namespace halo {
typedef __nv_bfloat16 bf16;

constexpr int T = 16, HALO = T + 2, HPIX = HALO * HALO;  // 324
constexpr int KG_PIX = 328;              // pixels a channel group, padded
constexpr int KG_BYTES = KG_PIX * 16;    // 5248: 128-byte aligned groups
constexpr int ACT_BYTES = 8 * KG_BYTES;  // 41,984 a chunk
constexpr int BN = 128, WST_BYTES = BN * 128;
constexpr int ASTAGES = 2, WSTAGES = 4;
constexpr int STAGE_BYTES = 2 * 128 * 128;  // a group's staging tile
constexpr int THREADS = 384;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int BAR_CONS = 1, BAR_EPI = 2;
constexpr int MAX_TAPS = 16;             // phases x taps
// the furthest tap offset, halo cell (2, 2) (the kernel adds the consumer
// group's 8 columns)
constexpr int MAX_TAP_BYTES = 16 * (2 * HALO + 2);
constexpr int SMEM = 1024 + ASTAGES * ACT_BYTES + WSTAGES * WST_BYTES +
                     2 * STAGE_BYTES + 256;

// K6: a 3x3 conv of silu(x*a + b), one phase of nine taps, + residual
struct ConvForm {
  static constexpr int PHASES = 1, TAPS = 9;
  static constexpr bool GN_SILU = true;
};
// K7: four phases of four taps on the small grid, no transform
struct UpsampleForm {
  static constexpr int PHASES = 4, TAPS = 4;
  static constexpr bool GN_SILU = false;
};

struct Bars {
  uint64_t act_full[ASTAGES], act_empty[ASTAGES];
  uint64_t w_full[WSTAGES], w_empty[WSTAGES];
  uint64_t res_full[2];
  int tap_bytes[MAX_TAPS];
};
static_assert(sizeof(Bars) <= 256, "barriers");
static_assert(SMEM <= 232448, "shared memory");

// the output map of each phase (2r + s), and K6's residual
template <class F>
struct OutMaps {
  CUtensorMap out[F::PHASES];
  CUtensorMap res;
};

struct Params {
  const float* ga;    // [N, C] GN scale (K6)
  const float* gb;    // [N, C] GN shift (K6)
  const float* bias;  // [Cout]
  float* ssum;        // [N, Cout], zeroed by the caller
  float* ssq;
  int N, H, W, C, Cout, nct, tiles_h, tiles_w, has_res, want_stats;
  int tap_bytes[MAX_TAPS];  // A offset of tap j of phase ph: [TAPS*ph + j]
};

struct Tile {
  int n, h0, w0, col0, phase;
};

template <int PHASES>
__device__ __forceinline__ Tile tile_of(const Params& p, int t) {
  Tile r;
  r.col0 = (t % p.nct) * BN;
  t /= p.nct;
  r.phase = t % PHASES;
  t /= PHASES;
  r.w0 = (t % p.tiles_w) * T;
  t /= p.tiles_w;
  r.h0 = (t % p.tiles_h) * T;
  r.n = t / p.tiles_h;
  return r;
}

template <class F>
__device__ __forceinline__ void body(const CUtensorMap& tx,
                                     const CUtensorMap& tw,
                                     const OutMaps<F>& maps,
                                     const Params& p) {
  using namespace sm90;
  constexpr int TAPS = F::TAPS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* act = base;                             // [ASTAGES][ACT]
  unsigned char* wring = base + ASTAGES * ACT_BYTES;     // [WSTAGES][BN][128]
  unsigned char* staging = wring + WSTAGES * WST_BYTES;  // [2][STAGE]
  Bars& bars = *reinterpret_cast<Bars*>(staging + 2 * STAGE_BYTES);
  const int nchunk = p.C / 64;
  const int ntiles = p.nct * F::PHASES * p.tiles_w * p.tiles_h * p.N;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ASTAGES; ++s) {
      mbar_init(&bars.act_full[s], 1);
      mbar_init(&bars.act_empty[s], 8);    // lane 0 of each consumer warp
    }
    for (int s = 0; s < WSTAGES; ++s) {
      mbar_init(&bars.w_full[s], 1);
      mbar_init(&bars.w_empty[s], 8);
    }
    mbar_init(&bars.res_full[0], 1);
    mbar_init(&bars.res_full[1], 1);
    fence_barrier_init();
#pragma unroll
    for (int j = 0; j < MAX_TAPS; ++j) bars.tap_bytes[j] = p.tap_bytes[j];
  }
  __syncthreads();

  if (wg == 0) {
    // producers: lane 0 of warp 0 issues the halos, lane 0 of warp 1 the
    // weights, each through its own ring, so that neither waits behind
    // the other (K6's consumers wait for halo k+1 before they release the
    // weight stages of chunk k)
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int k = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const Tile tl = tile_of<F::PHASES>(p, t);
        for (int kc = 0; kc < nchunk; ++kc, ++k) {
          const int s = k % ASTAGES;
          mbar_wait(&bars.act_empty[s], ((k / ASTAGES) & 1) ^ 1);
          mbar_expect_tx(&bars.act_full[s], 8 * HPIX * 16);
          for (int kg = 0; kg < 8; ++kg)
            tma_load_4d(act + s * ACT_BYTES + kg * KG_BYTES, &tx,
                        &bars.act_full[s], kc * 64 + 8 * kg, tl.w0 - 1,
                        tl.h0 - 1, tl.n);
        }
      }
    } else if (threadIdx.x == 32) {
      int i = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const Tile tl = tile_of<F::PHASES>(p, t);
        for (int kc = 0; kc < nchunk; ++kc)
          for (int tap = 0; tap < TAPS; ++tap, ++i) {
            const int ws = i % WSTAGES;
            mbar_wait(&bars.w_empty[ws], ((i / WSTAGES) & 1) ^ 1);
            mbar_expect_tx(&bars.w_full[ws], WST_BYTES);
            tma_load_3d(wring + ws * WST_BYTES, &tw, &bars.w_full[ws],
                        kc * 64, TAPS * tl.phase + tap, tl.col0);
          }
      }
    }
    return;
  }

  // consumers: group c owns patch columns 8c .. 8c + 7 (pixel row r of
  // wgmma block mb is patch pixel (8 mb + r / 8, 8 c + r % 8))
  reg_alloc<CONSUMER_REGS>();
  const int c = wg - 1;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  unsigned char* stage = staging + c * STAGE_BYTES;  // 2 x [128][128 B]

  // K6's transform: consumer thread ct keeps channel group ct / 32 of halo
  // pixels ct % 32 + 32 u (u < 11)
  const int ct = threadIdx.x - 128, kg = ct >> 5;
  constexpr int UPIX = (HPIX + 31) / 32;           // 11
  float av[8], bv[8];
  Tile xt{};                                       // the tile transformed
  int xk = 0;                                      // and its chunk
  auto coeffs = [&]() {                            // GN (a, b) of the group
    const int cc = xk * 64 + 8 * kg;
    const float4* pa =
        reinterpret_cast<const float4*>(p.ga + (long long)xt.n * p.C + cc);
    const float4* pb =
        reinterpret_cast<const float4*>(p.gb + (long long)xt.n * p.C + cc);
    const float4 a0 = __ldg(pa), a1 = __ldg(pa + 1);
    const float4 b0 = __ldg(pb), b1 = __ldg(pb + 1);
    av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
    av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
    bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
    bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
  };
  // this thread's pixels u0 .. u1-1 of halo stage s: GN apply + SiLU, or
  // zeros outside the image
  auto transform = [&](int s, int u0, int u1) {
    unsigned char* a = act + s * ACT_BYTES + kg * KG_BYTES;
    for (int u = u0; u < u1; ++u) {
      const int px = (ct & 31) + 32 * u;
      if (px >= HPIX) break;
      const int hy = px / HALO, hx = px - hy * HALO;
      const int ih = xt.h0 - 1 + hy, iw = xt.w0 - 1 + hx;
      uint4* vp = reinterpret_cast<uint4*>(a + px * 16);
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (ih >= 0 && ih < p.H && iw >= 0 && iw < p.W) {
        val = *vp;
        bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float x = fmaf(__bfloat162float(e[j]), av[j], bv[j]);
          e[j] = __float2bfloat16(__fdividef(x, 1.f + __expf(-x)));
        }
      }
      *vp = val;
    }
  };

  float acc[2][BN / 2];
  auto fence_acc = [&]() {
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_reg(acc[mb][i]);
  };
  auto release = [&](int i) {   // step i's products have retired
    if (lane == 0) {
      mbar_arrive(&bars.w_empty[i % WSTAGES]);
      if (i % TAPS == TAPS - 1)
        mbar_arrive(&bars.act_empty[(i / TAPS) % ASTAGES]);
    }
  };
  // K6: the first chunk, before any product
  if constexpr (F::GN_SILU) {
    if ((int)blockIdx.x < ntiles) {
      xt = tile_of<F::PHASES>(p, blockIdx.x);
      coeffs();
      mbar_wait(&bars.act_full[0], 0);
      transform(0, 0, UPIX);
      fence_proxy_async();
      bar_sync(BAR_CONS, 256);
    }
  }
  int i = 0, n = 0;             // steps and tiles so far
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x, ++n) {
    const Tile tl = tile_of<F::PHASES>(p, t);
    const int wc0 = tl.w0 + 8 * c;
    const int* taps = bars.tap_bytes + TAPS * tl.phase;
    // the staging tile is free: its last stores were read before the
    // group's barrier that ended the previous tile
    if constexpr (F::GN_SILU) {
      if (p.has_res && tid == 0) {
        mbar_expect_tx(&bars.res_full[c], STAGE_BYTES);
        for (int u = 0; u < 2; ++u)
          tma_load_4d(stage + u * 128 * 128, &maps.res, &bars.res_full[c],
                      tl.col0 + 64 * u, wc0, tl.h0, tl.n);
      }
    }
    for (int kc = 0; kc < nchunk; ++kc) {
      const int k = i / TAPS, s = k % ASTAGES, s1 = (k + 1) % ASTAGES;
      bool more = false;
      if constexpr (F::GN_SILU) {
        // the next chunk: this tile's, or the next tile's first
        more = kc + 1 < nchunk || t + (int)gridDim.x < ntiles;
        if (more) {
          if (kc + 1 < nchunk) {
            xk = kc + 1;
          } else {
            xt = tile_of<F::PHASES>(p, t + gridDim.x);
            xk = 0;
          }
          coeffs();
        }
      } else {
        mbar_wait(&bars.act_full[s], (k / ASTAGES) & 1);
      }
      for (int tap = 0; tap < TAPS; ++tap, ++i) {
        const int ws = i % WSTAGES;
        mbar_wait(&bars.w_full[ws], (i / WSTAGES) & 1);
        const uint64_t da = desc_plain(
            act + s * ACT_BYTES + taps[tap] + 8 * c * 16, KG_BYTES,
            HALO * 16);
        const uint64_t db = desc_sw128(wring + ws * WST_BYTES, 16, 1024);
        fence_acc();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int sc = (kc | tap | kk) != 0;
          const uint64_t ka = da + ((2 * kk * KG_BYTES) >> 4);
          wgmma_ss<BN, 0, 0>(acc[0], ka, db + 2 * kk, sc);
          wgmma_ss<BN, 0, 0>(acc[1], ka + ((8 * HALO * 16) >> 4),
                             db + 2 * kk, sc);
        }
        wgmma_commit();
        // K6: a sixth of the next chunk under each of taps 3-8 (its halo
        // stage is refilled once tap 0's release has freed it; three taps
        // give the load time to land)
        if constexpr (F::GN_SILU) {
          if (more && tap >= 3) {
            if (tap == 3)
              mbar_wait(&bars.act_full[s1], ((k + 1) / ASTAGES) & 1);
            transform(s1, UPIX * (tap - 3) / 6, UPIX * (tap - 2) / 6);
          }
        }
        wgmma_wait<1>();
        fence_acc();
        if (kc | tap) release(i - 1);
      }
      if constexpr (F::GN_SILU) {
        if (more) {   // the next chunk is activated, by both groups
          fence_proxy_async();
          bar_sync(BAR_CONS, 256);
        }
      }
    }
    wgmma_wait<0>();
    fence_acc();
    release(i - 1);

    // epilogue: staging is two 64-channel halves of [128 pixels][128 B]
    // under the 128-byte swizzle
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float b0 = p.bias[tl.col0 + 8 * j + 2 * t4];
      const float b1 = p.bias[tl.col0 + 8 * j + 2 * t4 + 1];
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
        acc[mb][4 * j] += b0;
        acc[mb][4 * j + 1] += b1;
        acc[mb][4 * j + 2] += b0;
        acc[mb][4 * j + 3] += b1;
      }
    }
    const bool res = F::GN_SILU && p.has_res;
    if (res) mbar_wait(&bars.res_full[c], n & 1);
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mb * 64 + warp * 16 + g + 8 * h;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          __nv_bfloat162* sp = reinterpret_cast<__nv_bfloat162*>(
              stage + (j >> 3) * 128 * 128 + r * 128 +
              (((j & 7) ^ (r & 7)) << 4) + 4 * t4);
          __nv_bfloat162 v = __floats2bfloat162_rn(
              acc[mb][4 * j + 2 * h], acc[mb][4 * j + 2 * h + 1]);
          if (res) {
            const float2 rv = __bfloat1622float2(*sp);
            const float2 ov = __bfloat1622float2(v);
            v = __floats2bfloat162_rn(ov.x + rv.x, ov.y + rv.y);
          }
          *sp = v;
        }
      }
    fence_proxy_async();
    bar_sync(BAR_EPI + c, 128);
    if (tid == 0)
      for (int u = 0; u < 2; ++u)
        tma_store_4d(&maps.out[tl.phase], stage + u * 128 * 128,
                     tl.col0 + 64 * u, wc0, tl.h0, tl.n);
    if (p.want_stats) {
      // thread: columns 2 (tid % 64) and + 1, patch rows 8 (tid / 64) ..
      // + 7 (one 8-pixel row of the group's 8 columns each), bf16x2 reads
      const int col = 2 * (tid & 63), half = tid >> 6;
      const unsigned char* sp = stage + (col >> 6) * 128 * 128;
      const int prows = min(8, p.H - tl.h0 - 8 * half);
      const int pcols = min(8, p.W - wc0);
      float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
      for (int pr = 0; pr < prows; ++pr) {
        const int r0 = (8 * half + pr) * 8;
#pragma unroll 8
        for (int pc = 0; pc < pcols; ++pc) {
          const float2 v = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  sp + swizzle((r0 + pc) * 128 + (col & 63) * 2, 128)));
          s0 += v.x;
          s1 += v.y;
          q0 = fmaf(v.x, v.x, q0);
          q1 = fmaf(v.y, v.y, q1);
        }
      }
      float* ps = p.ssum + (long long)tl.n * p.Cout + tl.col0 + col;
      float* pq = p.ssq + (long long)tl.n * p.Cout + tl.col0 + col;
      atomicAdd(ps, s0);
      atomicAdd(ps + 1, s1);
      atomicAdd(pq, q0);
      atomicAdd(pq + 1, q1);
    }
    if (tid == 0) bulk_wait_read<0>();      // the stores have read the tile
    bar_sync(BAR_EPI + c, 128);              // and so have the statistics
  }
}

// Checks what the entry point was handed, encodes the tensor maps and
// launches `kernel` on `grid` persistent blocks. x [N,H,W,C] bf16; w
// [Cout, PHASES*TAPS, C] bf16; out and residual (K6, or null) bf16 with
// PHASES*N*H*W*Cout elements; phase ph stores through the [N][H][W][Cout]
// view `out_offset[ph]` elements into out with byte strides
// `out_strides` (W, H, N), the residual through phase 0's; p's
// tap_bytes as the plan gives them.
template <class F, class K>
int launch(K kernel, const void* x, const void* w, const void* residual,
           void* out, const long long* out_offset,
           const long long* out_strides, Params p, int grid, void* stream) {
  const int N = p.N, H = p.H, W = p.W, C = p.C, Cout = p.Cout;
  if (N < 1 || H < 1 || W < 1 || C < 64 || C % 64 || Cout < BN ||
      Cout % BN || grid < 1)
    return (int)cudaErrorInvalidValue;
  const void* ptr[4] = {x, w, out, residual ? residual : out};
  for (const void* q : ptr)
    if ((uintptr_t)q % 16) return (int)cudaErrorInvalidValue;
  for (int j = 0; j < F::PHASES * F::TAPS; ++j)
    if (p.tap_bytes[j] < 0 || p.tap_bytes[j] % 16 ||
        p.tap_bytes[j] > MAX_TAP_BYTES)
      return (int)cudaErrorInvalidValue;
  // every phase's view must lie inside out, 16-byte aligned
  const long long total = (long long)F::PHASES * N * H * W * Cout;
  for (int d = 0; d < 3; ++d)
    if (out_strides[d] < 16 || out_strides[d] % 16)
      return (int)cudaErrorInvalidValue;
  const long long span = (Cout - 1) + ((W - 1) * out_strides[0] +
                                       (H - 1) * out_strides[1] +
                                       (N - 1) * out_strides[2]) / 2;
  for (int ph = 0; ph < F::PHASES; ++ph)
    if (out_offset[ph] < 0 || out_offset[ph] % 8 ||
        out_offset[ph] + span >= total)
      return (int)cudaErrorInvalidValue;
  p.nct = Cout / BN;
  p.tiles_h = (H + T - 1) / T;
  p.tiles_w = (W + T - 1) / T;
  p.has_res = residual != nullptr;
  if ((long long)N * p.tiles_h * p.tiles_w * F::PHASES * p.nct >
      0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  // a runtime call before the CUDA driver's tensor-map encoder binds
  // this host thread to the device's context
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  const uint64_t xd[4] = {(uint64_t)C, (uint64_t)W, (uint64_t)H, (uint64_t)N};
  const uint64_t xs[3] = {(uint64_t)C * 2, (uint64_t)W * C * 2,
                          (uint64_t)H * W * C * 2};
  const uint32_t xb[4] = {8, HALO, HALO, 1};
  const uint64_t wd[3] = {(uint64_t)C, (uint64_t)F::PHASES * F::TAPS,
                          (uint64_t)Cout};
  const uint64_t ws[2] = {(uint64_t)C * 2,
                          (uint64_t)F::PHASES * F::TAPS * C * 2};
  const uint32_t wb[3] = {64, 1, BN};
  const uint64_t od[4] = {(uint64_t)Cout, (uint64_t)W, (uint64_t)H,
                          (uint64_t)N};
  const uint64_t os[3] = {(uint64_t)out_strides[0], (uint64_t)out_strides[1],
                          (uint64_t)out_strides[2]};
  const uint32_t ob[4] = {64, 8, T, 1};
  CUtensorMap tx, tw;
  OutMaps<F> maps;
  if (!sm90::encode_bf16(&tx, x, 4, xd, xs, xb, 0) ||
      !sm90::encode_bf16(&tw, w, 3, wd, ws, wb, 128) ||
      !sm90::encode_bf16(&maps.res, residual ? residual : out, 4, od, os, ob,
                         128))
    return (int)cudaErrorInvalidValue;
  for (int ph = 0; ph < F::PHASES; ++ph)
    if (!sm90::encode_bf16(&maps.out[ph], (const bf16*)out + out_offset[ph],
                           4, od, os, ob, 128))
      return (int)cudaErrorInvalidValue;
  kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(tx, tw, maps, p);
  return (int)cudaGetLastError();
}
}  // namespace halo
