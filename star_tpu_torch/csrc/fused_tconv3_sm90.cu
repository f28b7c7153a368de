// Fused GroupNorm-apply + SiLU + (3,1,1) temporal conv for Hopper (sm_90a)
// on wgmma + TMA: K5 of the port.
//
// Replaces the Pallas kernel `_kernel` of star_tpu/ops/fused_temporal_conv.py
// (via `_dispatch`, :225, from `fused_gn_silu_tconv3`): y = silu(x*a + b)
// with GN coefficients (a, b) [B, C] folded from threaded statistics, the
// three frame taps as products with fp32 accumulation (a tap outside
// [0, F) adds 0 AFTER the SiLU), + fp32 bias, rounded once to bf16, + an
// optional bf16 residual, and the fp32 (sum, sumsq) of the stored output
// per (batch, channel) or, with per_frame, per (batch, frame, channel).
//
// What bounds it on the H100: at the UNet's widths (C = Cout = 320..1280)
// tensor-core operations, 2*3*C*Cout FLOPs per row against (C + Cout) * 2
// bytes (480..1920 FLOP/byte, above the card's 295); at the VAE's 128
// channels it is close to the balance point. Beside the products, each
// activated element costs an exponential and a reciprocal on the SFUs
// (16 a clock per SM): an earlier design that activated the input once per
// tap and 128-column tile spent more time there than in its products.
//
// Design. A block owns one batch element b, P pixels n0..n0+P-1, FT frames
// f0..f0+FT-1 (all F when F < 16), and BN = 2*NW output channels; its rows
// are frame-major, row = f*P + p, at most 128 (two 64-row wgmma blocks).
// Per 64-channel chunk:
// - one 4-D TMA load brings the slab x[b, f0-1 .. f0+FT, n0 .. n0+P-1,
//   c0 .. c0+63] (FT + 2 frames) under the 128-byte swizzle; frames and
//   pixels outside the tensor read as zero;
// - the consumer warpgroups apply silu(x*a + b) in fp32 IN PLACE, once per
//   element, rounded once to bf16, and write zeros over the frames outside
//   [0, F) (the temporal SAME padding after the activation); they do it
//   for chunk k+1 while chunk k's products run, a third after each tap's
//   issue (three transform warps beside them could not keep up:
//   chip_variants.py, PERF.md);
// - tap t (frame f + t - 1) is then the same slab shifted by t*P rows: P is
//   a multiple of 8, so the shift is a whole number of 1024-byte swizzle
//   atoms and each tap is one wgmma descriptor offset;
// - the weights of each (chunk, tap), K-major [BN][64] (the wrapper
//   transposes [3, C, Cout] into [3, Cout, C]), stream through a TMA ring;
// - two consumer warpgroups share the activated slab and each owns NW of
//   the BN columns (m64nNWk16, fp32 accumulators), so each element is
//   activated ceil(Cout / BN) times in all, once at Cout <= BN.
// Two producer threads issue the TMA loads through mbarrier rings (one the
// slabs, one the weights: full / empty), so the loads run ahead of the
// products. The grid is persistent:
// one block an SM walks the tiles t = blockIdx.x, + gridDim.x, ..., and
// the rings run on across tiles, so the next tile's loads and transform
// run under this tile's epilogue.
// Epilogue (each consumer group): + bias, round, + the residual (TMA-loaded
// into the group's staging tile when the tile starts), round; TMA stores
// clipped at the pixel and frame tails; then the statistics of the staged
// (stored) values, two columns a thread over the valid rows (the pixel
// tail and frames past F left out), added with one atomicAdd per (tile,
// statistics row, column) into zeroed buffers: their order varies between
// runs. The staging tile is NW / BW sub-tiles of BW columns under the
// TMA swizzle of their row width, so that a fragment's eight rows land on
// distinct banks (a plain [rows][NW] tile took 4- to 8-way conflicts).
// Rows of a pixel past N only ever read that pixel's (garbage) slab rows,
// so they touch no stored value.
// The launch arithmetic (maps, P, FT, NW, grid, shared memory) is
// `tconv3_launch_plan` in star_tpu_torch/ops/fused_temporal_conv.py.

#include "sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace k5 {
constexpr int BM = 128;                // rows of a tile (two wgmma blocks)
constexpr int SLABS = 3;               // slab ring; the weight ring's depth
                                       // is the plan's (2..6)
constexpr int MAX_WSTAGES = 6;
constexpr int THREADS = 384;           // a producer warpgroup, 2 consumers
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int BAR_CONS = 1, BAR_EPI = 2;  // named barriers (+ group)

struct Bars {
  uint64_t slab_full[SLABS], slab_empty[SLABS];
  uint64_t w_full[MAX_WSTAGES], w_empty[MAX_WSTAGES];
  uint64_t res_full[2];
};
static_assert(sizeof(Bars) <= 256, "barriers");

struct Params {
  const float* ga;    // [B, C] GN scale
  const float* gb;    // [B, C] GN shift
  const float* bias;  // [Cout]
  float* ssum;        // [B or B*F, Cout], zeroed by the caller
  float* ssq;
  int B, F, N, C, Cout, P, FT, nct, npt, nft, has_res, want_stats, per_frame;
  int slab_bytes;     // bytes of one slab buffer (a multiple of 1024)
  int wstages;        // depth of the weight ring
};

struct Tile {
  int b, n0, f0, col0;
};

__device__ __forceinline__ Tile tile_of(const Params& p, int t, int nw) {
  Tile r;
  r.col0 = (t % p.nct) * 2 * nw;
  t /= p.nct;
  r.n0 = (t % p.npt) * p.P;
  t /= p.npt;
  r.f0 = (t % p.nft) * p.FT;
  r.b = t / p.nft;
  return r;
}
}  // namespace k5

__device__ __forceinline__ float silu_f(float t) {
  return __fdividef(t, 1.f + __expf(-t));
}

__device__ __forceinline__ void load8(float (&v)[8], const float* src) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(src));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(src + 4));
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// the staging tile of a consumer group: NW / BW sub-tiles of [128 rows][BW
// columns], BW the widest of 64, 32, 16 that divides NW, each under the
// TMA swizzle of its row width (2 BW bytes), so that the accumulator's
// eight rows of a fragment land on distinct banks
template <int NW>
struct Staging {
  static constexpr int BW = NW % 64 == 0 ? 64 : NW % 32 == 0 ? 32 : 16;
  static constexpr int ROW = 2 * BW;             // bytes a row
  static constexpr int SUB = 128 * ROW;          // bytes a sub-tile
  // byte offset of (row r, column col) in the tile
  static __device__ __forceinline__ uint32_t at(int r, int col) {
    return (col / BW) * SUB + sm90::swizzle(r * ROW + (col % BW) * 2, ROW);
  }
};

template <int NW>
__global__ void __launch_bounds__(k5::THREADS, 1)
fused_tconv3_sm90(const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap tw,
                  const __grid_constant__ CUtensorMap tres,
                  const __grid_constant__ CUtensorMap tout,
                  const k5::Params p) {
  using namespace k5;
  using namespace sm90;
  constexpr int WST_BYTES = 2 * NW * 128;  // one (chunk, tap) of weights
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* slabs = base;                           // [SLABS][slab]
  unsigned char* wring = base + SLABS * p.slab_bytes;    // [W][2NW][128]
  unsigned char* staging = wring + p.wstages * WST_BYTES;  // 2 x Staging
  Bars& bars = *reinterpret_cast<Bars*>(staging + 2 * BM * NW * 2);
  const int nchunk = (p.C + 63) / 64;
  const int ntiles = p.nct * p.npt * p.nft * p.B;
  const int W = p.wstages, P = p.P, F = p.F;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < SLABS; ++s) {
      mbar_init(&bars.slab_full[s], 1);
      mbar_init(&bars.slab_empty[s], 8);   // lane 0 of each consumer warp
    }
    for (int s = 0; s < W; ++s) {
      mbar_init(&bars.w_full[s], 1);
      mbar_init(&bars.w_empty[s], 8);
    }
    mbar_init(&bars.res_full[0], 1);
    mbar_init(&bars.res_full[1], 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producers: lane 0 of warp 0 issues the slabs, lane 0 of warp 1 the
    // weights, each through its own ring, so that neither waits behind
    // the other (the consumers wait for slab k+1 before they release the
    // weight stages of chunk k)
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      const uint32_t slab_tx = 64 * 2 * P * (p.FT + 2);
      int k = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const Tile tl = tile_of(p, t, NW);
        for (int kc = 0; kc < nchunk; ++kc, ++k) {
          const int s = k % SLABS;
          mbar_wait(&bars.slab_empty[s], ((k / SLABS) & 1) ^ 1);
          mbar_expect_tx(&bars.slab_full[s], slab_tx);
          tma_load_4d(slabs + s * p.slab_bytes, &tx, &bars.slab_full[s],
                      kc * 64, tl.n0, tl.f0 - 1, tl.b);
        }
      }
    } else if (threadIdx.x == 32) {
      int i = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const Tile tl = tile_of(p, t, NW);
        for (int kc = 0; kc < nchunk; ++kc)
          for (int tap = 0; tap < 3; ++tap, ++i) {
            const int ws = i % W;
            mbar_wait(&bars.w_empty[ws], ((i / W) & 1) ^ 1);
            mbar_expect_tx(&bars.w_full[ws], WST_BYTES);
            unsigned char* dst = wring + ws * WST_BYTES;
            tma_load_3d(dst, &tw, &bars.w_full[ws], kc * 64, tl.col0, tap);
            tma_load_3d(dst + NW * 128, &tw, &bars.w_full[ws], kc * 64,
                        tl.col0 + NW, tap);
          }
      }
    }
    return;
  }

  // consumers: warpgroup c owns columns col0 + c*NW .. + NW-1 of a tile
  reg_alloc<CONSUMER_REGS>();
  const int c = wg - 1;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  using St = Staging<NW>;
  const int rows = p.FT * P;                   // <= BM
  unsigned char* stage = staging + c * BM * NW * 2;

  // the transform: consumer thread ct keeps 16-byte slot ct % 8 of slab
  // rows ct / 8 + 32 u; under the swizzle that slot holds channel group
  // slot ^ (row % 8), the same for all of the thread's rows
  const int ct = threadIdx.x - 128, slot = ct & 7, r0 = ct >> 3;
  const int grp = slot ^ (r0 & 7);
  const int srows = (p.FT + 2) * P;            // rows a slab holds
  const int urows = (srows + 31) / 32;         // rows a thread, at most
  float av[8], bv[8];
  bool cin = false;
  Tile xt{};                                   // the tile being transformed
  int xk = 0;                                  // its chunk
  auto coeffs = [&]() {                        // GN (a, b) of the chunk
    const int cc = xk * 64 + 8 * grp;
    cin = cc < p.C;
    if (cin) {
      load8(av, p.ga + (long long)xt.b * p.C + cc);
      load8(bv, p.gb + (long long)xt.b * p.C + cc);
    }
  };
  // rows u0 .. u1-1 of this thread in slab s: GN apply + SiLU, or zeros
  // outside [0, F) (channels past C read as zero and stay zero)
  auto transform = [&](int s, int u0, int u1) {
    unsigned char* slab = slabs + s * p.slab_bytes;
    for (int u = u0; u < u1; ++u) {
      const int r = r0 + 32 * u;
      if (r >= srows) break;
      const int fr = xt.f0 - 1 + r / P;
      uint4* vp = reinterpret_cast<uint4*>(slab + r * 128 + slot * 16);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (fr >= 0 && fr < F && cin) {
        v = *vp;
        bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          e[j] = __float2bfloat16(
              silu_f(fmaf(__bfloat162float(e[j]), av[j], bv[j])));
      }
      *vp = v;
    }
  };

  float acc[2][NW / 2];
  auto fence_acc = [&]() {
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) fence_reg(acc[mb][i]);
  };
  auto release = [&](int i) {   // step i's products have retired
    if (lane == 0) {
      mbar_arrive(&bars.w_empty[i % W]);
      if (i % 3 == 2) mbar_arrive(&bars.slab_empty[(i / 3) % SLABS]);
    }
  };
  // the first chunk, before any product
  if ((int)blockIdx.x < ntiles) {
    xt = tile_of(p, blockIdx.x, NW);
    coeffs();
    mbar_wait(&bars.slab_full[0], 0);
    transform(0, 0, urows);
    fence_proxy_async();
    bar_sync(BAR_CONS, 256);
  }
  int i = 0, n = 0;             // steps and tiles so far
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x, ++n) {
    const Tile tl = tile_of(p, t, NW);
    const int cg0 = tl.col0 + c * NW;
    // the staging tile is free: its last store was read before the
    // group's barrier that ended the previous tile
    if (p.has_res && tid == 0) {
      mbar_expect_tx(&bars.res_full[c], rows * NW * 2);
      for (int u = 0; u < NW / St::BW; ++u)
        tma_load_4d(stage + u * St::SUB, &tres, &bars.res_full[c],
                    cg0 + u * St::BW, tl.n0, tl.f0, tl.b);
    }
    for (int kc = 0; kc < nchunk; ++kc) {
      const int k = i / 3, s = k % SLABS, s1 = (k + 1) % SLABS;
      // the next chunk: this tile's, or the next tile's first
      const bool more = kc + 1 < nchunk || t + (int)gridDim.x < ntiles;
      if (more) {
        if (kc + 1 < nchunk) {
          xk = kc + 1;
        } else {
          xt = tile_of(p, t + gridDim.x, NW);
          xk = 0;
        }
        coeffs();
      }
      unsigned char* slab = slabs + s * p.slab_bytes;
      for (int tap = 0; tap < 3; ++tap, ++i) {
        const int ws = i % W;
        mbar_wait(&bars.w_full[ws], (i / W) & 1);
        const uint64_t da = desc_sw128(slab + tap * P * 128, 16, 1024);
        const uint64_t db =
            desc_sw128(wring + ws * WST_BYTES + c * NW * 128, 16, 1024);
        fence_acc();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int sc = (kc | tap | kk) != 0;
          wgmma_ss<NW, 0, 0>(acc[0], da + 2 * kk, db + 2 * kk, sc);
          wgmma_ss<NW, 0, 0>(acc[1], da + (64 * 128 >> 4) + 2 * kk,
                             db + 2 * kk, sc);
        }
        wgmma_commit();
        if (more) {   // a third of the next chunk under these products
          if (tap == 0) mbar_wait(&bars.slab_full[s1], ((k + 1) / SLABS) & 1);
          transform(s1, urows * tap / 3, urows * (tap + 1) / 3);
        }
        wgmma_wait<1>();
        fence_acc();
        if (kc | tap) release(i - 1);
      }
      if (more) {     // the next chunk is activated, by both groups
        fence_proxy_async();
        bar_sync(BAR_CONS, 256);
      }
    }
    wgmma_wait<0>();
    fence_acc();
    release(i - 1);

    // epilogue
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int cc = cg0 + 8 * j + 2 * t4;
      const float b0 = cc < p.Cout ? p.bias[cc] : 0.f;
      const float b1 = cc + 1 < p.Cout ? p.bias[cc + 1] : 0.f;
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
        acc[mb][4 * j] += b0;
        acc[mb][4 * j + 1] += b1;
        acc[mb][4 * j + 2] += b0;
        acc[mb][4 * j + 3] += b1;
      }
    }
    if (p.has_res) mbar_wait(&bars.res_full[c], n & 1);
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mb * 64 + warp * 16 + g + 8 * h;
        if (r >= rows) continue;
#pragma unroll
        for (int j = 0; j < NW / 8; ++j) {
          __nv_bfloat162* sp = reinterpret_cast<__nv_bfloat162*>(
              stage + St::at(r, 8 * j + 2 * t4));
          __nv_bfloat162 v = __floats2bfloat162_rn(
              acc[mb][4 * j + 2 * h], acc[mb][4 * j + 2 * h + 1]);
          if (p.has_res) {
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
      for (int u = 0; u < NW / St::BW; ++u)
        tma_store_4d(&tout, stage + u * St::SUB, cg0 + u * St::BW, tl.n0,
                     tl.f0, tl.b);
    if (p.want_stats && 2 * tid < NW && cg0 + 2 * tid < p.Cout) {
      // columns 2 tid and + 1: the valid rows are the first min(P, N - n0)
      // pixels of each of the first min(FT, F - f0) frames; bf16x2 reads
      const int col = 2 * tid;
      const int pmax = min(P, p.N - tl.n0), fmax = min(p.FT, F - tl.f0);
      const long long row0 = p.per_frame ? (long long)tl.b * F + tl.f0 : tl.b;
      float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
      for (int f = 0; f < fmax; ++f) {
#pragma unroll 8
        for (int pp = 0; pp < pmax; ++pp) {
          const float2 v = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  stage + St::at(f * P + pp, col)));
          s0 += v.x;
          s1 += v.y;
          q0 = fmaf(v.x, v.x, q0);
          q1 = fmaf(v.y, v.y, q1);
        }
        if (p.per_frame || f == fmax - 1) {
          const long long o = (row0 + (p.per_frame ? f : 0)) * p.Cout + cg0
                              + col;
          atomicAdd(p.ssum + o, s0);
          atomicAdd(p.ssum + o + 1, s1);
          atomicAdd(p.ssq + o, q0);
          atomicAdd(p.ssq + o + 1, q1);
          s0 = s1 = q0 = q1 = 0.f;
        }
      }
    }
    if (tid == 0) bulk_wait_read<0>();      // the store has read the tile
    bar_sync(BAR_EPI + c, 128);              // and so have the statistics
  }
}

namespace {
template <int NW>
int launch_k5(const CUtensorMap& tx, const CUtensorMap& tw,
              const CUtensorMap& tres, const CUtensorMap& tout,
              const k5::Params& p, int grid, int smem, cudaStream_t stream) {
  fused_tconv3_sm90<NW><<<grid, k5::THREADS, smem, stream>>>(tx, tw, tres,
                                                             tout, p);
  return (int)cudaGetLastError();
}

template <int NW>
cudaError_t set_smem_k5(int smem) {
  return cudaFuncSetAttribute(fused_tconv3_sm90<NW>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}
}  // namespace

// x [B,F,N,C] bf16; a, b [B,C] fp32; wt [3,Cout,C] bf16 (K-major taps);
// bias [Cout] fp32; residual [B,F,N,Cout] bf16 or null; out [B,F,N,Cout]
// bf16; sum/sumsq [B or B*F, Cout] fp32 zeroed by the caller (ignored
// without want_stats). P pixels and FT frames a tile, NW columns a consumer
// group, the slab's bytes, the weight ring's depth, the persistent grid
// and the shared memory from `tconv3_launch_plan`. Requires C and Cout
// multiples of 8 (16-byte rows), P a multiple of 8, FT*P <= 128.
extern "C" int star_fused_gn_silu_tconv3(
    const void* x, const void* a, const void* b, const void* wt,
    const void* bias, const void* residual, void* out, void* ssum, void* ssq,
    int B, int F, int N, int C, int Cout, int want_stats, int per_frame,
    int P, int FT, int NW, int slab_bytes, int wstages, int grid, int smem,
    void* stream) {
  using namespace k5;
  if (B < 1 || F < 1 || N < 1 || C < 8 || Cout < 8 || C % 8 || Cout % 8 ||
      P < 8 || P % 8 || P > 64 || FT < 1 || FT * P > BM ||
      slab_bytes % 1024 || slab_bytes < (2 * P + BM) * 128 || wstages < 2 ||
      wstages > MAX_WSTAGES || grid < 1 || smem > 232448 ||
      smem < 1024 + SLABS * slab_bytes + (wstages + 2) * 256 * NW + 256)
    return (int)cudaErrorInvalidValue;
  const void* ptr[3] = {x, wt, out};
  for (const void* q : ptr)
    if ((uintptr_t)q % 16) return (int)cudaErrorInvalidValue;
  // a runtime call before the driver's tensor-map encoder binds this host
  // thread to the device's context (autograd runs on its own thread)
  cudaError_t err;
  switch (NW) {
    case 16: err = set_smem_k5<16>(smem); break;
    case 32: err = set_smem_k5<32>(smem); break;
    case 64: err = set_smem_k5<64>(smem); break;
    case 128: err = set_smem_k5<128>(smem); break;
    case 160: err = set_smem_k5<160>(smem); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const uint64_t xd[4] = {(uint64_t)C, (uint64_t)N, (uint64_t)F, (uint64_t)B};
  const uint64_t xs[3] = {(uint64_t)C * 2, (uint64_t)N * C * 2,
                          (uint64_t)F * N * C * 2};
  const uint32_t xb[4] = {64, (uint32_t)P, (uint32_t)(FT + 2), 1};
  const uint64_t wd[3] = {(uint64_t)C, (uint64_t)Cout, 3};
  const uint64_t ws[2] = {(uint64_t)C * 2, (uint64_t)Cout * C * 2};
  const uint32_t wb[3] = {64, (uint32_t)NW, 1};
  const uint64_t od[4] = {(uint64_t)Cout, (uint64_t)N, (uint64_t)F,
                          (uint64_t)B};
  const uint64_t os[3] = {(uint64_t)Cout * 2, (uint64_t)N * Cout * 2,
                          (uint64_t)F * N * Cout * 2};
  const int bw = NW % 64 == 0 ? 64 : NW % 32 == 0 ? 32 : 16;  // Staging
  const uint32_t ob[4] = {(uint32_t)bw, (uint32_t)P, (uint32_t)FT, 1};
  CUtensorMap tx, tw, tres, tout;
  if (!sm90::encode_bf16(&tx, x, 4, xd, xs, xb, 128) ||
      !sm90::encode_bf16(&tw, wt, 3, wd, ws, wb, 128) ||
      !sm90::encode_bf16(&tout, out, 4, od, os, ob, 2 * bw) ||
      !sm90::encode_bf16(&tres, residual ? residual : out, 4, od, os, ob,
                         2 * bw))
    return (int)cudaErrorInvalidValue;
  k5::Params p{(const float*)a, (const float*)b, (const float*)bias,
               (float*)ssum, (float*)ssq, B, F, N, C, Cout, P, FT,
               (Cout + 2 * NW - 1) / (2 * NW), (N + P - 1) / P,
               (F + FT - 1) / FT, residual != nullptr, want_stats, per_frame,
               slab_bytes, wstages};
  if ((long long)p.nct * p.npt * p.nft * B > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (NW) {
    case 16: return launch_k5<16>(tx, tw, tres, tout, p, grid, smem, st);
    case 32: return launch_k5<32>(tx, tw, tres, tout, p, grid, smem, st);
    case 64: return launch_k5<64>(tx, tw, tres, tout, p, grid, smem, st);
    case 128:
      return launch_k5<128>(tx, tw, tres, tout, p, grid, smem, st);
    default: return launch_k5<160>(tx, tw, tres, tout, p, grid, smem, st);
  }
}
