// Implicit-GEMM convolution over a staged halo patch for K7
// (csrc/upsample_conv.cu: one phase of nearest-2x + 3x3 conv, 4 taps).
//
// A block owns an 8x16 patch of one image (M = 128 pixels) and 128 output
// channels (N). The reduction runs over K = taps x C in chunks of 32
// channels: for each chunk the (8+2) x (16+2) halo patch of x is copied to
// shared memory with cp.async (positions outside the image are not read),
// copied into the bf16 operand tile with ZEROS at positions outside the
// image (the SAME padding of the upsampled grid). Each tap is then a
// shifted view of that tile: the A fragments of tap (ty, tx) are ldmatrix
// loads at halo row (i + ty, j + tx), so x is read once per chunk and
// output-channel tile, not once per tap. The weight slab of each (chunk,
// tap) — [128 Cout][32 C], K contiguous — streams through a three-stage
// cp.async ring; the halo of the next chunk is copied during the first
// tap of the current one and moved into place after its last, into the
// other of two halo buffers.
// 8 warps of 32x64 run mma.sync m16n8k16 (bf16 in, fp32 accumulate), two
// blocks per SM. Neither a 16x16 patch with 16 warps (half the weight
// traffic from L2) nor 64x64 warp tiles (two thirds of the ldmatrix bytes
// per MMA) changed the time by more than 4% on the H100, so the simplest
// of the three stays.
//
// Epilogue: acc + fp32 bias, rounded once to bf16, staged in shared memory;
// then one 16-byte vector per thread: store, and the
// fp32 (sum, sumsq) of the stored values per output channel, reduced over
// the block (shuffles, then shared atomics) and added with one atomicAdd
// per (block, channel) into the caller's zeroed [N, Cout] buffers. A tile
// never crosses an image, so each block adds to one statistics row. The
// order of those atomic adds varies between runs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace conv_tile {

typedef __nv_bfloat16 bf16;

constexpr int TH = 8, TW = 16;          // output patch (small grid for K7)
constexpr int BM = TH * TW;             // 128 pixels
constexpr int BN = 128, BK = 32;
constexpr int MT = 2, NT = 8;           // warp tile: MT x 16 rows, NT x 8 cols
constexpr int WARPS_M = BM / (16 * MT), WARPS_N = BN / (8 * NT);
constexpr int THREADS = 32 * WARPS_M * WARPS_N;            // 256
constexpr int HH = TH + 2, HW = TW + 2, HPIX = HH * HW;  // 180 halo pixels
constexpr int AP = BK + 8;  // 80-byte operand rows: ldmatrix hits 8 banks
constexpr int BP = BK + 8;  // likewise for the weight rows
constexpr int OP = BN + 8;  // 272-byte rows of the bf16 output stage
constexpr int HALO_ELEMS = HPIX * AP;
constexpr int RAW_ELEMS = HPIX * BK;
constexpr int W_ELEMS = BN * BP;
constexpr int WSTAGES = 3;
constexpr int HVEC = HPIX * (BK / 8);                      // 720 vectors
constexpr int HV_PER_THREAD = (HVEC + THREADS - 1) / THREADS;  // 3
constexpr int WV_PER_THREAD = BN * (BK / 8) / THREADS;         // 2
constexpr int MAIN_BYTES =
    (2 * HALO_ELEMS + RAW_ELEMS + WSTAGES * W_ELEMS) * 2;   // 71,040
constexpr int OUT_BYTES = BM * OP * 2 + 2 * BN * 4;          // 35,840
constexpr int SMEM_BYTES = MAIN_BYTES > OUT_BYTES ? MAIN_BYTES : OUT_BYTES;
// a 16-row MMA fragment is one patch row; warp row wm owns patch rows
// wm*MT .. wm*MT + MT-1
static_assert(TW == 16 && WARPS_M * MT == TH, "patch / warp layout");
static_assert(THREADS % 4 == 0 && BN * (BK / 8) % THREADS == 0, "loaders");

constexpr int NTAPS = 4;                 // a 2x2 window a phase

struct Args {
  const bf16* x;      // [N, H, W, C]
  const bf16* w;      // [4 phases, Cout, 4 taps, C]
  const float* bias;  // [Cout]
  bf16* out;          // [N, 2H, 2W, Cout]
  float* ssum;        // [N, Cout], zeroed by the caller
  float* ssq;
  int N, H, W, C, Cout, want_stats;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col); bf16 in, fp32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// phase (r, s) = blockIdx-derived, tap t = (p, q) reads halo offset
// (p + r, q + s), output at (2i + r, 2j + s)
__global__ void __launch_bounds__(THREADS, 2) conv_tile_kernel(Args p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sHalo = reinterpret_cast<bf16*>(smem);  // [2][HPIX][AP]
  bf16* sRaw = sHalo + 2 * HALO_ELEMS;           // [HPIX][BK]
  bf16* sW = sRaw + RAW_ELEMS;                   // [WSTAGES][BN][BP]

  const int C = p.C, Cout = p.Cout, H = p.H, W = p.W;
  const int nct = Cout / BN;
  const int tilesW = (W + TW - 1) / TW, tilesH = (H + TH - 1) / TH;
  int bid = blockIdx.x;
  const int ct = bid % nct;
  bid /= nct;
  const int phase = bid & 3;
  bid >>= 2;
  const int tw = bid % tilesW;
  bid /= tilesW;
  const int th = bid % tilesH;
  const int n = bid / tilesH;
  const int h0 = th * TH, w0 = tw * TW, n0 = ct * BN;
  const int pr = phase >> 1, ps = phase & 1;
  const long long KS = (long long)NTAPS * C;  // weight row length
  const bf16* wbase = p.w + (long long)phase * Cout * KS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int lm = lane >> 3, lr = lane & 7;  // ldmatrix matrix / row
  const int g = lane >> 2, t4 = lane & 3;   // mma fragment row / pair

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // halo vectors of this thread: the channel offset is the same for all
  // of them (THREADS is a multiple of the 4 vectors of a pixel)
  const int hcv = (tid & 3) * 8;
  auto halo_in = [&](int u, int& ih, int& iw) {
    const int v = tid + u * THREADS;
    const int pos = v >> 2;
    ih = h0 + pos / HW - 1;
    iw = w0 + pos % HW - 1;
    return v < HVEC && ih >= 0 && ih < H && iw >= 0 && iw < W;
  };
  auto issue_raw = [&](int cc) {
#pragma unroll
    for (int u = 0; u < HV_PER_THREAD; ++u) {
      int ih, iw;
      if (halo_in(u, ih, iw)) {
        const int pos = (tid + u * THREADS) >> 2;
        cp_async16(sRaw + pos * BK + hcv,
                   p.x + (((long long)n * H + ih) * W + iw) * C + cc * BK +
                       hcv);
      }
    }
  };
  // raw chunk -> operand tile: each thread copies the vectors it loaded
  // (its own cp.async writes are visible to it after the wait)
  auto transform = [&](int buf) {
#pragma unroll
    for (int u = 0; u < HV_PER_THREAD; ++u) {
      const int v = tid + u * THREADS;
      if (v >= HVEC) continue;
      const int pos = v >> 2;
      int ih, iw;
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);  // SAME zero pad
      if (halo_in(u, ih, iw))
        packed = *reinterpret_cast<const uint4*>(sRaw + pos * BK + hcv);
      *reinterpret_cast<uint4*>(sHalo + buf * HALO_ELEMS + pos * AP + hcv) =
          packed;
    }
  };
  auto issue_w = [&](int kt, int stage) {
    const int cc = kt / NTAPS, t = kt - cc * NTAPS;
#pragma unroll
    for (int u = 0; u < WV_PER_THREAD; ++u) {
      const int i = tid + u * THREADS;
      const int row = i >> 2, kv = (i & 3) * 8;
      cp_async16(sW + stage * W_ELEMS + row * BP + kv,
                 wbase + (long long)(n0 + row) * KS + (long long)t * C +
                     cc * BK + kv);
    }
  };

  const int nchunk = C / BK;
  const int KT = nchunk * NTAPS;
  issue_raw(0);
  issue_w(0, 0);
  cp_commit();
  if (KT > 1) issue_w(1, 1);
  cp_commit();
  cp_wait<1>();
  transform(0);

  for (int kt = 0; kt < KT; ++kt) {
    // groups 0..kt have landed; after the barrier every thread is done
    // with step kt-1, so its weight stage and the other halo may be reused
    cp_wait<1>();
    __syncthreads();
    const int cc = kt / NTAPS, t = kt - cc * NTAPS;
    if (kt + 2 < KT) issue_w(kt + 2, (kt + 2) % WSTAGES);
    if (t == 0 && cc + 1 < nchunk) issue_raw(cc + 1);
    cp_commit();

    const int ty = (t >> 1) + pr, tx = (t & 1) + ps;
    const bf16* cA = sHalo + (cc & 1) * HALO_ELEMS;
    const bf16* cB = sW + (kt % WSTAGES) * W_ELEMS;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // pixel (li, lj) = (wm*MT + mt, lr + (lm&1)*8) reads halo
        // (li + ty, lj + tx)
        const int hp = (wm * MT + mt + ty) * HW + lr + (lm & 1) * 8 + tx;
        ldsm_x4(af[mt], cA + hp * AP + ks * 16 + (lm >> 1) * 8);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bfr[4];
        ldsm_x4(bfr, cB + (wn * NT * 8 + np * 16 + (lm >> 1) * 8 + lr) * BP +
                         ks * 16 + (lm & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(acc[mt][2 * np], af[mt], bfr[0], bfr[1]);
          mma(acc[mt][2 * np + 1], af[mt], bfr[2], bfr[3]);
        }
      }
    }
    if (t == NTAPS - 1 && cc + 1 < nchunk) transform((cc + 1) & 1);
  }
  cp_wait<0>();
  __syncthreads();

  // epilogue 1: acc + bias, rounded once, staged as bf16 [BM][OP]
  bf16* sO = reinterpret_cast<bf16*>(smem);
  float* sRed = reinterpret_cast<float*>(smem + BM * OP * 2);  // [2][BN]
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int cl = wn * NT * 8 + nt * 8 + 2 * t4;
    const float b0 = p.bias[n0 + cl], b1 = p.bias[n0 + cl + 1];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = (wm * MT + mt) * 16 + g;
      *reinterpret_cast<__nv_bfloat162*>(sO + r * OP + cl) =
          __floats2bfloat162_rn(acc[mt][nt][0] + b0, acc[mt][nt][1] + b1);
      *reinterpret_cast<__nv_bfloat162*>(sO + (r + 8) * OP + cl) =
          __floats2bfloat162_rn(acc[mt][nt][2] + b0, acc[mt][nt][3] + b1);
    }
  }
  for (int i = tid; i < 2 * BN; i += THREADS) sRed[i] = 0.f;
  __syncthreads();

  // epilogue 2: one 16-byte vector of one pixel per thread and pass; the
  // channel vector is fixed per thread, the pixel advances by THREADS/16
  const int cv = (tid & 15) * 8;
  float s[8], s2[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) s[e] = s2[e] = 0.f;
  const int OH = 2 * H, OW = 2 * W;
#pragma unroll 2
  for (int u = 0; u < BM * 16 / THREADS; ++u) {
    const int m = (tid >> 4) + u * (THREADS / 16);
    const int ih = h0 + (m >> 4), iw = w0 + (m & 15);
    if (ih >= H || iw >= W) continue;
    const int oh = 2 * ih + pr, ow = 2 * iw + ps;
    const long long o = (((long long)n * OH + oh) * OW + ow) * Cout + n0 + cv;
    uint4 vec = *reinterpret_cast<const uint4*>(sO + m * OP + cv);
    const bf16* vv = reinterpret_cast<const bf16*>(&vec);
    *reinterpret_cast<uint4*>(p.out + o) = vec;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float f = __bfloat162float(vv[e]);
      s[e] += f;
      s2[e] += f * f;
    }
  }
  if (!p.want_stats) return;
  // lanes l and l^16 hold the same channel vector
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    s[e] += __shfl_xor_sync(0xffffffffu, s[e], 16);
    s2[e] += __shfl_xor_sync(0xffffffffu, s2[e], 16);
  }
  if (lane < 16) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      atomicAdd(sRed + cv + e, s[e]);
      atomicAdd(sRed + BN + cv + e, s2[e]);
    }
  }
  __syncthreads();
  for (int i = tid; i < BN; i += THREADS) {
    atomicAdd(p.ssum + (long long)n * Cout + n0 + i, sRed[i]);
    atomicAdd(p.ssq + (long long)n * Cout + n0 + i, sRed[BN + i]);
  }
}

// One launch over every (image, patch, phase, Cout tile); Cout tiles vary
// fastest so the blocks that share a halo patch run together.
inline int launch(const Args& a, cudaStream_t stream) {
  if (a.C % BK != 0 || a.Cout % BN != 0 || a.N <= 0 || a.H <= 0 ||
      a.W <= 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)a.N * ((a.H + TH - 1) / TH) *
                           ((a.W + TW - 1) / TW) * 4 *
                           (a.Cout / BN);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      conv_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  conv_tile_kernel<<<(unsigned)blocks, THREADS, SMEM_BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace conv_tile
