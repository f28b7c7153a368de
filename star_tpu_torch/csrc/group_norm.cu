// GroupNorm on channels-last tensors for Hopper (sm_90a): K13 of the port.
//
// Replaces no TPU kernel: in the JAX package XLA fuses GroupNorm and the
// SiLU after it (star_tpu/models/unet/blocks.py:419-427). Eager PyTorch ran
// `ops/norms.group_norm_plain` as eight passes over the activation (a bf16
// mean, an fp32 cast, square and mean, three broadcast bf16 passes for the
// apply) and the SiLU as three more (cast, fp32 SiLU, cast back): about 52
// bytes of traffic a value. K13 is two streaming passes, 6 bytes a value.
// For x [N, R, C] bf16 (statistics pooled over R and over each group of
// C / G channels, per n):
//
// star_gn_stats: fp32 sum and sum of squares per (n, channel) [N, C], the
//   contract of `ops/conv3x3.channel_stats`; asked for a GroupNorm, the
//   groups folded with group_norm_plain's own arithmetic
//     mean = s / count, mean2 = s2 / count (count = R * C / G)
//     inv  = rsqrt(mean2 - mean^2 + eps), a = inv * scale       (fp32)
//   into the apply's bf16 per-(n, channel) coefficients mean, a and bias.
// star_gn_apply: y = bf16(bf16(bf16(x - mean) * a) + bias), the
//   subtract-first form rounded as the eager bf16 ops round it, then with
//   `silu` bf16(v / (1 + expf(-v))) on v = float(y), PyTorch's CUDA SiLU in
//   fp32 rounded once (`F.silu(y.float()).to(bf16)`).
//
// What bounds it on the H100: bytes. A value takes a few FLOPs (about 20
// with the SiLU) for 2 bytes read by the statistics and 4 moved by the
// apply, far below the card's balance.
// The apply runs on bf16 pairs (sub, mul, add of bf16x2, each rounded once,
// which is what the eager fp32 arithmetic of bf16 operands rounds to), and
// only the SiLU in fp32.
// Design: both kernels share one layout. A block is k row lanes of V = C/8
// threads (k = about 256 / V, so 128 to 1024 threads whatever C), thread
// (j, v) owning the 16-byte vector of channels 8v..8v+7 in rows
// j, j + k, ... of its slab of rows, four rows in flight at a time; a warp
// reads contiguous runs of a row. Each thread keeps its 8 channels' sums
// (or its 8 channels' coefficients) in registers, so group widths from 4
// channels (C = 128) to 80 (C = 2560) need no alignment with the vectors:
// the statistics accumulate per channel and the groups fold afterwards.
// The grid is (slabs, N), the slabs sized so that one wave of the
// kernel's resident blocks fills every SM, none left for a second wave,
// whether N is 1 with R = 8.6e6 (the causal VAE) or N is 16 with R = 14400
// (the UNet). The reduction is deterministic: each thread sums its rows
// in order (four at a time, pairwise, before they join its running sums),
// the block's lanes are summed in lane order through shared memory into
// per-slab partials [N, slabs, 2, C], and a second kernel, a block for
// each tile of whole groups of an n, sums the slabs in a fixed order and
// folds the groups. No float atomics, so two runs give the same bits.
// Any N and R; C a multiple of 8 up to 8192; x 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

namespace {

constexpr int kFoldThreads = 1024;
constexpr int kMaxVectors = 1024;   // C <= 8192

__device__ __forceinline__ void accumulate(const uint4& xv, float* s,
                                           float* q) {
  const bf162* x2 = reinterpret_cast<const bf162*>(&xv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(x2[i]);
    s[2 * i] += f.x;
    s[2 * i + 1] += f.y;
    q[2 * i] = fmaf(f.x, f.x, q[2 * i]);
    q[2 * i + 1] = fmaf(f.y, f.y, q[2 * i + 1]);
  }
}

// four rows summed pairwise before they join the running sums, which
// keeps the fp32 rounding error of a thread's sums that of a quarter as
// many additions
__device__ __forceinline__ void accumulate4(const uint4& v0, const uint4& v1,
                                            const uint4& v2, const uint4& v3,
                                            float* s, float* q) {
  const bf162* x0 = reinterpret_cast<const bf162*>(&v0);
  const bf162* x1 = reinterpret_cast<const bf162*>(&v1);
  const bf162* x2 = reinterpret_cast<const bf162*>(&v2);
  const bf162* x3 = reinterpret_cast<const bf162*>(&v3);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f0 = __bfloat1622float2(x0[i]);
    const float2 f1 = __bfloat1622float2(x1[i]);
    const float2 f2 = __bfloat1622float2(x2[i]);
    const float2 f3 = __bfloat1622float2(x3[i]);
    s[2 * i] += (f0.x + f1.x) + (f2.x + f3.x);
    s[2 * i + 1] += (f0.y + f1.y) + (f2.y + f3.y);
    q[2 * i] += fmaf(f0.x, f0.x, f1.x * f1.x) + fmaf(f2.x, f2.x, f3.x * f3.x);
    q[2 * i + 1] +=
        fmaf(f0.y, f0.y, f1.y * f1.y) + fmaf(f2.y, f2.y, f3.y * f3.y);
  }
}

// per-slab partial sums: grid (slabs, N), block V * k threads, dynamic
// shared memory 2 * k * C floats when k > 1
__global__ void gn_partials_kernel(const uint4* __restrict__ x,
                                   float* __restrict__ part, long long rows,
                                   int nv, int k, long long slab_rows) {
  const int n = blockIdx.y, slab = blockIdx.x, slabs = gridDim.x;
  const int v = threadIdx.x % nv, j = threadIdx.x / nv;
  const int c = nv * 8;
  const long long r0 = (long long)slab * slab_rows;
  const long long r1 = min(rows, r0 + slab_rows);
  const uint4* xn = x + (size_t)n * rows * nv + v;
  float s[8], q[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = q[i] = 0.f;
  long long r = r0 + j;
  for (; r + 3 * k < r1; r += 4 * k) {
    const uint4 a0 = xn[(size_t)r * nv];
    const uint4 a1 = xn[(size_t)(r + k) * nv];
    const uint4 a2 = xn[(size_t)(r + 2 * k) * nv];
    const uint4 a3 = xn[(size_t)(r + 3 * k) * nv];
    accumulate4(a0, a1, a2, a3, s, q);
  }
  for (; r < r1; r += k) accumulate(xn[(size_t)r * nv], s, q);
  if (k > 1) {
    extern __shared__ float lanes[];   // [2][k][C]
    float* ls = lanes + j * c + v * 8;
    float* lq = lanes + (k + j) * c + v * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      ls[i] = s[i];
      lq[i] = q[i];
    }
    __syncthreads();
    if (j != 0) return;
    for (int jj = 1; jj < k; ++jj) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s[i] += lanes[jj * c + v * 8 + i];
        q[i] += lanes[(k + jj) * c + v * 8 + i];
      }
    }
  }
  float4* ps = reinterpret_cast<float4*>(
      part + ((size_t)(n * slabs + slab) * 2) * c + v * 8);
  float4* pq = reinterpret_cast<float4*>(
      part + ((size_t)(n * slabs + slab) * 2 + 1) * c + v * 8);
  ps[0] = make_float4(s[0], s[1], s[2], s[3]);
  ps[1] = make_float4(s[4], s[5], s[6], s[7]);
  pq[0] = make_float4(q[0], q[1], q[2], q[3]);
  pq[1] = make_float4(q[4], q[5], q[6], q[7]);
}

__device__ __forceinline__ float load_param(const void* p, int i,
                                            bool pbf) {
  return pbf ? __bfloat162float(reinterpret_cast<const bf16*>(p)[i])
             : reinterpret_cast<const float*>(p)[i];
}

// The slabs' partials summed in a fixed order, for a tile of channels of
// one n: grid (C / tile, N), block tile * lanes threads, lane l summing
// slabs l, l + lanes, ... (into four running sums, so that four loads
// are in flight), then the lanes in order through shared memory. Without
// mean_out the sums go to sum, sumsq [N, C]; with it the tile holds whole
// groups of gw channels, which are folded into the apply's bf16 mean, a
// and bias [N, C] (scale and bias read as bf16 or fp32).
__global__ void __launch_bounds__(kFoldThreads)
gn_fold_kernel(const float* __restrict__ part, int slabs, int c, int gw,
               int tile, int lanes, float count, float eps,
               const void* __restrict__ scale, const void* __restrict__ bias,
               int params_bf16, float* __restrict__ sum,
               float* __restrict__ sumsq, bf16* __restrict__ mean_out,
               bf16* __restrict__ a_out, bf16* __restrict__ b_out) {
  extern __shared__ float fold[];   // [2][lanes][tile], then [2][tile]
  float* tot = fold + 2 * lanes * tile;
  const int n = blockIdx.y, c0 = blockIdx.x * tile, t = threadIdx.x;
  const int cl = t % tile, lane = t / tile, ch = c0 + cl;
  const bool live = lane < lanes && ch < c;
  const float* pn = part + (size_t)n * slabs * 2 * c + ch;
  float s4[4] = {0.f, 0.f, 0.f, 0.f}, q4[4] = {0.f, 0.f, 0.f, 0.f};
  if (live) {
    int sl = lane;
    for (; sl + 3 * lanes < slabs; sl += 4 * lanes) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        s4[u] += pn[(size_t)(sl + u * lanes) * 2 * c];
        q4[u] += pn[(size_t)(sl + u * lanes) * 2 * c + c];
      }
    }
    for (int u = 0; sl < slabs; sl += lanes, ++u) {
      s4[u] += pn[(size_t)sl * 2 * c];
      q4[u] += pn[(size_t)sl * 2 * c + c];
    }
  }
  if (lane < lanes) {
    fold[lane * tile + cl] = (s4[0] + s4[1]) + (s4[2] + s4[3]);
    fold[(lanes + lane) * tile + cl] = (q4[0] + q4[1]) + (q4[2] + q4[3]);
  }
  __syncthreads();
  if (lane == 0) {
    float s = fold[cl], q = fold[lanes * tile + cl];
    for (int l = 1; l < lanes; ++l) {
      s += fold[l * tile + cl];
      q += fold[(lanes + l) * tile + cl];
    }
    tot[cl] = s;
    tot[tile + cl] = q;
    if (mean_out == nullptr && ch < c) {
      sum[(size_t)n * c + ch] = s;
      sumsq[(size_t)n * c + ch] = q;
    }
  }
  if (mean_out == nullptr) return;
  __syncthreads();
  if (lane != 0 || ch >= c) return;
  // each channel folds its own group's sums, in the group's channel order
  const int g0 = cl - cl % gw;
  float s = 0.f, q = 0.f;
  for (int i = 0; i < gw; ++i) {
    s += tot[g0 + i];
    q += tot[tile + g0 + i];
  }
  // group_norm_plain's order, each step rounded (no contraction)
  const float mean = __fdiv_rn(s, count);
  const float mean2 = __fdiv_rn(q, count);
  const float var = __fsub_rn(mean2, __fmul_rn(mean, mean));
  const float inv = rsqrtf(__fadd_rn(var, eps));
  const bool pbf = params_bf16 != 0;
  mean_out[(size_t)n * c + ch] = __float2bfloat16_rn(mean);
  a_out[(size_t)n * c + ch] =
      __float2bfloat16_rn(__fmul_rn(inv, load_param(scale, ch, pbf)));
  b_out[(size_t)n * c + ch] = __float2bfloat16_rn(load_param(bias, ch, pbf));
}

__device__ __forceinline__ float silu(float v) {
  return v / (1.f + expf(-v));
}

// bf16x2 arithmetic on the packed pairs of a 32-bit word, each result
// rounded once to bf16: what the eager passes round their fp32 result of
// two bf16 operands to (the difference, product and sum of two bf16
// values are exact in fp32 wherever the second rounding could tell). The
// explicit .rn keeps the compiler from contracting the product and the
// sum into one fma, which would skip the product's rounding.
__device__ __forceinline__ unsigned sub_bf2(unsigned a, unsigned b) {
  unsigned d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ unsigned mul_bf2(unsigned a, unsigned b) {
  unsigned d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ unsigned add_bf2(unsigned a, unsigned b) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

template <bool kSilu>
__device__ __forceinline__ unsigned apply2(unsigned x, unsigned m, unsigned a,
                                           unsigned b) {
  unsigned y = add_bf2(mul_bf2(sub_bf2(x, m), a), b);
  if (kSilu) {
    const float2 v =
        __bfloat1622float2(*reinterpret_cast<const bf162*>(&y));
    const bf162 o = __floats2bfloat162_rn(silu(v.x), silu(v.y));
    y = *reinterpret_cast<const unsigned*>(&o);
  }
  return y;
}

template <bool kSilu>
__device__ __forceinline__ uint4 apply8(const uint4& x, const uint4& m,
                                        const uint4& a, const uint4& b) {
  return make_uint4(apply2<kSilu>(x.x, m.x, a.x, b.x),
                    apply2<kSilu>(x.y, m.y, a.y, b.y),
                    apply2<kSilu>(x.z, m.z, a.z, b.z),
                    apply2<kSilu>(x.w, m.w, a.w, b.w));
}

// grid (slabs, N), block V * k threads
template <bool kSilu>
__global__ void __launch_bounds__(kMaxVectors)
gn_apply_kernel(const uint4* __restrict__ x, const uint4* __restrict__ mean,
                const uint4* __restrict__ a, const uint4* __restrict__ b,
                uint4* __restrict__ y, long long rows, int nv, int k,
                long long slab_rows) {
  const int n = blockIdx.y, slab = blockIdx.x;
  const int v = threadIdx.x % nv, j = threadIdx.x / nv;
  const long long r0 = (long long)slab * slab_rows;
  const long long r1 = min(rows, r0 + slab_rows);
  const uint4 m2 = mean[(size_t)n * nv + v], a2 = a[(size_t)n * nv + v],
              b2 = b[(size_t)n * nv + v];
  const size_t base = (size_t)n * rows * nv + v;
  const uint4* xn = x + base;
  uint4* yn = y + base;
  long long r = r0 + j;
  for (; r + 3 * k < r1; r += 4 * k) {
    const uint4 x0 = xn[(size_t)r * nv];
    const uint4 x1 = xn[(size_t)(r + k) * nv];
    const uint4 x2 = xn[(size_t)(r + 2 * k) * nv];
    const uint4 x3 = xn[(size_t)(r + 3 * k) * nv];
    yn[(size_t)r * nv] = apply8<kSilu>(x0, m2, a2, b2);
    yn[(size_t)(r + k) * nv] = apply8<kSilu>(x1, m2, a2, b2);
    yn[(size_t)(r + 2 * k) * nv] = apply8<kSilu>(x2, m2, a2, b2);
    yn[(size_t)(r + 3 * k) * nv] = apply8<kSilu>(x3, m2, a2, b2);
  }
  for (; r < r1; r += k)
    yn[(size_t)r * nv] = apply8<kSilu>(xn[(size_t)r * nv], m2, a2, b2);
}

// rows a block (its slab): one wave of the kernel's resident blocks over
// the card, split evenly over the n (as many slabs an n as the SMs hold
// blocks, over n, rounded down: no block waits for a second wave), at most
// `max_slabs` an n and at least four rows a thread; returns 0 on an error
template <typename Kernel>
long long slab_rows_for(Kernel kernel, int threads, size_t smem, int sms,
                        long long n, long long rows, int k, int max_slabs,
                        int* slabs) {
  int resident = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                    threads, smem) !=
          cudaSuccess ||
      resident < 1)
    return 0;
  long long want = (long long)resident * sms / n;
  if (want > max_slabs) want = max_slabs;
  const long long most = (rows + 4LL * k - 1) / (4LL * k);
  if (want > most) want = most;
  if (want < 1) want = 1;
  const long long per = (rows + want - 1) / want;
  *slabs = (int)((rows + per - 1) / per);
  return per;
}

bool shape_ok(long long n, long long rows, int c, int k) {
  return n > 0 && n < 65536 && rows > 0 && c > 0 && c % 8 == 0 &&
         c / 8 <= kMaxVectors && k > 0 && (c / 8) * k <= kMaxVectors;
}

}  // namespace

// x [n, rows, c] bf16, contiguous and 16-byte aligned; k row lanes a block
// (V * k <= 1024, V = c / 8); part fp32 [n, max_slabs, 2, c] scratch.
// With mean_out null: the channel statistics in sum and sumsq fp32 [n, c].
// Else the GroupNorm's bf16 mean, a, bias [n, c] from scale and bias [c]
// (bf16 with params_bf16, else fp32), `groups` groups of at most 1024
// channels (c % groups == 0).
extern "C" int star_gn_stats(const void* x, void* part, void* sum,
                             void* sumsq, const void* scale,
                             const void* bias, int params_bf16,
                             void* mean_out, void* a_out, void* b_out,
                             long long n, long long rows, int c, int groups,
                             float eps, int k, int max_slabs, int sms,
                             void* stream) {
  if (!shape_ok(n, rows, c, k) || max_slabs < 1 || sms < 1)
    return (int)cudaErrorInvalidValue;
  const bool gn = mean_out != nullptr;
  if (gn && (groups < 1 || c % groups || c / groups > kFoldThreads))
    return (int)cudaErrorInvalidValue;
  const int nv = c / 8, threads = nv * k;
  const size_t smem = k > 1 ? (size_t)2 * k * c * sizeof(float) : 0;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  int slabs = 0;
  const long long per = slab_rows_for(gn_partials_kernel, threads, smem, sms,
                                      n, rows, k, max_slabs, &slabs);
  if (per == 0) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
  gn_partials_kernel<<<dim3(slabs, (unsigned)n), threads, smem, st>>>(
      (const uint4*)x, (float*)part, rows, nv, k, per);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // a tile of whole groups, about 32 channels or more, and lanes enough
  // to fill a block of at most kFoldThreads
  const int gw = gn ? c / groups : 1;
  int tile = gw * ((32 + gw - 1) / gw);
  if (tile > c) tile = c;
  int lanes = kFoldThreads / tile;
  if (lanes > (slabs + 3) / 4) lanes = (slabs + 3) / 4;   // 4 slabs a lane
  if (lanes > 32) lanes = 32;
  const size_t fold_smem = (size_t)2 * (lanes + 1) * tile * sizeof(float);
  const float count = (float)((double)rows * (double)gw);
  gn_fold_kernel<<<dim3((c + tile - 1) / tile, (unsigned)n), tile * lanes,
                   fold_smem, st>>>(
      (const float*)part, slabs, c, gw, tile, lanes, count, eps, scale, bias,
      params_bf16, (float*)sum, (float*)sumsq, (bf16*)mean_out, (bf16*)a_out,
      (bf16*)b_out);
  return (int)cudaGetLastError();
}

// x, y [n, rows, c] bf16, contiguous and 16-byte aligned; mean, a, b
// [n, c] bf16; k as for star_gn_stats; silu 0 or 1
extern "C" int star_gn_apply(const void* x, const void* mean, const void* a,
                             const void* b, void* y, long long n,
                             long long rows, int c, int k, int silu, int sms,
                             void* stream) {
  if (!shape_ok(n, rows, c, k) || sms < 1) return (int)cudaErrorInvalidValue;
  const int nv = c / 8, threads = nv * k;
  int slabs = 0;
  const long long per =
      silu ? slab_rows_for(gn_apply_kernel<true>, threads, 0, sms, n, rows,
                           k, 1 << 30, &slabs)
           : slab_rows_for(gn_apply_kernel<false>, threads, 0, sms, n, rows,
                           k, 1 << 30, &slabs);
  if (per == 0) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid(slabs, (unsigned)n);
  cudaStream_t st = (cudaStream_t)stream;
  if (silu)
    gn_apply_kernel<true><<<grid, threads, 0, st>>>(
        (const uint4*)x, (const uint4*)mean, (const uint4*)a,
        (const uint4*)b, (uint4*)y, rows, nv, k, per);
  else
    gn_apply_kernel<false><<<grid, threads, 0, st>>>(
        (const uint4*)x, (const uint4*)mean, (const uint4*)a,
        (const uint4*)b, (uint4*)y, rows, nv, k, per);
  return (int)cudaGetLastError();
}
