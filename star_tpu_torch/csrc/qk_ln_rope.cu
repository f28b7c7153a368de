// Fused qk-LayerNorm + half-split RoPE for Hopper (sm_90a): K9 of the port.
//
// Replaces the Pallas kernel `_kernel` of star_tpu/ops/qk_ln_rope.py (via
// `qk_ln_rope`), the DiT's q/k prologue (star_tpu/models/dit/dit.py:245,251):
// for every (row s, head h) of x [B, S, H*64] in its natural layout,
//   y   = ((x - mean) * rsqrt(var + eps) * scale + bias) * fold_scale
//   out = y * cos[s] + rotate_half(y) * sin[s]
// with fp32 statistics over the head's 64 values, fp32 rotation math and a
// bf16 output. The wrapper folds fold_scale into scale and bias (for q it
// carries the softmax scale * log2(e) of the flash kernel that follows).
// The variance is the two-pass form, mean of (x - mean)^2, as the JAX
// package's reference computes it (its Pallas kernel uses E[x^2] - mean^2).
//
// What bounds it on the H100: bytes. Each value is read once and written
// once as bf16 with about 10 FLOPs between, far below the card's 295
// FLOP/byte balance. The Pallas kernel's block-diagonal ones matmuls were
// the MXU's way to reduce per head; here the reduction is two shuffle
// trees inside a half-warp.
// Design: one half-warp per (row, head). Lane j of the half holds the
// head's values 2j, 2j+1 and 32+2j, 33+2j (two bf16x2 loads), so the
// half-split rotate pairs (i, i+32) sit in the same lane and need no
// shuffle. A warp covers two neighbouring heads of a row: its loads are two
// contiguous 64-byte runs each. The RoPE tables are [S, 64] fp32 (one row
// serves every head; text and tail rows are the identity rotation), read
// with float2 loads and served from L1/L2 to the 48 heads of a row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef __nv_bfloat16 bf16;

__global__ void __launch_bounds__(256)
qk_ln_rope_kernel(const bf16* __restrict__ x, const float* __restrict__ cos_t,
                  const float* __restrict__ sin_t,
                  const float* __restrict__ sc, const float* __restrict__ bi,
                  bf16* __restrict__ out, long long rows, int S, int H,
                  float eps) {
  const long long total = rows * H;
  const long long first = (long long)blockIdx.x * (blockDim.x >> 4);
  const long long hw = first + (threadIdx.x >> 4);
  // whole warps past the end leave together; a warp with one live half
  // keeps its other half in the shuffles, with zeros and no stores
  if (first + ((threadIdx.x >> 5) << 1) >= total) return;
  const bool live = hw < total;
  const int j = threadIdx.x & 15;
  const long long r = live ? hw / H : 0;
  const int h = live ? (int)(hw % H) : 0;
  const long long base = r * H * 64 + h * 64 + 2 * j;

  float2 a = make_float2(0.f, 0.f), b = a;
  if (live) {
    a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + base));
    b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(x + base + 32));
  }
  float s = (a.x + a.y) + (b.x + b.y);
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  const float mean = s * (1.f / 64.f);
  const float d0 = a.x - mean, d1 = a.y - mean;
  const float d2 = b.x - mean, d3 = b.y - mean;
  float v = (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (!live) return;
  const float inv = rsqrtf(v * (1.f / 64.f) + eps);

  const float2 sa = *reinterpret_cast<const float2*>(sc + 2 * j);
  const float2 sb = *reinterpret_cast<const float2*>(sc + 32 + 2 * j);
  const float2 ba = *reinterpret_cast<const float2*>(bi + 2 * j);
  const float2 bb = *reinterpret_cast<const float2*>(bi + 32 + 2 * j);
  const float ya0 = d0 * inv * sa.x + ba.x, ya1 = d1 * inv * sa.y + ba.y;
  const float yb0 = d2 * inv * sb.x + bb.x, yb1 = d3 * inv * sb.y + bb.y;

  const long long t = (r % S) * 64 + 2 * j;
  const float2 ca = *reinterpret_cast<const float2*>(cos_t + t);
  const float2 cb = *reinterpret_cast<const float2*>(cos_t + t + 32);
  const float2 na = *reinterpret_cast<const float2*>(sin_t + t);
  const float2 nb = *reinterpret_cast<const float2*>(sin_t + t + 32);
  // rotate_half(y) = (-y[32:], y[:32])
  *reinterpret_cast<__nv_bfloat162*>(out + base) = __floats2bfloat162_rn(
      ya0 * ca.x - yb0 * na.x, ya1 * ca.y - yb1 * na.y);
  *reinterpret_cast<__nv_bfloat162*>(out + base + 32) = __floats2bfloat162_rn(
      yb0 * cb.x + ya0 * nb.x, yb1 * cb.y + ya1 * nb.y);
}

// x, out [rows, H*64] bf16 (rows = B*S, row r uses table row r % S);
// cos_t, sin_t [S, 64] fp32; sc, bi [64] fp32 with fold_scale folded in
extern "C" int star_qk_ln_rope(const void* x, const void* cos_t,
                               const void* sin_t, const void* sc,
                               const void* bi, void* out, long long rows,
                               int S, int H, float eps, void* stream) {
  if (rows <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const long long halves = rows * H;
  const int per_block = 16;  // half-warps of a 256-thread block
  const long long blocks = (halves + per_block - 1) / per_block;
  qk_ln_rope_kernel<<<(unsigned)blocks, per_block * 16, 0,
                      (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)cos_t, (const float*)sin_t,
      (const float*)sc, (const float*)bi, (bf16*)out, rows, S, H, eps);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K9's backward. It replaces no TPU kernel: the JAX package defines no
// backward of its own (jax.grad differentiates `qk_ln_rope_reference`). For
// every (row s, head h), from x and the cotangent ct of the output:
//   xh  = (x - mean) * rstd        (recomputed, the forward's two-pass var)
//   g   = ct * cos[s] + rotT(ct * sin[s]),  rotT(u) = (u[32:], -u[:32])
//   gh  = g * scale * fold_scale
//   dx  = rstd * (gh - mean(gh) - xh * mean(gh * xh))
// all in fp32, dx rounded to bf16 once. With kParams each block also writes
// its partial sums over its (row, head) pairs of g * fold_scale (the bias
// gradient) and g * fold_scale * xh (the scale's), [2, 64] fp32, which the
// wrapper adds up in a fixed order.
//
// What bounds it: bytes. x and ct are read once and dx written once, about
// 20 FLOPs a value. Design: four lanes per (row, head); lane j holds the
// head's values 8j..8j+7 and 32+8j..39+8j, each input two 16-byte loads, so
// the rotation's pairs (i, i+32) sit in one lane and need no shuffle, and
// each of the four reductions (mean, variance, mean(gh), mean(gh xh)) is two
// shuffle steps. A warp covers 8 neighbouring heads (1 KB of each input), a
// 256-thread block 64. The tables and the scale are read as float4 from
// L1/L2, one table row for the row's heads; row r uses table row r % S.

namespace {

constexpr int kBwdUnits = 64;  // (row, head) pairs of a 256-thread block

__device__ __forceinline__ void load8(const bf16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(bf16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void loadf8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// the sum over the four lanes of a (row, head)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace

template <bool kParams>
__global__ void __launch_bounds__(256)
qk_ln_rope_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ct,
                      const float* __restrict__ cos_t,
                      const float* __restrict__ sin_t,
                      const float* __restrict__ sc, bf16* __restrict__ dx,
                      float* __restrict__ partials, long long units, int S,
                      int H, float eps, float fold) {
  __shared__ float red[kParams ? 8 : 1][2][64];
  const long long first = (long long)blockIdx.x * kBwdUnits;
  // dx alone: whole warps past the end leave together; with kParams every
  // thread stays for the block's sums, a dead pair adding zeros
  if (!kParams && first + ((threadIdx.x >> 5) << 3) >= units) return;
  const long long u = first + (threadIdx.x >> 2);
  const bool live = u < units;
  const int j = threadIdx.x & 3;
  const long long uu = live ? u : 0;
  const long long base = uu * 64 + 8 * j;
  const long long t = (uu / H % S) * 64 + 8 * j;

  float xa[8], xb[8], ga[8], gb[8];
  if (live) {
    load8(x + base, xa);
    load8(x + base + 32, xb);
    load8(ct + base, ga);
    load8(ct + base + 32, gb);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) xa[i] = xb[i] = ga[i] = gb[i] = 0.f;
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += xa[i] + xb[i];
  const float mean = quad_sum(s) * (1.f / 64.f);
  float v = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    xa[i] -= mean;
    xb[i] -= mean;
    v += xa[i] * xa[i] + xb[i] * xb[i];
  }
  const float rstd = rsqrtf(quad_sum(v) * (1.f / 64.f) + eps);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    xa[i] *= rstd;
    xb[i] *= rstd;
  }

  {
    // g * fold_scale: g[i] = ct[i] cos[i] + ct[i+32] sin[i+32] and
    // g[i+32] = ct[i+32] cos[i+32] - ct[i] sin[i], i < 32
    float ca[8], cb[8], na[8], nb[8];
    loadf8(cos_t + t, ca);
    loadf8(cos_t + t + 32, cb);
    loadf8(sin_t + t, na);
    loadf8(sin_t + t + 32, nb);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float lo = ga[i], hi = gb[i];
      ga[i] = (lo * ca[i] + hi * nb[i]) * fold;
      gb[i] = (hi * cb[i] - lo * na[i]) * fold;
    }
  }

  if constexpr (kParams) {
    // the warp's 8 pairs summed by column (lanes j, j+4, ... hold the same
    // columns), then the block's 8 warps in order: no atomics
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float b0 = ga[i], b1 = gb[i];
      float s0 = ga[i] * xa[i], s1 = gb[i] * xb[i];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        b0 += __shfl_xor_sync(0xffffffffu, b0, off);
        b1 += __shfl_xor_sync(0xffffffffu, b1, off);
        s0 += __shfl_xor_sync(0xffffffffu, s0, off);
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      }
      if (lane < 4) {
        red[warp][0][8 * j + i] = b0;
        red[warp][0][32 + 8 * j + i] = b1;
        red[warp][1][8 * j + i] = s0;
        red[warp][1][32 + 8 * j + i] = s1;
      }
    }
    __syncthreads();
    if (threadIdx.x < 128) {
      const int which = threadIdx.x >> 6, col = threadIdx.x & 63;
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) acc += red[w][which][col];
      partials[(long long)blockIdx.x * 128 + threadIdx.x] = acc;
    }
  }

  float sa[8], sb[8];
  loadf8(sc + 8 * j, sa);
  loadf8(sc + 32 + 8 * j, sb);
  float m1 = 0.f, m2 = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    ga[i] *= sa[i];
    gb[i] *= sb[i];
    m1 += ga[i] + gb[i];
    m2 += ga[i] * xa[i] + gb[i] * xb[i];
  }
  m1 = quad_sum(m1) * (1.f / 64.f);
  m2 = quad_sum(m2) * (1.f / 64.f);
  if (!live) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    ga[i] = rstd * (ga[i] - m1 - xa[i] * m2);
    gb[i] = rstd * (gb[i] - m1 - xb[i] * m2);
  }
  store8(dx + base, ga);
  store8(dx + base + 32, gb);
}

// x, ct, dx [rows, H*64] bf16 (row r uses table row r % S), 16-byte
// aligned; cos_t, sin_t [S, 64] fp32 and sc [64] fp32 (without
// fold_scale), 16-byte aligned; partials [blocks, 2, 64] fp32 (bias, then
// scale gradient; blocks = ceil(rows * H / 64)) or null for dx alone
extern "C" int star_qk_ln_rope_bwd(const void* x, const void* ct,
                                   const void* cos_t, const void* sin_t,
                                   const void* sc, void* dx, void* partials,
                                   long long rows, int S, int H, float eps,
                                   float fold, void* stream) {
  if (rows <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const long long units = rows * H;
  const long long blocks = (units + kBwdUnits - 1) / kBwdUnits;
  const cudaStream_t st = (cudaStream_t)stream;
  if (partials)
    qk_ln_rope_bwd_kernel<true><<<(unsigned)blocks, kBwdUnits * 4, 0, st>>>(
        (const bf16*)x, (const bf16*)ct, (const float*)cos_t,
        (const float*)sin_t, (const float*)sc, (bf16*)dx, (float*)partials,
        units, S, H, eps, fold);
  else
    qk_ln_rope_bwd_kernel<false><<<(unsigned)blocks, kBwdUnits * 4, 0, st>>>(
        (const bf16*)x, (const bf16*)ct, (const float*)cos_t,
        (const float*)sin_t, (const float*)sc, (bf16*)dx, nullptr, units, S,
        H, eps, fold);
  return (int)cudaGetLastError();
}
