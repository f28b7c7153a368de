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
