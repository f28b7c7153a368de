// Per-pixel frame attention for Hopper (sm_90a): K4 of the port.
//
// Replaces the Pallas kernel `_temporal_kernel` of
// star_tpu/ops/temporal_attention.py (via `temporal_attention`): softmax
// attention over the F frames, independently at every (batch, pixel, head),
// on q/k/v in their natural [B, F, N, H*D] layout, d=64, F <= 16.
//
// What bounds it on the H100: bytes. Each (pixel, head) does 4*F*F*64
// FLOPs on 3*F*64 inputs of 2 bytes — about 2*F/3 FLOP per byte, far below
// the card's 295 FLOP/byte balance, so the floor is reading q, k and v once
// and writing the output once.
// Design: one warp per (b, n, head); each lane holds two of the 64 head
// dims of every frame's q, k and v in registers (bf16x2 loads: a warp reads
// one contiguous 128-byte row per frame, coalesced, in place, no transpose).
// The F x F logits are lane partial dot products reduced with warp
// shuffles, so every lane ends with the full row; the softmax is fp32 with
// the row max subtracted; the output is the p-weighted sum of the lane's v
// values, written as bf16x2. Nothing touches shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

typedef __nv_bfloat16 bf16;

template <int F>
__global__ void __launch_bounds__(256)
temporal_attention_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          int B, int N, int H, float c) {
  const long long wid =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (wid >= (long long)B * N * H) return;
  const int h = (int)(wid % H);
  const long long bn = wid / H;
  const long long n = bn % N;
  const long long b = bn / N;
  const long long C = (long long)H * 64;
  const long long fstride = (long long)N * C;
  const long long base = (b * F * N + n) * C + h * 64 + 2 * lane;

  float2 qf[F], kf[F], vf[F];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    qf[f] = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(q + base + f * fstride));
    kf[f] = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(k + base + f * fstride));
    vf[f] = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(v + base + f * fstride));
  }
#pragma unroll
  for (int f = 0; f < F; ++f) {
    float l[F];
    float mx = -INFINITY;
#pragma unroll
    for (int g = 0; g < F; ++g) {
      float p = qf[f].x * kf[g].x + qf[f].y * kf[g].y;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      l[g] = p * c;  // log2 domain
      mx = fmaxf(mx, l[g]);
    }
    float den = 0.f, o0 = 0.f, o1 = 0.f;
#pragma unroll
    for (int g = 0; g < F; ++g) {
      const float e = exp2f(l[g] - mx);
      den += e;
      o0 += e * vf[g].x;
      o1 += e * vf[g].y;
    }
    const float inv = 1.f / den;
    *reinterpret_cast<__nv_bfloat162*>(o + base + f * fstride) =
        __floats2bfloat162_rn(o0 * inv, o1 * inv);
  }
}

template <int F>
static int launch_temporal(const void* q, const void* k, const void* v,
                           void* o, int B, int N, int H, float c,
                           void* stream) {
  const long long warps = (long long)B * N * H;
  const int per_block = 8;
  const long long blocks = (warps + per_block - 1) / per_block;
  temporal_attention_kernel<F><<<(unsigned)blocks, per_block * 32, 0,
                                 (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, B, N, H, c);
  return (int)cudaGetLastError();
}

// scale: the softmax scale (1/sqrt(64) by default); F in [1, 16]
extern "C" int star_temporal_attention(const void* q, const void* k,
                                       const void* v, void* o, int B, int F,
                                       int N, int H, float scale,
                                       void* stream) {
  const float c = scale * 1.4426950408889634f;
  switch (F) {
#define STAR_CASE(FF) \
  case FF:            \
    return launch_temporal<FF>(q, k, v, o, B, N, H, c, stream);
    STAR_CASE(1) STAR_CASE(2) STAR_CASE(3) STAR_CASE(4) STAR_CASE(5)
    STAR_CASE(6) STAR_CASE(7) STAR_CASE(8) STAR_CASE(9) STAR_CASE(10)
    STAR_CASE(11) STAR_CASE(12) STAR_CASE(13) STAR_CASE(14) STAR_CASE(15)
    STAR_CASE(16)
#undef STAR_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
