// 2x2 phase interleave with output statistics for Hopper (sm_90a): K8 of
// the port.
//
// Replaces `_interleave_kernel` of star_tpu/ops/conv3x3.py (via
// `interleave2x2`): out[n, 2i+r, 2j+s, c] = p_rs[n, i, j, c], and the
// fp32 (sum, sumsq) of the output per (image, channel). It recombines the
// four phase convs of the upsample wherever the fused kernel K7 does not
// take the widths.
//
// What bounds it on the H100: bytes. It reads the four phases once and
// writes the output once (16 bytes per output element pair, no arithmetic
// worth naming).
// Design: one thread per 16-byte vector of 8 channels, in output order, so
// that a warp writes contiguous output and reads contiguous runs of two
// phases; four vectors are loaded before any is stored. A thread keeps one
// channel vector while it walks its pixels, sums its statistics in
// registers, and the block reduces them in shared memory and adds them
// with one atomicAdd per (block, channel) into the caller's zeroed [N, C]
// buffers (in an order that varies between runs). A block covers a
// contiguous range of one image's output pixels; about eight blocks per SM
// of the card are launched in all. Any C % 8 == 0 is taken.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {
constexpr int THREADS = 256, UNROLL = 4, BLOCKS_PER_SM = 8;

__global__ void __launch_bounds__(THREADS)
interleave2x2_kernel(const bf16* __restrict__ p00,
                     const bf16* __restrict__ p01,
                     const bf16* __restrict__ p10,
                     const bf16* __restrict__ p11, bf16* __restrict__ out,
                     float* __restrict__ ssum, float* __restrict__ ssq,
                     int H, int W, int C, int chunk, int want_stats) {
  extern __shared__ float sred[];  // [2][C]
  const int n = blockIdx.y, tid = threadIdx.x;
  const int npix = 4 * H * W;
  const int begin = blockIdx.x * chunk;
  const int end = begin + chunk < npix ? begin + chunk : npix;
  const int V = C / 8;
  const int lanes = V < THREADS ? V : THREADS;  // threads per pixel
  const int ppass = THREADS / lanes;             // pixels per pass
  const int lane = tid % lanes, pg = tid / lanes;
  const long long in_img = (long long)n * H * W * C;
  bf16* o_img = out + (long long)n * npix * C;
  const int W2 = 2 * W;

  if (want_stats) {
    for (int i = tid; i < 2 * C; i += THREADS) sred[i] = 0.f;
    __syncthreads();
  }
  if (pg < ppass) {
    for (int cv = lane; cv < V; cv += lanes) {
      float s[8], s2[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) s[e] = s2[e] = 0.f;
      for (int pix0 = begin + pg; pix0 < end; pix0 += UNROLL * ppass) {
        uint4 v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int pix = pix0 + u * ppass;
          if (pix < end) {
            const int oh = pix / W2, ow = pix - oh * W2;
            const bf16* sp = (oh & 1) ? ((ow & 1) ? p11 : p10)
                                      : ((ow & 1) ? p01 : p00);
            v[u] = __ldg(reinterpret_cast<const uint4*>(
                sp + in_img + ((long long)(oh >> 1) * W + (ow >> 1)) * C +
                cv * 8));
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int pix = pix0 + u * ppass;
          if (pix < end) {
            *reinterpret_cast<uint4*>(o_img + (long long)pix * C + cv * 8) =
                v[u];
            const bf16* vb = reinterpret_cast<const bf16*>(&v[u]);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const float f = __bfloat162float(vb[e]);
              s[e] += f;
              s2[e] += f * f;
            }
          }
        }
      }
      if (want_stats) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          atomicAdd(sred + cv * 8 + e, s[e]);
          atomicAdd(sred + C + cv * 8 + e, s2[e]);
        }
      }
    }
  }
  if (!want_stats) return;
  __syncthreads();
  for (int i = tid; i < C; i += THREADS) {
    atomicAdd(ssum + (long long)n * C + i, sred[i]);
    atomicAdd(ssq + (long long)n * C + i, sred[C + i]);
  }
}
}  // namespace

// p00, p01, p10, p11 [N,H,W,C] bf16; out [N,2H,2W,C] bf16; sum/sumsq [N,C]
// fp32 zeroed by the caller (ignored without want_stats). Requires
// C % 8 == 0.
extern "C" int star_interleave2x2(const void* p00, const void* p01,
                                  const void* p10, const void* p11,
                                  void* out, void* ssum, void* ssq, int N,
                                  int H, int W, int C, int want_stats,
                                  void* stream) {
  if (C % 8 != 0 || N <= 0 || N > 65535 || H <= 0 || W <= 0 ||
      4LL * H * W > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int npix = 4 * H * W;
  const int per_img = (BLOCKS_PER_SM * sms + N - 1) / N;
  const int chunk = (npix + per_img - 1) / per_img;
  const int blocks = (npix + chunk - 1) / chunk;
  const size_t smem = want_stats ? 2 * (size_t)C * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(interleave2x2_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  interleave2x2_kernel<<<dim3((unsigned)blocks, (unsigned)N), THREADS, smem,
                         (cudaStream_t)stream>>>(
      (const bf16*)p00, (const bf16*)p01, (const bf16*)p10,
      (const bf16*)p11, (bf16*)out, (float*)ssum, (float*)ssq, H, W, C,
      chunk, want_stats);
  return (int)cudaGetLastError();
}
