// The UNet's GEGLU for Hopper (sm_90a): K12 of the port.
//
// Replaces no TPU kernel: in the JAX package XLA fuses the GEGLU's split,
// fp32 GELU, cast and product (star_tpu/models/unet/blocks.py:108) into one
// loop. Eager PyTorch ran the same expression as four passes (the gate's
// strided cast to fp32, the GELU, the cast back, the strided product), 26
// bytes of traffic per output value. For p [M, 2*inner] bf16, h its first
// half of each row and gate its second (as `chunk(2, -1)` splits it), and
// out [M, inner] bf16:
//
//   out = bf16( float(h) * float( bf16( gelu_tanh( float(gate) ) ) ) )
//
// The tanh GELU is written as PyTorch's CUDA kernel writes it (the same
// constants, order of operations and tanhf), rounded to bf16 once as
// `.to(torch.bfloat16)` rounds it, then the product rounded once: the
// rounding of `h * F.gelu(gate.float(), approximate='tanh').to(h.dtype)`.
//
// What bounds it on the H100: bytes. A value moves 6 bytes (h and the gate
// read, out written) for about 30 instructions, below the card's balance,
// so the floor is one read of p and one write of out.
// Design: one streaming pass, a thread for each 16-byte vector (8 values)
// of the output, a flat index v. Vector v of out sits in row v / (inner / 8),
// and its h and gate vectors at v + row * (inner / 8) and inner / 8 past
// that in p; a warp's loads and stores are contiguous 512-byte runs except
// where a row's half ends. A thread takes 32 registers, so an SM holds its
// full 2048 threads and 64 KB of loads in flight: four vectors a thread
// took 80 registers, 768 threads an SM, and reached 82% of the bound at
// [230400, 2560] against 92% for this form, which is what a copy with the
// same reads and writes reaches (a probe on an H100). Any M; inner a
// multiple of 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

typedef __nv_bfloat162 bf162;

namespace {

constexpr int kThreads = 256;

// PyTorch's GeluCUDAKernelImpl (approximate='tanh') for float: kBeta is
// M_SQRT2 * M_2_SQRTPI * 0.5 in double, rounded to float
__device__ __forceinline__ float gelu_tanh(float x) {
  constexpr float kBeta =
      1.41421356237309504880 * 1.12837916709551257390 * 0.5;
  constexpr float kKappa = 0.044715;
  const float x_cube = x * x * x;
  const float inner = kBeta * (x + kKappa * x_cube);
  return 0.5f * x * (1.f + tanhf(inner));
}

__device__ __forceinline__ uint4 geglu8(const uint4& hv, const uint4& gv) {
  const bf162* h2 = reinterpret_cast<const bf162*>(&hv);
  const bf162* g2 = reinterpret_cast<const bf162*>(&gv);
  uint4 ov;
  bf162* o2 = reinterpret_cast<bf162*>(&ov);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 g = __bfloat1622float2(g2[i]);
    const float2 h = __bfloat1622float2(h2[i]);
    const float2 a = __bfloat1622float2(
        __floats2bfloat162_rn(gelu_tanh(g.x), gelu_tanh(g.y)));
    o2[i] = __floats2bfloat162_rn(h.x * a.x, h.y * a.y);
  }
  return ov;
}

__global__ void __launch_bounds__(kThreads)
geglu_kernel(const uint4* __restrict__ p, uint4* __restrict__ out,
             unsigned nv, unsigned total) {
  const unsigned v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= total) return;
  const size_t src = (size_t)v + (size_t)(v / nv) * nv;
  out[v] = geglu8(p[src], p[src + nv]);
}

}  // namespace

// p [rows, 2*inner] bf16, out [rows, inner] bf16, both contiguous and
// 16-byte aligned; inner a multiple of 8; rows * inner / 8 below 2^31
extern "C" int star_geglu(const void* p, void* out, long long rows,
                          int inner, void* stream) {
  if (rows <= 0 || inner <= 0 || inner % 8) return (int)cudaErrorInvalidValue;
  const long long nv = inner / 8;
  const long long total = rows * nv;
  if (total >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const long long blocks = (total + kThreads - 1) / kThreads;
  geglu_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)p, (uint4*)out, (unsigned)nv, (unsigned)total);
  return (int)cudaGetLastError();
}
