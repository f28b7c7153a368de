// Row LayerNorm kernels for Hopper (sm_90a): K10 and K11 of the port.
//
// K10 replaces the Pallas kernel `_kernel` of
// tools/negative_results/fused_ln.py (via `_impl`): LayerNorm over the last
// axis with fp32 statistics, optionally after the TemporalLIEM gate
// g = sigmoid(w0 * max_c(x) + w1 * mean_c(x)).
// K11 replaces the Pallas kernel `_kernel` of
// tools/negative_results/stream_fuse.py (via `_dispatch`): the residual add
// xr = y + resid (rounded to bf16 once, as PyTorch's bf16 add rounds it,
// and written out), then the same optionally gated LayerNorm of the rounded
// xr. For every row of C values (C a multiple of 64, at most 4096):
//
//   mean = sum(x) / C, var = max(sum(x^2) / C - mean^2, 0)      (fp32)
//   a    = rsqrt(var + eps), or gated g * rsqrt(g^2 var + eps)
//   out  = bf16((x - mean) * a * scale + bias)
//
// The gate is folded into the coefficients (mean(g x) = g mean(x),
// var(g x) = g^2 var(x)), so the gated row is never formed; the apply runs
// in fp32 with one bf16 rounding at the output.
//
// What bounds it on the H100: bytes. A row does about 8 FLOPs per value on
// 2 (K10) or 4 (K11) bytes read and 2 or 4 written, far below the card's
// 295 FLOP/byte balance: the floor is one read of each input and one write
// of each output.
// Design: one warp per row, the whole row in registers as bf16x2 (C/64
// pairs a lane; lane j holds pairs j, j + 32, ..., so each step of the warp
// reads 128 contiguous bytes). Sum, sum of squares and, when gated, the
// max are lane partials reduced with xor shuffles, so every lane ends with
// the row's statistics and applies them to the values it already holds:
// one read and one write of every tensor, nothing in shared memory. The
// register array is sized by a bucket of C (8, 16, 32 or 64 pairs) and the
// pairs past C/64 are skipped. Scale, bias and the gate weights are read as
// bf16 or fp32, whichever the module holds, so no cast runs beside the
// kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

__device__ __forceinline__ float load_param(const void* p, int i, bool pbf) {
  return pbf ? __bfloat162float(reinterpret_cast<const bf16*>(p)[i])
             : reinterpret_cast<const float*>(p)[i];
}

__device__ __forceinline__ float2 load_param2(const void* p, int i,
                                              bool pbf) {
  return pbf ? __bfloat1622float2(reinterpret_cast<const bf162*>(p)[i])
             : reinterpret_cast<const float2*>(p)[i];
}

// One row per warp. x is the row (K10) or y (K11, with resid and xr).
template <int MAXP, bool GATED, bool RESID>
__device__ __forceinline__ void ln_row(
    const bf16* __restrict__ x, const bf16* __restrict__ resid,
    const void* __restrict__ scale, const void* __restrict__ bias,
    const void* __restrict__ gate_w, bool pbf, bf16* __restrict__ out,
    bf16* __restrict__ xr, long long rows, int C, float eps) {
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int np = C >> 6;
  const long long base = row * C;
  const bf162* xp = reinterpret_cast<const bf162*>(x + base);

  bf162 v[MAXP];
  float s = 0.f, s2 = 0.f, mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < MAXP; ++i) {
    if (i < np) {
      const int p = lane + 32 * i;
      bf162 a = xp[p];
      if (RESID) {
        const float2 fy = __bfloat1622float2(a);
        const float2 fr = __bfloat1622float2(
            reinterpret_cast<const bf162*>(resid + base)[p]);
        a = __floats2bfloat162_rn(fy.x + fr.x, fy.y + fr.y);
        reinterpret_cast<bf162*>(xr + base)[p] = a;
      }
      v[i] = a;
      const float2 f = __bfloat1622float2(a);
      s += f.x + f.y;
      s2 += f.x * f.x + f.y * f.y;
      if (GATED) mx = fmaxf(mx, fmaxf(f.x, f.y));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    if (GATED) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
  const float mean = s / (float)C;
  const float var = fmaxf(s2 / (float)C - mean * mean, 0.f);
  float a;
  if (GATED) {
    const float w0 = load_param(gate_w, 0, pbf);
    const float w1 = load_param(gate_w, 1, pbf);
    const float g = 1.f / (1.f + expf(-(w0 * mx + w1 * mean)));
    a = g * rsqrtf(var * (g * g) + eps);
  } else {
    a = rsqrtf(var + eps);
  }
  bf162* op = reinterpret_cast<bf162*>(out + base);
#pragma unroll
  for (int i = 0; i < MAXP; ++i) {
    if (i < np) {
      const int p = lane + 32 * i;
      const float2 f = __bfloat1622float2(v[i]);
      const float2 sc = load_param2(scale, p, pbf);
      const float2 bi = load_param2(bias, p, pbf);
      op[p] = __floats2bfloat162_rn((f.x - mean) * a * sc.x + bi.x,
                                    (f.y - mean) * a * sc.y + bi.y);
    }
  }
}

template <int MAXP, bool GATED>
__global__ void __launch_bounds__(256)
star_ln_kernel(const bf16* __restrict__ x, const void* __restrict__ scale,
               const void* __restrict__ bias,
               const void* __restrict__ gate_w, int pbf,
               bf16* __restrict__ out, long long rows, int C, float eps) {
  ln_row<MAXP, GATED, false>(x, nullptr, scale, bias, gate_w, pbf != 0, out,
                             nullptr, rows, C, eps);
}

template <int MAXP, bool GATED>
__global__ void __launch_bounds__(256)
star_resid_ln_kernel(const bf16* __restrict__ y,
                     const bf16* __restrict__ resid,
                     const void* __restrict__ scale,
                     const void* __restrict__ bias,
                     const void* __restrict__ gate_w, int pbf,
                     bf16* __restrict__ out, bf16* __restrict__ xr,
                     long long rows, int C, float eps) {
  ln_row<MAXP, GATED, true>(y, resid, scale, bias, gate_w, pbf != 0, out,
                            xr, rows, C, eps);
}

namespace {

constexpr int kThreads = 256;  // 8 rows a block

bool bad_shape(long long rows, int C) {
  return rows <= 0 || C < 64 || C > 4096 || C % 64 != 0;
}

unsigned blocks_for(long long rows) {
  const int per_block = kThreads / 32;
  return (unsigned)((rows + per_block - 1) / per_block);
}

template <int MAXP>
void launch_ln(const void* x, const void* scale, const void* bias,
               const void* gate_w, int pbf, void* out, long long rows, int C,
               float eps, cudaStream_t st) {
  if (gate_w)
    star_ln_kernel<MAXP, true><<<blocks_for(rows), kThreads, 0, st>>>(
        (const bf16*)x, scale, bias, gate_w, pbf, (bf16*)out, rows, C, eps);
  else
    star_ln_kernel<MAXP, false><<<blocks_for(rows), kThreads, 0, st>>>(
        (const bf16*)x, scale, bias, gate_w, pbf, (bf16*)out, rows, C, eps);
}

template <int MAXP>
void launch_resid_ln(const void* y, const void* resid, const void* scale,
                     const void* bias, const void* gate_w, int pbf,
                     void* out, void* xr, long long rows, int C, float eps,
                     cudaStream_t st) {
  if (gate_w)
    star_resid_ln_kernel<MAXP, true><<<blocks_for(rows), kThreads, 0, st>>>(
        (const bf16*)y, (const bf16*)resid, scale, bias, gate_w, pbf,
        (bf16*)out, (bf16*)xr, rows, C, eps);
  else
    star_resid_ln_kernel<MAXP, false><<<blocks_for(rows), kThreads, 0, st>>>(
        (const bf16*)y, (const bf16*)resid, scale, bias, gate_w, pbf,
        (bf16*)out, (bf16*)xr, rows, C, eps);
}

}  // namespace

// K10. x, out [rows, C] bf16; scale, bias [C] and gate_w [2] (null: no
// gate) all bf16 (pbf = 1) or all fp32 (pbf = 0)
extern "C" int star_fused_ln(const void* x, const void* scale,
                             const void* bias, const void* gate_w, int pbf,
                             void* out, long long rows, int C, float eps,
                             void* stream) {
  if (bad_shape(rows, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (C <= 512)
    launch_ln<8>(x, scale, bias, gate_w, pbf, out, rows, C, eps, st);
  else if (C <= 1024)
    launch_ln<16>(x, scale, bias, gate_w, pbf, out, rows, C, eps, st);
  else if (C <= 2048)
    launch_ln<32>(x, scale, bias, gate_w, pbf, out, rows, C, eps, st);
  else
    launch_ln<64>(x, scale, bias, gate_w, pbf, out, rows, C, eps, st);
  return (int)cudaGetLastError();
}

// K11. y, resid, out, xr [rows, C] bf16; parameters as for star_fused_ln
extern "C" int star_fused_resid_ln(const void* y, const void* resid,
                                   const void* scale, const void* bias,
                                   const void* gate_w, int pbf, void* out,
                                   void* xr, long long rows, int C,
                                   float eps, void* stream) {
  if (bad_shape(rows, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (C <= 512)
    launch_resid_ln<8>(y, resid, scale, bias, gate_w, pbf, out, xr, rows, C,
                       eps, st);
  else if (C <= 1024)
    launch_resid_ln<16>(y, resid, scale, bias, gate_w, pbf, out, xr, rows,
                        C, eps, st);
  else if (C <= 2048)
    launch_resid_ln<32>(y, resid, scale, bias, gate_w, pbf, out, xr, rows,
                        C, eps, st);
  else
    launch_resid_ln<64>(y, resid, scale, bias, gate_w, pbf, out, xr, rows,
                        C, eps, st);
  return (int)cudaGetLastError();
}
