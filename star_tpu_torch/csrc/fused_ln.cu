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
// Design: one warp per row, the whole row in registers. Sum, sum of squares
// and, when gated, the max are lane partials reduced with xor shuffles, so
// every lane ends with the row's statistics and applies them to the values
// it already holds: one read and one write of every tensor, nothing in
// shared memory. Two paths by width, the same function:
// - C < 1024 (the UNet's 320 and 640): the row as bf16x2, C/64 pairs a
//   lane (lane j holds pairs j, j + 32, ..., so each step of the warp reads
//   128 contiguous bytes), in a register array sized by a bucket of C (8 or
//   16 pairs), the pairs past C/64 skipped.
// - C >= 1024 (CLIP's 1024, the UNet's 1280, the DiT's 3072): 16-byte
//   vectors of 8 bf16, C/256 a lane (each step of the warp reads 512
//   contiguous bytes), so a lane issues a quarter of the loads and stores
//   and holds no unused registers: the array is sized to the exact C for
//   1024, 1280 and 3072, and one generic instantiation of the same kernel
//   takes the other multiples of 64 up to 4096 with the vectors past C/8
//   skipped. The whole row is loaded before any arithmetic, so a warp has
//   all of its row's bytes in flight at once.
// Scale, bias and the gate weights are read as bf16 or fp32, whichever the
// module holds, so no cast runs beside the kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

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

// ---------------------------------------------------------------------------
// C >= 1024: 16-byte vectors

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const bf162* h = reinterpret_cast<const bf162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 t = __bfloat1622float2(h[k]);
    f[2 * k] = t.x;
    f[2 * k + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 u;
  bf162* h = reinterpret_cast<bf162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
  return u;
}

// parameters i*8 .. i*8+7, bf16 or fp32
__device__ __forceinline__ void load_param8(const void* p, int i, bool pbf,
                                            float (&f)[8]) {
  if (pbf) {
    unpack8(reinterpret_cast<const uint4*>(p)[i], f);
  } else {
    const float4 a = reinterpret_cast<const float4*>(p)[2 * i];
    const float4 b = reinterpret_cast<const float4*>(p)[2 * i + 1];
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
}

// One row per warp, NV vectors a lane (lane j holds vectors j, j + 32,
// ...); EXACT: C == 256 * NV, else the vectors past C/8 are skipped.
template <int NV, bool EXACT, bool GATED, bool RESID>
__device__ __forceinline__ void ln_row_wide(
    const bf16* __restrict__ x, const bf16* __restrict__ resid,
    const void* __restrict__ scale, const void* __restrict__ bias,
    const void* __restrict__ gate_w, bool pbf, bf16* __restrict__ out,
    bf16* __restrict__ xr, long long rows, int C, float eps) {
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int nv = C >> 3;
  const long long base = row * C;
  const uint4* xp = reinterpret_cast<const uint4*>(x + base);

  uint4 v[NV];
  uint4 r[RESID ? NV : 1];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int idx = lane + 32 * i;
    if (EXACT || idx < nv) {
      v[i] = xp[idx];
      if (RESID) r[i] = reinterpret_cast<const uint4*>(resid + base)[idx];
    }
  }
  float s = 0.f, s2 = 0.f, mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int idx = lane + 32 * i;
    if (EXACT || idx < nv) {
      float f[8];
      unpack8(v[i], f);
      if (RESID) {
        float fr[8];
        unpack8(r[i], fr);
#pragma unroll
        for (int k = 0; k < 8; ++k) f[k] += fr[k];
        v[i] = pack8(f);           // xr, rounded once
        unpack8(v[i], f);
        reinterpret_cast<uint4*>(xr + base)[idx] = v[i];
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        s += f[k];
        s2 += f[k] * f[k];
        if (GATED) mx = fmaxf(mx, f[k]);
      }
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
  uint4* op = reinterpret_cast<uint4*>(out + base);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int idx = lane + 32 * i;
    if (EXACT || idx < nv) {
      float f[8], sc[8], bi[8];
      unpack8(v[i], f);
      load_param8(scale, idx, pbf, sc);
      load_param8(bias, idx, pbf, bi);
#pragma unroll
      for (int k = 0; k < 8; ++k) f[k] = (f[k] - mean) * a * sc[k] + bi[k];
      op[idx] = pack8(f);
    }
  }
}

template <int MAXP, bool GATED>
__global__ void __launch_bounds__(128)
star_ln_kernel(const bf16* __restrict__ x, const void* __restrict__ scale,
               const void* __restrict__ bias,
               const void* __restrict__ gate_w, int pbf,
               bf16* __restrict__ out, long long rows, int C, float eps) {
  ln_row<MAXP, GATED, false>(x, nullptr, scale, bias, gate_w, pbf != 0, out,
                             nullptr, rows, C, eps);
}

template <int MAXP, bool GATED>
__global__ void __launch_bounds__(128)
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

template <int NV, bool EXACT, bool GATED>
__global__ void __launch_bounds__(128)
star_ln_kernel_wide(const bf16* __restrict__ x,
                    const void* __restrict__ scale,
                    const void* __restrict__ bias,
                    const void* __restrict__ gate_w, int pbf,
                    bf16* __restrict__ out, long long rows, int C,
                    float eps) {
  ln_row_wide<NV, EXACT, GATED, false>(x, nullptr, scale, bias, gate_w,
                                       pbf != 0, out, nullptr, rows, C, eps);
}

template <int NV, bool EXACT, bool GATED>
__global__ void __launch_bounds__(128)
star_resid_ln_kernel_wide(const bf16* __restrict__ y,
                          const bf16* __restrict__ resid,
                          const void* __restrict__ scale,
                          const void* __restrict__ bias,
                          const void* __restrict__ gate_w, int pbf,
                          bf16* __restrict__ out, bf16* __restrict__ xr,
                          long long rows, int C, float eps) {
  ln_row_wide<NV, EXACT, GATED, true>(y, resid, scale, bias, gate_w,
                                      pbf != 0, out, xr, rows, C, eps);
}

namespace {

constexpr int kThreads = 128;  // 4 rows a block
constexpr int kWide = 1024;    // rows of C >= kWide take the 16-byte path

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

template <int NV, bool EXACT>
void launch_ln_wide(const void* x, const void* scale, const void* bias,
                    const void* gate_w, int pbf, void* out, long long rows,
                    int C, float eps, cudaStream_t st) {
  if (gate_w)
    star_ln_kernel_wide<NV, EXACT, true><<<blocks_for(rows), kThreads, 0,
                                           st>>>(
        (const bf16*)x, scale, bias, gate_w, pbf, (bf16*)out, rows, C, eps);
  else
    star_ln_kernel_wide<NV, EXACT, false><<<blocks_for(rows), kThreads, 0,
                                            st>>>(
        (const bf16*)x, scale, bias, gate_w, pbf, (bf16*)out, rows, C, eps);
}

template <int NV, bool EXACT>
void launch_resid_ln_wide(const void* y, const void* resid,
                          const void* scale, const void* bias,
                          const void* gate_w, int pbf, void* out, void* xr,
                          long long rows, int C, float eps, cudaStream_t st) {
  if (gate_w)
    star_resid_ln_kernel_wide<NV, EXACT, true><<<blocks_for(rows), kThreads,
                                                 0, st>>>(
        (const bf16*)y, (const bf16*)resid, scale, bias, gate_w, pbf,
        (bf16*)out, (bf16*)xr, rows, C, eps);
  else
    star_resid_ln_kernel_wide<NV, EXACT, false><<<blocks_for(rows),
                                                  kThreads, 0, st>>>(
        (const bf16*)y, (const bf16*)resid, scale, bias, gate_w, pbf,
        (bf16*)out, (bf16*)xr, rows, C, eps);
}

// the 16-byte path reads every tensor in 16-byte vectors
bool misaligned(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (p != nullptr && reinterpret_cast<uintptr_t>(p) % 16) return true;
  return false;
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
  if (C >= kWide && misaligned({x, scale, bias, out}))
    return (int)cudaErrorInvalidValue;
  if (C <= 512)
    launch_ln<8>(x, scale, bias, gate_w, pbf, out, rows, C, eps, st);
  else if (C < kWide)
    launch_ln<16>(x, scale, bias, gate_w, pbf, out, rows, C, eps, st);
  else if (C == 1024)
    launch_ln_wide<4, true>(x, scale, bias, gate_w, pbf, out, rows, C, eps,
                            st);
  else if (C == 1280)
    launch_ln_wide<5, true>(x, scale, bias, gate_w, pbf, out, rows, C, eps,
                            st);
  else if (C == 3072)
    launch_ln_wide<12, true>(x, scale, bias, gate_w, pbf, out, rows, C, eps,
                             st);
  else
    launch_ln_wide<16, false>(x, scale, bias, gate_w, pbf, out, rows, C,
                              eps, st);
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
  if (C >= kWide && misaligned({y, resid, scale, bias, out, xr}))
    return (int)cudaErrorInvalidValue;
  if (C <= 512)
    launch_resid_ln<8>(y, resid, scale, bias, gate_w, pbf, out, xr, rows, C,
                       eps, st);
  else if (C < kWide)
    launch_resid_ln<16>(y, resid, scale, bias, gate_w, pbf, out, xr, rows,
                        C, eps, st);
  else if (C == 1024)
    launch_resid_ln_wide<4, true>(y, resid, scale, bias, gate_w, pbf, out,
                                  xr, rows, C, eps, st);
  else if (C == 1280)
    launch_resid_ln_wide<5, true>(y, resid, scale, bias, gate_w, pbf, out,
                                  xr, rows, C, eps, st);
  else if (C == 3072)
    launch_resid_ln_wide<12, true>(y, resid, scale, bias, gate_w, pbf, out,
                                   xr, rows, C, eps, st);
  else
    launch_resid_ln_wide<16, false>(y, resid, scale, bias, gate_w, pbf, out,
                                    xr, rows, C, eps, st);
  return (int)cudaGetLastError();
}
