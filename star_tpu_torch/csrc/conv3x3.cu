// Fused GroupNorm-apply + SiLU + 3x3 SAME conv for Hopper (sm_90a): K6 of
// the port, one kernel for the three Pallas forms of the same function.
//
// Replaces `_conv_kernel` (direct taps, via `_conv3x3_pallas`),
// `_winoh_kernel` (H-Winograd F(4,3)/F(2,3), via `_conv3x3_winoh_pallas`)
// and `_wino_kernel` (2-D Winograd F(2x2,3x3), via
// `_conv3x3_wino_pallas`) of star_tpu/ops/conv3x3.py: y = silu(x*a + b)
// with GN coefficients (a, b) [N, C] folded from threaded statistics, a
// 3x3 SAME conv with zero padding AFTER the activation, fp32 accumulation,
// + fp32 bias, one rounding to bf16, + an optional bf16 residual, and the
// fp32 (sum, sumsq) of the stored output per (image, channel). Winograd
// was a choice for the TPU's matrix unit; the function is the same, so
// one direct implicit GEMM serves all three here.
//
// What bounds it on the H100: tensor-core operations. Per output pixel it
// does 2*9*C*Cout FLOPs against (C + Cout [+ Cout]) * 2 bytes: at the VAE's
// narrowest scale (C = Cout = 128, 720x1280) that is 1152 FLOP/byte with
// a residual, four times the card's 295.
// Design: see conv_tile.cuh. The activation is staged once per 32-channel
// chunk in shared memory (1.4 SiLUs per input element with the 10x18 halo
// of an 8x16 patch, instead of 9 with per-tap gathers: at C = Cout = 128
// nine SiLUs per element would cost about as much as the MMAs). The
// weights arrive as [Cout, 3, 3, C] bf16 (K contiguous), made by the
// wrapper on every call.
// Not yet used: wgmma, TMA, a persistent schedule, deeper pipelines.

#include "conv_tile.cuh"

// x [N,H,W,C] bf16; a, b [N,C] fp32; w [Cout,3,3,C] bf16; bias [Cout] fp32;
// residual [N,H,W,Cout] bf16 or null; out [N,H,W,Cout] bf16; sum/sumsq
// [N,Cout] fp32 zeroed by the caller (ignored without want_stats).
// Requires C % 32 == 0 and Cout % 128 == 0.
extern "C" int star_conv3x3(const void* x, const void* a, const void* b,
                            const void* w, const void* bias,
                            const void* residual, void* out, void* ssum,
                            void* ssq, int N, int H, int W, int C, int Cout,
                            int want_stats, void* stream) {
  using namespace conv_tile;
  Args args{(const bf16*)x, (const float*)a, (const float*)b,
            (const bf16*)w, (const float*)bias, (const bf16*)residual,
            (bf16*)out, (float*)ssum, (float*)ssq, N, H, W, C, Cout,
            want_stats};
  return launch<9>(args, (cudaStream_t)stream);
}
