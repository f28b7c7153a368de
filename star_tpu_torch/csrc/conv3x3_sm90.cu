// Fused GroupNorm-apply + SiLU + 3x3 SAME conv for Hopper (sm_90a) on
// wgmma + TMA: K6 of the port, one kernel for the three Pallas forms of
// the same function.
//
// Replaces `_conv_kernel` (direct taps, via `_conv3x3_pallas`, :278),
// `_winoh_kernel` (H-Winograd F(4,3)/F(2,3), via `_conv3x3_winoh_pallas`,
// :904) and `_wino_kernel` (2-D Winograd F(2x2,3x3), via
// `_conv3x3_wino_pallas`, :656) of star_tpu/ops/conv3x3.py: y = silu(x*a +
// b) with GN coefficients (a, b) [N, C] folded from threaded statistics, a
// 3x3 SAME conv with zero padding AFTER the activation, fp32 accumulation,
// + fp32 bias, one rounding to bf16, + an optional bf16 residual, and the
// fp32 (sum, sumsq) of the stored output per (image, channel). Winograd
// was a choice for the TPU's matrix unit; the function is the same, so one
// direct implicit GEMM serves all three here.
//
// What bounds it on the H100: tensor-core operations. Per output pixel it
// does 2*9*C*Cout FLOPs against (C + Cout [+ Cout]) * 2 bytes: at the VAE's
// narrowest scale (C = Cout = 128, 720x1280) 1152 FLOP/byte with a
// residual, four times the card's 295. Beside the products: one SiLU (an
// exponential and a reciprocal on the SFUs) per halo element, and the
// weights, which every tile reads again from L2.
//
// Design: the halo conv of halo_conv_sm90.cuh with one phase of nine taps
// (tap (ty, tx) 16*(18*ty + tx) bytes into the halo), the GN apply + SiLU
// done in place on each halo (zeros over the pixels outside the image)
// under the previous chunk's products, and the residual added in the
// epilogue. The launch arithmetic (maps, grid, shared memory, tap
// offsets) is `conv3x3_launch_plan` in star_tpu_torch/ops/conv3x3.py.

#include "halo_conv_sm90.cuh"

__global__ void __launch_bounds__(halo::THREADS, 1)
conv3x3_sm90(const __grid_constant__ CUtensorMap tx,
             const __grid_constant__ CUtensorMap tw,
             const __grid_constant__ halo::OutMaps<halo::ConvForm> maps,
             const __grid_constant__ halo::Params p) {
  halo::body<halo::ConvForm>(tx, tw, maps, p);
}

// x [N,H,W,C] bf16; a, b [N,C] fp32; w [Cout,3,3,C] bf16; bias [Cout] fp32;
// residual [N,H,W,Cout] bf16 or null; out [N,H,W,Cout] bf16; sum/sumsq
// [N,Cout] fp32 zeroed by the caller (ignored without want_stats); `grid`
// persistent blocks. Requires C % 64 == 0 and Cout % 128 == 0; the launch
// arithmetic is `conv3x3_launch_plan`.
extern "C" int star_conv3x3(const void* x, const void* a, const void* b,
                            const void* w, const void* bias,
                            const void* residual, void* out, void* ssum,
                            void* ssq, int N, int H, int W, int C, int Cout,
                            int want_stats, int grid, void* stream) {
  using namespace halo;
  Params p{(const float*)a, (const float*)b, (const float*)bias,
           (float*)ssum, (float*)ssq, N, H, W, C, Cout, 0, 0, 0, 0,
           want_stats, {}};
  for (int tap = 0; tap < 9; ++tap)
    p.tap_bytes[tap] = 16 * (HALO * (tap / 3) + tap % 3);
  const long long offset[1] = {0};
  const long long strides[3] = {(long long)Cout * 2, (long long)W * Cout * 2,
                                (long long)H * W * Cout * 2};
  return launch<ConvForm>(conv3x3_sm90, x, w, residual, out, offset, strides,
                          p, grid, stream);
}
