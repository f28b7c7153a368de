// Nearest-2x upsample + 3x3 SAME conv for Hopper (sm_90a): K7 of the port.
//
// Replaces `_upsample_kernel` of star_tpu/ops/conv3x3.py (via
// `upsample_conv2x_fused`): on the 2x grid every output pixel of phase
// (r, s) = (row % 2, col % 2) reads a fixed 2x2 window of the small grid,
// rows {i+r-1, i+r} and cols {j+s-1, j+s}, so the conv is four 2x2 convs
// on the small grid whose weights K_rs [4, 2, 2, C, Cout] are tap sums of
// the 3x3 weights (computed in fp32 and rounded once to bf16 by the
// wrapper, `phase_weights`). Zero halo rows and columns of the small grid
// are the SAME padding of the upsampled one; there is no activation.
// Output: fp32 accumulation + fp32 bias, one rounding to bf16, written
// straight to out[2i+r, 2j+s] — the phase outputs never reach device
// memory — and the fp32 (sum, sumsq) of the stored values per (image,
// channel).
//
// What bounds it on the H100: tensor-core operations: 2*4*C*Cout FLOPs per
// output pixel (2.25x fewer than the 3x3 on the upsampled grid) against
// C/2 + 2*Cout bytes, far above the card's 295 FLOP/byte.
// Design: see conv_tile.cuh. A block owns an 8x16 patch of the small grid,
// one phase and 128 output channels: a GEMM of depth 4*C over the staged
// raw halo. The four phase blocks of a patch are adjacent in launch order
// and share the patch through L2. Weights arrive as [4, Cout, 2, 2, C]
// bf16 (K contiguous per phase), made by the wrapper on every call.
// Not yet used: wgmma, TMA, one halo staging for all four phases.

#include "conv_tile.cuh"

// x [N,H,W,C] bf16; w [4,Cout,2,2,C] bf16 (phase 2r+s, tap 2p+q); bias
// [Cout] fp32; out [N,2H,2W,Cout] bf16; sum/sumsq [N,Cout] fp32 zeroed by
// the caller (ignored without want_stats). Requires C % 32 == 0 and
// Cout % 128 == 0.
extern "C" int star_upsample_conv2x(const void* x, const void* w,
                                    const void* bias, void* out, void* ssum,
                                    void* ssq, int N, int H, int W, int C,
                                    int Cout, int want_stats, void* stream) {
  using namespace conv_tile;
  Args args{(const bf16*)x, (const bf16*)w, (const float*)bias, (bf16*)out,
            (float*)ssum, (float*)ssq, N, H, W, C, Cout, want_stats};
  return launch(args, (cudaStream_t)stream);
}
