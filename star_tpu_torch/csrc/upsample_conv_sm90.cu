// Fused nearest-2x upsample + 3x3 SAME conv for Hopper (sm_90a) on wgmma +
// TMA: K7 of the port.
//
// Replaces `_upsample_kernel` of star_tpu/ops/conv3x3.py (its pallas_call
// in `upsample_conv2x_fused`, :1117): on the 2x grid every output pixel of
// phase (r, s) = (row % 2, col % 2) reads a fixed 2x2 window of the small
// grid, so the conv is four 2x2 convs on the small grid,
//   out[n, 2i+r, 2j+s] = sum_{p,q} x[n, i+r-1+p, j+s-1+q] . K_rs[p, q],
// whose weights K_rs are tap sums of the 3x3 weights (computed in fp32 and
// rounded once to bf16 by the wrapper, `phase_weights`). Zeros outside the
// small grid are the SAME padding of the upsampled one; there is no
// activation. fp32 accumulation + fp32 bias, one rounding to bf16, written
// straight to out[2i+r, 2j+s] (the phase outputs never reach device
// memory), and the fp32 (sum, sumsq) of the stored values per (image,
// channel).
//
// What bounds it on the H100: tensor-core operations. Per output pixel it
// does 2*4*C*Cout FLOPs (2.25x fewer than the 3x3 on the upsampled grid)
// against C/2 + Cout bytes (x read once for four outputs): at the 256-
// channel upsample 2730 FLOP/byte, nine times the card's 295. Beside the
// products: the weights, which every tile reads again from L2 (256 FLOPs
// a weight byte, the patch's pixels), and the halo, read again for each of
// the 4 * Cout/128 tiles of a patch (from L2: they are adjacent in the
// walk). Measured (`chip_variants.py k7`): with its products stubbed out
// the kernel takes nearly as long, so these loads and the epilogue (both
// consumer groups at once) bound it, as they bound K6.
//
// Design: the halo conv of halo_conv_sm90.cuh (K6's kernel) with four
// phases of four taps and no transform: a tile is one phase (r, s) of a
// 16x16 patch of the small grid and 128 output channels; tap (p, q) reads
// halo cell (r+p, s+q) of the same 18x18 halo, 16*(18*(r+p) + s+q) bytes
// in; TMA's zero fill is the SAME padding; the weights are row 4*(2r+s) +
// 2p + q of the [Cout, 16, C] layout the wrapper makes; and each phase
// stores through its own map of out (a 4-D view [N][H][W][Cout] of
// out[n, 2i+r, 2j+s, :]: (2W*r + s)*Cout elements on, byte strides 4*Cout
// (j), 8*W*Cout (i), 8*H*W*Cout (n)), clipped at the small grid's edges.
// The launch arithmetic (maps, tiles, grid, shared memory, tap offsets) is
// `upsample_conv2x_launch_plan` in star_tpu_torch/ops/upsample_conv.py,
// whose phase map offsets, strides and tap offsets the entry point takes.

#include "halo_conv_sm90.cuh"

__global__ void __launch_bounds__(halo::THREADS, 1)
upsample_conv_sm90(const __grid_constant__ CUtensorMap tx,
                   const __grid_constant__ CUtensorMap tw,
                   const __grid_constant__ halo::OutMaps<halo::UpsampleForm>
                       maps,
                   const __grid_constant__ halo::Params p) {
  halo::body<halo::UpsampleForm>(tx, tw, maps, p);
}

// x [N,H,W,C] bf16; w [Cout,16,C] bf16 (row 4*(2r+s) + 2p + q: K_rs[p,q]
// transposed); bias [Cout] fp32; out [N,2H,2W,Cout] bf16; sum/sumsq
// [N,Cout] fp32 zeroed by the caller (ignored without want_stats); the
// plan's out_offset [4] (elements: phase 2r+s's view starts there),
// out_strides [3] (bytes: j, i, n) and tap_bytes [16] (tap (p, q) of phase
// 2r+s at 4*(2r+s) + 2p + q); `grid` persistent blocks. Requires C % 64
// == 0 and Cout % 128 == 0.
extern "C" int star_upsample_conv2x(const void* x, const void* w,
                                    const void* bias, void* out, void* ssum,
                                    void* ssq, int N, int H, int W, int C,
                                    int Cout, int want_stats,
                                    const long long* out_offset,
                                    const long long* out_strides,
                                    const int* tap_bytes, int grid,
                                    void* stream) {
  using namespace halo;
  Params p{nullptr, nullptr, (const float*)bias, (float*)ssum, (float*)ssq,
           N, H, W, C, Cout, 0, 0, 0, 0, want_stats, {}};
  for (int j = 0; j < 16; ++j) p.tap_bytes[j] = tap_bytes[j];
  return launch<UpsampleForm>(upsample_conv_sm90, x, w, nullptr, out,
                              out_offset, out_strides, p, grid, stream);
}
