// K5: the channel-packed ULPPACK conv2d on CUDA cores -- Sparq's
// Algorithm 1 (`vmacsr` after every packed multiply-accumulate group).
//
// Replaces repro/kernels/ulppack_conv2d.py:ulppack_conv2d (Pallas `_kernel`
// via `_tiled_conv_call`, pallas_call at :148).  x holds packed activation
// lanes [N, H, W, Cp] (int8/16/32, ascending fields); w holds field-
// reversed weight lanes [FH, FW, Cp, CO] ('lanes') or bit-dense int32 words
// [FH, FW, ceil(Cin / (32 / w_bits)), CO] ('dense', expanded to lanes while
// the weight block is staged).  out[n, oh, ow, co] is the exact int32
// lattice conv.  The tile, the padding and the extraction grouping are
// described in conv2d_tile.cuh.
//
// Why CUDA cores: this is the kernel of every layout but int16xP2s8
// (int8xP2s4, int16xP4s4, the int32 lanes), whose fields are not whole
// bytes, so their lanes have no reading as int8 tensor-core operands; it
// multiplies packed lanes in 32-bit integer registers (one IMAD per packed
// product, n_pack lattice MACs each).  int16xP2s8 lanes are lattice bytes,
// and the planner sends them to the tensor-core K5 (ulppack_conv2d_mma.cu);
// this kernel still takes them when its geometry is given.
//
// Bound on Hopper: at the model's and the paper's shapes the work is
// ~50-200 packed products per byte moved, so the kernel is bound by the
// CUDA cores' integer multiply-add rate (64 IMAD per SM per clock); the
// register window over the taps keeps shared-memory loads to about one per
// 10 products so the IMAD pipe, not the load pipe, is the limit.

#include "conv2d_tile.cuh"

REPRO_EXPORT int ulppack_conv2d_launch(
    const void* x, const void* w, void* out, int N, int H, int W, int Cp,
    int lane_bytes, int FH, int FW, int WC, int CO, int HO, int WO,
    int pad_top, int pad_left, int run, int band, int field_mask, int dense,
    int w_bits, int n_pack, int shift, int th, int bco, int cc, int threads,
    int smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (run < 1 || (dense && (w_bits < 1 || w_bits > 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  conv2d::Args a{x, w, static_cast<int32_t*>(out),
                 N, H, W, Cp, lane_bytes,
                 FH, FW, WC, CO, dense ? 4 : lane_bytes,
                 HO, WO, pad_top, pad_left,
                 run, band, static_cast<uint32_t>(field_mask),
                 dense, w_bits, n_pack, shift,
                 th, bco, cc, threads, smem};
  return static_cast<int>(
      conv2d::launch<true>(a, device, static_cast<cudaStream_t>(stream)));
}
