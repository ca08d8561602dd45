// K6: the unpacked integer conv2d on CUDA cores -- the paper's int16
// baseline (Fig. 4).
//
// Replaces repro/kernels/ulppack_conv2d.py:int_conv2d (Pallas
// `_int_kernel` via `_tiled_conv_call`, pallas_call at :148).  x [N, H, W,
// C] and w [FH, FW, C, CO] hold int8 or int16 values (each operand its own
// width), widened to 32 bits; out is the int32 conv, wrapped mod 2^32 like
// XLA's s32.  Same tile as K5 (conv2d_tile.cuh) without packing or
// extraction.
//
// Bound on Hopper: one IMAD per MAC on the CUDA cores.  The card's int8
// tensor cores could take it only after splitting each 9- to 16-bit
// operand into bytes (four int8 products per MAC); a tensor-core variant is
// later work.

#include "conv2d_tile.cuh"

REPRO_EXPORT int int_conv2d_launch(
    const void* x, const void* w, void* out, int N, int H, int W, int C,
    int x_bytes, int FH, int FW, int CO, int w_bytes, int HO, int WO,
    int pad_top, int pad_left, int th, int bco, int cc, int threads,
    int smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv2d::Args a{x, w, static_cast<int32_t*>(out),
                 N, H, W, C, x_bytes,
                 FH, FW, C, CO, w_bytes,
                 HO, WO, pad_top, pad_left,
                 0, 0, 0u,
                 0, 0, 0, 0,
                 th, bco, cc, threads, smem};
  return static_cast<int>(
      conv2d::launch<false>(a, device, static_cast<cudaStream_t>(stream)));
}
