// K2 on Hopper's int8 tensor cores: the packed-lane matmul of the
// int16xP2s8 layout, with the affine epilogue of ops.quantized_linear.
//
// Replaces repro/kernels/ulppack_matmul.py:ulppack_matmul (Pallas kernel
// `_kernel`, pallas_call at :99) for int16 lanes of two 8-bit fields, the
// layout of every shipped W2A2 config; every other layout keeps the
// CUDA-core kernel of ulppack_matmul.cu.  For activation lanes a [M, K]
// (field j of lane k = lattice value 2k + j, at bit 8j) and field-reversed
// weight lanes w [K, N] (lattice value 2k at bit 8, 2k + 1 at bit 0), each
// byte of a lane is one lattice value, so the exact lattice dot is
//   out[m, n] = sum_k lo(a[m,k]) * hi(w[k,n]) + hi(a[m,k]) * lo(w[k,n])
// -- two u8 x u8 products per lane on the int8 tensor cores, with no
// packed-space product, no k_tile runs and no shift-mask extraction.  It
// equals ref.packed_matmul_ref / packing.packed_lanes_matmul bit for bit.
//
// Bound on Hopper: bytes, at decode (M = 4) and at prefill (M = 64) alike
// once on the tensor cores: (64, 1024, 5632) is 0.74 G int8 MACs, 0.75 us
// at the int8 rate, against 3.9 us for its 11.5 MB.  (On the CUDA cores
// the same call is 369 M 32-bit multiply-adds, >= 22 us: the old kernel's
// ceiling.)  So the design streams the weight lanes once with enough
// bytes in flight, on K7's tile (mma_s8.cuh: W as the MMA's A operand,
// 128 columns a block, rows of m in groups of 8, a cp.async ring of raw W
// tiles transposed with prmt into K-major byte planes in shared memory):
//
// - Both operands are 2-byte and split into byte planes (plane 0 = hi,
//   plane 1 = lo), W's in the transposing pass, a's in a pass over its
//   staged rows.  A k32 step is two mma_m16n8k32<u8, u8> into one s32
//   accumulator: W's hi plane x a's lo plane, W's lo x a's hi.  The fields
//   are unsigned lattices, so both planes are read as u8.
// - No accumulator may leave the int32 range (PTX does not promise that
//   the MMA wraps): each lane adds at most 2 * 255^2, so a K split holds at
//   most kMaxBlockK = 16384 lanes (32768 lattice values; 255^2 * 32768 <
//   2^31).  The planner owns that limit and this launcher refuses more.
// - One launch a call, with no zero fill and no atomics on the output.
//   The grid is (N tiles, M tiles, K splits).  With one split a block
//   applies the epilogue and stores.  Otherwise each block writes its s32
//   tile to the workspace [splits, M, N] and draws a ticket for its output
//   tile (one acq_rel atomic by one thread, between two barriers: a
//   device-wide fence by every thread cost more); the block that draws the
//   last one reads the partials
//   through L2 (__ldcg), sums them in split order (exact integers, the same
//   bits on every run), applies the epilogue, stores, and puts the ticket
//   back to 0.  The wrapper owns the workspace and the tickets (zeroed
//   once, at fixed addresses), so a call can be captured in a CUDA graph.
// - Epilogue, chosen at launch: the s32 dot (ops.packed_matmul), or the
//   affine map of ops.quantized_linear in its eager order and rounding,
//     out = (a_scale * w_scale)
//           * (((acc - w_zp * a_sum) - a_zp * col_sum) + (k * a_zp) * w_zp)
//           [+ bias]
//   one f32 operation at a time with the _rn intrinsics (nvcc would
//   contract a * b + c into an FMA, which rounds once where PyTorch rounds
//   twice), stored as f32, bf16 or f16 rounded to nearest even.  The four
//   scalars are read from device memory, never from the host.
// - Edge tiles are masked (M, N and K are not padded on the host; lanes
//   past K are zero in the ring).
// - K1 folded in (a_kind 1-3, the serving path's route): the block stages
//   the float activations x [M, k_full] (f32, bf16 or f16, read in their
//   own type; 2 x 64 values a row a stage) in place of lanes, and its
//   plane pass quantizes them to K1's lattice (clip(rint(x / scale) + zp);
//   values past k_full forced to 0) straight into the hi and lo planes
//   that an int16xP2s8 lane splits into, so the MMAs and their functor are
//   unchanged.  The quotient's rounding is decided by a multiply by 1 /
//   scale wherever that is provably exact, by K1's IEEE divide elsewhere
//   (QuantA in mma_s8.cuh).  The pass also adds up the lattice row sums:
//   with one split the block reduces them (half-warp shuffles, then
//   shared memory) for the epilogue; with several each block writes its
//   rows' partial sums for its own (split, N tile) beside the partial
//   dots, and the fix-up block sums its tile's in split order.  One launch
//   reads x once per N tile (each N tile re-quantizes its rows), and the
//   output equals K1 on x.float() followed by the lanes route with the
//   affine epilogue, bit for bit.
// - The bit-dense weight store (ops.dense_store_weights: int32 words of
//   w_bits values) takes the same kernel with another W side: DenseW in
//   mma_s8.cuh stages the words and expands them into the planes the
//   lanes' hi / lo split produces, so the MMAs, the fix-up and the
//   epilogue are these.  The kernel and its launcher live in
//   ulppack_matmul_mma.cuh, shared with ulppack_matmul_mma_dense.cu (one
//   library per w_bits); this file instantiates the lanes' W side, RawW<2>.
// - Launch geometry is the planner's (_plan_packed_matmul, and
//   _plan_quantized_linear for x, in repro_torch/kernels/plan.py, which
//   mirror the tile's constants in mma_s8.cuh and kMaxBlockK in
//   ulppack_matmul_mma.cuh); the launcher refuses a plan that disagrees
//   with this layout.

#include "ulppack_matmul_mma.cuh"

// a [M, K] and w [K, N] int16 lanes (int16xP2s8), row-major.  out [M, N]:
// int32 (out_kind 0) or, with the affine epilogue, f32 / bf16 / f16
// (out_kind 1 / 2 / 3), which reads a_sums [M], col_sums [N], the 0-dim
// a_scale (f32), a_zp (int32), w_scale (f32), w_zp (int32), k_full (the
// lattice K) and bias [N] (bias_kind 1: f32, 2: bf16; 0: none).  With
// a_kind 1 / 2 / 3, `a` is instead x [M, k_full] of f32 / bf16 / f16, K =
// ceil(k_full / 2) lanes, quantized in the kernel with a_scale, a_zp and
// qmax (K1 fused: the epilogue must be affine, and a_sums is not read).
// With splits > 1, `work` holds at least work_len int32 (splits * M * N
// needed, and splits * ceil(N / 128) * M more with x) and `tickets` at
// least tickets_len words (one per output tile), all 0.  The plan (block_m
// rows of m and block_n = 128 columns a block, step_k = 64 lanes a stage,
// the ring depth `stages` of stages_for() for a's staged bytes -- 2 a lane
// for lanes, 2 x the element size for x --, `threads` = 256, K in `splits`
// runs of block_k lanes, a multiple of 64 and at most 16384, with splits =
// ceil(K / block_k), and smem_bytes of dynamic shared memory) must match
// this kernel's layout, or the launch is refused with
// cudaErrorInvalidValue, as are missing operands of the chosen epilogue.
REPRO_EXPORT int ulppack_matmul_mma_launch(
    const void* a, const void* w, void* out, void* work, void* tickets,
    const void* a_sums, const void* col_sums, const void* a_scale,
    const void* a_zp, const void* w_scale, const void* w_zp,
    const void* bias, int M, int K, int N, int k_full, int a_kind, int qmax,
    int out_kind, int bias_kind, int work_len, int tickets_len, int block_m,
    int block_n, int step_k, int block_k, int splits, int stages,
    int threads, int smem, int device, void* stream) {
  return launch_mma<RawW<2>>(
      a, w, out, work, tickets, a_sums, col_sums, a_scale, a_zp, w_scale,
      w_zp, bias, M, K, N, k_full, a_kind, qmax, out_kind, bias_kind,
      work_len, tickets_len, block_m, block_n, step_k, block_k, splits,
      stages, threads, smem, device, stream);
}
