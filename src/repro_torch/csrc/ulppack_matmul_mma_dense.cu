// K2 on Hopper's int8 tensor cores over the bit-dense weight store: the
// tensor-core K2 of ulppack_matmul_mma.cu (int16xP2s8 activation lanes, or
// float activations quantized in the kernel with K1 folded in; the same
// MMAs, split-K fix-up and affine epilogue) with W read as int32 words of
// DENSE_W_BITS-wide lattice values (ops.dense_store_weights) and expanded
// in its staging pass (DenseW in mma_s8.cuh).  The build compiles this
// source once per w_bits (1, 2, 4: a 128-value stage is whole words),
// each into its own library, so the three compile in parallel.
//
// Replaces the reference's dense route of
// repro/kernels/ulppack_matmul.py:ulppack_matmul (pallas_call at :99), which
// expands the words to lanes ahead of the Pallas kernel
// (repro/kernels/ops.py:_packed_matmul_pallas): here the expansion happens
// in shared memory, so device memory holds and streams w_bits bits a
// value, a quarter (W2) or an eighth (W1) of the lanes' bytes.
//
// Bound on Hopper: bytes, like the lanes route; the words are the only
// operand that scales with N x K.  What the design does about it: the ring
// carries the raw words (2 x 64 / per rows of 128 columns a stage), and
// one pass a stage turns each word into the plane bytes the lanes' hi / lo
// split would have produced (8- or 16-byte conflict-free plane stores,
// swizzled raw rows for conflict-free reads), so everything after the
// planes -- MMAs, fix-up, epilogue -- is the lanes route's, bit for bit.

#include "ulppack_matmul_mma.cuh"

#ifndef DENSE_W_BITS
#error "build with -DDENSE_W_BITS=1, 2 or 4"
#endif

// As ulppack_matmul_mma_launch, with w [ceil(k_full / per), N] int32 words
// (per = 32 / w_bits values a word, ascending fields, zero tail) in place
// of lanes; `w_bits` must be this library's DENSE_W_BITS and k_full >= 1
// with K = ceil(k_full / 2) (a's lanes, or x's), or the launch is refused
// with cudaErrorInvalidValue, as is a plan whose ring and shared memory are
// not this layout's (stages_for_w / smem_bytes_w with the words' tile).
REPRO_EXPORT int ulppack_matmul_mma_dense_launch(
    const void* a, const void* w, void* out, void* work, void* tickets,
    const void* a_sums, const void* col_sums, const void* a_scale,
    const void* a_zp, const void* w_scale, const void* w_zp,
    const void* bias, int M, int K, int N, int k_full, int a_kind, int qmax,
    int out_kind, int bias_kind, int work_len, int tickets_len, int block_m,
    int block_n, int step_k, int block_k, int splits, int stages,
    int threads, int smem, int w_bits, int device, void* stream) {
  if (w_bits != DENSE_W_BITS)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_mma<DenseW<DENSE_W_BITS>>(
      a, w, out, work, tickets, a_sums, col_sums, a_scale, a_zp, w_scale,
      w_zp, bias, M, K, N, k_full, a_kind, qmax, out_kind, bias_kind,
      work_len, tickets_len, block_m, block_n, step_k, block_k, splits,
      stages, threads, smem, device, stream);
}
