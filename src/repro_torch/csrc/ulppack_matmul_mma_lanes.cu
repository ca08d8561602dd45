// K2 on Hopper's int8 tensor cores for every layout of the family but
// int16xP2s8: int8xP2s4, int16xP4s4, int32xP2s8, int32xP4s8 and
// int32xP2s16 (the only layout of W4A4).  The build compiles this source
// once per layout (-DLANE_BYTES, -DN_PACK, -DSHIFT), each into its own
// library, so they compile in parallel.
//
// Replaces repro/kernels/ulppack_matmul.py:ulppack_matmul (Pallas kernel
// `_kernel` :31-55, pallas_call at :99) for these layouts, where the
// CUDA-core kernel (ulppack_matmul.cu: runs of k_tile lanes multiplied in
// packed space, then shift-mask extraction) served them.  In the
// overflow-free region the Pallas kernel's result is the plain integer dot
// of the lattices behind the lanes (ref.matmul_i32_ref), so the layout can
// be undone while the operands are staged: the kernel never multiplies in
// packed space.  Its W side (LanesW in mma_s8.cuh) stages the raw
// field-reversed weight lanes through the cp.async ring and writes each
// field to the plane byte an int16xP2s8 lane would have put it in after its
// hi / lo split; its a side (LanesA) does the same for ascending
// activation lanes.  From the planes on -- the u8 x u8 MMAs, the split-K
// fix-up, the affine epilogue -- everything is the int16xP2s8 route's
// (ulppack_matmul_mma.cu), bit for bit, and the float activations of the
// fused quantize (QuantA, K1 folded in) pair with these weight lanes as
// they do with int16xP2s8 ones, so ops.quantized_linear is one launch for
// every layout.  Activation lanes of this layout also pair with the
// bit-dense weight store (DenseW, w_bits 1 / 2 / 4 where the layout holds
// them), so a dense store is never expanded to lanes on the card.
//
// K is the tile's: K steps of two lattice values (kBK = 64 a stage, 128
// values = 2 kBK / N_PACK lanes), at most kMaxBlockK = 16384 steps (32768
// values) a split, so no s32 MMA sum reaches 2^31 (PTX does not promise
// that the MMA wraps); a split starts on a whole stage, so on a whole lane.
//
// Bound on Hopper: bytes, as the int16xP2s8 route, and these layouts move
// more of them a value: int32xP2s16 / int32xP2s8 16 bits a value (2x
// int16xP2s8's), int32xP4s8 8, int16xP4s4 / int8xP2s4 4.  The staging
// costs a few integer operations a value (byte moves for byte fields, a
// shift and a mask for nibbles), done once a stage by the whole block
// while the ring keeps the next stages' copies in flight.

#include "ulppack_matmul_mma.cuh"

#if !defined(LANE_BYTES) || !defined(N_PACK) || !defined(SHIFT)
#error "build with -DLANE_BYTES=1|2|4 -DN_PACK=2|4 -DSHIFT=4|8|16"
#endif

namespace {

using LW = LanesW<LANE_BYTES, N_PACK, SHIFT>;
using LA = LanesA<LANE_BYTES, N_PACK, SHIFT>;

bool is_layout(int lane_bytes, int n_pack, int shift) {
  return lane_bytes == LANE_BYTES && n_pack == N_PACK && shift == SHIFT;
}

// The dense store's W side for w_bits BITS; 4-bit words only where this
// layout's fields are bytes (nibble layouts hold w_bits <= 3).
template <int BITS, class... T>
int dense_launch(T... args) {
  if constexpr (BITS == 4 && SHIFT < 8)
    return static_cast<int>(cudaErrorInvalidValue);
  else
    return launch_mma<DenseW<BITS>, LA, false>(args...);
}

}  // namespace

// As ulppack_matmul_mma_launch, for this library's layout: a [M, Kp] lanes
// (ascending fields) and w [Kp, N] lanes (field-reversed) of lane_bytes
// bytes, n_pack fields `shift` bits apart, with Kp = ceil(2 K / n_pack):
// K counts K steps of two lattice values (for lanes in, K = Kp n_pack / 2;
// for x in, K = ceil(k_full / 2)), and so do block_k and step_k.  A
// layout other than this library's is refused with cudaErrorInvalidValue,
// as is a plan whose ring and shared memory are not this layout's
// (stages_for_w / smem_bytes_w with the lanes' tile and staged bytes).
REPRO_EXPORT int ulppack_matmul_mma_lanes_launch(
    const void* a, const void* w, void* out, void* work, void* tickets,
    const void* a_sums, const void* col_sums, const void* a_scale,
    const void* a_zp, const void* w_scale, const void* w_zp,
    const void* bias, int M, int K, int N, int k_full, int a_kind, int qmax,
    int out_kind, int bias_kind, int work_len, int tickets_len, int block_m,
    int block_n, int step_k, int block_k, int splits, int stages,
    int threads, int smem, int lane_bytes, int n_pack, int shift,
    int device, void* stream) {
  if (!is_layout(lane_bytes, n_pack, shift))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_mma<LW, LA>(
      a, w, out, work, tickets, a_sums, col_sums, a_scale, a_zp, w_scale,
      w_zp, bias, M, K, N, k_full, a_kind, qmax, out_kind, bias_kind,
      work_len, tickets_len, block_m, block_n, step_k, block_k, splits,
      stages, threads, smem, device, stream);
}

// Activation lanes of this layout (a_kind 0 only) against the bit-dense
// weight store: w [ceil(k_full / per), N] int32 words of w_bits-wide
// values (per = 32 / w_bits; w_bits 1 or 2, and 4 where the layout's
// fields are bytes), K = ceil(k_full / 2); otherwise as
// ulppack_matmul_mma_dense_launch.
REPRO_EXPORT int ulppack_matmul_mma_lanes_dense_launch(
    const void* a, const void* w, void* out, void* work, void* tickets,
    const void* a_sums, const void* col_sums, const void* a_scale,
    const void* a_zp, const void* w_scale, const void* w_zp,
    const void* bias, int M, int K, int N, int k_full, int a_kind, int qmax,
    int out_kind, int bias_kind, int work_len, int tickets_len, int block_m,
    int block_n, int step_k, int block_k, int splits, int stages,
    int threads, int smem, int w_bits, int lane_bytes, int n_pack,
    int shift, int device, void* stream) {
  if (!is_layout(lane_bytes, n_pack, shift))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (w_bits) {
    case 1:
    case 2:
    case 4:
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto launch = [&](auto bits) {
    return dense_launch<decltype(bits)::value>(
        a, w, out, work, tickets, a_sums, col_sums, a_scale, a_zp, w_scale,
        w_zp, bias, M, K, N, k_full, a_kind, qmax, out_kind, bias_kind,
        work_len, tickets_len, block_m, block_n, step_k, block_k, splits,
        stages, threads, smem, device, stream);
  };
  if (w_bits == 1) return launch(std::integral_constant<int, 1>());
  if (w_bits == 2) return launch(std::integral_constant<int, 2>());
  return launch(std::integral_constant<int, 4>());
}
