// K7: the unpacked integer matmul, s8/s16 x s8/s16 -> s32.
//
// Replaces repro/kernels/ulppack_matmul.py:int_matmul (Pallas kernel
// `_int_kernel`, pallas_call at :145): the W8A8 / out-of-region fallback and
// the int8 baseline row of benchmarks/serve_microbench.py.  out[m, n] =
// sum_k a[m, k] * w[k, n], wrapped mod 2^32 like XLA's s32 dot.
//
// Bound on Hopper: bytes.  At M <= 64 the weight W [K, N] is nearly all of
// the traffic (16.8 MB at 4096 x 4096 s8), and its products on the int8
// tensor cores take a fifth of the time its bytes take; they would set the
// pace only from M ~ 300.  So the design streams W once, with enough bytes
// in flight, and keeps the products on mma.sync (mma_s8.cuh):
//
// - The tile is mma_s8.cuh's (its note gives the layout): W is the MMA's
//   A operand, 8 warps x 16 output columns, the block's BM rows m in
//   groups of 8 (BM = 8 wastes nothing at decode), W streamed through a
//   cp.async ring and transposed with prmt into K-major byte planes in
//   shared memory, never in device memory.
// - s16 operands are split into two byte planes, x = hi * 2^8 + lo with
//   lo = x & 0xFF (u8) and hi = x >> 8 (s8): W's in the transposing pass,
//   a's in a pass over its staged rows.  A product of two s16 operands is
//   four MMAs into four s32 accumulators, combined in uint32 as
//   (hh << 16) + ((hl + lh) << 8) + ll; s8 x s16 is two.
// - No accumulator may leave the int32 range (PTX does not promise that
//   the MMA wraps): the worst, lo x lo, gains at most 255 * 255 per k, so a
//   K split holds at most kMaxBlockK = 32768 (255^2 * 32768 < 2^31).  The
//   planner owns that limit and this launcher refuses a larger block_k.
// - The grid is (N tiles, M tiles, K splits); splits add into the zeroed
//   output with 32-bit integer atomics, which wrap mod 2^32 in any order,
//   so the result is exact and two launches are bit-equal.
// - Launch geometry is the planner's (_plan_int_matmul in
//   repro_torch/kernels/plan.py, which mirrors the tile's constants in
//   mma_s8.cuh and kMaxBlockK below); the launcher refuses a plan that
//   disagrees with this layout.

#include "common.cuh"
#include "mma_s8.cuh"

namespace {

using namespace mma_s8;

constexpr int kMaxBlockK = 32768;  // K per split at most (int32 sums)

struct Args {
  const unsigned char* a;
  const unsigned char* w;
  int32_t* out;
  int M, K, N, block_k, splits;
  int cb_a, cb_w;  // copy bytes (16, 8, 4; 0: plain loads)
};

// d += (W plane pw) x (a plane pa): plane 0 of an s16 operand is its high
// byte (signed, weight 2^8), plane 1 its low byte (unsigned); an s8
// operand is one signed plane.  pw and pa are unrolled loop indices, so
// the branches fold.
template <int AB, int WB>
__device__ __forceinline__ void mma_planes(int32_t (&d)[4],
                                           const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1, int pw,
                                           int pa) {
  const bool ws = WB == 1 || pw == 0, as = AB == 1 || pa == 0;
  if (ws && as)
    mma_m16n8k32<true, true>(d, a, b0, b1);
  else if (ws)
    mma_m16n8k32<true, false>(d, a, b0, b1);
  else if (as)
    mma_m16n8k32<false, true>(d, a, b0, b1);
  else
    mma_m16n8k32<false, false>(d, a, b0, b1);
}

template <int AB, int WB, int BM, bool V16>
__global__ void __launch_bounds__(kThreads)
int_matmul_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int k_lo = blockIdx.z * p.block_k;
  const int k_hi = min(p.K, k_lo + p.block_k);
  constexpr int MG = BM / 8;  // 8-row groups of m

  int32_t acc[MG][WB][AB][4];
#pragma unroll
  for (int j = 0; j < MG; ++j)
#pragma unroll
    for (int pw = 0; pw < WB; ++pw)
#pragma unroll
      for (int pa = 0; pa < AB; ++pa)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][pw][pa][i] = 0;

  mainloop<WB, BM, V16>(
      p, smem, m0, n0, k_lo, k_hi, RawA<AB>(),
      [&](int j, int pw, int pa, const uint32_t(&a)[4], uint32_t b0,
          uint32_t b1) {
        mma_planes<AB, WB>(acc[j][pw][pa], a, b0, b1, pw, pa);
      });

  // d_i of group j is out[m0 + 8j + 2t + (i & 1)][n0 + 16 warp + g + 8 (i >> 1)]
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < MG; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + 8 * j + 2 * t + (i & 1);
      const int n = n0 + 16 * warp + g + 8 * (i >> 1);
      uint32_t v = 0u;
#pragma unroll
      for (int pw = 0; pw < WB; ++pw)
#pragma unroll
        for (int pa = 0; pa < AB; ++pa)
          v += static_cast<uint32_t>(acc[j][pw][pa][i])
               << ((WB == 2 && pw == 0 ? 8 : 0) + (AB == 2 && pa == 0 ? 8 : 0));
      if (m < p.M && n < p.N) {
        int32_t* o = p.out + static_cast<size_t>(m) * p.N + n;
        if (p.splits == 1)
          *o = static_cast<int32_t>(v);
        else
          atomicAdd(reinterpret_cast<unsigned int*>(o), v);
      }
    }
  }
}

template <int AB, int WB, int BM, bool V16>
cudaError_t launch_variant(const Args& p, int device, cudaStream_t s) {
  void (*kern)(Args) = int_matmul_kernel<AB, WB, BM, V16>;
  constexpr int smem = smem_bytes(BM, AB, WB);
  static bool raised[8] = {false};  // per device, this instantiation
  if (smem > 48 * 1024 && !raised[device & 7]) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    raised[device & 7] = true;
  }
  const dim3 grid((p.N + kBN - 1) / kBN, (p.M + BM - 1) / BM, p.splits);
  kern<<<grid, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

template <int AB, int WB, bool V16>
cudaError_t launch_bm(const Args& p, int block_m, int device,
                      cudaStream_t s) {
  switch (block_m) {
    case 8: return launch_variant<AB, WB, 8, V16>(p, device, s);
    case 16: return launch_variant<AB, WB, 16, V16>(p, device, s);
    case 32: return launch_variant<AB, WB, 32, V16>(p, device, s);
    case 64: return launch_variant<AB, WB, 64, V16>(p, device, s);
    default: return cudaErrorInvalidValue;
  }
}

// 16-byte copies of both operands in a fixed count per thread (a kernel of
// its own, which measured faster at M = 64 than one kernel taking either
// path), or the ladder of copy sizes.
template <int AB, int WB>
cudaError_t launch_types(const Args& p, int block_m, int device,
                         cudaStream_t s) {
  if (p.cb_a == 16 && p.cb_w == 16)
    return launch_bm<AB, WB, true>(p, block_m, device, s);
  return launch_bm<AB, WB, false>(p, block_m, device, s);
}

}  // namespace

// a [M, K] and w [K, N], row-major, of a_bytes / w_bytes (1: int8, 2: int16)
// each; out [M, N] int32, zeroed by the caller when splits > 1.  The plan
// (block_m rows of m and block_n = 128 columns a block, step_k = 64 K a
// stage, the ring depth `stages` of stages_for(), `threads` = 256, K in
// `splits` runs of block_k, a multiple of 64 and at most 32768, with
// splits = ceil(K / block_k), and smem_bytes of dynamic shared memory)
// must match this kernel's layout, or the launch is refused with
// cudaErrorInvalidValue.
REPRO_EXPORT int int_matmul_launch(const void* a, const void* w, void* out,
                                   int M, int K, int N, int a_bytes,
                                   int w_bytes, int block_m, int block_n,
                                   int step_k, int block_k, int splits,
                                   int stages, int threads, int smem,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool bm_ok = block_m == 8 || block_m == 16 || block_m == 32 ||
                     block_m == 64;
  const bool types_ok = (a_bytes == 1 || a_bytes == 2) &&
                        (w_bytes == 1 || w_bytes == 2);
  if (M < 1 || N < 1 || K < 0 || !bm_ok || !types_ok || block_n != kBN ||
      step_k != kBK || stages != stages_for(block_m, a_bytes, w_bytes) ||
      threads != kThreads ||
      block_k < kBK || block_k > kMaxBlockK || block_k % kBK != 0 ||
      splits != (K > 0 ? (K + block_k - 1) / block_k : 1) ||
      splits > 65535 || (M + block_m - 1) / block_m > 65535 ||
      smem != smem_bytes(block_m, a_bytes, w_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  Args p;
  p.a = static_cast<const unsigned char*>(a);
  p.w = static_cast<const unsigned char*>(w);
  p.out = static_cast<int32_t*>(out);
  p.M = M;
  p.K = K;
  p.N = N;
  p.block_k = block_k;
  p.splits = splits;
  p.cb_a = copy_bytes(a, static_cast<long long>(K) * a_bytes);
  p.cb_w = copy_bytes(w, static_cast<long long>(N) * w_bytes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_bytes == 1 && w_bytes == 1)
    err = launch_types<1, 1>(p, block_m, device, s);
  else if (a_bytes == 1)
    err = launch_types<1, 2>(p, block_m, device, s);
  else if (w_bytes == 1)
    err = launch_types<2, 1>(p, block_m, device, s);
  else
    err = launch_types<2, 2>(p, block_m, device, s);
  return static_cast<int>(err);
}
