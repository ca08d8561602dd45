// K2: ULPPACK packed-lane matmul on CUDA cores -- Sparq's `vmacsr`.
//
// Replaces the Pallas kernel repro/kernels/ulppack_matmul.py:ulppack_matmul
// (`_kernel`, pallas_call at :99).  For packed activation lanes a [M, Kp]
// and field-reversed weight lanes w [Kp, N] (one lane dtype, int8/16/32):
//   out[m, n] = sum over runs R of ((sum_{k in R} a[m,k] * w[k,n]) >> band)
//                                  & field_mask
// where each run R holds at most k_tile lanes, so the extracted band is the
// exact lattice dot of the run (core/packing.py:k_tile_bound).  The packed
// products wrap mod 2^32 by design; they are accumulated in uint32 because
// signed overflow is undefined in C++.  The total is the exact int32 dot.
//
// Why CUDA cores: Hopper's integer tensor-core MMA takes 8-bit operands
// only, and every layout feasible at W2A2 uses 16- or 32-bit lanes, so the
// faithful kernel multiplies packed lanes in 32-bit integer registers.
//
// Bound on Hopper: at decode (M = 4) the kernel streams the weight lanes
// once, so it is bound by bytes; at prefill (M = 64) the multiply-adds
// dominate.  Design: one thread owns CPT neighbouring output columns (an
// 8-byte vector load of w per k), so a warp reads a contiguous 256-byte span
// of each weight row; the block stages its BM activation rows in shared
// memory in chunks of KC lanes and every thread keeps BM x CPT accumulators
// in registers.  The grid is (column blocks, row blocks, K splits): the
// split-K dimension fills the card at decode, where N / columns-per-block
// alone gives too few blocks.  Splits add their exact integer partials with
// atomicAdd (integer addition is order-free, so the result is
// deterministic); with one split the block stores directly.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int KC = 256;  // activation lanes staged in shared memory per pass

template <typename Lane>
struct Vec8;  // 8 bytes of lanes
template <> struct Vec8<int8_t> { using T = int2; static constexpr int n = 8; };
template <> struct Vec8<int16_t> { using T = int2; static constexpr int n = 4; };
template <> struct Vec8<int32_t> { using T = int2; static constexpr int n = 2; };

template <typename Lane, int BM>
__global__ void __launch_bounds__(kThreads)
ulppack_matmul_kernel(const Lane* __restrict__ a, const Lane* __restrict__ w,
                      int32_t* __restrict__ out, int M, int Kp, int N,
                      int run, int band, uint32_t mask, int lanes_per_split,
                      int vec, int atomic) {
  constexpr int CPT = Vec8<Lane>::n;
  __shared__ int32_t sa[BM][KC];

  const int n0 = (blockIdx.x * kThreads + threadIdx.x) * CPT;
  const int m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * lanes_per_split;
  const int k_end = min(Kp, k_begin + lanes_per_split);
  // chunk length: whole runs, so a run never straddles two chunks
  const int kc_max = run >= KC ? KC : (KC / run) * run;

  uint32_t acc[BM][CPT], tot[BM][CPT];
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = tot[r][c] = 0u;

  int in_run = 0;  // lanes accumulated since the last extraction
  for (int k0 = k_begin; k0 < k_end; k0 += kc_max) {
    const int kc = min(kc_max, k_end - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * kc_max; i += kThreads) {
      const int r = i / kc_max, kk = i - r * kc_max;
      sa[r][kk] = (m0 + r < M && kk < kc)
          ? static_cast<int32_t>(a[static_cast<size_t>(m0 + r) * Kp + k0 + kk])
          : 0;
    }
    __syncthreads();
    if (n0 < N) {
      const Lane* wb = w + static_cast<size_t>(k0) * N + n0;
      int kk = 0;
      while (kk < kc) {
        // lanes up to the end of the current run: a branch-free inner loop
        // the compiler can unroll, so several weight loads are in flight
        const int stop = min(kc, kk + (run - in_run));
        in_run += stop - kk;
#pragma unroll 4
        for (; kk < stop; ++kk) {
          const Lane* wp = wb + static_cast<size_t>(kk) * N;
          union {
            typename Vec8<Lane>::T v;
            Lane l[CPT];
          } wv;
          if (vec) {
            wv.v = __ldg(reinterpret_cast<const typename Vec8<Lane>::T*>(wp));
          } else {
#pragma unroll
            for (int c = 0; c < CPT; ++c)
              wv.l[c] = n0 + c < N ? wp[c] : Lane(0);
          }
#pragma unroll
          for (int r = 0; r < BM; ++r) {
            const uint32_t av = static_cast<uint32_t>(sa[r][kk]);
#pragma unroll
            for (int c = 0; c < CPT; ++c)
              acc[r][c] +=
                  av * static_cast<uint32_t>(static_cast<int32_t>(wv.l[c]));
          }
        }
        if (in_run == run) {
#pragma unroll
          for (int r = 0; r < BM; ++r)
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
              tot[r][c] += (acc[r][c] >> band) & mask;
              acc[r][c] = 0u;
            }
          in_run = 0;
        }
      }
    }
  }
  if (n0 >= N) return;
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    if (m0 + r >= M) break;
    int32_t* o = out + static_cast<size_t>(m0 + r) * N + n0;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      if (n0 + c >= N) break;
      const int32_t v = static_cast<int32_t>(tot[r][c] + ((acc[r][c] >> band) & mask));
      if (atomic) atomicAdd(o + c, v); else o[c] = v;
    }
  }
}

template <typename Lane>
cudaError_t launch_lane(const void* a, const void* w, void* out, int M,
                        int Kp, int N, int run, int band, uint32_t mask,
                        int lanes_per_split, int splits, int bm,
                        cudaStream_t s) {
  constexpr int CPT = Vec8<Lane>::n;
  const int cols_per_block = kThreads * CPT;
  const int vec = (N % CPT == 0) &&
      (reinterpret_cast<uintptr_t>(w) % 8 == 0);
  const int atomic = splits > 1;
  const dim3 grid((N + cols_per_block - 1) / cols_per_block,
                  (M + bm - 1) / bm, splits);
  const Lane* ap = static_cast<const Lane*>(a);
  const Lane* wp = static_cast<const Lane*>(w);
  int32_t* op = static_cast<int32_t*>(out);
  switch (bm) {
    case 4:
      ulppack_matmul_kernel<Lane, 4><<<grid, kThreads, 0, s>>>(
          ap, wp, op, M, Kp, N, run, band, mask, lanes_per_split, vec, atomic);
      break;
    case 8:
      ulppack_matmul_kernel<Lane, 8><<<grid, kThreads, 0, s>>>(
          ap, wp, op, M, Kp, N, run, band, mask, lanes_per_split, vec, atomic);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// `out` must be zero-filled by the caller when splits > 1.
REPRO_EXPORT int ulppack_matmul_launch(const void* a, const void* w,
                                       void* out, int M, int Kp, int N,
                                       int lane_bytes, int run, int band,
                                       int field_mask, int lanes_per_split,
                                       int splits, int bm, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t mask = static_cast<uint32_t>(field_mask);
  switch (lane_bytes) {
    case 1:
      err = launch_lane<int8_t>(a, w, out, M, Kp, N, run, band, mask,
                                lanes_per_split, splits, bm, s);
      break;
    case 2:
      err = launch_lane<int16_t>(a, w, out, M, Kp, N, run, band, mask,
                                 lanes_per_split, splits, bm, s);
      break;
    case 4:
      err = launch_lane<int32_t>(a, w, out, M, Kp, N, run, band, mask,
                                 lanes_per_split, splits, bm, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
