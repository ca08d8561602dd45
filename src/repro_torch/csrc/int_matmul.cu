// K7: the unpacked integer matmul, s8/s16 x s8/s16 -> s32.
//
// Replaces repro/kernels/ulppack_matmul.py:int_matmul (Pallas kernel
// `_int_kernel`, pallas_call at :145): the W8A8 / out-of-region fallback and
// the int8 baseline row of benchmarks/serve_microbench.py.  out[m, n] =
// sum_k a[m, k] * w[k, n], wrapped mod 2^32 like XLA's s32 dot: products
// and sums are taken in uint32 (a signed overflow in CUDA C++ is undefined),
// which gives the same low 32 bits.
//
// Bound on Hopper: at decode shapes (M = 8) bytes -- the weight matrix is
// read once; at M = 64 still bytes for s8 on the int8 tensor cores.  Design
// (simple, on the CUDA cores): a block computes a BM x BN output tile with
// 256 threads (16 x 16), each thread BM/16 x BN/16 outputs at rows ty + 16i,
// columns tx + 16j; K advances in steps of BK = 32, staging the A tile
// (transposed, so a thread's rows are one broadcast read) and the W tile in
// shared memory, both widened to int32 as they are stored (as
// conv2d_tile.cuh does).  Edge tiles are masked on load and store: any M, K
// and N, no padding copies.  Small M takes BM = 16, BN = 32.  K is split
// over blockIdx.z (`splits` runs of `block_k`, a multiple of BK) so that
// enough blocks are in flight to hide the load latency of each K step; the
// splits add into the zeroed output with 32-bit integer atomics, which
// wrap mod 2^32 in any order, so the result does not depend on it.  The s8
// tensor-core version (mma.sync / wgmma s8) is later work.

#include "common.cuh"

namespace {

constexpr int kBK = 32;
constexpr int kThreads = 256;

template <typename TA, typename TW, int BM, int BN>
__global__ void __launch_bounds__(kThreads)
int_matmul_kernel(const TA* __restrict__ a, const TW* __restrict__ w,
                  int32_t* __restrict__ out, int M, int K, int N,
                  int block_k, int splits) {
  constexpr int TM = BM / 16, TN = BN / 16;
  // +1 column: the transposed stores of a warp hit 32 banks, not one
  __shared__ int32_t as[kBK][BM + 1];
  __shared__ int32_t ws[kBK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  uint32_t acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0u;

  const int k_lo = blockIdx.z * block_k;
  const int k_hi = min(K, k_lo + block_k);
  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    for (int e = tid; e < BM * kBK; e += kThreads) {
      const int r = e / kBK, kk = e % kBK;
      const int gm = m0 + r, gk = k0 + kk;
      as[kk][r] = (gm < M && gk < k_hi)
                      ? static_cast<int32_t>(a[static_cast<size_t>(gm) * K + gk])
                      : 0;
    }
    for (int e = tid; e < kBK * BN; e += kThreads) {
      const int kk = e / BN, c = e % BN;
      const int gk = k0 + kk, gn = n0 + c;
      ws[kk][c] = (gk < k_hi && gn < N)
                      ? static_cast<int32_t>(w[static_cast<size_t>(gk) * N + gn])
                      : 0;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      uint32_t av[TM], wv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        av[i] = static_cast<uint32_t>(as[kk][ty + 16 * i]);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        wv[j] = static_cast<uint32_t>(ws[kk][tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += av[i] * wv[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      int32_t* o = out + static_cast<size_t>(gm) * N + gn;
      if (splits == 1)
        *o = static_cast<int32_t>(acc[i][j]);
      else
        atomicAdd(reinterpret_cast<unsigned int*>(o), acc[i][j]);
    }
  }
}

template <typename TA, typename TW>
cudaError_t launch_types(const void* a, const void* w, int32_t* out, int M,
                         int K, int N, int block_m, int block_k, int splits,
                         cudaStream_t s) {
  const TA* ap = static_cast<const TA*>(a);
  const TW* wp = static_cast<const TW*>(w);
  if (block_m == 16) {
    const dim3 grid((N + 31) / 32, (M + 15) / 16, splits);
    int_matmul_kernel<TA, TW, 16, 32><<<grid, kThreads, 0, s>>>(
        ap, wp, out, M, K, N, block_k, splits);
  } else if (block_m == 64) {
    const dim3 grid((N + 63) / 64, (M + 63) / 64, splits);
    int_matmul_kernel<TA, TW, 64, 64><<<grid, kThreads, 0, s>>>(
        ap, wp, out, M, K, N, block_k, splits);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// a [M, K] and w [K, N], row-major, of a_bytes / w_bytes (1: int8, 2: int16)
// each; out [M, N] int32, zeroed by the caller when splits > 1.  block_m is
// 16 (tile 16 x 32) or 64 (64 x 64); K is cut into `splits` runs of block_k
// (a multiple of 32) with splits * block_k >= K.
REPRO_EXPORT int int_matmul_launch(const void* a, const void* w, void* out,
                                   int M, int K, int N, int a_bytes,
                                   int w_bytes, int block_m, int block_k,
                                   int splits, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M < 1 || N < 1 || K < 0 || splits < 1 || splits > 65535 ||
      block_k < kBK || block_k % kBK != 0 ||
      static_cast<long long>(splits) * block_k < K)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* o = static_cast<int32_t*>(out);
  if (a_bytes == 1 && w_bytes == 1)
    err = launch_types<int8_t, int8_t>(a, w, o, M, K, N, block_m, block_k,
                                       splits, s);
  else if (a_bytes == 1 && w_bytes == 2)
    err = launch_types<int8_t, int16_t>(a, w, o, M, K, N, block_m, block_k,
                                        splits, s);
  else if (a_bytes == 2 && w_bytes == 1)
    err = launch_types<int16_t, int8_t>(a, w, o, M, K, N, block_m, block_k,
                                        splits, s);
  else if (a_bytes == 2 && w_bytes == 2)
    err = launch_types<int16_t, int16_t>(a, w, o, M, K, N, block_m,
                                         block_k, splits, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}
