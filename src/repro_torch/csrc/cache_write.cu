// The KV-cache window write: a predicated row scatter with fixed shapes.
//
// No TPU kernel of its own: the reference writes its caches with XLA's
// scatter (repro/models/attention.py:_cache_write_ragged and
// _cache_write_paged, `.at[...].set(..., mode='drop')`).  The port needs a
// kernel here because a CUDA graph cannot capture a write whose indices
// come from `nonzero` (their count depends on the data): the serving
// steps compute one destination row per token of the [B, width] window
// instead, a fixed-shape int64 vector holding the flat cache row
// (b * S + slot, or page * page_size + row) or -1 where the reference's
// drop-mode scatter drops the token, and this kernel copies each kept
// token's already quantized row into every cache leaf (k, v, and the
// k_scale / v_scale planes of quantized caches).
//
// For leaf l with rows of row_bytes[l] bytes, token t of the window:
//   d = dest[t];  kept when 0 <= d < rows[l] and no later token t' > t of
//   the window has dest[t'] == d (the last writer wins, as a sequential
//   scatter leaves it; the serving steps never write one row twice)
//   dst_l[d, :] = src_l[t, :]
// A dropped token writes nothing: no spare row, no sink page.
//
// Bound on Hopper: bytes, and at decode a launch's latency (4 tokens, 16
// rows of at most 4 KB).  Design: one block per (token, leaf), 128 threads
// copying the row in the widest unit (16, 8, 4, 2 or 1 bytes) that the
// row size and both base addresses allow; the duplicate test reads the
// window's later destinations (at most a few hundred int64s, from L1).
// One launch per layer covers every leaf.

#include "common.cuh"

namespace {

constexpr int kMaxLeaves = 4;
constexpr int kThreads = 128;

struct Leaves {
  const unsigned char* src[kMaxLeaves];
  unsigned char* dst[kMaxLeaves];
  int row_bytes[kMaxLeaves];
  int rows[kMaxLeaves];
  int unit[kMaxLeaves];
};

template <typename T>
__device__ __forceinline__ void copy_row(const unsigned char* src,
                                         unsigned char* dst, int n_bytes) {
  const T* s = reinterpret_cast<const T*>(src);
  T* d = reinterpret_cast<T*>(dst);
  for (int i = threadIdx.x; i < n_bytes / static_cast<int>(sizeof(T));
       i += blockDim.x)
    d[i] = s[i];
}

__global__ void __launch_bounds__(kThreads)
    cache_write_kernel(const long long* __restrict__ dest, Leaves L,
                       int n_tokens) {
  const int t = blockIdx.x;
  const int l = blockIdx.y;
  const long long d = dest[t];
  if (d < 0 || d >= L.rows[l]) return;   // uniform across the block
  __shared__ int later;
  if (threadIdx.x == 0) later = 0;
  __syncthreads();
  for (int u = t + 1 + threadIdx.x; u < n_tokens; u += blockDim.x)
    if (dest[u] == d) later = 1;
  __syncthreads();
  if (later) return;
  const int rb = L.row_bytes[l];
  const unsigned char* src = L.src[l] + static_cast<long long>(t) * rb;
  unsigned char* dst = L.dst[l] + d * rb;
  switch (L.unit[l]) {
    case 16: copy_row<int4>(src, dst, rb); break;
    case 8: copy_row<int2>(src, dst, rb); break;
    case 4: copy_row<int>(src, dst, rb); break;
    case 2: copy_row<short>(src, dst, rb); break;
    default: copy_row<unsigned char>(src, dst, rb); break;
  }
}

}  // namespace

// dest [n_tokens] int64; for each of n_leaves leaves a source [n_tokens,
// row_bytes] and a destination [rows, row_bytes], both contiguous, copied
// in units of `unit` bytes (a power of two dividing row_bytes and both base
// addresses; the wrapper picks it).  Unused leaf slots are ignored.
REPRO_EXPORT int cache_write_launch(
    const void* dest, const void* src0, const void* src1, const void* src2,
    const void* src3, void* dst0, void* dst1, void* dst2, void* dst3,
    int n_tokens, int n_leaves, int row_bytes0, int row_bytes1,
    int row_bytes2, int row_bytes3, int rows0, int rows1, int rows2,
    int rows3, int unit0, int unit1, int unit2, int unit3, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_leaves < 1 || n_leaves > kMaxLeaves || n_tokens < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_tokens == 0) return static_cast<int>(cudaSuccess);
  const void* srcs[kMaxLeaves] = {src0, src1, src2, src3};
  void* dsts[kMaxLeaves] = {dst0, dst1, dst2, dst3};
  const int rbs[kMaxLeaves] = {row_bytes0, row_bytes1, row_bytes2, row_bytes3};
  const int rows[kMaxLeaves] = {rows0, rows1, rows2, rows3};
  const int units[kMaxLeaves] = {unit0, unit1, unit2, unit3};
  Leaves L{};
  for (int l = 0; l < n_leaves; ++l) {
    const int u = units[l];
    if (u != 1 && u != 2 && u != 4 && u != 8 && u != 16)
      return static_cast<int>(cudaErrorInvalidValue);
    if (rbs[l] <= 0 || rbs[l] % u != 0 || rows[l] < 0 ||
        reinterpret_cast<uintptr_t>(srcs[l]) % u != 0 ||
        reinterpret_cast<uintptr_t>(dsts[l]) % u != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    L.src[l] = static_cast<const unsigned char*>(srcs[l]);
    L.dst[l] = static_cast<unsigned char*>(dsts[l]);
    L.row_bytes[l] = rbs[l];
    L.rows[l] = rows[l];
    L.unit[l] = u;
  }
  dim3 grid(n_tokens, n_leaves);
  cache_write_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(dest), L, n_tokens);
  return static_cast<int>(cudaGetLastError());
}
