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
// - Orientation: out^T = W^T a^T with mma.m16n8k32, W as the A operand.
//   Each of the 8 warps owns 16 output columns n (the MMA's M slot), the
//   block's BM rows m fill the N slot in groups of 8 (BM = 8 wastes
//   nothing at decode), and K advances 32 bytes an MMA.  a^T as the "col"
//   operand is a's own row-major layout.
// - W is [K, N], N-major, and integer MMAs want K-major operands; ldmatrix
//   transposes 16-bit elements only.  Raw W tiles (kBK rows of k x kBN
//   columns) stream into a ring of up to 8 stages with cp.async
//   (16-byte copies where the row size and both bases allow, else 8 or 4,
//   else plain loads; out-of-range chunks are zeroed), each 16-byte chunk
//   XOR-swizzled by its row so that the transposing reads hit 32 banks.  One pass per
//   tile reads 4 x 4 byte blocks (4 columns of 4 k rows) as words,
//   transposes them with prmt and stores K-major plane rows of kBK bytes
//   (padded to kPlaneRow and swizzled by chunk: conflict-free stores and
//   ldmatrix reads).  W is never transposed in device memory.
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
//   repro_torch/kernels/plan.py, which mirrors the constants below); the
//   launcher refuses a plan that disagrees with this layout.

#include "common.cuh"
#include "mma_s8.cuh"

namespace {

using namespace mma_s8;

constexpr int kBN = 128;          // output columns per block (8 warps x 16)
constexpr int kBK = 64;           // K per stage
constexpr int kMaxStages = 8;     // cp.async ring depth at most
constexpr int kSmemMax = 232448;  // shared memory a block may use
constexpr int kThreads = 256;
constexpr int kMaxBlockK = 32768;  // K per split at most (int32 sums)
constexpr int kPlaneRow = kBK + 16;  // bytes of a K-major plane row

// Shared memory: `stages` ring slots of [raw W tile | raw a rows], then
// two plane buffers of [W planes | a planes (s16 a only)].  The ring is as
// deep as the shared memory allows, up to kMaxStages: stages - 2 of them
// are in flight while a block transposes one and multiplies another.
__host__ __device__ constexpr int ring_a_row(int ab) {
  return kBK * ab + 16;
}
__host__ __device__ constexpr int stage_bytes(int bm, int ab, int wb) {
  return kBK * kBN * wb + bm * ring_a_row(ab);
}
__host__ __device__ constexpr int plane_bytes(int bm, int ab, int wb) {
  return wb * kBN * kPlaneRow + (ab == 2 ? 2 * bm * kPlaneRow : 0);
}
__host__ __device__ constexpr int stages_for(int bm, int ab, int wb) {
  const int fit =
      (kSmemMax - 2 * plane_bytes(bm, ab, wb)) / stage_bytes(bm, ab, wb);
  return fit < kMaxStages ? fit : kMaxStages;
}
__host__ __device__ constexpr int smem_bytes(int bm, int ab, int wb) {
  return stages_for(bm, ab, wb) * stage_bytes(bm, ab, wb) +
         2 * plane_bytes(bm, ab, wb);
}

struct Args {
  const unsigned char* a;
  const unsigned char* w;
  int32_t* out;
  int M, K, N, block_k, splits;
  int cb_a, cb_w;  // copy bytes (16, 8, 4; 0: plain loads)
};

// The 16-byte chunk position of chunk c of a staged row r.  Raw W rows
// (SW = 1 or 2, W's bytes) are swizzled by k block (r / 4) so that a
// warp's transposing reads (8 column blocks x 4 k blocks) fall in distinct
// banks; a rows (SW = 0) are padded instead.
template <int SW>
__device__ __forceinline__ int chunk_pos(int r, int c) {
  if constexpr (SW == 1) return c ^ (((r >> 2) & 3) << 1);
  if constexpr (SW == 2) return c ^ (((r >> 2) & 1) << 2);
  return c;
}

// Byte offset of (row R, byte kk) in a K-major W plane.
__device__ __forceinline__ int plane_off(int R, int kk) {
  return R * kPlaneRow + ((((kk >> 4) ^ (R >> 3)) & 3) << 4) + (kk & 15);
}

// Stage ROWS rows of ROW_BYTES bytes: row r from src + r * src_ld to
// dst + r * dst_ld (chunks placed by chunk_pos<SW>).  Rows from
// rows_valid on, and bytes from `lim` on, are zeroed.  V16: 16-byte
// copies in a fixed count per thread; else `cb` bytes a copy (8 or 4, the
// row size and base allowing) or, with cb 0, plain byte loads.
template <bool V16, int ROWS, int ROW_BYTES, int SW>
__device__ __forceinline__ void stage_rows(unsigned char* dst, int dst_ld,
                                           const unsigned char* src,
                                           size_t src_ld, int rows_valid,
                                           long long lim, int cb) {
  if constexpr (V16) {
    constexpr int CPR = ROW_BYTES / 16;
    constexpr int TOTAL = ROWS * CPR;
#pragma unroll
    for (int i = 0; i < (TOTAL + kThreads - 1) / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (TOTAL % kThreads == 0 || e < TOTAL) {
        const int r = e / CPR, c = e % CPR;
        unsigned char* d = dst + r * dst_ld + (chunk_pos<SW>(r, c) << 4);
        if (r < rows_valid && 16 * c < lim)
          cp_async(d, src + r * src_ld + 16 * c, 16);
        else
          zero_smem(d, 16);
      }
    }
  } else {
    const int step = cb ? cb : 1;
    const int per_row = ROW_BYTES / step;
#pragma unroll 1
    for (int e = threadIdx.x; e < ROWS * per_row; e += kThreads) {
      const int r = e / per_row, x = (e - r * per_row) * step;
      unsigned char* d =
          dst + r * dst_ld + (chunk_pos<SW>(r, x >> 4) << 4) + (x & 15);
      const bool ok = r < rows_valid && x < lim;
      if (cb == 0)
        *d = ok ? src[r * src_ld + x] : 0;
      else if (ok)
        cp_async(d, src + r * src_ld + x, cb);
      else
        zero_smem(d, cb);
    }
  }
}

// Issue the copies of stage k0 (W rows [k0, k0 + kBK) of the block's
// columns, a's rows at the same k) into ring slot `slot`.
template <int AB, int WB, int BM, bool V16>
__device__ __forceinline__ void issue_stage(const Args& p,
                                            unsigned char* slot, int k0,
                                            int k_hi, int m0, int n0) {
  const size_t w_ld = static_cast<size_t>(p.N) * WB;
  stage_rows<V16, kBK, kBN * WB, WB>(
      slot, kBN * WB, p.w + k0 * w_ld + static_cast<size_t>(n0) * WB, w_ld,
      k_hi - k0, static_cast<long long>(p.N - n0) * WB, p.cb_w);
  const size_t a_ld = static_cast<size_t>(p.K) * AB;
  stage_rows<V16, BM, kBK * AB, 0>(
      slot + kBK * kBN * WB, ring_a_row(AB),
      p.a + m0 * a_ld + static_cast<size_t>(k0) * AB, a_ld, p.M - m0,
      (k_hi - k0) * AB, p.cb_a);
}

// Transpose the raw W tile of `slot` into K-major planes at `wp` (s16:
// plane 0 = hi, plane 1 = lo), and split s16 a rows into planes at `ap`.
// Thread item (nb, kb): columns [4nb, 4nb + 4) of k rows [4kb, 4kb + 4);
// a warp takes 8 column blocks x 4 k blocks.
template <int AB, int WB, int BM>
__device__ __forceinline__ void prepare(const unsigned char* slot,
                                        unsigned char* wp,
                                        unsigned char* ap) {
  constexpr int WROW = kBN * WB;
#pragma unroll
  for (int item = 0; item < (kBN / 4) * (kBK / 4) / kThreads; ++item) {
    const int e = threadIdx.x + item * kThreads;
    const int lane = e & 31, wi = e >> 5;
    const int nb = ((wi & 3) << 3) | (lane & 7);
    const int kb = ((wi >> 2) << 2) | (lane >> 3);
    uint32_t r[WB][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 4 * kb + i;
      const int x = WB == 1 ? 4 * nb : 8 * nb;
      const unsigned char* src =
          slot + row * WROW + (chunk_pos<WB>(row, x >> 4) << 4) + (x & 15);
      if constexpr (WB == 1) {
        r[0][i] = *reinterpret_cast<const uint32_t*>(src);
      } else {
        const uint2 v = *reinterpret_cast<const uint2*>(src);
        r[0][i] = plane_hi(v.x, v.y);
        r[1][i] = plane_lo(v.x, v.y);
      }
    }
#pragma unroll
    for (int pl = 0; pl < WB; ++pl) {
      uint32_t o[4];
      transpose4x4(r[pl], o);
      unsigned char* base = wp + pl * kBN * kPlaneRow;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(base + plane_off(4 * nb + j, 4 * kb)) =
            o[j];
    }
  }
  if constexpr (AB == 2) {
    const unsigned char* as = slot + kBK * WROW;
    constexpr int ITEMS = BM * (kBK / 4);
#pragma unroll
    for (int item = 0; item < (ITEMS + kThreads - 1) / kThreads; ++item) {
      const int e = threadIdx.x + item * kThreads;
      if (ITEMS % kThreads != 0 && e >= ITEMS) break;
      const int m = e >> 4, g4 = e & 15;
      const uint2 v = *reinterpret_cast<const uint2*>(
          as + m * ring_a_row(2) + 8 * g4);
      *reinterpret_cast<uint32_t*>(ap + m * kPlaneRow + 4 * g4) =
          plane_hi(v.x, v.y);
      *reinterpret_cast<uint32_t*>(ap + BM * kPlaneRow + m * kPlaneRow +
                                   4 * g4) = plane_lo(v.x, v.y);
    }
  }
}

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
  const int nsteps = k_hi > k_lo ? (k_hi - k_lo + kBK - 1) / kBK : 0;
  constexpr int SB = stage_bytes(BM, AB, WB);
  constexpr int PB = plane_bytes(BM, AB, WB);
  constexpr int MG = BM / 8;  // 8-row groups of m
  constexpr int kStages = stages_for(BM, AB, WB);
  unsigned char* planes = smem + kStages * SB;

  int32_t acc[MG][WB][AB][4];
#pragma unroll
  for (int j = 0; j < MG; ++j)
#pragma unroll
    for (int pw = 0; pw < WB; ++pw)
#pragma unroll
      for (int pa = 0; pa < AB; ++pa)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][pw][pa][i] = 0;

#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps)
      issue_stage<AB, WB, BM, V16>(p, smem + s * SB, k_lo + s * kBK, k_hi,
                                   m0, n0);
    cp_async_commit();
  }

  // this lane's ldmatrix rows: W rows of its warp's 16 columns (matrices
  // rows 0-7 / 8-15 at k chunk 0 / 1), a rows of an m-group pair
  const int wrow = 16 * warp + ((lane >> 3) & 1) * 8 + (lane & 7);
  const int wchunk = lane >> 4;
  const int arow = ((lane >> 4) & 1) * 8 + (lane & 7);
  const int achunk = (lane >> 3) & 1;

  // Stage it is transposed into plane buffer it & 1 one step ahead of its
  // MMAs, so one barrier a step separates the copies, the transposing
  // pass and the MMAs.
  if (nsteps > 0) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    prepare<AB, WB, BM>(smem, planes, planes + WB * kBN * kPlaneRow);
  }
  for (int it = 0; it < nsteps; ++it) {
    // stage it + 1 has landed; the barrier publishes every thread's copies
    // and stage it's planes, and ends the MMAs of step it - 1 (the last
    // readers of ring slot it - 1 and plane buffer it + 1)
    cp_async_wait<kStages - 3>();
    __syncthreads();
    {
      const int s = it + kStages - 1;
      if (s < nsteps)
        issue_stage<AB, WB, BM, V16>(p, smem + (s % kStages) * SB,
                                     k_lo + s * kBK, k_hi, m0, n0);
      cp_async_commit();
    }
    unsigned char* slot = smem + (it % kStages) * SB;
    unsigned char* wp = planes + (it & 1) * PB;
    unsigned char* ap = AB == 2 ? wp + WB * kBN * kPlaneRow
                                : slot + kBK * kBN * WB;
    if (it + 1 < nsteps) {
      unsigned char* wn = planes + ((it + 1) & 1) * PB;
      prepare<AB, WB, BM>(smem + ((it + 1) % kStages) * SB, wn,
                          wn + WB * kBN * kPlaneRow);
    }

    const uint32_t wp_s = smem_addr(wp), ap_s = smem_addr(ap);
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      uint32_t af[WB][4];
#pragma unroll
      for (int pw = 0; pw < WB; ++pw)
        ldmatrix_x4(af[pw], wp_s + pw * kBN * kPlaneRow +
                                plane_off(wrow, 32 * ks + 16 * wchunk));
      if constexpr (MG == 1) {
#pragma unroll
        for (int pa = 0; pa < AB; ++pa) {
          uint32_t bf[2];
          ldmatrix_x2(bf, ap_s + pa * BM * kPlaneRow +
                              (lane & 7) * kPlaneRow +
                              (2 * ks + achunk) * 16);
#pragma unroll
          for (int pw = 0; pw < WB; ++pw)
            mma_planes<AB, WB>(acc[0][pw][pa], af[pw], bf[0], bf[1], pw,
                               pa);
        }
      } else {
#pragma unroll
        for (int jj = 0; jj < MG / 2; ++jj) {
#pragma unroll
          for (int pa = 0; pa < AB; ++pa) {
            uint32_t bf[4];
            ldmatrix_x4(bf, ap_s + pa * BM * kPlaneRow +
                                (16 * jj + arow) * kPlaneRow +
                                (2 * ks + achunk) * 16);
#pragma unroll
            for (int pw = 0; pw < WB; ++pw) {
              mma_planes<AB, WB>(acc[2 * jj][pw][pa], af[pw], bf[0],
                                 bf[1], pw, pa);
              mma_planes<AB, WB>(acc[2 * jj + 1][pw][pa], af[pw], bf[2],
                                 bf[3], pw, pa);
            }
          }
        }
      }
    }
  }

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

// The largest of 16, 8, 4 bytes that divides the row size and the base
// address; 0 (plain loads) if none does.
int copy_bytes(const void* base, long long row_bytes) {
  const auto addr = reinterpret_cast<uintptr_t>(base);
  for (int cb = 16; cb >= 4; cb >>= 1)
    if (row_bytes % cb == 0 && addr % cb == 0) return cb;
  return 0;
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
