// The tensor-core K2's kernel and launcher, shared by ulppack_matmul_mma.cu
// (int16xP2s8 weight lanes), ulppack_matmul_mma_dense.cu (the bit-dense
// weight store, one library per w_bits) and ulppack_matmul_mma_lanes.cu
// (every other layout, one library per layout): see ulppack_matmul_mma.cu
// for the design and the arguments.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "common.cuh"
#include "mma_s8.cuh"

namespace {

using namespace mma_s8;

// K steps a split at most: 32768 lattice values, so no s32 sum leaves the
// int32 range (255^2 * 32768 < 2^31) whatever the layout
constexpr int kMaxBlockK = 16384;

// What the epilogue stores.
enum OutKind { kS32 = 0, kF32 = 1, kBF16 = 2, kF16 = 3 };
// The bias it adds (affine epilogue only).
enum BiasKind { kNoBias = 0, kBiasF32 = 1, kBiasBF16 = 2 };

// What a holds: int16 lanes, or float activations for the fused quantize.
enum AKind { kLanes = 0, kXF32 = 1, kXBF16 = 2, kXF16 = 3 };

// K counts the tile's K steps of two lattice values (an int16xP2s8 lane).
struct Args {
  const unsigned char* a;    // lanes [M, lanes(K)], or x [M, k_full]
  const unsigned char* w;    // lanes [lanes(K), N], field-reversed, or words
  void* out;                 // [M, N] of out_kind
  int32_t* work;             // [splits, M, N] partial dots (splits > 1),
                             // then [splits, N tiles, M] row sums (x)
  unsigned int* tickets;     // one per output tile, 0 between launches
  const int32_t* a_sums;     // [M] lattice row sums (affine, lanes only)
  const int32_t* col_sums;   // [N] lattice column sums
  const float* a_scale;      // 0-dim scalars
  const int32_t* a_zp;
  const float* w_scale;
  const int32_t* w_zp;
  const void* bias;          // [N] of bias_kind, or null
  int M, K, N, k_full, block_k, splits;
  int qmax;                  // 2^a_bits - 1 (x only)
  int out_kind, bias_kind;
  int cb_a, cb_w;            // copy bytes (16, 8, 4; 0: plain loads)
};

// The affine map of one output element (see the note above).
struct Affine {
  float s, azp, wzp, kzz;

  __device__ explicit Affine(const Args& p) {
    s = __fmul_rn(*p.a_scale, *p.w_scale);
    azp = __int2float_rn(*p.a_zp);
    wzp = __int2float_rn(*p.w_zp);
    kzz = __fmul_rn(__fmul_rn(__int2float_rn(p.k_full), azp), wzp);
  }

  __device__ __forceinline__ float operator()(const Args& p, int32_t a_sum,
                                              int n, int32_t acc) const {
    float c = __fsub_rn(__int2float_rn(acc),
                        __fmul_rn(wzp, __int2float_rn(a_sum)));
    c = __fsub_rn(c, __fmul_rn(azp, __int2float_rn(p.col_sums[n])));
    c = __fadd_rn(c, kzz);
    float v = __fmul_rn(s, c);
    if (p.bias_kind == kBiasF32)
      v = __fadd_rn(v, static_cast<const float*>(p.bias)[n]);
    else if (p.bias_kind == kBiasBF16)
      v = __fadd_rn(v, __bfloat162float(
                           static_cast<const __nv_bfloat16*>(p.bias)[n]));
    return v;
  }
};

// WS: RawW<2> (int16xP2s8 lanes), LanesW<LB, NP, SH> (another layout's
// lanes) or DenseW<BITS> (bit-dense words); AS: RawA<2> or LanesA<LB, NP,
// SH> (activation lanes) or QuantA<T> (float activations, K1 fused).
template <class WS, class AS, int BM, bool V16>
__global__ void __launch_bounds__(kThreads)
ulppack_matmul_mma_kernel(Args p) {
  constexpr bool kQuant = AS::kQuant;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  __shared__ int32_t row_sum[kQuant ? BM : 1];  // the block's rows' sums
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int k_lo = blockIdx.z * p.block_k;
  const int k_hi = min(p.K, k_lo + p.block_k);
  constexpr int MG = BM / 8;  // 8-row groups of m

  int32_t acc[MG][4];
#pragma unroll
  for (int j = 0; j < MG; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0;

  // the lattice dot: W's hi plane x a's lo plane + W's lo x a's hi, u8
  AS as(p, m0);
  mainloop_w<WS, BM, V16>(
      p, smem, m0, n0, k_lo, k_hi, WS(p), as,
      [&](int j, int pw, int pa, const uint32_t(&a)[4], uint32_t b0,
          uint32_t b1) {
        if (pw != pa) mma_m16n8k32<false, false>(acc[j], a, b0, b1);
      });

  // d_i of group j is out[m0 + 8j + 2t + (i & 1)][n0 + 16 warp + g + 8 (i >> 1)]
  const int g = lane >> 2, t = lane & 3;
  const size_t mn = static_cast<size_t>(p.M) * p.N;
  // x's row sums of this split and N tile: [splits, N tiles, M] after the
  // partial dots
  int32_t* const sums = p.work + p.splits * mn;
  if (p.splits > 1) {
    int32_t* part = p.work + blockIdx.z * mn;
#pragma unroll
    for (int j = 0; j < MG; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + 8 * j + 2 * t + (i & 1);
        const int n = n0 + 16 * warp + g + 8 * (i >> 1);
        if (m < p.M && n < p.N)
          __stcg(part + static_cast<size_t>(m) * p.N + n, acc[j][i]);
      }
    if constexpr (kQuant) {
      int32_t* mine =
          sums + (static_cast<size_t>(blockIdx.z) * gridDim.x + blockIdx.x) *
                     p.M;
      as.template row_sums<BM>([&](int mi, int32_t v) {
        if (m0 + mi < p.M) __stcg(mine + m0 + mi, v);
      });
    }
    // publish the partials and draw a ticket: the barrier orders every
    // thread's stores before thread 0's release (cumulative), and the
    // block that draws the last ticket acquires every split's partials
    // (thread 0's acquire, then the barrier; the reads go to L2)
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned int* ticket = p.tickets + blockIdx.y * gridDim.x + blockIdx.x;
      unsigned int drawn;
      asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                   : "=r"(drawn) : "l"(ticket) : "memory");
      last = drawn == static_cast<unsigned int>(p.splits - 1);
      if (last) *ticket = 0u;  // every split has drawn: ready for the next
    }
    __syncthreads();
    if (!last) return;
    // the splits in order, ZU splits' MG x 4 loads in flight at once
    constexpr int ZU = MG >= 8 ? 1 : 8 / MG;
    uint32_t sum[MG][4];
#pragma unroll
    for (int j = 0; j < MG; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) sum[j][i] = 0u;
#pragma unroll ZU
    for (int z = 0; z < p.splits; ++z) {
      const int32_t* src = p.work + z * mn;
#pragma unroll
      for (int j = 0; j < MG; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = m0 + 8 * j + 2 * t + (i & 1);
          const int n = n0 + 16 * warp + g + 8 * (i >> 1);
          if (m < p.M && n < p.N)
            sum[j][i] += static_cast<uint32_t>(
                __ldcg(src + static_cast<size_t>(m) * p.N + n));
        }
    }
#pragma unroll
    for (int j = 0; j < MG; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = static_cast<int32_t>(sum[j][i]);
    if constexpr (kQuant) {
      // this tile's row sums, split by split in order, 8 loads in flight
      const int mi = threadIdx.x;
      if (mi < BM && m0 + mi < p.M) {
        uint32_t v = 0u;
#pragma unroll 8
        for (int z = 0; z < p.splits; ++z)
          v += static_cast<uint32_t>(__ldcg(
              sums + (static_cast<size_t>(z) * gridDim.x + blockIdx.x) * p.M +
              m0 + mi));
        row_sum[mi] = static_cast<int32_t>(v);
      }
    }
  } else if constexpr (kQuant) {
    as.template row_sums<BM>([&](int mi, int32_t v) { row_sum[mi] = v; });
  }
  if constexpr (kQuant) __syncthreads();

  if (!kQuant && p.out_kind == kS32) {
#pragma unroll
    for (int j = 0; j < MG; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + 8 * j + 2 * t + (i & 1);
        const int n = n0 + 16 * warp + g + 8 * (i >> 1);
        if (m < p.M && n < p.N)
          static_cast<int32_t*>(p.out)[static_cast<size_t>(m) * p.N + n] =
              acc[j][i];
      }
    return;
  }
  const Affine affine(p);
#pragma unroll
  for (int j = 0; j < MG; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + 8 * j + 2 * t + (i & 1);
      const int n = n0 + 16 * warp + g + 8 * (i >> 1);
      if (m < p.M && n < p.N) {
        int32_t a_sum;
        if constexpr (kQuant)
          a_sum = row_sum[m - m0];
        else
          a_sum = p.a_sums[m];
        const float v = affine(p, a_sum, n, acc[j][i]);
        const size_t o = static_cast<size_t>(m) * p.N + n;
        if (p.out_kind == kF32)
          static_cast<float*>(p.out)[o] = v;
        else if (p.out_kind == kBF16)
          static_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16_rn(v);
        else
          static_cast<__half*>(p.out)[o] = __float2half_rn(v);
      }
    }
}

template <class WS, class AS, int BM, bool V16>
cudaError_t launch_variant(const Args& p, int device, cudaStream_t s) {
  // the ring keeps one stage landing, one being expanded and one in flight
  // at least: a layout whose stages do not fit three times (int32 lanes
  // of two fields beside 64 rows of f32 x) is not built
  if constexpr (stages_for_w(BM, AS::kBytes, WS::kTile, WS::kPlanes,
                             AS::kPlanes) < kMinStages) {
    return cudaErrorInvalidValue;
  } else {
    void (*kern)(Args) = ulppack_matmul_mma_kernel<WS, AS, BM, V16>;
    constexpr int smem =
        smem_bytes_w(BM, AS::kBytes, WS::kTile, WS::kPlanes, AS::kPlanes);
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
}

template <class WS, class AS, bool V16>
cudaError_t launch_bm(const Args& p, int block_m, int device,
                      cudaStream_t s) {
  switch (block_m) {
    case 8: return launch_variant<WS, AS, 8, V16>(p, device, s);
    case 16: return launch_variant<WS, AS, 16, V16>(p, device, s);
    case 32: return launch_variant<WS, AS, 32, V16>(p, device, s);
    case 64: return launch_variant<WS, AS, 64, V16>(p, device, s);
    default: return cudaErrorInvalidValue;
  }
}

// LA: the a side for lanes (a_kind 0); with QUANT the library also holds
// the fused quantize's a sides (a_kind 1-3).
template <class WS, class LA, bool QUANT, bool V16>
cudaError_t launch_a(const Args& p, int a_kind, int block_m, int device,
                     cudaStream_t s) {
  if constexpr (QUANT) {
    switch (a_kind) {
      case kXF32:
        return launch_bm<WS, QuantA<float>, V16>(p, block_m, device, s);
      case kXBF16:
        return launch_bm<WS, QuantA<__nv_bfloat16>, V16>(p, block_m, device,
                                                         s);
      case kXF16:
        return launch_bm<WS, QuantA<__half>, V16>(p, block_m, device, s);
      default: break;
    }
  }
  return launch_bm<WS, LA, V16>(p, block_m, device, s);
}

// Bytes of x's elements by a_kind (0: lanes).
int x_bytes(int a_kind) {
  return a_kind == kXF32 ? 4 : (a_kind == kXBF16 || a_kind == kXF16) ? 2 : 0;
}


// The launcher of every K2 library with W side WS (RawW<2>: int16 lanes
// [K, N]; LanesW: another layout's lanes [lanes(K), N]; DenseW<BITS>:
// bit-dense words [ceil(k_full / (32 / BITS)), N]) and a side LA for
// lanes (RawA<2> or LanesA, [M, lanes(K)]), with the fused quantize's a
// sides unless QUANT is false: checks the plan against this layout and
// launches; see the exported functions for the arguments.
template <class WS, class LA = RawA<2>, bool QUANT = true>
int launch_mma(const void* a, const void* w, void* out, void* work,
               void* tickets, const void* a_sums, const void* col_sums,
               const void* a_scale, const void* a_zp, const void* w_scale,
               const void* w_zp, const void* bias, int M, int K, int N,
               int k_full, int a_kind, int qmax, int out_kind, int bias_kind,
               int work_len, int tickets_len, int block_m, int block_n,
               int step_k, int block_k, int splits, int stages, int threads,
               int smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int xb = QUANT ? x_bytes(a_kind) : 0;
  const int ab = xb ? 2 * xb : LA::kBytes;  // a's staged bytes a K step
  const bool bm_ok = block_m == 8 || block_m == 16 || block_m == 32 ||
                     block_m == 64;
  if (M < 1 || N < 1 || K < 0 || !bm_ok || block_n != kBN ||
      step_k != kBK ||
      stages != stages_for_w(block_m, ab, WS::kTile, WS::kPlanes, 2) ||
      threads != kThreads ||
      block_k < kBK || block_k > kMaxBlockK || block_k % kBK != 0 ||
      splits != (K > 0 ? (K + block_k - 1) / block_k : 1) ||
      splits > 65535 || (M + block_m - 1) / block_m > 65535 ||
      smem != smem_bytes_w(block_m, ab, WS::kTile, WS::kPlanes, 2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a_kind < kLanes || a_kind > (QUANT ? kXF16 : kLanes) ||
      (a_kind != kLanes &&
       (out_kind == kS32 || k_full < 1 || K != (k_full + 1) / 2 ||
        qmax < 1 || qmax > 255)))
    return static_cast<int>(cudaErrorInvalidValue);
  // the dense store holds k_full values in K = ceil(k_full / 2) lanes'
  // worth of words; its tail is masked by k_full
  if (WS::kDense && (k_full < 1 || K != (k_full + 1) / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_tiles = (N + kBN - 1) / kBN;
  const long long tiles = n_tiles * ((M + block_m - 1) / block_m);
  const long long need =
      static_cast<long long>(splits) * M * (N + (xb ? n_tiles : 0));
  if (splits > 1 && (work == nullptr || tickets == nullptr ||
                     tickets_len < tiles || work_len < need))
    return static_cast<int>(cudaErrorInvalidValue);
  if (out_kind < kS32 || out_kind > kF16 || bias_kind < kNoBias ||
      bias_kind > kBiasBF16 ||
      (out_kind != kS32 &&
       ((xb == 0 && a_sums == nullptr) || col_sums == nullptr ||
        a_scale == nullptr || a_zp == nullptr || w_scale == nullptr ||
        w_zp == nullptr || (bias_kind != kNoBias && bias == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  Args p;
  p.a = static_cast<const unsigned char*>(a);
  p.w = static_cast<const unsigned char*>(w);
  p.out = out;
  p.work = static_cast<int32_t*>(work);
  p.tickets = static_cast<unsigned int*>(tickets);
  p.a_sums = static_cast<const int32_t*>(a_sums);
  p.col_sums = static_cast<const int32_t*>(col_sums);
  p.a_scale = static_cast<const float*>(a_scale);
  p.a_zp = static_cast<const int32_t*>(a_zp);
  p.w_scale = static_cast<const float*>(w_scale);
  p.w_zp = static_cast<const int32_t*>(w_zp);
  p.bias = bias;
  p.M = M;
  p.K = K;
  p.N = N;
  p.k_full = k_full;
  p.block_k = block_k;
  p.splits = splits;
  p.qmax = qmax;
  p.out_kind = out_kind;
  p.bias_kind = out_kind == kS32 ? kNoBias : bias_kind;
  p.cb_a = xb ? copy_bytes(a, static_cast<long long>(k_full) * xb)
              : copy_bytes(a, LA::row_bytes(K));
  p.cb_w = copy_bytes(w, static_cast<long long>(N) * WS::kElem);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte copies of both operands in a fixed count per thread, or the
  // ladder of copy sizes (as K7)
  if (p.cb_a == 16 && p.cb_w == 16)
    err = launch_a<WS, LA, QUANT, true>(p, a_kind, block_m, device, s);
  else
    err = launch_a<WS, LA, QUANT, false>(p, a_kind, block_m, device, s);
  return static_cast<int>(err);
}

}  // namespace
