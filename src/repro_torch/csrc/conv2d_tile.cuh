// The output-stationary NHWC conv2d tile shared by K5 (ulppack_conv2d.cu)
// and K6 (int_conv2d.cu), for CUDA cores on sm_90a.
//
// Replaces the Pallas kernels `_kernel` and `_int_kernel` of
// repro/kernels/ulppack_conv2d.py, both launched by `_tiled_conv_call`
// (pallas_call at :148).  x is [N, H, W, C] (C packed lanes for K5, plain
// channels for K6), w is [FH, FW, WC, CO] (lanes, bit-dense int32 words, or
// plain channels), out is int32 [N, HO, WO, CO].
//
// One block covers TH output rows x TW = 32 output columns of one image
// and `bco` output channels, with TH x GPR x (bco / CPT) threads.
// Padding is never materialised: the block stages its halo input tile
// [cc][TH + FH - 1][TW + FW - 1] with pixels outside the image read as
// zero (a zero lane contributes zero), and its weight block [FH * FW][cc][bco], both widened to int32 in shared memory,
// `cc` channels (lanes) per stage.  With the 'dense' store the weight stage
// expands words to field-reversed lanes on the fly, exactly as
// expand_dense_taps does.  Each thread keeps PPT = 8 neighbouring output
// pixels of one row x CPT = 4 output channels in registers: for one
// (channel, kernel row) it loads PPT + FW - 1 input values once and slides
// them over the FW taps, so every shared-memory load feeds 4-8 products.
//
// K5 (PACKED): the packed products wrap mod 2^32 by design, so they are
// accumulated in uint32 (signed overflow is undefined in C++); after every
// `run` = k_tile products an accumulator's band `(acc >> band) & mask` is
// added to its total.  Extraction is exact for any group of at most k_tile
// products, so grouping across taps and channels is bit-equal to the
// Pallas kernel's per-(tap, chunk) extraction.  K6: the same loop without
// extraction; int8/int16 products summed in uint32 give the int32 result
// wrapped mod 2^32, like XLA's s32.
#pragma once

#include "common.cuh"

namespace conv2d {

constexpr int PPT = 8;          // output pixels per thread (one row)
constexpr int CPT = 4;          // output channels per thread
constexpr int GPR = 4;          // pixel groups per tile row
constexpr int TW = PPT * GPR;   // output columns per block
constexpr int FW_MAX = 8;       // widest kernel the register window takes
constexpr int kMaxThreads = 256;

struct Args {
  const void* x;
  const void* w;
  int32_t* out;
  int N, H, W, C, x_bytes;        // x [N, H, W, C]
  int FH, FW, WC, CO, w_bytes;    // w [FH, FW, WC, CO]
  int HO, WO, pad_top, pad_left;  // out [N, HO, WO, CO]
  int run, band;                  // K5: products per extraction, band offset
  uint32_t mask;                  //     field mask
  int dense, w_bits, n_pack, shift;  // 'dense' weight store (lanes: x_bytes)
  int th, bco, cc;                // rows, out channels, channels per stage
  int threads, smem;              // the planner's figures, checked in launch
};

__device__ __forceinline__ int32_t load_elem(const void* p, size_t i,
                                             int bytes) {
  switch (bytes) {
    case 1: return static_cast<const int8_t*>(p)[i];
    case 2: return static_cast<const int16_t*>(p)[i];
    default: return static_cast<const int32_t*>(p)[i];
  }
}

// Lane `lane` (of cp) of the dense words at (tap, co): the field-reversed
// sum of lattice values of channels lane*n_pack + j, truncated to the lane
// dtype of x like expand_dense_taps' astype.
__device__ __forceinline__ int32_t dense_lane(const Args& a, int tap,
                                              int lane, int co) {
  const int per = 32 / a.w_bits;
  const uint32_t wmask = (1u << a.w_bits) - 1u;
  const int32_t* words = static_cast<const int32_t*>(a.w);
  uint32_t v = 0u;
  for (int j = 0; j < a.n_pack; ++j) {
    const int ch = lane * a.n_pack + j;
    if (ch >= a.WC * per) break;
    const uint32_t word = static_cast<uint32_t>(
        words[(static_cast<size_t>(tap) * a.WC + ch / per) * a.CO + co]);
    const uint32_t lat = (word >> (a.w_bits * (ch % per))) & wmask;
    v += lat << (a.shift * (a.n_pack - 1 - j));
  }
  switch (a.x_bytes) {
    case 1: return static_cast<int8_t>(v);
    case 2: return static_cast<int16_t>(v);
    default: return static_cast<int32_t>(v);
  }
}

template <bool PACKED>
__global__ void __launch_bounds__(kMaxThreads) conv2d_tile_kernel(Args a) {
  extern __shared__ __align__(16) int32_t smem[];
  const int ht = a.th + a.FH - 1;
  const int wt = TW + a.FW - 1;
  const int xs_len = (a.cc * ht * wt + 3) & ~3;  // keep ws 16-byte aligned
  int32_t* xs = smem;                              // [cc][ht][wt]
  int32_t* ws = smem + xs_len;                     // [FH*FW][cc][bco]

  const int tiles_w = (a.WO + TW - 1) / TW;
  const int oh0 = (blockIdx.x / tiles_w) * a.th;
  const int ow0 = (blockIdx.x % tiles_w) * TW;
  const int n = blockIdx.y;
  const int co0 = blockIdx.z * a.bco;
  const int cgroups = a.bco / CPT;
  const int cg = threadIdx.x % cgroups;
  const int pg = threadIdx.x / cgroups;  // pixel group, < th * GPR
  const int prow = pg / GPR;
  const int pcol = (pg % GPR) * PPT;
  const int gh0 = oh0 - a.pad_top;
  const int gw0 = ow0 - a.pad_left;
  const int taps = a.FH * a.FW;

  uint32_t acc[PPT][CPT], tot[PPT][CPT];
#pragma unroll
  for (int p = 0; p < PPT; ++p)
#pragma unroll
    for (int q = 0; q < CPT; ++q) acc[p][q] = tot[p][q] = 0u;
  int in_run = 0;  // products per accumulator since the last extraction

  for (int c0 = 0; c0 < a.C; c0 += a.cc) {
    __syncthreads();
    // halo input tile, channel fastest so neighbouring threads read
    // neighbouring addresses of the NHWC input
    for (int i = threadIdx.x; i < a.cc * ht * wt; i += blockDim.x) {
      const int c = i % a.cc;
      const int pix = i / a.cc;
      const int r = pix / wt, col = pix - (pix / wt) * wt;
      const int gh = gh0 + r, gw = gw0 + col, gc = c0 + c;
      int32_t v = 0;
      if (gh >= 0 && gh < a.H && gw >= 0 && gw < a.W && gc < a.C)
        v = load_elem(a.x,
                      ((static_cast<size_t>(n) * a.H + gh) * a.W + gw) * a.C
                          + gc, a.x_bytes);
      xs[(c * ht + r) * wt + col] = v;
    }
    // weight block, output channel fastest
    for (int i = threadIdx.x; i < taps * a.cc * a.bco; i += blockDim.x) {
      const int co = i % a.bco;
      const int rest = i / a.bco;
      const int c = rest % a.cc, tap = rest / a.cc;
      const int gco = co0 + co, gc = c0 + c;
      int32_t v = 0;
      if (gco < a.CO && gc < a.C)
        v = a.dense ? dense_lane(a, tap, gc, gco)
                    : load_elem(a.w,
                                (static_cast<size_t>(tap) * a.WC + gc) * a.CO
                                    + gco, a.w_bytes);
      ws[(tap * a.cc + c) * a.bco + co] = v;
    }
    __syncthreads();

    const int cc = min(a.cc, a.C - c0);
    for (int c = 0; c < cc; ++c) {
      for (int fh = 0; fh < a.FH; ++fh) {
        const int32_t* xrow = xs + (c * ht + prow + fh) * wt + pcol;
        uint32_t xr[PPT + FW_MAX - 1];
#pragma unroll
        for (int j = 0; j < PPT + FW_MAX - 1; ++j)
          xr[j] = j < PPT + a.FW - 1 ? static_cast<uint32_t>(xrow[j]) : 0u;
        const int32_t* wrow = ws + (fh * a.FW * a.cc + c) * a.bco + cg * CPT;
#pragma unroll
        for (int fw = 0; fw < FW_MAX; ++fw) {
          if (fw < a.FW) {
            const int4 wv =
                *reinterpret_cast<const int4*>(wrow + fw * a.cc * a.bco);
            const uint32_t wq[CPT] = {
                static_cast<uint32_t>(wv.x), static_cast<uint32_t>(wv.y),
                static_cast<uint32_t>(wv.z), static_cast<uint32_t>(wv.w)};
#pragma unroll
            for (int p = 0; p < PPT; ++p)
#pragma unroll
              for (int q = 0; q < CPT; ++q) acc[p][q] += xr[p + fw] * wq[q];
            if (PACKED && ++in_run == a.run) {
#pragma unroll
              for (int p = 0; p < PPT; ++p)
#pragma unroll
                for (int q = 0; q < CPT; ++q) {
                  tot[p][q] += (acc[p][q] >> a.band) & a.mask;
                  acc[p][q] = 0u;
                }
              in_run = 0;
            }
          }
        }
      }
    }
  }

  const int oh = oh0 + prow;
  if (oh >= a.HO) return;
  const int co = co0 + cg * CPT;
  const bool vec = (a.CO % CPT == 0) && co + CPT <= a.CO;
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int ow = ow0 + pcol + p;
    if (ow >= a.WO) break;
    int32_t v[CPT];
#pragma unroll
    for (int q = 0; q < CPT; ++q)
      v[q] = static_cast<int32_t>(
          PACKED ? tot[p][q] + ((acc[p][q] >> a.band) & a.mask) : acc[p][q]);
    int32_t* o = a.out + ((static_cast<size_t>(n) * a.HO + oh) * a.WO + ow)
                             * a.CO + co;
    if (vec) {
      *reinterpret_cast<int4*>(o) = make_int4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int q = 0; q < CPT; ++q)
        if (co + q < a.CO) o[q] = v[q];
    }
  }
}

inline int threads_per_block(const Args& a) {
  return a.th * GPR * (a.bco / CPT);
}

inline size_t smem_bytes(const Args& a) {
  const int ht = a.th + a.FH - 1, wt = TW + a.FW - 1;
  const size_t xs_len = (static_cast<size_t>(a.cc) * ht * wt + 3) & ~size_t(3);
  return (xs_len + static_cast<size_t>(a.FH) * a.FW * a.cc * a.bco) * 4;
}

// Checks the geometry -- the planner's threads and shared memory must be
// what this tile computes from (th, bco, cc), so the two cannot drift
// apart silently -- raises the dynamic shared-memory limit when the block
// needs more than 48 KB, and launches on `stream`.
template <bool PACKED>
cudaError_t launch(const Args& a, int device, cudaStream_t stream) {
  if (a.FW < 1 || a.FW > FW_MAX || a.FH < 1 || a.bco % CPT != 0 ||
      a.th < 1 || a.cc < 1 || a.N > 65535 ||
      threads_per_block(a) > kMaxThreads ||
      a.threads != threads_per_block(a) ||
      static_cast<size_t>(a.smem) != smem_bytes(a))
    return cudaErrorInvalidValue;
  if (a.N == 0 || a.HO <= 0 || a.WO <= 0 || a.CO == 0)
    return cudaSuccess;
  const size_t smem = smem_bytes(a);
  static size_t raised[8] = {0};  // per device, this instantiation
  if (smem > 48 * 1024 && smem > raised[device & 7]) {
    cudaError_t err = cudaFuncSetAttribute(
        conv2d_tile_kernel<PACKED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    raised[device & 7] = smem;
  }
  const int tiles = ((a.HO + a.th - 1) / a.th) * ((a.WO + TW - 1) / TW);
  const dim3 grid(tiles, a.N, (a.CO + a.bco - 1) / a.bco);
  conv2d_tile_kernel<PACKED><<<grid, a.threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace conv2d
