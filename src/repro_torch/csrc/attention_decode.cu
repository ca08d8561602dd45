// K3 and K4: flash-decoding attention over the stored (possibly sub-byte) KV
// cache, contiguous (K3) or paged (K4).
//
// Replaces the Pallas kernel
// repro/kernels/ulppack_attention.py:_attention_decode_pallas
// (`_decode_kernel`): its contiguous-cache branch (K3, pallas_call at :395)
// and its paged branch (K4, pallas_call at :367), and also takes query
// windows wider than one token (C >= 1), which the reference routes to its
// 'xla' backend.  Per query row (b, c, h), with kv head h / (H / KVH):
//   s_p   = q . k_p                         float cache (kv_bits 0/16)
//         = sk_p * (q . u_p)                int8 cache (symmetric)
//         = sk_p * (q . u_p - zp * sum(q))  4/2-bit words, zp = 2^(bits-1)
//   visible positions: p < valid_len[b] and p <= qpos[b, c]
//   out   = sum_p softmax(s)_p * v_p, where a sub-byte value row is
//           sv_p * (u_p - zp): accumulated as (p * sv) . u - zp * sum(p * sv)
// q arrives pre-scaled by hd^-0.5 in f32 with its row sums (the wrapper
// does this, as the reference does outside its pallas_call); the output is
// f32 [B, C, H, hd].  A row with nothing visible returns exact zeros (the
// reference's l == 0 guard).  Word unpack is (word >> bits*j) & mask in
// ascending field order, dropping the tail beyond hd.
//
// Bound on Hopper: bytes -- each visible cache row (words + bf16 scales) is
// read once per query head.  Design: one block per query row; its 16 warps
// stride over the visible positions (a warp's loop is latency-bound, so
// more warps per row means a shorter chain), a warp reads one cache row as a
// contiguous span (lane d owns dims d, d+32, ...), reduces the score with
// shuffles and keeps its own online-softmax carry (m, l, acc) in registers;
// the warps' carries merge through shared memory at the end.  The loop stops
// at min(valid_len, qpos + 1), so the cost is O(live rows), not
// O(allocated).
//
// K4 (PAGED) is the same kernel over a pool [P, page_size, KVH, ...]: the
// logical length is S = NP * page_size, and position p of batch row b lives
// at physical page clamp(bt[b * NP + p / page_size], 0, P - 1), row
// p % page_size (the reference clips the scalar-prefetched table the same
// way).  Warps, position order, the online-softmax merge and the l == 0
// guard are K3's, so on the same logical data K4 gives K3's bits.  Pages hold
// whole words (page_size is a multiple of 32 / bits), so a row never
// straddles a page.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 16;
constexpr float kNegInf = -1e30f;

enum Kind { kF32 = 0, kBF16 = 1, kInt8 = 2, kWords = 3 };

template <int KIND>
__device__ __forceinline__ float load_val(const void* base, size_t row,
                                          int d, int bits) {
  if (KIND == kF32) return static_cast<const float*>(base)[row + d];
  if (KIND == kBF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(base)[row + d]);
  if (KIND == kInt8)
    return static_cast<float>(static_cast<const int8_t*>(base)[row + d]);
  const int per = 32 / bits;
  const uint32_t word = static_cast<const uint32_t*>(base)[row + d / per];
  return static_cast<float>((word >> (bits * (d % per))) & ((1u << bits) - 1u));
}

// Where the cache rows of a batch row live: contiguous [B, S, KVH, ...]
// (bt == nullptr) or a page pool [P, page_size, KVH, ...] behind the block
// table bt [B, NP].
struct Layout {
  const int32_t* bt;
  int S, NP, page_size, P;
};

template <bool PAGED>
__device__ __forceinline__ size_t cache_cell(const Layout& lay, int b, int p,
                                             int KVH, int kvh) {
  if (!PAGED) return (static_cast<size_t>(b) * lay.S + p) * KVH + kvh;
  int pg = lay.bt[static_cast<size_t>(b) * lay.NP + p / lay.page_size];
  pg = min(max(pg, 0), lay.P - 1);
  return (static_cast<size_t>(pg) * lay.page_size + p % lay.page_size) * KVH +
         kvh;
}

template <int KIND, int DPL, bool PAGED>
__global__ void __launch_bounds__(kWarps * 32)
attention_decode_kernel(const float* __restrict__ qg,
                        const float* __restrict__ qsum,
                        const void* __restrict__ k, const void* __restrict__ v,
                        const __nv_bfloat16* __restrict__ ks,
                        const __nv_bfloat16* __restrict__ vs,
                        const int32_t* __restrict__ valid_len,
                        const int32_t* __restrict__ qpos,
                        float* __restrict__ out, int C, int H, int KVH,
                        Layout lay, int hd, int row_elems, int bits) {
  const int S = lay.S;
  const int qrow = blockIdx.x;  // (b * C + c) * H + h
  const int h = qrow % H;
  const int bc = qrow / H;
  const int b = bc / C;
  const int kvh = h / (H / KVH);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float zp = KIND == kWords ? static_cast<float>(1 << (bits - 1)) : 0.f;

  float qv[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    qv[i] = d < hd ? qg[static_cast<size_t>(qrow) * hd + d] : 0.f;
  }
  const float qs = qsum[qrow];
  const int end = min(min(valid_len[b], qpos[bc] + 1), S);

  float m = kNegInf, l = 0.f, acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  for (int p = warp; p < end; p += kWarps) {
    const size_t cell = cache_cell<PAGED>(lay, b, p, KVH, kvh);
    const size_t row = cell * row_elems;
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) dot += qv[i] * load_val<KIND>(k, row, d, bits);
    }
    dot = warp_sum_f32(dot);
    float s = dot, sv = 1.f;
    if (KIND >= kInt8) {
      const float sk = __bfloat162float(ks[cell]);
      s = KIND == kWords ? sk * (dot - zp * qs) : sk * dot;
      sv = __bfloat162float(vs[cell]);
    }
    const float mn = fmaxf(m, s);
    const float corr = expf(m - mn);
    const float pe = expf(s - mn);
    l = l * corr + pe;
    const float pv = pe * sv;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      const float u = d < hd ? load_val<KIND>(v, row, d, bits) : 0.f;
      acc[i] = acc[i] * corr + pv * u - zp * pv;
    }
    m = mn;
  }

  // merge the warps' carries
  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_acc[kWarps][DPL * 32];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) sm_acc[warp][lane + 32 * i] = acc[i];
  __syncthreads();
  if (warp != 0) return;
  float mx = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
  float lt = 0.f, f[kWarps];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    f[w] = expf(sm_m[w] - mx);
    lt += sm_l[w] * f[w];
  }
  const float inv = lt == 0.f ? 1.f : 1.f / lt;
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    if (d >= hd) continue;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += sm_acc[w][d] * f[w];
    out[static_cast<size_t>(qrow) * hd + d] = a * inv;
  }
}

template <int KIND, bool PAGED>
cudaError_t launch_kind(const float* qg, const float* qsum, const void* k,
                        const void* v, const void* ks, const void* vs,
                        const int32_t* vl, const int32_t* qp, float* out,
                        int rows, int C, int H, int KVH, const Layout& lay,
                        int hd, int row_elems, int bits, cudaStream_t s) {
  const __nv_bfloat16* ksb = static_cast<const __nv_bfloat16*>(ks);
  const __nv_bfloat16* vsb = static_cast<const __nv_bfloat16*>(vs);
  const dim3 grid(rows), block(kWarps * 32);
  const int dpl = (hd + 31) / 32;
#define REPRO_LAUNCH(D)                                                    \
  attention_decode_kernel<KIND, D, PAGED><<<grid, block, 0, s>>>(          \
      qg, qsum, k, v, ksb, vsb, vl, qp, out, C, H, KVH, lay, hd,          \
      row_elems, bits)
  if (dpl <= 1) REPRO_LAUNCH(1);
  else if (dpl <= 2) REPRO_LAUNCH(2);
  else if (dpl <= 4) REPRO_LAUNCH(4);
  else if (dpl <= 8) REPRO_LAUNCH(8);
  else return cudaErrorInvalidValue;
#undef REPRO_LAUNCH
  return cudaGetLastError();
}

template <bool PAGED>
int launch_layout(const void* qg, const void* qsum, const void* k,
                  const void* v, const void* ks, const void* vs,
                  const void* valid_len, const void* qpos, void* out, int B,
                  int C, int H, int KVH, const Layout& lay, int hd,
                  int row_elems, int kind, int bits, int device,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (H % KVH != 0 || (kind == kWords && bits != 4 && bits != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* q = static_cast<const float*>(qg);
  const float* qsm = static_cast<const float*>(qsum);
  const int32_t* vl = static_cast<const int32_t*>(valid_len);
  const int32_t* qp = static_cast<const int32_t*>(qpos);
  float* o = static_cast<float*>(out);
  const int rows = B * C * H;
  switch (kind) {
    case kF32:
      err = launch_kind<kF32, PAGED>(q, qsm, k, v, ks, vs, vl, qp, o, rows, C,
                                     H, KVH, lay, hd, row_elems, bits, s);
      break;
    case kBF16:
      err = launch_kind<kBF16, PAGED>(q, qsm, k, v, ks, vs, vl, qp, o, rows,
                                      C, H, KVH, lay, hd, row_elems, bits, s);
      break;
    case kInt8:
      err = launch_kind<kInt8, PAGED>(q, qsm, k, v, ks, vs, vl, qp, o, rows,
                                      C, H, KVH, lay, hd, row_elems, bits, s);
      break;
    case kWords:
      err = launch_kind<kWords, PAGED>(q, qsm, k, v, ks, vs, vl, qp, o, rows,
                                       C, H, KVH, lay, hd, row_elems, bits,
                                       s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // namespace

// kind: 0 f32 cache, 1 bf16 cache, 2 int8 + bf16 scales, 3 int32 words of
// `bits`-wide fields + bf16 scales.  row_elems is the cache's last dim (hd,
// or hd words).  ks / vs may be null for kinds 0 and 1.
REPRO_EXPORT int attention_decode_launch(
    const void* qg, const void* qsum, const void* k, const void* v,
    const void* ks, const void* vs, const void* valid_len, const void* qpos,
    void* out, int B, int C, int H, int KVH, int S, int hd, int row_elems,
    int kind, int bits, int device, void* stream) {
  const Layout lay{nullptr, S, 0, 1, 0};
  return launch_layout<false>(qg, qsum, k, v, ks, vs, valid_len, qpos, out,
                              B, C, H, KVH, lay, hd, row_elems, kind, bits,
                              device, stream);
}

// K4: as attention_decode_launch, over a pool [P, page_size, KVH, ...] read
// through the block table bt [B, NP] int32 (logical length NP * page_size).
REPRO_EXPORT int attention_decode_paged_launch(
    const void* qg, const void* qsum, const void* k, const void* v,
    const void* ks, const void* vs, const void* valid_len, const void* qpos,
    const void* bt, void* out, int B, int C, int H, int KVH, int NP,
    int page_size, int P, int hd, int row_elems, int kind, int bits,
    int device, void* stream) {
  if (page_size < 1 || P < 1 || NP < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay{static_cast<const int32_t*>(bt), NP * page_size, NP,
                   page_size, P};
  return launch_layout<true>(qg, qsum, k, v, ks, vs, valid_len, qpos, out, B,
                             C, H, KVH, lay, hd, row_elems, kind, bits, device,
                             stream);
}
