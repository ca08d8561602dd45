// K3 and K4: flash-decoding attention over the stored (possibly sub-byte) KV
// cache, contiguous (K3) or paged (K4).
//
// Replaces the Pallas kernel
// repro/kernels/ulppack_attention.py:_attention_decode_pallas
// (`_decode_kernel`): its contiguous-cache branch (K3, pallas_call at :395)
// and its paged branch (K4, pallas_call at :367), and also takes query
// windows wider than one token (C >= 1), which the reference routes to its
// 'xla' backend.  Per query row (b, c, h), with kv head h / (H / KVH) and q
// scaled by hd^-0.5 in f32 (one rounding, as the reference does outside its
// pallas_call):
//   s_p   = q . k_p                         float cache (kv_bits 0/16)
//         = sk_p * (q . u_p)                int8 cache (symmetric)
//         = sk_p * (q . u_p - zp * sum(q))  4/2-bit words, zp = 2^(bits-1)
//   visible positions: p < valid_len[b] and p <= qpos[b, c]
//   out   = sum_p softmax(s)_p * v_p, where a sub-byte value row is
//           sv_p * (u_p - zp): accumulated as (p * sv) . u - zp * sum(p * sv)
// q is read in its own dtype (f32, bf16 or f16); the output is written in
// that dtype, rounded to nearest even as `.to(dtype)` does.  A row with
// nothing visible returns exact zeros (the reference's l == 0 guard).  Word
// unpack is (word >> bits*j) & mask in ascending field order, dropping the
// tail beyond hd.
//
// Bound on Hopper: bytes -- each live cache row (words + bf16 scales) is
// read once per (b, kv head); at decode the products are a few per byte,
// and what a decode read costs beyond that is latency: dependent loads,
// reductions and barriers in sequence.  Design:
//   * grid (split, kv head x query-row chunk, b).  A block serves every
//     query row that reads its kv head (G = H / KVH heads x C positions, up
//     to 64 rows; wider windows take several chunks) over one split of
//     `split_rows` logical positions.  The plan sets the split count so the
//     blocks fill one wave of the card.  A block whose split starts at or
//     past its live end, min(valid_len, max qpos + 1), exits at once, so
//     the cost is O(live rows) while the grid stays fixed (capturable in a
//     CUDA graph).
//   * the split is walked in tiles of `tile_rows` rows, staged in shared
//     memory with cp.async (16-byte copies where the rows allow), double
//     buffered when a split holds more than one tile: tile t+1 is in flight
//     while tile t is computed.  The bf16 scales are plain loads issued
//     with the copies and consumed a tile later.  Paged (K4), the block
//     reads its split's block-table entries once, clamped to [0, P-1], and
//     works out each row's cell before its first copy.
//   * every staged row is unpacked once in the block, and the products run
//     on the CUDA cores in f32 from shared memory, on one of two paths:
//     - warp path, up to 4 query rows (decode, small GQA groups): each warp
//       owns a slice of the tile's rows and keeps its own online-softmax
//       carry for every query row in registers, so a tile costs one block
//       barrier; the lanes unpack K and V values as they read them.
//     - tile path, wider windows: the tile is unpacked into f32 rows that
//       every query row shares, then block-wide phases -- scores (4 query
//       rows x 2 cache rows a thread), one online-softmax update per tile
//       and query row, values (4 query rows x 4 dims a thread).
//   * the splits of one (b, kv head, chunk) form a thread-block cluster and
//     merge in split order through distributed shared memory: on the warp
//     path every split writes its carry into rank 0's shared memory, which
//     merges and writes the rows while the others exit; on the tile path
//     each block reads every split's carry for its share of the outputs.
//     No float atomics and no workspace: two launches on the same inputs
//     are bit-equal, whatever order the blocks ran in.
//
// K4 (PAGED) is the same kernel over a pool [P, page_size, KVH, ...]: the
// logical length is S = NP * page_size, and position p of batch row b lives
// at physical page clamp(bt[b * NP + p / page_size], 0, P - 1), row
// p % page_size.  Split boundaries (whole pages), tiles, loop order and the
// merge are K3's; only the staging addresses differ, so on the same logical
// data and plan geometry K4 gives K3's bits.  Pages hold whole words, so a
// row never straddles a page.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <cmath>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

// The kernel's constraints; kernels/plan.py keeps the same numbers
// (ATTN_*) and the same shared-memory layout (attention_smem_bytes).
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplits = 8;   // the portable cluster size
constexpr int kMaxQRows = 64;
constexpr int kMaxTile = 128;
constexpr int kSmemMax = 232448;
constexpr int kMinBlocks = 3;   // blocks per SM the registers must allow
constexpr float kNegInf = -1e30f;

// Cache kinds of the interface (kWords: int32 words of `bits`-wide fields);
// the kernel is instantiated per field width, kW4 and kW2.
enum Kind { kF32 = 0, kBF16 = 1, kInt8 = 2, kWords = 3 };
enum KernelKind { kW4 = 3, kW2 = 4 };

template <int KIND>
struct Fields {  // the word layout of a sub-byte kind
  static constexpr int bits = KIND == kW2 ? 2 : 4;
  static constexpr int per = 32 / bits;
  static constexpr uint32_t mask = (1u << bits) - 1u;
};
enum QType { kQF32 = 0, kQBF16 = 1, kQF16 = 2 };

struct Args {
  const void* q;
  const unsigned char* k;
  const unsigned char* v;
  const __nv_bfloat16* ks;
  const __nv_bfloat16* vs;
  const int32_t* valid_len;
  const int32_t* qpos;
  const int32_t* bt;  // paged only
  void* out;
  int C, H, KVH, G, S, NP, page_size, P;
  int hd, row_bytes, rstride, bits, qtype, copy_bytes;
  int qrows, split_rows, splits, tile_rows, table_len;
  float qscale;
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Dims padded to a multiple of 8 (the unpack writes 8 at a time), and the
// f32 row stride of the shared q, K and V tiles: hdp + 4, so a 16-byte
// load by 8 lanes on 8 consecutive rows hits 32 distinct banks.
__host__ __device__ inline int padded_dims(int hd) { return (hd + 7) & ~7; }
__host__ __device__ inline int row_stride(int hd) {
  return padded_dims(hd) + 4;
}

// The warp path (see the note at the top): a block of kWarps warps, each
// taking tile / kWarps consecutive rows of a 32-, 64- or 128-row tile, 8, 4
// or 2 lanes a row; it holds kWarpQ query rows x DPL dims a lane in
// registers.
constexpr int kWarpQ = 4;
__host__ __device__ inline bool warp_tile_ok(int tile) {
  return tile == 32 || tile == 64 || tile == 128;
}

// The warp path's dims a lane for qrows query rows of hd dims, or 0 for
// the tile path (more than kWarpQ query rows).
__host__ __device__ inline int warp_variant(int qrows, int hd) {
  const int hdp = padded_dims(hd);
  if (qrows > kWarpQ) return 0;
  return hdp <= 64 ? 2 : hdp <= 128 ? 4 : 8;
}

// Byte offsets of the block's shared-memory regions; query rows are
// padded to a multiple of 4.  The tile path stages unpacked f32 K and V
// tiles and the scores; the warp path keeps those in registers and needs
// each warp's carry, and every split's at rank 0.
struct Smem {
  size_t q, acc, kf, vf, p, raw, sk, sv, row, f, tbl, wml, wacc, pm, total;
};

__host__ __device__ inline Smem smem_layout(int qrows, int tile, int hd,
                                            int rstride, int table_len,
                                            int split_rows) {
  const size_t ld = row_stride(hd), hdp = padded_dims(hd);
  const size_t q4 = (qrows + 3) & ~3;
  const bool warp = warp_variant(qrows, hd) != 0;
  const size_t tl = warp ? 0 : tile;  // f32 tile rows
  const size_t wq = warp ? q4 : 0;    // rows of the warps' carries
  const size_t nbuf = split_rows > tile ? 2 : 1;  // one tile: no 2nd buffer
  Smem s;
  size_t o = 0;
  s.q = o;    o += align16(4 * q4 * ld);         // q * hd^-0.5
  s.acc = o;  o += align16(4 * q4 * hdp);        // the block's carry: acc
  s.kf = o;   o += align16(4 * tl * ld);         // unpacked K tile
  s.vf = o;   o += align16(4 * tl * ld);         // unpacked V tile
  s.p = o;    o += align16(4 * q4 * tl);         // scores, probabilities
  s.raw = o;  o += align16(2 * nbuf * tile * rstride);  // buffers x (K, V)
  s.sk = o;   o += align16(4 * tl);
  s.sv = o;   o += align16(4 * tl);
  s.row = o;  o += align16(4 * 7 * q4);  // m, l, corr, zsum, qsum, qpos, q0
  s.f = o;    o += align16(4 * (kMaxSplits + 1) * q4);  // merge weights, l
  s.tbl = o;  o += align16(4 * static_cast<size_t>(table_len));
  s.wml = o;  o += align16(4 * 2 * kWarps * wq);        // warps' m, l
  s.wacc = o; o += align16(4 * kWarps * wq * hdp);      // warps' acc
  s.pm = o;   o += align16(4 * kMaxSplits * wq * (hdp + 2));  // splits'
  s.total = o;                                   // carries, at rank 0
  return s;
}

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src) : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float load_q(const void* q, int qtype, size_t i) {
  if (qtype == kQBF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i]);
  if (qtype == kQF16) return __half2float(static_cast<const __half*>(q)[i]);
  return static_cast<const float*>(q)[i];
}

__device__ __forceinline__ void store_out(void* out, int qtype, size_t i,
                                          float x) {
  if (qtype == kQBF16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(x);
  else if (qtype == kQF16)
    static_cast<__half*>(out)[i] = __float2half_rn(x);
  else
    static_cast<float*>(out)[i] = x;
}

// The cache cell (row index into [.., KVH, row]) of logical position p;
// paged, the split's cells were worked out from its table entries into
// cells[p - s0] before the first copy.
template <bool PAGED>
__device__ __forceinline__ size_t cache_cell(const Args& a, int b, int kvh,
                                             int p, int s0,
                                             const int* cells) {
  if (!PAGED) return (static_cast<size_t>(b) * a.S + p) * a.KVH + kvh;
  return static_cast<size_t>(static_cast<unsigned>(cells[p - s0]));
}

struct Scales {
  __nv_bfloat16 k, v;
};

// Issue the copies of the K and V rows of positions [t0, t0 + n) into
// staging buffer `buf`; returns the scales of tile row `srow` (the row
// this thread serves them for), which the caller consumes one tile later.
template <int KIND, bool PAGED>
__device__ __forceinline__ Scales stage(const Args& a, unsigned char* raw,
                                        int buf, int b, int kvh, int t0,
                                        int n, int s0, const int* cells,
                                        int srow) {
  const int T = a.tile_rows;
  const int cb = a.copy_bytes;
  if (cb) {
    // this thread's chunks: row tt of the tile's K rows then V rows, chunk
    // ch of the row, stepped by kThreads chunks without a division
    const int cpr = a.row_bytes / cb;
    const int st = kThreads / cpr, sch = kThreads - st * cpr;
    int tt = threadIdx.x / cpr, ch = threadIdx.x - tt * cpr;
    for (; tt < 2 * n; tt += st) {
      const int kv = tt >= n, t = tt - kv * n;
      const size_t cell = cache_cell<PAGED>(a, b, kvh, t0 + t, s0, cells);
      const unsigned char* src =
          (kv ? a.v : a.k) + cell * a.row_bytes + ch * cb;
      unsigned char* dst =
          raw + (static_cast<size_t>(buf * 2 + kv) * T + t) * a.rstride +
          ch * cb;
      cp_async(dst, src, cb);
      ch += sch;
      if (ch >= cpr) {
        ch -= cpr;
        ++tt;
      }
    }
  } else {  // rows of a size that is no multiple of 4 bytes: plain loads
    const int per_kv = n * a.row_bytes;
    for (int e = threadIdx.x; e < 2 * per_kv; e += kThreads) {
      const int kv = e / per_kv, rem = e - kv * per_kv;
      const int t = rem / a.row_bytes, by = rem - t * a.row_bytes;
      const size_t cell = cache_cell<PAGED>(a, b, kvh, t0 + t, s0, cells);
      raw[(static_cast<size_t>(buf * 2 + kv) * T + t) * a.rstride + by] =
          (kv ? a.v : a.k)[cell * a.row_bytes + by];
    }
  }
  Scales sc{__float2bfloat16(0.f), __float2bfloat16(0.f)};
  if (KIND >= kInt8 && srow >= 0 && srow < n) {
    const size_t cell = cache_cell<PAGED>(a, b, kvh, t0 + srow, s0, cells);
    sc.k = a.ks[cell];
    sc.v = a.vs[cell];
  }
  return sc;
}

template <int KIND>
__device__ __forceinline__ float unpack(const unsigned char* row, int d) {
  if (KIND == kF32) return reinterpret_cast<const float*>(row)[d];
  if (KIND == kBF16)
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(row)[d]);
  if (KIND == kInt8)
    return static_cast<float>(reinterpret_cast<const int8_t*>(row)[d]);
  using F = Fields<KIND>;
  const uint32_t word = reinterpret_cast<const uint32_t*>(row)[d / F::per];
  return static_cast<float>((word >> (F::bits * (d % F::per))) & F::mask);
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ float s8(uint32_t w, int j) {
  return static_cast<float>(static_cast<int8_t>(w >> (8 * j)));
}

// Dims 8g .. 8g+7 of a staged row into (lo, hi), zero past hd.
template <int KIND>
__device__ __forceinline__ void unpack8(const unsigned char* row, int g,
                                        int hd, float4& lo, float4& hi) {
  const int d0 = 8 * g;
  if (d0 + 8 > hd) {
    auto f = [&](int j) {
      return d0 + j < hd ? unpack<KIND>(row, d0 + j) : 0.f;
    };
    lo = make_float4(f(0), f(1), f(2), f(3));
    hi = make_float4(f(4), f(5), f(6), f(7));
  } else if (KIND == kF32) {
    lo = reinterpret_cast<const float4*>(row)[2 * g];
    hi = reinterpret_cast<const float4*>(row)[2 * g + 1];
  } else if (KIND == kBF16) {
    const uint4 w = reinterpret_cast<const uint4*>(row)[g];
    lo = make_float4(bf16_lo(w.x), bf16_hi(w.x), bf16_lo(w.y), bf16_hi(w.y));
    hi = make_float4(bf16_lo(w.z), bf16_hi(w.z), bf16_lo(w.w), bf16_hi(w.w));
  } else if (KIND == kInt8) {
    const uint2 w = reinterpret_cast<const uint2*>(row)[g];
    lo = make_float4(s8(w.x, 0), s8(w.x, 1), s8(w.x, 2), s8(w.x, 3));
    hi = make_float4(s8(w.y, 0), s8(w.y, 1), s8(w.y, 2), s8(w.y, 3));
  } else {
    using F = Fields<KIND>;
    const uint32_t w =
        reinterpret_cast<const uint32_t*>(row)[d0 / F::per] >>
        (F::bits * (d0 % F::per));
    auto f = [&](int j) {
      return static_cast<float>((w >> (F::bits * j)) & F::mask);
    };
    lo = make_float4(f(0), f(1), f(2), f(3));
    hi = make_float4(f(4), f(5), f(6), f(7));
  }
}

// Element d of query row i of the chunk starting at kv-head row r0, in
// q / out [B, C, H, hd].
__device__ __forceinline__ size_t out_index(const Args& a, int b, int kvh,
                                            int r0, int i, int d) {
  const int r = r0 + i;
  return (static_cast<size_t>(b * a.C + r / a.G) * a.H + kvh * a.G +
          r % a.G) * a.hd + d;
}

// q = n * i + r for 0 <= q < 2^22, with inv = 1 / n in f32: one rounding
// step off at most, corrected.
__device__ __forceinline__ int div_small(int q, int n, float inv, int& r) {
  int i = __float2int_rz(__int2float_rn(q) * inv);
  int rem = q - i * n;
  if (rem < 0) {
    --i;
    rem += n;
  } else if (rem >= n) {
    ++i;
    rem -= n;
  }
  r = rem;
  return i;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// The warp path: every warp owns tile / kWarps rows of each staged tile
// and keeps its own online-softmax carry for all query rows (kWarpQ x DPL
// values a lane), so a tile costs one block barrier.  A row is unpacked
// once in the block: 32 / (tile / kWarps) lanes split its K dims for the
// scores, and every lane unpacks its dims of the V row for the values.
// The warps' carries then merge, in warp order, into the split's carry,
// written straight into cluster rank 0's shared memory (pacc [Q4][hdp],
// pml m and l [2][Q4] there).
template <int KIND, bool PAGED, int DPL>
__device__ __forceinline__ void warp_tiles(
    const Args& a, unsigned char* raw, const float* q_s,
    const float* qsum_s, const int* qp_s, float* pacc, float* pml,
    unsigned char* wml_b, unsigned char* wacc_b, const int* cells, int b,
    int kvh, int s0, int s1, int nq, int srow, Scales sc_next) {
  constexpr unsigned kFull = 0xffffffffu;
  const int T = a.tile_rows, WR = T / kWarps, LPR = 32 / WR;
  const int hd = a.hd, hdp = padded_dims(hd), ld = row_stride(hd);
  const int Q4 = (a.qrows + 3) & ~3;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float zp =
      KIND >= kW4 ? static_cast<float>(1 << (Fields<KIND>::bits - 1)) : 0.f;
  float* wml = reinterpret_cast<float*>(wml_b);  // [warp][m | l][Q4]
  float* wm = wml + warp * 2 * Q4;
  float* wl = wm + Q4;
  float* wacc = reinterpret_cast<float*>(wacc_b);  // [warp][Q4][hdp]
  if (lane < Q4) {
    wm[lane] = kNegInf;
    wl[lane] = 0.f;
  }
  float acc[kWarpQ][DPL];
#pragma unroll
  for (int i = 0; i < kWarpQ; ++i)
#pragma unroll
    for (int k = 0; k < DPL; ++k) acc[i][k] = 0.f;
  const int rt = lane / LPR, sl = lane - rt * LPR;  // row, dim half
  const int t = warp * WR + rt;                     // this lane's tile row
  const int g8 = hdp / 8;
  const int ntiles = (s1 - s0 + T - 1) / T;

  for (int ti = 0; ti < ntiles; ++ti) {
    const int t0 = s0 + ti * T;
    const int n = min(T, s1 - t0);
    const Scales sc = sc_next;
    cp_async_wait<0>();
    __syncthreads();  // tile ti landed; every warp is done with tile ti - 1
    if (ti + 1 < ntiles) {
      sc_next = stage<KIND, PAGED>(a, raw, (ti + 1) & 1, b, kvh, t0 + T,
                                   min(T, s1 - t0 - T), s0, cells, srow);
      cp_async_commit();
    }
    const unsigned char* rk =
        raw + static_cast<size_t>((ti & 1) * 2) * T * a.rstride;
    const unsigned char* rv = rk + static_cast<size_t>(T) * a.rstride;
    const bool row_ok = t < n;

    // this row's scores, half the dims a lane
    float s[kWarpQ];
#pragma unroll
    for (int i = 0; i < kWarpQ; ++i) s[i] = 0.f;
    if (row_ok) {
      const unsigned char* kr = rk + static_cast<size_t>(t) * a.rstride;
#pragma unroll 2
      for (int g = sl; g < g8; g += LPR) {
        float4 lo, hi;
        unpack8<KIND>(kr, g, hd, lo, hi);
#pragma unroll
        for (int i = 0; i < kWarpQ; ++i) {
          if (i >= nq) break;
          const float4* qr = reinterpret_cast<const float4*>(q_s + i * ld);
          s[i] = dot4(qr[2 * g + 1], hi, dot4(qr[2 * g], lo, s[i]));
        }
      }
    }
    // the row's scales sit with lane rt (stage's srow)
    const float skr =
        __shfl_sync(kFull, KIND >= kInt8 ? __bfloat162float(sc.k) : 1.f, rt);
    const float svr =
        __shfl_sync(kFull, KIND >= kInt8 ? __bfloat162float(sc.v) : 1.f, rt);

    // one online-softmax update per query row over the warp's rows
#pragma unroll
    for (int i = 0; i < kWarpQ; ++i) {
      if (i >= nq) break;
      float x = s[i];
      for (int off = 1; off < LPR; off <<= 1)
        x += __shfl_xor_sync(kFull, x, off);
      if (KIND >= kW4) x = skr * (x - zp * qsum_s[i]);
      else if (KIND == kInt8) x = skr * x;
      const bool vis = row_ok && t0 + t <= qp_s[i];
      float mx = vis ? x : kNegInf;
      for (int off = LPR; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_old = wm[i];
      const float mn = fmaxf(m_old, mx);
      const float corr = expf(m_old - mn);
      const float pe = vis ? expf(x - mn) : 0.f;
      const float pv = pe * svr;
      float ls = pe, zs = pv;
      for (int off = LPR; off < 32; off <<= 1) {
        ls += __shfl_xor_sync(kFull, ls, off);
        zs += __shfl_xor_sync(kFull, zs, off);
      }
      __syncwarp();
      if (lane == 0) {
        wm[i] = mn;
        wl[i] = wl[i] * corr + ls;
      }
      const float z = KIND >= kW4 ? zp * zs : 0.f;
#pragma unroll
      for (int k = 0; k < DPL; ++k) acc[i][k] = acc[i][k] * corr - z;
      s[i] = pv;
    }

    // acc += (p * sv) . u over the warp's rows, DPL dims a lane
    // (rows past the tile carry p = 0; their stale bytes are not read)
#pragma unroll 4
    for (int tt = 0; tt < WR; ++tt) {
      const int trow = warp * WR + tt;
      const unsigned char* vr = rv + static_cast<size_t>(trow) * a.rstride;
      float v[DPL];
#pragma unroll
      for (int k = 0; k < DPL; ++k) {
        const int d = lane + 32 * k;
        v[k] = d < hd && trow < n ? unpack<KIND>(vr, d) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kWarpQ; ++i) {
        if (i >= nq) break;
        const float pr = __shfl_sync(kFull, s[i], tt * LPR);
#pragma unroll
        for (int k = 0; k < DPL; ++k) acc[i][k] = fmaf(pr, v[k], acc[i][k]);
      }
    }
  }

  // the warps' carries, merged in warp order into the block's
#pragma unroll
  for (int i = 0; i < kWarpQ; ++i) {
    if (i >= nq) break;
#pragma unroll
    for (int k = 0; k < DPL; ++k) {
      const int d = lane + 32 * k;
      if (d < hdp) wacc[(warp * Q4 + i) * hdp + d] = acc[i][k];
    }
  }
  __syncthreads();
  for (int o = tid; o < nq * hdp; o += kThreads) {
    const int i = o / hdp, d = o - i * hdp;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wml[w * 2 * Q4 + i]);
    float l = 0.f, x = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(wml[w * 2 * Q4 + i] - mx);
      l += wml[w * 2 * Q4 + Q4 + i] * f;
      x += wacc[(w * Q4 + i) * hdp + d] * f;
    }
    pacc[o] = x;
    if (d == 0) {
      pml[i] = mx;
      pml[Q4 + i] = l;
    }
  }
}

// DPL: the warp path's dims a lane, or 0 for the tile path.
template <int KIND, bool PAGED, int DPL>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
attention_decode_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = a.hd, T = a.tile_rows, Q = a.qrows;
  const int hdp = padded_dims(hd), ld = row_stride(hd), Q4 = (Q + 3) & ~3;
  const Smem L = smem_layout(Q, T, hd, a.rstride, a.table_len, a.split_rows);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* acc_s = reinterpret_cast<float*>(smem + L.acc);
  float* kf = reinterpret_cast<float*>(smem + L.kf);
  float* vf = reinterpret_cast<float*>(smem + L.vf);
  float* p_s = reinterpret_cast<float*>(smem + L.p);
  unsigned char* raw = smem + L.raw;
  float* sk_s = reinterpret_cast<float*>(smem + L.sk);
  float* sv_s = reinterpret_cast<float*>(smem + L.sv);
  float* m_s = reinterpret_cast<float*>(smem + L.row);
  float* l_s = m_s + Q4;
  float* corr_s = m_s + 2 * Q4;
  float* zs_s = m_s + 3 * Q4;
  float* qsum_s = m_s + 4 * Q4;
  int* qp_s = reinterpret_cast<int*>(m_s + 5 * Q4);
  int* qb_s = qp_s + Q4;  // where query row i starts in q and out
  float* f_s = reinterpret_cast<float*>(smem + L.f);  // [splits][Q4], then l
  float* lt_s = f_s + kMaxSplits * Q4;
  int* tbl = reinterpret_cast<int*>(smem + L.tbl);

  cg::cluster_group cluster = cg::this_cluster();
  // warp path: announce that this block runs, so that other blocks may
  // write into its shared memory once they have waited for the cluster
  if constexpr (DPL != 0)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int sp = blockIdx.x;  // the split, and the block's cluster rank
  const int kvh = blockIdx.y % a.KVH;
  const int r0 = (blockIdx.y / a.KVH) * Q;  // first query row of the chunk
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nq = min(Q, a.C * a.G - r0);
  const int nq4 = (nq + 3) >> 2;
  const float zp =
      KIND >= kW4 ? static_cast<float>(1 << (Fields<KIND>::bits - 1)) : 0.f;

  // the live end: valid_len and the query positions, loaded together.
  // Query row i of the chunk is row r0 + i of the kv head: position
  // c = r / G, head kvh * G + r % G.
  const int vlen = a.valid_len[b];
  if (tid < nq) {
    qp_s[tid] = a.qpos[b * a.C + (r0 + tid) / a.G];
    qb_s[tid] = static_cast<int>(out_index(a, b, kvh, r0, tid, 0));
  }
  __syncthreads();
  int qmax = -1;
  for (int i = 0; i < nq; ++i) qmax = max(qmax, qp_s[i]);
  const int end = max(0, min(min(vlen, a.S), qmax + 1));
  const int n_live = (end + a.split_rows - 1) / a.split_rows;
  if (n_live == 0) {  // nothing visible to any row: exact zeros
    for (int o = sp * kThreads + tid; o < nq * hd; o += a.splits * kThreads)
      store_out(a.out, a.qtype, qb_s[o / hd] + o % hd, 0.f);
    return;
  }
  // a split past the live end leaves at once: the cluster barriers below
  // wait only for threads that have not exited, and no block reads a dead
  // split's shared memory
  if (sp >= n_live) return;

  {  // the live split [s0, s1)
    const int s0 = sp * a.split_rows;
    const int s1 = min(s0 + a.split_rows, end);
    // paged: the split's table entries, read once and clamped, then the
    // cell of each of its rows
    int* cells = tbl + a.split_rows / a.page_size;
    if (PAGED) {
      const int np = a.split_rows / a.page_size;
      for (int j = tid; j < np; j += kThreads) {
        const int pi = s0 / a.page_size + j;
        const int pg = pi < a.NP ? a.bt[static_cast<size_t>(b) * a.NP + pi]
                                 : 0;
        tbl[j] = min(max(pg, 0), a.P - 1);
      }
      __syncthreads();
      for (int j = tid; j < a.split_rows; j += kThreads) {
        const int pj = j / a.page_size;
        cells[j] = static_cast<int>(
            (static_cast<unsigned>(tbl[pj]) * a.page_size + j -
             pj * a.page_size) * a.KVH + kvh);
      }
      __syncthreads();  // the cells before the first copy
    }
    // q scaled by hd^-0.5 (rows past the chunk and dims past hd zero):
    // each thread's first eight elements loaded ahead of the first tile's
    // copies and stored after them, walked without divisions
    const int q_si = kThreads / ld, q_sd = kThreads - q_si * ld;
    int q_i = tid / ld, q_d = tid - q_i * ld;
    float qx[8];
    int qe[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      qx[j] = q_i < nq && q_d < hd ? load_q(a.q, a.qtype, qb_s[q_i] + q_d)
                                   : 0.f;
      qe[j] = q_i * ld + q_d;
      q_d += q_sd;
      q_i += q_si;
      if (q_d >= ld) {
        q_d -= ld;
        ++q_i;
      }
    }
    const int ntiles = (s1 - s0 + T - 1) / T;
    // the tile row whose scales this thread loads
    const int wr = T / kWarps;  // rows a warp (warp path)
    const int srow = DPL ? (lane < wr ? warp * wr + lane : -1) : tid;
    Scales sc_next = stage<KIND, PAGED>(a, raw, 0, b, kvh, s0,
                                        min(T, s1 - s0), s0, cells, srow);
    cp_async_commit();
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (qe[j] < Q4 * ld) q_s[qe[j]] = qx[j] * a.qscale;
    for (; q_i < Q4;) {  // the rest (more than 8 x kThreads elements)
      q_s[q_i * ld + q_d] =
          q_i < nq && q_d < hd
              ? load_q(a.q, a.qtype, qb_s[q_i] + q_d) * a.qscale
              : 0.f;
      q_d += q_sd;
      q_i += q_si;
      if (q_d >= ld) {
        q_d -= ld;
        ++q_i;
      }
    }

    __syncthreads();
    for (int i = warp; i < Q4; i += kWarps) {
      float part = 0.f;
      for (int d = lane; d < ld; d += 32) part += q_s[i * ld + d];
      part = warp_sum_f32(part);
      if (lane == 0) {
        m_s[i] = kNegInf;
        l_s[i] = 0.f;
        qsum_s[i] = part;
      }
    }
    if constexpr (DPL == 0) {
    for (int e = tid; e < Q4 * hdp; e += kThreads) acc_s[e] = 0.f;

    // work split of the two products: `ds` threads share an item (4 query
    // rows x two cache rows for the scores, 4 query rows x 4 dims for the
    // values), each taking every ds-th chunk; their sums meet by shuffles
    const int c4 = hdp / 4;
    const int s_items = nq4 * ((T + 1) >> 1);  // bound: n <= T rows
    int s_ds = 1;
    while (s_ds < 8 && s_items * s_ds * 2 <= kThreads) s_ds *= 2;
    const int v_items = nq4 * c4;
    int v_ds = 1;
    while (v_ds < 16 && v_ds * 4 < T && v_items * v_ds * 2 <= kThreads)
      v_ds *= 2;
    const float inv_c4 = 1.f / c4;

    // the unpack's items (row, group of 8 dims), walked without divisions
    const int g8 = hdp / 8;
    const int u_t = tid / g8, u_g = tid - u_t * g8;
    const int u_st = kThreads / g8, u_sg = kThreads - u_st * g8;

    for (int ti = 0; ti < ntiles; ++ti) {
      const int t0 = s0 + ti * T;
      const int n = min(T, s1 - t0);
      const Scales sc = sc_next;
      if (ti + 1 < ntiles) {
        sc_next = stage<KIND, PAGED>(a, raw, (ti + 1) & 1, b, kvh, t0 + T,
                                     min(T, s1 - t0 - T), s0, cells, srow);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();

      // unpack the tile once, 8 dims at a time: f32 rows shared by every
      // query row; rows past the tile's end and dims past hd are zero
      {
        const unsigned char* rk =
            raw + static_cast<size_t>((ti & 1) * 2) * T * a.rstride;
        int g = u_g, tt = u_t;  // K rows, then V rows
        for (; tt < 2 * T;) {
          const int kv = tt >= T, t = tt - kv * T;
          float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
          if (t < n)
            unpack8<KIND>(rk + (static_cast<size_t>(kv) * T + t) * a.rstride,
                          g, hd, lo, hi);
          float4* dst =
              reinterpret_cast<float4*>((kv ? vf : kf) + t * ld + 8 * g);
          dst[0] = lo;
          dst[1] = hi;
          g += u_sg;
          tt += u_st;
          if (g >= g8) {
            g -= g8;
            ++tt;
          }
        }
      }
      if (tid < T) {
        sk_s[tid] = KIND >= kInt8 && tid < n ? __bfloat162float(sc.k) : 1.f;
        sv_s[tid] = KIND >= kInt8 ? (tid < n ? __bfloat162float(sc.v) : 0.f)
                                  : 1.f;
      }
      __syncthreads();

      // scores: a thread takes 4 query rows x 2 cache rows (t, t + nh)
      {
        const int nh = (n + 1) >> 1;
        const float inv_nh = 1.f / nh;
        const int items = nq4 * nh;
        const int pw = 32 / s_ds, part = lane / pw, il = lane - part * pw;
        auto score = [&](float dot, int i, int t) {
          if (KIND >= kW4) return sk_s[t] * (dot - zp * qsum_s[i]);
          if (KIND == kInt8) return sk_s[t] * dot;
          return dot;
        };
        for (int base = warp * pw; base < items; base += kWarps * pw) {
          const int it = base + il;
          const bool ok = it < items;
          int t = 0;
          const int i4 = ok ? div_small(it, nh, inv_nh, t) : 0;
          const int t2 = t + nh;
          const bool two = t2 < n;
          float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
          if (ok) {
            const float4* kr = reinterpret_cast<const float4*>(kf + t * ld);
            const float4* kr2 =
                reinterpret_cast<const float4*>(kf + (two ? t2 : t) * ld);
            const float4* qr =
                reinterpret_cast<const float4*>(q_s + 4 * i4 * ld);
            for (int c = part; c < c4; c += s_ds) {
              const float4 k4 = kr[c], k4b = kr2[c];
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                const float4 q4 = qr[r * (ld / 4) + c];
                acc[r] = dot4(q4, k4, acc[r]);
                acc[4 + r] = dot4(q4, k4b, acc[4 + r]);
              }
            }
          }
#pragma unroll
          for (int off = pw; off < 32; off <<= 1)
#pragma unroll
            for (int r = 0; r < 8; ++r)
              acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
          if (ok && part == 0) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int i = 4 * i4 + r;
              if (i >= nq) break;
              p_s[i * T + t] = score(acc[r], i, t);
              if (two) p_s[i * T + t2] = score(acc[4 + r], i, t2);
            }
          }
        }
      }
      __syncthreads();

      // one online-softmax update per query row (a warp per row); the
      // probabilities times the value scales replace the scores, zero past
      // the tile's rows and where masked (two rows at once, i0 and
      // i1 = i0 + kWarps, for two chains in flight; a lone last row takes
      // i1 = i0 and writes once)
      for (int i0 = warp; i0 < nq; i0 += 2 * kWarps) {
        const bool two = i0 + kWarps < nq;
        const int i1 = two ? i0 + kWarps : i0;
        const int qp0 = qp_s[i0], qp1 = qp_s[i1];
        float mx0 = kNegInf, mx1 = kNegInf;
        for (int t = lane; t < n; t += 32) {
          if (t0 + t <= qp0) mx0 = fmaxf(mx0, p_s[i0 * T + t]);
          if (t0 + t <= qp1) mx1 = fmaxf(mx1, p_s[i1 * T + t]);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        const float mo0 = m_s[i0], mo1 = m_s[i1];
        const float mn0 = fmaxf(mo0, mx0), mn1 = fmaxf(mo1, mx1);
        float ls0 = 0.f, zs0 = 0.f, ls1 = 0.f, zs1 = 0.f;
        for (int t = lane; t < T; t += 32) {
          const float sv = sv_s[t];
          const float pe0 =
              t < n && t0 + t <= qp0 ? expf(p_s[i0 * T + t] - mn0) : 0.f;
          const float pe1 =
              t < n && t0 + t <= qp1 ? expf(p_s[i1 * T + t] - mn1) : 0.f;
          ls0 += pe0;
          zs0 += pe0 * sv;
          ls1 += pe1;
          zs1 += pe1 * sv;
          p_s[i0 * T + t] = pe0 * sv;
          if (two) p_s[i1 * T + t] = pe1 * sv;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          ls0 += __shfl_xor_sync(0xffffffffu, ls0, off);
          zs0 += __shfl_xor_sync(0xffffffffu, zs0, off);
          ls1 += __shfl_xor_sync(0xffffffffu, ls1, off);
          zs1 += __shfl_xor_sync(0xffffffffu, zs1, off);
        }
        __syncwarp();
        if (lane == 0) {
          const float c0 = expf(mo0 - mn0), c1 = expf(mo1 - mn1);
          m_s[i0] = mn0;
          l_s[i0] = l_s[i0] * c0 + ls0;
          corr_s[i0] = c0;
          zs_s[i0] = zs0;
          if (two) {
            m_s[i1] = mn1;
            l_s[i1] = l_s[i1] * c1 + ls1;
            corr_s[i1] = c1;
            zs_s[i1] = zs1;
          }
        }
      }
      __syncthreads();

      // acc = acc * corr + (p * sv) . u - zp * sum(p * sv): a thread takes
      // 4 query rows x 4 dims over every v_ds-th group of 4 cache rows
      {
        const int pw = 32 / v_ds, part = lane / pw, il = lane - part * pw;
        const int t4 = (n + 3) >> 2;
        for (int base = warp * pw; base < v_items; base += kWarps * pw) {
          const int it = base + il;
          const bool ok = it < v_items;
          int dc = 0;
          const int i4 = ok ? div_small(it, c4, inv_c4, dc) : 0;
          float4 acc[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (ok) {
            for (int tb = part; tb < t4; tb += v_ds) {
              float4 p4[4];
#pragma unroll
              for (int r = 0; r < 4; ++r)
                p4[r] = reinterpret_cast<const float4*>(
                    p_s + (4 * i4 + r) * T)[tb];
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const float4 v4 = reinterpret_cast<const float4*>(
                    vf + (4 * tb + u) * ld)[dc];
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                  const float pr = u == 0 ? p4[r].x : u == 1 ? p4[r].y
                                 : u == 2 ? p4[r].z : p4[r].w;
                  acc[r].x = fmaf(pr, v4.x, acc[r].x);
                  acc[r].y = fmaf(pr, v4.y, acc[r].y);
                  acc[r].z = fmaf(pr, v4.z, acc[r].z);
                  acc[r].w = fmaf(pr, v4.w, acc[r].w);
                }
              }
            }
          }
#pragma unroll
          for (int off = pw; off < 32; off <<= 1)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              acc[r].x += __shfl_xor_sync(0xffffffffu, acc[r].x, off);
              acc[r].y += __shfl_xor_sync(0xffffffffu, acc[r].y, off);
              acc[r].z += __shfl_xor_sync(0xffffffffu, acc[r].z, off);
              acc[r].w += __shfl_xor_sync(0xffffffffu, acc[r].w, off);
            }
          if (ok && part == 0) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int i = 4 * i4 + r;
              if (i >= nq) break;
              const float c = corr_s[i];
              const float z = KIND >= kW4 ? zp * zs_s[i] : 0.f;
              float4* A = reinterpret_cast<float4*>(acc_s + i * hdp) + dc;
              const float4 o = *A;
              *A = make_float4(o.x * c + acc[r].x - z, o.y * c + acc[r].y - z,
                               o.z * c + acc[r].z - z,
                               o.w * c + acc[r].w - z);
            }
          }
        }
      }
      __syncthreads();
    }
    } else {
      float* pm = reinterpret_cast<float*>(smem + L.pm);
      asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
      float* pacc = cluster.map_shared_rank(pm, 0) + sp * Q4 * hdp;
      float* pml = cluster.map_shared_rank(pm, 0) + kMaxSplits * Q4 * hdp +
                   sp * 2 * Q4;
      warp_tiles<KIND, PAGED, DPL>(a, raw, q_s, qsum_s, qp_s, pacc, pml,
                                       smem + L.wml, smem + L.wacc, cells, b,
                                       kvh, s0, s1, nq, srow, sc_next);
      // rank 0 holds every live split's carry: it merges them in split
      // order and writes the rows; the other blocks are done
      cluster.sync();
      if (sp != 0) return;
      const float* ml = pm + kMaxSplits * Q4 * hdp;
      for (int o = tid; o < nq * hd; o += kThreads) {
        const int i = o / hd, d = o - i * hd;
        float mx = kNegInf;
        for (int j = 0; j < n_live; ++j) mx = fmaxf(mx, ml[j * 2 * Q4 + i]);
        float l = 0.f, x = 0.f;
        for (int j = 0; j < n_live; ++j) {
          const float f = expf(ml[j * 2 * Q4 + i] - mx);
          l += ml[j * 2 * Q4 + Q4 + i] * f;
          x += pm[(j * Q4 + i) * hdp + d] * f;
        }
        store_out(a.out, a.qtype, qb_s[i] + d, l == 0.f ? 0.f : x / l);
      }
      return;
    }
  }

  // merge the live splits' carries, in split order, through distributed
  // shared memory; every block of the cluster writes a share of the rows
  cluster.sync();
  if (tid < nq) {
    float mj[kMaxSplits], lj[kMaxSplits];
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j) {
      mj[j] = j < n_live ? *cluster.map_shared_rank(m_s + tid, j) : kNegInf;
      lj[j] = j < n_live ? *cluster.map_shared_rank(l_s + tid, j) : 0.f;
    }
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j) mx = fmaxf(mx, mj[j]);
    float lt = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j) {
      if (j >= n_live) break;
      const float f = expf(mj[j] - mx);
      f_s[j * Q4 + tid] = f;
      lt += lj[j] * f;
    }
    lt_s[tid] = lt;
  }
  __syncthreads();
  for (int o = sp * kThreads + tid; o < nq * hd; o += n_live * kThreads) {
    const int i = o / hd, d = o - i * hd;
    float aj[kMaxSplits];
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j)
      aj[j] = j < n_live ? *cluster.map_shared_rank(acc_s + i * hdp + d, j)
                         : 0.f;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j)
      if (j < n_live) acc += aj[j] * f_s[j * Q4 + i];
    const float lt = lt_s[i];
    store_out(a.out, a.qtype, qb_s[i] + d, lt == 0.f ? 0.f : acc / lt);
  }
  cluster.sync();  // no block leaves while another reads its carries
}

template <int KIND, bool PAGED, int DPL>
cudaError_t launch_variant(const Args& a, int B, int qchunks, size_t smem,
                           int device, cudaStream_t s) {
  void (*kern)(Args) = attention_decode_kernel<KIND, PAGED, DPL>;
  static size_t raised[8] = {0};  // per device, this instantiation
  if (smem > 48 * 1024 && smem > raised[device & 7]) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    raised[device & 7] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, a.KVH * qchunks, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int KIND, bool PAGED>
cudaError_t launch_kind(const Args& a, int B, int qchunks, size_t smem,
                        int device, cudaStream_t s) {
  switch (warp_variant(a.qrows, a.hd)) {
    case 2:
      return launch_variant<KIND, PAGED, 2>(a, B, qchunks, smem, device, s);
    case 4:
      return launch_variant<KIND, PAGED, 4>(a, B, qchunks, smem, device, s);
    case 8:
      return launch_variant<KIND, PAGED, 8>(a, B, qchunks, smem, device, s);
    default:
      return launch_variant<KIND, PAGED, 0>(a, B, qchunks, smem, device, s);
  }
}

// Checks the plan's geometry against the kernel's constraints (a plan that
// disagrees is refused, never adjusted) and launches.
template <bool PAGED>
int launch_layout(Args a, int B, int row_elems, int kind, int threads,
                  int smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int elem = kind == kBF16 ? 2 : kind == kInt8 ? 1 : 4;
  const int per = kind == kWords && a.bits > 0 ? 32 / a.bits : 1;
  const int cover = a.splits * a.split_rows;
  if (a.KVH < 1 || a.H % a.KVH != 0 || kind < kF32 || kind > kWords ||
      (kind == kWords && a.bits != 4 && a.bits != 2) || a.hd < 1 ||
      a.hd > 256 || row_elems * per < a.hd || a.qtype < kQF32 ||
      a.qtype > kQF16 || threads != kThreads || a.qrows < 1 ||
      a.qrows > kMaxQRows || a.tile_rows < 4 || a.tile_rows > kMaxTile ||
      a.tile_rows % 4 != 0 ||
      (warp_variant(a.qrows, a.hd) && !warp_tile_ok(a.tile_rows)) ||
      a.splits < 1 || a.splits > kMaxSplits || a.split_rows < 1 ||
      a.split_rows % a.tile_rows != 0 ||
      (PAGED && a.split_rows % a.page_size != 0) || cover < a.S ||
      cover - a.split_rows >= (a.S > 0 ? a.S : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  a.G = a.H / a.KVH;
  a.row_bytes = row_elems * elem;
  a.rstride = static_cast<int>(align16(a.row_bytes));
  // paged: the split's table entries, then one cell per row
  a.table_len = PAGED ? a.split_rows / a.page_size + a.split_rows : 0;
  const size_t need =
      smem_layout(a.qrows, a.tile_rows, a.hd, a.rstride, a.table_len,
                  a.split_rows).total;
  if (static_cast<size_t>(smem) != need || need > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nq = a.C * a.G;
  const int qchunks = (nq + a.qrows - 1) / a.qrows;
  if (B == 0 || nq == 0) return static_cast<int>(cudaSuccess);
  if (B > 65535 || static_cast<long long>(a.KVH) * qchunks > 65535 ||
      static_cast<long long>(B) * a.C * a.H * a.hd > INT32_MAX ||
      (PAGED && static_cast<long long>(a.P) * a.page_size * a.KVH >
                    UINT32_MAX))
    return static_cast<int>(cudaErrorInvalidValue);
  // the widest async copy that the row size and both bases allow
  int cb = 16;
  while (cb && (a.row_bytes % cb ||
                reinterpret_cast<uintptr_t>(a.k) % cb ||
                reinterpret_cast<uintptr_t>(a.v) % cb))
    cb = cb == 4 ? 0 : cb / 2;
  a.copy_bytes = cb;
  a.qscale = static_cast<float>(std::pow(static_cast<double>(a.hd), -0.5));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kF32:
      err = launch_kind<kF32, PAGED>(a, B, qchunks, need, device, s);
      break;
    case kBF16:
      err = launch_kind<kBF16, PAGED>(a, B, qchunks, need, device, s);
      break;
    case kInt8:
      err = launch_kind<kInt8, PAGED>(a, B, qchunks, need, device, s);
      break;
    default:
      err = a.bits == 4
                ? launch_kind<kW4, PAGED>(a, B, qchunks, need, device, s)
                : launch_kind<kW2, PAGED>(a, B, qchunks, need, device, s);
      break;
  }
  return static_cast<int>(err);
}

Args make_args(const void* q, const void* k, const void* v, const void* ks,
               const void* vs, const void* valid_len, const void* qpos,
               const void* bt, void* out, int C, int H, int KVH, int hd,
               int bits, int qtype, int qrows, int split_rows, int splits,
               int tile_rows) {
  Args a{};
  a.q = q;
  a.k = static_cast<const unsigned char*>(k);
  a.v = static_cast<const unsigned char*>(v);
  a.ks = static_cast<const __nv_bfloat16*>(ks);
  a.vs = static_cast<const __nv_bfloat16*>(vs);
  a.valid_len = static_cast<const int32_t*>(valid_len);
  a.qpos = static_cast<const int32_t*>(qpos);
  a.bt = static_cast<const int32_t*>(bt);
  a.out = out;
  a.C = C;
  a.H = H;
  a.KVH = KVH;
  a.hd = hd;
  a.bits = bits;
  a.qtype = qtype;
  a.qrows = qrows;
  a.split_rows = split_rows;
  a.splits = splits;
  a.tile_rows = tile_rows;
  a.page_size = 1;
  a.P = 1;
  return a;
}

}  // namespace

// kind: 0 f32 cache, 1 bf16 cache, 2 int8 + bf16 scales, 3 int32 words of
// `bits`-wide fields + bf16 scales.  row_elems is the cache's last dim (hd,
// or hd words).  ks / vs may be null for kinds 0 and 1.  qtype: 0 f32,
// 1 bf16, 2 f16 (q and out).  The geometry (qrows query rows per block,
// split_rows, splits, tile_rows, threads, smem bytes) comes from
// kernels/plan.py:plan_attention_decode.
REPRO_EXPORT int attention_decode_launch(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* valid_len, const void* qpos, void* out,
    int B, int C, int H, int KVH, int S, int hd, int row_elems, int kind,
    int bits, int qtype, int qrows, int split_rows, int splits,
    int tile_rows, int threads, int smem, int device, void* stream) {
  Args a = make_args(q, k, v, ks, vs, valid_len, qpos, nullptr, out, C, H,
                     KVH, hd, bits, qtype, qrows, split_rows, splits,
                     tile_rows);
  a.S = S;
  return launch_layout<false>(a, B, row_elems, kind, threads, smem, device,
                              stream);
}

// K4: as attention_decode_launch, over a pool [P, page_size, KVH, ...] read
// through the block table bt [B, NP] int32 (logical length NP * page_size).
REPRO_EXPORT int attention_decode_paged_launch(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* valid_len, const void* qpos, const void* bt,
    void* out, int B, int C, int H, int KVH, int NP, int page_size, int P,
    int hd, int row_elems, int kind, int bits, int qtype, int qrows,
    int split_rows, int splits, int tile_rows, int threads, int smem,
    int device, void* stream) {
  if (page_size < 1 || P < 1 || NP < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(q, k, v, ks, vs, valid_len, qpos, bt, out, C, H, KVH,
                     hd, bits, qtype, qrows, split_rows, splits, tile_rows);
  a.S = NP * page_size;
  a.NP = NP;
  a.page_size = page_size;
  a.P = P;
  return launch_layout<true>(a, B, row_elems, kind, threads, smem, device,
                             stream);
}
