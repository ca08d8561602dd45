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
//   * two paths, by the query rows a block serves:
//     - warp path, up to 4 query rows (decode, small GQA groups), on the
//       CUDA cores in f32: each warp owns a slice of the tile's rows and
//       keeps its own online-softmax carry for every query row in
//       registers, so a tile costs one block barrier; the lanes unpack K
//       and V values as they read them from the staged rows.
//     - tile path, more than 4 (prefill chunks, verify windows, GQA
//       groups past 4, the encoder), on the bf16 tensor cores
//       (mma.sync m16n8k16, f32 accumulate): the rows are padded to m16
//       blocks, and the 8 warps split as (m-block x a slice of the tile's
//       key rows x a slice of the dims).  Each warp keeps its rows' m, l
//       and accumulator in the MMA's registers; scores, mask, softmax
//       update and P.V run there, 16 keys a step, with no block barrier:
//       a tile costs one (the buffer swap).  The B fragments come
//       straight from the staged raw rows (ldmatrix, .trans for bf16 V;
//       sub-byte fields, int8 and bf16 values are exact in bf16), and the
//       scores' P fragments are the P.V's A fragments.  Precision is the
//       f32 path's: q goes in as the bf16 terms that hold it exactly (one
//       for bf16 q, two for f16, three for f32: hi + mid + lo, each the
//       rounding of what the terms before it leave) and hd^-0.5 scales the
//       f32 dot; p x sv (f32) goes in as three terms.  So every product is
//       exact and the sums are f32; an f32 cache splits K and V the same
//       way (six of the nine term products: the three dropped sit below an
//       f32 ulp).  The affine parts stay in f32: sk * (hd^-0.5 dot - zp *
//       sum(q hd^-0.5)) and (p * sv) . u - zp * sum(p * sv).  At the
//       split's end the warps of one m-block merge their carries in
//       key-slice order in shared memory (the staging buffers, no longer
//       needed).
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
// (ATTN_*) and the same shared-memory layouts (attention_smem_bytes).
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplits = 8;   // the portable cluster size
constexpr int kMaxQRows = 64;
constexpr int kMaxTile = 128;
constexpr int kSmemMax = 232448;
constexpr int kMinBlocks = 3;   // warp-path blocks per SM the registers allow
constexpr int kTileMinBlocks = 2;  // tile-path blocks per SM
constexpr int kMmaM = 16;       // tile path: query rows an MMA block
constexpr int kQTerms = 3;      // tile path: bf16 terms of q
constexpr int kQGroups = 2;     // tile path: q's 8-dim groups staged at once
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
  int qvec;  // tile path: q rows load 8 elements (16 or 32 bytes) at once
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

// Byte offsets of a warp-path block's shared-memory regions; query rows
// are padded to a multiple of 4.  The products run from registers; the
// block needs each warp's carry, and every split's at rank 0.
struct Smem {
  size_t q, acc, raw, row, f, tbl, wml, wacc, pm, total;
};

__host__ __device__ inline Smem smem_layout(int qrows, int tile, int hd,
                                            int rstride, int table_len,
                                            int split_rows) {
  const size_t ld = row_stride(hd), hdp = padded_dims(hd);
  const size_t q4 = (qrows + 3) & ~3;
  const size_t nbuf = split_rows > tile ? 2 : 1;  // one tile: no 2nd buffer
  Smem s;
  size_t o = 0;
  s.q = o;    o += align16(4 * q4 * ld);         // q * hd^-0.5
  s.acc = o;  o += align16(4 * q4 * hdp);        // the block's carry: acc
  s.raw = o;  o += align16(2 * nbuf * tile * rstride);  // buffers x (K, V)
  s.row = o;  o += align16(4 * 7 * q4);  // m, l, corr, zsum, qsum, qpos, q0
  s.f = o;    o += align16(4 * (kMaxSplits + 1) * q4);  // merge weights, l
  s.tbl = o;  o += align16(4 * static_cast<size_t>(table_len));
  s.wml = o;  o += align16(4 * 2 * kWarps * q4);        // warps' m, l
  s.wacc = o; o += align16(4 * kWarps * q4 * hdp);      // warps' acc
  s.pm = o;   o += align16(4 * kMaxSplits * q4 * (hdp + 2));  // splits'
  s.total = o;                                   // carries, at rank 0
  return s;
}

// The tile path: tiles of 16 .. 128 rows (whole k16 steps of P.V, a power
// of two of them), and its 8 warps as wm m-block groups (one m16 block of
// query rows each; three blocks take four groups) x wk slices of a tile's
// key rows (16 at least) x wd slices of the dims, with ntw n8 dim tiles a
// warp's accumulator: at most 8 (32 registers a lane), or 16 where hd is
// past 128 and each of the 8 warps serves its own m-block and key slice.
__host__ __device__ inline bool tile_tile_ok(int tile) {
  return tile == 16 || tile == 32 || tile == 64 || tile == 128;
}

struct TileWarps {
  int wm, wk, wd, ntw;
};

__host__ __device__ inline TileWarps tile_warps(int qrows, int tile,
                                                int hd) {
  const int mb = (qrows + kMmaM - 1) / kMmaM;
  const int nt = 2 * ((hd + 15) / 16);  // n8 tiles of the padded dims
  TileWarps w;
  w.wm = mb == 3 ? 4 : mb;
  int wd_min = 1;
  while (wd_min * 8 < nt && wd_min * w.wm < kWarps) wd_min *= 2;
  const int wk_max = kWarps / w.wm / wd_min;
  w.wk = wk_max < tile / 16 ? wk_max : tile / 16;
  w.wd = kWarps / (w.wm * w.wk);
  w.ntw = (nt + w.wd - 1) / w.wd;
  return w;
}

// A tile-path staged row's stride: an odd multiple of 16 bytes, so the 8
// rows of an ldmatrix (or a fragment's 8 rows of 32-bit loads) hit 32
// distinct banks.
__host__ __device__ inline int tile_rstride(int row_bytes) {
  return static_cast<int>(align16(row_bytes) | 16);
}

// Byte offsets of a tile-path block's shared-memory regions; query rows
// padded to m16 blocks (q16), dims to 16 (hdp).  One region holds the
// staging buffers during the loop and the warps' accumulators after it
// (the first of them the block's carry, which the cluster merge reads).
struct TileSmem {
  size_t q, qp, u, scl, row, f, wml, tbl, total;
};

__host__ __device__ inline TileSmem tile_layout(int qrows, int tile, int hd,
                                                int rstride, int table_len,
                                                int split_rows) {
  const size_t q16 = (qrows + kMmaM - 1) / kMmaM * kMmaM;
  const size_t hdp = (hd + 15) & ~15;
  const size_t wk = tile_warps(qrows, tile, hd).wk;
  const size_t nbuf = split_rows > tile ? 2 : 1;  // one tile: no 2nd buffer
  const size_t staging = nbuf * 2 * tile * rstride;  // buffers x (K, V)
  const size_t carries = 4 * wk * q16 * hdp;         // [wk][q16][hdp] f32
  TileSmem s;
  size_t o = 0;
  s.q = o;   o += align16(2 * kQTerms * q16 * (hdp + 8));  // bf16 planes
  s.qp = o;  o += align16(4 * q16 * (hdp / 8));  // sums of 8 dims of q
  s.u = o;   o += align16(staging > carries ? staging : carries);
  s.scl = o; o += align16(4 * 2 * 2 * tile);  // buffers x (k, v) scales
  s.row = o; o += align16(4 * 4 * q16);       // m, l, qpos, q0
  s.f = o;   o += align16(4 * (kMaxSplits + 1) * q16);  // merge weights, l
  s.wml = o; o += align16(4 * 2 * wk * q16);  // the warps' m, l
  s.tbl = o; o += align16(4 * static_cast<size_t>(table_len));
  s.total = o;
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

// The warp path (up to kWarpQ query rows a block); DPL: dims a lane.
template <int KIND, bool PAGED, int DPL>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
attention_decode_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = a.hd, T = a.tile_rows, Q = a.qrows;
  const int hdp = padded_dims(hd), ld = row_stride(hd), Q4 = (Q + 3) & ~3;
  const Smem L = smem_layout(Q, T, hd, a.rstride, a.table_len, a.split_rows);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  unsigned char* raw = smem + L.raw;
  float* m_s = reinterpret_cast<float*>(smem + L.row);
  float* l_s = m_s + Q4;
  float* qsum_s = m_s + 4 * Q4;
  int* qp_s = reinterpret_cast<int*>(m_s + 5 * Q4);
  int* qb_s = qp_s + Q4;  // where query row i starts in q and out
  int* tbl = reinterpret_cast<int*>(smem + L.tbl);

  cg::cluster_group cluster = cg::this_cluster();
  // announce that this block runs, so that other blocks may write into
  // its shared memory once they have waited for the cluster
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int sp = blockIdx.x;  // the split, and the block's cluster rank
  const int kvh = blockIdx.y % a.KVH;
  const int r0 = (blockIdx.y / a.KVH) * Q;  // first query row of the chunk
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nq = min(Q, a.C * a.G - r0);

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
    const int wr = T / kWarps;  // rows a warp
    const int srow = lane < wr ? warp * wr + lane : -1;
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
    {
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
}

// ---------------------------------------------------------------------------
// The tile path: bf16 tensor-core fragments (mma.sync m16n8k16, f32
// accumulate).  g = lane / 4 and t = lane % 4 name a lane's place in a
// fragment: A (16 x 16, rows x k) a0 = (g, 2t..2t+1), a1 = (g + 8, 2t..),
// a2 = (g, 2t + 8..), a3 = (g + 8, 2t + 8..); B (16 x 8, k x n) b0 = (2t..
// 2t+1, g), b1 = (2t + 8.., g); C (16 x 8) c0, c1 = (g, 2t..2t+1), c2, c3 =
// (g + 8, 2t..).
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x = h + m + l exactly: each term the bf16 rounding of what the terms
// before it leave (an f32's 24 bits take three).
__device__ __forceinline__ void split3(float x, float& h, float& m,
                                       float& l) {
  h = __bfloat162float(__float2bfloat16_rn(x));
  const float r = x - h;
  m = __bfloat162float(__float2bfloat16_rn(r));
  l = r - m;
}

// The three terms of (lo, hi) as bf16x2 words, largest first.
__device__ __forceinline__ void split3x2(float lo, float hi,
                                         uint32_t (&w)[kQTerms]) {
  float h0, m0, l0, h1, m1, l1;
  split3(lo, h0, m0, l0);
  split3(hi, h1, m1, l1);
  w[0] = bf16x2(h0, h1);
  w[1] = bf16x2(m0, m1);
  w[2] = bf16x2(l0, l1);
}

// Two small integers (0 .. 127) as bf16x2, exactly: 0x4300 | v is the bf16
// 128 + v, less 128.
__device__ __forceinline__ uint32_t small2(uint32_t lo, uint32_t hi) {
  const uint32_t w = lo | (hi << 16) | 0x43004300u;
  const __nv_bfloat162 v = __hsub2(
      *reinterpret_cast<const __nv_bfloat162*>(&w),
      __float2bfloat162_rn(128.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t s8x2(uint32_t lo, uint32_t hi) {
  return bf16x2(static_cast<float>(static_cast<int8_t>(lo)),
                static_cast<float>(static_cast<int8_t>(hi)));
}

// Keep the low / high bf16 of w where lo / hi hold, else +0.
__device__ __forceinline__ uint32_t keep2(uint32_t w, bool lo, bool hi) {
  return w & ((lo ? 0x0000ffffu : 0u) | (hi ? 0xffff0000u : 0u));
}

// The cache's terms in bf16: three for the f32 cache, else one (exact).
template <int KIND>
struct KTerms {
  static constexpr int n = KIND == kF32 ? 3 : 1;
};

// B fragments of the scores (K as k16 x n8 "col") from the staged K row
// `kr` (key g of the n8 tile) over dims d0 .. d0 + 15: b[term][0] = dims
// d0 + 2t, +1, b[term][1] = dims d0 + 8 + 2t, +1; float dims past hd read
// as 0 (the row's padding is never written).  bf16 rows go by ldmatrix.
template <int KIND>
__device__ __forceinline__ void k_frag(const unsigned char* kr, int d0,
                                       int t, int hd,
                                       uint32_t (&b)[KTerms<KIND>::n][2]) {
  if constexpr (KIND == kF32) {
    float2 x[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = d0 + 8 * h + 2 * t;
      x[h] = *reinterpret_cast<const float2*>(kr + 4 * d);
      if (d0 + 16 > hd) {
        x[h].x = d < hd ? x[h].x : 0.f;
        x[h].y = d + 1 < hd ? x[h].y : 0.f;
      }
      uint32_t w[kQTerms];
      split3x2(x[h].x, x[h].y, w);
#pragma unroll
      for (int k = 0; k < kQTerms; ++k) b[k][h] = w[k];
    }
  } else if constexpr (KIND == kInt8) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t x =
          *reinterpret_cast<const uint16_t*>(kr + d0 + 8 * h + 2 * t);
      b[0][h] = s8x2(x, x >> 8);
    }
  } else if constexpr (KIND == kW4) {
    // fields d0 + 2t, +1: byte t of word d0 / 8; 8 dims on: the next word
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t x = kr[4 * (d0 / 8 + h) + t];
      b[0][h] = small2(x & 15u, x >> 4);
    }
  } else if constexpr (KIND == kW2) {
    // fields 2t, 2t + 1 and 2t + 8, 2t + 9 of word d0 / 16
    const uint32_t w = *reinterpret_cast<const uint32_t*>(kr + d0 / 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t x = w >> (16 * h + 4 * t);
      b[0][h] = small2(x & 3u, (x >> 2) & 3u);
    }
  }
}

// B fragments of P.V (V as k16 x n8 "col") at dim n (the lane's g of the
// n8 tile) over keys k0 .. k0 + 15 of the staged V tile `rv`: b[term][0] =
// keys k0 + 2t, +1, b[term][1] = keys k0 + 8 + 2t, +1; f32 keys at or past
// n_rows read as 0 (their bytes are stale or never written).  bf16 tiles
// go by ldmatrix.trans.
template <int KIND>
__device__ __forceinline__ void v_frag(const unsigned char* rv, int rstride,
                                       int k0, int n, int t, int n_rows,
                                       uint32_t (&b)[KTerms<KIND>::n][2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + 8 * h + 2 * t;
    const unsigned char* r0 = rv + static_cast<size_t>(key) * rstride;
    const unsigned char* r1 = r0 + rstride;
    if constexpr (KIND == kF32) {
      float x0 = reinterpret_cast<const float*>(r0)[n];
      float x1 = reinterpret_cast<const float*>(r1)[n];
      if (k0 + 16 > n_rows) {
        x0 = key < n_rows ? x0 : 0.f;
        x1 = key + 1 < n_rows ? x1 : 0.f;
      }
      uint32_t w[kQTerms];
      split3x2(x0, x1, w);
#pragma unroll
      for (int k = 0; k < kQTerms; ++k) b[k][h] = w[k];
    } else if constexpr (KIND == kInt8) {
      b[0][h] = s8x2(r0[n], r1[n]);
    } else if constexpr (KIND == kW4) {
      const int o = 4 * (n / 8), sh = 4 * (n % 8);
      b[0][h] = small2((*reinterpret_cast<const uint32_t*>(r0 + o) >> sh) &
                           15u,
                       (*reinterpret_cast<const uint32_t*>(r1 + o) >> sh) &
                           15u);
    } else if constexpr (KIND == kW2) {
      const int o = 4 * (n / 16), sh = 2 * (n % 16);
      b[0][h] = small2((*reinterpret_cast<const uint32_t*>(r0 + o) >> sh) &
                           3u,
                       (*reinterpret_cast<const uint32_t*>(r1 + o) >> sh) &
                           3u);
    }
  }
}

// kQGroups groups of 8 dims of the chunk's q rows -- groups e0, e0 +
// kThreads, ... of the [rows][hdp / 8] grid -- into x, in f32; zero past
// the chunk's rows, hd or the grid.  Rows of hd a multiple of 8 on a
// 16-byte base load 16 or 32 bytes at once.
__device__ __forceinline__ void load_q_groups(const Args& a, int b, int kvh,
                                              int r0, int nq, int g8,
                                              int ngroups, int e0,
                                              float (&x)[kQGroups][8]) {
#pragma unroll
  for (int u = 0; u < kQGroups; ++u) {
    const int e = e0 + u * kThreads;
    const int i = e / g8, d0 = 8 * (e - i * g8);
#pragma unroll
    for (int j = 0; j < 8; ++j) x[u][j] = 0.f;
    if (e >= ngroups || i >= nq || d0 >= a.hd) continue;
    const size_t at = out_index(a, b, kvh, r0, i, d0);
    if (a.qvec && a.qtype == kQF32) {
      const float4* p =
          reinterpret_cast<const float4*>(static_cast<const float*>(a.q) + at);
      const float4 lo = p[0], hi = p[1];
      x[u][0] = lo.x; x[u][1] = lo.y; x[u][2] = lo.z; x[u][3] = lo.w;
      x[u][4] = hi.x; x[u][5] = hi.y; x[u][6] = hi.z; x[u][7] = hi.w;
    } else if (a.qvec) {
      const uint4 w = *reinterpret_cast<const uint4*>(
          static_cast<const uint16_t*>(a.q) + at);
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint16_t h = static_cast<uint16_t>(ws[j / 2] >> (16 * (j & 1)));
        x[u][j] = a.qtype == kQBF16 ? __uint_as_float(uint32_t(h) << 16)
                                    : __half2float(__ushort_as_half(h));
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (d0 + j < a.hd) x[u][j] = load_q(a.q, a.qtype, at + j);
    }
  }
}

// Their bf16 terms into the first `nterms` planes of q_s ([term][rows][qld])
// and the f32 sum of q x hd^-0.5 over each group into qpart (Σq, in a
// fixed order, for the sub-byte zero point).
__device__ __forceinline__ void store_q_groups(const Args& a,
                                               __nv_bfloat16* q_s,
                                               float* qpart, int qld,
                                               size_t plane, int nterms,
                                               int g8, int ngroups, int e0,
                                               const float (&x)[kQGroups][8]) {
#pragma unroll
  for (int u = 0; u < kQGroups; ++u) {
    const int e = e0 + u * kThreads;
    if (e >= ngroups) break;
    const int i = e / g8, d0 = 8 * (e - i * g8);
    uint32_t w[kQTerms][4];
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      uint32_t t3[kQTerms];
      split3x2(x[u][j], x[u][j + 1], t3);
#pragma unroll
      for (int k = 0; k < kQTerms; ++k) w[k][j / 2] = t3[k];
      part += x[u][j] * a.qscale;
      part += x[u][j + 1] * a.qscale;
    }
    __nv_bfloat16* dst = q_s + static_cast<size_t>(i) * qld + d0;
#pragma unroll
    for (int k = 0; k < kQTerms; ++k)
      if (k < nterms)
        *reinterpret_cast<uint4*>(dst + k * plane) =
            make_uint4(w[k][0], w[k][1], w[k][2], w[k][3]);
    qpart[e] = part;
  }
}

// The tile path (more than kWarpQ query rows a block); NTW: the n8 dim
// tiles a warp's accumulator holds (tile_warps).
template <int KIND, bool PAGED, int NTW>
__global__ void __launch_bounds__(kThreads, kTileMinBlocks)
attention_tile_kernel(const Args a) {
  constexpr int KT = KTerms<KIND>::n;
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = a.hd, T = a.tile_rows, Q = a.qrows, rs = a.rstride;
  const int Q16 = (Q + kMmaM - 1) / kMmaM * kMmaM;
  const int hdp = (hd + 15) & ~15, qld = hdp + 8;
  const TileWarps W = tile_warps(Q, T, hd);
  const TileSmem L =
      tile_layout(Q, T, hd, rs, a.table_len, a.split_rows);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + L.q);
  float* qpart = reinterpret_cast<float*>(smem + L.qp);  // [Q16][hdp / 8]
  unsigned char* raw = smem + L.u;
  float* wacc = reinterpret_cast<float*>(smem + L.u);  // after the tiles
  float* scl = reinterpret_cast<float*>(smem + L.scl);  // [buf][k | v][T]
  float* m_s = reinterpret_cast<float*>(smem + L.row);
  float* l_s = m_s + Q16;
  int* qp_s = reinterpret_cast<int*>(m_s + 2 * Q16);
  int* qb_s = qp_s + Q16;  // where query row i starts in q and out
  float* f_s = reinterpret_cast<float*>(smem + L.f);  // [splits][Q16], l
  float* lt_s = f_s + kMaxSplits * Q16;
  float* wml = reinterpret_cast<float*>(smem + L.wml);  // [wk][m | l][Q16]
  int* tbl = reinterpret_cast<int*>(smem + L.tbl);

  cg::cluster_group cluster = cg::this_cluster();
  const int sp = blockIdx.x;  // the split, and the block's cluster rank
  const int kvh = blockIdx.y % a.KVH;
  const int r0 = (blockIdx.y / a.KVH) * Q;  // first query row of the chunk
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nq = min(Q, a.C * a.G - r0);
  const float zp =
      KIND >= kW4 ? static_cast<float>(1 << (Fields<KIND>::bits - 1)) : 0.f;

  // q as bf16 terms: one for bf16 q, two for f16 (11 bits), three for
  // f32, so the products are exact; hd^-0.5 scales the f32 dot
  const int nterms = a.qtype == kQBF16 ? 1 : a.qtype == kQF16 ? 2 : 3;
  const size_t plane = static_cast<size_t>(Q16) * qld;
  const int g8 = hdp / 8, ngroups = Q16 * g8;

  // the live end, as the warp path (rows past the chunk see nothing),
  // loaded with the split's block-table entries (paged: its rows' cells
  // follow).  Split 0 is live whenever any row sees a key, so its first
  // tile is staged before the live end is known: its rows are in bounds
  // whatever the end, and those past it are masked.
  const int vlen = a.valid_len[b];
  const int s0 = sp * a.split_rows;
  int* cells = tbl + a.split_rows / a.page_size;
  if (PAGED) {
    for (int j = tid; j < a.split_rows / a.page_size; j += kThreads) {
      const int pi = s0 / a.page_size + j;
      const int pg =
          pi < a.NP ? a.bt[static_cast<size_t>(b) * a.NP + pi] : 0;
      tbl[j] = min(max(pg, 0), a.P - 1);
    }
  }
  if (tid < Q16) {
    qp_s[tid] = tid < nq ? a.qpos[b * a.C + (r0 + tid) / a.G] : -1;
    qb_s[tid] =
        tid < nq ? static_cast<int>(out_index(a, b, kvh, r0, tid, 0)) : 0;
  }
  Scales sc = {__float2bfloat16(0.f), __float2bfloat16(0.f)};
  if (!PAGED && sp == 0) {
    sc = stage<KIND, PAGED>(a, raw, 0, b, kvh, 0, min(T, a.S), 0, cells, tid);
    cp_async_commit();
  }
  __syncthreads();
  if (PAGED) {
    for (int j = tid; j < a.split_rows; j += kThreads) {
      const int pj = j / a.page_size;
      cells[j] = static_cast<int>(
          (static_cast<unsigned>(tbl[pj]) * a.page_size + j -
           pj * a.page_size) * a.KVH + kvh);
    }
    __syncthreads();  // the cells before the first copy
    if (sp == 0) {
      sc = stage<KIND, PAGED>(a, raw, 0, b, kvh, 0, min(T, a.S), 0, cells,
                              tid);
      cp_async_commit();
    }
  }
  int qmax = -1;
  for (int i = 0; i < nq; ++i) qmax = max(qmax, qp_s[i]);
  const int end = max(0, min(min(vlen, a.S), qmax + 1));
  const int n_live = (end + a.split_rows - 1) / a.split_rows;
  if (n_live == 0) {  // nothing visible to any row: exact zeros
    cp_async_wait<0>();
    for (int o = sp * kThreads + tid; o < nq * hd; o += a.splits * kThreads)
      store_out(a.out, a.qtype, qb_s[o / hd] + o % hd, 0.f);
    return;
  }
  // a split past the live end leaves at once (as the warp path)
  if (sp >= n_live) return;

  const int s1 = min(s0 + a.split_rows, end);
  const int ntiles = (s1 - s0 + T - 1) / T;
  if (sp != 0) {
    sc = stage<KIND, PAGED>(a, raw, 0, b, kvh, s0, min(T, s1 - s0), s0,
                            cells, tid);
    cp_async_commit();
  }
  // q's groups of 8 dims, kQGroups a thread at a time, while tile 0's
  // copies are in flight
  for (int e0 = tid; e0 < ngroups; e0 += kQGroups * kThreads) {
    float xq[kQGroups][8];
    load_q_groups(a, b, kvh, r0, nq, g8, ngroups, e0, xq);
    store_q_groups(a, q_s, qpart, qld, plane, nterms, g8, ngroups, e0, xq);
  }
  if (KIND >= kInt8 && tid < T) {  // tile 0's scales
    scl[tid] = __bfloat162float(sc.k);
    scl[T + tid] = __bfloat162float(sc.v);
  }
  __syncthreads();  // q's terms and partial sums

  // this warp: m-block mb, key slice ks (KS rows of each tile), dim slice
  // ds (n8 tiles j0 .. j0 + nj - 1)
  const int per_mb = W.wk * W.wd;
  const int mb = warp / per_mb, ks = warp % per_mb / W.wd,
            ds = warp % W.wd;
  const int row0 = mb * kMmaM;
  const bool active = row0 < nq;  // rows of its own to serve
  const int KS = T / W.wk;
  const int j0 = ds * W.ntw;
  const int nj = max(0, min(W.ntw, hdp / 8 - j0));
  float acc[NTW][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // rows g and g + 8 of the m-block: m, and this lane's shares of l and
  // of z = sum(p * sv) (summed over the quad at the end)
  float mrow[2] = {kNegInf, kNegInf}, lrow[2] = {0.f, 0.f},
        zrow[2] = {0.f, 0.f}, qsr[2] = {0.f, 0.f};
  int qpr[2] = {-1, -1};
  if (active) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      qpr[r] = qp_s[row0 + g + 8 * r];
      if (KIND >= kW4) {  // Σq: the quad's lanes take every 4th group
        const float* pr = qpart + (row0 + g + 8 * r) * g8;
        for (int gi = t; gi < g8; gi += 4) qsr[r] += pr[gi];
        qsr[r] += __shfl_xor_sync(0xffffffffu, qsr[r], 1);
        qsr[r] += __shfl_xor_sync(0xffffffffu, qsr[r], 2);
      }
    }
  }
  // this lane's ldmatrix rows: q (A: rows by lane % 16, dims + 8 for lanes
  // 16..31), bf16 K (keys + 8 for lanes 16..31, dims + 8 for lanes 8..15,
  // 24..31), bf16 V (keys + 8 for lanes 8..15)
  const __nv_bfloat16* qa =
      q_s + static_cast<size_t>(row0 + (lane & 15)) * qld + 8 * (lane >> 4);
  const int k_row = (lane & 7) + 8 * (lane >> 4), k_col = 8 * ((lane >> 3) & 1);
  const int v_row = lane & 15;

  for (int ti = 0; ti < ntiles; ++ti) {
    const int t0 = s0 + ti * T;
    const int n = min(T, s1 - t0);
    if (ti > 0 && KIND >= kInt8 && tid < T) {  // this tile's scales
      scl[(ti & 1) * 2 * T + tid] = __bfloat162float(sc.k);
      scl[(ti & 1) * 2 * T + T + tid] = __bfloat162float(sc.v);
    }
    cp_async_wait<0>();
    __syncthreads();  // tile ti landed; every warp is done with tile ti - 1
    if (ti + 1 < ntiles) {
      sc = stage<KIND, PAGED>(a, raw, (ti + 1) & 1, b, kvh, t0 + T,
                              min(T, s1 - t0 - T), s0, cells, tid);
      cp_async_commit();
    }
    if (!active) continue;
    const unsigned char* rk =
        raw + static_cast<size_t>((ti & 1) * 2) * T * rs;
    const unsigned char* rv = rk + static_cast<size_t>(T) * rs;
    const float* skt = scl + (ti & 1) * 2 * T;
    const float* svt = skt + T;
    for (int k0 = ks * KS; k0 < ks * KS + KS && k0 < n; k0 += 16) {
      // scores of keys k0 .. k0 + 15 (two n8 tiles)
      float s[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      for (int d0 = 0; d0 < hdp; d0 += 16) {
        uint32_t bk[2][KT][2];
        if constexpr (KIND == kBF16) {
          uint32_t r[4];
          ldsm_x4(r, rk + static_cast<size_t>(k0 + k_row) * rs +
                         2 * (d0 + k_col));
          if (d0 + 16 > hd) {
            const int d = d0 + 2 * t;
            r[0] = keep2(r[0], d < hd, d + 1 < hd);
            r[1] = keep2(r[1], d + 8 < hd, d + 9 < hd);
            r[2] = keep2(r[2], d < hd, d + 1 < hd);
            r[3] = keep2(r[3], d + 8 < hd, d + 9 < hd);
          }
          bk[0][0][0] = r[0];
          bk[0][0][1] = r[1];
          bk[1][0][0] = r[2];
          bk[1][0][1] = r[3];
        } else {
#pragma unroll
          for (int j = 0; j < 2; ++j)
            k_frag<KIND>(rk + static_cast<size_t>(k0 + 8 * j + g) * rs, d0,
                         t, hd, bk[j]);
        }
        // the smaller terms first; term products below an f32 ulp skipped
        for (int qt = nterms - 1; qt >= 0; --qt) {
          uint32_t qf[4];
          ldsm_x4(qf, qa + qt * plane + d0);
#pragma unroll
          for (int kt = KT - 1; kt >= 0; --kt) {
            if (qt + kt >= kQTerms) continue;
            mma_bf16(s[0], qf, bk[0][kt][0], bk[0][kt][1]);
            mma_bf16(s[1], qf, bk[1][kt][0], bk[1][kt][1]);
          }
        }
      }
      // affine parts, mask, the online-softmax update
      bool vis[2][4];
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1), r = e >> 1;
          float x = s[j][e] * a.qscale;
          if (KIND >= kW4) x = skt[key] * (x - zp * qsr[r]);
          else if (KIND == kInt8) x = skt[key] * x;
          vis[j][e] = key < n && t0 + key <= qpr[r];
          s[j][e] = x;
          if (vis[j][e]) mx[r] = fmaxf(mx[r], x);
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float mn = fmaxf(mrow[r], mx[r]);
        corr[r] = expf(mrow[r] - mn);
        mrow[r] = mn;
        lrow[r] *= corr[r];
        zrow[r] *= corr[r];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1), r = e >> 1;
          const float pe = vis[j][e] ? expf(s[j][e] - mrow[r]) : 0.f;
          const float pv = KIND >= kInt8 ? pe * svt[key] : pe;
          lrow[r] += pe;
          zrow[r] += pv;
          s[j][e] = pv;
        }
      // acc * corr, skipped where no row's max moved (corr is then 1.0:
      // the same bits)
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int j = 0; j < NTW; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];
      }
      // P.V: the scores' C fragments are the A fragments of p * sv, as
      // three bf16 terms
      uint32_t pa[kQTerms][4];
      {
        uint32_t w[kQTerms];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          split3x2(s[i >> 1][2 * (i & 1)], s[i >> 1][2 * (i & 1) + 1], w);
#pragma unroll
          for (int k = 0; k < kQTerms; ++k) pa[k][i] = w[k];
        }
      }
#pragma unroll
      for (int jj = 0; jj < NTW; ++jj) {
        if (jj >= nj) break;
        const int n0 = 8 * (j0 + jj);
        uint32_t bv[KT][2];
        if constexpr (KIND == kBF16) {
          uint32_t r[2];
          ldsm_x2_trans(r, rv + static_cast<size_t>(k0 + v_row) * rs +
                               2 * n0);
          if (k0 + 16 > n) {
            const int key = k0 + 2 * t;
            r[0] = keep2(r[0], key < n, key + 1 < n);
            r[1] = keep2(r[1], key + 8 < n, key + 9 < n);
          }
          bv[0][0] = r[0];
          bv[0][1] = r[1];
        } else {
          v_frag<KIND>(rv, rs, k0, n0 + g, t, n, bv);
        }
#pragma unroll
        for (int pt = kQTerms - 1; pt >= 0; --pt)
#pragma unroll
          for (int vt = KT - 1; vt >= 0; --vt) {
            if (pt + vt >= kQTerms) continue;
            mma_bf16(acc[jj], pa[pt], bv[vt][0], bv[vt][1]);
          }
      }
    }
  }

  // the quad's shares of l and z; acc = (p * sv) . u - zp * sum(p * sv)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 1);
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 2);
    zrow[r] += __shfl_xor_sync(0xffffffffu, zrow[r], 1);
    zrow[r] += __shfl_xor_sync(0xffffffffu, zrow[r], 2);
  }
  if (KIND >= kW4) {
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] -= zp * zrow[e >> 1];
  }
  __syncthreads();  // every warp is done with the staging buffers
  if (active) {  // the warp's carry into slot ks: [wk][Q16][hdp]
    if (ds == 0 && t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        wml[2 * ks * Q16 + row0 + g + 8 * r] = mrow[r];
        wml[(2 * ks + 1) * Q16 + row0 + g + 8 * r] = lrow[r];
      }
    }
#pragma unroll
    for (int jj = 0; jj < NTW; ++jj) {
      if (jj >= nj) break;
      float* dst = wacc + (static_cast<size_t>(ks) * Q16 + row0 + g) * hdp +
                   8 * (j0 + jj) + 2 * t;
      *reinterpret_cast<float2*>(dst) = make_float2(acc[jj][0], acc[jj][1]);
      *reinterpret_cast<float2*>(dst + 8 * hdp) =
          make_float2(acc[jj][2], acc[jj][3]);
    }
  }
  __syncthreads();
  // one live split: the key slices merged in order give the rows (the
  // cluster merge of one split would scale them by exp(0) = 1: the same
  // bits), and no other block waits
  if (n_live == 1) {
    for (int o = tid; o < nq * hd; o += kThreads) {
      const int i = o / hd, d = o - i * hd;
      float mx = kNegInf;
      for (int k = 0; k < W.wk; ++k) mx = fmaxf(mx, wml[2 * k * Q16 + i]);
      float x = 0.f, l = 0.f;
      for (int k = 0; k < W.wk; ++k) {
        const float f = expf(wml[2 * k * Q16 + i] - mx);
        x += wacc[(static_cast<size_t>(k) * Q16 + i) * hdp + d] * f;
        l += wml[(2 * k + 1) * Q16 + i] * f;
      }
      store_out(a.out, a.qtype, qb_s[i] + d, l == 0.f ? 0.f : x / l);
    }
    return;
  }
  // else the block's carry: the key slices merged in order, in place into
  // slot 0 (one slice: slot 0 is the carry)
  if (W.wk > 1) {
    for (int o = tid; o < nq * hdp; o += kThreads) {
      const int i = o / hdp, d = o - i * hdp;
      float mx = kNegInf;
      for (int k = 0; k < W.wk; ++k) mx = fmaxf(mx, wml[2 * k * Q16 + i]);
      float x = 0.f, l = 0.f;
      for (int k = 0; k < W.wk; ++k) {
        const float f = expf(wml[2 * k * Q16 + i] - mx);
        x += wacc[(static_cast<size_t>(k) * Q16 + i) * hdp + d] * f;
        l += wml[(2 * k + 1) * Q16 + i] * f;
      }
      wacc[static_cast<size_t>(i) * hdp + d] = x;
      if (d == 0) {
        m_s[i] = mx;
        l_s[i] = l;
      }
    }
  } else if (tid < nq) {
    m_s[tid] = wml[tid];
    l_s[tid] = wml[Q16 + tid];
  }
  const float* acc_s = wacc;

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
      f_s[j * Q16 + tid] = f;
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
      aj[j] = j < n_live ? *cluster.map_shared_rank(
                               acc_s + static_cast<size_t>(i) * hdp + d, j)
                         : 0.f;
    float acc_o = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j)
      if (j < n_live) acc_o += aj[j] * f_s[j * Q16 + i];
    const float lt = lt_s[i];
    store_out(a.out, a.qtype, qb_s[i] + d, lt == 0.f ? 0.f : acc_o / lt);
  }
  cluster.sync();  // no block leaves while another reads its carries
}

// Launches one instantiation on a cluster of `splits` blocks along x,
// raising its dynamic shared-memory limit first where needed (`raised`:
// the limit set so far on each device, for this instantiation).
cudaError_t launch_kern(void (*kern)(Args), size_t* raised, const Args& a,
                        int B, int qchunks, size_t smem, int device,
                        cudaStream_t s) {
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

template <int KIND, bool PAGED, int DPL>
cudaError_t launch_variant(const Args& a, int B, int qchunks, size_t smem,
                           int device, cudaStream_t s) {
  static size_t raised[8] = {0};  // per device, this instantiation
  return launch_kern(attention_decode_kernel<KIND, PAGED, DPL>, raised, a, B,
                     qchunks, smem, device, s);
}

template <int KIND, bool PAGED, int NTW>
cudaError_t launch_tile(const Args& a, int B, int qchunks, size_t smem,
                        int device, cudaStream_t s) {
  static size_t raised[8] = {0};
  return launch_kern(attention_tile_kernel<KIND, PAGED, NTW>, raised, a, B,
                     qchunks, smem, device, s);
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
      return tile_warps(a.qrows, a.tile_rows, a.hd).ntw <= 8
                 ? launch_tile<KIND, PAGED, 8>(a, B, qchunks, smem, device, s)
                 : launch_tile<KIND, PAGED, 16>(a, B, qchunks, smem, device,
                                                s);
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
      !(warp_variant(a.qrows, a.hd) ? warp_tile_ok(a.tile_rows)
                                     : tile_tile_ok(a.tile_rows)) ||
      a.splits < 1 || a.splits > kMaxSplits || a.split_rows < 1 ||
      a.split_rows % a.tile_rows != 0 ||
      (PAGED && a.split_rows % a.page_size != 0) || cover < a.S ||
      cover - a.split_rows >= (a.S > 0 ? a.S : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  a.G = a.H / a.KVH;
  a.row_bytes = row_elems * elem;
  const bool warp = warp_variant(a.qrows, a.hd) != 0;
  a.rstride = warp ? static_cast<int>(align16(a.row_bytes))
                   : tile_rstride(a.row_bytes);
  // paged: the split's table entries, then one cell per row
  a.table_len = PAGED ? a.split_rows / a.page_size + a.split_rows : 0;
  const size_t need =
      warp ? smem_layout(a.qrows, a.tile_rows, a.hd, a.rstride, a.table_len,
                         a.split_rows).total
           : tile_layout(a.qrows, a.tile_rows, a.hd, a.rstride, a.table_len,
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
  a.qvec = a.hd % 8 == 0 && reinterpret_cast<uintptr_t>(a.q) % 16 == 0;
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

// This file is built twice (kernels/build.py, ATTENTION_VARIANTS): with
// ATTN_PAGED=0 it holds K3's entry point and its 25 kernels, with
// ATTN_PAGED=1 K4's, so that the two halves compile in parallel.
#ifndef ATTN_PAGED
#error "build with -DATTN_PAGED=0 (K3) or -DATTN_PAGED=1 (K4)"
#endif
#if ATTN_PAGED == 0
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
#endif

#if ATTN_PAGED == 1

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
#endif
