// The int8 tensor-core tile of the integer matmuls (K7 in int_matmul.cu,
// K2's int16xP2s8 route in ulppack_matmul_mma.cu): cp.async staging, the
// in-register 4x4 byte transposition and byte-plane split (prmt), the
// ldmatrix fragment loads, mma.sync.m16n8k32 with s8 / u8 operands, and
// the K loop of one block that strings them together (mainloop below).
//
// Fragments of mma.sync.aligned.m16n8k32.row.col.s32.{s8,u8}.{s8,u8}.s32
// (lane = 4 * g + t): A (16 x 32, row-major, K-contiguous) is four words,
// a0 = A[g][4t..4t+3], a1 = A[g+8][4t..], a2 = A[g][16+4t..],
// a3 = A[g+8][16+4t..]; B (32 x 8, "col": K-contiguous per column) is two,
// b0 = B[4t..4t+3][g], b1 = B[16+4t..][g]; D is four s32,
// d0 = D[g][2t], d1 = D[g][2t+1], d2 = D[g+8][2t], d3 = D[g+8][2t+1].
// A non-transposing ldmatrix of b16 8 x 8 matrices hands lane 4g + t the
// bytes [4t, 4t+4) of matrix row g: over K-major rows of 16 bytes that is
// exactly these fragments, so one x4 gives A, and one x4 the B fragments of
// two 8-column groups.
//
// The tile computes out^T = W^T a^T for a [M, K] and W [K, N], row-major,
// of 1 or 2 bytes an element (AB, WB).  W is the MMA's A operand: each of
// the 8 warps owns 16 output columns n, a block kBN = 128; the block's BM
// rows of m fill the N slot in groups of 8; K advances 32 bytes an MMA.
// Raw W tiles (kBK rows of k x kBN columns) stream through a cp.async ring
// as deep as shared memory allows (16-byte copies where the row size and
// both bases allow, else 8 or 4, else plain loads; out-of-range chunks are
// zeroed), each 16-byte chunk XOR-swizzled by its row so that the
// transposing reads hit 32 banks.  One pass per tile transposes 4 x 4 byte
// blocks with prmt into K-major plane rows of kBK bytes (padded to
// kPlaneRow and swizzled by chunk: conflict-free stores and ldmatrix
// reads); 2-byte operands are split there into a high and a low byte
// plane (plane 0 = hi, plane 1 = lo), a's in a pass over its staged rows.
// What a block stages of a and how it turns a stage into what the MMAs
// read is the a side's (RawA: a's own int8 / int16 rows; QuantA: float
// activations quantized in that pass, K1 folded into K2).  Likewise what a
// block stages of W and how it turns a stage into planes is the W side's
// (RawW: W's own int8 / int16 rows, transposed as above; DenseW: K2's
// bit-dense store, int32 words of w_bits-wide lattice values expanded into
// the hi / lo planes an int16xP2s8 lane would have split into; LanesW /
// LanesA: K2's lanes of every other layout, whose fields are written to
// those same plane bytes).  Which planes multiply, with which signedness,
// into which accumulator is the caller's (an MMA functor); W is never
// transposed in device memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace mma_s8 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous global -> shared copy of 16, 8 or 4 bytes (both addresses
// aligned to the size).
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const uint32_t s = smem_addr(dst);
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

// Zero `bytes` (16, 8 or 4) of shared memory, aligned to the size.
__device__ __forceinline__ void zero_smem(void* dst, int bytes) {
  if (bytes == 16)
    *static_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  else if (bytes == 8)
    *static_cast<uint2*>(dst) = make_uint2(0u, 0u);
  else
    *static_cast<uint32_t*>(dst) = 0u;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Transpose a 4 x 4 byte block: r[i] holds row i (byte j = column j); on
// return o[j] holds column j (byte i = row i).
__device__ __forceinline__ void transpose4x4(const uint32_t (&r)[4],
                                             uint32_t (&o)[4]) {
  const uint32_t t01l = __byte_perm(r[0], r[1], 0x5140);  // r0.0 r1.0 r0.1 r1.1
  const uint32_t t01h = __byte_perm(r[0], r[1], 0x7362);  // r0.2 r1.2 r0.3 r1.3
  const uint32_t t23l = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t23h = __byte_perm(r[2], r[3], 0x7362);
  o[0] = __byte_perm(t01l, t23l, 0x5410);
  o[1] = __byte_perm(t01l, t23l, 0x7632);
  o[2] = __byte_perm(t01h, t23h, 0x5410);
  o[3] = __byte_perm(t01h, t23h, 0x7632);
}

// Four consecutive int16 values x (little-endian in words w0, w1) as byte
// planes, value i in byte i: lo = x & 0xFF and hi = x >> 8.  Only bytes
// move; the MMA's template flags read a plane as s8 or u8 (K7's hi planes
// are s8, the rest u8).
__device__ __forceinline__ uint32_t plane_lo(uint32_t w0, uint32_t w1) {
  return __byte_perm(w0, w1, 0x6420);
}
__device__ __forceinline__ uint32_t plane_hi(uint32_t w0, uint32_t w1) {
  return __byte_perm(w0, w1, 0x7531);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

#define MMA_S8_ASM(AT, BT)                                                  \
  asm volatile("mma.sync.aligned.m16n8k32.row.col.s32." AT "." BT          \
               ".s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "        \
               "{%0, %1, %2, %3};\n"                                        \
               : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])             \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),       \
                 "r"(b1))

// d += A * B on the int8 tensor cores; A_SIGNED / B_SIGNED pick s8 or u8
// for each operand.  The s32 sums must not leave the int32 range: PTX
// does not promise that they wrap, so callers bound their K runs.
template <bool A_SIGNED, bool B_SIGNED>
__device__ __forceinline__ void mma_m16n8k32(int32_t (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  if constexpr (A_SIGNED && B_SIGNED)
    MMA_S8_ASM("s8", "s8");
  else if constexpr (A_SIGNED)
    MMA_S8_ASM("s8", "u8");
  else if constexpr (B_SIGNED)
    MMA_S8_ASM("u8", "s8");
  else
    MMA_S8_ASM("u8", "u8");
}

#undef MMA_S8_ASM


// ---------------------------------------------------------------------------
// The tile (K7's, and K2's int16xP2s8 route's)
// ---------------------------------------------------------------------------

constexpr int kBN = 128;          // output columns per block (8 warps x 16)
constexpr int kBK = 64;           // K per stage
constexpr int kMaxStages = 8;     // cp.async ring depth at most
constexpr int kMinStages = 3;     // ... and at least (mainloop_w)
constexpr int kSmemMax = 232448;  // shared memory a block may use
constexpr int kThreads = 256;
constexpr int kPlaneRow = kBK + 16;  // bytes of a K-major plane row

// Shared memory: `stages` ring slots of [raw W tile | raw a rows], then
// two plane buffers of [W planes | a planes (unless the MMAs read a's ring
// rows)].  `ab` is the bytes of a staged per K step: 1 or 2 for int8 /
// int16 a, 2 x the element size for float activations (two lattice values
// a lane), 2 LB / NP for lanes of NP fields in LB bytes.  `ap` is the
// planes the MMAs read of a: 1 (int8 a, read from the ring) or 2 (split
// into the plane buffers).  The raw W tile is `wt` bytes (kBK x kBN x WB
// for W's own rows, fewer for the dense store's words or narrow lanes, more
// for int32 lanes) and W has `wp` planes.  The ring is as deep as the
// shared memory allows, up to kMaxStages: stages - 2 of them are in flight
// while a block transposes one and multiplies another.
__host__ __device__ constexpr int ring_a_row(int ab) {
  return kBK * ab + 16;
}
__host__ __device__ constexpr int stage_bytes_w(int bm, int ab, int wt) {
  return wt + bm * ring_a_row(ab);
}
__host__ __device__ constexpr int plane_bytes(int bm, int ap, int wp) {
  return wp * kBN * kPlaneRow + (ap >= 2 ? 2 * bm * kPlaneRow : 0);
}
__host__ __device__ constexpr int stages_for_w(int bm, int ab, int wt,
                                               int wp, int ap) {
  const int fit =
      (kSmemMax - 2 * plane_bytes(bm, ap, wp)) / stage_bytes_w(bm, ab, wt);
  return fit < kMaxStages ? fit : kMaxStages;
}
__host__ __device__ constexpr int smem_bytes_w(int bm, int ab, int wt,
                                               int wp, int ap) {
  return stages_for_w(bm, ab, wt, wp, ap) * stage_bytes_w(bm, ab, wt) +
         2 * plane_bytes(bm, ap, wp);
}
// W's own rows of WB bytes: a kBK x kBN tile, WB planes; a's AB-byte rows,
// AB planes (K7).
__host__ __device__ constexpr int stage_bytes(int bm, int ab, int wb) {
  return stage_bytes_w(bm, ab, kBK * kBN * wb);
}
__host__ __device__ constexpr int stages_for(int bm, int ab, int wb) {
  return stages_for_w(bm, ab, kBK * kBN * wb, wb, ab);
}
__host__ __device__ constexpr int smem_bytes(int bm, int ab, int wb) {
  return smem_bytes_w(bm, ab, kBK * kBN * wb, wb, ab);
}

// The 16-byte chunk position of chunk c of a staged row r.  Raw W rows
// (SW = 1 or 2, W's bytes) are swizzled by k block (r / 4) so that a
// warp's transposing reads (8 column blocks x 4 k blocks) fall in distinct
// banks; a rows (SW = 0) are padded instead.
// Rows of dense words (SW = 16 + RW, rows of 32 chunks) are swizzled by
// row within groups of RW rows, so that a warp reading RW rows x 32 / RW
// consecutive words hits 32 banks (DenseW below).  Rows of int16 lanes of
// four fields (SW = 3; LanesW<2, 4, 4>) are read in pairs of rows: the
// swizzle flips with the pair, as SW = 2's with a group of four.
template <int SW>
__device__ __forceinline__ int chunk_pos(int r, int c) {
  if constexpr (SW == 1) return c ^ (((r >> 2) & 3) << 1);
  if constexpr (SW == 2) return c ^ (((r >> 2) & 1) << 2);
  if constexpr (SW == 3) return c ^ (((r >> 1) & 1) << 2);
  if constexpr (SW > 16) return c ^ ((r % (SW - 16)) * (8 / (SW - 16)));
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

// The a side of the tile: a's rows staged raw, AB bytes an element (int8
// or int16, row-major [M, K]; P carries a, M, K and the copy size cb_a).
// int8 rows are what the MMAs read (the ring row is a plane row); int16
// rows are split into a hi and a lo plane.
template <int AB>
struct RawA {
  static constexpr int kBytes = AB;   // staged bytes a K step
  static constexpr int kPlanes = AB;  // planes the MMAs read
  static constexpr bool kQuant = false;

  // bytes of one of a's rows over K steps
  static __host__ __device__ constexpr long long row_bytes(int K) {
    return static_cast<long long>(K) * AB;
  }

  RawA() = default;
  template <class P>
  __device__ RawA(const P&, int) {}

  template <bool V16, int BM, class P>
  __device__ __forceinline__ void stage(const P& p, unsigned char* dst,
                                        int k0, int k_hi, int m0) const {
    const size_t a_ld = static_cast<size_t>(p.K) * AB;
    stage_rows<V16, BM, kBK * AB, 0>(
        dst, ring_a_row(AB), p.a + m0 * a_ld + static_cast<size_t>(k0) * AB,
        a_ld, p.M - m0, (k_hi - k0) * AB, p.cb_a);
  }

  template <int BM>
  __device__ __forceinline__ void split(const unsigned char* as,
                                        unsigned char* ap, int) const {
    if constexpr (AB == 2) {
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
};

// Eight consecutive activations of type T (f32, bf16 or f16) in shared
// memory as f32 (exact: bf16 and f16 widen without rounding).
template <class T>
__device__ __forceinline__ void load8_f32(const unsigned char* src,
                                          float (&v)[8]) {
  if constexpr (sizeof(T) == 4) {
    const float4 a = *reinterpret_cast<const float4*>(src);
    const float4 b = *reinterpret_cast<const float4*>(src + 16);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (std::is_same_v<T, __nv_bfloat16>) {
        v[2 * i] = __uint_as_float(w[i] << 16);
        v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
      } else {
        v[2 * i] = __half2float(__ushort_as_half(
            static_cast<unsigned short>(w[i] & 0xFFFFu)));
        v[2 * i + 1] = __half2float(__ushort_as_half(
            static_cast<unsigned short>(w[i] >> 16)));
      }
    }
  }
}

// The a side of K2's fused quantize (K1 folded into the tensor-core K2):
// float activations x [M, k_full] of T (f32, bf16 or f16), row-major, read
// in their own type.  A stage stages 2 kBK values a row as they are (K is
// in int16xP2s8 lanes, two lattice values each), and `split` quantizes them
// to K1's lattice (csrc/quant_pack.cu), clip(rint(x / scale) + zp, 0,
// qmax), straight into the byte planes the MMAs read -- plane 0 = hi =
// lattice value 2k + 1, plane 1 = lo = 2k, the planes an int16xP2s8 lane
// would have split into -- and adds each thread's values to its rows'
// sums.  Values past k_full are staged as zeros, which would quantize to
// zp: they are forced to 0, as K1 does; rows past M are not quantized
// (their planes are zero; the epilogue masks them).  P carries a (x's
// bytes), M, k_full, a_scale, a_zp, qmax and cb_a.
//
// rint(x / scale) is computed exactly without a divide on the common
// path.  With inv = 1 / scale correctly rounded (a normal number), t = x *
// inv lies within 3 * 2^-24 |x / scale| (+ 2^-149) of the correctly
// rounded quotient q = x / scale, so wherever t is farther than |t| * 2^-21
// from every half-integer, q is on the same side of the same half-integer
// and rint(q) == rint(t).  rint(t) itself is 1.5 * 2^23 + t, which rounds
// t to an integer half to even for |t| < 2^22; its bits less those of
// 1.5 * 2^23 are that integer, clamped with the zero point in integers (zp
// held to +-2^22: beyond, every |t| < 2^20 clamps the same way).  The
// values the filter does not decide -- exact half-steps, values within its
// margin of one (a fraction 2^-20 |t| of spread values), |t| >= 2^20,
// non-finite values, and every value when 1 / scale is not normal -- are
// redone after the straight-line pass in K1's own arithmetic with the IEEE
// divide (__fdiv_rn), so the lattice is K1's bit for bit
// (tests/test_torch_quant_fused.py holds an emulation of this filter
// against the divide on adversarial values).
template <class T>
struct QuantA {
  static constexpr int kBytes = 2 * static_cast<int>(sizeof(T));
  static constexpr int kPlanes = 2;
  static constexpr bool kQuant = true;
  // items (row m, 4 lanes) of a thread at most: 64 rows x 16
  static constexpr int kMaxItems = 64 * (kBK / 4) / kThreads;

  float scale, inv, zp, qmaxf;  // K1's operands, as floats
  int zpi, qmax;                 // the zero point held to +-2^22, 2^a - 1
  bool fast;                     // inv is normal: the filter holds
  int k_full, rows;              // rows of x in this block
  int32_t sums[kMaxItems];       // this thread's row sums, by item

  template <class P>
  __device__ QuantA(const P& p, int m0) {
    scale = *p.a_scale;
    inv = __fdiv_rn(1.0f, scale);
    zp = __int2float_rn(*p.a_zp);
    zpi = min(max(*p.a_zp, -(1 << 22)), 1 << 22);
    qmax = p.qmax;
    qmaxf = __int2float_rn(p.qmax);
    fast = isfinite(inv) && fabsf(inv) >= 0x1p-126f;
    k_full = p.k_full;
    rows = p.M - m0;
#pragma unroll
    for (int i = 0; i < kMaxItems; ++i) sums[i] = 0;
  }

  template <bool V16, int BM, class P>
  __device__ __forceinline__ void stage(const P& p, unsigned char* dst,
                                        int k0, int k_hi, int m0) const {
    constexpr int XB = sizeof(T);
    const size_t ld = static_cast<size_t>(p.k_full) * XB;
    const int hi = min(2 * k_hi, p.k_full);
    stage_rows<V16, BM, 2 * kBK * XB, 0>(
        dst, ring_a_row(kBytes),
        p.a + m0 * ld + static_cast<size_t>(2 * k0) * XB, ld, p.M - m0,
        static_cast<long long>(hi - 2 * k0) * XB, p.cb_a);
  }

  // K1's arithmetic for one value: clip(rint(x / scale) + zp, 0, qmax).
  __device__ __forceinline__ int32_t k1_quantize(float x) const {
    return static_cast<int32_t>(
        fminf(fmaxf(__fadd_rn(rintf(__fdiv_rn(x, scale)), zp), 0.0f), qmaxf));
  }

  // The filter's lattice value for x; sets `undecided` where the filter
  // does not decide it: where t lies within |t| * 2^-21 of a half-integer
  // (fma(|t|, 2^-21, |t - rint(t)|) >= 0.5, with the sum rounded once, so
  // that a sum below 0.5 means the exact sum is too), which also takes in
  // every |t| >= 2^20, and where t is not finite (the sum is NaN).
  __device__ __forceinline__ int32_t filtered(float x, bool& undecided) const {
    const float t = __fmul_rn(x, inv);
    const float y = __fadd_rn(t, 0x1.8p23f);  // 1.5 * 2^23 + rint(t)
    const float d = __fsub_rn(t, __fsub_rn(y, 0x1.8p23f));
    undecided = !(__fmaf_rn(fabsf(t), 0x1p-21f, fabsf(d)) < 0.5f);
    const int32_t n = static_cast<int32_t>(
        __float_as_uint(y) - 0x4B400000u + static_cast<uint32_t>(zpi));
    return min(max(n, 0), qmax);
  }

  // Item (m, g4)'s eight lattice values as its lo (even) and hi (odd)
  // plane words, those past k_full forced to 0; returns their sum.
  __device__ __forceinline__ int32_t pack(const int32_t (&q)[8], int base,
                                          uint32_t& lo, uint32_t& hi) const {
    int32_t s = 0;
    lo = hi = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t qi = base + j < k_full ? static_cast<uint32_t>(q[j]) : 0u;
      s += static_cast<int32_t>(qi);
      if (j & 1)
        hi |= qi << (8 * (j >> 1));
      else
        lo |= qi << (8 * (j >> 1));
    }
    return s;
  }

  // Thread item (m, g4): lanes [k0 + 4 g4, k0 + 4 g4 + 4) of row m, the
  // items of RawA<2>'s split.  The filtered pass is straight-line, so a
  // thread's items interleave; the values it did not decide are redone
  // after it with K1's arithmetic (rare, and kept out of the pass, whose
  // schedule a divide's branches would serialize).
  template <int BM>
  __device__ __forceinline__ void split(const unsigned char* as,
                                        unsigned char* ap, int k0) {
    constexpr int ITEMS = BM * (kBK / 4);
    constexpr int NI = (ITEMS + kThreads - 1) / kThreads;
    bool redo = !fast;  // some value the filter did not decide
#pragma unroll
    for (int item = 0; item < NI; ++item) {
      const int e = threadIdx.x + item * kThreads;
      if (ITEMS % kThreads != 0 && e >= ITEMS) break;
      const int m = e >> 4, g4 = e & 15;
      uint32_t lo = 0u, hi = 0u;
      if (m < rows) {  // rows past M: zero planes, no sums
        float v[8];
        int32_t q[8];
        load8_f32<T>(as + m * ring_a_row(kBytes) + 8 * sizeof(T) * g4, v);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          bool u;
          q[j] = filtered(v[j], u);
          redo |= u;
        }
        sums[item] += pack(q, 2 * (k0 + 4 * g4), lo, hi);
      }
      *reinterpret_cast<uint32_t*>(ap + m * kPlaneRow + 4 * g4) = hi;
      *reinterpret_cast<uint32_t*>(ap + BM * kPlaneRow + m * kPlaneRow +
                                   4 * g4) = lo;
    }
    if (redo) {  // this thread's undecided values, in K1's arithmetic
#pragma unroll
      for (int item = 0; item < NI; ++item) {
        const int e = threadIdx.x + item * kThreads;
        if (ITEMS % kThreads != 0 && e >= ITEMS) break;
        const int m = e >> 4, g4 = e & 15;
        if (m >= rows) continue;
        float v[8];
        int32_t q[8];
        bool u[8], any = !fast;
        load8_f32<T>(as + m * ring_a_row(kBytes) + 8 * sizeof(T) * g4, v);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          q[j] = filtered(v[j], u[j]);
          any |= u[j];
        }
        if (!any) continue;
        const int base = 2 * (k0 + 4 * g4);
        uint32_t lo, hi;
        sums[item] -= pack(q, base, lo, hi);  // the pass's values, then K1's
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (u[j] || !fast) q[j] = k1_quantize(v[j]);
        sums[item] += pack(q, base, lo, hi);
        *reinterpret_cast<uint32_t*>(ap + m * kPlaneRow + 4 * g4) = hi;
        *reinterpret_cast<uint32_t*>(ap + BM * kPlaneRow + m * kPlaneRow +
                                     4 * g4) = lo;
      }
    }
  }

  // Each row's sum over the block's K range, reduced over the 16 threads
  // that share the row (one half-warp); `put(m, sum)` is called by the
  // thread of g4 = 0 of each row m < BM.
  template <int BM, class Put>
  __device__ __forceinline__ void row_sums(Put&& put) const {
    constexpr int ITEMS = BM * (kBK / 4);
#pragma unroll
    for (int item = 0; item < (ITEMS + kThreads - 1) / kThreads; ++item) {
      int32_t v = sums[item];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      const int e = threadIdx.x + item * kThreads;
      if (e < ITEMS && (e & 15) == 0) put(e >> 4, v);
    }
  }
};

// The W side of the tile: W's own rows [K, N] of WB bytes (int8 or int16,
// row-major; P carries w (a byte pointer), N and the copy size cb_w).  A
// stage is a raw kBK x kBN tile, swizzled for the transposing pass, which
// turns it into WB K-major planes (2-byte W: plane 0 = hi, plane 1 = lo).
template <int WB>
struct RawW {
  static constexpr int kTile = kBK * kBN * WB;  // raw bytes in a ring slot
  static constexpr int kPlanes = WB;            // planes the MMAs read
  static constexpr int kElem = WB;              // bytes of a W element
  static constexpr bool kDense = false;

  template <class P>
  __device__ explicit RawW(const P&) {}

  template <bool V16, class P>
  __device__ __forceinline__ void stage(const P& p, unsigned char* dst,
                                        int k0, int k_hi, int n0) const {
    const size_t w_ld = static_cast<size_t>(p.N) * WB;
    stage_rows<V16, kBK, kBN * WB, WB>(
        dst, kBN * WB, p.w + k0 * w_ld + static_cast<size_t>(n0) * WB, w_ld,
        k_hi - k0, static_cast<long long>(p.N - n0) * WB, p.cb_w);
  }

  // Thread item (nb, kb): columns [4nb, 4nb + 4) of k rows [4kb, 4kb + 4);
  // a warp takes 8 column blocks x 4 k blocks.
  __device__ __forceinline__ void expand(const unsigned char* slot,
                                         unsigned char* wp, int) const {
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
  }
};

// The W side of K2's bit-dense store (ops.dense_store_weights): int32 words
// [ceil(k_full / kPer), N], row-major, kPer = 32 / BITS lattice values a
// word in ascending fields (value j of word r at bit BITS * j: value
// r * kPer + j of the column).  K is counted in int16xP2s8 lanes of two
// values, so a stage's kBK lanes are kRows = 2 kBK / kPer whole word rows
// (BITS 1, 2, 4; 3 does not divide a stage and is refused by the planner)
// and a split of whole stages starts on a word.  The ring carries the raw
// word rows (kBN x 4 bytes each, a quarter to an eighth of the lanes'
// bytes), and `expand` writes each value as the lattice byte the lanes
// route puts there after its hi / lo split: a field-reversed lane holds
// value 2k at bit 8 and 2k + 1 at bit 0, so plane 0 (hi) gets the even
// values and plane 1 (lo) the odd ones, at lane 2k / 2 of the plane row.
// Values past k_full are 0 (a word's tail is masked; word rows past the
// store are staged as zeros).  P carries w, N, k_full and cb_w.
//
// Thread items: a warp takes RW word rows x CW = 32 / RW columns, where
// RW = 16 / kL rows (kL = kPer / 2 lanes a word) fill one 16-byte plane
// chunk: the raw rows are swizzled by row within the group (chunk_pos<16 +
// RW>) so the warp's 4-byte reads hit 32 banks, and each half- (or
// quarter-) warp's 8- (16-) byte plane stores cover 8 consecutive columns,
// the 32 banks of one chunk each.
template <int BITS>
struct DenseW {
  static_assert(BITS == 1 || BITS == 2 || BITS == 4,
                "a stage must be whole words");
  static constexpr int kPer = 32 / BITS;        // values a word
  static constexpr int kL = kPer / 2;           // lanes a word
  static constexpr int kRows = kBK / kL;        // word rows a stage
  static constexpr int kTile = kRows * kBN * 4;
  static constexpr int kPlanes = 2;
  static constexpr int kElem = 4;               // bytes of a word
  static constexpr bool kDense = true;
  static constexpr int RW = 16 / kL;            // word rows a warp
  static constexpr int CW = 32 / RW;            // columns a warp
  static constexpr uint32_t kMask = (1u << BITS) - 1u;

  int k_full;

  template <class P>
  __device__ explicit DenseW(const P& p) : k_full(p.k_full) {}

  template <bool V16, class P>
  __device__ __forceinline__ void stage(const P& p, unsigned char* dst,
                                        int k0, int k_hi, int n0) const {
    const size_t w_ld = static_cast<size_t>(p.N) * 4;
    const int r0 = k0 / kL;
    stage_rows<V16, kRows, kBN * 4, 16 + RW>(
        dst, kBN * 4, p.w + r0 * w_ld + static_cast<size_t>(n0) * 4, w_ld,
        (k_hi + kL - 1) / kL - r0, static_cast<long long>(p.N - n0) * 4,
        p.cb_w);
  }

  // Value pairs (2i, 2i + 1) of word w as the hi (even) and lo (odd)
  // plane bytes i = 0 .. kL - 1, kL / 4 words each.
  static __device__ __forceinline__ void split_word(uint32_t w,
                                                    uint32_t (&hi)[kL / 4],
                                                    uint32_t (&lo)[kL / 4]) {
#pragma unroll
    for (int j = 0; j < kL / 4; ++j) hi[j] = lo[j] = 0u;
#pragma unroll
    for (int i = 0; i < kL; ++i) {
      hi[i >> 2] |= ((w >> (2 * BITS * i)) & kMask) << (8 * (i & 3));
      lo[i >> 2] |= ((w >> (2 * BITS * i + BITS)) & kMask) << (8 * (i & 3));
    }
  }

  __device__ __forceinline__ void expand(const unsigned char* slot,
                                         unsigned char* wp, int k0) const {
    constexpr int ITEMS = kRows * kBN;
    constexpr int COL_GROUPS = kBN / CW;
#pragma unroll
    for (int item = 0; item < ITEMS / kThreads; ++item) {
      const int e = threadIdx.x + item * kThreads;
      const int lane = e & 31, g = e >> 5;
      const int r = (g / COL_GROUPS) * RW + lane % RW;
      const int n = (g % COL_GROUPS) * CW + lane / RW;
      uint32_t w = *reinterpret_cast<const uint32_t*>(
          slot + r * (kBN * 4) + (chunk_pos<16 + RW>(r, n >> 2) << 4) +
          4 * (n & 3));
      const int nv = k_full - (2 * k0 + r * kPer);  // values left in K
      if (nv < kPer) w = nv > 0 ? w & ((1u << (BITS * nv)) - 1u) : 0u;
      uint32_t hi[kL / 4], lo[kL / 4];
      split_word(w, hi, lo);
      unsigned char* d0 = wp + plane_off(n, r * kL);
      unsigned char* d1 = d0 + kBN * kPlaneRow;
      if constexpr (kL == 16) {
        *reinterpret_cast<uint4*>(d0) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(d1) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      } else if constexpr (kL == 8) {
        *reinterpret_cast<uint2*>(d0) = make_uint2(hi[0], hi[1]);
        *reinterpret_cast<uint2*>(d1) = make_uint2(lo[0], lo[1]);
      } else {
        *reinterpret_cast<uint32_t*>(d0) = hi[0];
        *reinterpret_cast<uint32_t*>(d1) = lo[0];
      }
    }
  }
};

// Lanes of the other layouts of the family: LB bytes (int8, int16 or
// int32) holding NP lattice values SH bits apart (int8xP2s4, int16xP4s4,
// int32xP2s8, int32xP4s8, int32xP2s16).  Lattice value v of a row or
// column lies in lane v / NP, field f = v % NP: at bit SH * (NP - 1 - f)
// of a field-reversed weight lane, at bit SH * f of an ascending
// activation lane.  In the overflow-free region no value reaches 2^4 (w,
// a <= 4 bits), so a field's low byte (SH >= 8) or its nibble (SH = 4) is
// the value.  K stays the tile's: a K step is two lattice values, as an
// int16xP2s8 lane, so a stage's kBK steps are kLanes = 2 kBK / NP lanes and
// a split of whole stages starts on a whole lane.  Each side writes value
// v to the plane byte the int16xP2s8 route puts it in after its hi / lo
// split -- W: value 2k to plane 0 (hi), 2k + 1 to plane 1 (lo), at byte k
// of the stage; a: 2k + 1 to plane 0 (hi), 2k to plane 1 (lo) -- so every
// W side pairs with every a side, and the MMAs, the fix-up and the
// epilogue are the int16xP2s8 route's.  Byte fields are taken by byte
// moves, nibbles by a shift and a mask; nvcc folds the constant shifts.
template <int LB, int NP, int SH>
struct LaneFields {
  static_assert((LB == 1 || LB == 2 || LB == 4) && (NP == 2 || NP == 4) &&
                    NP * SH <= 8 * LB && (SH == 4 || SH % 8 == 0),
                "a layout of the family");
  static constexpr int kLanes = 2 * kBK / NP;  // lanes a stage
  static constexpr int kRun = 8 / NP;          // lanes of 8 values
  static constexpr uint32_t kMask = SH >= 8 ? 0xFFu : (1u << SH) - 1u;

  // The lanes holding K steps [0, K): ceil(2 K / NP).
  static __host__ __device__ constexpr int lanes(int K) {
    return (2 * K + NP - 1) / NP;
  }

  // Field f of the lane at byte `off` of little-endian words w, the lane
  // field-reversed (REV) or ascending.  Callers unroll their loops, so
  // every index and shift is a constant and w stays in registers.
  template <bool REV>
  static __device__ __forceinline__ uint32_t field(const uint32_t* w, int off,
                                                   int f) {
    const int bit = 8 * off + SH * (REV ? NP - 1 - f : f);
    return (w[bit >> 5] >> (bit & 31)) & kMask;
  }
};

// The W side of the other layouts: field-reversed lanes [Kp, N] of LB
// bytes (P carries w, N and cb_w).  A stage is kLanes rows of the block's
// kBN columns as they are; its expand pass takes RawW's thread items
// (columns [4 nb, 4 nb + 4) x plane bytes [4 kb, 4 kb + 4), i.e. values
// [8 kb, 8 kb + 8): rows [kRun kb, kRun kb + kRun)) and writes each
// column's four even values to plane 0 and four odd ones to plane 1 at
// RawW's addresses, so the plane stores are as free of conflicts as
// there.  The reads of a warp (8 column blocks x 4 row groups) hit 32
// banks: 16-byte reads of int32 lanes by a quarter-warp's 8 column blocks
// of one row; int16 lanes (4 fields, row pairs) through chunk_pos<3>, int8
// lanes (2 fields, rows by four) through RawW<1>'s chunk_pos<1>.
template <int LB, int NP, int SH>
struct LanesW {
  using L = LaneFields<LB, NP, SH>;
  static constexpr int kTile = L::kLanes * kBN * LB;  // raw bytes a slot
  static constexpr int kPlanes = 2;
  static constexpr int kElem = LB;
  static constexpr bool kDense = false;
  static constexpr int kSW = LB == 4 ? 0 : LB == 2 ? 3 : 1;
  static_assert(LB != 1 || L::kRun == 4, "int8 lanes hold two fields");
  static_assert(LB != 2 || L::kRun == 2, "int16 lanes here hold four");

  template <class P>
  __device__ explicit LanesW(const P&) {}

  template <bool V16, class P>
  __device__ __forceinline__ void stage(const P& p, unsigned char* dst,
                                        int k0, int k_hi, int n0) const {
    const size_t w_ld = static_cast<size_t>(p.N) * LB;
    const int r0 = 2 * k0 / NP;
    stage_rows<V16, L::kLanes, kBN * LB, kSW>(
        dst, kBN * LB, p.w + r0 * w_ld + static_cast<size_t>(n0) * LB, w_ld,
        L::lanes(k_hi) - r0, static_cast<long long>(p.N - n0) * LB, p.cb_w);
  }

  // Column c's plane words of one item: even values to hi, odd to lo.
  template <int C>
  static __device__ __forceinline__ void column(
      const uint32_t (&r)[L::kRun][LB], uint32_t& hi, uint32_t& lo) {
    hi = lo = 0u;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      // lane i / NP of the run, field i % NP, column C's LB bytes
      const uint32_t v = L::template field<true>(r[i / NP], C * LB, i % NP);
      if (i & 1)
        lo |= v << (8 * (i >> 1));
      else
        hi |= v << (8 * (i >> 1));
    }
  }

  __device__ __forceinline__ void expand(const unsigned char* slot,
                                         unsigned char* wp, int) const {
    constexpr int WROW = kBN * LB;
#pragma unroll
    for (int item = 0; item < (kBN / 4) * (kBK / 4) / kThreads; ++item) {
      const int e = threadIdx.x + item * kThreads;
      const int lane = e & 31, wi = e >> 5;
      const int nb = ((wi & 3) << 3) | (lane & 7);
      const int kb = ((wi >> 2) << 2) | (lane >> 3);
      uint32_t r[L::kRun][LB];  // the item's rows: 4 columns of LB bytes
#pragma unroll
      for (int i = 0; i < L::kRun; ++i) {
        const int row = L::kRun * kb + i;
        const int x = 4 * LB * nb;
        const unsigned char* src =
            slot + row * WROW + (chunk_pos<kSW>(row, x >> 4) << 4) + (x & 15);
        if constexpr (LB == 4) {
          const uint4 v = *reinterpret_cast<const uint4*>(src);
          r[i][0] = v.x; r[i][1] = v.y; r[i][2] = v.z; r[i][3] = v.w;
        } else if constexpr (LB == 2) {
          const uint2 v = *reinterpret_cast<const uint2*>(src);
          r[i][0] = v.x; r[i][1] = v.y;
        } else {
          r[i][0] = *reinterpret_cast<const uint32_t*>(src);
        }
      }
      uint32_t hi[4], lo[4];
      column<0>(r, hi[0], lo[0]);
      column<1>(r, hi[1], lo[1]);
      column<2>(r, hi[2], lo[2]);
      column<3>(r, hi[3], lo[3]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        unsigned char* d = wp + plane_off(4 * nb + j, 4 * kb);
        *reinterpret_cast<uint32_t*>(d) = hi[j];
        *reinterpret_cast<uint32_t*>(d + kBN * kPlaneRow) = lo[j];
      }
    }
  }
};

// The a side of the other layouts: ascending activation lanes [M, Kp] of
// LB bytes (P carries a, M, K and cb_a), staged 2 kBK / NP lanes a row a
// stage and split as RawA<2>'s items (row m, plane bytes [4 g4, 4 g4 + 4):
// values [8 g4, 8 g4 + 8), 8 LB / NP staged bytes): odd values to plane 0
// (hi), even ones to plane 1 (lo).
template <int LB, int NP, int SH>
struct LanesA {
  using L = LaneFields<LB, NP, SH>;
  static constexpr int kBytes = 2 * LB / NP;  // staged bytes a K step
  static constexpr int kPlanes = 2;
  static constexpr bool kQuant = false;
  static constexpr int kItem = 8 * LB / NP;   // staged bytes of 8 values

  // bytes of one of a's rows: the lanes holding K steps
  static __host__ __device__ constexpr long long row_bytes(int K) {
    return static_cast<long long>(L::lanes(K)) * LB;
  }

  LanesA() = default;
  template <class P>
  __device__ LanesA(const P&, int) {}

  template <bool V16, int BM, class P>
  __device__ __forceinline__ void stage(const P& p, unsigned char* dst,
                                        int k0, int k_hi, int m0) const {
    const size_t a_ld = static_cast<size_t>(row_bytes(p.K));
    const int l0 = 2 * k0 / NP;
    stage_rows<V16, BM, kBK * kBytes, 0>(
        dst, ring_a_row(kBytes),
        p.a + m0 * a_ld + static_cast<size_t>(l0) * LB, a_ld, p.M - m0,
        static_cast<long long>(L::lanes(k_hi) - l0) * LB, p.cb_a);
  }

  template <int BM>
  __device__ __forceinline__ void split(const unsigned char* as,
                                        unsigned char* ap, int) const {
    constexpr int ITEMS = BM * (kBK / 4);
#pragma unroll
    for (int item = 0; item < (ITEMS + kThreads - 1) / kThreads; ++item) {
      const int e = threadIdx.x + item * kThreads;
      if (ITEMS % kThreads != 0 && e >= ITEMS) break;
      const int m = e >> 4, g4 = e & 15;
      const unsigned char* src = as + m * ring_a_row(kBytes) + kItem * g4;
      uint32_t w[kItem / 4];
      if constexpr (kItem == 16) {
        const uint4 v = *reinterpret_cast<const uint4*>(src);
        w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
      } else if constexpr (kItem == 8) {
        const uint2 v = *reinterpret_cast<const uint2*>(src);
        w[0] = v.x; w[1] = v.y;
      } else {
        w[0] = *reinterpret_cast<const uint32_t*>(src);
      }
      uint32_t hi = 0u, lo = 0u;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        // lane i / NP of the item at byte (i / NP) LB, field i % NP
        const uint32_t v = L::template field<false>(w, (i / NP) * LB, i % NP);
        if (i & 1)
          hi |= v << (8 * (i >> 1));
        else
          lo |= v << (8 * (i >> 1));
      }
      *reinterpret_cast<uint32_t*>(ap + m * kPlaneRow + 4 * g4) = hi;
      *reinterpret_cast<uint32_t*>(ap + BM * kPlaneRow + m * kPlaneRow +
                                   4 * g4) = lo;
    }
  }
};

// Issue the copies of stage k0 (W's stage k0 of the block's columns, as
// the W side stages it; a's rows at the same k, as the a side stages them)
// into ring slot `slot`.
template <int BM, bool V16, class P, class WS, class AS>
__device__ __forceinline__ void issue_stage(const P& p, const WS& ws,
                                            const AS& as, unsigned char* slot,
                                            int k0, int k_hi, int m0,
                                            int n0) {
  ws.template stage<V16>(p, slot, k0, k_hi, n0);
  as.template stage<V16, BM>(p, slot + WS::kTile, k0, k_hi, m0);
}

// Turn the raw W tile of `slot` into K-major planes at `wp` (the W side's
// expand) and a's staged rows of stage k0 into planes at `ap` (the a
// side's split).
template <int BM, class WS, class AS>
__device__ __forceinline__ void prepare(const unsigned char* slot,
                                        unsigned char* wp,
                                        unsigned char* ap, const WS& ws,
                                        AS& as, int k0) {
  ws.expand(slot, wp, k0);
  as.template split<BM>(slot + WS::kTile, ap, k0);
}

// The K loop of one block: W's K range [k_lo, k_hi) of columns [n0, n0 +
// kBN), as the W side `ws` stages it, and a's rows [m0, m0 + BM), as the a
// side `as` stages them, stream through the ring (dynamic shared memory
// `smem` of smem_bytes_w(BM, AS::kBytes, WS::kTile, WS::kPlanes,
// AS::kPlanes)), and for
// every k32 step,
// 8-row group j of m, W plane pw and a plane pa the block calls
//   mma(j, pw, pa, A fragment of W plane pw, b0, b1)
// with the B fragment (b0, b1) of a plane pa, group j.  The loops are
// unrolled, so j, pw and pa are constants and a caller's branches on them
// fold.  Output element d_i of group j of a thread (lane 4g + t of warp
// `warp`) is out[m0 + 8j + 2t + (i & 1)][n0 + 16 warp + g + 8 (i >> 1)].
// The ring and planes are not touched after the last MMA, so an epilogue
// may follow without a barrier.
template <class WS, int BM, bool V16, class P, class AS, class Mma>
__device__ __forceinline__ void mainloop_w(const P& p, unsigned char* smem,
                                           int m0, int n0, int k_lo,
                                           int k_hi, const WS& ws, AS&& as,
                                           Mma&& mma) {
  constexpr int AB = std::decay_t<AS>::kBytes;
  constexpr int AP = std::decay_t<AS>::kPlanes;
  constexpr int WB = WS::kPlanes;  // W planes
  constexpr int WT = WS::kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nsteps = k_hi > k_lo ? (k_hi - k_lo + kBK - 1) / kBK : 0;
  constexpr int SB = stage_bytes_w(BM, AB, WT);
  constexpr int PB = plane_bytes(BM, AP, WB);
  constexpr int MG = BM / 8;  // 8-row groups of m
  constexpr int kStages = stages_for_w(BM, AB, WT, WB, AP);
  static_assert(kStages >= kMinStages, "the ring needs three slots");
  unsigned char* planes = smem + kStages * SB;

#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps)
      issue_stage<BM, V16>(p, ws, as, smem + s * SB, k_lo + s * kBK, k_hi,
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
    prepare<BM>(smem, planes, planes + WB * kBN * kPlaneRow, ws, as, k_lo);
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
        issue_stage<BM, V16>(p, ws, as, smem + (s % kStages) * SB,
                             k_lo + s * kBK, k_hi, m0, n0);
      cp_async_commit();
    }
    unsigned char* slot = smem + (it % kStages) * SB;
    unsigned char* wp = planes + (it & 1) * PB;
    unsigned char* ap = AP == 2 ? wp + WB * kBN * kPlaneRow : slot + WT;
    if (it + 1 < nsteps) {
      unsigned char* wn = planes + ((it + 1) & 1) * PB;
      prepare<BM>(smem + ((it + 1) % kStages) * SB, wn,
                  wn + WB * kBN * kPlaneRow, ws, as, k_lo + (it + 1) * kBK);
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
        for (int pa = 0; pa < AP; ++pa) {
          uint32_t bf[2];
          ldmatrix_x2(bf, ap_s + pa * BM * kPlaneRow +
                              (lane & 7) * kPlaneRow +
                              (2 * ks + achunk) * 16);
#pragma unroll
          for (int pw = 0; pw < WB; ++pw)
            mma(0, pw, pa, af[pw], bf[0], bf[1]);
        }
      } else {
#pragma unroll
        for (int jj = 0; jj < MG / 2; ++jj) {
#pragma unroll
          for (int pa = 0; pa < AP; ++pa) {
            uint32_t bf[4];
            ldmatrix_x4(bf, ap_s + pa * BM * kPlaneRow +
                                (16 * jj + arow) * kPlaneRow +
                                (2 * ks + achunk) * 16);
#pragma unroll
            for (int pw = 0; pw < WB; ++pw) {
              mma(2 * jj, pw, pa, af[pw], bf[0], bf[1]);
              mma(2 * jj + 1, pw, pa, af[pw], bf[2], bf[3]);
            }
          }
        }
      }
    }
  }
}

// The K loop over W's own rows of WB bytes (RawW<WB>).
template <int WB, int BM, bool V16, class P, class AS, class Mma>
__device__ __forceinline__ void mainloop(const P& p, unsigned char* smem,
                                         int m0, int n0, int k_lo,
                                         int k_hi, AS&& as, Mma&& mma) {
  mainloop_w<RawW<WB>, BM, V16>(p, smem, m0, n0, k_lo, k_hi, RawW<WB>(p),
                                static_cast<AS&&>(as), static_cast<Mma&&>(mma));
}

// The largest of 16, 8, 4 bytes that divides the row size and the base
// address; 0 (plain loads) if none does.
inline int copy_bytes(const void* base, long long row_bytes) {
  const auto addr = reinterpret_cast<uintptr_t>(base);
  for (int cb = 16; cb >= 4; cb >>= 1)
    if (row_bytes % cb == 0 && addr % cb == 0) return cb;
  return 0;
}

}  // namespace mma_s8
