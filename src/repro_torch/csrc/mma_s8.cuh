// The int8 tensor-core tile of the integer matmuls: cp.async staging,
// the in-register 4x4 byte transposition and byte-plane split (prmt), the
// ldmatrix fragment loads and mma.sync.m16n8k32 with s8 / u8 operands.
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
#pragma once

#include <stdint.h>

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
// planes: lo = x & 0xFF (u8) and hi = x >> 8 (s8), value i in byte i.
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

}  // namespace mma_s8
