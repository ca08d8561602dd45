// The pixel tile of the tensor-core convs, K5 (ulppack_conv2d_mma.cu) and
// K6 (int_conv2d_mma.cu): an implicit GEMM whose M is output pixels in
// 16-pixel row fragments, walked by persistent blocks in tiles of
// block_h x block_w = 512 output pixels of one image, each tile's halo
// staged through a two-slot cp.async ring.
//
// K runs over (tap, channel).  A conv whose weights and halo fit one block
// whole stages each tile's halo once, every channel of a pixel in one
// slot, beside a weight block that stays resident.  A wider conv splits
// the channels into chunks of `cpad` staged bytes a pixel: the ring then
// runs over (tile, chunk) pairs, each slot holding one chunk's halo slice
// and the weight block's slice for that chunk, so the next pair's copies
// are in flight while the current one is multiplied.
//
// A halo slot holds [block_h + FH - 1][block_w + FW - 1] pixels of `cpad`
// staged bytes each (32, 64, or a multiple of 128); the 16-byte units of a
// pixel are XOR-swizzled by its index so that ldmatrix reads of 8
// consecutive pixels hit 32 banks.  Pixels outside the image, and bytes
// past the `xrow` bytes an image pixel holds, are staged as zero, so
// padding is never materialised.
//
// The helpers read these fields of the kernel's argument struct P: x (the
// image bytes), H, W, xrow, FH, FW, pad_top, pad_left, cpad, th / tw (a
// tile's output rows x columns), tiles_h, tiles_w, cb (copy bytes: 16,
// 8 or 4 by cp.async; 0: 2-byte loads; 1: byte loads) and, for a raw slot
// (K5's lanes that are not lattice bytes), craw.
#pragma once

#include "mma_s8.cuh"

namespace conv_mma {

constexpr int kConvThreads = 256;    // 8 warps
constexpr int kWarpFrags = 4;        // 16-pixel row fragments per warp
constexpr int kTilePixels = 512;     // 8 warps x 4 fragments x 16 pixels
constexpr int kStages = 2;           // halo ring slots
constexpr int kConvSmemMax = 232448; // shared memory a block may use

// The staged bytes of a pixel holding xrow lattice bytes: 32, 64, else a
// multiple of 128 (so that the swizzle below stays inside a pixel).
__host__ __device__ constexpr int cpad_for(int xrow) {
  return xrow <= 32 ? 32 : xrow <= 64 ? 64 : (xrow + 127) / 128 * 128;
}

// Chunks one run of s32 sums spans before the kernel folds them into
// uint32 totals (PTX does not promise that the MMA's s32 sums wrap, so
// none may reach 2^31): every chunk where taps * C * max_prod stays below
// 2^31 (no fold), else the most chunks of chunk_ch channels whose products
// do; 0 where one chunk's could reach it (the launcher refuses the plan).
__host__ __device__ constexpr long long fold_run(long long taps, long long c,
                                                 long long chunk_ch,
                                                 long long max_prod,
                                                 long long chunks) {
  return taps * c * max_prod < (1LL << 31)
             ? chunks
             : ((1LL << 31) - 1) / (taps * chunk_ch * max_prod);
}

// The 16-byte unit of pixel `pix` that holds logical unit u is
// u ^ swizzle(pix, nu) (nu = cpad / 16 units a pixel): the units of 8
// consecutive pixels then fall on distinct 16-byte bank groups.
__device__ __forceinline__ int swizzle(int pix, int nu) {
  return nu == 2 ? (pix >> 2) & 1 : nu == 4 ? (pix >> 1) & 3 : pix & 7;
}

// The image and the first halo row / column of pixel tile `tile`.
template <class P>
__device__ __forceinline__ void tile_origin(const P& p, int tile, int& n,
                                            int& oh0, int& ow0) {
  const int per_img = p.tiles_h * p.tiles_w;
  n = tile / per_img;
  const int r = tile - n * per_img;
  oh0 = (r / p.tiles_w) * p.th;
  ow0 = (r % p.tiles_w) * p.tw;
}

// Issue the copies of tile `tile`'s halo into ring slot `buf`: cpad bytes
// a pixel (craw for a raw slot) from byte x0 of each image pixel (x0: a
// chunk's first byte, a multiple of 16); pixels outside the image and
// bytes past xrow are zeroed.  Thread e of the block takes items e, e +
// kConvThreads, ...; an item is UPI consecutive 16-byte units of one pixel
// (UPI divides cpad / 16), so the thread that waits for an item's copies
// may rework its bytes before the next barrier.  RAW stages into a raw
// slot instead: pixels of p.craw bytes, units in order (no swizzle), for a
// pass that rewrites them elsewhere.
template <int UPI, bool RAW = false, class P>
__device__ void stage_halo(const P& p, unsigned char* buf, int tile,
                           int x0) {
  int n, oh0, ow0;
  tile_origin(p, tile, n, oh0, ow0);
  const int gh0 = oh0 - p.pad_top, gw0 = ow0 - p.pad_left;
  const int hw = p.tw + p.FW - 1;
  int stride = p.cpad;
  if constexpr (RAW) stride = p.craw;
  const int nu = stride >> 4;
  const int units = (p.th + p.FH - 1) * hw * nu;
  const unsigned char* img =
      p.x + static_cast<size_t>(n) * p.H * p.W * p.xrow;
  for (int item = threadIdx.x; item < units / UPI; item += kConvThreads) {
#pragma unroll
    for (int j = 0; j < UPI; ++j) {
      const int e = item * UPI + j;
      const int pix = e / nu, u = e - pix * nu;
      const int r = pix / hw, c = pix - r * hw;
      const int gh = gh0 + r, gw = gw0 + c;
      unsigned char* d =
          buf + pix * stride + ((RAW ? u : u ^ swizzle(pix, nu)) << 4);
      const int lim = p.xrow - x0 - 16 * u;  // bytes of this unit in x
      const bool in = gh >= 0 && gh < p.H && gw >= 0 && gw < p.W && lim > 0;
      const unsigned char* s =
          in ? img + (static_cast<size_t>(gh) * p.W + gw) * p.xrow + x0 +
                   16 * u
             : nullptr;
      if (p.cb == 16) {
        if (in)
          mma_s8::cp_async(d, s, 16);
        else
          mma_s8::zero_smem(d, 16);
      } else {
        const int step = p.cb ? p.cb : 2;
        for (int o = 0; o < 16; o += step) {
          const bool ok = in && o < lim;
          if (p.cb == 0)
            *reinterpret_cast<uint16_t*>(d + o) =
                ok ? *reinterpret_cast<const uint16_t*>(s + o) : 0;
          else if (p.cb == 1)
            d[o] = ok ? s[o] : 0;
          else if (ok)
            mma_s8::cp_async(d + o, s + o, p.cb);
          else
            mma_s8::zero_smem(d + o, p.cb);
        }
      }
    }
  }
}

}  // namespace conv_mma
