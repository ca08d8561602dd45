// K5 on Hopper's int8 tensor cores: the packed conv2d of the int16xP2s8
// layout as an implicit GEMM, with the affine dequant of the CNN's packed
// layer fused into its epilogue.
//
// Replaces repro/kernels/ulppack_conv2d.py:ulppack_conv2d (Pallas `_kernel`
// via `_tiled_conv_call`, pallas_call at :148) for int16 lanes of two 8-bit
// fields, the layout of sparq-cnn and of three of the four Fig. 4 rows;
// every other layout keeps the CUDA-core tile (ulppack_conv2d.cu over
// conv2d_tile.cuh).  Each byte of such a lane is one lattice value:
// activations are packed ascending (channel 2k in the low byte, 2k + 1 in
// the high byte), so an activation pixel read as bytes IS its u8 lattice in
// channel order; weights are field-reversed (byte 0 holds channel 2k + 1,
// byte 1 channel 2k) and have their byte pairs swapped back while they are
// staged.  The exact lattice conv that K5 returns is then an ordinary
// u8 x u8 -> s32 conv with no packed-space product and no extraction.
//
// Bound on Hopper: operations.  At sparq-cnn's 32->64 layer (x [8, 256,
// 256, 32], 7x7, SAME) the conv is 52.6 G lattice MACs, 0.053 ms at the
// int8 tensor-core rate, against 0.045 ms for its bytes (almost all the
// 134 MB int32 output).  The design:
//
// - Implicit GEMM on mma.sync.m16n8k32 (u8 x u8): output pixels are the
//   MMA's M (a 16-pixel run of one output row), output channels its N
//   (groups of 8), and K runs over (tap, channel) 32 bytes a step.  Each
//   tap's channel bytes are zero-padded to `cpad` (32, 64, or a multiple
//   of 128) in shared memory, so at Cin = 32 a tap is exactly one step.
// - The weight block stays in shared memory: staged once per block as u8
//   rows of K = taps * cpad bytes per output channel (K-major, byte pairs
//   swapped into channel order; the 'dense' store's words are expanded to
//   bytes in the same pass), each row padded by 16 bytes to an odd number
//   of 16-byte units so that ldmatrix reads of 8 channel rows are free of
//   bank conflicts.  49 x 32 x 64 = 100 KB at 32->64.
// - Persistent blocks (the tile of conv_mma.cuh, shared with K6): each
//   block walks pixel tiles of block_h x block_w = 512 output pixels of
//   one image (8 warps x 4 row fragments of 16 pixels), blockIdx.x,
//   + gridDim.x, ...; a two-slot cp.async ring keeps
//   the next tile's halo [block_h + FH - 1][block_w + FW - 1][cpad] in
//   flight while the current one is multiplied (one barrier a tile).
//   Pixels outside the image are staged as zero, so padding is never
//   materialised.  A fragment's A operand comes from the halo by ldmatrix,
//   each tap a shifted window of halo pixels; the 16-byte units of a pixel
//   are XOR-swizzled by its index so that 8 consecutive pixels hit 32
//   banks.
// - Each warp computes 4 fragments x all block_co channels a step (4 A and
//   block_co / 16 B ldmatrix.x4 feed 4 * block_co / 8 MMAs).
// - Sums stay in range: no s32 sum may leave the int32 range (PTX does not
//   promise that the MMA wraps), so the planner refuses a conv whose
//   FH * FW * 2 Cp * max_w * max_a reaches 2^31, and so does this
//   launcher.
// - The fused epilogue (sparq-cnn's packed layer, models/cnn.py
//   conv_apply): psum, the patch sums of the activation lattice, comes
//   from one more MMA per fragment and step against a B of ones (exact),
//   and the kernel stores
//     out = (a_scale * w_scale) * (float(acc) - float(w_zp) * float(psum))
//   in f32, one rounding per operation with the _rn intrinsics (nvcc would
//   contract into an FMA), the order of cnn.conv_epilogue; the scalars are
//   read from device memory.  Without it the kernel stores the s32 conv.
// - Ragged edges are masked on store; edge tiles read zero halo pixels.
// - Launch geometry is the planner's (_conv_mma_geometry in
//   repro_torch/kernels/plan.py mirrors the constants below); the launcher
//   refuses a plan that disagrees with this layout.

#include "common.cuh"
#include "conv_mma.cuh"
#include "mma_s8.cuh"

namespace {

using conv_mma::cpad_for;
using conv_mma::kConvSmemMax;
using conv_mma::kConvThreads;
using conv_mma::kStages;
using conv_mma::kTilePixels;
using conv_mma::kWarpFrags;
using conv_mma::stage_halo;
using conv_mma::swizzle;
using conv_mma::tile_origin;
using mma_s8::cp_async;
using mma_s8::ldmatrix_x2;
using mma_s8::ldmatrix_x4;
using mma_s8::mma_m16n8k32;
using mma_s8::smem_addr;
using mma_s8::zero_smem;

struct Args {
  const unsigned char* x;   // [N, H, W, xrow] lattice bytes (int16 lanes)
  const void* w;            // lanes [FH, FW, Cp, CO] int16, or bit-dense
                            // words [FH, FW, WC, CO] int32
  void* out;                // [N, HO, WO, CO] int32, or f32 when fused
  const float* a_scale;     // 0-dim scalars of the fused epilogue
  const float* w_scale;
  const int32_t* w_zp;
  int N, H, W, xrow;        // xrow = 2 Cp bytes a pixel
  int FH, FW, WC, CO, HO, WO, pad_top, pad_left;
  int dense, w_bits, cin;   // 'dense': w_bits-wide fields, cin channels
  int cpad;                 // staged bytes a pixel and a tap of W
  int th, tw;               // output rows x columns of a pixel tile
  int tiles_h, tiles_w, tiles;
  int krow;                 // bytes of a staged W row (one out channel)
  int halo_bytes;           // bytes of one ring slot
  int cb;                   // x copy bytes (16, 8, 4; 0: 2-byte loads)
  int wvec;                 // weights read 16 bytes at a time
};

// Stage the block's weights [BN][krow] as u8 lattice values: row co holds
// channel c of tap t at byte t * cpad + c.  Channels past cin, taps' pad
// bytes and channels past CO are zero.  Each item reads 16 bytes (8 lanes
// or 4 words of neighbouring output channels) where the layout allows;
// items are loaded in batches of kBatch so that loads overlap.
template <int BN>
__device__ void stage_weights(const Args& p, unsigned char* ws, int co0) {
  const int total = BN * p.krow / 16;
  for (int i = threadIdx.x; i < total; i += kConvThreads)
    zero_smem(ws + 16 * i, 16);
  __syncthreads();
  const int taps = p.FH * p.FW;
  constexpr int kBatch = 4;
  if (!p.dense) {
    // item (tap, lane, group of 8 channels); field-reversed lane: channel
    // 2 lane is its high byte, 2 lane + 1 its low byte
    const int16_t* w = static_cast<const int16_t*>(p.w);
    constexpr int G = BN / 8;
    const int items = taps * p.WC * G;
    for (int e0 = threadIdx.x; e0 < items; e0 += kBatch * kConvThreads) {
      uint4 v[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int e = e0 + b * kConvThreads;
        v[b] = make_uint4(0u, 0u, 0u, 0u);
        if (e >= items) continue;
        const int cg = e % G, rest = e / G;
        const int co = co0 + 8 * cg;
        const size_t src = static_cast<size_t>(rest) * p.CO + co;
        if (p.wvec && co + 8 <= p.CO) {
          v[b] = __ldg(reinterpret_cast<const uint4*>(w + src));
        } else {
          uint32_t h[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            h[j] = co + j < p.CO ? static_cast<uint16_t>(w[src + j]) : 0u;
          v[b] = make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16,
                            h[4] | h[5] << 16, h[6] | h[7] << 16);
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int e = e0 + b * kConvThreads;
        if (e >= items) continue;
        const int cg = e % G, rest = e / G;
        const int lane = rest % p.WC, tap = rest / p.WC;
        const uint32_t words[4] = {v[b].x, v[b].y, v[b].z, v[b].w};
        unsigned char* d = ws + (8 * cg) * p.krow + tap * p.cpad + 2 * lane;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t lv = (words[j >> 1] >> (16 * (j & 1))) & 0xFFFFu;
          *reinterpret_cast<uint16_t*>(d + j * p.krow) =
              static_cast<uint16_t>((lv >> 8) | ((lv & 0xFFu) << 8));
        }
      }
    }
  } else {
    // item (tap, word, group of 4 channels); field f of word k is channel
    // k * per + f
    const int32_t* w = static_cast<const int32_t*>(p.w);
    const int per = 32 / p.w_bits;
    const uint32_t mask = (1u << p.w_bits) - 1u;
    constexpr int G = BN / 4;
    const int items = taps * p.WC * G;
    for (int e0 = threadIdx.x; e0 < items; e0 += kBatch * kConvThreads) {
      uint4 v[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int e = e0 + b * kConvThreads;
        v[b] = make_uint4(0u, 0u, 0u, 0u);
        if (e >= items) continue;
        const int cg = e % G, rest = e / G;
        const int co = co0 + 4 * cg;
        const size_t src = static_cast<size_t>(rest) * p.CO + co;
        if (p.wvec && co + 4 <= p.CO) {
          v[b] = __ldg(reinterpret_cast<const uint4*>(w + src));
        } else {
          uint32_t h[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            h[j] = co + j < p.CO ? static_cast<uint32_t>(w[src + j]) : 0u;
          v[b] = make_uint4(h[0], h[1], h[2], h[3]);
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int e = e0 + b * kConvThreads;
        if (e >= items) continue;
        const int cg = e % G, rest = e / G;
        const int word = rest % p.WC, tap = rest / p.WC;
        const uint32_t words[4] = {v[b].x, v[b].y, v[b].z, v[b].w};
        unsigned char* d = ws + (4 * cg) * p.krow + tap * p.cpad;
        for (int f = 0; f < per; ++f) {
          const int ch = word * per + f;
          if (ch >= p.cin) break;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            d[j * p.krow + ch] =
                static_cast<unsigned char>((words[j] >> (p.w_bits * f)) &
                                           mask);
        }
      }
    }
  }
}

template <int BN, bool FUSED>
__global__ void __launch_bounds__(kConvThreads, 1)
ulppack_conv2d_mma_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NG = BN / 8;  // 8-channel groups of the MMA's N
  unsigned char* ws = smem;
  unsigned char* halo = smem + BN * p.krow;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int co0 = blockIdx.y * BN;
  const int hw = p.tw + p.FW - 1;
  const int nu = p.cpad >> 4;
  const int ksteps = p.cpad >> 5;  // k32 steps a tap
  const int frow = p.tw >> 4;      // fragments a tile row

  int tile = blockIdx.x;
  if (tile < p.tiles) stage_halo<1>(p, halo, tile);
  mma_s8::cp_async_commit();
  stage_weights<BN>(p, ws, co0);

  // this lane's ldmatrix rows: A pixel aj of a fragment at 16-byte chunk
  // achunk of the step; B channel row bco of a 16-channel pair at k half
  // bhalf (x2 for one group: lanes 0-15, channel lane & 7)
  const int aj = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int achunk = lane >> 4;
  const int bco = NG == 1 ? (lane & 7) : ((lane >> 4) & 1) * 8 + (lane & 7);
  const int bhalf = (lane >> 3) & 1;
  const uint32_t ws_s = smem_addr(ws) + bco * p.krow + bhalf * 16;
  constexpr uint32_t kOnes = 0x01010101u;

  float s = 0.f, wzp = 0.f;
  if constexpr (FUSED) {
    s = __fmul_rn(*p.a_scale, *p.w_scale);
    wzp = __int2float_rn(*p.w_zp);
  }

  for (int it = 0; tile < p.tiles; ++it, tile += gridDim.x) {
    // this tile's halo (and, the first time, the weights) has landed; the
    // barrier also ends every warp's reads of the slot refilled next
    mma_s8::cp_async_wait<0>();
    __syncthreads();
    const int next = tile + gridDim.x;
    if (next < p.tiles)
      stage_halo<1>(p, halo + ((it + 1) & 1) * p.halo_bytes, next);
    mma_s8::cp_async_commit();

    const uint32_t hs = smem_addr(halo + (it & 1) * p.halo_bytes);
    int base[kWarpFrags];  // halo pixel of this lane's A row at tap (0, 0)
#pragma unroll
    for (int i = 0; i < kWarpFrags; ++i) {
      const int f = warp * kWarpFrags + i;
      const int fr = f / frow;
      base[i] = fr * hw + 16 * (f - fr * frow) + aj;
    }
    int32_t acc[kWarpFrags][NG][4];
    int32_t ps[kWarpFrags][4];
#pragma unroll
    for (int i = 0; i < kWarpFrags; ++i) {
#pragma unroll
      for (int q = 0; q < NG; ++q)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][q][r] = 0;
#pragma unroll
      for (int r = 0; r < 4; ++r) ps[i][r] = 0;
    }

    int kstep = 0;
#pragma unroll 1
    for (int fh = 0; fh < p.FH; ++fh) {
#pragma unroll 1
      for (int fw = 0; fw < p.FW; ++fw) {
        uint32_t arow[kWarpFrags];
        int sw[kWarpFrags];
#pragma unroll
        for (int i = 0; i < kWarpFrags; ++i) {
          const int pix = base[i] + fh * hw + fw;
          arow[i] = hs + pix * p.cpad;
          sw[i] = swizzle(pix, nu);
        }
#pragma unroll 1
        for (int kc = 0; kc < ksteps; ++kc, ++kstep) {
          uint32_t b[NG][2];
          if constexpr (NG == 1) {
            uint32_t r[2];
            ldmatrix_x2(r, ws_s + kstep * 32);
            b[0][0] = r[0];
            b[0][1] = r[1];
          } else {
#pragma unroll
            for (int q = 0; q < NG / 2; ++q) {
              uint32_t r[4];
              ldmatrix_x4(r, ws_s + 16 * q * p.krow + kstep * 32);
              b[2 * q][0] = r[0];
              b[2 * q][1] = r[1];
              b[2 * q + 1][0] = r[2];
              b[2 * q + 1][1] = r[3];
            }
          }
          uint32_t a[kWarpFrags][4];
#pragma unroll
          for (int i = 0; i < kWarpFrags; ++i)
            ldmatrix_x4(a[i], arow[i] + (((2 * kc + achunk) ^ sw[i]) << 4));
#pragma unroll
          for (int i = 0; i < kWarpFrags; ++i) {
#pragma unroll
            for (int q = 0; q < NG; ++q)
              mma_m16n8k32<false, false>(acc[i][q], a[i], b[q][0], b[q][1]);
            if constexpr (FUSED)
              mma_m16n8k32<false, false>(ps[i], a[i], kOnes, kOnes);
          }
        }
      }
    }

    // d_r of group q of fragment i is out[pixel g + 8 (r >> 1) of the
    // fragment][co0 + 8 q + 2 t + (r & 1)]; psum is ps[i][0] (pixel g)
    // and ps[i][2] (pixel g + 8)
    int n, oh0, ow0;
    tile_origin(p, tile, n, oh0, ow0);
    const bool pair = (p.CO & 1) == 0;
#pragma unroll
    for (int i = 0; i < kWarpFrags; ++i) {
      const int f = warp * kWarpFrags + i;
      const int fr = f / frow;
      const int oh = oh0 + fr;
      if (oh >= p.HO) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ow = ow0 + 16 * (f - fr * frow) + g + 8 * h;
        if (ow >= p.WO) continue;
        const size_t o =
            ((static_cast<size_t>(n) * p.HO + oh) * p.WO + ow) * p.CO;
        float pv = 0.f;
        if constexpr (FUSED)
          pv = __fmul_rn(wzp, __int2float_rn(ps[i][2 * h]));
#pragma unroll
        for (int q = 0; q < NG; ++q) {
          const int co = co0 + 8 * q + 2 * t;
          if (co >= p.CO) continue;
          const int32_t v0 = acc[i][q][2 * h], v1 = acc[i][q][2 * h + 1];
          if constexpr (FUSED) {
            const float f0 = __fmul_rn(s, __fsub_rn(__int2float_rn(v0), pv));
            const float f1 = __fmul_rn(s, __fsub_rn(__int2float_rn(v1), pv));
            float* d = static_cast<float*>(p.out) + o + co;
            if (pair && co + 1 < p.CO) {
              *reinterpret_cast<float2*>(d) = make_float2(f0, f1);
            } else {
              d[0] = f0;
              if (co + 1 < p.CO) d[1] = f1;
            }
          } else {
            int32_t* d = static_cast<int32_t*>(p.out) + o + co;
            if (pair && co + 1 < p.CO) {
              *reinterpret_cast<int2*>(d) = make_int2(v0, v1);
            } else {
              d[0] = v0;
              if (co + 1 < p.CO) d[1] = v1;
            }
          }
        }
      }
    }
  }
}

template <int BN, bool FUSED>
cudaError_t launch_variant(const Args& p, int blocks, int smem, int device,
                           cudaStream_t s) {
  void (*kern)(Args) = ulppack_conv2d_mma_kernel<BN, FUSED>;
  static int raised[8] = {0};  // per device, this instantiation
  if (smem > 48 * 1024 && smem > raised[device & 7]) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    raised[device & 7] = smem;
  }
  const dim3 grid(blocks, (p.CO + BN - 1) / BN);
  kern<<<grid, kConvThreads, smem, s>>>(p);
  return cudaGetLastError();
}

template <bool FUSED>
cudaError_t launch_bn(const Args& p, int block_co, int blocks, int smem,
                      int device, cudaStream_t s) {
  switch (block_co) {
    case 8: return launch_variant<8, FUSED>(p, blocks, smem, device, s);
    case 16: return launch_variant<16, FUSED>(p, blocks, smem, device, s);
    case 32: return launch_variant<32, FUSED>(p, blocks, smem, device, s);
    case 64: return launch_variant<64, FUSED>(p, blocks, smem, device, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [N, H, W, Cp] int16 lanes (int16xP2s8, ascending fields); w the
// field-reversed lanes [FH, FW, Cp, CO] (dense 0) or bit-dense int32 words
// [FH, FW, WC, CO] of w_bits-wide fields holding k_full channels (dense 1);
// out [N, HO, WO, CO]: the exact s32 conv (fused 0) or the f32 affine
// dequant of the fused epilogue (fused 1, reading the 0-dim a_scale,
// w_scale (f32) and w_zp (int32)).  pad_top / pad_left zero rows / columns
// precede the image.  max_prod = max_w * max_a of the layout bounds the
// s32 sums.  The plan (block_h x block_w = 512 output pixels a tile,
// block_w 16 or 32; block_co 8/16/32/64 output channels a block;
// block_c = cpad_for(2 Cp) staged bytes a pixel; stages = 2; threads =
// 256; `blocks` persistent blocks along the pixel tiles, at most one per
// tile; smem_bytes = block_co * (FH FW block_c + 16) + 2 * halo slot) must
// match this kernel's layout, or the launch is refused with
// cudaErrorInvalidValue.
REPRO_EXPORT int ulppack_conv2d_mma_launch(
    const void* x, const void* w, void* out, const void* a_scale,
    const void* w_scale, const void* w_zp, int N, int H, int W, int Cp,
    int FH, int FW, int WC, int CO, int HO, int WO, int pad_top,
    int pad_left, int dense, int w_bits, int k_full, int max_prod,
    int fused, int block_h, int block_w, int block_co, int block_c,
    int stages, int threads, int blocks, int smem, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int xrow = 2 * Cp;
  const bool shape_ok =
      N >= 0 && H >= 0 && W >= 0 && Cp >= 1 && FH >= 1 && FW >= 1 &&
      CO >= 0 && HO >= 0 && WO >= 0 && pad_top >= 0 && pad_left >= 0 &&
      (dense ? (w_bits >= 1 && w_bits <= 8 && k_full >= 1 &&
                k_full <= xrow &&
                WC == (k_full + 32 / w_bits - 1) / (32 / w_bits))
             : WC == Cp);
  const bool tile_ok =
      (block_w == 16 || block_w == 32) &&
      block_h * block_w == kTilePixels &&
      (block_co == 8 || block_co == 16 || block_co == 32 ||
       block_co == 64) &&
      stages == kStages && threads == kConvThreads &&
      block_c == cpad_for(xrow);
  if (!shape_ok || !tile_ok || max_prod < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // the s32 sums stay in range
  if (static_cast<long long>(FH) * FW * xrow * max_prod >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long krow = static_cast<long long>(FH) * FW * block_c + 16;
  const long long halo =
      static_cast<long long>(block_h + FH - 1) * (block_w + FW - 1) * block_c;
  const long long need = block_co * krow + kStages * halo;
  if (need > kConvSmemMax || smem != need)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_h = (HO + block_h - 1) / block_h;
  const int tiles_w = (WO + block_w - 1) / block_w;
  const long long tiles = static_cast<long long>(N) * tiles_h * tiles_w;
  if (tiles > (1LL << 31) - 1 || blocks < 1 ||
      blocks > (tiles > 0 ? tiles : 1) ||
      (CO + block_co - 1) / block_co > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (fused && (a_scale == nullptr || w_scale == nullptr || w_zp == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tiles == 0 || CO == 0) return static_cast<int>(cudaSuccess);
  Args p;
  p.x = static_cast<const unsigned char*>(x);
  p.w = w;
  p.out = out;
  p.a_scale = static_cast<const float*>(a_scale);
  p.w_scale = static_cast<const float*>(w_scale);
  p.w_zp = static_cast<const int32_t*>(w_zp);
  p.N = N;
  p.H = H;
  p.W = W;
  p.xrow = xrow;
  p.FH = FH;
  p.FW = FW;
  p.WC = WC;
  p.CO = CO;
  p.HO = HO;
  p.WO = WO;
  p.pad_top = pad_top;
  p.pad_left = pad_left;
  p.dense = dense;
  p.w_bits = w_bits;
  p.cin = dense ? k_full : xrow;
  p.cpad = block_c;
  p.th = block_h;
  p.tw = block_w;
  p.tiles_h = tiles_h;
  p.tiles_w = tiles_w;
  p.tiles = static_cast<int>(tiles);
  p.krow = static_cast<int>(krow);
  p.halo_bytes = static_cast<int>(halo);
  p.cb = mma_s8::copy_bytes(x, xrow);
  p.wvec = reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
           CO % (dense ? 4 : 8) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = fused ? launch_bn<true>(p, block_co, blocks, smem, device, s)
              : launch_bn<false>(p, block_co, blocks, smem, device, s);
  return static_cast<int>(err);
}
