// K6 on Hopper's int8 tensor cores: the unpacked integer conv2d -- the
// paper's int16 baseline (Fig. 4) -- as a byte-plane implicit GEMM on the
// pixel tile K5 uses (conv_mma.cuh).
//
// Replaces repro/kernels/ulppack_conv2d.py:int_conv2d (Pallas
// `_int_kernel` via `_tiled_conv_call`, pallas_call at :148).  x [N, H, W,
// C] and w [FH, FW, C, CO] hold int8 or int16 values (each operand its own
// width); out is the int32 conv, wrapped mod 2^32 like XLA's s32.  Every
// shape runs here: K is split into channel chunks where the weight block
// and the halo ring do not fit one block's shared memory whole.
//
// The arithmetic.  A 16-bit value splits into a signed high and an
// unsigned low byte, v = 2^8 hi + lo (mma_s8.cuh's plane_hi / plane_lo);
// an int8 value is one signed plane.  The conv of two int16 operands is
//   2^16 sum(hi hi') + 2^8 (sum(hi lo') + sum(lo hi')) + sum(lo lo'),
// each sum on mma.sync.m16n8k32 with the planes' signedness, the two cross
// terms in one s32 accumulator: four MMAs into three accumulators a step
// (int8 x int16: two into two; int8 x int8: one).  PTX does not promise
// that the MMA's s32 sums wrap, so none may leave the int32 range: a
// product adds at most 128^2 (s8 s8), 255 * 128 (u8 s8) or, to the cross
// accumulator, 2 * 128 * 255 a channel.  Where taps * C * that bound could
// reach 2^31, the sums are folded every fold_run (conv_mma.cuh) chunks:
// combined in uint32, added into the thread's own elements of out, and
// restarted (the launcher refuses a plan whose one chunk could reach it).
// After all taps the accumulators are combined with shifts and adds in
// uint32, which is mod 2^32, so the result is the int32 conv wrapped
// exactly as the plain version wraps it.
//
// Bound on Hopper: operations.  At Fig. 4 (x [1, 256, 256, 32] x w [7, 7,
// 32, 32] int16, VALID) the conv is 3.1 G MACs, four byte products each:
// 0.0127 ms at the int8 tensor-core rate, against 0.0037 ms for its bytes.
// The design:
//
// - Implicit GEMM (conv_mma.cuh's tile, as K5): output pixels are the
//   MMA's M (16-pixel runs of one output row, 4 a warp, 512 a tile), output
//   channels its N (groups of 8, block_co 8 or 16 a block: three sets of
//   accumulators leave room for 2 groups), K runs over (tap, channel) 32
//   channels a step, each tap's channels zero-padded to cpc = 32, 64 or a
//   multiple of 128.
// - A halo pixel is staged as XB planes of cpc bytes, interleaved by k
//   step: step s holds channels 32 s .. 32 s + 31 as [hi 32 B | lo 32 B]
//   for int16, which are the raw int16 bytes of those 32 channels in
//   place.  So the halo ring copies x's bytes as they are (cp.async, zero
//   outside the image) and each thread splits the 64-byte groups it copied
//   with prmt after its copies land and before the tile's barrier; no
//   extra pass or barrier.
// - Where it fits, the weight block stays in shared memory: staged once
//   per block as K-major rows of taps * WB * cpc bytes per output channel
//   (the same step order, planes split while staging), each row padded by
//   16 bytes to an odd number of 16-byte units for conflict-free ldmatrix.
//   At Fig. 4: 16 x (49 x 64 + 16) = 50 KB, beside two 53.5 KB halo slots.
// - Wider convs (a separate instantiation, CHUNKED) split C into chunks of
//   cpc = 32, 64 or a multiple of 128 channels (whole k steps of both
//   planes): the ring runs over (tile, chunk) pairs, a slot holding the
//   chunk's weight rows and halo slice, as in K5.  At Fig. 4 with 64
//   int16 channels: 2 chunks of 32 at block_co 16, 208 KB.
// - Persistent blocks walk the 512-pixel tiles, the next tile's halo in
//   flight while the current one is multiplied (one barrier a tile).
// - Ragged edges are masked on store; edge tiles read zero halo pixels.
// - Launch geometry is the planner's (_int_conv_mma_geometry in
//   repro_torch/kernels/plan.py mirrors these constants); the launcher
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
using mma_s8::ldmatrix_x2;
using mma_s8::ldmatrix_x4;
using mma_s8::mma_m16n8k32;
using mma_s8::plane_hi;
using mma_s8::plane_lo;
using mma_s8::smem_addr;
using mma_s8::zero_smem;

struct Args {
  const unsigned char* x;   // [N, H, W, C] int8 / int16 values, as bytes
  const void* w;            // [FH, FW, C, CO] int8 / int16
  int32_t* out;             // [N, HO, WO, CO]
  int N, H, W, C, xrow;     // xrow = C * XB bytes an image pixel
  int FH, FW, CO, HO, WO, pad_top, pad_left;
  int cpc;                  // channels of a staged plane (a tap of W), a
                            // chunk
  int cpad;                 // staged bytes a halo pixel: XB * cpc
  int chunks, run;          // chunks of K a tile; chunks a fold's run
  int th, tw;               // output rows x columns of a pixel tile
  int tiles_h, tiles_w, tiles;
  int krow;                 // bytes of a staged W row (one out channel)
  int halo_bytes;           // bytes of one halo slice
  int slot_bytes;           // bytes of one ring slot
  int cb;                   // x copy bytes (16, 8, 4; 0: 2-byte loads;
                            // 1: byte loads)
  int wvec;                 // weights read 8 channels at a time
};

// The largest |product| an accumulator takes a channel (see the note
// above): s8 x s8, u8 x s8, and the cross sum of two int16 operands.
__host__ __device__ constexpr int max_prod(int xb, int wb) {
  return xb == 2 && wb == 2 ? 2 * 128 * 255
         : xb == 2 || wb == 2 ? 255 * 128
                              : 128 * 128;
}

// d += (x plane px) x (W plane pw): plane 0 of an int16 operand is its
// high byte (signed, weight 2^8), plane 1 its low byte (unsigned); an int8
// operand is one signed plane.  px and pw are unrolled loop indices, so
// the branches fold.
template <int XB, int WB>
__device__ __forceinline__ void mma_planes(int32_t (&d)[4],
                                           const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1, int px,
                                           int pw) {
  const bool xs = XB == 1 || px == 0, ws = WB == 1 || pw == 0;
  if (xs && ws)
    mma_m16n8k32<true, true>(d, a, b0, b1);
  else if (xs)
    mma_m16n8k32<true, false>(d, a, b0, b1);
  else if (ws)
    mma_m16n8k32<false, true>(d, a, b0, b1);
  else
    mma_m16n8k32<false, false>(d, a, b0, b1);
}

// Eight neighbouring output channels co .. co + 7 of w at element `src`
// (zero past CO), each as its 16 bits (int16) or 8 bits (int8).
template <int WB>
__device__ __forceinline__ void load8(const Args& p, size_t src, int co,
                                      uint32_t (&v)[8]) {
  if constexpr (WB == 2) {
    const int16_t* w = static_cast<const int16_t*>(p.w) + src;
    if (p.wvec && co + 8 <= p.CO) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(w));
      const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = (words[j >> 1] >> (16 * (j & 1))) & 0xFFFFu;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = co + j < p.CO ? static_cast<uint16_t>(w[j]) : 0u;
    }
  } else {
    const int8_t* w = static_cast<const int8_t*>(p.w) + src;
    if (p.wvec && co + 8 <= p.CO) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(w));
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = ((j < 4 ? u.x : u.y) >> (8 * (j & 3))) & 0xFFu;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = co + j < p.CO ? static_cast<uint8_t>(w[j]) : 0u;
    }
  }
}

// Stage the weight block's slice for chunk `chunk` [BN][krow]: row co
// holds channel c0 + c (c0 = chunk * cpc) of tap t, plane pw, at byte
// (t * cpc / 32 + c / 32) * 32 WB + 32 pw + c % 32 -- int8's one plane,
// int16's high byte (pw 0) and low byte (pw 1).  Every byte a k step reads
// is written, channels past C and output channels past CO as zero, so a
// slot that held another chunk needs no clearing.  An item is (tap, 4
// channels, 8 output channels): four 8-channel loads, one 4-byte store per
// output channel and plane.
template <int WB, int BN>
__device__ void stage_weights(const Args& p, unsigned char* ws, int co0,
                              int chunk) {
  constexpr int G = BN / 8;
  const int c0 = chunk * p.cpc;
  const int c4n = p.cpc / 4;
  const int items = p.FH * p.FW * c4n * G;
  for (int e = threadIdx.x; e < items; e += kConvThreads) {
    const int cg = e % G, rest = e / G;
    const int c4 = rest % c4n, tap = rest / c4n;
    const int co = co0 + 8 * cg;
    uint32_t hi[8], lo[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) hi[j] = lo[j] = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + 4 * c4 + i;
      if (c >= p.C) break;
      uint32_t v[8];
      load8<WB>(p, (static_cast<size_t>(tap) * p.C + c) * p.CO + co, co, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if constexpr (WB == 2) {
          hi[j] |= (v[j] >> 8) << (8 * i);
          lo[j] |= (v[j] & 0xFFu) << (8 * i);
        } else {
          hi[j] |= v[j] << (8 * i);
        }
      }
    }
    const int c = 4 * c4;
    unsigned char* d = ws + (8 * cg) * p.krow +
                       (tap * (p.cpc >> 5) + (c >> 5)) * 32 * WB + (c & 31);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<uint32_t*>(d + j * p.krow) = hi[j];
      if constexpr (WB == 2)
        *reinterpret_cast<uint32_t*>(d + j * p.krow + 32) = lo[j];
    }
  }
}

// Split the int16 halo groups this thread staged (stage_halo<4>'s items:
// 64 bytes, 32 channels, of one pixel) in place into [hi 32 B | lo 32 B].
__device__ void split_halo(const Args& p, unsigned char* buf) {
  const int hw = p.tw + p.FW - 1;
  const int nu = p.cpad >> 4;
  const int groups = (p.th + p.FH - 1) * hw * nu / 4;
  for (int item = threadIdx.x; item < groups; item += kConvThreads) {
    const int pix = 4 * item / nu, u0 = 4 * item - pix * nu;
    const int sw = swizzle(pix, nu);
    unsigned char* px = buf + pix * p.cpad;
    uint4 r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      r[j] = *reinterpret_cast<const uint4*>(px + (((u0 + j) ^ sw) << 4));
    const uint4 out[4] = {
        make_uint4(plane_hi(r[0].x, r[0].y), plane_hi(r[0].z, r[0].w),
                   plane_hi(r[1].x, r[1].y), plane_hi(r[1].z, r[1].w)),
        make_uint4(plane_hi(r[2].x, r[2].y), plane_hi(r[2].z, r[2].w),
                   plane_hi(r[3].x, r[3].y), plane_hi(r[3].z, r[3].w)),
        make_uint4(plane_lo(r[0].x, r[0].y), plane_lo(r[0].z, r[0].w),
                   plane_lo(r[1].x, r[1].y), plane_lo(r[1].z, r[1].w)),
        make_uint4(plane_lo(r[2].x, r[2].y), plane_lo(r[2].z, r[2].w),
                   plane_lo(r[3].x, r[3].y), plane_lo(r[3].z, r[3].w))};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint4*>(px + (((u0 + j) ^ sw) << 4)) = out[j];
  }
}

// CHUNKED: K in p.chunks channel chunks streamed through the ring (else
// one chunk, the weights resident), a separate instantiation so that the
// resident kernel carries no chunk state.
template <int XB, int WB, int BN, bool CHUNKED>
__global__ void __launch_bounds__(kConvThreads, 1)
int_conv2d_mma_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NG = BN / 8;          // 8-channel groups of the MMA's N
  constexpr int NACC = XB + WB - 1;   // accumulators: 2^8 weights, high first
  constexpr int UPI = XB == 2 ? 4 : 1;  // halo units a thread's item
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int co0 = blockIdx.y * BN;
  const int hw = p.tw + p.FW - 1;
  const int nu = p.cpad >> 4;
  const int ksteps = p.cpc >> 5;   // k32 steps a tap and chunk
  const int frow = p.tw >> 4;      // fragments a tile row
  const int taps = p.FH * p.FW;
  const int chunks = CHUNKED ? p.chunks : 1;

  // resident: [weights][slot 0][slot 1]; chunked: [slot 0][slot 1], each
  // slot [the chunk's weights][its halo slice]
  const int wsb = BN * p.krow;
  unsigned char* ring = smem + (CHUNKED ? 0 : wsb);
  auto ws_of = [&](int s) {
    return CHUNKED ? ring + (s & 1) * p.slot_bytes : smem;
  };
  auto halo_of = [&](int s) {
    return ring + (s & 1) * p.slot_bytes + (CHUNKED ? wsb : 0);
  };

  int tile = blockIdx.x;
  if (tile < p.tiles) stage_halo<UPI>(p, halo_of(0), tile, 0);
  mma_s8::cp_async_commit();
  stage_weights<WB, BN>(p, ws_of(0), co0, 0);

  // this lane's ldmatrix rows, as K5's: A pixel aj of a fragment at 16-byte
  // chunk achunk of a plane's step; B channel row bco at k half bhalf
  const int aj = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int achunk = lane >> 4;
  const int bco = NG == 1 ? (lane & 7) : ((lane >> 4) & 1) * 8 + (lane & 7);
  const int bhalf = (lane >> 3) & 1;
  const bool folds = CHUNKED && p.run < chunks;

  for (int st = 0; tile < p.tiles; tile += gridDim.x) {
    int base[kWarpFrags];  // halo pixel of this lane's A row at tap (0, 0)
#pragma unroll
    for (int i = 0; i < kWarpFrags; ++i) {
      const int f = warp * kWarpFrags + i;
      const int fr = f / frow;
      base[i] = fr * hw + 16 * (f - fr * frow) + aj;
    }
    int32_t acc[kWarpFrags][NG][NACC][4];
#pragma unroll
    for (int i = 0; i < kWarpFrags; ++i)
#pragma unroll
      for (int q = 0; q < NG; ++q)
#pragma unroll
        for (int a = 0; a < NACC; ++a)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][q][a][r] = 0;

    for (int chunk = 0; chunk < chunks; ++chunk, ++st) {
      unsigned char* cur = halo_of(st);
      // this thread's copies of the stage have landed: split them; the
      // barrier then publishes every thread's planes (and the stage's
      // weights) and ends every warp's reads of the slot refilled next
      mma_s8::cp_async_wait<0>();
      if constexpr (XB == 2) split_halo(p, cur);
      __syncthreads();
      const bool more = chunk + 1 < chunks;
      const int ntile = more ? tile : tile + gridDim.x;
      const int nchunk = more ? chunk + 1 : 0;
      if (ntile < p.tiles)
        stage_halo<UPI>(p, halo_of(st + 1), ntile, nchunk * p.cpad);
      mma_s8::cp_async_commit();
      if (CHUNKED && ntile < p.tiles)
        stage_weights<WB, BN>(p, ws_of(st + 1), co0, nchunk);

      const uint32_t hs = smem_addr(cur);
      const uint32_t ws_s =
          smem_addr(ws_of(st)) + bco * p.krow + bhalf * 16;
#pragma unroll 1
      for (int tap = 0; tap < taps; ++tap) {
        const int fh = tap / p.FW, fw = tap - fh * p.FW;
        uint32_t arow[kWarpFrags];
        int sw[kWarpFrags];
#pragma unroll
        for (int i = 0; i < kWarpFrags; ++i) {
          const int pix = base[i] + fh * hw + fw;
          arow[i] = hs + pix * p.cpad;
          sw[i] = swizzle(pix, nu);
        }
#pragma unroll 1
        for (int kc = 0; kc < ksteps; ++kc) {
          const uint32_t wk = ws_s + (tap * ksteps + kc) * 32 * WB;
          uint32_t b[NG][WB][2];
#pragma unroll
          for (int pw = 0; pw < WB; ++pw) {
            if constexpr (NG == 1) {
              uint32_t r[2];
              ldmatrix_x2(r, wk + 32 * pw);
              b[0][pw][0] = r[0];
              b[0][pw][1] = r[1];
            } else {
#pragma unroll
              for (int q = 0; q < NG / 2; ++q) {
                uint32_t r[4];
                ldmatrix_x4(r, wk + 16 * q * p.krow + 32 * pw);
                b[2 * q][pw][0] = r[0];
                b[2 * q][pw][1] = r[1];
                b[2 * q + 1][pw][0] = r[2];
                b[2 * q + 1][pw][1] = r[3];
              }
            }
          }
          uint32_t a[kWarpFrags][XB][4];
#pragma unroll
          for (int i = 0; i < kWarpFrags; ++i)
#pragma unroll
            for (int px = 0; px < XB; ++px)
              ldmatrix_x4(a[i][px],
                          arow[i] +
                              (((2 * XB * kc + 2 * px + achunk) ^ sw[i])
                               << 4));
#pragma unroll
          for (int i = 0; i < kWarpFrags; ++i)
#pragma unroll
            for (int q = 0; q < NG; ++q)
#pragma unroll
              for (int px = 0; px < XB; ++px)
#pragma unroll
                for (int pw = 0; pw < WB; ++pw)
                  mma_planes<XB, WB>(acc[i][q][px + pw], a[i][px],
                                     b[q][pw][0], b[q][pw][1], px, pw);
        }
      }
      if constexpr (CHUNKED) {
        // after a run of chunks whose sums could next reach 2^31 (not the
        // tile's last), a fold: the accumulators combined in uint32 (mod
        // 2^32) and added into this thread's own elements of out, then
        // restarted from 0
        if (folds && more && (chunk + 1) % p.run == 0) {
          const bool first = chunk + 1 == p.run;
          int n, oh0, ow0;
          tile_origin(p, tile, n, oh0, ow0);
#pragma unroll
          for (int i = 0; i < kWarpFrags; ++i) {
            const int f = warp * kWarpFrags + i;
            const int fr = f / frow;
            const int oh = oh0 + fr;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int ow = ow0 + 16 * (f - fr * frow) + g + 8 * h;
              if (oh >= p.HO || ow >= p.WO) continue;
              int32_t* d =
                  p.out + ((static_cast<size_t>(n) * p.HO + oh) * p.WO + ow) *
                              p.CO;
#pragma unroll
              for (int q = 0; q < NG; ++q) {
                const int co = co0 + 8 * q + 2 * t;
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  if (co + e >= p.CO) continue;
                  uint32_t v = first ? 0u : static_cast<uint32_t>(d[co + e]);
#pragma unroll
                  for (int a = 0; a < NACC; ++a)
                    v += static_cast<uint32_t>(acc[i][q][a][2 * h + e])
                         << (8 * (NACC - 1 - a));
                  d[co + e] = static_cast<int32_t>(v);
                }
              }
            }
#pragma unroll
            for (int q = 0; q < NG; ++q)
#pragma unroll
              for (int a = 0; a < NACC; ++a)
#pragma unroll
                for (int r = 0; r < 4; ++r) acc[i][q][a][r] = 0;
          }
        }
      }
    }

    // d_r of group q of fragment i is out[pixel g + 8 (r >> 1) of the
    // fragment][co0 + 8 q + 2 t + (r & 1)]: the accumulators combined in
    // uint32, plus the folded total of a chunked tile that folded
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
#pragma unroll
        for (int q = 0; q < NG; ++q) {
          const int co = co0 + 8 * q + 2 * t;
          if (co >= p.CO) continue;
          uint32_t v0 = 0u, v1 = 0u;
#pragma unroll
          for (int a = 0; a < NACC; ++a) {
            v0 += static_cast<uint32_t>(acc[i][q][a][2 * h])
                  << (8 * (NACC - 1 - a));
            v1 += static_cast<uint32_t>(acc[i][q][a][2 * h + 1])
                  << (8 * (NACC - 1 - a));
          }
          int32_t* d = p.out + o + co;
          const bool both = co + 1 < p.CO;
          if (CHUNKED && folds) {
            v0 += static_cast<uint32_t>(d[0]);
            if (both) v1 += static_cast<uint32_t>(d[1]);
          }
          if (pair && both) {
            *reinterpret_cast<int2*>(d) = make_int2(
                static_cast<int32_t>(v0), static_cast<int32_t>(v1));
          } else {
            d[0] = static_cast<int32_t>(v0);
            if (both) d[1] = static_cast<int32_t>(v1);
          }
        }
      }
    }
  }
}

template <int XB, int WB, int BN, bool C>
cudaError_t launch_variant(const Args& p, int blocks, int smem, int device,
                           cudaStream_t s) {
  void (*kern)(Args) = int_conv2d_mma_kernel<XB, WB, BN, C>;
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

template <int XB, int WB, bool C>  // chunked
cudaError_t launch_bn(const Args& p, int block_co, int blocks, int smem,
                      int device, cudaStream_t s) {
  switch (block_co) {
    case 8: return launch_variant<XB, WB, 8, C>(p, blocks, smem, device, s);
    case 16: return launch_variant<XB, WB, 16, C>(p, blocks, smem, device, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int XB, int WB>
cudaError_t launch_chunked(const Args& p, int block_co, int blocks, int smem,
                           int device, cudaStream_t s) {
  return p.chunks > 1
             ? launch_bn<XB, WB, true>(p, block_co, blocks, smem, device, s)
             : launch_bn<XB, WB, false>(p, block_co, blocks, smem, device, s);
}

}  // namespace

// x [N, H, W, C] and w [FH, FW, C, CO] of x_bytes / w_bytes (1: int8, 2:
// int16) each; out [N, HO, WO, CO] int32, the conv wrapped mod 2^32.
// pad_top / pad_left zero rows / columns precede the image.  The plan
// (block_h x block_w = 512 output pixels a tile, block_w 16 or 32;
// block_co 8 or 16 output channels a block; block_c = x_bytes *
// cpad_for(C) staged bytes a halo pixel; chunk_c = x_bytes * the channels
// of a chunk -- block_c itself for one chunk, else 32, 64 or a multiple of
// 128 channels below cpad_for(C) -- and chunks = ceil(C / those channels);
// one chunk's sums below 2^31; stages = 2; threads = 256; `blocks`
// persistent blocks along the pixel tiles, at most one per tile;
// smem_bytes = one chunk: block_co * (FH FW w_bytes cpad_for(C) + 16) + 2
// halo slots, several: 2 * (block_co * (FH FW w_bytes cpc + 16) + a halo
// slice of chunk_c bytes a pixel)) must match this kernel's layout, or the
// launch is refused with cudaErrorInvalidValue.
REPRO_EXPORT int int_conv2d_mma_launch(
    const void* x, const void* w, void* out, int N, int H, int W, int C,
    int x_bytes, int FH, int FW, int CO, int w_bytes, int HO, int WO,
    int pad_top, int pad_left, int block_h, int block_w, int block_co,
    int block_c, int chunk_c, int chunks, int stages, int threads,
    int blocks, int smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool types_ok =
      (x_bytes == 1 || x_bytes == 2) && (w_bytes == 1 || w_bytes == 2);
  const bool shape_ok = N >= 0 && H >= 0 && W >= 0 && C >= 1 && FH >= 1 &&
                        FW >= 1 && CO >= 0 && HO >= 0 && WO >= 0 &&
                        pad_top >= 0 && pad_left >= 0;
  if (!types_ok || !shape_ok) return static_cast<int>(cudaErrorInvalidValue);
  const int cpc = chunk_c / x_bytes;  // channels of a staged plane, a chunk
  const bool tile_ok =
      (block_w == 16 || block_w == 32) &&
      block_h * block_w == kTilePixels &&
      (block_co == 8 || block_co == 16) && stages == kStages &&
      threads == kConvThreads && block_c == x_bytes * cpad_for(C) &&
      chunk_c == x_bytes * cpc && cpc == cpad_for(cpc) &&
      chunk_c <= block_c && (chunk_c == block_c) == (chunks == 1) &&
      chunks == (C + cpc - 1) / cpc;
  // the s32 sums of one chunk stay in range; longer K folds every run
  const long long taps = static_cast<long long>(FH) * FW;
  const long long run =
      conv_mma::fold_run(taps, C, cpc, max_prod(x_bytes, w_bytes), chunks);
  if (!tile_ok || run < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long krow = taps * w_bytes * cpc + 16;
  const long long halo =
      static_cast<long long>(block_h + FH - 1) * (block_w + FW - 1) * chunk_c;
  const long long slot = chunks == 1 ? halo : block_co * krow + halo;
  const long long need = (chunks == 1 ? block_co * krow : 0) + kStages * slot;
  if (need > kConvSmemMax || smem != need)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_h = (HO + block_h - 1) / block_h;
  const int tiles_w = (WO + block_w - 1) / block_w;
  const long long tiles = static_cast<long long>(N) * tiles_h * tiles_w;
  if (tiles > (1LL << 31) - 1 || blocks < 1 ||
      blocks > (tiles > 0 ? tiles : 1) ||
      (CO + block_co - 1) / block_co > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tiles == 0 || CO == 0) return static_cast<int>(cudaSuccess);
  Args p;
  p.x = static_cast<const unsigned char*>(x);
  p.w = w;
  p.out = static_cast<int32_t*>(out);
  p.N = N;
  p.H = H;
  p.W = W;
  p.C = C;
  p.xrow = C * x_bytes;
  p.FH = FH;
  p.FW = FW;
  p.CO = CO;
  p.HO = HO;
  p.WO = WO;
  p.pad_top = pad_top;
  p.pad_left = pad_left;
  p.cpc = cpc;
  p.cpad = chunk_c;
  p.chunks = chunks;
  p.run = static_cast<int>(run < chunks ? run : chunks);
  p.th = block_h;
  p.tw = block_w;
  p.tiles_h = tiles_h;
  p.tiles_w = tiles_w;
  p.tiles = static_cast<int>(tiles);
  p.krow = static_cast<int>(krow);
  p.halo_bytes = static_cast<int>(halo);
  p.slot_bytes = static_cast<int>(slot);
  // 2-byte loads need an even row and base, else bytes
  p.cb = mma_s8::copy_bytes(x, p.xrow);
  if (p.cb == 0 && (p.xrow % 2 || reinterpret_cast<uintptr_t>(x) % 2))
    p.cb = 1;
  p.wvec = reinterpret_cast<uintptr_t>(w) % (8 * w_bytes) == 0 &&
           CO % 8 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bytes == 1 && w_bytes == 1)
    err = launch_chunked<1, 1>(p, block_co, blocks, smem, device, s);
  else if (x_bytes == 1)
    err = launch_chunked<1, 2>(p, block_co, blocks, smem, device, s);
  else if (w_bytes == 1)
    err = launch_chunked<2, 1>(p, block_co, blocks, smem, device, s);
  else
    err = launch_chunked<2, 2>(p, block_co, blocks, smem, device, s);
  return static_cast<int>(err);
}
