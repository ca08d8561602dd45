// K5 on Hopper's int8 tensor cores: the packed conv2d of every layout of
// the family as an implicit GEMM, with the affine dequant of the CNN's
// packed layer fused into its epilogue.
//
// Replaces repro/kernels/ulppack_conv2d.py:ulppack_conv2d (Pallas `_kernel`
// :65-97 via `_tiled_conv_call`, pallas_call at :148).  In the
// overflow-free region its result is the plain integer conv of the
// lattices (ref.conv2d_i32_ref), so the kernel undoes the layout while it
// stages the operands and never multiplies in packed space.  Activations
// are packed ascending: an int16xP2s8 or int32xP4s8 pixel read as bytes
// IS its u8 lattice in channel order (channel NP k + f in byte f of lane
// k), and is staged straight into the halo.  Every other layout (int8xP2s4
// and int16xP4s4's nibbles, int32xP2s8 / int32xP2s16's two fields in four
// bytes) is staged raw into one more slot, and each thread rewrites the
// 16-byte units it staged as lattice bytes into the halo slot of the tile
// after its own cp.async wait and before the tile's barrier (prmt byte
// moves; a shift and a mask for nibbles), so the halo the MMAs read is
// lattice bytes for every layout.  Weights are field-reversed (field f of
// lane k, channel NP k + f, at bit SH (NP - 1 - f)) and are written in
// channel order while they are staged.  The exact lattice conv that K5
// returns is then an ordinary u8 x u8 -> s32 conv with no packed-space
// product and no extraction.  Every conv shape of the family runs here:
// K is split into channel chunks where the weight block and the halo ring
// do not fit the shared memory whole.
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
// - Where it fits beside the halo ring, the weight block stays in shared
//   memory: staged once per block as u8 rows of K = taps * cpad bytes per
//   output channel (K-major, fields written in channel order; the 'dense'
//   store's words are expanded to bytes in the same pass), each row padded
//   by 16 bytes to an odd number of 16-byte units so that ldmatrix reads
//   of 8 channel rows are free of bank conflicts.  49 x 32 x 64 = 100 KB
//   at 32->64.
// - Wider convs (a separate instantiation, CHUNKED) split each pixel's
//   lattice bytes into chunks of cpad = 32, 64 or a multiple of 128 bytes
//   (whole k32 steps; the swizzle stays inside a chunk).  The ring runs
//   over (tile, chunk) pairs: a slot holds the chunk's weight rows (taps *
//   cpad bytes + 16 a channel, staged by the threads' loads since each
//   field is moved to its byte) and its halo slice (cp.async, or the raw
//   slot's slice of whole lanes rewritten), so the next pair is in flight
//   while the current one is multiplied, one barrier a pair.  The MMAs add
//   into the same registers across a tile's chunks; each tile re-reads its
//   weights, from L2.  At Fig. 4 with 128 channels: 4 chunks of 32 bytes
//   at block_co 32, 155 KB.
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
//   promise that the MMA wraps).  Where FH * FW * NP Cp * max_w * max_a
//   could reach 2^31, the sums are folded every fold_run (conv_mma.cuh)
//   chunks: added in uint32 (mod 2^32, as the int32 conv wraps) into the
//   thread's own elements of out (the patch sums into registers) and
//   restarted; the launcher refuses a plan whose one chunk could reach it.
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

// How a staged raw unit of 16 activation bytes becomes lattice bytes.
enum Xform {
  kDirect = 0,   // the bytes are the lattice (int16xP2s8, int32xP4s8)
  kNibbles = 1,  // 4-bit fields in byte order: 32 values (int8xP2s4,
                 // int16xP4s4)
  kP2s8 = 2,     // bytes 0, 1 of each int32 lane: 8 values (int32xP2s8)
  kP2s16 = 3,    // bytes 0, 2 of each int32 lane: 8 values (int32xP2s16)
};

struct Args {
  const unsigned char* x;   // [N, H, W, xrow] lanes (ascending fields)
  const void* w;            // lanes [FH, FW, Cp, CO] (field-reversed), or
                            // bit-dense words [FH, FW, WC, CO] int32
  void* out;                // [N, HO, WO, CO] int32, or f32 when fused
  const float* a_scale;     // 0-dim scalars of the fused epilogue
  const float* w_scale;
  const int32_t* w_zp;
  int N, H, W, xrow;        // xrow = Cp lane_bytes bytes a pixel
  int FH, FW, WC, CO, HO, WO, pad_top, pad_left;
  int dense, w_bits, cin;   // 'dense': w_bits-wide fields, cin channels
  int lane_bytes, n_pack, shift;  // the layout
  int xform;                // Xform of the activations
  int craw;                 // bytes a pixel of the raw slot (xform != 0)
  int cpad;                 // staged bytes a pixel and a tap of W, a chunk
  int chunks, run;          // chunks of K a tile; chunks a fold's run
  int th, tw;               // output rows x columns of a pixel tile
  int tiles_h, tiles_w, tiles;
  int krow;                 // bytes of a staged W row (one out channel)
  int halo_bytes;           // bytes of one halo slice (lattice bytes)
  int slot_bytes;           // bytes of one ring slot
  int cb;                   // x copy bytes (16, 8, 4; 0: 2-byte loads;
                            // 1: byte loads)
  int wvec;                 // weights read 16 bytes at a time
};

// Stage the weight block's slice for chunk `chunk` [BN][krow] as u8
// lattice values: row co holds channel c0 + c of tap t at byte t * cpad +
// c (c0 = chunk * cpad, the chunk's first lattice channel).  The resident
// block (one chunk) is zeroed first and its own lanes or words written, as
// they lie in w (an item's row in w needs no division).  A chunk of
// several writes every byte a k step reads, channels past cin and output
// channels past CO as zero, so a slot that held another chunk needs no
// clearing.  int16xP2s8 lanes and the dense store's words are read 16
// bytes an item (8 lanes or 4 words of neighbouring output channels) where
// the layout allows, in batches of kBatch so that loads overlap; the other
// layouts' lanes one lane an item.
template <int BN, bool CHUNKED>
__device__ void stage_weights(const Args& p, unsigned char* ws, int co0,
                              int chunk) {
  const int taps = p.FH * p.FW;
  const int c0 = chunk * p.cpad;
  constexpr int kBatch = 4;
  if constexpr (!CHUNKED) {
    const int total = BN * p.krow / 16;
    for (int i = threadIdx.x; i < total; i += kConvThreads)
      zero_smem(ws + 16 * i, 16);
    __syncthreads();
  }
  if (!p.dense && !(p.lane_bytes == 2 && p.n_pack == 2)) {
    // any other layout: item (tap, lane, channel co), consecutive threads
    // on consecutive co; field f of lane k is channel n_pack k + f
    const unsigned char* w = static_cast<const unsigned char*>(p.w);
    const int lb = p.lane_bytes, np = p.n_pack, sh = p.shift;
    const uint32_t mask = sh >= 8 ? 0xFFu : (1u << sh) - 1u;
    const int lanes = CHUNKED ? p.cpad / np : p.WC, l0 = c0 / np;
    const int items = taps * lanes * BN;
    for (int e = threadIdx.x; e < items; e += kConvThreads) {
      const int j = e % BN, rest = e / BN;
      const int co = co0 + j;
      if (!CHUNKED && co >= p.CO) continue;
      int row = rest, lane = 0, tap = 0;
      bool in = true;
      if constexpr (CHUNKED) {
        lane = rest % lanes;
        tap = rest / lanes;
        row = tap * p.WC + l0 + lane;
        in = co < p.CO && l0 + lane < p.WC;
      }
      uint32_t lv = 0u;
      if (in) {
        const unsigned char* src =
            w + (static_cast<size_t>(row) * p.CO + co) * lb;
        lv = lb == 4 ? __ldg(reinterpret_cast<const uint32_t*>(src))
             : lb == 2
                 ? static_cast<uint32_t>(
                       __ldg(reinterpret_cast<const unsigned short*>(src)))
                 : static_cast<uint32_t>(__ldg(src));
      }
      if constexpr (!CHUNKED) {
        lane = rest % lanes;
        tap = rest / lanes;
      }
      unsigned char* d = ws + j * p.krow + tap * p.cpad + np * lane;
      for (int f = 0; f < np; ++f)
        d[f] = static_cast<unsigned char>((lv >> (sh * (np - 1 - f))) & mask);
    }
  } else if (!p.dense) {
    // int16xP2s8: item (tap, lane, group of 8 channels); field-reversed
    // lane: channel 2 lane is its high byte, 2 lane + 1 its low byte
    const int16_t* w = static_cast<const int16_t*>(p.w);
    constexpr int G = BN / 8;
    const int lanes = CHUNKED ? p.cpad / 2 : p.WC, l0 = c0 / 2;
    const int items = taps * lanes * G;
    for (int e0 = threadIdx.x; e0 < items; e0 += kBatch * kConvThreads) {
      uint4 v[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int e = e0 + b * kConvThreads;
        v[b] = make_uint4(0u, 0u, 0u, 0u);
        if (e >= items) continue;
        const int cg = e % G, rest = e / G;
        const int co = co0 + 8 * cg;
        int row = rest;
        if constexpr (CHUNKED) {
          const int lane = l0 + rest % lanes;
          if (lane >= p.WC) continue;
          row = rest / lanes * p.WC + lane;
        }
        const size_t src = static_cast<size_t>(row) * p.CO + co;
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
        const int lane = rest % lanes, tap = rest / lanes;
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
    // k * per + f, written where it falls inside the chunk (a word may
    // straddle two chunks when per does not divide 32)
    const int32_t* w = static_cast<const int32_t*>(p.w);
    const int per = 32 / p.w_bits;
    const uint32_t mask = (1u << p.w_bits) - 1u;
    constexpr int G = BN / 4;
    const int k0 = c0 / per;
    const int words = CHUNKED ? (c0 + p.cpad - 1) / per - k0 + 1 : p.WC;
    const int items = taps * words * G;
    for (int e0 = threadIdx.x; e0 < items; e0 += kBatch * kConvThreads) {
      uint4 v[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int e = e0 + b * kConvThreads;
        v[b] = make_uint4(0u, 0u, 0u, 0u);
        if (e >= items) continue;
        const int cg = e % G, rest = e / G;
        const int co = co0 + 4 * cg;
        int row = rest;
        if constexpr (CHUNKED) {
          const int word = k0 + rest % words;
          if (word >= p.WC) continue;
          row = rest / words * p.WC + word;
        }
        const size_t src = static_cast<size_t>(row) * p.CO + co;
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
        const int word = k0 + rest % words, tap = rest / words;
        const uint32_t vals[4] = {v[b].x, v[b].y, v[b].z, v[b].w};
        unsigned char* d = ws + (4 * cg) * p.krow + tap * p.cpad;
        for (int f = 0; f < per; ++f) {
          const int ch = word * per + f;
          if (ch < c0) continue;
          if (ch >= c0 + p.cpad) break;
          const bool real = ch < p.cin;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            d[j * p.krow + ch - c0] = static_cast<unsigned char>(
                real ? (vals[j] >> (p.w_bits * f)) & mask : 0u);
        }
      }
    }
  }
}

// Rewrite the raw units this thread staged (stage_halo<1, true>'s items:
// unit e of the raw slot, pixel e / (craw / 16)) as lattice bytes into the
// halo slot `lat`, at the swizzled units K5's ldmatrix reads.  A raw unit
// of 16 bytes becomes 32 lattice bytes (nibbles: units 2u, 2u + 1) or 8
// (int32 lanes of two fields: half u & 1 of unit u / 2).  Lattice bytes no
// raw unit reaches are never written: the kernel zeroes both halo slots
// once, before its first barrier.
__device__ void convert_halo(const Args& p, const unsigned char* raw,
                             unsigned char* lat) {
  const int hw = p.tw + p.FW - 1;
  const int nur = p.craw >> 4, nu = p.cpad >> 4;
  const int units = (p.th + p.FH - 1) * hw * nur;
  for (int e = threadIdx.x; e < units; e += kConvThreads) {
    const int pix = e / nur, u = e - pix * nur;
    const uint4 v = *reinterpret_cast<const uint4*>(raw + pix * p.craw +
                                                    16 * u);
    unsigned char* px = lat + pix * p.cpad;
    const int sw = swizzle(pix, nu);
    if (p.xform == kNibbles) {
      // byte b of the unit holds values 2b (low nibble) and 2b + 1 (high)
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
      uint32_t o[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t lo = w[i] & 0x0F0F0F0Fu, hi = (w[i] >> 4) & 0x0F0F0F0Fu;
        o[2 * i] = __byte_perm(lo, hi, 0x5140);
        o[2 * i + 1] = __byte_perm(lo, hi, 0x7362);
      }
      *reinterpret_cast<uint4*>(px + (((2 * u) ^ sw) << 4)) =
          make_uint4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<uint4*>(px + (((2 * u + 1) ^ sw) << 4)) =
          make_uint4(o[4], o[5], o[6], o[7]);
    } else {
      // four int32 lanes, values 2k and 2k + 1 in bytes 0 and 1 (s8) or 0
      // and 2 (s16)
      const uint32_t sel = p.xform == kP2s8 ? 0x5410u : 0x6420u;
      *reinterpret_cast<uint2*>(px + (((u >> 1) ^ sw) << 4) + 8 * (u & 1)) =
          make_uint2(__byte_perm(v.x, v.y, sel), __byte_perm(v.z, v.w, sel));
    }
  }
}

// CHUNKED: K in p.chunks channel chunks streamed through the ring (else
// one chunk, the weights resident), a separate instantiation so that the
// resident kernel carries no chunk state.
template <int BN, bool FUSED, bool CHUNKED>
__global__ void __launch_bounds__(kConvThreads, 1)
ulppack_conv2d_mma_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NG = BN / 8;  // 8-channel groups of the MMA's N
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int co0 = blockIdx.y * BN;
  const int hw = p.tw + p.FW - 1;
  const int nu = p.cpad >> 4;
  const int ksteps = p.cpad >> 5;  // k32 steps a tap and chunk
  const int frow = p.tw >> 4;      // fragments a tile row
  const int chunks = CHUNKED ? p.chunks : 1;

  // resident: [weights][slot 0][slot 1]; chunked: [slot 0][slot 1], each
  // slot [the chunk's weights][its halo slice]; then the raw slot (layouts
  // whose lanes are not lattice bytes), whose units are rewritten into the
  // ring's halo slices
  const int wsb = BN * p.krow;
  unsigned char* ring = smem + (CHUNKED ? 0 : wsb);
  unsigned char* raw = ring + kStages * p.slot_bytes;
  const bool conv = p.xform != kDirect;
  auto ws_of = [&](int s) {
    return CHUNKED ? ring + (s & 1) * p.slot_bytes : smem;
  };
  auto halo_of = [&](int s) {
    return ring + (s & 1) * p.slot_bytes + (CHUNKED ? wsb : 0);
  };
  auto stage = [&](int s, int tile, int chunk) {
    if (conv)
      stage_halo<1, true>(p, raw, tile, chunk * p.craw);
    else
      stage_halo<1>(p, halo_of(s), tile, chunk * p.cpad);
  };

  int tile = blockIdx.x;
  if (tile < p.tiles) stage(0, tile, 0);
  mma_s8::cp_async_commit();
  if (conv && !CHUNKED)  // lattice bytes no raw unit reaches stay 0
    for (int i = threadIdx.x; i < kStages * p.halo_bytes / 16;
         i += kConvThreads)
      zero_smem(ring + 16 * i, 16);
  // (the resident staging's first barrier orders the zeroing)
  stage_weights<BN, CHUNKED>(p, ws_of(0), co0, 0);

  // this lane's ldmatrix rows: A pixel aj of a fragment at 16-byte chunk
  // achunk of the step; B channel row bco of a 16-channel pair at k half
  // bhalf (x2 for one group: lanes 0-15, channel lane & 7)
  const int aj = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int achunk = lane >> 4;
  const int bco = NG == 1 ? (lane & 7) : ((lane >> 4) & 1) * 8 + (lane & 7);
  const int bhalf = (lane >> 3) & 1;
  constexpr uint32_t kOnes = 0x01010101u;

  float s = 0.f, wzp = 0.f;
  if constexpr (FUSED) {
    s = __fmul_rn(*p.a_scale, *p.w_scale);
    wzp = __int2float_rn(*p.w_zp);
  }
  const bool folds = CHUNKED && p.run < chunks;

  for (int st = 0; tile < p.tiles; tile += gridDim.x) {
    int base[kWarpFrags];  // halo pixel of this lane's A row at tap (0, 0)
#pragma unroll
    for (int i = 0; i < kWarpFrags; ++i) {
      const int f = warp * kWarpFrags + i;
      const int fr = f / frow;
      base[i] = fr * hw + 16 * (f - fr * frow) + aj;
    }
    int32_t acc[kWarpFrags][NG][4];
    int32_t ps[kWarpFrags][4];
    uint32_t pst[kWarpFrags][2];  // folded patch sums (chunked, fused)
#pragma unroll
    for (int i = 0; i < kWarpFrags; ++i) {
#pragma unroll
      for (int q = 0; q < NG; ++q)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][q][r] = 0;
#pragma unroll
      for (int r = 0; r < 4; ++r) ps[i][r] = 0;
      pst[i][0] = pst[i][1] = 0u;
    }

    for (int chunk = 0; chunk < chunks; ++chunk, ++st) {
      // this stage's halo (and weights) have landed: this thread's raw
      // units are rewritten into slot st & 1 (its last readers, stage
      // st - 2's MMAs, ended at the last barrier); the barrier publishes
      // the slot and ends every warp's reads of the slot (or of the raw
      // slot) refilled next
      mma_s8::cp_async_wait<0>();
      if (conv) convert_halo(p, raw, halo_of(st));
      __syncthreads();
      const bool more = chunk + 1 < chunks;
      const int ntile = more ? tile : tile + gridDim.x;
      const int nchunk = more ? chunk + 1 : 0;
      if (ntile < p.tiles) stage(st + 1, ntile, nchunk);
      mma_s8::cp_async_commit();
      if (CHUNKED && ntile < p.tiles)
        stage_weights<BN, CHUNKED>(p, ws_of(st + 1), co0, nchunk);

      const uint32_t hs = smem_addr(halo_of(st));
      const uint32_t ws_s =
          smem_addr(ws_of(st)) + bco * p.krow + bhalf * 16;
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
                mma_m16n8k32<false, false>(acc[i][q], a[i], b[q][0],
                                           b[q][1]);
              if constexpr (FUSED)
                mma_m16n8k32<false, false>(ps[i], a[i], kOnes, kOnes);
            }
          }
        }
      }
      if constexpr (CHUNKED) {
        // after a run of chunks whose sums could next reach 2^31 (not the
        // tile's last), a fold: the s32 sums added into uint32 totals (mod
        // 2^32, as the int32 conv wraps) held in this thread's own
        // elements of out (the patch sums in registers), then restarted
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
              if constexpr (FUSED)
                pst[i][h] += static_cast<uint32_t>(ps[i][2 * h]);
              if (oh >= p.HO || ow >= p.WO) continue;
              uint32_t* tot =
                  static_cast<uint32_t*>(p.out) +
                  ((static_cast<size_t>(n) * p.HO + oh) * p.WO + ow) * p.CO;
#pragma unroll
              for (int q = 0; q < NG; ++q) {
                const int co = co0 + 8 * q + 2 * t;
#pragma unroll
                for (int e = 0; e < 2; ++e)
                  if (co + e < p.CO)
                    tot[co + e] = (first ? 0u : tot[co + e]) +
                                  static_cast<uint32_t>(acc[i][q][2 * h + e]);
              }
            }
#pragma unroll
            for (int q = 0; q < NG; ++q)
#pragma unroll
              for (int r = 0; r < 4; ++r) acc[i][q][r] = 0;
#pragma unroll
            for (int r = 0; r < 4; ++r) ps[i][r] = 0;
          }
        }
      }
    }

    // d_r of group q of fragment i is out[pixel g + 8 (r >> 1) of the
    // fragment][co0 + 8 q + 2 t + (r & 1)]; psum is ps[i][0] (pixel g)
    // and ps[i][2] (pixel g + 8); a chunked tile that folded adds the
    // uint32 totals
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
          pv = __fmul_rn(wzp, __int2float_rn(static_cast<int32_t>(
                                  static_cast<uint32_t>(ps[i][2 * h]) +
                                  pst[i][h])));
#pragma unroll
        for (int q = 0; q < NG; ++q) {
          const int co = co0 + 8 * q + 2 * t;
          if (co >= p.CO) continue;
          int32_t v0 = acc[i][q][2 * h], v1 = acc[i][q][2 * h + 1];
          if (CHUNKED && folds) {
            const uint32_t* tot = static_cast<const uint32_t*>(p.out) + o;
            v0 = static_cast<int32_t>(static_cast<uint32_t>(v0) + tot[co]);
            if (co + 1 < p.CO)
              v1 = static_cast<int32_t>(static_cast<uint32_t>(v1) +
                                        tot[co + 1]);
          }
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

template <int BN, bool FUSED, bool CHUNKED>
cudaError_t launch_variant(const Args& p, int blocks, int smem, int device,
                           cudaStream_t s) {
  void (*kern)(Args) = ulppack_conv2d_mma_kernel<BN, FUSED, CHUNKED>;
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

template <bool F, bool C>  // fused, chunked
cudaError_t launch_bn(const Args& p, int block_co, int blocks, int smem,
                      int device, cudaStream_t s) {
  switch (block_co) {
    case 8: return launch_variant<8, F, C>(p, blocks, smem, device, s);
    case 16: return launch_variant<16, F, C>(p, blocks, smem, device, s);
    case 32: return launch_variant<32, F, C>(p, blocks, smem, device, s);
    case 64: return launch_variant<64, F, C>(p, blocks, smem, device, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool FUSED>
cudaError_t launch_chunked(const Args& p, int block_co, int blocks, int smem,
                           int device, cudaStream_t s) {
  return p.chunks > 1
             ? launch_bn<FUSED, true>(p, block_co, blocks, smem, device, s)
             : launch_bn<FUSED, false>(p, block_co, blocks, smem, device, s);
}

// The raw-unit rewrite of a layout of lane_bytes bytes and n_pack fields
// `shift` bits apart, or -1 for a layout outside the family.
int xform_of(int lane_bytes, int n_pack, int shift) {
  if (shift == 8 && n_pack == lane_bytes) return kDirect;  // 2x8, 4x8
  if (shift == 4 && n_pack * 4 == 8 * lane_bytes) return kNibbles;  // 2x4, 4x4
  if (lane_bytes == 4 && n_pack == 2 && shift == 8) return kP2s8;
  if (lane_bytes == 4 && n_pack == 2 && shift == 16) return kP2s16;
  return -1;
}

}  // namespace

// x [N, H, W, Cp] lanes of lane_bytes bytes holding n_pack lattice values
// `shift` bits apart (ascending fields; a layout of the family); w the
// field-reversed lanes [FH, FW, Cp, CO] (dense 0) or bit-dense int32 words
// [FH, FW, WC, CO] of w_bits-wide fields holding k_full channels (dense 1);
// out [N, HO, WO, CO]: the s32 conv wrapped mod 2^32 (fused 0) or the f32
// affine dequant of the fused epilogue (fused 1, reading the 0-dim
// a_scale, w_scale (f32) and w_zp (int32)).  pad_top / pad_left zero rows
// / columns precede the image.  max_prod = max_w * max_a of the layout
// bounds the s32 sums.  The plan (block_h x block_w = 512 output pixels a
// tile, block_w 16 or 32; block_co 8/16/32/64 output channels a block;
// block_c = cpad_for(n_pack Cp) staged lattice bytes a pixel; chunk_c the
// bytes of a chunk, block_c itself for one chunk, else 32, 64 or a
// multiple of 128 below it, and chunks = ceil(n_pack Cp / chunk_c); one
// chunk's sums below 2^31; stages = 2; threads = 256; `blocks` persistent
// blocks along the pixel tiles, at most one per tile; smem_bytes = one
// chunk: block_co * (FH FW block_c + 16) + 2 halo slots, several: 2 *
// (block_co * (FH FW chunk_c + 16) + a halo slice), then the raw slot of
// craw bytes a halo pixel for layouts whose lanes are not lattice bytes)
// must match this kernel's layout, or the launch is refused with
// cudaErrorInvalidValue.
REPRO_EXPORT int ulppack_conv2d_mma_launch(
    const void* x, const void* w, void* out, const void* a_scale,
    const void* w_scale, const void* w_zp, int N, int H, int W, int Cp,
    int FH, int FW, int WC, int CO, int HO, int WO, int pad_top,
    int pad_left, int dense, int w_bits, int k_full, int max_prod,
    int lane_bytes, int n_pack, int shift, int fused, int block_h,
    int block_w, int block_co, int block_c, int chunk_c, int chunks,
    int stages, int threads, int blocks, int smem, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int xform = xform_of(lane_bytes, n_pack, shift);
  if (xform < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long xlat = static_cast<long long>(n_pack) * Cp;  // channels
  const int xrow = lane_bytes * Cp;  // bytes of a pixel in x
  const bool shape_ok =
      N >= 0 && H >= 0 && W >= 0 && Cp >= 1 && FH >= 1 && FW >= 1 &&
      CO >= 0 && HO >= 0 && WO >= 0 && pad_top >= 0 && pad_left >= 0 &&
      (dense ? (w_bits >= 1 && w_bits <= 8 && k_full >= 1 &&
                k_full <= xlat &&
                WC == (k_full + 32 / w_bits - 1) / (32 / w_bits))
             : WC == Cp);
  const bool tile_ok =
      (block_w == 16 || block_w == 32) &&
      block_h * block_w == kTilePixels &&
      (block_co == 8 || block_co == 16 || block_co == 32 ||
       block_co == 64) &&
      stages == kStages && threads == kConvThreads &&
      xlat <= (1 << 30) && block_c == cpad_for(static_cast<int>(xlat));
  // one chunk of the whole pixel, or chunks of 32, 64 or a multiple of
  // 128 bytes (whole k32 steps; the swizzle stays inside a chunk)
  const bool chunk_ok =
      chunk_c >= 1 && chunk_c <= block_c &&
      chunk_c == cpad_for(chunk_c) &&
      (chunk_c == block_c) == (chunks == 1) &&
      chunks == (xlat + chunk_c - 1) / chunk_c;
  if (!shape_ok || !tile_ok || !chunk_ok || max_prod < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // the s32 sums of one chunk stay in range; longer K folds every run
  const long long taps = static_cast<long long>(FH) * FW;
  const long long run =
      conv_mma::fold_run(taps, xlat, chunk_c, max_prod, chunks);
  if (run < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long krow = taps * chunk_c + 16;
  const long long pixels =
      static_cast<long long>(block_h + FH - 1) * (block_w + FW - 1);
  const long long halo = pixels * chunk_c;
  const int craw = xform == kDirect ? 0
                   : chunks == 1    ? (xrow + 15) / 16 * 16
                                    : chunk_c * lane_bytes / n_pack;
  const long long slot = chunks == 1 ? halo : block_co * krow + halo;
  const long long need = (chunks == 1 ? block_co * krow : 0) +
                         kStages * slot + pixels * craw;
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
  p.cin = dense ? k_full : static_cast<int>(xlat);
  p.lane_bytes = lane_bytes;
  p.n_pack = n_pack;
  p.shift = shift;
  p.xform = xform;
  p.craw = craw;
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
  p.cb = mma_s8::copy_bytes(x, xrow);
  if (p.cb == 0 && (xrow % 2 != 0 || reinterpret_cast<uintptr_t>(x) % 2 != 0))
    p.cb = 1;  // odd rows of int8 lanes: byte loads
  p.wvec = reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
           CO % (dense ? 4 : 8) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = fused ? launch_chunked<true>(p, block_co, blocks, smem, device, s)
              : launch_chunked<false>(p, block_co, blocks, smem, device, s);
  return static_cast<int>(err);
}
