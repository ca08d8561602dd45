// K1: fused runtime quantize + P1 pack + lattice row sums.
//
// Replaces the Pallas kernel repro/kernels/quant_pack.py:quantize_pack
// (`_kernel`, pallas_call at :86): ops.quantize_pack at every layout, and
// ops.quantized_linear at the layouts that run the CUDA-core K2 (at
// int16xP2s8, the serving layout, the tensor-core K2 folds this pass into
// its staging: QuantA in mma_s8.cuh).  For float activations x [M, K]
// (f32, bf16 or f16, read in their own type and widened to f32 in
// registers, exactly, as the reference's astype(float32)):
//   q = clip(rint(x / scale) + zp, 0, 2^a_bits - 1)
//   lanes[m, j] = sum_f q[m, j*n_pack + f] << (shift * f)   (ascending fields)
//   row_sums[m] = sum_k q[m, k]
// Columns past K (the ragged tail of the last lane) contribute q = 0, which
// is what the reference's `-scale*zp` pad fill quantizes to.
//
// Bound on Hopper: bytes (one read per element, a lane write per
// n_pack elements); the arithmetic is a handful of ops per element.  Design:
// one block per row, threads walk the row's lanes, each thread reading its
// n_pack neighbouring floats, so a warp reads one contiguous span.  The row
// sum is a warp-shuffle + shared-memory block reduction.  Division is IEEE
// round-to-nearest (__fdiv_rn, no fast math) and rounding is half-to-even
// (rintf), the rules jnp.round/XLA use, so lattices are bit-equal to the
// reference.  scale and zp are read from device memory: no host sync.

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "common.cuh"

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename X, typename Lane>
__global__ void quant_pack_kernel(const X* __restrict__ x,
                                  const float* __restrict__ scale_p,
                                  const int32_t* __restrict__ zp_p,
                                  Lane* __restrict__ lanes,
                                  int32_t* __restrict__ row_sums,
                                  int K, int Kp, int n_pack, int shift,
                                  int qmax) {
  const int row = blockIdx.x;
  const float scale = *scale_p;
  const float zp = static_cast<float>(*zp_p);
  const float fmax_q = static_cast<float>(qmax);
  const X* xr = x + static_cast<size_t>(row) * K;
  Lane* lr = lanes + static_cast<size_t>(row) * Kp;

  int32_t sum = 0;
  for (int j = threadIdx.x; j < Kp; j += blockDim.x) {
    uint32_t lane = 0;
    for (int f = 0; f < n_pack; ++f) {
      const int col = j * n_pack + f;
      if (col < K) {
        float q = rintf(__fdiv_rn(to_f32(xr[col]), scale)) + zp;
        q = fminf(fmaxf(q, 0.0f), fmax_q);
        const int32_t qi = static_cast<int32_t>(q);
        lane += static_cast<uint32_t>(qi) << (shift * f);
        sum += qi;
      }
    }
    lr[j] = static_cast<Lane>(static_cast<int32_t>(lane));
  }

  __shared__ int32_t partial[32];
  sum = warp_sum_i32(sum);
  const int warp = threadIdx.x >> 5, lane_id = threadIdx.x & 31;
  if (lane_id == 0) partial[warp] = sum;
  __syncthreads();
  if (warp == 0) {
    const int nw = (blockDim.x + 31) >> 5;
    int32_t v = lane_id < nw ? partial[lane_id] : 0;
    v = warp_sum_i32(v);
    if (lane_id == 0) row_sums[row] = v;
  }
}

template <typename X>
cudaError_t launch_x(const void* x, const float* scale, const int32_t* zp,
                     void* lanes, int32_t* row_sums, int M, int K, int Kp,
                     int lane_bytes, int n_pack, int shift, int qmax,
                     int threads, cudaStream_t s) {
  const dim3 grid(M), block(threads);
  const X* xp = static_cast<const X*>(x);
  switch (lane_bytes) {
    case 1:
      quant_pack_kernel<X, int8_t><<<grid, block, 0, s>>>(
          xp, scale, zp, static_cast<int8_t*>(lanes), row_sums, K, Kp,
          n_pack, shift, qmax);
      break;
    case 2:
      quant_pack_kernel<X, int16_t><<<grid, block, 0, s>>>(
          xp, scale, zp, static_cast<int16_t*>(lanes), row_sums, K, Kp,
          n_pack, shift, qmax);
      break;
    case 4:
      quant_pack_kernel<X, int32_t><<<grid, block, 0, s>>>(
          xp, scale, zp, static_cast<int32_t*>(lanes), row_sums, K, Kp,
          n_pack, shift, qmax);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// x [M, K] of x_kind 0 / 1 / 2 (f32 / bf16 / f16), row-major; lanes [M,
// Kp] of lane_bytes 1 / 2 / 4; row_sums [M] int32; scale (f32) and zp
// (int32) 0-dim on the device.
REPRO_EXPORT int quant_pack_launch(const void* x, const void* scale,
                                   const void* zp, void* lanes,
                                   void* row_sums, int M, int K, int Kp,
                                   int x_kind, int lane_bytes, int n_pack,
                                   int shift, int qmax, int threads,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sf = static_cast<const float*>(scale);
  const int32_t* zi = static_cast<const int32_t*>(zp);
  int32_t* rs = static_cast<int32_t*>(row_sums);
  switch (x_kind) {
    case 0:
      err = launch_x<float>(x, sf, zi, lanes, rs, M, K, Kp, lane_bytes,
                            n_pack, shift, qmax, threads, s);
      break;
    case 1:
      err = launch_x<__nv_bfloat16>(x, sf, zi, lanes, rs, M, K, Kp,
                                    lane_bytes, n_pack, shift, qmax, threads,
                                    s);
      break;
    case 2:
      err = launch_x<__half>(x, sf, zi, lanes, rs, M, K, Kp, lane_bytes,
                             n_pack, shift, qmax, threads, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
