// Device helpers shared by the port's node-mixing kernels (gwnet_stack.cu,
// gwnet_layer.cu, dcrnn_stack.cu): storage-type conversion and rounding,
// 4-wide loads, and the block-wide small matrix product on CUDA cores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace port {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to the storage type T and back
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// out[r, c] = Σ_k A[r, k]·B[k, c] for r < rows, c < ncols (ncols % 4 == 0,
// B rows 16-byte aligned for float, 8-byte for bf16), handed to
// epi(r, c, acc). Each thread owns RM rows × 4 columns; a warp's threads
// share rows, so A reads are broadcasts and B reads coalesce.
template <int RM, typename TA, typename TB, typename Epi>
__device__ __forceinline__ void matmul(const TA* A, int lda, const TB* B, int ldb,
                                       int rows, int K, int ncols, Epi epi) {
  const int cg = ncols / 4, rg = (rows + RM - 1) / RM;
  for (int item = threadIdx.x; item < rg * cg; item += blockDim.x) {
    const int c = (item % cg) * 4, r0 = (item / cg) * RM;
    const TA* arow[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) arow[i] = A + (size_t)min(r0 + i, rows - 1) * lda;
    float acc[RM][4] = {};
    for (int k = 0; k < K; ++k) {
      float b[4];
      load4(B + (size_t)k * ldb + c, b);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float a = to_f(arow[i][k]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      if (r0 + i < rows) {
#pragma unroll
        for (int j = 0; j < 4; ++j) epi(r0 + i, c + j, acc[i][j]);
      }
    }
  }
}

__device__ __forceinline__ float sigmoidf(float v) { return 1.f / (1.f + expf(-v)); }

}  // namespace port
