// Block-level helpers of the bf16 bodies that run one block per (b, t)
// position (gwnet_stack.cu, gwnet_layer.cu): layout arithmetic, cp.async
// staging, the L2 prefetch, bf16 pair stores, the diffusion product on
// mma.sync, and the walk over a warp's accumulator rows.
#pragma once

#include <cstddef>

#include <cuda_bf16.h>

#include "mma.cuh"

namespace port {

using bf16 = __nv_bfloat16;

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int align16(int bytes) { return (bytes + 15) & ~15; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
// 8 bytes, through L1 (cp.async.cg takes only 16)
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Ask L2 for the `bytes` at p, one 128-byte line per thread: block b of
// the grid takes lines b·blockDim …, so the blocks share the work.
__device__ __forceinline__ void prefetch_l2(const void* p, size_t bytes) {
  const size_t step = (size_t)gridDim.x * blockDim.x * 128;
  for (size_t o = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 128; o < bytes; o += step)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(static_cast<const char*>(p) + o));
}

__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// d = Σ_v At[16m + row, v] · term[v, n0 + col] over the KS·16 rows of the
// term: A a transposed support, B the row-major term buffer read by
// ldmatrix.trans, both bf16 in shared memory.
__device__ __forceinline__ void mma_diffuse(float (&d)[1][1][4], const bf16* At, int ld_at, int m,
                                            const bf16* term, int ld_t, int n0, int KS) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int e = 0; e < 4; ++e) d[0][0][e] = 0.f;
  const bf16* a = At + (size_t)(16 * m + (lane & 15)) * ld_at + 8 * (lane >> 4);
  const bf16* bp = term + (size_t)(lane & 15) * ld_t + n0;
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t f[4], b[2];
    ldmatrix_x4(f, a + 16 * ks);
    ldmatrix_x2_trans(b, bp + (size_t)16 * ks * ld_t);
    mma_bf16(d[0][0], f[0], f[1], f[2], f[3], b[0], b[1]);
  }
}

// epi(r, c, v0, v1) for each accumulator row a lane holds in m-tiles
// m0 … m0 + mc − 1 of one n-tile starting at column c0: rows 16(m0 + i) +
// g and + 8, columns c0 + 2t and + 1 (lane = 4g + t)
template <int MPT, typename Epi>
__device__ __forceinline__ void for_pairs(const float (&d)[MPT][1][4], int m0, int mc, int c0,
                                          Epi epi) {
  const int lane = threadIdx.x % 32, c = c0 + 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < MPT; ++i) {
    if (i < mc) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        epi(16 * (m0 + i) + lane / 4 + 8 * hh, c, d[i][0][2 * hh], d[i][0][2 * hh + 1]);
    }
  }
}

}  // namespace port
