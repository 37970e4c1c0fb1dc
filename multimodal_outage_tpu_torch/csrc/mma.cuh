// Warp-level tensor-core helpers for the bf16 bodies (double_conv.cu,
// dcrnn_stack.cu, gwnet_stack.cu, gwnet_layer.cu): packing, shared-memory
// addresses, ldmatrix fragment loads and the m16n8k16 bf16 mma.sync with
// float32 accumulation.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace port {

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// d += A·B for one m16n8k16 tile: a0..a3 the row-major A fragment, b0/b1
// the column-major B fragment, d the float32 accumulator fragment
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The A fragment of a row-major 16 × 16 bf16 tile in shared memory: lane
// L passes the address of row L % 16, column 8·(L / 16); rows 16-byte
// aligned.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The B fragment of a row-major 16 (k) × 8 (n) bf16 tile in shared
// memory: lane L passes the address of row L % 16; rows 16-byte aligned.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

}  // namespace port
