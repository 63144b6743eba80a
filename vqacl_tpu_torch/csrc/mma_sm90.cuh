// Warp-level tensor-core and asynchronous-copy helpers shared by the bf16
// routes of the attention forward and backward (fused_attention_fwd.cu,
// fused_attention_bwd.cu) and the weight gradient (dw_splitk.cu): 16-byte
// cp.async staging, ldmatrix fragment loads, mma.sync m16n8k16 (bf16
// operands, f32 accumulators), bf16 packing of accumulators and sums
// across the quad of lanes that shares an accumulator row.
//
// Fragment layouts of mma.m16n8k16.row.col, with g = lane / 4 and
// c = lane % 4 (PTX ISA, "Matrix Fragments for mma.m16n8k16"):
//   A 16x16 row-major, 4 regs: (g, 2c..2c+1), (g+8, 2c..), (g, 2c+8..),
//     (g+8, 2c+8..);
//   B 16x8 column-major, 2 regs: (k 2c..2c+1, n g), (k 2c+8..2c+9, n g);
//   C 16x8 f32, 4 regs: (g, 2c), (g, 2c+1), (g+8, 2c), (g+8, 2c+1).
// ldmatrix x4 reads four 8x8 b16 matrices; lanes 8m..8m+7 give the row
// addresses of matrix m and register m holds that matrix's fragment.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sm90 {

// Copy 16 bytes from device to shared memory; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

// Copy 4 bytes (any 4-byte-aligned address); src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4],
                                        const void* smem_row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem_row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* smem_row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem_row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// c += a * b on the tensor cores: a 16x16 bf16, b 16x8 bf16, c 16x8 f32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to bf16 and packed as one operand register (lo in
// the low half): the A fragment of a product from two accumulator pairs.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&t);
}

// Max and sum over the four lanes (lane % 4) that hold one accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace sm90
