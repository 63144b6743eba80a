// Hopper (sm_90a) helpers for kernels that stage tiles with the Tensor
// Memory Accelerator and multiply them with warpgroup MMA (wgmma): mbarrier
// rings (arrivals also from the other blocks of a thread-block cluster), 2-D
// TMA loads (also multicast to a cluster) and stores, the host's encoding of
// a row-major tensor's map, bulk copies, wgmma descriptors for operands that
// are MN-major or K-major in shared memory (128-byte swizzle), m64n256k16
// bf16 wgmma with f32 accumulators, register hand-over between warpgroups
// (setmaxnreg), named barriers, an L2 eviction hint and the acquire/release
// flags of a cross-block sum. Used by the weight gradient (dw_splitk.cu) and
// the LM-head loss (head_loss.cu).
//
// Shared-memory tiles come from TMA boxes of 64 rows (k) x 64 bf16 (128
// bytes, m or n) with CU_TENSOR_MAP_SWIZZLE_128B: row r of a box lies at
// byte r * 128, its 16-byte chunk c at chunk c ^ (r % 8), and the pattern
// repeats every 8 rows (1024 bytes), so a box must start 1024-byte aligned.
// A K-major operand is such a box with k along its 128-byte rows (m or n
// down the box): its descriptor's stride byte offset is again the step
// between groups of 8 rows (1024 bytes), the leading byte offset is unused
// (one wgmma's 16 k lie inside a row), and the next 16 k start 32 bytes
// further on; the swizzle is applied to the address, so advancing the start
// address is again all a k step needs.
// For such MN-major operands the wgmma descriptor's stride byte offset is the
// step between groups of 8 k rows (1024 bytes) and its leading byte offset the
// step between 64-element columns of boxes along M or N (PTX ISA, "Matrix
// Descriptor Format", canonical MN-major layout ((T,8,m),(8,k)) :
// ((1,T,LBO),(8T,SBO)) in 16-byte units with T = 8 bf16). One wgmma takes 16
// k rows: the next 16 lie 2048 bytes further on, a whole number of swizzle
// periods, so advancing the start address is all a k step needs.
//
// Accumulator layout of wgmma m64nNk16 (f32): thread t of the warpgroup, warp
// w = t / 32, lane l, register i holds row 16w + l/4 + 8 * ((i / 2) % 2) and
// column 8 * (i / 4) + 2 * (l % 4) + (i % 2).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ---- mbarrier -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes initialised barriers visible to every thread and to the TMA unit.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic for this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity `parity` has completed. A barrier starts in
// phase 0; waiting on parity 1 of a fresh barrier returns at once.
// One arrival of this thread on a barrier of its own block.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_u32(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA ------------------------------------------------------------------

// Box at coordinates (c0 innermost, c1) of the tensor `map` describes into
// shared memory at `dst`; completion counts its bytes on `bar`. Elements
// outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// `bytes` (a multiple of 16) of contiguous device memory at `src` into
// shared memory at `dst` (both 16-byte aligned), counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Orders this thread's earlier generic-proxy accesses (an acquire of data
// other blocks wrote) before its later TMA and bulk copies.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// The same box into shared memory at `dst` in every block of the cluster set
// in `mask` (bit i = block rank i), counted on each one's barrier at `bar`'s
// offset.
__device__ __forceinline__ void tma_load_2d_multicast(void* dst,
                                                      const CUtensorMap* map,
                                                      uint64_t* bar, int c0,
                                                      int c1,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "h"(mask)
      : "memory");
}

// Box at coordinates (c0, c1) of `map` written from shared memory at `src`
// (its layout as a load of that box would leave it); the parts outside the
// tensor are not written. Completes with the bulk groups below.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}],"
      " [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

// A 16-byte store, kept in L2 ahead of other lines (evict_last): another
// block reads it back soon.
__device__ __forceinline__ void st_keep(float4* p, float4 v) {
  asm volatile(
      "{\n.reg .b64 pol;\n"
      "createpolicy.fractional.L2::evict_last.b64 pol, 1.0;\n"
      "st.global.L2::cache_hint.v4.f32 [%0], {%1, %2, %3, %4}, pol;\n}\n" ::"l"(
          p),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until the committed bulk stores have finished reading shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Makes this thread's shared-memory writes visible to later TMA and bulk
// stores.
__device__ __forceinline__ void fence_proxy_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- clusters -------------------------------------------------------------

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// One arrival on the barrier at `bar`'s offset in block `rank` of the
// cluster (this block's own included).
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    unsigned rank) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n"
      ::"r"(smem_u32(bar)), "r"(rank)
      : "memory");
}

// ---- wgmma ----------------------------------------------------------------

// Descriptor of an MN-major bf16 operand at shared address `addr` with the
// 128-byte swizzle; lbo and sbo in bytes (see the note at the top).
__device__ __forceinline__ uint64_t desc_mn_sw128(unsigned addr, unsigned lbo,
                                                  unsigned sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// Descriptor of a K-major bf16 operand at shared address `addr` with the
// 128-byte swizzle (see the note at the top).
__device__ __forceinline__ uint64_t desc_k_sw128(unsigned addr) {
  return desc_mn_sw128(addr, 16, 8 * 128);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses to accumulator registers across
// the asynchronous wgmma that owns them.
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= a * b over 64 x 256 x 16: a and b bf16 in shared memory, both
// MN-major (kTrans 1: transpose flags 1, 1) or both K-major (kTrans 0);
// scale_d 0 discards d's old value.
template <int kTrans>
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t a,
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTrans));
}

__device__ __forceinline__ void wgmma_mn(float (&d)[128], uint64_t a,
                                         uint64_t b, int scale_d) {
  wgmma_256<1>(d, a, b, scale_d);
}

__device__ __forceinline__ void wgmma_k(float (&d)[128], uint64_t a,
                                        uint64_t b, int scale_d) {
  wgmma_256<0>(d, a, b, scale_d);
}

// ---- warpgroup registers, named barriers, flags ----------------------------

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Barrier `id` (1..15) over `threads` threads, whole warps.
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// ---- host: tensor maps -----------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

struct EncodeEntry {
  EncodeTiled fn;
  cudaError_t err;
};

// The driver's cuTensorMapEncodeTiled, looked up once.
inline const EncodeEntry& encode_entry() {
  static const EncodeEntry entry = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess &&
        (found != cudaDriverEntryPointSuccess || fn == nullptr))
      err = cudaErrorSymbolNotFound;
    return EncodeEntry{reinterpret_cast<EncodeTiled>(fn), err};
  }();
  return entry;
}

// A row-major [rows, cols] tensor (bf16 or f32) moved in boxes of box_rows x
// box_cols (128 bytes wide) with the 128-byte swizzle; out-of-range elements
// read as zeros and are not written.
inline cudaError_t box_map(CUtensorMap* map, const void* base, int rows,
                           int cols, bool f32, int box_rows) {
  const EncodeEntry& e = encode_entry();
  if (e.err != cudaSuccess) return e.err;
  const int elem = f32 ? 4 : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / elem), (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = e.fn(
      map,
      f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sm90
