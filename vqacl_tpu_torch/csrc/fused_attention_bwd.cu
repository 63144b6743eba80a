// Encoder-attention backward for the VL-T5 joint encoder (K2), hand-written
// for Hopper (sm_90a), bound to PyTorch through plain C entry points
// (ctypes).
//
// Replaces the Pallas TPU kernel vqacl_tpu/ops/fused_attention.py
// `_bwd_kernel_batched` (and its serial twin `_bwd_kernel`, same math),
// reached through `_call_bwd` from the custom VJP `fused_attention`. It
// consumes the PRE-dropout probabilities p [B, H*Tq, Sk] f32 saved by the
// training forward K1' (fused_attention_fwd.cu) and regenerates K1''s
// dropout keep mask from the Philox streams of philox.cuh.
//
// Per (batch b, head h), everything in f32 (q, k, v, do upcast):
//   pd  = keep ? p / (1 - rate) : 0          (pd = p when rate == 0)
//   dv  = pd^T · do                          [Sk, dk]
//   dp  = keep ? (do · v^T) / (1 - rate) : 0 [Tq, Sk]
//   ds  = p ⊙ (dp − Σ_j p ⊙ dp)              [Tq, Sk]
//   dq  = ds · k,  dk = ds^T · q             written in q's dtype
//   dbias[h] = Σ_b ds[:L, :L]                f32, only when L > 0
// The TPU kernel accumulates dbias across its sequential batch grid. Here
// blocks run in parallel, so each block writes its (b, h) share to a
// partial buffer [B, H, L, L] and a second kernel sums the B partials in
// batch order: deterministic, with no atomics. With L == 0 neither dbias
// nor the partials are written. q/dq are [B, Tq, H*dk], k/v/dk/dv
// [B, Sk, H*dk] (the projection GEMMs' layout), and Tq != Sk is allowed
// (decoder cross-attention), as in the forward.
//
// What bounds it on the card. At the train shape (B=80, Tq=Sk=56, H=12,
// dk=64, bf16) it reads q/k/v/do 27.5 MB and p 12.0 MB and writes
// dq/dk/dv 20.6 MB: about 60 MB, 18 us at 3.35 TB/s, against 4 products
// of 2*B*H*Tq*Sk*dk = 1.54 GFLOP in f32 (23 us at the 67 TFLOP/s f32
// rate outside the tensor cores), so an f32 kernel is bound by its
// arithmetic, and one that ran the products on the tensor cores (bf16
// operands, f32 sums) would be bound by memory.
//
// What the design does about it. One block per (b, h) stages the head's
// q, k, v and do panels, p and the keep mask in shared memory, so each
// input element is read from device memory once and each output written
// once; ds never leaves the SM. The arithmetic is scalar f32 FMAs from
// shared memory: one warp per query row for dp, ds and dq (warp-shuffle
// row sums), then all threads over the (key, column) pairs of dk and dv.
// Like K1, this first version is held back by the shared-memory load rate
// (two loads per FMA); tensor-core tiles are work for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Shared memory (f32 unless noted), with ld = dk + 1 so that lanes
// walking rows land on distinct banks:
//   sq  [Tq][ld]   q panel          sdo [Tq][ld]  do panel
//   sk  [Sk][ld]   k panel          sv  [Sk][ld]  v panel
//   sp  [Tq][Sk]   p, overwritten row by row with ds
//   spd [Tq][Sk]   dropped p (pd)
//   sdp [kWarps][Sk]  each warp's dp row
//   skeep [Tq][Sk] uint8 keep mask (only when dropout)
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ p,
           const int* __restrict__ seed, const T* __restrict__ dout,
           T* __restrict__ dq, T* __restrict__ dk_out, T* __restrict__ dv,
           float* __restrict__ dbias_part, int Tq, int Sk, int H, int dk,
           int L, int dropout, uint32_t thresh, float keep_div) {
  extern __shared__ float smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int bh = b * H + h;
  const int HD = H * dk;
  const int ld = dk + 1;
  float* sq = smem;
  float* sdo = sq + (size_t)Tq * ld;
  float* sk = sdo + (size_t)Tq * ld;
  float* sv = sk + (size_t)Sk * ld;
  float* sp = sv + (size_t)Sk * ld;
  float* spd = sp + (size_t)Tq * Sk;
  float* sdp = spd + (size_t)Tq * Sk;
  uint8_t* skeep = reinterpret_cast<uint8_t*>(sdp + (size_t)kWarps * Sk);

  const size_t qoff = (size_t)b * Tq * HD + (size_t)h * dk;
  const size_t koff = (size_t)b * Sk * HD + (size_t)h * dk;
  for (int idx = threadIdx.x; idx < Tq * dk; idx += kThreads) {
    const int i = idx / dk;
    const int d = idx - i * dk;
    sq[i * ld + d] = to_f32(q[qoff + (size_t)i * HD + d]);
    sdo[i * ld + d] = to_f32(dout[qoff + (size_t)i * HD + d]);
  }
  for (int idx = threadIdx.x; idx < Sk * dk; idx += kThreads) {
    const int j = idx / dk;
    const int d = idx - j * dk;
    sk[j * ld + d] = to_f32(k[koff + (size_t)j * HD + d]);
    sv[j * ld + d] = to_f32(v[koff + (size_t)j * HD + d]);
  }
  const float* pb = p + (size_t)bh * Tq * Sk;
  const uint32_t s0 = dropout ? (uint32_t)seed[0] : 0u;
  for (int idx = threadIdx.x; idx < Tq * Sk; idx += kThreads) {
    const int i = idx / Sk;
    const int j = idx - i * Sk;
    const float pij = pb[idx];
    sp[idx] = pij;
    if (dropout) {
      const bool kp = philox::keep(s0, bh, i, j, thresh);
      skeep[idx] = kp;
      spd[idx] = kp ? pij / keep_div : 0.0f;
    } else {
      spd[idx] = pij;
    }
  }
  __syncthreads();

  // dp, ds and dq, one warp per query row
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* wdp = sdp + warp * Sk;
  const int Lq = min(L, Tq);
  const int Lk = min(L, Sk);
  float* part = dbias_part + (size_t)bh * L * L;  // not written when L == 0
  for (int i = warp; i < Tq; i += kWarps) {
    const float* dor = sdo + i * ld;
    float* prow = sp + (size_t)i * Sk;
    float rowsum = 0.0f;
    for (int j = lane; j < Sk; j += 32) {
      const float* vr = sv + j * ld;
      float acc = 0.0f;
      for (int d = 0; d < dk; ++d) acc = fmaf(dor[d], vr[d], acc);
      if (dropout) acc = skeep[i * Sk + j] ? acc / keep_div : 0.0f;
      wdp[j] = acc;
      rowsum += prow[j] * acc;
    }
    rowsum = warp_sum(rowsum);
    for (int j = lane; j < Sk; j += 32) {
      const float ds = prow[j] * (wdp[j] - rowsum);
      prow[j] = ds;
      if (i < Lq && j < Lk) part[i * L + j] = ds;
    }
    __syncwarp();
    T* dqr = dq + qoff + (size_t)i * HD;
    for (int d = lane; d < dk; d += 32) {
      float acc = 0.0f;
      for (int j = 0; j < Sk; ++j) acc = fmaf(prow[j], sk[j * ld + d], acc);
      dqr[d] = from_f32<T>(acc);
    }
    __syncwarp();  // wdp is rewritten by the warp's next row
  }
  __syncthreads();

  // dk = ds^T q and dv = pd^T do, all threads over (key j, column d)
  for (int idx = threadIdx.x; idx < Sk * dk; idx += kThreads) {
    const int j = idx / dk;
    const int d = idx - j * dk;
    float acc_k = 0.0f, acc_v = 0.0f;
    for (int i = 0; i < Tq; ++i) {
      acc_k = fmaf(sp[i * Sk + j], sq[i * ld + d], acc_k);
      acc_v = fmaf(spd[i * Sk + j], sdo[i * ld + d], acc_v);
    }
    dk_out[koff + (size_t)j * HD + d] = from_f32<T>(acc_k);
    dv[koff + (size_t)j * HD + d] = from_f32<T>(acc_v);
  }
}

// dbias[h, i, j] = Σ_b part[b, h, i, j], summed in batch order.
__global__ void dbias_reduce_kernel(const float* __restrict__ part,
                                    float* __restrict__ dbias, int B, int H,
                                    int L) {
  const int n = H * L * L;
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += gridDim.x * blockDim.x) {
    float acc = 0.0f;
    for (int b = 0; b < B; ++b) acc += part[(size_t)b * n + idx];
    dbias[idx] = acc;
  }
}

// The keep mask of every attention element, as K1' and K2 draw it.
__global__ void keep_mask_kernel(const int* __restrict__ seed,
                                 uint8_t* __restrict__ out, int BH, int Tq,
                                 int Sk, uint32_t thresh) {
  const size_t n = (size_t)BH * Tq * Sk;
  const uint32_t s0 = (uint32_t)seed[0];
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int j = (int)(idx % Sk);
    const int i = (int)((idx / Sk) % Tq);
    const int bh = (int)(idx / ((size_t)Sk * Tq));
    out[idx] = philox::keep(s0, bh, i, j, thresh);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* p, const int* seed, const void* dout,
                   void* dq, void* dk_out, void* dv, float* dbias_part,
                   float* dbias, int B, int Tq, int Sk, int H, int dk, int L,
                   int dropout, uint32_t thresh, float keep_div,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * (size_t)Tq * (dk + 1) + 2 * (size_t)Sk * (dk + 1) +
                       2 * (size_t)Tq * Sk + (size_t)kWarps * Sk) +
      (dropout ? (size_t)Tq * Sk : 0);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(H, B);
  bwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), p, seed, static_cast<const T*>(dout),
      static_cast<T*>(dq), static_cast<T*>(dk_out), static_cast<T*>(dv),
      dbias_part, Tq, Sk, H, dk, L, dropout, thresh, keep_div);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || L == 0) return err;
  const int n = H * L * L;
  const int threads = 256;
  dbias_reduce_kernel<<<(n + threads - 1) / threads, threads, 0, stream>>>(
      dbias_part, dbias, B, H, L);
  return cudaGetLastError();
}

}  // namespace

// K2. dtype: 0 = float32, 1 = bfloat16 (q, k, v, do, dq, dk, dv share it);
// p is f32 [B, H*Tq, Sk], seed a device int32 (read only when dropout is
// set), dbias_part f32 [B, H, L, L] scratch and dbias f32 [H, L, L] (both
// unused when L == 0). Returns the first failing cudaError_t of the two
// launches; 0 means both were accepted.
extern "C" int fused_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* p,
                                   const void* seed, const void* dout,
                                   void* dq, void* dk, void* dv,
                                   void* dbias_part, void* dbias, int B,
                                   int Tq, int Sk, int H, int dkv, int L,
                                   int dtype, int dropout,
                                   unsigned int thresh, float keep_div,
                                   void* stream) {
  const float* p_f = static_cast<const float*>(p);
  const int* seed_i = static_cast<const int*>(seed);
  float* part = static_cast<float*>(dbias_part);
  float* db = static_cast<float*>(dbias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, p_f, seed_i, dout, dq, dk, dv, part,
                              db, B, Tq, Sk, H, dkv, L, dropout, thresh,
                              keep_div, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, p_f, seed_i, dout, dq, dk, dv,
                                      part, db, B, Tq, Sk, H, dkv, L, dropout,
                                      thresh, keep_div, s);
  return (int)cudaErrorInvalidValue;
}

// The Philox keep mask [BH, Tq, Sk] (uint8, 1 = kept) that K1' and K2
// apply, for checking the PyTorch copy of the streams on the card.
extern "C" int fused_attention_keep_mask(const void* seed, void* out, int BH,
                                         int Tq, int Sk, unsigned int thresh,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  keep_mask_kernel<<<1024, 256, 0, s>>>(static_cast<const int*>(seed),
                                        static_cast<uint8_t*>(out), BH, Tq, Sk,
                                        thresh);
  return (int)cudaGetLastError();
}

// Message for a cudaError_t returned above.
extern "C" const char* fused_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
