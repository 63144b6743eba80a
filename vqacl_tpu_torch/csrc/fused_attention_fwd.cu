// Encoder-attention forward for the VL-T5 joint encoder, hand-written for
// Hopper (sm_90a), bound to PyTorch through plain C entry points (ctypes).
//
// Replaces the Pallas TPU kernels of vqacl_tpu/ops/fused_attention.py:
//   K1  `_fwd_kernel_batched` (and its serial twin `_fwd_kernel`, same math)
//       through `_call_fwd(save_p=False)`: the inference forward, entry
//       `fused_attention_fwd` (dropout 0, no saved probabilities);
//   K1' `_fwd_kernel_batched_save_p` / `_fwd_kernel_save_p` through
//       `_call_fwd(save_p=True)`: the training forward, entry
//       `fused_attention_fwd_train`. It also writes the PRE-dropout
//       probabilities p [B, H*Tq, Sk] f32 for the backward kernel K2
//       (fused_attention_bwd.cu) and applies dropout from the Philox
//       streams of philox.cuh, which K2 regenerates.
// Both are one template (`kTrain`), so K1' is K1 plus the two extra steps.
//
// Per (batch b, head h), for every query row i:
//   s[j] = q[i]·k[j] in f32 (q, k upcast, UNSCALED T5 attention)
//        + bias[h, i, j]              only when i < min(L,Tq), j < min(L,Sk)
//        + (1 - mask[b, j]) * -1e9    key padding mask
//   p    = softmax(s) in f32                  (K1': stored to p[b, h*Tq+i, j])
//   K1': p = keep(b,h,i,j) ? p / (1 - rate) : 0   when rate > 0
//   p is rounded to v's dtype, then o[i] = p·v with f32 accumulation,
//   written in q's dtype.
// q/o are [B, Tq, H*dk] and k/v [B, Sk, H*dk]: the layout the projection
// GEMMs produce, so the wrapper does no transposes; the head is the
// column panel [h*dk, (h+1)*dk). bias is [H, L, L] f32 (the relative bias
// of the text-text block; the rest of the joint-encoder bias is zero and
// never moves). mask is [B, Sk] f32, 1 = attend. Ragged Tq/Sk are handled
// here, so the wrapper needs no padding to a multiple of 8.
//
// What bounds it on the card. At the eval shape (B=100, Tq=Sk=56, H=12,
// dk=64, bf16) K1 moves q/k/v/o, 4 x 100*56*768*2 B = 34.4 MB, against
// 2*2*100*12*56*56*64 = 0.96 GFLOP: about 28 FLOP/byte, far below the
// H100's ~295 FLOP/byte bf16 ridge, so the least time is set by memory
// bandwidth: 10.3 us at 3.35 TB/s. At the train shape (B=80, S=56) K1'
// moves q/k/v/o 27.5 MB plus p 12.0 MB = 39.6 MB, about 11.8 us at
// 3.35 TB/s, against 0.77 GFLOP. chip_smoke.py prints the measured times
// beside these bounds (PERF.md: this version is far from them).
//
// What the design does about it. Each element of q/k/v is read from
// device memory once and o (and K1's p) written once: the head's K and V
// panels (Sk x dk) are staged in shared memory by the block, and scores
// never leave the SM (the plain PyTorch version writes the [B,H,Tq,Sk]
// scores and probabilities to device memory and transposes q/k/v/o); the
// dropout bits are computed in registers, never stored. The arithmetic is
// scalar f32 FMAs from shared memory -- one block per (b, h), one warp per
// query row, lane-strided keys, warp-shuffle max and sum, each lane owning
// dk/32 output columns. That is a simple first version, and what it
// reaches first is not memory but the shared memory load rate: every FMA
// of q.k and p.v needs two 4-byte shared loads (0.48 G FMAs at the eval
// shape -> ~30 M warp-wide loads, ~115 us at one load per clock per SM).
// Register tiling (several query rows per warp, vector loads), wgmma
// tiles, TMA staging and several heads per block are work for a later
// version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e9f;

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

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Shared memory, all f32:
//   sk   [Sk][dk+1]    K panel; the +1 keeps lane j's row on its own bank
//   sv   [Sk][dk]      V panel; lanes read neighbouring columns
//   sneg [Sk]          additive key mask
//   sq   [kWarps][dk]  the current query row of each warp
//   sp   [kWarps][Sk]  scores, then probabilities, of each warp's row
// kTrain (K1'): also store p, and drop with Philox when `dropout` is set.
template <typename T, bool kTrain>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ bias,
           const float* __restrict__ mask, T* __restrict__ o,
           int Tq, int Sk, int H, int dk, int L, float* __restrict__ p_out,
           const int* __restrict__ seed, int dropout, uint32_t thresh,
           float keep_div) {
  extern __shared__ float smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int HD = H * dk;
  const int ks = dk + 1;
  float* sk = smem;
  float* sv = sk + (size_t)Sk * ks;
  float* sneg = sv + (size_t)Sk * dk;
  float* sq = sneg + Sk;
  float* sp = sq + kWarps * dk;

  const T* kb = k + (size_t)b * Sk * HD + (size_t)h * dk;
  const T* vb = v + (size_t)b * Sk * HD + (size_t)h * dk;
  for (int idx = threadIdx.x; idx < Sk * dk; idx += kThreads) {
    const int j = idx / dk;
    const int d = idx - j * dk;
    sk[j * ks + d] = to_f32(kb[(size_t)j * HD + d]);
    sv[j * dk + d] = to_f32(vb[(size_t)j * HD + d]);
  }
  for (int j = threadIdx.x; j < Sk; j += kThreads)
    sneg[j] = (1.0f - mask[(size_t)b * Sk + j]) * kNegInf;
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* wq = sq + warp * dk;
  float* wp = sp + warp * Sk;
  const int Lq = min(L, Tq);
  const int Lk = min(L, Sk);
  const float* hbias = bias + (size_t)h * L * L;  // not read when L == 0
  const uint32_t s0 = (kTrain && dropout) ? (uint32_t)seed[0] : 0u;
  const int bh = b * H + h;

  for (int i = warp; i < Tq; i += kWarps) {
    const T* qrow = q + ((size_t)b * Tq + i) * HD + (size_t)h * dk;
    for (int d = lane; d < dk; d += 32) wq[d] = to_f32(qrow[d]);
    __syncwarp();

    float m = -INFINITY;
    for (int j = lane; j < Sk; j += 32) {
      const float* kr = sk + j * ks;
      float s = 0.0f;
      for (int d = 0; d < dk; ++d) s = fmaf(wq[d], kr[d], s);
      if (i < Lq && j < Lk) s += hbias[i * L + j];
      s += sneg[j];
      wp[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < Sk; j += 32) {
      const float e = expf(wp[j] - m);
      wp[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < Sk; j += 32) {
      float pj = wp[j] / sum;
      if (kTrain) {
        p_out[((size_t)bh * Tq + i) * Sk + j] = pj;  // pre-dropout
        if (dropout)
          pj = philox::keep(s0, bh, i, j, thresh) ? pj / keep_div : 0.0f;
      }
      wp[j] = to_f32(from_f32<T>(pj));  // p cast to v's dtype
    }
    __syncwarp();

    T* orow = o + ((size_t)b * Tq + i) * HD + (size_t)h * dk;
    for (int d = lane; d < dk; d += 32) {
      float acc = 0.0f;
      for (int j = 0; j < Sk; ++j) acc = fmaf(wp[j], sv[j * dk + d], acc);
      orow[d] = from_f32<T>(acc);
    }
    __syncwarp();  // wq/wp are rewritten by the next row
  }
}

template <typename T, bool kTrain>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* bias, const float* mask, void* o, int B,
                   int Tq, int Sk, int H, int dk, int L, float* p,
                   const int* seed, int dropout, uint32_t thresh,
                   float keep_div, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)Sk * (dk + 1) + (size_t)Sk * dk + Sk + (size_t)kWarps * dk +
       (size_t)kWarps * Sk);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fwd_kernel<T, kTrain>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(H, B);
  fwd_kernel<T, kTrain><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, mask, static_cast<T*>(o), Tq, Sk, H, dk,
      L, p, seed, dropout, thresh, keep_div);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).
// Returns the cudaError_t of the launch; 0 means it was accepted.
extern "C" int fused_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* bias,
                                   const void* mask, void* o, int B, int Tq,
                                   int Sk, int H, int dk, int L, int dtype,
                                   void* stream) {
  const float* bias_f = static_cast<const float*>(bias);
  const float* mask_f = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float, false>(q, k, v, bias_f, mask_f, o, B, Tq, Sk, H,
                                     dk, L, nullptr, nullptr, 0, 0u, 1.0f, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16, false>(q, k, v, bias_f, mask_f, o, B, Tq,
                                             Sk, H, dk, L, nullptr, nullptr, 0,
                                             0u, 1.0f, s);
  return (int)cudaErrorInvalidValue;
}

// K1': as above, and also p [B, H*Tq, Sk] f32 (pre-dropout). With
// dropout != 0, element (b, h, i, j) is kept when its Philox bits (key
// seed[0], a device int32) are below `thresh`, and kept p is divided by
// keep_div = 1 - rate (both computed by the wrapper as the Pallas kernel
// does).
extern "C" int fused_attention_fwd_train(const void* q, const void* k,
                                         const void* v, const void* bias,
                                         const void* mask, const void* seed,
                                         void* o, void* p, int B, int Tq,
                                         int Sk, int H, int dk, int L,
                                         int dtype, int dropout,
                                         unsigned int thresh, float keep_div,
                                         void* stream) {
  const float* bias_f = static_cast<const float*>(bias);
  const float* mask_f = static_cast<const float*>(mask);
  const int* seed_i = static_cast<const int*>(seed);
  float* p_f = static_cast<float*>(p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float, true>(q, k, v, bias_f, mask_f, o, B, Tq, Sk, H,
                                    dk, L, p_f, seed_i, dropout, thresh,
                                    keep_div, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16, true>(q, k, v, bias_f, mask_f, o, B, Tq,
                                            Sk, H, dk, L, p_f, seed_i, dropout,
                                            thresh, keep_div, s);
  return (int)cudaErrorInvalidValue;
}

// Message for a cudaError_t returned above.
extern "C" const char* fused_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
