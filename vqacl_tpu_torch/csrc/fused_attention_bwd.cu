// Encoder-attention backward for the VL-T5 joint encoder (K2; with
// `fused_decoder` also the decoder's self- and cross-attention),
// hand-written for Hopper (sm_90a), bound to PyTorch through plain C entry
// points (ctypes).
//
// Replaces the Pallas TPU kernel vqacl_tpu/ops/fused_attention.py
// `_bwd_kernel_batched` (and its serial twin `_bwd_kernel`, same math),
// reached through `_call_bwd` from the custom VJP `fused_attention`. It
// consumes the PRE-dropout probabilities p [B, H*Tq, Sk] f32 saved by the
// training forward K1' (fused_attention_fwd.cu) and regenerates K1''s
// dropout keep mask from the Philox streams of philox.cuh.
//
// Per (batch b, head h), with q, k, v and do upcast to f32:
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
// of 2*B*H*Tq*Sk*dk = 1.54 GFLOP, 1.6 us on the bf16 tensor cores (989
// TFLOP/s) and 23 us as f32 FMAs (67 TFLOP/s). On the tensor cores the
// kernel is bound by memory.
//
// Two routes, by dtype (the wrapper's `bwd_route` picks one and raises
// ValueError for a call neither takes; the C side refuses the same calls
// with cudaErrorInvalidValue):
//
// bf16: `bwd_mma_kernel`, on the tensor cores (mma.sync m16n8k16, bf16
// operands, f32 accumulators); dk a multiple of 16 up to 128, and one
// head's stage (below) within a block's 227 KB of shared memory.
//   - Work is cut into units: one batch row b and `heads` heads of it. A
//     unit's stage holds, per head, the q and do panels [Tqp][dk+8] and
//     the k and v panels [Skp][dk+8] as bf16, copied in with cp.async
//     (16-byte chunks of the rows at stride H*dk), and the ds and pd tiles
//     [Tqp][Skp+8] that the first phase writes for the second, each as a
//     hi and a lo bf16 tile (Tqp, Skp: Tq, Sk rounded up to 16). Rows from Tq and Sk are zero-filled,
//     so padded elements give ds = pd = 0. The 8-element row padding puts
//     the 8 rows an ldmatrix reads on distinct banks. p is read from
//     device memory straight into the accumulator layout (a quad reads 8
//     consecutive floats of a row: float2 pairs when Sk is even, scalars
//     when odd, since p rows are 16-byte aligned only when Sk % 4 == 0).
//     Each input byte is read from device memory once, each output
//     written once; ds and pd never leave the SM.
//   - Phase 1, one warp per 16-row query tile, keys in tiles of 64 (8
//     n-tiles of 8): dp = do·v^T with do's A fragments from ldmatrix and
//     v, stored [key][d], as the column-major B operand (plain ldmatrix).
//     bf16 x bf16 is exact in f32, so dp differs from the plain version
//     only in summation order. Dropout draws one Philox block per four
//     keys, shared by a lane pair (`keep_nibble`, as K1' draws it), and
//     kept dp and p are divided by 1 - rate with `div_keep` (the rounded
//     quotient of a true division). The row sum Σ p·dp goes across the
//     quad (`quad_sum`); ds = p (dp − sum) in f32 registers; ds[:L, :L]
//     is written in f32 to the (b, h) partial, so dbias never sees a
//     bf16 rounding. ds and pd are stored to the tiles as two bf16 terms
//     each (`split_bf16`), and ds, split and packed as A fragments straight
//     from the accumulators, gives dq = ds·k (hi·k + lo·k) with k as the
//     row-major B operand (ldmatrix.trans). With
//     one key tile (Sk <= 64) dp stays in registers; longer rows take two
//     sweeps over the key tiles, the first for the row sum, the second
//     recomputing dp (and the keep bits) for ds.
//   - Phase 2, after __syncthreads(), one warp per 16-key tile: dk =
//     ds^T·q and dv = pd^T·do over the query steps, the A fragments read
//     transposed out of the ds and pd tiles (ldmatrix.trans, hi and lo)
//     and q, do as row-major B operands (ldmatrix.trans). All sums are
//     f32; dq, dk and dv are rounded to bf16 once, when stored.
//   - Numerics: ds and pd reach the tensor cores as hi + lo, two bf16
//     terms (two mma.sync per product), which keep about 16 bits of their
//     f32 mantissa; dp, the row sum, the ds behind dbias and every
//     accumulator stay f32. One bf16 term each was tried first: it
//     matched an emulation of that rounding to the bit, but the sums
//     cancel (k, q and do have both signs), and at the decoder's
//     self-attention shape dq and dk missed chip_smoke.py's bf16 tolerance
//     (atol 1e-2 + rtol 1e-2; PERF.md, PR 5). The second term costs three
//     more products on tensor cores that are far from the bound and a
//     second pair of tiles in shared memory.
//   - Filling the card: `heads` is the largest divisor of H with at most
//     4 query tiles per unit (`bwd_heads`), blocks of at most 4 warps, one
//     unit per block. Encoder (Tq = Sk = 56, dk = 64): one head per unit,
//     960 units at the train shape, 73.7 KB each, so 3 blocks fit on an SM
//     by shared memory. Decoder (Tq = 10): 4 heads per unit, one warp per
//     head in phase 1; 240 units at batch 80.
//     Stage bytes, which ops/fused_attention.py::_bwd_mma_smem must give
//     too (tests/test_torch_bwd_route.py reads these lines):
//       bwd_stage_bytes(1, 56, 56, 64) = 73728    encoder
//       bwd_stage_bytes(4, 10, 10, 64) = 49152    decoder self
//       bwd_stage_bytes(4, 10, 58, 64) = 129024   decoder cross
//       bwd_stage_bytes(1, 40, 300, 64) = 221184  300 keys
//       bwd_stage_bytes(1, 56, 56, 128) = 106496  dk 128
//       bwd_stage_bytes(1, 33, 29, 64) = 38400    ragged
//     Registers per thread (ptxas -v, checked once), no
//     spills in any instance: 167 for dk <= 64 with one key tile (held to
//     170 by its launch bounds, so 3 blocks of 4 warps fit on an SM by
//     registers as by shared memory; 396 resident, so the train shape's
//     960 units take 2.4 waves), 209 for dk <= 64 with longer rows, 235
//     and 247 for dk 128. Fetching a warp's first p and keep bits before
//     the copy wait (as K1' draws its keep bits) was tried and gave
//     nothing (PERF.md, PR 5); so were 1 and 2 heads per unit at the
//     decoder shapes (4 is fastest at the cross shape, within 6 % at the
//     self shape).
//   - Deterministic: no atomics, every output element written once by one
//     warp, so two launches give the same bits.
//
// f32: `bwd_kernel<float>`, scalar f32 FMAs from shared memory. One block
// of 8 warps per (b, h) stages the head's q, k, v and do panels as f32
// (ld = dk + 1), p, pd and a byte keep mask; one warp per query row for
// dp, ds and dq (warp-shuffle row sums), then all threads over the (key,
// column) pairs of dk and dv. It is held back by the shared-memory load
// rate (two loads per FMA); the tensor cores would take f32 only as TF32,
// far outside the f32 tolerance that the tiny-config card == CPU checks
// hold. Its key limit is its block's shared memory (`_bwd_smem`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

#include "mma_sm90.cuh"
#include "philox.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// The scalar kernel is instantiated for f32 only (bf16 takes the tensor
// cores); these keep its body written for any T.
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

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

cudaError_t launch_dbias_reduce(const float* part, float* dbias, int B,
                                int H, int L, cudaStream_t stream) {
  const int n = H * L * L;
  const int threads = 256;
  dbias_reduce_kernel<<<(n + threads - 1) / threads, threads, 0, stream>>>(
      part, dbias, B, H, L);
  return cudaGetLastError();
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
  return launch_dbias_reduce(dbias_part, dbias, B, H, L, stream);
}

// ---- the bf16 route on the tensor cores ----------------------------------

constexpr int kMmaWarps = 4;             // warps per block, at most
constexpr int kKeyTile = 64;             // keys per phase-1 tile (8 n-tiles)
constexpr int kRowPad = 8;               // bf16 elements of row padding
constexpr size_t kSmemLimit = 232448;    // 227 KB a block can use

// Bytes of one unit's stage (kept equal to ops/fused_attention.py::
// `_bwd_mma_smem`; the note at the top lists values that a CPU test holds
// it to): per head the q and do panels [Tqp][dk+8], the k and v panels
// [Skp][dk+8] and the hi and lo tiles of ds and pd [Tqp][Skp+8], all bf16
// (Tqp, Skp: Tq, Sk rounded up to 16).
size_t bwd_stage_bytes(int heads, int Tq, int Sk, int dk) {
  const size_t tqp = (Tq + 15) / 16 * 16;
  const size_t skp = (Sk + 15) / 16 * 16;
  return sizeof(__nv_bfloat16) * heads *
         ((2 * tqp + 2 * skp) * (dk + kRowPad) + 4 * tqp * (skp + kRowPad));
}

// x0, x1 as two bf16 terms each: hi = x rounded to bf16, lo = the rest
// (x - hi, exact in f32) rounded to bf16, packed in pairs as mma operands;
// hi + lo keeps about 16 bits of x's mantissa.
__device__ __forceinline__ void split_bf16(float x0, float x1, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = sm90::pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// Heads per unit: the largest divisor of H whose unit has at most
// kMmaWarps 16-row query tiles and fits a block's shared memory.
int bwd_heads(int Tq, int Sk, int H, int dk) {
  const int tiles = (Tq + 15) / 16;
  for (int d = H; d > 1; --d)
    if (H % d == 0 && d * tiles <= kMmaWarps &&
        bwd_stage_bytes(d, Tq, Sk, dk) <= kSmemLimit)
      return d;
  return 1;
}

// Everything the kernel reads that is the same for the whole launch, worked
// out on the host and passed as one __grid_constant__ parameter (read from
// the constant bank rather than held in registers).
struct BwdArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* p;
  const int* seed;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* part;        // dbias partials [B, H, L, L]; unused when L == 0
  int Tq, Sk, H, d, L, dropout;  // d: the head width
  uint32_t thresh;
  float keep_div;     // 1 - rate: kept p and dp are divided by it
  float keep_rcp;     // 1 / keep_div, rounded to f32
  int heads;          // heads per unit, a divisor of H
  int groups;         // H / heads; unit u is batch row u / groups
  int kd;             // d / 16
  int ld;             // panel row stride, d + 8 elements
  int ldt;            // ds / pd tile row stride, Skp + 8 elements
  int chunks;         // 16-byte chunks per panel row, d / 8
  int rows_per_pass;  // panel rows a block's threads copy at once
  int HD;             // H * d
  int tqp, skp;       // Tq, Sk rounded up to 16
  int qtiles, ktiles; // 16-row query and key tiles per head
  int qitems, kitems; // heads * qtiles, heads * ktiles
  int nkt;            // phase-1 key tiles of kKeyTile keys
  int Lq, Lk;         // min(L, Tq), min(L, Sk)
  int qpanel, kpanel, tpanel;  // elements of one q panel, k panel, tile
};

// Copy unit u's q, do, k and v panels into the stage with cp.async, thread
// (row rr, chunk cc) of each pass; rows from Tq and Sk zero-filled.
__device__ __forceinline__ void stage_unit(const BwdArgs& a, int u,
                                           __nv_bfloat16* smem) {
  const int b = u / a.groups;
  const int h0 = (u - b * a.groups) * a.heads;
  __nv_bfloat16* sq = smem;
  __nv_bfloat16* sdo = sq + a.heads * a.qpanel;
  __nv_bfloat16* sk = sdo + a.heads * a.qpanel;
  __nv_bfloat16* sv = sk + a.heads * a.kpanel;
  const int rr = threadIdx.x / a.chunks;
  if (rr >= a.rows_per_pass) return;
  const int cc = (threadIdx.x - rr * a.chunks) * 8;
  for (int hl = 0; hl < a.heads; ++hl) {
    const size_t col = (size_t)(h0 + hl) * a.d + cc;
    for (int i = rr; i < a.tqp; i += a.rows_per_pass) {
      const bool in = i < a.Tq;
      const size_t off = ((size_t)b * a.Tq + i) * a.HD + col;
      const int dst = hl * a.qpanel + i * a.ld + cc;
      sm90::cp_async16(sq + dst, in ? a.q + off : a.q, in ? 16 : 0);
      sm90::cp_async16(sdo + dst, in ? a.dout + off : a.dout, in ? 16 : 0);
    }
    for (int j = rr; j < a.skp; j += a.rows_per_pass) {
      const bool in = j < a.Sk;
      const size_t off = ((size_t)b * a.Sk + j) * a.HD + col;
      const int dst = hl * a.kpanel + j * a.ld + cc;
      sm90::cp_async16(sk + dst, in ? a.k + off : a.k, in ? 16 : 0);
      sm90::cp_async16(sv + dst, in ? a.v + off : a.v, in ? 16 : 0);
    }
  }
}

// p[i, j], p[i, j+1] of head row block pb (j even), 0 past Tq and Sk: one
// float2 when Sk is even (8-byte aligned), two scalars when it is odd.
__device__ __forceinline__ float2 load_p_pair(const BwdArgs& a,
                                              const float* __restrict__ pb,
                                              int i, int j) {
  float2 r = make_float2(0.0f, 0.0f);
  if (i >= a.Tq || j >= a.Sk) return r;
  const float* row = pb + (size_t)i * a.Sk;
  if ((a.Sk & 1) == 0) return __ldg(reinterpret_cast<const float2*>(row + j));
  r.x = __ldg(row + j);
  if (j + 1 < a.Sk) r.y = __ldg(row + j + 1);
  return r;
}

// Grid (units,), up to kMmaWarps x 32 threads, one unit per block. KD: the
// most 16-wide slices of the head width the instance takes (kd <= KD);
// ONE: a single phase-1 key tile (Skp <= kKeyTile), whose dp and p stay in
// registers from the row sum to ds. The common instance (dk <= 64, one
// key tile) is held to the registers that fit three blocks of 4 warps on
// an SM, as many as its 73.7 KB stage at the encoder shape allows.
template <int KD, bool ONE>
__global__ void __launch_bounds__(kMmaWarps * 32, (KD == 4 && ONE) ? 3 : 1)
bwd_mma_kernel(const __grid_constant__ BwdArgs a) {
  constexpr int NT = kKeyTile / 8;  // n-tiles per phase-1 key tile
  extern __shared__ __align__(16) unsigned char bwd_smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(bwd_smem_raw);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int g = lane >> 2;        // accumulator rows g and g + 8
  const int c2 = (lane & 3) * 2;  // accumulator columns c2 and c2 + 1
  const bool drop = a.dropout;
  const uint32_t s0 = drop ? (uint32_t)a.seed[0] : 0u;

  const int u = blockIdx.x;
  stage_unit(a, u, smem);
  sm90::cp_async_commit();
  const int b = u / a.groups;
  const int h0 = (u - b * a.groups) * a.heads;
  const __nv_bfloat16* sq = smem;
  const __nv_bfloat16* sdo = sq + a.heads * a.qpanel;
  const __nv_bfloat16* sk = sdo + a.heads * a.qpanel;
  const __nv_bfloat16* sv = sk + a.heads * a.kpanel;
  // the hi and lo tiles of ds and pd, [heads][2][Tqp][ldt] each
  __nv_bfloat16* sds = smem + 2 * a.heads * (a.qpanel + a.kpanel);
  __nv_bfloat16* spd = sds + 2 * a.heads * a.tpanel;
  sm90::cp_async_wait<0>();
  __syncthreads();

  // ---- phase 1: dp, ds, pd and dq, one warp per 16-row query tile ----
  for (int t = warp; t < a.qitems; t += nwarps) {
    const int hl = t / a.qtiles;
    const int h = h0 + hl;
    const int r0 = (t - hl * a.qtiles) * 16;
    const int bh = b * a.H + h;
    const float* pb = a.p + (size_t)bh * a.Tq * a.Sk;
    const __nv_bfloat16* hdo = sdo + hl * a.qpanel;
    const __nv_bfloat16* hk = sk + hl * a.kpanel;
    const __nv_bfloat16* hv = sv + hl * a.kpanel;
    __nv_bfloat16* hds = sds + 2 * hl * a.tpanel;
    __nv_bfloat16* hpd = spd + 2 * hl * a.tpanel;

    unsigned df[KD][4];  // do's A fragments
#pragma unroll
    for (int ks = 0; ks < KD; ++ks)
      if (ks < a.kd)
        sm90::ldsm_x4(df[ks], hdo + (r0 + (lane & 7) +
                                     ((lane >> 3) & 1) * 8) * a.ld +
                                  ks * 16 + (lane >> 4) * 8);

    float dp[NT][4];   // dp, then ds, of the key tile
    float pr[NT][4];   // p of the key tile
    uint32_t kb = 0u;  // keep bits: bit 4 nt + e for element e of n-tile nt
    // Key tile kt: p into pr, dp = do v^T with the keep bits applied. The
    // tile's n-tiles from ntv (at or past Skp) are left zero.
    auto tile = [&](int kt, int ntv) {
      const int n0 = kt * kKeyTile;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 pp = load_p_pair(a, pb, r0 + g + 8 * r,
                                        n0 + nt * 8 + c2);
          pr[nt][2 * r] = pp.x;
          pr[nt][2 * r + 1] = pp.y;
        }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[2 * np][e] = dp[2 * np + 1][e] = 0.0f;
        if (2 * np >= ntv) continue;
#pragma unroll
        for (int ks = 0; ks < KD; ++ks) {
          if (ks >= a.kd) continue;
          unsigned bv[4];
          sm90::ldsm_x4(bv, hv + (n0 + np * 16 + (lane & 7) +
                                  (lane >> 4) * 8) * a.ld +
                                ks * 16 + ((lane >> 3) & 1) * 8);
          sm90::mma_bf16(dp[2 * np], df[ks], bv[0], bv[1]);
          sm90::mma_bf16(dp[2 * np + 1], df[ks], bv[2], bv[3]);
        }
      }
      if (!drop) return;
      kb = 0u;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (n0 + nt * 8 >= a.Sk) continue;  // warp-uniform: p is 0 there
        const uint32_t keep =
            philox::keep_nibble(s0, a.thresh, bh, r0, n0 + nt * 8 + c2);
        kb |= keep << (4 * nt);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[nt][e] = (keep >> e) & 1u
                          ? philox::div_keep(dp[nt][e], a.keep_div,
                                             a.keep_rcp)
                          : 0.0f;
      }
    };

    // sweep 1: the row sums Σ_j p dp of rows g and g + 8
    float rs[2] = {0.0f, 0.0f};
    for (int kt = 0; kt < (ONE ? 1 : a.nkt); ++kt) {
      tile(kt, min(NT, (a.skp - kt * kKeyTile) >> 3));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) rs[e >> 1] += pr[nt][e] * dp[nt][e];
    }
    rs[0] = sm90::quad_sum(rs[0]);
    rs[1] = sm90::quad_sum(rs[1]);

    // sweep 2: ds and pd to the tiles, ds[:L, :L] to the partial, dq
    float acc[2 * KD][4];
#pragma unroll
    for (int dt = 0; dt < 2 * KD; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dt][e] = 0.0f;
    for (int kt = 0; kt < (ONE ? 1 : a.nkt); ++kt) {
      const int n0 = kt * kKeyTile;
      const int ntv = min(NT, (a.skp - n0) >> 3);
      if (!ONE) tile(kt, ntv);
      // per 16-key step: ds and pd of its two n-tiles, then dq += ds k
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        if (2 * kk >= ntv) continue;
#pragma unroll
        for (int nt = 2 * kk; nt < 2 * kk + 2; ++nt) {
          const int j = n0 + nt * 8 + c2;
          float pd[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pv = pr[nt][e];
            pd[e] = !drop ? pv
                    : ((kb >> (4 * nt + e)) & 1u)
                        ? philox::div_keep(pv, a.keep_div, a.keep_rcp)
                        : 0.0f;
            dp[nt][e] = pv * (dp[nt][e] - rs[e >> 1]);
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = r0 + g + 8 * r;
            const int at = i * a.ldt + j;
            unsigned hi, lo;
            split_bf16(dp[nt][2 * r], dp[nt][2 * r + 1], hi, lo);
            *reinterpret_cast<unsigned*>(hds + at) = hi;
            *reinterpret_cast<unsigned*>(hds + a.tpanel + at) = lo;
            split_bf16(pd[2 * r], pd[2 * r + 1], hi, lo);
            *reinterpret_cast<unsigned*>(hpd + at) = hi;
            *reinterpret_cast<unsigned*>(hpd + a.tpanel + at) = lo;
            if (i < a.Lq) {
              float* prow = a.part + ((size_t)bh * a.L + i) * a.L;
              if (j < a.Lk) prow[j] = dp[nt][2 * r];
              if (j + 1 < a.Lk) prow[j + 1] = dp[nt][2 * r + 1];
            }
          }
        }
        unsigned fh[4], fl[4];  // ds's A fragment, hi and lo terms
        split_bf16(dp[2 * kk][0], dp[2 * kk][1], fh[0], fl[0]);
        split_bf16(dp[2 * kk][2], dp[2 * kk][3], fh[1], fl[1]);
        split_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1], fh[2], fl[2]);
        split_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3], fh[3], fl[3]);
#pragma unroll
        for (int dt = 0; dt < KD; ++dt) {
          if (dt >= a.kd) continue;
          unsigned bk[4];
          sm90::ldsm_x4_trans(
              bk, hk + (n0 + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                           a.ld + dt * 16 + (lane >> 4) * 8);
          sm90::mma_bf16(acc[2 * dt], fh, bk[0], bk[1]);
          sm90::mma_bf16(acc[2 * dt + 1], fh, bk[2], bk[3]);
          sm90::mma_bf16(acc[2 * dt], fl, bk[0], bk[1]);
          sm90::mma_bf16(acc[2 * dt + 1], fl, bk[2], bk[3]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = r0 + g + 8 * r;
      if (i >= a.Tq) continue;
      __nv_bfloat16* row = a.dq + ((size_t)b * a.Tq + i) * a.HD +
                           (size_t)h * a.d;
#pragma unroll
      for (int dt = 0; dt < 2 * KD; ++dt)
        if (dt < 2 * a.kd)
          *reinterpret_cast<__nv_bfloat162*>(row + dt * 8 + c2) =
              __floats2bfloat162_rn(acc[dt][2 * r], acc[dt][2 * r + 1]);
    }
  }
  __syncthreads();  // the ds and pd tiles are complete

  // ---- phase 2: dk = ds^T q and dv = pd^T do, one warp per 16 keys ----
  for (int t = warp; t < a.kitems; t += nwarps) {
    const int hl = t / a.ktiles;
    const int h = h0 + hl;
    const int j0 = (t - hl * a.ktiles) * 16;
    const __nv_bfloat16* hq = sq + hl * a.qpanel;
    const __nv_bfloat16* hdo = sdo + hl * a.qpanel;
    const __nv_bfloat16* hds = sds + 2 * hl * a.tpanel;
    const __nv_bfloat16* hpd = spd + 2 * hl * a.tpanel;
    float ak[2 * KD][4], av[2 * KD][4];
#pragma unroll
    for (int dt = 0; dt < 2 * KD; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) ak[dt][e] = av[dt][e] = 0.0f;
    for (int i0 = 0; i0 < a.tqp; i0 += 16) {
      // A = ds^T [16 keys][16 queries]: the tile's [query][key] blocks,
      // read transposed
      const int toff = (i0 + (lane & 7) + ((lane >> 4) & 1) * 8) * a.ldt +
                       j0 + ((lane >> 3) & 1) * 8;
      unsigned fs[4], fsl[4], fp[4], fpl[4];  // hi and lo terms
      sm90::ldsm_x4_trans(fs, hds + toff);
      sm90::ldsm_x4_trans(fsl, hds + a.tpanel + toff);
      sm90::ldsm_x4_trans(fp, hpd + toff);
      sm90::ldsm_x4_trans(fpl, hpd + a.tpanel + toff);
      const int poff = (i0 + (lane & 7) + ((lane >> 3) & 1) * 8) * a.ld +
                       (lane >> 4) * 8;
#pragma unroll
      for (int dt = 0; dt < KD; ++dt) {
        if (dt >= a.kd) continue;
        unsigned bq[4], bo[4];
        sm90::ldsm_x4_trans(bq, hq + poff + dt * 16);
        sm90::ldsm_x4_trans(bo, hdo + poff + dt * 16);
        sm90::mma_bf16(ak[2 * dt], fs, bq[0], bq[1]);
        sm90::mma_bf16(ak[2 * dt + 1], fs, bq[2], bq[3]);
        sm90::mma_bf16(ak[2 * dt], fsl, bq[0], bq[1]);
        sm90::mma_bf16(ak[2 * dt + 1], fsl, bq[2], bq[3]);
        sm90::mma_bf16(av[2 * dt], fp, bo[0], bo[1]);
        sm90::mma_bf16(av[2 * dt + 1], fp, bo[2], bo[3]);
        sm90::mma_bf16(av[2 * dt], fpl, bo[0], bo[1]);
        sm90::mma_bf16(av[2 * dt + 1], fpl, bo[2], bo[3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = j0 + g + 8 * r;
      if (j >= a.Sk) continue;
      const size_t off = ((size_t)b * a.Sk + j) * a.HD + (size_t)h * a.d;
#pragma unroll
      for (int dt = 0; dt < 2 * KD; ++dt) {
        if (dt >= 2 * a.kd) continue;
        *reinterpret_cast<__nv_bfloat162*>(a.dk + off + dt * 8 + c2) =
            __floats2bfloat162_rn(ak[dt][2 * r], ak[dt][2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(a.dv + off + dt * 8 + c2) =
            __floats2bfloat162_rn(av[dt][2 * r], av[dt][2 * r + 1]);
      }
    }
  }
}

template <int KD, bool ONE>
cudaError_t launch_mma_instance(BwdArgs a, int B, cudaStream_t stream) {
  const auto kern = bwd_mma_kernel<KD, ONE>;
  a.heads = bwd_heads(a.Tq, a.Sk, a.H, a.d);
  a.groups = a.H / a.heads;
  a.kd = a.d / 16;
  a.ld = a.d + kRowPad;
  a.chunks = a.d / 8;
  a.HD = a.H * a.d;
  a.tqp = (a.Tq + 15) / 16 * 16;
  a.skp = (a.Sk + 15) / 16 * 16;
  a.ldt = a.skp + kRowPad;
  a.qtiles = a.tqp / 16;
  a.ktiles = a.skp / 16;
  a.qitems = a.heads * a.qtiles;
  a.kitems = a.heads * a.ktiles;
  a.nkt = (a.skp + kKeyTile - 1) / kKeyTile;
  a.Lq = std::min(a.L, a.Tq);
  a.Lk = std::min(a.L, a.Sk);
  a.qpanel = a.tqp * a.ld;
  a.kpanel = a.skp * a.ld;
  a.tpanel = a.tqp * a.ldt;
  const int warps = std::min(kMmaWarps, std::max(a.qitems, a.kitems));
  a.rows_per_pass = warps * 32 / a.chunks;
  const size_t smem = bwd_stage_bytes(a.heads, a.Tq, a.Sk, a.d);

  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  // the most dynamic shared memory this instance was allowed on each
  // device (the attribute belongs to a device's context); past the table,
  // it is set at every launch that needs more than 48 KB
  constexpr int kDevices = 64;
  static size_t smem_set[kDevices] = {};
  size_t scratch = 0;
  size_t& allowed = dev < kDevices ? smem_set[dev] : scratch;
  if (smem > 48 * 1024 && smem > allowed) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  kern<<<B * a.groups, warps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// The bf16 route: dk a multiple of 16 up to 128, one head's stage within a
// block's shared memory; anything else is refused.
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const float* p, const int* seed, const void* dout,
                       void* dq, void* dk_out, void* dv, float* dbias_part,
                       float* dbias, int B, int Tq, int Sk, int H, int dk,
                       int L, int dropout, uint32_t thresh, float keep_div,
                       cudaStream_t stream) {
  if (dk % 16 != 0 || dk < 16 || dk > 128 ||
      bwd_stage_bytes(1, Tq, Sk, dk) > kSmemLimit)
    return cudaErrorInvalidValue;
  BwdArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.p = p;
  a.seed = seed;
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk_out);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.part = dbias_part;
  a.Tq = Tq;
  a.Sk = Sk;
  a.H = H;
  a.d = dk;
  a.L = L;
  a.dropout = dropout;
  a.thresh = thresh;
  a.keep_div = keep_div;
  a.keep_rcp = 1.0f / keep_div;
  const bool one = Sk <= kKeyTile;
  const cudaError_t err =
      dk <= 64 ? (one ? launch_mma_instance<4, true>(a, B, stream)
                      : launch_mma_instance<4, false>(a, B, stream))
               : (one ? launch_mma_instance<8, true>(a, B, stream)
                      : launch_mma_instance<8, false>(a, B, stream));
  if (err != cudaSuccess || L == 0) return err;
  return launch_dbias_reduce(dbias_part, dbias, B, H, L, stream);
}

}  // namespace

// K2. dtype: 0 = float32 (scalar route), 1 = bfloat16 (tensor-core route);
// q, k, v, do, dq, dk, dv share it. p is f32 [B, H*Tq, Sk], seed a device
// int32 (read only when dropout is set), dbias_part f32 [B, H, L, L]
// scratch and dbias f32 [H, L, L] (both unused when L == 0). Returns the
// first failing cudaError_t of the two launches; 0 means both were
// accepted.
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
    return (int)launch_mma(q, k, v, p_f, seed_i, dout, dq, dk, dv, part, db,
                           B, Tq, Sk, H, dkv, L, dropout, thresh, keep_div,
                           s);
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
