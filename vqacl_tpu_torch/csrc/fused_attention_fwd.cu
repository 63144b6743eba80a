// Encoder-attention forward for the VL-T5 joint encoder (and, with
// `fused_decoder`, the decoder's self- and cross-attention), hand-written
// for Hopper (sm_90a), bound to PyTorch through plain C entry points
// (ctypes).
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
//
// Per (batch b, head h), for every query row i:
//   s[j] = q[i]·k[j] in f32 (UNSCALED T5 attention)
//        + bias[h, i, j]              only when i < min(L,Tq), j < min(L,Sk)
//        + (1 - mask[b, j]) * -1e9    key padding mask
//   p    = softmax(s) in f32                  (K1': stored to p[b, h*Tq+i, j])
//   K1': p = keep(b,h,i,j) ? p / (1 - rate) : 0   when rate > 0
//   p is rounded to v's dtype, then o[i] = p·v with f32 accumulation,
//   written in q's dtype.
// q/o are [B, Tq, H*dk] and k/v [B, Sk, H*dk]: the layout the projection
// GEMMs produce, so the wrapper does no transposes; the head is the
// column panel [h*dk, (h+1)*dk). bias is [H, L, L] f32 (the relative bias
// of the text-text block, or the decoder's whole causal + relative block;
// the rest is zero and never moves). mask is [B, Sk] f32, 1 = attend.
// Ragged Tq/Sk are handled here, so the wrapper pads nothing.
//
// What bounds it on the card. At the eval shape (B=100, Tq=Sk=56, H=12,
// dk=64, bf16) K1 moves q/k/v/o, 4 x 100*56*768*2 B = 34.4 MB, against
// 2*2*100*12*56*56*64 = 0.96 GFLOP: about 28 FLOP/byte, far below the
// H100's ~295 FLOP/byte bf16 ridge, so the least time is set by memory:
// 10.3 us at 3.35 TB/s. At the train shape (B=80, S=56) K1' moves q/k/v/o
// 27.5 MB plus p 12.0 MB = 39.6 MB, 11.8 us. At the decoder shapes (B=80,
// T=10; cross-attention 10 x 58) the bounds are 1.5-5.7 us, about one
// kernel launch: there the time is launch and latency, and the design's
// job is to put enough independent warps on the card.
//
// Two routes, by dtype (the wrapper's `fwd_route` picks one and raises
// ValueError for a call neither takes; the C side refuses the same calls
// with cudaErrorInvalidValue):
//
// bf16: `fwd_mma_kernel`, on the tensor cores (mma.sync m16n8k16, bf16
// operands, f32 accumulators); dk a multiple of 16 up to 128, and one
// head's stage (below) within a block's 227 KB of shared memory.
//   - Work is cut into units: one batch row b and `heads` heads of it,
//     each head in 16-row query tiles, one warp per tile. A unit's stage
//     holds its K and V panels [Skp][dk+8] and Q tiles [Tqp][dk+8] as bf16
//     and its key mask [Skp] f32, copied in with cp.async (16-byte chunks
//     of the 128-byte rows at stride H*dk; the mask 4 bytes at a time).
//     The 8-element row padding puts the 8 rows an ldmatrix reads on
//     distinct banks. Key rows from Sk up to Skp (Sk rounded up to 16) and
//     query rows from Tq are zero-filled: stale shared memory in V would
//     give 0 x NaN. Each input byte is read from device memory once.
//   - Blocks are persistent when the units do not fit on the card at once:
//     as many blocks as fit (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
//     the units spread evenly over them, two stages each, so the next
//     unit's copy overlaps this one's arithmetic. Otherwise one unit per
//     block and one stage.
//   - S = Q K^T: Q's A fragments come from ldmatrix; K, stored [key][d], is
//     already the column-major B operand, read with a plain ldmatrix.
//     bf16 x bf16 is exact in f32, so S differs from the plain version only
//     in summation order. The bias is read from device memory (L1/L2) for
//     i < L, j < L; keys j >= Sk are -INF.
//   - Softmax in registers: a thread holds rows g and g+8 (g = lane/4) and
//     two adjacent columns of each 8-key n-tile; row max and sum go across
//     the quad with __shfl_xor_sync 1, 2, with expf as in the plain
//     version, and p = e * (1/sum). Keys come in tiles: for Sk <= 64 one
//     tile of 8 n-tiles (32 f32 registers), else tiles of 128 keys; with
//     one tile the whole row stays in registers, longer rows take a first
//     sweep for the row max and sum (online rescaling) and a second that
//     recomputes S, normalises, stores p and multiplies. N-tiles whose
//     keys are all past Sk (keys 56..63 at Sk = 56) skip the softmax,
//     the stores and the dropout draw.
//   - K1' extras, straight from the accumulators: p is stored as float2 (a
//     quad writes 8 consecutive floats of a row, one 32-byte sector) when
//     Sk is even, as scalars when it is odd. Dropout draws one
//     Philox4x32-10 block per thread and n-tile: the lanes of a pair share
//     a counter group (j / 4) of two rows, each draws one row and passes
//     the other two words. With one key tile a tile's keep bits are drawn
//     into one register before its scores (the warp's first tile while the
//     unit's copy is in flight), so the Philox state is dead before S and
//     the accumulators are live. Kept p is divided by keep_div = 1 - rate
//     as p times the reciprocal plus one correction step (`div_keep`, two
//     fmas): the rounded quotient of a true division for every p from
//     2^-101 up, so the dropped p behind o is the one K2, the f32 route
//     and the plain version use. A plain `/` runs its refinement chain
//     per element and made K1' at the train shape about a quarter slower
//     (PERF.md).
//   - P V from registers: the dropped p is rounded to bf16 and the C
//     fragments of n-tiles 2t and 2t+1 are packed as the A fragment of
//     key step t (FlashAttention-2's register reuse); V, stored [key][d],
//     is the row-major B operand, read with ldmatrix.trans. o accumulates
//     in f32 and is written as bf16 pairs.
//   - Filling the card: `heads` is the largest divisor of H with at most 4
//     query tiles per unit. Encoder (Tq = Sk = 56, dk = 64): one head per
//     unit, 4 warps; a stage is 2 x 64 x 72 x 2 B (K, V) + 64 x 72 x 2 B
//     (Q) + 64 x 4 B (mask) = 27.9 KB, two stages 55.8 KB. The instance
//     for dk <= 64 and Sk <= 64 takes blocks of at most 4 warps. Registers
//     per thread (ptxas -v, CUDA 12.8, checked once): K1's is held to 128
//     and spills 4 bytes, so 4 blocks fit on an SM by registers and by
//     shared memory, 528 resident, and the eval shape runs 400 persistent
//     blocks of 3 units (1200 units). The K1' one is held to 168 and uses 164
//     with no spills (held to 128 it spilled 176 bytes, and at 4 blocks
//     per SM it was slower than 3 without spills, PERF.md): 3 blocks per
//     SM, 396 resident, and the train shape runs 320 blocks of 3 units
//     (960). Decoder (Tq = 10): one warp per head, 4 heads per unit, 240
//     units at batch 80 in one wave and one stage; 27.7 KB (self, T = 10)
//     or 83.2 KB (cross, Sk = 58). The other instances run unbounded with
//     no spills: K1 / K1' use 170 / 232 registers (dk <= 64, 128-key
//     tiles), 194 / 222 (dk 128, Sk <= 64) and 220 / 245 (both).
//     Stage bytes, which ops/fused_attention.py::_mma_smem must give too
//     (tests/test_torch_fwd_route.py reads these lines):
//       mma_stage_bytes(1, 56, 56, 64) = 27904    encoder
//       mma_stage_bytes(4, 10, 10, 64) = 27712    decoder self
//       mma_stage_bytes(4, 10, 58, 64) = 83200    decoder cross
//       mma_stage_bytes(1, 40, 300, 64) = 95680   300 keys
//       mma_stage_bytes(1, 56, 56, 128) = 52480   dk 128
//   - All argument-derived sizes are computed on the host and passed as
//     one __grid_constant__ struct, read from the constant bank rather
//     than held in registers.
//   - Deterministic: no atomics, every output element written once by one
//     warp, so two launches give the same bits (remat replays K1').
//
// f32: `fwd_kernel<float, kTrain>`, scalar f32 FMAs from shared memory --
// one block per (b, h), one warp per query row, lane-strided keys,
// warp-shuffle max and sum, each lane owning dk/32 output columns. The
// tensor cores could take f32 only as TF32 (10-bit mantissa), far outside
// the f32 tolerance (1e-5) that the tiny-config card == CPU checks hold;
// this route is what they run, at any dk, and it is bound by the shared
// memory load rate (two 4-byte loads per FMA), not by device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

#include "mma_sm90.cuh"
#include "philox.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e9f;

// The scalar kernel is instantiated for f32 only (bf16 takes the tensor
// cores); these keep its body written for any T.
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

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

// ---- the bf16 route on the tensor cores ----------------------------------

constexpr int kMmaMaxWarps = 8;
constexpr int kMmaTargetWarps = 4;
constexpr int kRowPad = 8;               // bf16 elements of row padding
constexpr size_t kSmemLimit = 232448;    // 227 KB a block can use

// Bytes of one stage (kept equal to ops/fused_attention.py::`_mma_smem`;
// the note at the top lists values that a CPU test holds it to):
// one unit's K and V panels [heads][Skp][dk+8] and Q tiles [heads][Tqp]
// [dk+8], bf16 (Skp, Tqp: Sk, Tq rounded up to 16), and its key mask [Skp]
// f32, rounded up to 16 bytes.
size_t mma_stage_bytes(int heads, int Tq, int Sk, int dk) {
  const size_t skp = (Sk + 15) / 16 * 16;
  const size_t tq16 = (Tq + 15) / 16 * 16;
  const size_t bytes =
      sizeof(__nv_bfloat16) * heads * (2 * skp + tq16) * (dk + kRowPad) +
      sizeof(float) * skp;
  return (bytes + 15) / 16 * 16;
}

// Everything the kernel reads that is the same for the whole launch, worked
// out on the host and passed as one __grid_constant__ parameter: the kernel
// reads these from the constant bank instead of holding them in registers.
struct MmaArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float* bias;
  const float* mask;
  const int* seed;
  __nv_bfloat16* o;
  float* p;
  int Tq, Sk, H, dk, L, dropout;
  uint32_t thresh;
  float keep_div;     // 1 - rate: kept p is divided by it (`div_keep`)
  float keep_rcp;     // 1 / keep_div, rounded to f32
  int heads;          // heads per unit, a divisor of H
  int units;          // B * H / heads; unit u is batch row u / groups
  int groups;         // H / heads
  int stages;         // 1, or 2: the next unit is copied in meanwhile
  int kd;             // dk / 16
  int ld;             // shared-memory row stride, dk + 8 elements
  int chunks;         // 16-byte chunks per row, dk / 8
  int rows_per_pass;  // rows a block's threads copy at once
  int HD;             // H * dk
  int skp, tiles, tq16, items, nkt, Lq, Lk;
  int panel;          // elements of one K or V panel, skp * ld
  int mask_off;       // elements from a stage's start to its mask
  int stage_elems;    // bf16 elements per stage
};

// Heads per unit: the largest divisor of H whose unit has at most
// kMmaTargetWarps 16-row query tiles and fits a block's shared memory.
int mma_heads(int Tq, int Sk, int H, int dk) {
  const int tiles = (Tq + 15) / 16;
  for (int d = H; d > 1; --d)
    if (H % d == 0 && d * tiles <= kMmaTargetWarps &&
        mma_stage_bytes(d, Tq, Sk, dk) <= kSmemLimit)
      return d;
  return 1;
}

using philox::div_keep;
using sm90::pack_bf16;
using sm90::quad_max;
using sm90::quad_sum;

// Store p[j], p[j+1] of one row (j even): one float2 when Sk is even.
__device__ __forceinline__ void store_p_pair(float* __restrict__ row, int j,
                                             int Sk, float p0, float p1) {
  if ((Sk & 1) == 0) {
    if (j < Sk) *reinterpret_cast<float2*>(row + j) = make_float2(p0, p1);
  } else {
    if (j < Sk) row[j] = p0;
    if (j + 1 < Sk) row[j + 1] = p1;
  }
}

// K1' dropout draw for the four accumulator elements of an n-tile
// (philox.cuh).
using philox::keep_nibble;

// Copy unit u into stage `stage` with cp.async: K, V and Q rows in 16-byte
// chunks, thread (row rr, chunk cc) of each pass, key rows from Sk and
// query rows from Tq zero-filled; the mask 4 bytes at a time.
__device__ __forceinline__ void stage_unit(const MmaArgs& a, int u,
                                           __nv_bfloat16* stage) {
  const int b = u / a.groups;
  const int h0 = (u - b * a.groups) * a.heads;
  __nv_bfloat16* sk = stage;
  __nv_bfloat16* sv = sk + a.heads * a.panel;
  __nv_bfloat16* sq = sv + a.heads * a.panel;
  float* smask = reinterpret_cast<float*>(stage + a.mask_off);
  for (int j = threadIdx.x; j < a.skp; j += blockDim.x) {
    const bool in = j < a.Sk;
    sm90::cp_async4(smask + j, in ? a.mask + (size_t)b * a.Sk + j : a.mask,
                    in ? 4 : 0);
  }
  const int rr = threadIdx.x / a.chunks;
  if (rr >= a.rows_per_pass) return;
  const int cc = (threadIdx.x - rr * a.chunks) * 8;
  for (int hl = 0; hl < a.heads; ++hl) {
    const size_t col = (size_t)(h0 + hl) * a.dk + cc;
    for (int j = rr; j < a.skp; j += a.rows_per_pass) {
      const bool in = j < a.Sk;
      const size_t off = ((size_t)b * a.Sk + j) * a.HD + col;
      const int dst = hl * a.panel + j * a.ld + cc;
      sm90::cp_async16(sk + dst, in ? a.k + off : a.k, in ? 16 : 0);
      sm90::cp_async16(sv + dst, in ? a.v + off : a.v, in ? 16 : 0);
    }
    for (int i = rr; i < a.tq16; i += a.rows_per_pass) {
      const bool in = i < a.Tq;
      const size_t off = ((size_t)b * a.Tq + i) * a.HD + col;
      sm90::cp_async16(sq + (hl * a.tq16 + i) * a.ld + cc, in ? a.q + off : a.q,
                       in ? 16 : 0);
    }
  }
}

// Grid (grid,), warps x 32 threads: block x takes units x, x + grid, ...
// through a.stages shared-memory stages; with 2, the next unit's K, V, Q
// and mask are copied in while this one computes. Warps take the unit's
// 16-row query tiles (items: head t / tiles, rows 16 (t % tiles) on). KD:
// the most 16-wide slices of dk the instance takes (kd <= KD); NT: 8-key
// n-tiles per score tile (8: Skp <= 64, a single tile; 16: tiles of 128
// keys). The common instance (dk <= 64, Skp <= 64) runs blocks of at most
// kMmaTargetWarps warps, held to the registers that fit four such blocks
// (K1: 128 per thread) or three (K1': 168, so its dropout arithmetic does
// not spill) on an SM.
template <int KD, int NT, bool kTrain>
__global__ void __launch_bounds__(
    (KD == 4 && NT == 8) ? kMmaTargetWarps * 32 : kMmaMaxWarps * 32,
    (KD == 4 && NT == 8) ? (kTrain ? 3 : 4) : 1)
fwd_mma_kernel(const __grid_constant__ MmaArgs a) {
  constexpr int kKeys = NT * 8;  // keys per score tile
  extern __shared__ __align__(16) unsigned char mma_smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(mma_smem_raw);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;        // accumulator rows g and g + 8
  const int c2 = (lane & 3) * 2;  // accumulator columns c2 and c2 + 1
  const bool drop = kTrain && a.dropout;
  const uint32_t s0 = drop ? (uint32_t)a.seed[0] : 0u;

  // With a single key tile (NT == 8), K1' draws a work item's keep bits
  // (bit 4 nt + e: element e of n-tile nt) before its scores: the warp's
  // first item's while the unit's copy is still in flight, and the Philox
  // state is dead before S and the accumulators are live.
  auto draw_item = [&](int u, int t) {
    uint32_t kb = 0u;
    if (!(kTrain && NT == 8) || !drop || t >= a.items) return kb;
    const int b = u / a.groups;
    const int hl = t / a.tiles;
    const int bh = b * a.H + (u - b * a.groups) * a.heads + hl;
    const int r0 = (t - hl * a.tiles) * 16;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      if (nt * 8 < a.Sk)
        kb |= keep_nibble(s0, a.thresh, bh, r0, nt * 8 + c2) << (4 * nt);
    return kb;
  };

  int u = blockIdx.x;
  stage_unit(a, u, smem);
  sm90::cp_async_commit();
  for (int it = 0; u < a.units; ++it, u += gridDim.x) {
    const int st = a.stages == 2 ? (it & 1) : 0;
    const int un = u + gridDim.x;
    uint32_t kb = draw_item(u, warp);
    if (a.stages == 2) {
      if (un < a.units) stage_unit(a, un, smem + (st ^ 1) * a.stage_elems);
      sm90::cp_async_commit();
      sm90::cp_async_wait<1>();
    } else {
      sm90::cp_async_wait<0>();
    }
    __syncthreads();

    const int b = u / a.groups;
    const int h0 = (u - b * a.groups) * a.heads;
    const __nv_bfloat16* sk = smem + st * a.stage_elems;
    const __nv_bfloat16* sv = sk + a.heads * a.panel;
    const __nv_bfloat16* sq = sv + a.heads * a.panel;
    const float* smask = reinterpret_cast<const float*>(sk + a.mask_off);

    for (int t = warp; t < a.items; t += blockDim.x >> 5) {
      const int hl = t / a.tiles;
      const int h = h0 + hl;
      const int r0 = (t - hl * a.tiles) * 16;
      const int bh = b * a.H + h;
      const __nv_bfloat16* hk = sk + hl * a.panel;
      const __nv_bfloat16* hv = sv + hl * a.panel;
      if (t != warp) kb = draw_item(u, t);

      unsigned qf[KD][4];
#pragma unroll
      for (int ks = 0; ks < KD; ++ks)
        if (ks < a.kd)
          sm90::ldsm_x4(qf[ks],
                        sq + (hl * a.tq16 + r0 + (lane & 7) +
                              ((lane >> 3) & 1) * 8) * a.ld +
                            ks * 16 + (lane >> 4) * 8);

      float s[NT][4];
      // S = Q K^T for key tile kt plus the bias, the key mask and -INF for
      // keys from Sk. The tile's n-tiles from ntv (at or past Skp) are left
      // out; those from nte (all keys at or past Sk) are zero and take no
      // part in the softmax, only in the P V products of their key step.
      auto scores = [&](int kt, int ntv, int nte) {
        const int n0 = kt * kKeys;
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[2 * np][e] = s[2 * np + 1][e] = 0.0f;
          if (2 * np >= ntv) continue;
#pragma unroll
          for (int ks = 0; ks < KD; ++ks) {
            if (ks >= a.kd) continue;
            unsigned bk[4];
            sm90::ldsm_x4(bk, hk + (n0 + np * 16 + (lane & 7) +
                                    (lane >> 4) * 8) * a.ld +
                                  ks * 16 + ((lane >> 3) & 1) * 8);
            sm90::mma_bf16(s[2 * np], qf[ks], bk[0], bk[1]);
            sm90::mma_bf16(s[2 * np + 1], qf[ks], bk[2], bk[3]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (nt >= nte) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = r0 + g + (e >> 1) * 8;
            const int j = n0 + nt * 8 + c2 + (e & 1);
            float x = s[nt][e];
            if (i < a.Lq && j < a.Lk)
              x += __ldg(a.bias + ((size_t)h * a.L + i) * a.L + j);
            s[nt][e] = j < a.Sk ? x + (1.0f - smask[j]) * kNegInf : -INFINITY;
          }
        }
      };

      // sweep 1: row max m and sum l (rescaled across key tiles); with a
      // single tile, s keeps exp(s - m)
      float m[2] = {-INFINITY, -INFINITY};
      float l[2] = {0.0f, 0.0f};
      for (int kt = 0; kt < a.nkt; ++kt) {
        const int ntv = min(NT, (a.skp - kt * kKeys) >> 3);
        const int nte = min(NT, (a.Sk - kt * kKeys + 7) >> 3);
        scores(kt, ntv, nte);
        float mn[2] = {m[0], m[1]};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (nt >= nte) continue;
          mn[0] = fmaxf(mn[0], fmaxf(s[nt][0], s[nt][1]));
          mn[1] = fmaxf(mn[1], fmaxf(s[nt][2], s[nt][3]));
        }
        mn[0] = quad_max(mn[0]);
        mn[1] = quad_max(mn[1]);
        float part[2] = {0.0f, 0.0f};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (nt >= nte) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[nt][e] = expf(s[nt][e] - mn[e >> 1]);
            part[e >> 1] += s[nt][e];
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] = l[r] * expf(m[r] - mn[r]) + part[r];
          m[r] = mn[r];
        }
      }
      const float inv[2] = {1.0f / quad_sum(l[0]), 1.0f / quad_sum(l[1])};

      // sweep 2: normalise, store p (K1'), drop, P V
      float acc[2 * KD][4];
#pragma unroll
      for (int dt = 0; dt < 2 * KD; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[dt][e] = 0.0f;
      for (int kt = 0; kt < a.nkt; ++kt) {
        const int n0 = kt * kKeys;
        const int ntv = min(NT, (a.skp - n0) >> 3);
        const int nte = min(NT, (a.Sk - n0 + 7) >> 3);
        if (a.nkt > 1) {
          scores(kt, ntv, nte);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            if (nt >= nte) continue;
#pragma unroll
            for (int e = 0; e < 4; ++e) s[nt][e] = expf(s[nt][e] - m[e >> 1]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (nt >= nte) continue;
          const int j = n0 + nt * 8 + c2;
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] *= inv[e >> 1];
          if (!kTrain) continue;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = r0 + g + r * 8;
            if (i < a.Tq)
              store_p_pair(a.p + ((size_t)bh * a.Tq + i) * a.Sk, j, a.Sk,
                           s[nt][2 * r], s[nt][2 * r + 1]);
          }
          if (drop) {
            const uint32_t keep =
                NT == 8 ? kb >> (4 * nt)
                        : keep_nibble(s0, a.thresh, bh, r0, j);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[nt][e] = (keep >> e) & 1u
                             ? div_keep(s[nt][e], a.keep_div, a.keep_rcp)
                             : 0.0f;
          }
        }
#pragma unroll
        for (int kk = 0; kk < NT / 2; ++kk) {
          if (2 * kk >= ntv) continue;
          const unsigned pa[4] = {
              pack_bf16(s[2 * kk][0], s[2 * kk][1]),
              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
          for (int dp = 0; dp < KD; ++dp) {
            if (dp >= a.kd) continue;
            unsigned bv[4];
            sm90::ldsm_x4_trans(
                bv, hv + (n0 + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                             a.ld + dp * 16 + (lane >> 4) * 8);
            sm90::mma_bf16(acc[2 * dp], pa, bv[0], bv[1]);
            sm90::mma_bf16(acc[2 * dp + 1], pa, bv[2], bv[3]);
          }
        }
      }

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = r0 + g + r * 8;
        if (i >= a.Tq) continue;
        __nv_bfloat16* orow =
            a.o + ((size_t)b * a.Tq + i) * a.HD + (size_t)h * a.dk;
#pragma unroll
        for (int dt = 0; dt < 2 * KD; ++dt)
          if (dt < 2 * a.kd)
            *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8 + c2) =
                __floats2bfloat162_rn(acc[dt][2 * r], acc[dt][2 * r + 1]);
      }
    }
    __syncthreads();  // stage st is free for the unit after next
    if (a.stages == 1 && un < a.units) {
      stage_unit(a, un, smem);
      sm90::cp_async_commit();
    }
  }
}

// Units of one batch row and `heads` heads. When the units fit on the card
// at once, one per block with one stage; otherwise persistent blocks with
// two stages, as many as fit, the units spread evenly over them.
template <int KD, int NT, bool kTrain>
cudaError_t launch_mma_instance(MmaArgs a, int B, cudaStream_t stream) {
  const auto kern = fwd_mma_kernel<KD, NT, kTrain>;
  a.heads = mma_heads(a.Tq, a.Sk, a.H, a.dk);
  a.groups = a.H / a.heads;
  a.units = B * a.groups;
  a.kd = a.dk / 16;
  a.ld = a.dk + kRowPad;
  a.chunks = a.dk / 8;
  a.HD = a.H * a.dk;
  a.skp = (a.Sk + 15) / 16 * 16;
  a.tiles = (a.Tq + 15) / 16;
  a.tq16 = a.tiles * 16;
  a.items = a.heads * a.tiles;
  a.nkt = (a.skp + NT * 8 - 1) / (NT * 8);
  a.Lq = std::min(a.L, a.Tq);
  a.Lk = std::min(a.L, a.Sk);
  a.panel = a.skp * a.ld;
  a.mask_off = a.heads * (2 * a.skp + a.tq16) * a.ld;
  const size_t stage = mma_stage_bytes(a.heads, a.Tq, a.Sk, a.dk);
  a.stage_elems = (int)(stage / sizeof(__nv_bfloat16));
  const int warps = std::min(
      a.items, (KD == 4 && NT == 8) ? kMmaTargetWarps : kMmaMaxWarps);
  a.rows_per_pass = warps * 32 / a.chunks;

  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // the most dynamic shared memory this instance was allowed on each
  // device (the attribute belongs to a device's context); past the table,
  // it is set at every launch that needs more than 48 KB
  constexpr int kDevices = 64;
  static size_t smem_set[kDevices] = {};
  size_t scratch = 0;
  size_t& allowed = dev < kDevices ? smem_set[dev] : scratch;
  auto resident = [&](size_t smem, int* n) {
    if (smem > 48 * 1024 && smem > allowed) {
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
      allowed = smem;
    }
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, kern, warps * 32,
                                                         smem);
  };
  int n1 = 0, n2 = 0;
  if ((err = resident(stage, &n1)) != cudaSuccess) return err;
  if (n1 == 0) return cudaErrorInvalidValue;
  int grid = a.units;
  a.stages = 1;
  if (a.units > n1 * sms && 2 * stage <= kSmemLimit) {
    if ((err = resident(2 * stage, &n2)) != cudaSuccess) return err;
    if (n2 > 0) {
      const int waves = (a.units + n2 * sms - 1) / (n2 * sms);
      grid = (a.units + waves - 1) / waves;
      a.stages = 2;
    }
  }
  kern<<<grid, warps * 32, a.stages * stage, stream>>>(a);
  return cudaGetLastError();
}

// The bf16 route: dk a multiple of 16 up to 128, one head's stage within a
// block's shared memory; anything else is refused.
template <bool kTrain>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const float* bias, const float* mask, void* o, int B,
                       int Tq, int Sk, int H, int dk, int L, float* p,
                       const int* seed, int dropout, uint32_t thresh,
                       float keep_div, cudaStream_t stream) {
  if (dk % 16 != 0 || dk < 16 || dk > 128 ||
      mma_stage_bytes(1, Tq, Sk, dk) > kSmemLimit)
    return cudaErrorInvalidValue;
  MmaArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.bias = bias;
  a.mask = mask;
  a.seed = seed;
  a.o = static_cast<__nv_bfloat16*>(o);
  a.p = p;
  a.Tq = Tq;
  a.Sk = Sk;
  a.H = H;
  a.dk = dk;
  a.L = L;
  a.dropout = dropout;
  a.thresh = thresh;
  a.keep_div = keep_div;
  a.keep_rcp = 1.0f / keep_div;
  const bool wide = dk > 64;
  const bool long_keys = Sk > 64;
  if (!wide && !long_keys)
    return launch_mma_instance<4, 8, kTrain>(a, B, stream);
  if (!wide) return launch_mma_instance<4, 16, kTrain>(a, B, stream);
  if (!long_keys) return launch_mma_instance<8, 8, kTrain>(a, B, stream);
  return launch_mma_instance<8, 16, kTrain>(a, B, stream);
}

}  // namespace

// dtype: 0 = float32 (scalar route), 1 = bfloat16 (tensor-core route); q,
// k, v and o share it. Returns the cudaError_t of the launch; 0 means it
// was accepted.
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
    return (int)launch_mma<false>(q, k, v, bias_f, mask_f, o, B, Tq, Sk, H,
                                  dk, L, nullptr, nullptr, 0, 0u, 1.0f, s);
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
    return (int)launch_mma<true>(q, k, v, bias_f, mask_f, o, B, Tq, Sk, H, dk,
                                 L, p_f, seed_i, dropout, thresh, keep_div, s);
  return (int)cudaErrorInvalidValue;
}

// Message for a cudaError_t returned above.
extern "C" const char* fused_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
