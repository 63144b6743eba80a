// Greedy non-maximum suppression on the card (N1), hand-written for Hopper
// (sm_90a), bound to PyTorch through a plain C entry point (ctypes).
//
// Not a port of a Pallas kernel: it is the counterpart of the two greedy
// suppressions the JAX package runs as a `lax.scan` on the device, with no
// trip back to the host -- the RPN's over up to 6000 score-sorted boxes at
// one threshold (vqacl_tpu/vision/rpn.py:154) and the 36-box sweep over 300
// boxes at five thresholds at once (vqacl_tpu/ops/nms.py:83). Eager PyTorch
// has no such loop: a Python loop over the boxes is several launches per
// box.
//
// Contract. boxes [N, 4] f32 (x1, y1, x2, y2), already in score order,
// valid [N] u8 and thresholds [T] f32 -> keep [T, N] u8: box i is kept at
// threshold t iff it is valid and no earlier kept box has IoU > t with it.
// IoU is where(union > 0, inter / union, 0) with areas
// clip(x2 - x1, 0) * clip(y2 - y1, 0), every product, sum and quotient
// rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn: no
// contraction into FMAs), so the keep masks equal the plain PyTorch
// version's bit for bit.
//
// Design. Two kernels on the caller's stream.
//  1. nms_mask_kernel, parallel: block (cb, rb) of 64 threads holds the 64
//     column boxes of tile cb in shared memory; thread i of row tile rb
//     writes, for every threshold, the 64-bit word of tile cb whose bit c
//     says IoU(i, 64 cb + c) > t for a later box (64 cb + c > i). Only the
//     upper triangle (cb >= rb) is written; nothing reads the rest.
//  2. nms_walk_kernel, one block of 256 threads per threshold, walks the 64-
//     row tiles in order. Warp 0 resolves a tile alone, in registers: the
//     tile's "removed" word, its rows' diagonal words (one shuffle per row)
//     and a ballot of their validity give the tile's kept rows with no
//     memory traffic in the dependent chain. Then all 256 threads OR the
//     kept rows' words right of the diagonal into the shared "removed"
//     mask (64-bit atomicOr in shared memory), and the next tile starts.
//
// What bounds it. The work is N dependent decisions, so neither bytes nor
// operations bound it: the chain of 64-row tiles does (per tile one serial
// pass of up to 64 shuffles and two block barriers). At N = 6000, T = 1 the
// mask is 4.5 MB written and read once, 2.7 us at 3.35 TB/s, and the IoUs
// (18 M, ~10 operations each) are ~3 us at the f32 rate; the serial walk
// over 94 tiles is what the time is made of. The mask is T * N * ceil(N/64)
// words of scratch the wrapper allocates; N <= 16384 and T <= 8.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;        // boxes per tile = bits per mask word
constexpr int kMaxT = 8;         // thresholds at once
constexpr int kMaxN = 16384;     // boxes (mask: T * N * N / 64 words)
constexpr int kWalkThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float area_rn(float x1, float y1, float x2,
                                         float y2) {
  return __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.f),
                   fmaxf(__fsub_rn(y2, y1), 0.f));
}

// IoU of box a (the earlier) with box b, as the plain version rounds it:
// union = (area_a + area_b) - inter.
__device__ __forceinline__ float iou_rn(const float* a, float area_a,
                                        const float* b, float area_b) {
  const float w = fmaxf(__fsub_rn(fminf(a[2], b[2]), fmaxf(a[0], b[0])), 0.f);
  const float h = fmaxf(__fsub_rn(fminf(a[3], b[3]), fmaxf(a[1], b[1])), 0.f);
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
}

__global__ void __launch_bounds__(kTile)
nms_mask_kernel(const float* __restrict__ boxes, const float* __restrict__ thr,
                uint64_t* __restrict__ mask, int N, int T, int nw) {
  const int cb = blockIdx.x, rb = blockIdx.y;
  if (cb < rb) return;
  __shared__ float cols[kTile][4];
  __shared__ float col_area[kTile];
  __shared__ float th[kMaxT];
  const int j0 = cb * kTile;
  const int ncols = min(kTile, N - j0);
  const int tid = threadIdx.x;
  if (tid < ncols) {
    for (int k = 0; k < 4; ++k) cols[tid][k] = boxes[4 * (j0 + tid) + k];
    col_area[tid] = area_rn(cols[tid][0], cols[tid][1], cols[tid][2],
                            cols[tid][3]);
  }
  if (tid < T) th[tid] = thr[tid];
  __syncthreads();
  const int i = rb * kTile + tid;
  if (i >= N) return;
  float a[4];
  for (int k = 0; k < 4; ++k) a[k] = boxes[4 * i + k];
  const float area_a = area_rn(a[0], a[1], a[2], a[3]);
  uint64_t bits[kMaxT];
#pragma unroll
  for (int t = 0; t < kMaxT; ++t) bits[t] = 0;
  for (int c = 0; c < ncols; ++c) {
    if (j0 + c <= i) continue;
    const float v = iou_rn(a, area_a, cols[c], col_area[c]);
#pragma unroll
    for (int t = 0; t < kMaxT; ++t)
      if (t < T && v > th[t]) bits[t] |= 1ull << c;
  }
#pragma unroll
  for (int t = 0; t < kMaxT; ++t)
    if (t < T) mask[((size_t)t * N + i) * nw + cb] = bits[t];
}

__global__ void __launch_bounds__(kWalkThreads)
nms_walk_kernel(const uint64_t* __restrict__ mask,
                const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep,
                int N, int nw) {
  extern __shared__ unsigned long long removed[];   // nw words
  __shared__ int kept_rows[kTile];
  __shared__ int n_kept;
  const int t = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint64_t* m = mask + (size_t)t * N * nw;
  uint8_t* out = keep + (size_t)t * N;
  for (int w = tid; w < nw; w += blockDim.x) removed[w] = 0ull;
  __syncthreads();
  for (int r = 0; r < nw; ++r) {
    const int i0 = r * kTile;
    const int rows = min(kTile, N - i0);
    if (warp == 0) {
      const int lo = lane, hi = lane + 32;
      const uint64_t d0 = lo < rows ? m[(size_t)(i0 + lo) * nw + r] : 0ull;
      const uint64_t d1 = hi < rows ? m[(size_t)(i0 + hi) * nw + r] : 0ull;
      const unsigned v0 = __ballot_sync(kFull, lo < rows && valid[i0 + lo]);
      const unsigned v1 = __ballot_sync(kFull, hi < rows && valid[i0 + hi]);
      const uint64_t vw = (uint64_t)v0 | ((uint64_t)v1 << 32);
      uint64_t cur = removed[r];
      uint64_t kw = 0ull;
      for (int b = 0; b < rows; ++b) {
        const uint64_t d = __shfl_sync(kFull, b < 32 ? d0 : d1, b & 31);
        if (((vw >> b) & 1ull) && !((cur >> b) & 1ull)) {
          kw |= 1ull << b;
          cur |= d;
        }
      }
      if (lo < rows) out[i0 + lo] = (uint8_t)((kw >> lo) & 1ull);
      if (hi < rows) out[i0 + hi] = (uint8_t)((kw >> hi) & 1ull);
      if ((kw >> lo) & 1ull)
        kept_rows[__popcll(kw & ((1ull << lo) - 1ull))] = i0 + lo;
      if ((kw >> hi) & 1ull)
        kept_rows[__popcll(kw & ((1ull << hi) - 1ull))] = i0 + hi;
      if (lane == 0) n_kept = __popcll(kw);
    }
    __syncthreads();
    const int span = nw - r - 1;
    const int work = n_kept * span;
    for (int idx = tid; idx < work; idx += blockDim.x) {
      const int k = idx / span;
      const int w = r + 1 + idx % span;
      atomicOr(&removed[w],
               (unsigned long long)m[(size_t)kept_rows[k] * nw + w]);
    }
    __syncthreads();
  }
}

}  // namespace

// boxes [N,4] f32, valid [N] u8, thr [T] f32 (device pointers), mask
// scratch of T * N * ceil(N/64) u64, keep [T,N] u8 out. 0 or a cudaError_t.
extern "C" int greedy_nms(const void* boxes, const void* valid,
                          const void* thr, void* mask, void* keep, int N,
                          int T, void* stream) {
  if (N < 1 || N > kMaxN || T < 1 || T > kMaxT)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nw = (N + kTile - 1) / kTile;
  nms_mask_kernel<<<dim3(nw, nw), kTile, 0, s>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(thr),
      static_cast<uint64_t*>(mask), N, T, nw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_walk_kernel<<<T, kWalkThreads, nw * sizeof(unsigned long long), s>>>(
      static_cast<const uint64_t*>(mask), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), N, nw);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* greedy_nms_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
