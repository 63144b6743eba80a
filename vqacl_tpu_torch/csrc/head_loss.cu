// The LM head's cross-entropy over the vocabulary (H1 forward, H2 backward),
// hand-written for Hopper (sm_90a), bound to PyTorch through plain C entry
// points (ctypes).
//
// What it replaces. No Pallas kernel: the JAX package leaves the head to
// XLA, which fuses `einsum(h, shared, preferred_element_type=float32)` with
// the log-sum-exp and the d(logits) products of `fused_head_loss`'s custom
// VJP (vqacl_tpu/models/vlt5.py:313-350): bf16 products summed in f32, the
// [rows, V] f32 logits never kept. The port's plain version
// (models/vlt5.py::_plain_forward/_plain_backward) forms the same products
// as f32 FFMA GEMMs of the bf16-rounded operands and writes f32 logits, p and
// d(logits) of [rows, V] to device memory; at VL-Moonlight's 800 rows x
// 163,840 columns each is 524 MB.
//
// What bounds it on the card. Four products of 2 x rows x V x D: the logits
// (H1), their recompute (H2), and the two gradient products, which are K5
// (dw_splitk.cu) on H2's bf16 d(logits). At 800 x 163,840 x 2048 each is
// 0.537 TFLOP, 0.54 ms on the bf16 tensor cores (989 TFLOP/s), against the
// 671 MB bf16 head read once per pass (0.20 ms at 3.35 TB/s) and H2's two
// 262 MB bf16 d(logits) writes: bound by the arithmetic.
//
// The design. One block per tile of 128 hidden rows x 256 vocabulary
// columns (blockIdx: the rows' tile fastest, so the blocks of one vocabulary
// chunk run together and read its 1 MB of the head from L2 after the first),
// 384 threads: a producer warpgroup, one thread of which keeps TMA loads of
// [64 d x 128 rows] and [64 d x 256 columns] boxes (128-byte swizzle, d
// contiguous: both operands K-major as they lie in memory) in flight into a
// ring of 4 mbarrier-guarded 48 KB stages, and two consumer warpgroups, each
// running wgmma m64n256k16 over 64 of the rows with f32 sums in registers
// (setmaxnreg moves registers from the producer, 40, to them, 232). The
// logits of the tile then live only in registers:
//   H1 keeps per row the tile's max and sum of exp(l - max) over the columns
//      below V (the ragged last chunk's others do not enter), reduced over
//      the 4 lanes that share a row in a fixed order, and writes that pair to
//      a [chunks, rows] workspace; the thread holding a row's label column
//      writes its logit. head_lse_combine_kernel then merges each row's
//      pairs in chunk order (32 lanes strided over the chunks, then a fixed
//      butterfly; every merge is symmetric, so all lanes agree) into lse.
//      The loss, (lse - label logit) x the token weights summed, is formed by
//      the wrapper from lse and the label logit as the plain version forms it.
//   H2 forms d(logits) = (exp(l - lse) - onehot(label)) x w per element,
//      rounds it to bf16 where the plain version does, and writes it twice
//      through the idle ring: as [rows, V] for dshared = d(logits)^T h (K5
//      with K = rows) and as [V, rows_pad] for dh = d(logits) W (K5 with
//      K = V, the sum over the vocabulary), each as 128-byte-swizzled boxes
//      that TMA stores, dropping what lies past V and the rows. Rows past the
//      batch (rows .. rows_pad - 1) are written as zeros (their weight is 0).
// No float atomics; every sum is in a fixed order, so a launch gives the same
// bits every time on one card. Nothing is allocated here: the workspace and
// outputs come from the wrapper (ops/head_loss.py), and nothing depends on
// the data but the values, so both kernels are captured in CUDA graphs.
// Tensor maps are encoded on the host (wgmma_sm90.cuh::box_map) and passed as
// __grid_constant__ parameters.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

namespace {

using sm90::box_map;

constexpr int kBM = 128;  // hidden rows per block: two consumer warpgroups
constexpr int kBN = 256;  // vocabulary columns per block (one m64n256 wgmma)
constexpr int kBK = 64;   // d per stage: one 128-byte box row
constexpr int kThreads = 384;
constexpr int kConsumers = 256;
constexpr int kABytes = kBM * kBK * 2;          // 16 KB
constexpr int kStageBytes = kABytes + kBN * kBK * 2;  // 48 KB
constexpr int kStages = 4;
constexpr int kAcc = kBN / 2;  // f32 sums per consumer thread
constexpr int kSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;
// H2's output boxes in the idle ring: d(logits) as 4 boxes of 128 rows x 64
// columns, then its transpose as 2 boxes of 256 columns x 64 rows
constexpr int kOutBox = kBM * 128;
constexpr int kTBox = kBN * 128;
static_assert(4 * kOutBox + 2 * kTBox <= kStages * kStageBytes,
              "H2's output boxes fit the ring");

// Block b: rows' tile b % m_tiles, vocabulary chunk b / m_tiles. Register i
// of consumer thread (warpgroup wg, warp, lane) holds row wg*64 + 16*warp +
// lane/4 + 8*((i/2)%2) and column 8*(i/4) + 2*(lane%4) + i%2 of the tile.
template <bool kGrad>
__global__ void __launch_bounds__(kThreads, 1)
head_kernel(const __grid_constant__ CUtensorMap tmh,
            const __grid_constant__ CUtensorMap tmw,
            const __grid_constant__ CUtensorMap tmd,
            const __grid_constant__ CUtensorMap tmt,
            const int* __restrict__ labels, const float* __restrict__ lse,
            const float* __restrict__ w, float2* __restrict__ part,
            float* __restrict__ ll, int rows, int V, int m_tiles,
            int k_steps) {
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int m0 = (blockIdx.x % m_tiles) * kBM;
  const int chunk = blockIdx.x / m_tiles;
  const int n0 = chunk * kBN;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);  // one arrival per warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread keeps the ring full -------------------------
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      int stage = 0;
      unsigned phase = 0;
      for (int k = 0; k < k_steps; ++k) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* st = ring + stage * kStageBytes;
        mbar_arrive_expect_tx(&full[stage], kStageBytes);
        tma_load_2d(st, &tmh, &full[stage], k * kBK, m0);
        tma_load_2d(st + kABytes, &tmw, &full[stage], k * kBK, n0);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns the tile's rows wg*64 .. wg*64+63 -----
  setmaxnreg_inc<232>();
  const int ctid = threadIdx.x;  // 0 .. 255
  const int lane = ctid & 31;
  const int warp = (ctid >> 5) & 3;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
  int stage = 0;
  unsigned phase = 0;
  int prev = -1;
  for (int k = 0; k < k_steps; ++k) {
    mbar_wait(&full[stage], phase);
    const unsigned st = smem_u32(ring + stage * kStageBytes);
    const uint64_t da = desc_k_sw128(st + wg * 64 * 128);
    const uint64_t db = desc_k_sw128(st + kABytes);
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)  // 16 d = 32 bytes further on
      wgmma_k(acc, da + 2 * kk, db + 2 * kk, (k != 0 || kk != 0) ? 1 : 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands(acc);
    if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
    prev = stage;
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_operands(acc);

  const int rbase = wg * 64 + warp * 16 + (lane >> 2);  // the tile's row
  const int cq = 2 * (lane & 3);                       // column in 8
  if (!kGrad) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + rbase + 8 * h;
      const int label = row < rows ? labels[row] : -1;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + 8 * j + cq + e;
          const float v = acc[4 * j + 2 * h + e];
          if (col < V) mx = fmaxf(mx, v);
          if (col == label) ll[row] = v;  // the one thread of the label
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (n0 + 8 * j + cq + e < V)
            s += __expf(acc[4 * j + 2 * h + e] - mx);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if ((lane & 3) == 0 && row < rows)
        part[(size_t)chunk * rows + row] = make_float2(mx, s);
    }
    return;
  }

  // H2: both warpgroups are done with the ring; it holds the outputs now
  named_bar_sync(1, kConsumers);
  uint8_t* outd = ring;
  uint8_t* outt = ring + 4 * kOutBox;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rl = rbase + 8 * h;
    const int row = m0 + rl;
    const bool live = row < rows;
    const float l = live ? lse[row] : 0.0f;
    const float wr = live ? w[row] : 0.0f;
    const int label = live ? labels[row] : -1;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      float d[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p = __expf(acc[4 * j + 2 * h + e] - l);
        if (n0 + 8 * j + cq + e == label) p -= 1.0f;
        d[e] = p * wr;
      }
      const __nv_bfloat162 pair = __floats2bfloat162_rn(d[0], d[1]);
      // [rows, V]: box j / 8, row rl, 16-byte chunk j % 8 swizzled by row
      *reinterpret_cast<__nv_bfloat162*>(
          outd + (j >> 3) * kOutBox + rl * 128 +
          (((j & 7) ^ (rl & 7)) << 4) + 4 * (lane & 3)) = pair;
      // [V, rows_pad]: box wg (the row's 64), line c, chunk (rl % 64) / 8
      // swizzled by the line
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + cq + e;
        *reinterpret_cast<__nv_bfloat16*>(
            outt + wg * kTBox + c * 128 +
            ((((rl & 63) >> 3) ^ (c & 7)) << 4) + (rl & 7) * 2) =
            e ? pair.y : pair.x;
      }
    }
  }
  fence_proxy_async_smem();
  named_bar_sync(1, kConsumers);
  if (ctid == 0) {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      tma_store_2d(&tmd, outd + b * kOutBox, n0 + 64 * b, m0);
#pragma unroll
    for (int b = 0; b < 2; ++b)
      tma_store_2d(&tmt, outt + b * kTBox, m0 + 64 * b, n0);
    bulk_commit();
    bulk_wait_read();
  }
}

// (m, s) with s = sum exp(x - m) merged with (m2, s2); symmetric in its two
// pairs, so both lanes of a butterfly step get the same bits.
__device__ __forceinline__ void merge(float& m, float& s, float m2,
                                      float s2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;  // both empty
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

// One warp per row: lane l merges chunks l, l + 32, ... in order, then the
// lanes merge in a fixed butterfly; lse = m + log(s).
__global__ void __launch_bounds__(256)
head_lse_combine_kernel(const float2* __restrict__ part,
                        float* __restrict__ lse, int rows, int chunks) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float m = -INFINITY, s = 0.0f;
  for (int c = lane; c < chunks; c += 32) {
    const float2 p = part[(size_t)c * rows + row];
    merge(m, s, p.x, p.y);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, m2, s2);
  }
  if (lane == 0) lse[row] = m + logf(s);
}

bool shapes_ok(const void* hs, const void* wb, int rows, int D, int V) {
  return rows > 0 && D > 0 && V > 0 && D % kBK == 0 && V % 8 == 0 &&
         ((reinterpret_cast<uintptr_t>(hs) |
           reinterpret_cast<uintptr_t>(wb)) % 16) == 0;
}

template <bool kGrad>
cudaError_t launch(const CUtensorMap& tmh, const CUtensorMap& tmw,
                   const CUtensorMap& tmd, const CUtensorMap& tmt,
                   const int* labels, const float* lse, const float* w,
                   float2* part, float* ll, int rows, int D, int V,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      head_kernel<kGrad>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const int m_tiles = (rows + kBM - 1) / kBM;
  const long long blocks = (long long)m_tiles * ((V + kBN - 1) / kBN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  head_kernel<kGrad><<<(unsigned)blocks, kThreads, kSmem, stream>>>(
      tmh, tmw, tmd, tmt, labels, lse, w, part, ll, rows, V, m_tiles,
      D / kBK);
  return cudaGetLastError();
}

}  // namespace

// H1. hs [rows, D] and wb [V, D] bf16 row-major (D a multiple of 64, V of 8,
// 16-byte-aligned bases), labels int32 [rows] in [0, V); part f32 [chunks,
// rows, 2] (chunks = ceil(V / 256)) scratch; out: lse f32 [rows] and ll f32
// [rows], the logit at each row's label. Returns the cudaError_t of the
// launches; 0 means both were accepted.
extern "C" int head_lse(const void* hs, const void* wb, const int* labels,
                        void* part, void* lse, void* ll, int rows, int D,
                        int V, void* stream) {
  if (!shapes_ok(hs, wb, rows, D, V)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap tmh, tmw;
  cudaError_t err;
  if ((err = box_map(&tmh, hs, rows, D, false, kBM)) != cudaSuccess)
    return (int)err;
  if ((err = box_map(&tmw, wb, V, D, false, kBN)) != cudaSuccess)
    return (int)err;
  float2* p = static_cast<float2*>(part);
  err = launch<false>(tmh, tmw, tmh, tmh, labels, nullptr, nullptr, p,
                      static_cast<float*>(ll), rows, D, V, s);
  if (err != cudaSuccess) return (int)err;
  head_lse_combine_kernel<<<(rows + 7) / 8, 256, 0, s>>>(
      p, static_cast<float*>(lse), rows, (V + kBN - 1) / kBN);
  return (int)cudaGetLastError();
}

// H2. hs, wb and labels as for H1; lse f32 [rows] (H1's), w f32 [rows] (the
// loss's weight of each row times the incoming gradient); out: dlogits bf16
// [rows, V] and dlogits_t bf16 [V, rows_pad] (rows_pad a multiple of 8, at
// least rows; its columns from rows on are zeros), every element written.
extern "C" int head_dlogits(const void* hs, const void* wb, const int* labels,
                            const void* lse, const void* w, void* dlogits,
                            void* dlogits_t, int rows, int rows_pad, int D,
                            int V, void* stream) {
  if (!shapes_ok(hs, wb, rows, D, V) || rows_pad < rows || rows_pad % 8 ||
      ((reinterpret_cast<uintptr_t>(dlogits) |
        reinterpret_cast<uintptr_t>(dlogits_t)) % 16))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tmh, tmw, tmd, tmt;
  cudaError_t err;
  if ((err = box_map(&tmh, hs, rows, D, false, kBM)) != cudaSuccess ||
      (err = box_map(&tmw, wb, V, D, false, kBN)) != cudaSuccess ||
      (err = box_map(&tmd, dlogits, rows, V, false, kBM)) != cudaSuccess ||
      (err = box_map(&tmt, dlogits_t, V, rows_pad, false, kBN)) !=
          cudaSuccess)
    return (int)err;
  return (int)launch<true>(tmh, tmw, tmd, tmt, labels,
                           static_cast<const float*>(lse),
                           static_cast<const float*>(w), nullptr, nullptr,
                           rows, D, V, static_cast<cudaStream_t>(stream));
}

// Message for a cudaError_t returned above.
extern "C" const char* head_loss_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
