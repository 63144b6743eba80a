// Weight gradient out[D, F] = x^T g (K5), hand-written for Hopper (sm_90a),
// bound to PyTorch through a plain C entry point (ctypes).
//
// Replaces the Pallas TPU kernel `dw_kernel`, launched by `pallas_dw` in
// scripts/mm_bench.py: the MLP input projection's weight gradient
// x^T g with x [K, D] (the layer input, K = batch x sequence rows) and
// g [K, F] (the gradient of the projection's output), in bf16 or f32, with
// the sum over K in f32 and an f32 result. The TPU kernel holds an output
// tile [D, F/nt] in VMEM across a sequential grid over K chunks (`pl.when`
// k == 0 stores, later chunks add). Here blocks run in parallel and in no
// order, so each block owns one 128 x 128 output tile and walks all of K
// itself, in order, adding each step's products to f32 sums in registers.
// No atomics and no cross-block sum, so runs are deterministic. K, D and F
// may be any size; the ragged edges are masked.
//
// What bounds it on the card. At the probe shape (K = 4480, D = 768,
// F = 3072, bf16) it reads x 6.9 MB and g 27.5 MB and writes 9.4 MB: 43.8 MB,
// 13.1 us at 3.35 TB/s, against 2*K*D*F = 21.1 GFLOP, 21.4 us on the bf16
// tensor cores (989 TFLOP/s): bound by its arithmetic.
//
// What the design does about it. bf16 runs on the tensor cores (mma.sync,
// dw_mma_kernel below); f32 runs as scalar f32 FMAs (dw_kernel, at most
// 67 TFLOP/s). In both, a step of the sum over k is the outer product of the
// row x[k, d0:d0+128] with the row g[k, f0:f0+128], so x and g are staged
// k-major exactly as they lie in device memory (coalesced along D and F) and
// x is read "transposed" from shared memory: no copy of x^T is made in
// device memory. The 144 tiles of the probe shape are about one wave on 132
// SMs, and mma.sync reaches only part of the rate that wgmma with TMA would:
// those are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using sm90::cp_async16;
using sm90::cp_async_commit;
using sm90::cp_async_wait;
using sm90::ldsm_x4_trans;
using sm90::mma_bf16;

constexpr int kBD = 128;  // output rows (d) per block
constexpr int kBF = 128;  // output columns (f) per block
constexpr int kBK = 8;    // rows of x and g per shared-memory step
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int kLoads = kBK * kBD / kThreads;  // elements a thread stages

// The f32 route. Each block stages [8, 128] slices of x and g per step in
// shared memory; each of 256 threads keeps an 8 x 8 tile of sums in
// registers and reads two float4s of each row per k (four FMAs per shared
// word). Thread (ty, tx) owns rows {ty*4 + i, 64 + ty*4 + i} and columns
// {tx*4 + j, 64 + tx*4 + j}, i, j < 4, of the block's tile: the two halves
// make each warp's float4 reads of a shared row conflict-free.
__device__ __forceinline__ int half_index(int t, int i) {
  return (i < 4 ? 0 : 64) + t * 4 + (i & 3);
}

__global__ void __launch_bounds__(kThreads, 2)
dw_kernel(const float* __restrict__ x, const float* __restrict__ g,
          float* __restrict__ out, int K, int D, int F) {
  __shared__ __align__(16) float xs[kBK][kBD];
  __shared__ __align__(16) float gs[kBK][kBF];
  const int d0 = blockIdx.y * kBD;
  const int f0 = blockIdx.x * kBF;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int idx = tid + l * kThreads;
      const int r = idx / kBD;  // kBD == kBF: one index serves both
      const int c = idx - r * kBD;
      const int k = k0 + r;
      const bool kin = k < K;
      xs[r][c] = (kin && d0 + c < D) ? x[(size_t)k * D + d0 + c] : 0.0f;
      gs[r][c] = (kin && f0 + c < F) ? g[(size_t)k * F + f0 + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&xs[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&gs[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&gs[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const bool vec = (F & 3) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int d = d0 + half_index(ty, i);
    if (d >= D) continue;
    float* row = out + (size_t)d * F;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = f0 + half_index(tx, 4 * h);
      if (vec && f + 3 < F) {
        *reinterpret_cast<float4*>(row + f) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (f + j < F) row[f + j] = acc[i][4 * h + j];
      }
    }
  }
}

// The bf16 route on the tensor cores. Same tile and order as above: the
// block owns a 128 x 128 output tile and walks K in order, 32 rows of x and
// g per step, kept k-major in shared memory ([k][d] and [k][f], rows padded
// to 136 elements so the 8 rows an ldmatrix reads fall on distinct banks).
// Both mma operands come out of those k-major tiles with ldmatrix.trans: a
// [k][d] slice transposed is the row-major A = x^T fragment, a [k][f] slice
// transposed the column-major B = g fragment, so x^T is never formed. Eight
// warps each own 64 x 32 outputs: 4 x 4 mma.sync m16n8k16 tiles, bf16
// operands, f32 sums in registers. cp.async fills the next step's tiles
// while the current ones are multiplied (two stages), when D and F are
// multiples of 8 (16-byte rows); other shapes stage with plain loads.
constexpr int kMmaBK = 32;
constexpr int kLd = kBD + 8;

// Stage rows k0 .. k0+31 of x[:, d0:d0+128] and g[:, f0:f0+128], zero past
// the edges.
template <bool kAsync>
__device__ __forceinline__ void stage_tiles(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
    __nv_bfloat16 (*xs)[kLd], __nv_bfloat16 (*gs)[kLd], int k0, int d0,
    int f0, int K, int D, int F, int tid) {
  if (kAsync) {
    // 32 rows x 16 chunks of 8 elements per operand: 2 chunks a thread
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      const int c = tid + l * kThreads;
      const int r = c >> 4;
      const int col = (c & 15) * 8;
      const int k = k0 + r;
      const bool xin = k < K && d0 + col < D;
      const bool gin = k < K && f0 + col < F;
      cp_async16(&xs[r][col], xin ? x + (size_t)k * D + d0 + col : x,
                 xin ? 16 : 0);
      cp_async16(&gs[r][col], gin ? g + (size_t)k * F + f0 + col : g,
                 gin ? 16 : 0);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
#pragma unroll 4
    for (int l = 0; l < kMmaBK * kBD / kThreads; ++l) {
      const int idx = tid + l * kThreads;
      const int r = idx / kBD;
      const int col = idx - r * kBD;
      const int k = k0 + r;
      xs[r][col] = (k < K && d0 + col < D) ? x[(size_t)k * D + d0 + col]
                                           : zero;
      gs[r][col] = (k < K && f0 + col < F) ? g[(size_t)k * F + f0 + col]
                                           : zero;
    }
  }
}

__device__ __forceinline__ void store_pair(float* __restrict__ out, int d,
                                           int f, int D, int F, float v0,
                                           float v1) {
  if (d >= D) return;
  float* p = out + (size_t)d * F + f;
  if ((F & 1) == 0 && f + 1 < F) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    if (f < F) p[0] = v0;
    if (f + 1 < F) p[1] = v1;
  }
}

template <bool kAsync>
__global__ void __launch_bounds__(kThreads, 2)
dw_mma_kernel(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ g, float* __restrict__ out,
              int K, int D, int F) {
  __shared__ __align__(16) __nv_bfloat16 xs[2][kMmaBK][kLd];
  __shared__ __align__(16) __nv_bfloat16 gs[2][kMmaBK][kLd];
  const int d0 = blockIdx.y * kBD;
  const int f0 = blockIdx.x * kBF;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wm = (tid >> 5) >> 2;  // warp row: outputs wm*64 .. +63
  const int wn = (tid >> 5) & 3;   // warp column: outputs wn*32 .. +31
  const int j = lane >> 3;         // the 8x8 matrix this lane addresses
  const int r8 = lane & 7;         // and its row

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  const int nk = (K + kMmaBK - 1) / kMmaBK;
  stage_tiles<kAsync>(x, g, xs[0], gs[0], 0, d0, f0, K, D, F, tid);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      stage_tiles<kAsync>(x, g, xs[cur ^ 1], gs[cur ^ 1], (kt + 1) * kMmaBK,
                          d0, f0, K, D, F, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kMmaBK; ks += 16) {
      // A fragments: matrix j covers rows (j&1)*8 and k (j>>1)*8
      unsigned a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldsm_x4_trans(a[mt], &xs[cur][ks + ((j >> 1) << 3) + r8]
                                [wm * 64 + mt * 16 + ((j & 1) << 3)]);
      // B fragments: matrix j covers k (j&1)*8 and columns (j>>1)*8, so
      // one x4 load gives both k halves of two n8 tiles
      unsigned b[2][4];
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldsm_x4_trans(b[np], &gs[cur][ks + ((j & 1) << 3) + r8]
                                [wn * 32 + np * 16 + ((j >> 1) << 3)]);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mt][nt], a[mt], b[nt >> 1][(nt & 1) * 2],
                   b[nt >> 1][(nt & 1) * 2 + 1]);
    }
    __syncthreads();
  }

  // accumulator (mt, nt): rows lane/4 and lane/4 + 8, columns 2*(lane%4)
  const int gr = lane >> 2;
  const int gc = (lane & 3) * 2;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int d = d0 + wm * 64 + mt * 16 + gr;
      const int f = f0 + wn * 32 + nt * 8 + gc;
      store_pair(out, d, f, D, F, acc[mt][nt][0], acc[mt][nt][1]);
      store_pair(out, d + 8, f, D, F, acc[mt][nt][2], acc[mt][nt][3]);
    }
}

cudaError_t launch_f32(const void* x, const void* g, float* out, int K,
                       int D, int F, cudaStream_t stream) {
  const dim3 grid((F + kBF - 1) / kBF, (D + kBD - 1) / kBD);
  dw_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(g), out, K, D,
      F);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* x, const void* g, float* out, int K,
                        int D, int F, cudaStream_t stream) {
  const dim3 grid((F + kBF - 1) / kBF, (D + kBD - 1) / kBD);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* gb = static_cast<const __nv_bfloat16*>(g);
  const bool rows16 = (D % 8 == 0) && (F % 8 == 0) &&
                      ((reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(g)) % 16 == 0);
  if (rows16)
    dw_mma_kernel<true><<<grid, kThreads, 0, stream>>>(xb, gb, out, K, D, F);
  else
    dw_mma_kernel<false><<<grid, kThreads, 0, stream>>>(xb, gb, out, K, D, F);
  return cudaGetLastError();
}

}  // namespace

// K5. x [K, D] and g [K, F] row-major in one dtype (0 = float32,
// 1 = bfloat16); out [D, F] f32 row-major, every element written. Returns
// the cudaError_t of the launch; 0 means it was accepted.
extern "C" int dw_splitk(const void* x, const void* g, void* out, int K,
                         int D, int F, int dtype, void* stream) {
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_f32(x, g, o, K, D, F, s);
  if (dtype == 1) return (int)launch_bf16(x, g, o, K, D, F, s);
  return (int)cudaErrorInvalidValue;
}

// Message for a cudaError_t returned above.
extern "C" const char* dw_splitk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
