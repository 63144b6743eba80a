// Grouped matrix products over the held experts of an MoE layer, hand-
// written for Hopper (sm_90a), bound to PyTorch through a plain C entry
// point (ctypes). Wrapper: ops/moe.py.
//
// What it replaces. No TPU kernel: the JAX package has no mixture of
// experts. It was added for the VL-Moonlight backbone (models/moonlight.py),
// whose MoE layers route each token to 6 of 64 experts; this card holds 8
// of them (expert parallelism 8) and computes their part.
//
// The rows are the token choices sorted by expert (ops/moe.py::route_plan,
// on the card): expert e owns sorted rows offsets[e] .. offsets[e+1]. The
// host never learns the counts, so a launch's grid covers the most rows an
// expert can get (max_rows, every token), and a block whose tile starts
// past its expert's count returns at once. Any count from 0 up is taken.
//
// moe_rows_gemm: C[r, :] = A[row(r), :] · B[e] for the rows r of each
// expert e, A bf16 row-major with K columns (gathered through a_rows when
// given: the token rows of the layer input), B[e] bf16 either [K, N] (n
// contiguous, b_kmajor 1) or [N, K] (k contiguous). Epilogues:
//   0 store       C [rows, N] bf16;
//   1 swiglu      N = 2F columns interleaved in blocks of 64 (gate block
//                 b at 128b, its up block at 128b + 64): stores the
//                 products C [rows, 2F] bf16 (for the backward) and
//                 C2 = silu(gate) * up [rows, F] bf16 from the f32 sums;
//   2 swiglu bwd  N = F: the sums are d(act); reads the stored gate and up
//                 of G [rows, 2F] and stores [d gate | d up] interleaved
//                 as G is, C [rows, 2F] bf16.
// moe_dw_gemm: C[e] = sum over expert e's rows r of A[row(r), :]^T B[r, :],
// f32 [M, N] (epilogue 0), or with N = 2F interleaved split into the gate
// and up halves C, C2 [E, M, F] (epilogue 1). An expert with no rows gets
// zeros.
//
// What bounds it on the card. At the VL-Moonlight cell's shape (80 x 66
// tokens, 6 choices each, 8 of 64 experts held: ~3,900 rows, ~495 an
// expert; D = 2048, F = 1408) a layer's forward is 2 n D 2F + 2 n F D =
// 67 GFLOP against 214 MB (the weights' bf16 copies, the rows, gate|up and
// the activation), its six launches 202 GFLOP against 792 MB: ~250 FLOP a
// byte for the whole and 315 for the forward, near or above the H100's
// 295 FLOP/byte ridge, so bound by the tensor cores (989 TFLOP/s bf16):
// 0.068 ms forward, 0.247 ms all six (NVIDIA H100 80GB HBM3).
// This first version is the simple one: one 128 x 128 tile per block, 8
// warps of mma.sync m16n8k16 (bf16 operands, f32 sums), two cp.async
// stages of 32-deep k slices in shared memory (rows padded by 8 elements so
// that the 8 rows an ldmatrix reads fall on distinct banks). ptxas
// -v: 124-128 registers, no spills, 34-40 KB of static shared memory.
// Making it fast (wgmma, TMA, a persistent tile schedule over the
// device-side offsets) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using sm90::cp_async16;
using sm90::cp_async_commit;
using sm90::cp_async_wait;
using sm90::ldsm_x4;
using sm90::ldsm_x4_trans;
using sm90::mma_bf16;
using bf16 = __nv_bfloat16;

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kThreads = 256;
constexpr int kPadK = kBK + 8;    // a [row][k] tile's row
constexpr int kPadN = kBN + 8;    // a [k][col] tile's row
constexpr int kGroup = 64;        // gate / up block of the interleave

enum { kStore = 0, kSwiglu = 1, kSwigluBwd = 2 };

__device__ __forceinline__ float silu(float g) {
  return g / (1.0f + __expf(-g));
}

__device__ __forceinline__ void store_bf16x2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The warp's n8 tiles: cols 32 wn + 8 nt, or, for the swiglu epilogue,
// 16 wn + 8 nt (nt 0, 1: gate) and 64 + 16 wn + 8 (nt - 2) (up), so that
// one thread holds a gate sum and its up sum.
template <int EPI>
__device__ __forceinline__ int pair_col(int wn, int np) {
  return EPI == kSwiglu ? np * 64 + wn * 16 : wn * 32 + np * 16;
}

template <bool B_KMAJOR, int EPI>
__global__ void __launch_bounds__(kThreads, 2)
moe_rows_kernel(const bf16* __restrict__ A, const int* __restrict__ a_rows,
            int lda, const bf16* __restrict__ B, long long b_stride,
            int ldb, const int* __restrict__ offsets,
            bf16* __restrict__ C, bf16* __restrict__ C2,
            const bf16* __restrict__ G, int N, int K) {
  __shared__ __align__(16) bf16 as[2][kBM][kPadK];
  __shared__ __align__(16) bf16 bs[2][B_KMAJOR ? kBK : kBN]
                                  [B_KMAJOR ? kPadN : kPadK];
  const int e = blockIdx.z;
  const int start = offsets[e];
  const int cnt = offsets[e + 1] - start;
  const int r0 = blockIdx.y * kBM;
  if (r0 >= cnt) return;
  const int n0 = blockIdx.x * kBN;
  const bf16* Be = B + (size_t)e * b_stride;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wm = (tid >> 5) >> 2;
  const int wn = (tid >> 5) & 3;
  const int j = lane >> 3;
  const int r8 = lane & 7;

  // this thread's two A rows (16-byte chunks c of rows ar[i]) per stage
  const bf16* arow[2];
  int abytes[2], arr[2], ac[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * kThreads;
    arr[i] = idx >> 2;
    ac[i] = (idx & 3) * 8;
    const int r = r0 + arr[i];
    const bool in = r < cnt;
    const int s = start + (in ? r : 0);
    const long long phys = a_rows != nullptr ? a_rows[s] : s;
    arow[i] = A + (size_t)phys * lda;
    abytes[i] = in ? 16 : 0;
  }

  auto stage = [&](int buf, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      cp_async16(&as[buf][arr[i]][ac[i]], arow[i] + k0 + ac[i], abytes[i]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kThreads;
      if constexpr (B_KMAJOR) {
        const int r = idx >> 4, c = (idx & 15) * 8;
        cp_async16(&bs[buf][r][c], Be + (size_t)(k0 + r) * ldb + n0 + c, 16);
      } else {
        const int r = idx >> 2, c = (idx & 3) * 8;
        cp_async16(&bs[buf][r][c], Be + (size_t)(n0 + r) * ldb + k0 + c, 16);
      }
    }
    cp_async_commit();
  };

  float acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.0f;

  const int nk = K / kBK;
  stage(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      stage(cur ^ 1, (kt + 1) * kBK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      unsigned a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldsm_x4(a[mt], &as[cur][wm * 64 + mt * 16 + ((j & 1) << 3) + r8]
                          [ks + ((j >> 1) << 3)]);
      unsigned b[2][4];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int col = pair_col<EPI>(wn, np);
        if constexpr (B_KMAJOR)
          ldsm_x4_trans(b[np], &bs[cur][ks + ((j & 1) << 3) + r8]
                                  [col + ((j >> 1) << 3)]);
        else
          ldsm_x4(b[np], &bs[cur][col + ((j >> 1) << 3) + r8]
                            [ks + ((j & 1) << 3)]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mt][nt], a[mt], b[nt >> 1][(nt & 1) * 2],
                   b[nt >> 1][(nt & 1) * 2 + 1]);
    }
    __syncthreads();
  }

  // accumulator (mt, nt) element q: row lane/4 (+8 for q >= 2), column
  // 2 (lane % 4) (+1 for odd q) of its 16 x 8 tile
  const int gr = lane >> 2;
  const int gc = (lane & 3) * 2;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = r0 + wm * 64 + mt * 16 + gr + 8 * h;
      if (lr >= cnt) continue;
      const size_t row = (size_t)(start + lr);
      if constexpr (EPI == kSwiglu) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int c = wn * 16 + nt * 8 + gc;  // gate column in the tile
          const float g0 = acc[mt][nt][2 * h], g1 = acc[mt][nt][2 * h + 1];
          const float u0 = acc[mt][nt + 2][2 * h];
          const float u1 = acc[mt][nt + 2][2 * h + 1];
          bf16* gu = C + row * N + n0 + c;
          store_bf16x2(gu, g0, g1);
          store_bf16x2(gu + kGroup, u0, u1);
          store_bf16x2(C2 + row * (N / 2) + (n0 / 2) + c, silu(g0) * u0,
                       silu(g1) * u1);
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = n0 + wn * 32 + nt * 8 + gc;
          const float d0 = acc[mt][nt][2 * h], d1 = acc[mt][nt][2 * h + 1];
          if constexpr (EPI == kStore) {
            store_bf16x2(C + row * N + col, d0, d1);
          } else {  // kSwigluBwd: col is a column of act, F = N
            const size_t at = row * (2 * (size_t)N) +
                              (size_t)(col / kGroup) * (2 * kGroup) +
                              (col % kGroup);
            const __nv_bfloat162 g2 =
                *reinterpret_cast<const __nv_bfloat162*>(G + at);
            const __nv_bfloat162 u2 =
                *reinterpret_cast<const __nv_bfloat162*>(G + at + kGroup);
            const float g[2] = {__low2float(g2), __high2float(g2)};
            const float u[2] = {__low2float(u2), __high2float(u2)};
            const float d[2] = {d0, d1};
            float dg[2], du[2];
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const float s = 1.0f / (1.0f + __expf(-g[q]));
              du[q] = d[q] * g[q] * s;
              dg[q] = d[q] * u[q] * s * (1.0f + g[q] * (1.0f - s));
            }
            store_bf16x2(C + at, dg[0], dg[1]);
            store_bf16x2(C + at + kGroup, du[0], du[1]);
          }
        }
      }
    }
}

// C[e] [M, N] f32 = sum over expert e's rows of A[row]^T B[row]: both
// operands staged k-major ([k][m], [k][n]) and read with ldmatrix.trans.
template <int EPI>
__global__ void __launch_bounds__(kThreads, 2)
moe_dw_kernel(const bf16* __restrict__ A, const int* __restrict__ a_rows,
          int lda, const bf16* __restrict__ Bm, int ldb,
          const int* __restrict__ offsets, float* __restrict__ C,
          float* __restrict__ C2, int M, int N) {
  __shared__ __align__(16) bf16 as[2][kBK][kPadN];
  __shared__ __align__(16) bf16 bs[2][kBK][kPadN];
  const int e = blockIdx.z;
  const int start = offsets[e];
  const int cnt = offsets[e + 1] - start;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wm = (tid >> 5) >> 2;
  const int wn = (tid >> 5) & 3;
  const int j = lane >> 3;
  const int r8 = lane & 7;

  auto stage = [&](int buf, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx >> 4, c = (idx & 15) * 8;
      const int k = k0 + r;
      const bool in = k < cnt;
      const int s = start + (in ? k : 0);
      const long long phys = a_rows != nullptr ? a_rows[s] : s;
      cp_async16(&as[buf][r][c], A + (size_t)phys * lda + m0 + c,
                 in ? 16 : 0);
      cp_async16(&bs[buf][r][c], Bm + (size_t)s * ldb + n0 + c,
                 in ? 16 : 0);
    }
    cp_async_commit();
  };

  float acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.0f;

  const int nk = (cnt + kBK - 1) / kBK;
  if (nk > 0) stage(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      stage(cur ^ 1, (kt + 1) * kBK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      unsigned a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldsm_x4_trans(a[mt], &as[cur][ks + ((j >> 1) << 3) + r8]
                                [wm * 64 + mt * 16 + ((j & 1) << 3)]);
      unsigned b[2][4];
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldsm_x4_trans(b[np], &bs[cur][ks + ((j & 1) << 3) + r8]
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

  const int gr = lane >> 2;
  const int gc = (lane & 3) * 2;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t m = (size_t)(m0 + wm * 64 + mt * 16 + gr + 8 * h);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + wn * 32 + nt * 8 + gc;
        const float2 v = make_float2(acc[mt][nt][2 * h],
                                     acc[mt][nt][2 * h + 1]);
        if constexpr (EPI == 0) {
          *reinterpret_cast<float2*>(C + ((size_t)e * M + m) * N + n) = v;
        } else {
          const int F = N / 2;
          const int w = n % (2 * kGroup);
          const int f = (n / (2 * kGroup)) * kGroup + (w % kGroup);
          float* dst = w < kGroup ? C : C2;
          *reinterpret_cast<float2*>(dst + ((size_t)e * M + m) * F + f) = v;
        }
      }
    }
}

template <bool KM, int EPI>
cudaError_t launch_rows(dim3 grid, cudaStream_t s, const bf16* A,
                        const int* rows, int lda, const bf16* B,
                        long long bst, int ldb, const int* off, bf16* C,
                        bf16* C2, const bf16* G, int N, int K) {
  moe_rows_kernel<KM, EPI><<<grid, kThreads, 0, s>>>(A, rows, lda, B, bst,
                                                     ldb, off, C, C2, G, N,
                                                     K);
  return cudaGetLastError();
}

}  // namespace

// Returns 0, or a cudaError_t / -1 for arguments the kernels do not take.
extern "C" int moe_rows_gemm(const void* A, const void* a_rows, int lda,
                             const void* B, int b_stride, int ldb,
                             int b_kmajor, const void* offsets, int experts,
                             int max_rows, void* C, void* C2, const void* G,
                             int N, int K, int epi, void* stream) {
  if (N % kBN || K % kBK || experts < 1 || max_rows < 1) return -1;
  if (epi == kSwiglu && (!b_kmajor || C2 == nullptr)) return -1;
  if (epi == kSwigluBwd && (b_kmajor || G == nullptr)) return -1;
  const dim3 grid(N / kBN, (max_rows + kBM - 1) / kBM, experts);
  if (grid.y > 65535 || grid.z > 65535) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* a = static_cast<const bf16*>(A);
  const int* r = static_cast<const int*>(a_rows);
  const bf16* b = static_cast<const bf16*>(B);
  const int* off = static_cast<const int*>(offsets);
  bf16* c = static_cast<bf16*>(C);
  bf16* c2 = static_cast<bf16*>(C2);
  const bf16* g = static_cast<const bf16*>(G);
  cudaError_t err;
  if (b_kmajor && epi == kStore)
    err = launch_rows<true, kStore>(grid, s, a, r, lda, b, b_stride, ldb,
                                    off, c, c2, g, N, K);
  else if (b_kmajor && epi == kSwiglu)
    err = launch_rows<true, kSwiglu>(grid, s, a, r, lda, b, b_stride, ldb,
                                     off, c, c2, g, N, K);
  else if (!b_kmajor && epi == kStore)
    err = launch_rows<false, kStore>(grid, s, a, r, lda, b, b_stride, ldb,
                                     off, c, c2, g, N, K);
  else if (!b_kmajor && epi == kSwigluBwd)
    err = launch_rows<false, kSwigluBwd>(grid, s, a, r, lda, b, b_stride,
                                         ldb, off, c, c2, g, N, K);
  else
    return -1;
  return static_cast<int>(err);
}

extern "C" int moe_dw_gemm(const void* A, const void* a_rows, int lda,
                           const void* Bm, int ldb, const void* offsets,
                           int experts, void* C, void* C2, int M, int N,
                           int epi, void* stream) {
  if (M % kBM || N % kBN || experts < 1) return -1;
  if (epi == 1 && (C2 == nullptr || N % (2 * kGroup))) return -1;
  if (epi != 0 && epi != 1) return -1;
  const dim3 grid(N / kBN, M / kBM, experts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* a = static_cast<const bf16*>(A);
  const int* r = static_cast<const int*>(a_rows);
  const bf16* b = static_cast<const bf16*>(Bm);
  const int* off = static_cast<const int*>(offsets);
  float* c = static_cast<float*>(C);
  float* c2 = static_cast<float*>(C2);
  if (epi == 0)
    moe_dw_kernel<0><<<grid, kThreads, 0, s>>>(a, r, lda, b, ldb, off, c,
                                               c2, M, N);
  else
    moe_dw_kernel<1><<<grid, kThreads, 0, s>>>(a, r, lda, b, ldb, off, c,
                                               c2, M, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* moe_error_string(int err) {
  if (err == -1) return "arguments the kernels do not take";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
