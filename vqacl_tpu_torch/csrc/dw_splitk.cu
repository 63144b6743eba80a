// Weight gradient out[D, F] = x^T g (K5), hand-written for Hopper (sm_90a),
// bound to PyTorch through a plain C entry point (ctypes).
//
// What it replaces. The Pallas TPU kernel `dw_kernel`, launched by
// `pallas_dw` in scripts/mm_bench.py: the MLP input projection's weight
// gradient x^T g with x [K, D] (the layer input, K = batch x sequence rows)
// and g [K, F] (the gradient of the projection's output), bf16 or f32, the
// sum over K in f32, an f32 result. The TPU kernel holds an output tile
// [D, F/nt] in VMEM across a sequential grid over K chunks (`pl.when` k == 0
// stores, later chunks add), so it sums the K chunks in order.
//
// What bounds it on the card. At the probe shape (K = 4480, D = 768,
// F = 3072, bf16) it reads x 6.9 MB and g 27.5 MB and writes 9.4 MB: 43.8 MB,
// 13.1 us at 3.35 TB/s, against 2*K*D*F = 21.1 GFLOP, 21.4 us on the bf16
// tensor cores (989 TFLOP/s): bound by its arithmetic, so the design is about
// keeping every SM's tensor cores fed for the whole launch.
//
// Three routes, chosen by ops/dw.py::dw_route before anything is built (a
// route that fails raises; none gives way to another):
//   wgmma  bf16 with D and F multiples of 8 and 16-byte-aligned bases (TMA
//          can describe both operands): dw_wgmma_kernel below.
//   mma    any other bf16 shape: one 128 x 128 tile per block, the whole of K
//          in order, mma.sync m16n8k16 on plain loads (dw_mma_kernel).
//   f32    scalar f32 FMAs, one 128 x 128 tile per block (dw_kernel).
//
// The wgmma route. Both operands are used as they lie in device memory: A = x^T
// is M-major (d contiguous in x) and B = g is N-major (f contiguous), and
// wgmma's transpose flags take both, so no x^T is ever formed. A block of 384
// threads per SM runs a producer warpgroup, whose one thread keeps TMA loads of
// [64 k x 64] boxes (128-byte swizzle) in flight into a ring of
// mbarrier-guarded stages, and two consumer warpgroups, each of which runs
// wgmma m64n256k16 over 64 of the block's 128 d rows with f32 sums in registers
// (setmaxnreg moves registers from the producer, 40, to them, 232). A block's
// tile is 128 (d) x 256 (f), with a ring of 4 stages of 48 KB (at N = 128, 6
// stages of 32 KB, the probe shape took 8 % longer on the card). Two blocks
// form a cluster, a unit of the plan, over a 256-row tile: each loads its own x
// boxes and half of g's boxes, multicast into both, so the pair reads g from L2
// once: with every SM busy, the stream of TMA loads from L2, more than the
// tensor cores, sets the main loop's pace.
//
// The stream-K plan. The tiles x 64-row k-blocks iterations, tile-major, are
// cut into one contiguous range per cluster (ops/dw.py::dw_plan computes the
// first iteration of each and passes it in; the ranges differ by at most one
// iteration), so every SM gets the same work whatever the number of tiles:
// the probe shape's 36 tiles x 70 k-blocks are 38 or 39 iterations on each
// of 66 clusters. A cluster walks its range in order;
// where its range starts inside a tile, its first piece of that tile is a
// partial sum, which each block writes to its own f32 slot of a workspace
// (kept in L2 ahead of other lines) and flags ready.
// The cluster that holds the tile's first k-block reaches that piece last in
// its range; each of its blocks then adds the partials of the following
// clusters' blocks of its rank, in the order of their k ranges, resets their
// flags for the next launch, and writes the tile. Each partial is the same
// wgmma sequence on the same data and the partials are added in a fixed
// order with no float atomics, so a launch gives the same bits every time on
// one card. The clusters are launched cooperatively: the launch guarantees
// they are all resident (or is refused), so a block waiting on a flag cannot
// wait on a block that never runs.
//
// The end of a range. A cluster's last piece leaves its ring idle, so a
// tile it finishes leaves through the ring: 128 columns at a time as
// 128-byte-swizzled TMA boxes (which drop what lies past D and F), while the
// partials of the next 128 columns arrive by bulk copy into two other
// slots, in the order they are added. Partials, and tiles finished inside a
// range, are stored from registers. On an H100 this end makes the probe
// shape about 5 % faster than reading the partials from L2 into registers
// and storing the tile from there.
//
// The kernel allocates nothing: the plan (int32 [clusters + 1]) and the
// workspace (blocks x 128 x 256 f32 partials, then blocks int32 flags, zeroed
// once) come from the wrapper, which caches them per device and stream.
// Tensor maps are encoded on the host with cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint (no link against the driver library), and
// passed as __grid_constant__ parameters. ptxas (CUDA 12.9): 168 registers
// at launch, no spills; the mma route 118, the f32 route 123.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace {

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

// The mma route (bf16 shapes TMA cannot describe). Same tile and order as
// the f32 route: the block owns a 128 x 128 output tile and walks K in
// order, 32 rows of x and g per step, kept k-major in shared memory ([k][d]
// and [k][f], rows padded to 136 elements so the 8 rows an ldmatrix reads
// fall on distinct banks). Both mma operands come out of those k-major tiles
// with ldmatrix.trans: a [k][d] slice transposed is the row-major A = x^T
// fragment, a [k][f] slice transposed the column-major B = g fragment. Eight
// warps each own 64 x 32 outputs: 4 x 4 mma.sync m16n8k16 tiles, bf16
// operands, f32 sums in registers. The next step's tiles are loaded into the
// second buffer before the current one is multiplied.
constexpr int kMmaBK = 32;
constexpr int kLd = kBD + 8;

// Stage rows k0 .. k0+31 of x[:, d0:d0+128] and g[:, f0:f0+128], zero past
// the edges.
__device__ __forceinline__ void stage_tiles(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
    __nv_bfloat16 (*xs)[kLd], __nv_bfloat16 (*gs)[kLd], int k0, int d0,
    int f0, int K, int D, int F, int tid) {
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
#pragma unroll 4
  for (int l = 0; l < kMmaBK * kBD / kThreads; ++l) {
    const int idx = tid + l * kThreads;
    const int r = idx / kBD;
    const int col = idx - r * kBD;
    const int k = k0 + r;
    xs[r][col] = (k < K && d0 + col < D) ? x[(size_t)k * D + d0 + col] : zero;
    gs[r][col] = (k < K && f0 + col < F) ? g[(size_t)k * F + f0 + col] : zero;
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
  stage_tiles(x, g, xs[0], gs[0], 0, d0, f0, K, D, F, tid);
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk)
      stage_tiles(x, g, xs[cur ^ 1], gs[cur ^ 1], (kt + 1) * kMmaBK, d0, f0,
                  K, D, F, tid);
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

// ---- the wgmma route --------------------------------------------------------

constexpr int kWgBM = 128;  // d rows per block: two consumer warpgroups x 64
constexpr int kWgBN = 256;  // f columns per block (one m64n256 wgmma)
constexpr int kCluster = 2;  // blocks per cluster: a unit's tile is 256 rows
constexpr int kWgBK = 64;   // k rows per iteration (one box deep)
constexpr int kBox = 64;    // a TMA box: 64 k rows x 64 bf16 (128 bytes)
constexpr int kBoxBytes = kBox * kBox * 2;
constexpr int kWgThreads = 384;        // warpgroups 0, 1 consume; 2 loads
constexpr int kConsumerThreads = 256;
constexpr int kKStepBytes = 16 * 128;  // one wgmma's 16 k rows of a box
constexpr int kSbo = 8 * 128;          // 8 k rows: one swizzle period
constexpr int kLbo = kBoxBytes;        // next 64 columns of g: the next box
constexpr int kStages = 4;
constexpr int kABytes = 2 * kBoxBytes;           // x: d0 .. d0+127
constexpr int kBBoxes = kWgBN / kBox;            // g: f0 .. f0+255
constexpr int kStageBytes = kABytes + kBBoxes * kBoxBytes;  // 48 KB
constexpr int kAcc = kWgBN / 2;  // f32 sums per consumer thread
constexpr int kOutBox = kWgBM * 128;      // an output box: 128 rows x 32 f32
constexpr int kChunkBytes = 4 * kOutBox;  // 128 columns of a block's tile
constexpr int kGroups = kWgBN / 128;      // 128-column groups of a tile
// the ring, its full and empty barriers, the two chunk slots' barriers, and
// room to align the ring to 1024
constexpr int kSmem = kStages * kStageBytes + (2 * kStages + 2) * 8 + 1024;
static_assert(3 * kChunkBytes <= kStages * kStageBytes,
              "three chunks of 128 columns fit the ring");

// A cluster of two blocks per unit of the plan: unit u runs iterations
// plan[u] .. plan[u+1] - 1 (see the note at the top). Iteration it is tile
// it / kbs (256-row d tile (it / kbs) / tiles_f, f tile the rest) at k-block
// it % kbs; block rank r of the cluster takes the tile's rows 128r .. 128r +
// 127, loads its own x boxes, and loads half of g's boxes into both blocks.
__global__ void __launch_bounds__(kWgThreads, 1)
dw_wgmma_kernel(const __grid_constant__ CUtensorMap tmx,
                const __grid_constant__ CUtensorMap tmg,
                const __grid_constant__ CUtensorMap tmo,
                float* __restrict__ out, const int* __restrict__ plan,
                float* __restrict__ part, int* __restrict__ flags, int D,
                int F, int kbs, int tiles_f) {
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  uint64_t* landed = empty + kStages;  // [2]: partial chunks copied in
  const int rank = (int)cluster_rank();
  const int unit = blockIdx.x / kCluster;
  const int units = gridDim.x / kCluster;
  const int start = plan[unit];
  const int end = plan[unit + 1];
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      // every consumer warp of the cluster releases the stage: the other
      // block's loads write into it too
      mbar_init(&empty[s], kCluster * kConsumerThreads / 32);
    }
    mbar_init(&landed[0], 1);
    mbar_init(&landed[1], 1);
    fence_mbar_init();
  }
  cluster_sync();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread keeps the ring full -------------------------
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      int stage = 0;
      unsigned phase = 0;
      for (int it = start; it < end; ++it) {
        const int tile = it / kbs;
        const int td = tile / tiles_f;
        const int d0 = (td * kCluster + rank) * kWgBM;
        const int f0 = (tile - td * tiles_f) * kWgBN;
        const int k0 = (it - tile * kbs) * kWgBK;
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* st = ring + stage * kStageBytes;
        mbar_arrive_expect_tx(&full[stage], kStageBytes);
        tma_load_2d(st, &tmx, &full[stage], d0, k0);
        tma_load_2d(st + kBoxBytes, &tmx, &full[stage], d0 + kBox, k0);
#pragma unroll
        for (int j = 0; j < kBBoxes / kCluster; ++j) {
          const int box = rank * (kBBoxes / kCluster) + j;
          tma_load_2d_multicast(st + kABytes + box * kBoxBytes, &tmg,
                                &full[stage], f0 + box * kBox, k0,
                                (1 << kCluster) - 1);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      // stay until every consumer of the cluster has released every stage:
      // the other block arrives on these barriers until then
      for (int s = 0; s < kStages; ++s) {
        mbar_wait(&empty[stage], phase ^ 1);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns d rows wg*64 .. wg*64+63 ------------
    setmaxnreg_inc<232>();
    const int ctid = threadIdx.x;  // 0 .. 255
    const int lane = ctid & 31;
    const int warp = (ctid >> 5) & 3;
    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
    int stage = 0;
    unsigned phase = 0;
    for (int it = start; it < end;) {
      const int tile = it / kbs;
      const int seg0 = it;
      const int seg1 = min(end, (tile + 1) * kbs);
      const int kb0 = seg0 - tile * kbs;
      const int kb1 = seg1 - tile * kbs;
      const int td = tile / tiles_f;
      const int d0 = (td * kCluster + rank) * kWgBM;
      const int f0 = (tile - td * tiles_f) * kWgBN;

      // the piece's products, in k order, one stage in flight behind
      int prev = -1;
      for (; it < seg1; ++it) {
        mbar_wait(&full[stage], phase);
        const unsigned st = smem_u32(ring + stage * kStageBytes);
        const uint64_t da = desc_mn_sw128(st + wg * kBoxBytes, kLbo, kSbo);
        const uint64_t db = desc_mn_sw128(st + kABytes, kLbo, kSbo);
        fence_operands(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWgBK / 16; ++kk)
          wgmma_mn(acc, da + ((kk * kKStepBytes) >> 4),
                   db + ((kk * kKStepBytes) >> 4),
                   (it != seg0 || kk != 0) ? 1 : 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_operands(acc);
        if (prev >= 0 && lane < kCluster)
          mbar_arrive_cluster(&empty[prev], lane);
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_operands(acc);
      if (lane < kCluster) mbar_arrive_cluster(&empty[prev], lane);

      const bool last = it == end;  // the ring is idle from here on
      const int slot = unit * kCluster + rank;
      if (kb0 != 0) {
        // a later piece of a tile another unit finishes: the partial sums,
        // as float4 [i / 4][thread], to this block's slot, then its flag
        float4* p = reinterpret_cast<float4*>(part) +
                    (size_t)slot * (kWgBM * kWgBN / 4) + ctid;
#pragma unroll
        for (int i = 0; i < kAcc; i += 4)
          st_keep(p + (i / 4) * kConsumerThreads,
                  make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]));
        named_bar_sync(1, kConsumerThreads);
        if (ctid == 0) {
          __threadfence();
          st_release(&flags[slot], 1);
        }
        continue;
      }
      // the finished tile: register i of thread (warp, lane) is row
      // 16*warp + lane/4 + 8*((i/2)%2), column 8*(i/4) + 2*(lane%4) + i%2
      const int rl = wg * 64 + warp * 16 + (lane >> 2);
      if (!last) {  // a whole tile inside the range: straight from registers
        const int c = f0 + 2 * (lane & 3);
#pragma unroll
        for (int i = 0; i < kAcc; i += 4) {
          store_pair(out, d0 + rl, c + 2 * i, D, F, acc[i], acc[i + 1]);
          store_pair(out, d0 + rl + 8, c + 2 * i, D, F, acc[i + 2],
                     acc[i + 3]);
        }
        continue;
      }
      // The unit's last piece: a whole tile, or the tile's first piece,
      // whose following units' m partials (their blocks of this rank) are
      // added in the order of their k ranges. Both go out through the idle
      // ring, one group of 128 columns at a time: each partial's 64 KB of
      // the group is copied into one of two slots (the next copy in flight
      // while one is added), then the group is written into the third slot
      // as four 128-byte-swizzled boxes of 128 rows x 32 columns (16-byte
      // chunk c of row r at c ^ (r % 8)) and stored by TMA, which drops
      // what lies past D and F, while the next group's partials arrive.
      const int tile_end = (tile + 1) * kbs;
      int m = 0;
      if (kb1 != kbs)
        while (unit + 1 + m < units && plan[unit + 1 + m] < tile_end) ++m;
      const int chunks = kGroups * m;
      uint8_t* out_slot = ring + 2 * kChunkBytes;
      auto fetch = [&](int c) {  // thread 0: chunk c = (group, partial)
        const int g = c / m;
        const int other = (unit + 1 + c - g * m) * kCluster + rank;
        if (g == 0) {
          while (ld_acquire(&flags[other]) == 0) {
          }
          flags[other] = 0;
          fence_proxy_async();
        }
        mbar_arrive_expect_tx(&landed[c & 1], kChunkBytes);
        bulk_load(ring + (c & 1) * kChunkBytes,
                  part + (size_t)other * (kWgBM * kWgBN) +
                      g * (kChunkBytes / 4),
                  kChunkBytes, &landed[c & 1]);
      };
      if (ctid == 0) {
        if (chunks > 0) fetch(0);
        if (chunks > 1) fetch(1);
      }
      int c = 0;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        for (int k = 0; k < m; ++k, ++c) {
          mbar_wait(&landed[c & 1], (c >> 1) & 1);
          const float4* buf =
              reinterpret_cast<const float4*>(ring + (c & 1) * kChunkBytes) +
              ctid;
#pragma unroll
          for (int q = 0; q < 16; ++q) {
            const float4 v = buf[q * kConsumerThreads];
            acc[64 * g + 4 * q] += v.x;
            acc[64 * g + 4 * q + 1] += v.y;
            acc[64 * g + 4 * q + 2] += v.z;
            acc[64 * g + 4 * q + 3] += v.w;
          }
          named_bar_sync(1, kConsumerThreads);  // the slot is free again
          if (ctid == 0 && c + 2 < chunks) fetch(c + 2);
        }
        if (g > 0) {  // the last group's boxes have left the third slot
          if (ctid == 0) bulk_wait_read();
          named_bar_sync(1, kConsumerThreads);
        }
#pragma unroll
        for (int j = 16 * g; j < 16 * g + 16; ++j) {
          const int chunk = 2 * (j & 3) + ((lane & 3) >> 1);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = rl + 8 * h;
            *reinterpret_cast<float2*>(
                out_slot + ((j >> 2) & 3) * kOutBox + row * 128 +
                ((chunk ^ (row & 7)) << 4) + (lane & 1) * 8) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          }
        }
        fence_proxy_async_smem();
        named_bar_sync(1, kConsumerThreads);
        if (ctid == 0) {
#pragma unroll
          for (int b = 0; b < 4; ++b)
            tma_store_2d(&tmo, out_slot + b * kOutBox, f0 + 128 * g + 32 * b,
                         d0);
          bulk_commit();
        }
      }
      if (ctid == 0) bulk_wait_read();
    }
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

cudaError_t launch_mma(const void* x, const void* g, float* out, int K,
                       int D, int F, cudaStream_t stream) {
  const dim3 grid((F + kBF - 1) / kBF, (D + kBD - 1) / kBD);
  dw_mma_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(g), out, K, D, F);
  return cudaGetLastError();
}

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
const EncodeEntry& encode_entry() {
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
cudaError_t box_map(CUtensorMap* map, const void* base, int rows, int cols,
                    bool f32, int box_rows) {
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

// The launch of a unit's cluster: two blocks, dynamic shared memory set.
cudaError_t cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                           int units, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      dw_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(kCluster * units);
  cfg->blockDim = dim3(kWgThreads);
  cfg->dynamicSmemBytes = kSmem;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // all blocks resident at once, or the launch is refused
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 2;
  return cudaSuccess;
}

cudaError_t launch_wgmma(const void* x, const void* g, float* out, int K,
                         int D, int F, const int* plan, void* workspace,
                         int units, cudaStream_t stream) {
  const bool boxes = D % 8 == 0 && F % 8 == 0 &&
                     ((reinterpret_cast<uintptr_t>(x) |
                       reinterpret_cast<uintptr_t>(g)) % 16) == 0;
  if (!boxes || workspace == nullptr || units < 1)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  cudaError_t err = cluster_config(&cfg, attr, units, stream);
  if (err != cudaSuccess) return err;
  CUtensorMap tmx, tmg, tmo;
  if ((err = box_map(&tmx, x, K, D, false, kBox)) != cudaSuccess) return err;
  if ((err = box_map(&tmg, g, K, F, false, kBox)) != cudaSuccess) return err;
  if ((err = box_map(&tmo, out, D, F, true, kWgBM)) != cudaSuccess)
    return err;
  float* part = static_cast<float*>(workspace);
  int* flags =
      reinterpret_cast<int*>(part + (size_t)kCluster * units * kWgBM * kWgBN);
  const int kbs = (K + kWgBK - 1) / kWgBK;
  const int tiles_f = (F + kWgBN - 1) / kWgBN;
  err = cudaLaunchKernelEx(&cfg, dw_wgmma_kernel, tmx, tmg, tmo, out, plan,
                           part, flags, D, F, kbs, tiles_f);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// K5. x [K, D] and g [K, F] row-major in one dtype (0 = float32,
// 1 = bfloat16); out [D, F] f32 row-major, every element written. The route
// is the caller's: f32 for dtype 0; for bf16, the mma route when plan is
// null, else the wgmma route on n_blocks blocks, two to a cluster: plan is
// the first iteration of each cluster and the total (int32 [n_blocks / 2 +
// 1], ops/dw.py::dw_plan), and workspace n_blocks x 128 x 256 f32 partials
// followed by n_blocks int32 flags, zero before the first launch and left
// zero by every launch. The last three arguments follow the stream so that
// a library from before them still lines up (it takes its own route).
// Returns the cudaError_t of the launch; 0 means it was accepted.
extern "C" int dw_splitk(const void* x, const void* g, void* out, int K,
                         int D, int F, int dtype, void* stream,
                         const int* plan, void* workspace, int n_blocks) {
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_f32(x, g, o, K, D, F, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (plan == nullptr) return (int)launch_mma(x, g, o, K, D, F, s);
  if (n_blocks % kCluster) return (int)cudaErrorInvalidValue;
  return (int)launch_wgmma(x, g, o, K, D, F, plan, workspace,
                           n_blocks / kCluster, s);
}

// The most blocks of the wgmma route that the current device holds at once
// (whole clusters), into *blocks (an int). Returns the cudaError_t.
extern "C" int dw_splitk_wgmma_blocks(void* blocks) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  int units = 0;
  cudaError_t err = cluster_config(&cfg, attr, 1, nullptr);
  if (err == cudaSuccess) {
    cfg.numAttrs = 1;  // the cluster shape alone
    err = cudaOccupancyMaxActiveClusters(&units, dw_wgmma_kernel, &cfg);
  }
  *static_cast<int*>(blocks) = kCluster * units;
  return (int)err;
}

// Message for a cudaError_t returned above.
extern "C" const char* dw_splitk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
