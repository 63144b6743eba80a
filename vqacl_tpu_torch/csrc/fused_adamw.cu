// The train step's optimizer as one multi-tensor kernel pair, hand-written
// for Hopper (sm_90a), bound to PyTorch through a plain C entry (ctypes).
//
// Not a port of a Pallas kernel: it is the counterpart of the optimizer
// XLA fuses inside the JAX package's jitted train step (optax's clip,
// HF or torch AdamW, masked decoupled decay, freeze mask, warmup schedule
// and p - lr·u), which eager PyTorch runs as ~25 launches per leaf.
//
// Contract (ops/adamw.py::fused_adamw). Per leaf i of the tree in sorted-
// key order: g_i f32, p_i f32, m_i and v_i in the moment dtype (f32 or
// bf16), all contiguous but g_i, which may be the rows of a 2-D leaf
// gcols[i] long and gstride[i] apart (a column slice of a merged q/k/v
// projection's gradient; gcols[i] 0: contiguous). Outputs go to fresh
// flat buffers at the offsets
// of a plan computed once on the host (ops/adamw.py::adamw_plan): p_out
// f32, m_out and v_out in the moment dtype; scal_out = [lr, ‖g‖] f32 and
// count_out int32. Inputs are never written.
//
// Numerics: the eager chain's operations in its order, each rounded on
// its own (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn: no
// contraction into FMAs), the moments stored round-to-nearest-even, and
// powf for β^t as torch.pow computes it on the card. Given the same ‖g‖
// the new parameters and moments equal the eager chain's bit for bit.
// ‖g‖ itself is √(Σ g²) with the squares and sums in f64 (exact products,
// a fixed order), rounded to f32 once before the square root: it may
// differ from global_norm's f32 sums in the last bits, and is the same on
// every launch.
//
// Design. Two kernels on the caller's stream, for a tree of up to
// kMaxLeaves leaves (t5-base's has 264). The leaves' addresses travel by
// value in the kernel's parameters (a LeafTable of 20 KiB, CUDA 12.1+),
// so a step copies nothing to the card.
//  1. sq_norm_kernel: kNormBlocks blocks (a fixed count, 4 x the H100's
//     132 SMs), block b sums g² over the plan's chunks b, b + kNormBlocks,
//     ... in f64 and writes its sum to partials[b]: a fixed slot, no
//     atomics. Skipped when the caller gives the norm (FSDP and tp
//     layouts reduce it over their ranks).
//  2. adamw_apply_kernel: a persistent grid (SMs x resident blocks).
//     Every block first sums the partials in the same fixed order (so all
//     agree on ‖g‖ bit for bit) and derives the step's scalars on the
//     card: count + 1 saturating at INT32_MAX, the bias correction (HF:
//     √(1−β₂ᵗ)/(1−β₁ᵗ); torch: 1−β₁ᵗ and 1−β₂ᵗ), the warmup schedule's
//     lr from the step and [warmup, t_total]. Then each block walks its
//     chunks: per element the optax clip, the moments in f32, the
//     direction, + wd·p where the leaf decays, zero where it is frozen,
//     p − lr·u. 16-byte loads and stores where a chunk's inputs and
//     outputs are aligned (the outputs follow each other in the flat
//     buffers: all are when every leaf's size is a multiple of 4, as in
//     T5's and BART's trees), scalar otherwise and for tails.
//
// What bounds it. Bytes: per parameter 4 (g, norm pass) + 4 + 4 + 2 + 2
// read and 4 + 2 + 2 written with bf16 moments, 24 B (32 B with f32); at
// t5-base's 224 M parameters 5.4 GB, 1.6 ms at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNormBlocks = 528;  // partial slots (ops/adamw.py)
constexpr int kMaxLeaves = 512;   // leaves of a tree (ops/adamw.py)
constexpr int kMaxDevices = 64;
constexpr int kWarps = kThreads / 32;

// each leaf's gradient: its address, and for a strided 2-D leaf its row
// length and row stride in elements (cols 0: contiguous)
struct GradTable {
  const float* g[kMaxLeaves];
  int cols[kMaxLeaves];
  int stride[kMaxLeaves];
};

struct LeafTable {
  GradTable g;
  const float* p[kMaxLeaves];
  const void* m[kMaxLeaves];
  const void* v[kMaxLeaves];
};

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd, lr, max_norm;
  int linear;  // 0: constant_warmup, 1: linear_warmup
};

// the step's scalars, one copy per block
struct Coef {
  float gn, max_norm, b1, omb1, b2, omb2, eps, wd, lr, corr, b1c, b2c;
  int keep;  // ‖g‖ < max_norm: the gradient is used unclipped
};

// one chunk of the plan: three int64 words (leaf | flags << 32,
// start | len << 32, flat output offset)
struct Chunk {
  int leaf, flags, start, len;
  long long out;
};

__device__ __forceinline__ Chunk load_chunk(const long long* plan, int c) {
  const unsigned long long a = plan[3 * c], b = plan[3 * c + 1];
  Chunk k;
  k.leaf = static_cast<int>(a & 0xffffffffull);
  k.flags = static_cast<int>(a >> 32);
  k.start = static_cast<int>(b & 0xffffffffull);
  k.len = static_cast<int>(b >> 32);
  k.out = plan[3 * c + 2];
  return k;
}

__device__ __forceinline__ bool aligned(const void* x, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(x) & (bytes - 1)) == 0;
}

// leaf i's gradient at element e of its row-major order
__device__ __forceinline__ const float* grad_at(const GradTable& t, int i,
                                                int e) {
  const int cols = t.cols[i];
  if (cols == 0) return t.g[i] + e;
  const int r = e / cols;
  return t.g[i] + static_cast<long long>(r) * t.stride[i] + (e - r * cols);
}

// whether leaf i's gradient reads in aligned float4s from any multiple of
// 4 (the plan's chunks start at multiples of CHUNK): a strided leaf's
// rows and row stride are multiples of 4, so no float4 crosses a row
__device__ __forceinline__ bool grad_vec(const GradTable& t, int i) {
  return aligned(t.g[i], 16) &&
         (t.cols[i] == 0 || ((t.cols[i] | t.stride[i]) & 3) == 0);
}

// Σ over the block in a fixed order (butterfly within warps, then warp
// sums in order); valid in thread 0
__device__ __forceinline__ double block_sum(double x, double* sh) {
  for (int o = 16; o > 0; o >>= 1)
    x = __dadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = x;
  __syncthreads();
  double t = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) t = __dadd_rn(t, sh[w]);
  return t;
}

__device__ __forceinline__ double add_sq(double acc, float x) {
  const double d = static_cast<double>(x);
  return __dadd_rn(acc, __dmul_rn(d, d));  // the product is exact
}

__global__ void __launch_bounds__(kThreads)
sq_norm_kernel(GradTable t, const long long* __restrict__ plan,
               int n_chunks, double* __restrict__ partials) {
  __shared__ double sh[kWarps];
  double acc = 0.0;
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const Chunk k = load_chunk(plan, c);
    int done = 0;
    if (grad_vec(t, k.leaf)) {
      const int nv = k.len >> 2;
#pragma unroll 4
      for (int j = threadIdx.x; j < nv; j += kThreads) {
        const float4 x = __ldcs(reinterpret_cast<const float4*>(
            grad_at(t, k.leaf, k.start + 4 * j)));
        acc = add_sq(add_sq(add_sq(add_sq(acc, x.x), x.y), x.z), x.w);
      }
      done = nv << 2;
    }
    for (int j = done + threadIdx.x; j < k.len; j += kThreads)
      acc = add_sq(acc, __ldcs(grad_at(t, k.leaf, k.start + j)));
  }
  const double s = block_sum(acc, sh);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// moment storage: f32, or bf16 bits (uint16_t) rounded to nearest even as
// PyTorch's cast on the card rounds them (cvt.rn.bf16.f32)
template <typename MT>
struct Mom;

template <>
struct Mom<float> {
  static constexpr uintptr_t kVecBytes = 16;
  static __device__ void load4(const float* x, int j, float (&o)[4]) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(x) + j);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  }
  static __device__ void store4(float* x, int j, const float (&o)[4]) {
    __stcs(reinterpret_cast<float4*>(x) + j, make_float4(o[0], o[1], o[2],
                                                         o[3]));
  }
  static __device__ float load1(const float* x, int i) { return __ldcs(x + i); }
  static __device__ void store1(float* x, int i, float f) { __stcs(x + i, f); }
};

__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ unsigned short to_bf16(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

template <>
struct Mom<uint16_t> {
  static constexpr uintptr_t kVecBytes = 8;
  static __device__ void load4(const uint16_t* x, int j, float (&o)[4]) {
    const uint2 a = __ldcs(reinterpret_cast<const uint2*>(x) + j);
    o[0] = bf16_lo(a.x); o[1] = bf16_hi(a.x);
    o[2] = bf16_lo(a.y); o[3] = bf16_hi(a.y);
  }
  static __device__ void store4(uint16_t* x, int j, const float (&o)[4]) {
    uint2 a;
    a.x = static_cast<unsigned>(to_bf16(o[0])) |
          (static_cast<unsigned>(to_bf16(o[1])) << 16);
    a.y = static_cast<unsigned>(to_bf16(o[2])) |
          (static_cast<unsigned>(to_bf16(o[3])) << 16);
    __stcs(reinterpret_cast<uint2*>(x) + j, a);
  }
  static __device__ float load1(const uint16_t* x, int i) {
    return bf16_lo(static_cast<unsigned>(__ldcs(
        reinterpret_cast<const unsigned short*>(x) + i)));
  }
  static __device__ void store1(uint16_t* x, int i, float f) {
    x[i] = to_bf16(f);
  }
};

// x.clamp_min(lo) as PyTorch computes it: NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// One element of the chain, in the eager functions' order
// (train/optim.py): clip → moments → direction → decay → freeze → p − lr·u.
// IMPL 0: scale_by_hf_adamw; 1: scale_by_adam (its f32 branch when F32M).
template <int IMPL, bool F32M>
__device__ __forceinline__ void adamw_one(const Coef& k, bool decay,
                                          bool train, float g, float p,
                                          float m, float v, float& p2,
                                          float& m2, float& v2) {
  if (!k.keep) g = __fmul_rn(__fdiv_rn(g, k.gn), k.max_norm);
  if (IMPL == 1 && F32M) {
    m2 = __fadd_rn(__fmul_rn(k.omb1, g), __fmul_rn(k.b1, m));
    v2 = __fadd_rn(__fmul_rn(k.omb2, __fmul_rn(g, g)), __fmul_rn(k.b2, v));
  } else {
    m2 = __fadd_rn(__fmul_rn(k.b1, m), __fmul_rn(k.omb1, g));
    v2 = __fadd_rn(__fmul_rn(k.b2, v), __fmul_rn(__fmul_rn(k.omb2, g), g));
  }
  float u;
  if (IMPL == 0)
    u = __fdiv_rn(__fmul_rn(k.corr, m2), __fadd_rn(__fsqrt_rn(v2), k.eps));
  else
    u = __fdiv_rn(__fdiv_rn(m2, k.b1c),
                  __fadd_rn(__fsqrt_rn(__fdiv_rn(v2, k.b2c)), k.eps));
  if (decay) u = __fadd_rn(u, __fmul_rn(k.wd, p));
  if (!train) u = 0.f;
  p2 = __fsub_rn(p, __fmul_rn(k.lr, u));
}

// the step's scalars from the device state (thread 0 of each block)
__device__ Coef step_coef(const Hyper& h, float gn, int count, int step,
                          const float* sched, int* count_new) {
  Coef k;
  k.gn = gn;
  k.max_norm = h.max_norm;
  k.keep = gn < h.max_norm;
  k.b1 = h.b1; k.omb1 = h.omb1; k.b2 = h.b2; k.omb2 = h.omb2;
  k.eps = h.eps; k.wd = h.wd;
  // _safe_increment, then count.float() and base ** c in f32
  const int cnt = count < 0x7fffffff ? count + 1 : count;
  *count_new = cnt;
  const float c = __int2float_rn(cnt);
  const float pb1 = powf(h.b1, c), pb2 = powf(h.b2, c);
  k.b1c = __fsub_rn(1.f, pb1);
  k.b2c = __fsub_rn(1.f, pb2);
  k.corr = __fdiv_rn(__fsqrt_rn(k.b2c), k.b1c);
  // dynamic_lr(step.float(), sched, lr, kind)
  const float s = __int2float_rn(step);
  const float warmup = sched[0];
  const float t_total = clamp_min(sched[1], 1.f);
  const float wu = __fdiv_rn(s, clamp_min(warmup, 1.f));
  float f;
  if (h.linear) {
    float d = __fdiv_rn(__fsub_rn(t_total, s),
                        clamp_min(__fsub_rn(t_total, warmup), 1.f));
    if (!isnan(d)) d = fminf(fmaxf(d, 0.f), 1.f);
    f = s < warmup ? wu : d;
  } else {
    f = s < warmup ? wu : 1.f;
  }
  k.lr = __fmul_rn(h.lr, f);
  return k;
}

template <typename MT, int IMPL>
__global__ void __launch_bounds__(kThreads)
adamw_apply_kernel(LeafTable t, const long long* __restrict__ plan,
                   int n_chunks, const double* __restrict__ partials,
                   const float* __restrict__ gnorm_in,
                   const int* __restrict__ count_in,
                   const int* __restrict__ step_in,
                   const float* __restrict__ sched, float* __restrict__ p_out,
                   MT* __restrict__ m_out, MT* __restrict__ v_out,
                   float* __restrict__ scal_out, int* __restrict__ count_out,
                   Hyper h) {
  constexpr bool kF32M = sizeof(MT) == 4;
  __shared__ double sh[kWarps];
  __shared__ Coef coef;
  float gn = 0.f;
  if (gnorm_in != nullptr) {
    gn = *gnorm_in;
  } else {
    double acc = 0.0;
    for (int i = threadIdx.x; i < kNormBlocks; i += kThreads)
      acc = __dadd_rn(acc, partials[i]);
    gn = __fsqrt_rn(__double2float_rn(block_sum(acc, sh)));
  }
  if (threadIdx.x == 0) {
    int cnt;
    coef = step_coef(h, gn, *count_in, *step_in, sched, &cnt);
    if (blockIdx.x == 0) {
      scal_out[0] = coef.lr;
      scal_out[1] = gn;
      *count_out = cnt;
    }
  }
  __syncthreads();
  const Coef k = coef;

  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const Chunk ch = load_chunk(plan, c);
    const int li = ch.leaf;
    const float* p = t.p[li] + ch.start;
    const MT* m = static_cast<const MT*>(t.m[li]) + ch.start;
    const MT* v = static_cast<const MT*>(t.v[li]) + ch.start;
    float* po = p_out + ch.out;
    MT* mo = m_out + ch.out;
    MT* vo = v_out + ch.out;
    const bool decay = ch.flags & 1, train = ch.flags & 2;
    int done = 0;
    if (grad_vec(t.g, li) && aligned(p, 16) && aligned(po, 16) &&
        aligned(m, Mom<MT>::kVecBytes) && aligned(v, Mom<MT>::kVecBytes) &&
        aligned(mo, Mom<MT>::kVecBytes) && aligned(vo, Mom<MT>::kVecBytes)) {
      const int nv = ch.len >> 2;
#pragma unroll 2
      for (int j = threadIdx.x; j < nv; j += kThreads) {
        const float4 g4 = __ldcs(reinterpret_cast<const float4*>(
            grad_at(t.g, li, ch.start + 4 * j)));
        const float4 p4 = __ldcs(reinterpret_cast<const float4*>(p) + j);
        float mm[4], vv[4], p2[4], m2[4], v2[4];
        Mom<MT>::load4(m, j, mm);
        Mom<MT>::load4(v, j, vv);
        const float gg[4] = {g4.x, g4.y, g4.z, g4.w};
        const float pp[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          adamw_one<IMPL, kF32M>(k, decay, train, gg[e], pp[e], mm[e], vv[e],
                                 p2[e], m2[e], v2[e]);
        __stcs(reinterpret_cast<float4*>(po) + j,
               make_float4(p2[0], p2[1], p2[2], p2[3]));
        Mom<MT>::store4(mo, j, m2);
        Mom<MT>::store4(vo, j, v2);
      }
      done = nv << 2;
    }
    for (int j = done + threadIdx.x; j < ch.len; j += kThreads) {
      float p2, m2, v2;
      adamw_one<IMPL, kF32M>(k, decay, train,
                             __ldcs(grad_at(t.g, li, ch.start + j)),
                             __ldcs(p + j),
                             Mom<MT>::load1(m, j), Mom<MT>::load1(v, j), p2,
                             m2, v2);
      __stcs(po + j, p2);
      Mom<MT>::store1(mo, j, m2);
      Mom<MT>::store1(vo, j, v2);
    }
  }
}

// resident blocks of each apply instance per device (0: not read yet)
int g_resident[kMaxDevices][4];

template <typename MT, int IMPL>
int apply_grid(int dev, int slot) {
  int& r = g_resident[dev][slot];
  if (r == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, adamw_apply_kernel<MT, IMPL>, kThreads, 0) !=
            cudaSuccess)
      return 0;
    r = sms * (per_sm > 0 ? per_sm : 1);
  }
  return r;
}

// the gradients' table from ptrs[0 .. n) and gshape [2][n] (cols, stride)
GradTable grad_table(const uint64_t* ptrs, const int* gshape, int n) {
  GradTable t;
  for (int i = 0; i < kMaxLeaves; ++i) {
    const bool in = i < n;
    t.g[i] = in ? reinterpret_cast<const float*>(ptrs[i]) : nullptr;
    t.cols[i] = in ? gshape[i] : 0;
    t.stride[i] = in ? gshape[n + i] : 0;
  }
  return t;
}

template <typename MT, int IMPL>
cudaError_t launch_apply(const uint64_t* ptrs, const int* gshape,
                         int n_leaves, int n_chunks,
                         const long long* plan, const double* partials,
                         const float* gnorm_in, const int* count_in,
                         const int* step_in, const float* sched, void* p_out,
                         void* m_out, void* v_out, void* scal_out,
                         void* count_out, const Hyper& h, int dev, int slot,
                         cudaStream_t s) {
  const int grid = apply_grid<MT, IMPL>(dev, slot);
  if (grid == 0) return cudaErrorInvalidConfiguration;
  LeafTable t;
  t.g = grad_table(ptrs, gshape, n_leaves);
  for (int i = 0; i < kMaxLeaves; ++i) {
    const bool in = i < n_leaves;
    t.p[i] = in ? reinterpret_cast<const float*>(ptrs[n_leaves + i])
                : nullptr;
    t.m[i] = in ? reinterpret_cast<const void*>(ptrs[2 * n_leaves + i])
                : nullptr;
    t.v[i] = in ? reinterpret_cast<const void*>(ptrs[3 * n_leaves + i])
                : nullptr;
  }
  adamw_apply_kernel<MT, IMPL><<<grid, kThreads, 0, s>>>(
      t, plan, n_chunks, partials, gnorm_in, count_in, step_in, sched,
      static_cast<float*>(p_out), static_cast<MT*>(m_out),
      static_cast<MT*>(v_out), static_cast<float*>(scal_out),
      static_cast<int*>(count_out), h);
  return cudaGetLastError();
}

}  // namespace

// ptrs: host uint64 [4][n_leaves] (g, p, m, v), n_leaves <= kMaxLeaves;
// gshape: host int32 [2][n_leaves], each gradient's row length and row
// stride in elements (0, 0: contiguous); plan: device int64
// [n_chunks][3]; partials: device f64 [kNormBlocks] scratch (unused when
// gnorm_in is given); moment_dtype 0 f32, 1 bf16; impl 0 HF, 1 torch;
// linear 0 constant warmup, 1 linear warmup. Returns a cudaError_t code.
extern "C" int fused_adamw(const void* ptrs, const void* gshape,
                           int n_leaves, const void* plan, int n_chunks,
                           void* partials, const void* gnorm_in,
                           const void* count_in, const void* step_in,
                           const void* sched, void* p_out, void* m_out,
                           void* v_out, void* scal_out, void* count_out,
                           float b1, float omb1, float b2, float omb2,
                           float eps, float wd, float lr, float max_norm,
                           int linear, int impl, int moment_dtype,
                           void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || n_chunks < 1 ||
      (moment_dtype != 0 && moment_dtype != 1) || (impl != 0 && impl != 1) ||
      (gnorm_in == nullptr && partials == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint64_t* p64 = static_cast<const uint64_t*>(ptrs);
  const int* gsh = static_cast<const int*>(gshape);
  const long long* pl = static_cast<const long long*>(plan);
  double* part = static_cast<double*>(partials);
  if (gnorm_in == nullptr) {
    sq_norm_kernel<<<kNormBlocks, kThreads, 0, s>>>(
        grad_table(p64, gsh, n_leaves), pl, n_chunks, part);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Hyper h{b1, omb1, b2, omb2, eps, wd, lr, max_norm, linear};
  const float* gn = static_cast<const float*>(gnorm_in);
  const int* ci = static_cast<const int*>(count_in);
  const int* si = static_cast<const int*>(step_in);
  const float* sc = static_cast<const float*>(sched);
  if (moment_dtype == 0)
    err = impl == 0
              ? launch_apply<float, 0>(p64, gsh, n_leaves, n_chunks, pl, part,
                                       gn, ci, si, sc, p_out, m_out, v_out,
                                       scal_out, count_out, h, dev, 0, s)
              : launch_apply<float, 1>(p64, gsh, n_leaves, n_chunks, pl, part,
                                       gn, ci, si, sc, p_out, m_out, v_out,
                                       scal_out, count_out, h, dev, 1, s);
  else
    err = impl == 0
              ? launch_apply<uint16_t, 0>(p64, gsh, n_leaves, n_chunks, pl,
                                          part, gn, ci, si, sc, p_out, m_out,
                                          v_out, scal_out, count_out, h, dev,
                                          2, s)
              : launch_apply<uint16_t, 1>(p64, gsh, n_leaves, n_chunks, pl,
                                          part, gn, ci, si, sc, p_out, m_out,
                                          v_out, scal_out, count_out, h, dev,
                                          3, s);
  return static_cast<int>(err);
}

extern "C" const char* fused_adamw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
