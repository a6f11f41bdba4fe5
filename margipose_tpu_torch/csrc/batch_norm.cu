// Train-mode batch norm, forward and backward: every batch norm of the
// port's models while they train on one card (models/layers.BatchNorm2d ->
// ops/batch_norm.py), over NCHW activations (float32 steps) and, further
// down, over channels-last ones (the bf16 step, whose convolutions cuDNN
// runs in NHWC: without these the model would have to be NCHW, and cuDNN
// transposed every convolution's input and output, 21% of that step).
//
// It replaces no TPU kernel: on the TPU, XLA fused flax's BatchNorm into the
// ops around it, and the port first left it to ATen. For channel c of x
// [B, C, H, W], n = B * H * W values:
//   forward   mean, biased var = M2 / n, invstd = 1 / sqrt(var + eps),
//             y = (x - mean) * invstd * w + b in x's dtype; save_mean and
//             save_invstd for the backward; running_mean and running_var
//             take in mean and the biased var (flax's statistics) by the EMA
//             factor momentum, or 1 / num_batches_tracked for momentum None;
//   backward  sdy = sum dy, sdx = sum dy (x - mean),
//             dx = (dy - sdy / n - (x - mean) sdx invstd^2 / n) invstd w,
//             dw = sdx invstd, db = sdy, in float32.
// x, y, dy and dx are float32 or bf16 (autocast's convolution output); the
// statistics, weights and sums are float32.
//
// What bounds it: bytes. The flagship's 379 batch norms a train step of 32
// touch 1.076 G values: read x and write y (4 B a value in bf16), read x and
// dy and write dx (6 B), 10.76 GB, 3.21 ms at 3.35 TB/s. Two FLOPs a byte is
// far below the card's ridge. ATen's train-mode kernels took 25.1 ms of that
// step (12.8% of the bound): its statistics and backward kernels moved 0.32
// and 0.41 TB/s with a block a channel (128-192 blocks for 132 SMs, too few
// bytes in flight), its transform read x a second time, and the biased
// running variance took five more small kernels a layer.
//
// What the design does about it:
// - A channel is split over a thread-block cluster of k blocks (k = 1, 2,
//   4, 8, chosen in ops/batch_norm.plan from C and n: at least 264 blocks a
//   launch where the channels allow, a block's slice at most 64 KB where it
//   can be split further). Each block copies its slice of x (and dy) into
//   shared memory once, every 16-byte vector requested at once (cp.async),
//   so the whole slice is in flight.
// - Statistics by two passes over shared memory: the block's sum, then M2
//   about the block's own mean. The cluster's blocks read each other's
//   (count, mean, M2) through distributed shared memory and every block
//   merges the k of them in rank order (Chan et al.'s pairwise update): no
//   atomics and no scratch in device memory, so a launch gives the same
//   bits every time, and one launch does the whole forward or backward.
// - y (or dx) is written from the slice in shared memory: x is read from
//   device memory once.
// - The block of rank 0 writes the channel's saved statistics, running
//   statistics and gradients; the channel-0 block increments
//   num_batches_tracked (for momentum None the wrapper increments it before
//   the launch and the kernel reads it).
// - A channel whose slice would not fit 8 blocks' 128 KB (the 524,288-value
//   stem channels in float32 forward, or x and dy in the backward) takes
//   the split path: the same arithmetic over chunks of 32 KB of x in two
//   launches, partials through a workspace the wrapper allocates, merged in
//   chunk order by the second kernel, which reads x (and dy) again.
// - A thread handles whole 16-byte vectors when H * W is a multiple of 16
//   bytes and the pointers are 16-byte aligned; otherwise single values.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;                 // portable cluster size
constexpr int kMaxSliceBytes = 128 * 1024;     // a cluster block's shared memory for values
constexpr int kMaxChunkBytes = 48 * 1024;      // a split chunk's shared memory (no opt-in)
constexpr unsigned kFull = 0xffffffffu;

// n / d for 0 <= n < 2^31: (umulhi(n, mul) + n) >> shift (Granlund and
// Montgomery's round-up method; mul = 1, shift = log2 d for a power of two).
struct FastDiv {
  uint32_t d, mul, shift;
};

FastDiv make_fastdiv(uint32_t d) {
  uint32_t shift = 0;
  while ((1ull << shift) < d) ++shift;
  const uint64_t mul = (((1ull << 32) * ((1ull << shift) - d)) / d) + 1;
  return {d, static_cast<uint32_t>(mul), shift};
}

__device__ __forceinline__ uint32_t divide(const FastDiv& f, uint32_t n) {
  return (__umulhi(n, f.mul) + n) >> f.shift;
}

// A launch's layout: a channel's values in vectors of V, plane (H * W / V
// vectors) after plane at (b * C + c) * plane, and the blocks a channel.
struct Layout {
  int channels;
  int vectors;     // a channel's vectors: n / V
  FastDiv plane;   // vectors a plane
  int parts;       // blocks a channel: the cluster's size or the split's chunks
  float inv_count; // 1 / n
};

struct Running {
  float* mean;
  float* var;
  int64_t* tracked;  // num_batches_tracked
  float momentum;    // < 0: the cumulative average, 1 / *tracked
};

// (count, mean, M2) of a set of values.
struct Stat {
  float n, mean, m2;
};

// V values of T in one access.
template <typename T, int V>
struct Pack;
template <>
struct Pack<float, 4> {
  using type = float4;
};
template <>
struct Pack<float, 1> {
  using type = float;
};
template <>
struct Pack<__nv_bfloat16, 8> {
  using type = uint4;
};
template <>
struct Pack<__nv_bfloat16, 1> {
  using type = __nv_bfloat16;
};

__device__ __forceinline__ void unpack(const float4& p, float (&x)[4]) {
  x[0] = p.x, x[1] = p.y, x[2] = p.z, x[3] = p.w;
}
__device__ __forceinline__ void unpack(const float& p, float (&x)[1]) { x[0] = p; }
__device__ __forceinline__ void unpack(const uint4& p, float (&x)[8]) {
  const uint32_t w[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[2 * k] = __uint_as_float(w[k] << 16);
    x[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const __nv_bfloat16& p, float (&x)[1]) {
  x[0] = __bfloat162float(p);
}

__device__ __forceinline__ void pack(const float (&x)[4], float4& p) {
  p = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void pack(const float (&x)[1], float& p) { p = x[0]; }
__device__ __forceinline__ void pack(const float (&x)[8], uint4& p) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 pair = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
    w[k] = *reinterpret_cast<const uint32_t*>(&pair);
  }
  p = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void pack(const float (&x)[1], __nv_bfloat16& p) {
  p = __float2bfloat16_rn(x[0]);
}

// Vector j of channel c, in vectors from the tensor's start.
__device__ __forceinline__ int64_t offset(const Layout& l, int c, int j) {
  const uint32_t b = divide(l.plane, static_cast<uint32_t>(j));
  const uint32_t q = static_cast<uint32_t>(j) - b * l.plane.d;
  return (static_cast<int64_t>(b) * l.channels + c) * l.plane.d + q;
}

// Vectors [begin, end) of a channel for its block `part`.
__device__ __forceinline__ void part_range(const Layout& l, int part, int& begin, int& end) {
  begin = static_cast<int>(static_cast<int64_t>(l.vectors) * part / l.parts);
  end = static_cast<int>(static_cast<int64_t>(l.vectors) * (part + 1) / l.parts);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// Copy vectors [begin, begin + len) of channel c into dst[0, len): thread t
// takes slots t, t + kThreads, ... and later reads only those, so no block
// barrier is needed before its own reads.
template <typename P>
__device__ __forceinline__ void load_slice(const P* __restrict__ src, const Layout& l, int c,
                                           int begin, int len, P* dst) {
  for (int j = threadIdx.x; j < len; j += kThreads) {
    const P* g = src + offset(l, c, begin + j);
    if constexpr (sizeof(P) == 16) {
      cp_async16(dst + j, g);
    } else {
      dst[j] = *g;
    }
  }
}

__device__ __forceinline__ void wait_slices() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Every thread gets the block's sums of v, in one fixed order; scratch
// holds N rows of kWarps.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float (*scratch)[kWarps]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[i] += __shfl_xor_sync(kFull, v[i], off);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) scratch[i][warp] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = scratch[i][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += scratch[i][w];
    v[i] = s;
  }
  __syncthreads();  // scratch free again
}

// (count, mean, M2) of the len vectors in shared memory s: the sum, then M2
// about the block's own mean.
template <int V, typename P>
__device__ __forceinline__ Stat slice_stats(const P* s, int len, float (&scratch)[2][kWarps]) {
  float v[1] = {0.f};
  for (int j = threadIdx.x; j < len; j += kThreads) {
    float x[V];
    unpack(s[j], x);
#pragma unroll
    for (int k = 0; k < V; ++k) v[0] += x[k];
  }
  block_sum<1>(v, scratch);
  const float count = static_cast<float>(len) * V;
  const float mean = v[0] / count;
  v[0] = 0.f;
  for (int j = threadIdx.x; j < len; j += kThreads) {
    float x[V];
    unpack(s[j], x);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float d = x[k] - mean;
      v[0] = fmaf(d, d, v[0]);
    }
  }
  block_sum<1>(v, scratch);
  return {count, mean, v[0]};
}

// a and b as one (Chan, Golub and LeVeque's pairwise update).
__device__ __forceinline__ Stat merge(const Stat& a, const Stat& b) {
  const float n = a.n + b.n;
  const float delta = b.mean - a.mean;
  const float wb = b.n / n;
  return {n, fmaf(delta, wb, a.mean), a.m2 + b.m2 + delta * delta * a.n * wb};
}

__device__ __forceinline__ Stat shuffle(const Stat& a, int lane) {
  return {__shfl_sync(kFull, a.n, lane), __shfl_sync(kFull, a.mean, lane),
          __shfl_sync(kFull, a.m2, lane)};
}

// Merged in rank order: the first `count` lanes of the warp each hold one
// partial; every lane returns the same merge.
__device__ __forceinline__ Stat merge_lanes(const Stat& mine, int count, Stat acc, bool first) {
  for (int q = 0; q < count; ++q) {
    const Stat p = shuffle(mine, q);
    acc = (first && q == 0) ? p : merge(acc, p);
  }
  return acc;
}

// The channel's normalisation from its merged statistics, as (mean, scale,
// bias); the block of rank 0 writes the saved and running statistics.
__device__ __forceinline__ float3 finish(const Stat& s, int c, bool first_part,
                                         const float* __restrict__ weight,
                                         const float* __restrict__ bias, float eps,
                                         const Running& run, float* __restrict__ save_mean,
                                         float* __restrict__ save_invstd) {
  const float var = s.m2 / s.n;
  const float invstd = 1.f / sqrtf(var + eps);
  const float w = weight ? weight[c] : 1.f;
  const float b = bias ? bias[c] : 0.f;
  if (first_part) {
    save_mean[c] = s.mean;
    save_invstd[c] = invstd;
    float f = run.momentum;
    if (f < 0.f) f = 1.f / static_cast<float>(*run.tracked);
    run.mean[c] = fmaf(f, s.mean, (1.f - f) * run.mean[c]);
    run.var[c] = fmaf(f, var, (1.f - f) * run.var[c]);
    if (c == 0 && run.momentum >= 0.f) *run.tracked += 1;
  }
  return make_float3(s.mean, invstd * w, b);
}

template <int V, typename P>
__device__ __forceinline__ void normalise(const P& in, const float3& norm, P& out) {
  float x[V];
  unpack(in, x);
#pragma unroll
  for (int k = 0; k < V; ++k) x[k] = fmaf(x[k] - norm.x, norm.y, norm.z);
  pack(x, out);
}

// The backward's coefficients from the channel's sums (sdy, sdx).
struct Grad {
  float mean, grad_mean, proj, scale;
};

__device__ __forceinline__ Grad grad_coefficients(float sdy, float sdx, int c, bool first_part,
                                                  float inv_count,
                                                  const float* __restrict__ weight,
                                                  const float* __restrict__ mean,
                                                  const float* __restrict__ invstd,
                                                  float* __restrict__ dweight,
                                                  float* __restrict__ dbias) {
  const float is = invstd[c];
  if (first_part && dweight) {
    dweight[c] = sdx * is;
    dbias[c] = sdy;
  }
  return {mean[c], sdy * inv_count, sdx * inv_count * is * is,
          is * (weight ? weight[c] : 1.f)};
}

template <int V, typename P>
__device__ __forceinline__ void grad_input(const P& xin, const P& dyin, const Grad& g, P& out) {
  float x[V], dy[V];
  unpack(xin, x);
  unpack(dyin, dy);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    x[k] = (dy[k] - g.grad_mean - (x[k] - g.mean) * g.proj) * g.scale;
  }
  pack(x, out);
}

template <int V, typename P>
__device__ __forceinline__ void grad_sums(const P& xin, const P& dyin, float mu, float (&v)[2]) {
  float x[V], dy[V];
  unpack(xin, x);
  unpack(dyin, dy);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    v[0] += dy[k];
    v[1] = fmaf(dy[k], x[k] - mu, v[1]);
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// ---- one launch a batch norm: a cluster of l.parts blocks a channel ----

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
batch_norm_train_fwd_kernel(const T* __restrict__ x, const Layout l,
                            const float* __restrict__ weight, const float* __restrict__ bias,
                            float eps, const Running run, T* __restrict__ y,
                            float* __restrict__ save_mean, float* __restrict__ save_invstd) {
  using P = typename Pack<T, V>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  P* s = reinterpret_cast<P*>(smem);
  __shared__ float scratch[2][kWarps];
  __shared__ Stat part;
  __shared__ float3 norm;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = blockIdx.y;
  const int rank = static_cast<int>(cluster.block_rank());
  int begin, end;
  part_range(l, rank, begin, end);
  const int len = end - begin;
  load_slice(reinterpret_cast<const P*>(x), l, c, begin, len, s);
  wait_slices();
  const Stat mine = slice_stats<V>(s, len, scratch);
  if (threadIdx.x == 0) part = mine;
  cluster.sync();  // every block's partial written
  if (threadIdx.x < 32) {
    const Stat p = *cluster.map_shared_rank(&part, threadIdx.x < l.parts ? threadIdx.x : 0);
    const Stat all = merge_lanes(p, l.parts, p, true);
    if (threadIdx.x == 0) {
      norm = finish(all, c, rank == 0, weight, bias, eps, run, save_mean, save_invstd);
    }
  }
  cluster_arrive();  // done reading the others' partials
  __syncthreads();
  const float3 nm = norm;
  P* out = reinterpret_cast<P*>(y);
  for (int j = threadIdx.x; j < len; j += kThreads) {
    normalise<V>(s[j], nm, out[offset(l, c, begin + j)]);
  }
  cluster_wait();  // no block leaves while another may read its partial
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
batch_norm_train_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy, const Layout l,
                            const float* __restrict__ weight, const float* __restrict__ mean,
                            const float* __restrict__ invstd, T* __restrict__ dx,
                            float* __restrict__ dweight, float* __restrict__ dbias) {
  using P = typename Pack<T, V>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int most = (l.vectors + l.parts - 1) / l.parts;  // the largest slice
  P* sx = reinterpret_cast<P*>(smem);
  P* sdy = sx + most;
  __shared__ float scratch[2][kWarps];
  __shared__ float2 part;
  __shared__ Grad coeff;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = blockIdx.y;
  const int rank = static_cast<int>(cluster.block_rank());
  int begin, end;
  part_range(l, rank, begin, end);
  const int len = end - begin;
  load_slice(reinterpret_cast<const P*>(x), l, c, begin, len, sx);
  load_slice(reinterpret_cast<const P*>(dy), l, c, begin, len, sdy);
  wait_slices();
  const float mu = mean[c];
  float v[2] = {0.f, 0.f};
  for (int j = threadIdx.x; j < len; j += kThreads) grad_sums<V>(sx[j], sdy[j], mu, v);
  block_sum<2>(v, scratch);
  if (threadIdx.x == 0) part = make_float2(v[0], v[1]);
  cluster.sync();  // every block's sums written
  if (threadIdx.x < 32) {
    const float2 p = *cluster.map_shared_rank(&part, threadIdx.x < l.parts ? threadIdx.x : 0);
    float s0 = 0.f, s1 = 0.f;
    for (int q = 0; q < l.parts; ++q) {
      s0 += __shfl_sync(kFull, p.x, q);
      s1 += __shfl_sync(kFull, p.y, q);
    }
    if (threadIdx.x == 0) {
      coeff = grad_coefficients(s0, s1, c, rank == 0, l.inv_count, weight, mean, invstd, dweight,
                                dbias);
    }
  }
  cluster_arrive();
  __syncthreads();
  const Grad g = coeff;
  P* out = reinterpret_cast<P*>(dx);
  for (int j = threadIdx.x; j < len; j += kThreads) {
    grad_input<V>(sx[j], sdy[j], g, out[offset(l, c, begin + j)]);
  }
  cluster_wait();
}

// ---- the split path: two launches, partials through `work` ----

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
batch_norm_train_fwd_partial_kernel(const T* __restrict__ x, const Layout l,
                                    Stat* __restrict__ work) {
  using P = typename Pack<T, V>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  P* s = reinterpret_cast<P*>(smem);
  __shared__ float scratch[2][kWarps];
  const int c = blockIdx.y;
  int begin, end;
  part_range(l, blockIdx.x, begin, end);
  const int len = end - begin;
  load_slice(reinterpret_cast<const P*>(x), l, c, begin, len, s);
  wait_slices();
  const Stat mine = slice_stats<V>(s, len, scratch);
  if (threadIdx.x == 0) work[static_cast<int64_t>(c) * l.parts + blockIdx.x] = mine;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
batch_norm_train_fwd_apply_kernel(const T* __restrict__ x, const Layout l,
                                  const Stat* __restrict__ work,
                                  const float* __restrict__ weight,
                                  const float* __restrict__ bias, float eps, const Running run,
                                  T* __restrict__ y, float* __restrict__ save_mean,
                                  float* __restrict__ save_invstd) {
  using P = typename Pack<T, V>::type;
  __shared__ float3 norm;
  const int c = blockIdx.y;
  if (threadIdx.x < 32) {
    const Stat* w = work + static_cast<int64_t>(c) * l.parts;
    Stat all = {0.f, 0.f, 0.f};
    for (int base = 0; base < l.parts; base += 32) {
      const int q = base + static_cast<int>(threadIdx.x);
      const Stat p = w[q < l.parts ? q : base];
      all = merge_lanes(p, min(32, l.parts - base), all, base == 0);
    }
    if (threadIdx.x == 0) {
      norm = finish(all, c, blockIdx.x == 0, weight, bias, eps, run, save_mean, save_invstd);
    }
  }
  __syncthreads();
  const float3 nm = norm;
  int begin, end;
  part_range(l, blockIdx.x, begin, end);
  const P* in = reinterpret_cast<const P*>(x);
  P* out = reinterpret_cast<P*>(y);
#pragma unroll 4
  for (int j = begin + threadIdx.x; j < end; j += kThreads) {
    const int64_t o = offset(l, c, j);
    normalise<V>(in[o], nm, out[o]);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
batch_norm_train_bwd_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                                    const Layout l, const float* __restrict__ mean,
                                    float2* __restrict__ work) {
  using P = typename Pack<T, V>::type;
  __shared__ float scratch[2][kWarps];
  const int c = blockIdx.y;
  int begin, end;
  part_range(l, blockIdx.x, begin, end);
  const P* xin = reinterpret_cast<const P*>(x);
  const P* dyin = reinterpret_cast<const P*>(dy);
  const float mu = mean[c];
  float v[2] = {0.f, 0.f};
#pragma unroll 4
  for (int j = begin + threadIdx.x; j < end; j += kThreads) {
    const int64_t o = offset(l, c, j);
    grad_sums<V>(xin[o], dyin[o], mu, v);
  }
  block_sum<2>(v, scratch);
  if (threadIdx.x == 0) {
    work[static_cast<int64_t>(c) * l.parts + blockIdx.x] = make_float2(v[0], v[1]);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
batch_norm_train_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                                  const Layout l, const float2* __restrict__ work,
                                  const float* __restrict__ weight,
                                  const float* __restrict__ mean,
                                  const float* __restrict__ invstd, T* __restrict__ dx,
                                  float* __restrict__ dweight, float* __restrict__ dbias) {
  using P = typename Pack<T, V>::type;
  __shared__ Grad coeff;
  const int c = blockIdx.y;
  if (threadIdx.x < 32) {
    const float2* w = work + static_cast<int64_t>(c) * l.parts;
    float s0 = 0.f, s1 = 0.f;
    for (int base = 0; base < l.parts; base += 32) {
      const int q = base + static_cast<int>(threadIdx.x);
      const float2 p = w[q < l.parts ? q : base];
      const int count = min(32, l.parts - base);
      for (int r = 0; r < count; ++r) {
        s0 += __shfl_sync(kFull, p.x, r);
        s1 += __shfl_sync(kFull, p.y, r);
      }
    }
    if (threadIdx.x == 0) {
      coeff = grad_coefficients(s0, s1, c, blockIdx.x == 0, l.inv_count, weight, mean, invstd,
                                dweight, dbias);
    }
  }
  __syncthreads();
  const Grad g = coeff;
  int begin, end;
  part_range(l, blockIdx.x, begin, end);
  const P* xin = reinterpret_cast<const P*>(x);
  const P* dyin = reinterpret_cast<const P*>(dy);
  P* out = reinterpret_cast<P*>(dx);
#pragma unroll 4
  for (int j = begin + threadIdx.x; j < end; j += kThreads) {
    const int64_t o = offset(l, c, j);
    grad_input<V>(xin[o], dyin[o], g, out[o]);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// The layout of x [batch, channels, plane] in vectors of `width` bytes
// (16, or one value); false for a shape, plan or pointer the kernels do not
// take. `bytes` is a block's shared memory.
bool setup(int batch, int channels, int plane, int value_bytes, int vec, int parts, int split,
           int tensors, Layout& l, size_t& bytes) {
  const int per = vec ? 16 / value_bytes : 1;
  const int64_t count = static_cast<int64_t>(batch) * plane;
  if (batch < 1 || channels < 1 || channels > 65535 || plane < 1 || count < 2 ||
      count >= (int64_t{1} << 31) || plane % per != 0 || parts < 1) {
    return false;
  }
  l.channels = channels;
  l.vectors = static_cast<int>(count / per);
  l.plane = make_fastdiv(static_cast<uint32_t>(plane / per));
  l.parts = parts;
  l.inv_count = static_cast<float>(1.0 / static_cast<double>(count));
  if (parts > l.vectors) return false;
  const size_t slice = static_cast<size_t>((l.vectors + parts - 1) / parts) * per * value_bytes;
  if (split) {
    bytes = tensors == 1 ? slice : 0;  // the backward's partials stream from device memory
    return bytes <= static_cast<size_t>(kMaxChunkBytes);
  }
  bytes = slice * tensors;
  return parts <= kMaxCluster && bytes <= static_cast<size_t>(kMaxSliceBytes);
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int parts, int channels, int cluster, size_t bytes,
                   cudaStream_t stream, Args... args) {
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(parts, channels, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 0 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename T, int V>
cudaError_t forward(const void* x, const Layout& l, bool split, size_t bytes, const float* w,
                    const float* b, float eps, const Running& run, void* y, float* save_mean,
                    float* save_invstd, void* work, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (!split) {
    return launch(batch_norm_train_fwd_kernel<T, V>, l.parts, l.channels, l.parts, bytes, st, xt,
                  l, w, b, eps, run, yt, save_mean, save_invstd);
  }
  Stat* ws = static_cast<Stat*>(work);
  cudaError_t err = launch(batch_norm_train_fwd_partial_kernel<T, V>, l.parts, l.channels, 0,
                           bytes, st, xt, l, ws);
  if (err != cudaSuccess) return err;
  return launch(batch_norm_train_fwd_apply_kernel<T, V>, l.parts, l.channels, 0, 0, st, xt, l,
                static_cast<const Stat*>(ws), w, b, eps, run, yt, save_mean, save_invstd);
}

template <typename T, int V>
cudaError_t backward(const void* x, const void* dy, const Layout& l, bool split, size_t bytes,
                     const float* w, const float* mean, const float* invstd, void* dx, float* dw,
                     float* db, void* work, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  if (!split) {
    return launch(batch_norm_train_bwd_kernel<T, V>, l.parts, l.channels, l.parts, bytes, st, xt,
                  dyt, l, w, mean, invstd, dxt, dw, db);
  }
  float2* ws = static_cast<float2*>(work);
  cudaError_t err = launch(batch_norm_train_bwd_partial_kernel<T, V>, l.parts, l.channels, 0, 0,
                           st, xt, dyt, l, mean, ws);
  if (err != cudaSuccess) return err;
  return launch(batch_norm_train_bwd_apply_kernel<T, V>, l.parts, l.channels, 0, 0, st, xt, dyt,
                l, static_cast<const float2*>(ws), w, mean, invstd, dxt, dw, db);
}

// ---- channels-last: x [rows = B * H * W, C], channels innermost ----
//
// The bf16 train step on one card runs channels-last (train/steps.py), so
// that cuDNN's NHWC convolutions read and write the activations without
// transposing them; these kernels are its batch norms, with the same
// arithmetic as the kernels above. A channel's values no longer lie in one
// contiguous slice but C values apart, one in every row. So a block takes a
// group of channels (tc 16-byte vectors of a row, tc a power of two up to
// 32, so that a warp reads 32 / tc rows of tc neighbouring vectors) over a
// range of rows; thread t takes vector t % tc of its group in rows t / tc,
// t / tc + 256 / tc, ... (ops/batch_norm.plan_nhwc chooses tc and the row
// parts from C, the rows and the dtype).
// - Resident (one kernel): a cluster of k <= 8 blocks covers all rows of
//   its group, each block holding its rows of the group in shared memory
//   (cp.async). Statistics by two passes over shared memory; a block's
//   per-channel sums across its threads in a fixed order (a butterfly over
//   a column's lanes, then the warps in order); the k blocks' (count, mean,
//   M2) read through distributed shared memory at once, then merged in rank
//   order; y written from shared memory: x read once.
// - Split (a group's rows too many for 8 blocks' 128 KB, single values, or
//   a cluster launch too large to pay; plan_nhwc decides): three kernels.
//   The partial kernel streams rows (Welford's update in each thread,
//   merged across the block in a fixed tree) into a workspace [parts, C];
//   one warp a channel merges the parts in a fixed order and writes the
//   saved and running statistics; the apply kernel reads x again (from the
//   50 MB L2 where the tensor fits) and writes y. The backward likewise,
//   with the sums of dy and dy (x - mean).
// No float atomics: a launch gives the same bits every time. The bound is
// the NCHW pair's (bytes). On an H100 in CUDA graphs the pair takes about
// 1.6x the NCHW pair's time over the flagship's 379 layers (PERF.md §6):
// the small layers wait on their clusters' phases, the split ones read x
// twice; the step still gains, as cuDNN no longer transposes.

constexpr int kMaxGroup = 256;            // a group's channels: 32 vectors of 8 bf16 values
constexpr int kBatch = 8;                 // rows a streaming thread loads before it uses them
constexpr int kRedWidth = 2 * kMaxGroup;  // a warp's sums: two a channel in the backward

struct Nhwc {
  int rows;         // B * H * W
  int channels;     // C
  int cols;         // vectors a row: C / V
  int tc;           // a group's vectors: a power of two, 1-32
  int shift;        // log2 tc
  int parts;        // blocks a group along the rows: the cluster's size, or the split's
  float inv_count;  // 1 / rows
};

// A block's rows [begin, end) of group blockIdx.y; the thread's vector
// column col in the row (slot in the group), its first row lane and the
// lanes' step; active while col lies inside the row.
struct Tile {
  int begin, end, col, slot, lane, step;
  bool active;
};

__device__ __forceinline__ Tile make_tile(const Nhwc& l, int part) {
  Tile t;
  t.begin = static_cast<int>(static_cast<int64_t>(l.rows) * part / l.parts);
  t.end = static_cast<int>(static_cast<int64_t>(l.rows) * (part + 1) / l.parts);
  t.slot = static_cast<int>(threadIdx.x) & (l.tc - 1);
  t.col = static_cast<int>(blockIdx.y) * l.tc + t.slot;
  t.lane = static_cast<int>(threadIdx.x) >> l.shift;
  t.step = kThreads >> l.shift;
  t.active = t.col < l.cols;
  return t;
}

// A resident block's slice of one tensor in vectors: the largest share of
// rows, tc vectors each.
__host__ __device__ __forceinline__ int slice_vectors(const Nhwc& l) {
  return (l.rows + l.parts - 1) / l.parts * l.tc;
}

// Where the gathered partials start after `bytes` of slices: 16-byte aligned.
__host__ __device__ __forceinline__ size_t after_slices(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

__device__ __forceinline__ int64_t at(const Nhwc& l, int row, int col) {
  return static_cast<int64_t>(row) * l.cols + col;
}

// a and b as one; a partial of no values gives the other.
__device__ __forceinline__ Stat merge_nz(const Stat& a, const Stat& b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  return merge(a, b);
}

__device__ __forceinline__ Stat shuffle_down(const Stat& a, int off) {
  return {__shfl_down_sync(kFull, a.n, off), __shfl_down_sync(kFull, a.mean, off),
          __shfl_down_sync(kFull, a.m2, off)};
}

// Channel c's float32 inputs for the statistics' last step, read while
// the slices load: weight, bias, running mean and variance (forward) or
// saved mean, saved invstd and weight (backward).
struct Channel {
  float a, b, c, d;
};

__device__ __forceinline__ Channel channel_fwd(int c, const float* __restrict__ weight,
                                               const float* __restrict__ bias, const Running& run) {
  return {weight ? weight[c] : 1.f, bias ? bias[c] : 0.f, run.mean[c], run.var[c]};
}

// finish() with the channel's values already read.
__device__ __forceinline__ float3 finish_read(const Stat& s, int c, bool first_part,
                                              const Channel& ch, float eps, const Running& run,
                                              float* __restrict__ save_mean,
                                              float* __restrict__ save_invstd) {
  const float var = s.m2 / s.n;
  const float invstd = 1.f / sqrtf(var + eps);
  if (first_part) {
    save_mean[c] = s.mean;
    save_invstd[c] = invstd;
    float f = run.momentum;
    if (f < 0.f) f = 1.f / static_cast<float>(*run.tracked);
    run.mean[c] = fmaf(f, s.mean, (1.f - f) * ch.c);
    run.var[c] = fmaf(f, var, (1.f - f) * ch.d);
    if (c == 0 && run.momentum >= 0.f) *run.tracked += 1;
  }
  return make_float3(s.mean, invstd * ch.a, ch.b);
}

// Every thread gets its column's block sums of v (N values a column) in one
// fixed order: the column's lanes by a butterfly (a + b == b + a, so each
// lane holds the same bits), then the warps in order. red holds kWarps rows.
template <int N>
__device__ __forceinline__ void column_sum(float (&v)[N], int tc, float (*red)[kRedWidth]) {
  for (int off = tc; off < 32; off <<= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(kFull, v[i], off);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane < tc) {
#pragma unroll
    for (int i = 0; i < N; ++i) red[warp][lane * N + i] = v[i];
  }
  __syncthreads();
  const int slot = threadIdx.x & (tc - 1);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = red[0][slot * N + i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w][slot * N + i];
    v[i] = s;
  }
  __syncthreads();  // red free again
}

// The tile's rows of its column into dst: row r's vector at slot
// (r - begin) * tc + slot, which only this thread reads later.
template <typename P>
__device__ __forceinline__ void load_rows(const P* __restrict__ src, const Nhwc& l, const Tile& t,
                                          P* dst) {
  for (int r = t.begin + t.lane; r < t.end; r += t.step) {
    const P* g = src + at(l, r, t.col);
    P* d = dst + (r - t.begin) * l.tc + t.slot;
    if constexpr (sizeof(P) == 16) {
      cp_async16(d, g);
    } else {
      *d = *g;
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
batch_norm_train_nhwc_fwd_kernel(const T* __restrict__ x, const Nhwc l,
                                 const float* __restrict__ weight, const float* __restrict__ bias,
                                 float eps, const Running run, T* __restrict__ y,
                                 float* __restrict__ save_mean, float* __restrict__ save_invstd) {
  using P = typename Pack<T, V>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  P* s = reinterpret_cast<P*>(smem);
  // after the slice: the cluster's partials, [parts][the group's channels]
  Stat* gathered = reinterpret_cast<Stat*>(smem + after_slices(slice_vectors(l) * sizeof(P)));
  __shared__ float red[kWarps][kRedWidth];
  __shared__ Stat part[kMaxGroup];
  __shared__ float3 norm[kMaxGroup];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const Tile t = make_tile(l, rank);
  if (t.active) load_rows(reinterpret_cast<const P*>(x), l, t, s);
  const int width = l.tc * V;  // the group's channels
  const int first = static_cast<int>(blockIdx.y) * width;  // the group's first channel
  const int i = threadIdx.x;
  const bool merges = i < width && first + i < l.channels;
  const Channel ch = merges ? channel_fwd(first + i, weight, bias, run) : Channel{};
  wait_slices();
  float v[V];
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = 0.f;
  if (t.active) {
    for (int r = t.begin + t.lane; r < t.end; r += t.step) {
      float xv[V];
      unpack(s[(r - t.begin) * l.tc + t.slot], xv);
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] += xv[k];
    }
  }
  column_sum<V>(v, l.tc, red);
  const float count = static_cast<float>(t.end - t.begin);
  float mean[V];
#pragma unroll
  for (int k = 0; k < V; ++k) mean[k] = v[k] / count, v[k] = 0.f;
  if (t.active) {
    for (int r = t.begin + t.lane; r < t.end; r += t.step) {
      float xv[V];
      unpack(s[(r - t.begin) * l.tc + t.slot], xv);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float d = xv[k] - mean[k];
        v[k] = fmaf(d, d, v[k]);
      }
    }
  }
  column_sum<V>(v, l.tc, red);
  if (t.active && t.lane == 0) {
#pragma unroll
    for (int k = 0; k < V; ++k) part[t.slot * V + k] = {count, mean[k], v[k]};
  }
  cluster.sync();  // every block's partials written
  // every (rank, channel) partial read at once, then merged in rank order
  for (int j = threadIdx.x; j < l.parts * width; j += kThreads) {
    gathered[j] = *cluster.map_shared_rank(&part[j % width], j / width);
  }
  cluster_arrive();  // done reading the others' partials
  __syncthreads();
  if (merges) {
    Stat all = gathered[i];
    for (int q = 1; q < l.parts; ++q) all = merge(all, gathered[q * width + i]);
    norm[i] = finish_read(all, first + i, rank == 0, ch, eps, run, save_mean, save_invstd);
  }
  __syncthreads();
  if (t.active) {
    float3 nm[V];
#pragma unroll
    for (int k = 0; k < V; ++k) nm[k] = norm[t.slot * V + k];
    P* out = reinterpret_cast<P*>(y);
    for (int r = t.begin + t.lane; r < t.end; r += t.step) {
      float xv[V];
      unpack(s[(r - t.begin) * l.tc + t.slot], xv);
#pragma unroll
      for (int k = 0; k < V; ++k) xv[k] = fmaf(xv[k] - nm[k].x, nm[k].y, nm[k].z);
      pack(xv, out[at(l, r, t.col)]);
    }
  }
  cluster_wait();  // no block leaves while another may read its partials
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
batch_norm_train_nhwc_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                                 const Nhwc l, const float* __restrict__ weight,
                                 const float* __restrict__ mean,
                                 const float* __restrict__ invstd, T* __restrict__ dx,
                                 float* __restrict__ dweight, float* __restrict__ dbias) {
  using P = typename Pack<T, V>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int most = (l.rows + l.parts - 1) / l.parts;  // the largest share of rows
  P* sx = reinterpret_cast<P*>(smem);
  P* sdy = sx + most * l.tc;
  float2* gathered =
      reinterpret_cast<float2*>(smem + after_slices(2 * slice_vectors(l) * sizeof(P)));
  __shared__ float red[kWarps][kRedWidth];
  __shared__ float2 part[kMaxGroup];
  __shared__ Grad coeff[kMaxGroup];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const Tile t = make_tile(l, rank);
  if (t.active) {
    load_rows(reinterpret_cast<const P*>(x), l, t, sx);
    load_rows(reinterpret_cast<const P*>(dy), l, t, sdy);
  }
  float mu[V];
#pragma unroll
  for (int k = 0; k < V; ++k) mu[k] = t.active ? mean[t.col * V + k] : 0.f;
  const int width = l.tc * V;
  const int first = static_cast<int>(blockIdx.y) * width;
  const int i = threadIdx.x;
  const bool merges = i < width && first + i < l.channels;
  const Channel ch = merges ? Channel{mean[first + i], invstd[first + i],
                                      weight ? weight[first + i] : 1.f, 0.f}
                            : Channel{};
  wait_slices();
  float v[2 * V];
#pragma unroll
  for (int k = 0; k < 2 * V; ++k) v[k] = 0.f;
  if (t.active) {
    for (int r = t.begin + t.lane; r < t.end; r += t.step) {
      const int j = (r - t.begin) * l.tc + t.slot;
      float xv[V], gv[V];
      unpack(sx[j], xv);
      unpack(sdy[j], gv);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        v[k] += gv[k];
        v[V + k] = fmaf(gv[k], xv[k] - mu[k], v[V + k]);
      }
    }
  }
  column_sum<2 * V>(v, l.tc, red);
  if (t.active && t.lane == 0) {
#pragma unroll
    for (int k = 0; k < V; ++k) part[t.slot * V + k] = make_float2(v[k], v[V + k]);
  }
  cluster.sync();  // every block's sums written
  for (int j = threadIdx.x; j < l.parts * width; j += kThreads) {
    gathered[j] = *cluster.map_shared_rank(&part[j % width], j / width);
  }
  cluster_arrive();
  __syncthreads();
  if (merges) {
    float s0 = 0.f, s1 = 0.f;
    for (int q = 0; q < l.parts; ++q) {
      s0 += gathered[q * width + i].x;
      s1 += gathered[q * width + i].y;
    }
    if (rank == 0 && dweight) {  // as grad_coefficients, the channel's values read
      dweight[first + i] = s1 * ch.b;
      dbias[first + i] = s0;
    }
    coeff[i] = {ch.a, s0 * l.inv_count, s1 * l.inv_count * ch.b * ch.b, ch.b * ch.c};
  }
  __syncthreads();
  if (t.active) {
    Grad g[V];
#pragma unroll
    for (int k = 0; k < V; ++k) g[k] = coeff[t.slot * V + k];
    P* out = reinterpret_cast<P*>(dx);
    for (int r = t.begin + t.lane; r < t.end; r += t.step) {
      const int j = (r - t.begin) * l.tc + t.slot;
      float xv[V], gv[V];
      unpack(sx[j], xv);
      unpack(sdy[j], gv);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        xv[k] = (gv[k] - g[k].grad_mean - (xv[k] - g[k].mean) * g[k].proj) * g[k].scale;
      }
      pack(xv, out[at(l, r, t.col)]);
    }
  }
  cluster_wait();
}

// ---- the channels-last split path: partials, a warp a channel, apply ----

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
batch_norm_train_nhwc_fwd_partial_kernel(const T* __restrict__ x, const Nhwc l,
                                         Stat* __restrict__ work) {
  using P = typename Pack<T, V>::type;
  __shared__ Stat warps[kWarps][kMaxGroup];
  const Tile t = make_tile(l, blockIdx.x);
  Stat st[V];
#pragma unroll
  for (int k = 0; k < V; ++k) st[k] = {0.f, 0.f, 0.f};
  if (t.active) {
    const P* in = reinterpret_cast<const P*>(x);
    float n = 0.f;
    for (int r0 = t.begin + t.lane; r0 < t.end; r0 += kBatch * t.step) {
      P batch[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int r = r0 + u * t.step;
        if (r < t.end) batch[u] = in[at(l, r, t.col)];
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (r0 + u * t.step >= t.end) break;
        float xv[V];
        unpack(batch[u], xv);
        n += 1.f;
        const float inv = 1.f / n;
#pragma unroll
        for (int k = 0; k < V; ++k) {  // Welford's update
          const float d = xv[k] - st[k].mean;
          st[k].mean = fmaf(d, inv, st[k].mean);
          st[k].m2 = fmaf(d, xv[k] - st[k].mean, st[k].m2);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) st[k].n = n;
  }
  // a warp's row lanes of a column into its lowest, in a fixed tree
  const int lane = threadIdx.x & 31;
  for (int off = l.tc; off < 32; off <<= 1) {
    const bool keeps = ((lane >> l.shift) & ((2 * off >> l.shift) - 1)) == 0;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const Stat o = shuffle_down(st[k], off);
      if (keeps) st[k] = merge_nz(st[k], o);
    }
  }
  if (lane < l.tc) {
#pragma unroll
    for (int k = 0; k < V; ++k) warps[threadIdx.x >> 5][t.slot * V + k] = st[k];
  }
  __syncthreads();
  const int first = static_cast<int>(blockIdx.y) * l.tc * V;
  const int i = threadIdx.x;
  if (i < l.tc * V && first + i < l.channels) {
    Stat all = warps[0][i];
    for (int w = 1; w < kWarps; ++w) all = merge_nz(all, warps[w][i]);
    work[static_cast<int64_t>(blockIdx.x) * l.channels + first + i] = all;
  }
}

// A warp a channel: the parts' partials in a fixed order (lane q takes
// parts q, q + 32, ..., then a tree into lane 0), then the statistics.
__global__ void __launch_bounds__(kThreads)
batch_norm_train_nhwc_fwd_finish_kernel(const Stat* __restrict__ work, int parts, int channels,
                                        const float* __restrict__ weight,
                                        const float* __restrict__ bias, float eps,
                                        const Running run, float* __restrict__ save_mean,
                                        float* __restrict__ save_invstd) {
  const int c = static_cast<int>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= channels) return;  // the whole warp
  Stat s = {0.f, 0.f, 0.f};
  for (int q0 = lane; q0 < parts; q0 += 32 * kBatch) {
    Stat batch[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int q = q0 + 32 * u;
      batch[u] = q < parts ? work[static_cast<int64_t>(q) * channels + c] : Stat{0.f, 0.f, 0.f};
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) s = merge_nz(s, batch[u]);
  }
  for (int off = 1; off < 32; off <<= 1) {
    const Stat o = shuffle_down(s, off);
    if ((lane & (2 * off - 1)) == 0) s = merge_nz(s, o);
  }
  if (lane == 0) finish(s, c, true, weight, bias, eps, run, save_mean, save_invstd);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
batch_norm_train_nhwc_fwd_apply_kernel(const T* __restrict__ x, const Nhwc l,
                                       const float* __restrict__ weight,
                                       const float* __restrict__ bias,
                                       const float* __restrict__ save_mean,
                                       const float* __restrict__ save_invstd, T* __restrict__ y) {
  using P = typename Pack<T, V>::type;
  const Tile t = make_tile(l, blockIdx.x);
  if (!t.active) return;
  float3 nm[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = t.col * V + k;
    nm[k] = make_float3(save_mean[c], save_invstd[c] * (weight ? weight[c] : 1.f),
                        bias ? bias[c] : 0.f);
  }
  const P* in = reinterpret_cast<const P*>(x);
  P* out = reinterpret_cast<P*>(y);
  for (int r0 = t.begin + t.lane; r0 < t.end; r0 += kBatch * t.step) {
    P batch[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int r = r0 + u * t.step;
      if (r < t.end) batch[u] = in[at(l, r, t.col)];
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int r = r0 + u * t.step;
      if (r >= t.end) break;
      float xv[V];
      unpack(batch[u], xv);
#pragma unroll
      for (int k = 0; k < V; ++k) xv[k] = fmaf(xv[k] - nm[k].x, nm[k].y, nm[k].z);
      pack(xv, out[at(l, r, t.col)]);
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
batch_norm_train_nhwc_bwd_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                                         const Nhwc l, const float* __restrict__ mean,
                                         float2* __restrict__ work) {
  using P = typename Pack<T, V>::type;
  __shared__ float red[kWarps][kRedWidth];
  const Tile t = make_tile(l, blockIdx.x);
  float v[2 * V];
#pragma unroll
  for (int k = 0; k < 2 * V; ++k) v[k] = 0.f;
  if (t.active) {
    float mu[V];
#pragma unroll
    for (int k = 0; k < V; ++k) mu[k] = mean[t.col * V + k];
    const P* xin = reinterpret_cast<const P*>(x);
    const P* dyin = reinterpret_cast<const P*>(dy);
    constexpr int kHalf = kBatch / 2;  // two tensors: as many bytes in flight
    for (int r0 = t.begin + t.lane; r0 < t.end; r0 += kHalf * t.step) {
      P bx[kHalf], bg[kHalf];
#pragma unroll
      for (int u = 0; u < kHalf; ++u) {
        const int r = r0 + u * t.step;
        if (r < t.end) bx[u] = xin[at(l, r, t.col)], bg[u] = dyin[at(l, r, t.col)];
      }
#pragma unroll
      for (int u = 0; u < kHalf; ++u) {
        if (r0 + u * t.step >= t.end) break;
        float xv[V], gv[V];
        unpack(bx[u], xv);
        unpack(bg[u], gv);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          v[k] += gv[k];
          v[V + k] = fmaf(gv[k], xv[k] - mu[k], v[V + k]);
        }
      }
    }
  }
  column_sum<2 * V>(v, l.tc, red);
  if (t.active && t.lane == 0) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      work[static_cast<int64_t>(blockIdx.x) * l.channels + t.col * V + k] =
          make_float2(v[k], v[V + k]);
    }
  }
}

// A warp a channel: the parts' sums in a fixed order into row `parts` of
// the workspace, and the weight's and bias's gradients.
__global__ void __launch_bounds__(kThreads)
batch_norm_train_nhwc_bwd_finish_kernel(float2* __restrict__ work, int parts, int channels,
                                        const float* __restrict__ invstd,
                                        float* __restrict__ dweight, float* __restrict__ dbias) {
  const int c = static_cast<int>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= channels) return;
  float s0 = 0.f, s1 = 0.f;
  for (int q0 = lane; q0 < parts; q0 += 32 * kBatch) {
    float2 batch[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int q = q0 + 32 * u;
      batch[u] = q < parts ? work[static_cast<int64_t>(q) * channels + c] : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) s0 += batch[u].x, s1 += batch[u].y;
  }
  for (int off = 1; off < 32; off <<= 1) {
    const float o0 = __shfl_down_sync(kFull, s0, off), o1 = __shfl_down_sync(kFull, s1, off);
    if ((lane & (2 * off - 1)) == 0) s0 += o0, s1 += o1;
  }
  if (lane == 0) {
    work[static_cast<int64_t>(parts) * channels + c] = make_float2(s0, s1);
    if (dweight) {
      dweight[c] = s1 * invstd[c];
      dbias[c] = s0;
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
batch_norm_train_nhwc_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                                       const Nhwc l, const float2* __restrict__ sums,
                                       const float* __restrict__ weight,
                                       const float* __restrict__ mean,
                                       const float* __restrict__ invstd, T* __restrict__ dx) {
  using P = typename Pack<T, V>::type;
  const Tile t = make_tile(l, blockIdx.x);
  if (!t.active) return;
  Grad g[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = t.col * V + k;
    const float2 s = sums[c];
    g[k] = grad_coefficients(s.x, s.y, c, false, l.inv_count, weight, mean, invstd, nullptr,
                             nullptr);
  }
  const P* xin = reinterpret_cast<const P*>(x);
  const P* dyin = reinterpret_cast<const P*>(dy);
  P* out = reinterpret_cast<P*>(dx);
  constexpr int kHalf = kBatch / 2;
  for (int r0 = t.begin + t.lane; r0 < t.end; r0 += kHalf * t.step) {
    P bx[kHalf], bg[kHalf];
#pragma unroll
    for (int u = 0; u < kHalf; ++u) {
      const int r = r0 + u * t.step;
      if (r < t.end) bx[u] = xin[at(l, r, t.col)], bg[u] = dyin[at(l, r, t.col)];
    }
#pragma unroll
    for (int u = 0; u < kHalf; ++u) {
      const int r = r0 + u * t.step;
      if (r >= t.end) break;
      float xv[V], gv[V];
      unpack(bx[u], xv);
      unpack(bg[u], gv);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        xv[k] = (gv[k] - g[k].grad_mean - (xv[k] - g[k].mean) * g[k].proj) * g[k].scale;
      }
      pack(xv, out[at(l, r, t.col)]);
    }
  }
}

// The layout of x [rows, channels] in vectors of 16 bytes (vec) or of one
// value, tc vectors a group and parts blocks a group; false for what the
// kernels do not take. `bytes` is a resident block's shared memory.
bool setup_nhwc(int rows, int channels, int value_bytes, int vec, int tc, int parts, int split,
                int tensors, Nhwc& l, size_t& bytes) {
  const int per = vec ? 16 / value_bytes : 1;
  if (rows < 2 || channels < 1 || channels > 65535 || channels % per != 0 || tc < 1 ||
      tc > 32 || (tc & (tc - 1)) != 0 || parts < 1 || parts > rows) {
    return false;
  }
  l.rows = rows;
  l.channels = channels;
  l.cols = channels / per;
  l.tc = tc;
  l.shift = 0;
  while ((1 << l.shift) < tc) ++l.shift;
  l.parts = parts;
  l.inv_count = static_cast<float>(1.0 / static_cast<double>(rows));
  bytes = 0;
  if (split) return true;
  size_t slice = static_cast<size_t>(slice_vectors(l)) * per * value_bytes * tensors;
  if (parts > kMaxCluster || slice > static_cast<size_t>(kMaxSliceBytes)) return false;
  // the cluster's gathered partials after the slices
  bytes = after_slices(slice) + static_cast<size_t>(parts) * tc * per *
                                    (tensors == 1 ? sizeof(Stat) : sizeof(float2));
  return true;
}

int groups(const Nhwc& l) { return (l.cols + l.tc - 1) / l.tc; }

// A resident kernel's static shared memory (about 22 KB) and its dynamic
// shared memory pass 48 KB together at most sizes: always opt in.
template <typename Kernel>
cudaError_t allow_slice(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

int warp_blocks(int channels) { return (channels + kWarps - 1) / kWarps; }

template <typename T, int V>
cudaError_t forward_nhwc(const void* x, const Nhwc& l, bool split, size_t bytes, const float* w,
                         const float* b, float eps, const Running& run, void* y, float* save_mean,
                         float* save_invstd, void* work, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (!split) {
    const cudaError_t err = allow_slice(batch_norm_train_nhwc_fwd_kernel<T, V>, bytes);
    if (err != cudaSuccess) return err;
    return launch(batch_norm_train_nhwc_fwd_kernel<T, V>, l.parts, groups(l), l.parts, bytes, st,
                  xt, l, w, b, eps, run, yt, save_mean, save_invstd);
  }
  Stat* ws = static_cast<Stat*>(work);
  cudaError_t err = launch(batch_norm_train_nhwc_fwd_partial_kernel<T, V>, l.parts, groups(l), 0,
                           0, st, xt, l, ws);
  if (err != cudaSuccess) return err;
  err = launch(batch_norm_train_nhwc_fwd_finish_kernel, warp_blocks(l.channels), 1, 0, 0, st,
               static_cast<const Stat*>(ws), l.parts, l.channels, w, b, eps, run, save_mean,
               save_invstd);
  if (err != cudaSuccess) return err;
  return launch(batch_norm_train_nhwc_fwd_apply_kernel<T, V>, l.parts, groups(l), 0, 0, st, xt,
                l, w, b, static_cast<const float*>(save_mean),
                static_cast<const float*>(save_invstd), yt);
}

template <typename T, int V>
cudaError_t backward_nhwc(const void* x, const void* dy, const Nhwc& l, bool split, size_t bytes,
                          const float* w, const float* mean, const float* invstd, void* dx,
                          float* dw, float* db, void* work, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  if (!split) {
    const cudaError_t err = allow_slice(batch_norm_train_nhwc_bwd_kernel<T, V>, bytes);
    if (err != cudaSuccess) return err;
    return launch(batch_norm_train_nhwc_bwd_kernel<T, V>, l.parts, groups(l), l.parts, bytes, st,
                  xt, dyt, l, w, mean, invstd, dxt, dw, db);
  }
  float2* ws = static_cast<float2*>(work);
  cudaError_t err = launch(batch_norm_train_nhwc_bwd_partial_kernel<T, V>, l.parts, groups(l), 0,
                           0, st, xt, dyt, l, mean, ws);
  if (err != cudaSuccess) return err;
  err = launch(batch_norm_train_nhwc_bwd_finish_kernel, warp_blocks(l.channels), 1, 0, 0, st, ws,
               l.parts, l.channels, invstd, dw, db);
  if (err != cudaSuccess) return err;
  const float2* sums = ws + static_cast<int64_t>(l.parts) * l.channels;
  return launch(batch_norm_train_nhwc_bwd_apply_kernel<T, V>, l.parts, groups(l), 0, 0, st, xt,
                dyt, l, sums, w, mean, invstd, dxt);
}

}  // namespace

// x [batch, channels, plane] contiguous, float32 (bf16 = 0) or bf16 (bf16 =
// 1); vec = 1: plane a multiple of 16 bytes and x, y 16-byte aligned. parts:
// the cluster's size (split = 0) or the chunks a channel (split = 1, with
// work [channels, parts, 3] float32). weight and bias [channels] float32 or
// both null; running_mean, running_var [channels] float32, updated in place;
// tracked the int64 num_batches_tracked, incremented here for momentum >= 0
// and read for momentum < 0 (the cumulative average); y like x; save_mean,
// save_invstd [channels] float32. Launches on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for what the kernels do not
// take.
extern "C" int batch_norm_train_fwd(const void* x, int bf16, int vec, int batch, int channels,
                                    int plane, int parts, int split, const void* weight,
                                    const void* bias, void* running_mean, void* running_var,
                                    void* tracked, float momentum, float eps, void* y,
                                    void* save_mean, void* save_invstd, void* work,
                                    void* stream) {
  Layout l;
  size_t bytes = 0;
  if (!setup(batch, channels, plane, bf16 ? 2 : 4, vec, parts, split, 1, l, bytes) ||
      (vec && (!aligned16(x) || !aligned16(y))) || (split && !work) ||
      (weight == nullptr) != (bias == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const Running run = {static_cast<float*>(running_mean), static_cast<float*>(running_var),
                       static_cast<int64_t*>(tracked), momentum};
  const float* w = static_cast<const float*>(weight);
  const float* b = static_cast<const float*>(bias);
  float* sm = static_cast<float*>(save_mean);
  float* si = static_cast<float*>(save_invstd);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    err = vec ? forward<__nv_bfloat16, 8>(x, l, split, bytes, w, b, eps, run, y, sm, si, work, st)
              : forward<__nv_bfloat16, 1>(x, l, split, bytes, w, b, eps, run, y, sm, si, work, st);
  } else {
    err = vec ? forward<float, 4>(x, l, split, bytes, w, b, eps, run, y, sm, si, work, st)
              : forward<float, 1>(x, l, split, bytes, w, b, eps, run, y, sm, si, work, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// x as batch_norm_train_fwd took it, dy and dx like x (vec = 1: all three
// 16-byte aligned); weight [channels] float32 or null; save_mean and
// save_invstd as the forward wrote them; dweight, dbias [channels] float32,
// or both null with weight. parts and split as in the forward (work
// [channels, parts, 2] float32). Launches on `stream`; returns as the
// forward.
extern "C" int batch_norm_train_bwd(const void* x, const void* dy, int bf16, int vec, int batch,
                                    int channels, int plane, int parts, int split,
                                    const void* weight, const void* save_mean,
                                    const void* save_invstd, void* dx, void* dweight,
                                    void* dbias, void* work, void* stream) {
  Layout l;
  size_t bytes = 0;
  if (!setup(batch, channels, plane, bf16 ? 2 : 4, vec, parts, split, 2, l, bytes) ||
      (vec && (!aligned16(x) || !aligned16(dy) || !aligned16(dx))) || (split && !work) ||
      (weight == nullptr) != (dweight == nullptr) || (dweight == nullptr) != (dbias == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const float* w = static_cast<const float*>(weight);
  const float* m = static_cast<const float*>(save_mean);
  const float* is = static_cast<const float*>(save_invstd);
  float* dw = static_cast<float*>(dweight);
  float* db = static_cast<float*>(dbias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    err = vec ? backward<__nv_bfloat16, 8>(x, dy, l, split, bytes, w, m, is, dx, dw, db, work, st)
              : backward<__nv_bfloat16, 1>(x, dy, l, split, bytes, w, m, is, dx, dw, db, work, st);
  } else {
    err = vec ? backward<float, 4>(x, dy, l, split, bytes, w, m, is, dx, dw, db, work, st)
              : backward<float, 1>(x, dy, l, split, bytes, w, m, is, dx, dw, db, work, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// x [rows, channels] channels-last (the NHWC memory of [B, C, H, W], rows =
// B * H * W), float32 (bf16 = 0) or bf16 (bf16 = 1); vec = 1: channels a
// multiple of 16 bytes' values and x, y 16-byte aligned. tc: a group's
// vectors, a power of two up to 32; parts: the cluster's size (split = 0)
// or the blocks a group along the rows (split = 1, with work [parts,
// channels, 3] float32). The other arguments as batch_norm_train_fwd's; y
// like x. Launches on `stream`; returns as batch_norm_train_fwd.
extern "C" int batch_norm_train_nhwc_fwd(const void* x, int bf16, int vec, int rows,
                                         int channels, int tc, int parts, int split,
                                         const void* weight, const void* bias,
                                         void* running_mean, void* running_var, void* tracked,
                                         float momentum, float eps, void* y, void* save_mean,
                                         void* save_invstd, void* work, void* stream) {
  Nhwc l;
  size_t bytes = 0;
  if (!setup_nhwc(rows, channels, bf16 ? 2 : 4, vec, tc, parts, split, 1, l, bytes) ||
      (vec && (!aligned16(x) || !aligned16(y))) || (split && !work) ||
      (weight == nullptr) != (bias == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const Running run = {static_cast<float*>(running_mean), static_cast<float*>(running_var),
                       static_cast<int64_t*>(tracked), momentum};
  const float* w = static_cast<const float*>(weight);
  const float* b = static_cast<const float*>(bias);
  float* sm = static_cast<float*>(save_mean);
  float* si = static_cast<float*>(save_invstd);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    err = vec ? forward_nhwc<__nv_bfloat16, 8>(x, l, split, bytes, w, b, eps, run, y, sm, si, work,
                                               st)
              : forward_nhwc<__nv_bfloat16, 1>(x, l, split, bytes, w, b, eps, run, y, sm, si, work,
                                               st);
  } else {
    err = vec ? forward_nhwc<float, 4>(x, l, split, bytes, w, b, eps, run, y, sm, si, work, st)
              : forward_nhwc<float, 1>(x, l, split, bytes, w, b, eps, run, y, sm, si, work, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// x as batch_norm_train_nhwc_fwd took it, dy and dx like x (vec = 1: all
// three 16-byte aligned); weight, save_mean, save_invstd, dweight and dbias
// as batch_norm_train_bwd's; tc, parts and split as in the forward (work
// [parts + 1, channels, 2] float32). Launches on `stream`; returns as the
// forward.
extern "C" int batch_norm_train_nhwc_bwd(const void* x, const void* dy, int bf16, int vec,
                                         int rows, int channels, int tc, int parts, int split,
                                         const void* weight, const void* save_mean,
                                         const void* save_invstd, void* dx, void* dweight,
                                         void* dbias, void* work, void* stream) {
  Nhwc l;
  size_t bytes = 0;
  if (!setup_nhwc(rows, channels, bf16 ? 2 : 4, vec, tc, parts, split, 2, l, bytes) ||
      (vec && (!aligned16(x) || !aligned16(dy) || !aligned16(dx))) || (split && !work) ||
      (weight == nullptr) != (dweight == nullptr) || (dweight == nullptr) != (dbias == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const float* w = static_cast<const float*>(weight);
  const float* m = static_cast<const float*>(save_mean);
  const float* is = static_cast<const float*>(save_invstd);
  float* dw = static_cast<float*>(dweight);
  float* db = static_cast<float*>(dbias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    err = vec ? backward_nhwc<__nv_bfloat16, 8>(x, dy, l, split, bytes, w, m, is, dx, dw, db, work,
                                                st)
              : backward_nhwc<__nv_bfloat16, 1>(x, dy, l, split, bytes, w, m, is, dx, dw, db, work,
                                                st);
  } else {
    err = vec ? backward_nhwc<float, 4>(x, dy, l, split, bytes, w, m, is, dx, dw, db, work, st)
              : backward_nhwc<float, 1>(x, dy, l, split, bytes, w, m, is, dx, dw, db, work, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
