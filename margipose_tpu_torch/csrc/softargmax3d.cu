// Volumetric soft-argmax (the integral regression of Sun et al., arXiv:
// 1711.08229) and its closed-form backward: the integral model's head.
//
// It replaces no TPU kernel: the JAX package has no volumetric head. The
// integral model (models/integral.py) reads its output conv as one volume
// of V = D x H x W logits a joint (64^3 = 262,144 at the published size),
// a row l[V] here. For each row softargmax3d_fwd writes
//   xyz   = (E[cx], E[cy], E[cz]) under p = softmax(l), with cx, cy, cz the
//           voxel centres (2i + 1) / n - 1 along W, H and D;
//   stats = (m, s): m = max_i l_i log2(e), s = sum_i 2^(l_i log2(e) - m);
// and softargmax3d_bwd, from the cotangent g [rows, 3] of xyz,
//   dl_i = p_i sum_a g_a (c_a(i) - E_a),   p_i = 2^(l_i log2(e) - m) / s,
// in the logits' dtype: float32, or bf16 under autocast. Both accumulate in
// float32.
//
// What bounds them: bytes. At the train cell's batch of 32 (544 rows) the
// bf16 logits are 285 MB: the forward reads them once (85 us at 3.35 TB/s)
// and the backward reads them and writes their gradient (170 us). An element
// costs one MUFU ex2 and a handful of FP32 operations, about a third of the
// time its bytes take.
//
// What the design does about it:
// - 16-byte accesses: a thread takes 8 consecutive elements at a time (one
//   uint4 of bf16, two float4 of float32). W % 8 == 0, so the 8 share their
//   h and d: a vector's y and z centres are one value each and its x centres
//   an arithmetic series, so the forward adds s += sum e, sx += cx0 sum e +
//   step sum k e, sy += cy sum e and sz += cz sum e a vector.
// - One read: the forward keeps an online softmax, a running max that
//   rescales the thread's four sums when a vector raises it. Each thread
//   issues kUnroll vectors' loads before their arithmetic.
// - 544 rows are too few for a block a row (4.1 waves over 132 SMs, the
//   last a tenth full). A row is split over a cluster of kSplit = 8 blocks
//   of 256 threads: each block reduces its slice to (m, s, sx, sy, sz) in
//   shared memory, and block 0 of the cluster combines the eight through
//   distributed shared memory and writes the row. No scratch in device
//   memory, no atomics, one launch, which a CUDA graph captures as any
//   other.
// - The backward needs no reduction: the same (slice, row) grid without a
//   cluster, p recomputed from l and the row's stats, 16-byte stores.
// - A vector's h and d come from two divisions by the launch's constants,
//   by multiply-high (FastDiv), not the integer divide.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSplit = 8;   // blocks a row: the forward's cluster
constexpr int kVec = 8;     // elements a thread takes at a time
constexpr int kUnroll = 4;  // vectors a thread loads before their arithmetic
constexpr float kLog2e = 1.4426950408889634f;
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

struct Volume {
  int rows, size;  // rows and V = D * H * W
  int vectors;     // V / kVec
  FastDiv line;    // vectors a line of W: W / kVec
  FastDiv height;  // H
  // centres c = i * step + first along W (x), H (y) and D (z)
  float step_x, first_x, step_y, first_y, step_z, first_z;
};

struct Partial {
  float m, s, sx, sy, sz;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void load(const float* row, int v, float (&x)[kVec]) {
  const float4* p = reinterpret_cast<const float4*>(row) + 2 * v;
  const float4 a = p[0], b = p[1];
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}

__device__ __forceinline__ void load(const __nv_bfloat16* row, int v, float (&x)[kVec]) {
  const uint4 a = reinterpret_cast<const uint4*>(row)[v];
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[2 * k] = __uint_as_float(w[k] << 16);
    x[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store(float* row, int v, const float (&x)[kVec]) {
  float4* p = reinterpret_cast<float4*>(row) + 2 * v;
  p[0] = make_float4(x[0], x[1], x[2], x[3]);
  p[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store(__nv_bfloat16* row, int v, const float (&x)[kVec]) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 pair = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
    w[k] = *reinterpret_cast<const uint32_t*>(&pair);
  }
  reinterpret_cast<uint4*>(row)[v] = make_uint4(w[0], w[1], w[2], w[3]);
}

// The centres of vector v: x of its first element, y and z.
__device__ __forceinline__ void centres(const Volume& vol, int v, float& cx0, float& cy,
                                        float& cz) {
  const uint32_t line = divide(vol.line, v);
  const uint32_t d = divide(vol.height, line);
  const uint32_t h = line - d * vol.height.d;
  const uint32_t w0 = (v - line * vol.line.d) * kVec;
  cx0 = fmaf(static_cast<float>(w0), vol.step_x, vol.first_x);
  cy = fmaf(static_cast<float>(h), vol.step_y, vol.first_y);
  cz = fmaf(static_cast<float>(d), vol.step_z, vol.first_z);
}

__device__ __forceinline__ void accumulate(Partial& a, const float (&x)[kVec], int v,
                                           const Volume& vol) {
  float top = x[0];
#pragma unroll
  for (int k = 1; k < kVec; ++k) top = fmaxf(top, x[k]);
  const float m = top * kLog2e;
  if (m > a.m) {
    const float r = ex2(a.m - m);
    a.s *= r, a.sx *= r, a.sy *= r, a.sz *= r;
    a.m = m;
  }
  float s = 0.f, sk = 0.f;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const float e = ex2(fmaf(x[k], kLog2e, -a.m));
    s += e;
    sk = fmaf(static_cast<float>(k), e, sk);
  }
  float cx0, cy, cz;
  centres(vol, v, cx0, cy, cz);
  a.s += s;
  a.sx += fmaf(cx0, s, vol.step_x * sk);
  a.sy = fmaf(cy, s, a.sy);
  a.sz = fmaf(cz, s, a.sz);
}

// Two partials of one row as one; an empty partial (m = -FLT_MAX, sums 0)
// takes no part.
__device__ __forceinline__ Partial combine(const Partial& a, const Partial& b) {
  const float m = fmaxf(a.m, b.m);
  const float ra = ex2(a.m - m), rb = ex2(b.m - m);
  return {m, fmaf(a.s, ra, b.s * rb), fmaf(a.sx, ra, b.sx * rb), fmaf(a.sy, ra, b.sy * rb),
          fmaf(a.sz, ra, b.sz * rb)};
}

__device__ __forceinline__ Partial shuffle(const Partial& a, int offset, unsigned mask) {
  return {__shfl_xor_sync(mask, a.m, offset), __shfl_xor_sync(mask, a.s, offset),
          __shfl_xor_sync(mask, a.sx, offset), __shfl_xor_sync(mask, a.sy, offset),
          __shfl_xor_sync(mask, a.sz, offset)};
}

// Vectors [begin, end) of the row for slice `slice` of kSplit.
__device__ __forceinline__ void slice_range(const Volume& vol, int slice, int& begin, int& end) {
  begin = static_cast<int>(static_cast<int64_t>(vol.vectors) * slice / kSplit);
  end = static_cast<int>(static_cast<int64_t>(vol.vectors) * (slice + 1) / kSplit);
}

template <typename T>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads)
softargmax3d_fwd_kernel(const T* __restrict__ logits, const Volume vol, float* __restrict__ xyz,
                        float* __restrict__ stats) {
  __shared__ Partial warps[kWarps];
  __shared__ Partial block;
  cg::cluster_group cluster = cg::this_cluster();
  const int row = blockIdx.y;
  const unsigned slice = cluster.block_rank();
  const T* l = logits + static_cast<int64_t>(row) * vol.size;
  int begin, end;
  slice_range(vol, slice, begin, end);

  Partial a = {-FLT_MAX, 0.f, 0.f, 0.f, 0.f};
  int v = begin + threadIdx.x;
  for (; v + (kUnroll - 1) * kThreads < end; v += kUnroll * kThreads) {
    float x[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load(l, v + u * kThreads, x[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) accumulate(a, x[u], v + u * kThreads, vol);
  }
  for (; v < end; v += kThreads) {
    float x[kVec];
    load(l, v, x);
    accumulate(a, x, v, vol);
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) a = combine(a, shuffle(a, off, kFull));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warps[warp] = a;
  __syncthreads();
  if (warp == 0) {
    a = warps[lane % kWarps];
#pragma unroll
    for (int off = kWarps / 2; off > 0; off >>= 1) a = combine(a, shuffle(a, off, kFull));
    if (lane == 0) block = a;
  }
  cluster.sync();  // every block's partial written
  if (slice == 0 && warp == 0) {
    a = *cluster.map_shared_rank(&block, lane % kSplit);
#pragma unroll
    for (int off = kSplit / 2; off > 0; off >>= 1) a = combine(a, shuffle(a, off, kFull));
    if (lane == 0) {
      const float inv = 1.f / a.s;
      xyz[3 * row] = a.sx * inv;
      xyz[3 * row + 1] = a.sy * inv;
      xyz[3 * row + 2] = a.sz * inv;
      stats[2 * row] = a.m;
      stats[2 * row + 1] = a.s;
    }
  }
  cluster.sync();  // block 0 has read the others' shared memory
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
softargmax3d_bwd_kernel(const T* __restrict__ logits, const Volume vol,
                        const float* __restrict__ xyz, const float* __restrict__ stats,
                        const float* __restrict__ grad, T* __restrict__ dlogits) {
  const int row = blockIdx.y;
  const int64_t offset = static_cast<int64_t>(row) * vol.size;
  const T* l = logits + offset;
  T* dl = dlogits + offset;
  const float m = stats[2 * row], inv = 1.f / stats[2 * row + 1];
  const float gx = grad[3 * row] * inv, gy = grad[3 * row + 1] * inv,
              gz = grad[3 * row + 2] * inv;
  // dl = e * (gx cx + gy cy + gz cz + c0), e = 2^(l log2(e) - m), g scaled by 1 / s
  const float c0 = -(gx * xyz[3 * row] + gy * xyz[3 * row + 1] + gz * xyz[3 * row + 2]);
  const float step = gx * vol.step_x;
  int begin, end;
  slice_range(vol, blockIdx.x, begin, end);

  int v = begin + threadIdx.x;
  for (; v + (kUnroll - 1) * kThreads < end; v += kUnroll * kThreads) {
    float x[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load(l, v + u * kThreads, x[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float cx0, cy, cz;
      centres(vol, v + u * kThreads, cx0, cy, cz);
      const float base = fmaf(gx, cx0, fmaf(gy, cy, fmaf(gz, cz, c0)));
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        x[u][k] = ex2(fmaf(x[u][k], kLog2e, -m)) * fmaf(static_cast<float>(k), step, base);
      }
      store(dl, v + u * kThreads, x[u]);
    }
  }
  for (; v < end; v += kThreads) {
    float x[kVec];
    load(l, v, x);
    float cx0, cy, cz;
    centres(vol, v, cx0, cy, cz);
    const float base = fmaf(gx, cx0, fmaf(gy, cy, fmaf(gz, cz, c0)));
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      x[k] = ex2(fmaf(x[k], kLog2e, -m)) * fmaf(static_cast<float>(k), step, base);
    }
    store(dl, v, x);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// The launch's constants; false for a shape or pointer the kernels do not take.
bool setup(const void* logits, int rows, int d, int h, int w, Volume& vol) {
  const int64_t size = static_cast<int64_t>(d) * h * w;
  if (rows < 1 || rows > 65535 || d < 1 || h < 1 || w < kVec || w % kVec != 0 ||
      size >= (int64_t{1} << 31) || !aligned16(logits)) {
    return false;
  }
  vol.rows = rows;
  vol.size = static_cast<int>(size);
  vol.vectors = vol.size / kVec;
  vol.line = make_fastdiv(w / kVec);
  vol.height = make_fastdiv(h);
  vol.step_x = static_cast<float>(2.0 / w);
  vol.first_x = static_cast<float>(-(w - 1.0) / w);
  vol.step_y = static_cast<float>(2.0 / h);
  vol.first_y = static_cast<float>(-(h - 1.0) / h);
  vol.step_z = static_cast<float>(2.0 / d);
  vol.first_z = static_cast<float>(-(d - 1.0) / d);
  return true;
}

}  // namespace

// logits [rows, d * h * w] contiguous, 16-byte aligned, float32 (bf16 = 0)
// or bf16 (bf16 = 1), w a multiple of 8, rows at most 65535; xyz [rows, 3]
// and stats [rows, 2] contiguous f32. Launches once on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape it does not take.
extern "C" int softargmax3d_fwd(const void* logits, int bf16, int rows, int d, int h, int w,
                                void* xyz, void* stats, void* stream) {
  Volume vol;
  if (!setup(logits, rows, d, h, w, vol)) return cudaErrorInvalidValue;
  const dim3 grid(kSplit, rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* x = static_cast<float*>(xyz);
  float* s = static_cast<float*>(stats);
  if (bf16) {
    softargmax3d_fwd_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(logits), vol, x, s);
  } else {
    softargmax3d_fwd_kernel<<<grid, kThreads, 0, st>>>(static_cast<const float*>(logits), vol,
                                                         x, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// logits, xyz and stats as softargmax3d_fwd read and wrote them; grad
// [rows, 3] contiguous f32, the cotangent of xyz; dlogits like logits,
// 16-byte aligned. Launches once on `stream`; returns as softargmax3d_fwd.
extern "C" int softargmax3d_bwd(const void* logits, int bf16, const void* xyz, const void* stats,
                                const void* grad, void* dlogits, int rows, int d, int h, int w,
                                void* stream) {
  Volume vol;
  if (!setup(logits, rows, d, h, w, vol) || !aligned16(dlogits)) return cudaErrorInvalidValue;
  const dim3 grid(kSplit, rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(xyz);
  const float* s = static_cast<const float*>(stats);
  const float* g = static_cast<const float*>(grad);
  if (bf16) {
    softargmax3d_bwd_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(logits), vol, x, s, g,
        static_cast<__nv_bfloat16*>(dlogits));
  } else {
    softargmax3d_bwd_kernel<<<grid, kThreads, 0, st>>>(static_cast<const float*>(logits), vol, x,
                                                         s, g, static_cast<float*>(dlogits));
  }
  return static_cast<int>(cudaGetLastError());
}
