// Row softmax over the last axis for Hopper (sm_90a), f32 or bf16 in and
// out, f32 arithmetic.
//
// Replaces flashattention_kernel_project_tpu/ops/softmax.py::_softmax_kernel
// (softmax): the same arithmetic in the log2 domain, m = max(x), e =
// exp2((x - m) * log2(e)), then one reciprocal of the sum multiplied over
// the row. The TPU kernel reduces a VMEM block of rows at a time; here the
// reference's own ladder (warp-shuffle and block-hybrid softmax) returns:
// - a row of up to 32 * 8 16-byte pieces (1024 f32, 2048 bf16) goes to one
//   warp, which holds it in registers and reduces it with shuffles, 8 rows
//   to a block;
// - a row of up to 256 * 8 pieces (8192 f32, 16384 bf16) goes to a block of
//   256 threads, registers again, shuffles then shared memory across warps;
// - a longer row goes to a block that reads it twice: once for a running
//   (max, sum) per thread, merged over the block, once to write (the second
//   read mostly from L2, which holds the rows of every block in flight).
// Each thread reads 16-byte pieces where the row length and the bases allow
// it, element by element otherwise, so any length works.
//
// What bounds it on the H100: bytes. It reads each element once and writes
// it once, a few operations each, so 2 * rows * n * itemsize / 3.35 TB/s is
// its bound (0.080 ms at 8192 x 4096 f32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;  // finite, as NEG_INF in ops/softmax.py
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float& d, float x) { d = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16& d, float x) { d = __float2bfloat16(x); }

template <class T>
constexpr int kVec = 16 / sizeof(T);  // elements of a 16-byte piece

// the piece of row x starting at element i, -inf past n
template <class T>
__device__ __forceinline__ void load_piece(const T* x, int i, int n, bool vec,
                                           float (&v)[kVec<T>]) {
  if (vec && i + kVec<T> <= n) {
    const uint4 r = *reinterpret_cast<const uint4*>(x + i);
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int j = 0; j < kVec<T>; ++j) v[j] = to_f32(e[j]);
  } else {
#pragma unroll
    for (int j = 0; j < kVec<T>; ++j) v[j] = i + j < n ? to_f32(x[i + j]) : -INFINITY;
  }
}

template <class T>
__device__ __forceinline__ void store_piece(T* y, int i, int n, bool vec,
                                            const float (&v)[kVec<T>]) {
  if (vec && i + kVec<T> <= n) {
    uint4 r;
    T* e = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int j = 0; j < kVec<T>; ++j) from_f32(e[j], v[j]);
    *reinterpret_cast<uint4*>(y + i) = r;
  } else {
#pragma unroll
    for (int j = 0; j < kVec<T>; ++j) {
      if (i + j < n) from_f32(y[i + j], v[j]);
    }
  }
}

// the max (kMax) or the sum of v over the kTpr threads of a row
template <int kTpr, bool kMax>
__device__ __forceinline__ float row_reduce(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = kMax ? fmaxf(v, o) : v + o;
  }
  if constexpr (kTpr > 32) {
    __shared__ float part[kTpr / 32];
    if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = v;
    __syncthreads();
    v = part[0];
#pragma unroll
    for (int w = 1; w < kTpr / 32; ++w) v = kMax ? fmaxf(v, part[w]) : v + part[w];
    __syncthreads();  // part is written again by the next reduction
  }
  return v;
}

// kTpr threads a row (32: a warp, kThreads: the block), each holding kC
// pieces in registers: piece c of thread t starts at element (c * kTpr +
// t) * kVec.
template <class T, int kTpr, int kC>
__global__ void __launch_bounds__(kThreads)
    softmax_kernel(const T* x, T* y, int rows, int n, int vec) {
  constexpr int V = kVec<T>;
  const long long row = ((long long)blockIdx.x * kThreads + threadIdx.x) / kTpr;
  const int t = threadIdx.x % kTpr;
  if (row >= rows) return;  // whole warps only: kTpr is 32 or the block
  x += (size_t)row * n;
  y += (size_t)row * n;
  float v[kC][V];
  float mx = -INFINITY;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    load_piece(x, (c * kTpr + t) * V, n, vec, v[c]);
#pragma unroll
    for (int j = 0; j < V; ++j) mx = fmaxf(mx, v[c][j]);
  }
  mx = row_reduce<kTpr, true>(mx);
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      v[c][j] = exp2f((v[c][j] - mx) * kLog2e);  // 0 past n
      sum += v[c][j];
    }
  }
  const float r = 1.f / row_reduce<kTpr, false>(sum);
#pragma unroll
  for (int c = 0; c < kC; ++c) {
#pragma unroll
    for (int j = 0; j < V; ++j) v[c][j] *= r;
    store_piece(y, (c * kTpr + t) * V, n, vec, v[c]);
  }
}

// A row too long for registers: a block reads it twice.
template <class T>
__global__ void __launch_bounds__(kThreads)
    softmax_long_kernel(const T* x, T* y, int n, int vec) {
  constexpr int V = kVec<T>;
  x += (size_t)blockIdx.x * n;
  y += (size_t)blockIdx.x * n;
  float m = kNegInf, l = 0.f, v[V];
  for (int i = threadIdx.x * V; i < n; i += kThreads * V) {
    load_piece(x, i, n, vec, v);
    float mx = v[0];
#pragma unroll
    for (int j = 1; j < V; ++j) mx = fmaxf(mx, v[j]);
    const float m_new = fmaxf(m, mx);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) s += exp2f((v[j] - m_new) * kLog2e);
    l = l * exp2f((m - m_new) * kLog2e) + s;
    m = m_new;
  }
  const float mx = row_reduce<kThreads, true>(m);
  const float r = 1.f / row_reduce<kThreads, false>(l * exp2f((m - mx) * kLog2e));
  for (int i = threadIdx.x * V; i < n; i += kThreads * V) {
    load_piece(x, i, n, vec, v);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = exp2f((v[j] - mx) * kLog2e) * r;
    store_piece(y, i, n, vec, v);
  }
}

template <class T, int kTpr>
int launch_regs(const T* x, T* y, int rows, int n, int vec, int pieces,
                cudaStream_t s) {
  const int per = (pieces + kTpr - 1) / kTpr;  // pieces a thread, <= 8
  const int grid = (int)(((long long)rows * kTpr + kThreads - 1) / kThreads);
  auto go = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, s>>>(x, y, rows, n, vec);
  };
  if (per <= 1) go(softmax_kernel<T, kTpr, 1>);
  else if (per <= 2) go(softmax_kernel<T, kTpr, 2>);
  else if (per <= 4) go(softmax_kernel<T, kTpr, 4>);
  else go(softmax_kernel<T, kTpr, 8>);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch(const void* xv, void* yv, int rows, int n, int vec, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  const int pieces = (n + kVec<T> - 1) / kVec<T>;
  if (pieces <= 32 * 8) return launch_regs<T, 32>(x, y, rows, n, vec, pieces, s);
  if (pieces <= kThreads * 8) {
    return launch_regs<T, kThreads>(x, y, rows, n, vec, pieces, s);
  }
  softmax_long_kernel<T><<<rows, kThreads, 0, s>>>(x, y, n, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y [rows, n] contiguous, both f32 or both bf16 (bf16); vec: n is a
// multiple of 16 bytes' worth of elements and x, y are 16-byte aligned.
// Returns cudaGetLastError() after the launch.
extern "C" int fkp_softmax(const void* x, void* y, int rows, int n, int bf16,
                           int vec, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, y, rows, n, vec, s)
              : launch<float>(x, y, rows, n, vec, s);
}
