// The stream copy probe for Hopper (sm_90a). The stage probes (copy, qk,
// pv, the softmax chain, qk_kt, qk_packed) are the Hopper forward's own
// block with the other stages taken out (probes_sm90.cu, entry
// fkp_probe_sm90).
//
// Replaces flashattention_kernel_project_tpu/ops/probes.py::
// stream_copy_probe (:360): out = x + 1 over [R, C], in x's type.
//
// What bounds it on the H100: its read and write bytes at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// out = x + 1 over n elements of T (float or bf16). What bounds it on the
// H100: bytes, one read and one write of each element (0.0801 ms at
// 8192 x 4096 f32). One tile of kStreamThreads x kStreamVecs 16-byte
// vectors a block, all its loads issued before its stores, no loop, as
// many blocks as tiles: the block scheduler keeps every SM's slots full to
// the last tile (a grid-stride loop over the blocks that fit at once runs
// in waves with a tail) and consecutive blocks read consecutive memory.
// The element tail (n not a multiple of the vector) is block 0's.
constexpr int kStreamThreads = 128;
constexpr int kStreamVecs = 2;

template <class T>
__device__ __forceinline__ uint4 add_one(uint4 r) {
  if constexpr (sizeof(T) == 4) {
    float* f = reinterpret_cast<float*>(&r);
#pragma unroll
    for (int e = 0; e < 4; ++e) f[e] += 1.f;
  } else {
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      h[e] = __floats2bfloat162_rn(f.x + 1.f, f.y + 1.f);
    }
  }
  return r;
}

// a plain 16-byte ld.global, the load the timed design used (through
// const __restrict__ the compiler may take the read-only path instead)
__device__ __forceinline__ uint4 ld_global(const uint4* p) {
  uint4 r;
  asm volatile("ld.global.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

template <class T>
__global__ void __launch_bounds__(kStreamThreads)
    stream_copy_kernel(const T* __restrict__ x, T* __restrict__ out, size_t n) {
  constexpr int kPer = 16 / sizeof(T);
  constexpr size_t kStep = (size_t)kStreamVecs * kStreamThreads;
  const size_t n_vec = n / kPer;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* ov = reinterpret_cast<uint4*>(out);
  const size_t base = (size_t)blockIdx.x * kStep;
  const size_t i = base + threadIdx.x;
  if (base + kStep <= n_vec) {
    uint4 r[kStreamVecs];
#pragma unroll
    for (int u = 0; u < kStreamVecs; ++u) r[u] = ld_global(xv + i + u * kStreamThreads);
#pragma unroll
    for (int u = 0; u < kStreamVecs; ++u) ov[i + u * kStreamThreads] = add_one<T>(r[u]);
  } else {
    for (size_t j = i; j < n_vec; j += kStreamThreads) ov[j] = add_one<T>(ld_global(xv + j));
  }
  if (blockIdx.x == 0) {
    for (size_t j = n_vec * kPer + threadIdx.x; j < n; j += kStreamThreads) {
      if constexpr (sizeof(T) == 4) {
        out[j] = x[j] + 1.f;
      } else {
        out[j] = __float2bfloat16_rn(__bfloat162float(x[j]) + 1.f);
      }
    }
  }
}

template <class T>
int launch_stream(const void* x, void* out, long long n, cudaStream_t st) {
  constexpr long long kStep = (long long)kStreamVecs * kStreamThreads;
  const long long tiles = (n / (16 / (long long)sizeof(T)) + kStep - 1) / kStep;
  stream_copy_kernel<T><<<static_cast<int>(tiles < 1 ? 1 : tiles), kStreamThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<size_t>(n));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out = x + 1 over n elements, x and out contiguous and 16-byte aligned,
// f32 (bf16 == 0) or bf16 (bf16 == 1). Returns cudaGetLastError() after the
// launch.
extern "C" int fkp_stream_copy(const void* x, void* out, long long n, int bf16,
                               void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_stream<__nv_bfloat16>(x, out, n, st)
              : launch_stream<float>(x, out, n, st);
}
