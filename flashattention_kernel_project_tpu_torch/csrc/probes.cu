// The softmax-chain probe of the attention forward (row 23 of the port's
// kernel table) and the stream copy, for Hopper (sm_90a). The other stage
// probes (copy, qk, pv, qk_kt, qk_packed) are the Hopper forward's own block
// with the other stages taken out (probes_sm90.cu, entry fkp_probe_sm90);
// the chain here (entry fkp_probe, stage 3) is still a standalone
// template on 64-row blocks of 4 warps, the design of the port's first
// forward, whose body is gone.
//
// Replaces flashattention_kernel_project_tpu/ops/probes.py:
// - softmax_chain_probe (:287, :328): the online (m, l, rescale, exp) chain
//   on scores q[row, 0] * 0.001 at every key, no products; acc / (l + 1e-6);
// - stream_copy_probe (:360): out = x + 1 over [R, C], in x's type.
//
// Design of the chain: one block of 4 warps per 64-query tile, q head and
// batch row; 64-key K/V tiles loaded 16 bytes a thread into padded shared
// memory between two barriers; each thread holds the scores of the
// m16n8k16 accumulator layout. Outputs are f32 [B, Hq, N, D], written once.
//
// Keeping its work in the binary: every loaded row reaches shared memory (a
// shared store is never removed, other threads may read it), and the
// scores are the row's base score plus `zero * key` with `zero` a kernel
// argument (0 at run time): the compiler cannot prove a row's scores equal,
// so it takes exp2 of every one instead of hoisting it out of the key loop.
//
// What bounds each on the H100: the chain's bound is the exp2 unit (16
// results a clock an SM). The stream copy is bound by its read and write
// bytes at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // finite, as NEG_INF in ops/softmax.py
constexpr int kBlockM = 64;        // query rows per block (16 per warp)
constexpr int kBlockN = 64;        // keys per shared-memory tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// the stage number of ops/probes.py (the others are probes_sm90.cu's)
enum Stage : int { kChain = 3 };

// The chain: q [b, hq, n, D] bf16; k, v [b, hkv, s, D] bf16 (loaded, as
// the forward loads them, and unused); o [b, hq, n, D] f32. n and s
// multiples of 64; hq a multiple of hkv. zero: 0.f, read at run time.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    probe_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, float* __restrict__ o,
                 int hq, int hkv, int n, int s, float zero) {
  constexpr int kStride = D + 8;  // a [key][dim] tile row, in bf16
  __shared__ __align__(16) __nv_bfloat16 k_s[kBlockN * kStride];
  __shared__ __align__(16) __nv_bfloat16 v_s[kBlockN * kStride];

  const int m_block = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const size_t bh = (size_t)b * hq + h;
  const __nv_bfloat16* q_bh = q + bh * n * D;
  const size_t kv_head = ((size_t)b * hkv + kvh) * s * D;
  const __nv_bfloat16* k_bh = k + kv_head;
  const __nv_bfloat16* v_bh = v + kv_head;
  const int row0 = m_block * kBlockM + warp * 16 + g;
  const int row1 = row0 + 8;

  // the rows' base scores q[row, 0] * 0.001 and their (m, l)
  const float base0 = __bfloat162float(q_bh[(size_t)row0 * D]) * 0.001f;
  const float base1 = __bfloat162float(q_bh[(size_t)row1 * D]) * 0.001f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  }

  const int n_tiles = s / kBlockN;
  for (int j = 0; j < n_tiles; ++j) {
    const int key0 = j * kBlockN;
    __syncthreads();  // every warp is done with the previous tile
    constexpr int kVecPerRow = D / 8;
    for (int i = threadIdx.x; i < kBlockN * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow;
      const int c = (i % kVecPerRow) * 8;
      const size_t off = (size_t)(key0 + r) * D + c;
      *reinterpret_cast<uint4*>(k_s + r * kStride + c) =
          *reinterpret_cast<const uint4*>(k_bh + off);
      *reinterpret_cast<uint4*>(v_s + r * kStride + c) =
          *reinterpret_cast<const uint4*>(v_bh + off);
    }
    __syncthreads();

    // the forward's per-score softmax arithmetic: the thread's 32 scores
    // of the tile (16 keys of row0, 16 of row1), element e of n-tile nt at
    // key key0 + nt*8 + 2t + (e & 1)
    float sv[kBlockN / 8][4];
    float tmax0 = kNegInf, tmax1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float col = (float)(key0 + nt * 8 + 2 * t + (e & 1));
        sv[nt][e] = (e < 2 ? base0 : base1) + zero * col;
        if (e < 2) {
          tmax0 = fmaxf(tmax0, sv[nt][e]);
        } else {
          tmax1 = fmaxf(tmax1, sv[nt][e]);
        }
      }
    }
    tmax0 = fmaxf(tmax0, __shfl_xor_sync(0xffffffffu, tmax0, 1));
    tmax0 = fmaxf(tmax0, __shfl_xor_sync(0xffffffffu, tmax0, 2));
    tmax1 = fmaxf(tmax1, __shfl_xor_sync(0xffffffffu, tmax1, 1));
    tmax1 = fmaxf(tmax1, __shfl_xor_sync(0xffffffffu, tmax1, 2));
    const float mn0 = fmaxf(m0, tmax0);
    const float mn1 = fmaxf(m1, tmax1);
    const float r0 = exp2f(m0 - mn0);
    const float r1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      ps0 += exp2f(sv[nt][0] - mn0) + exp2f(sv[nt][1] - mn0);
      ps1 += exp2f(sv[nt][2] - mn1) + exp2f(sv[nt][3] - mn1);
    }
    // the row's sum over the tile's 64 keys (its four threads)
    ps0 += __shfl_xor_sync(0xffffffffu, ps0, 1);
    ps0 += __shfl_xor_sync(0xffffffffu, ps0, 2);
    ps1 += __shfl_xor_sync(0xffffffffu, ps1, 1);
    ps1 += __shfl_xor_sync(0xffffffffu, ps1, 2);
    l0 = l0 * r0 + ps0;
    l1 = l1 * r1 + ps1;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      acc[nd][0] = acc[nd][0] * r0 + ps0;
      acc[nd][1] = acc[nd][1] * r0 + ps0;
      acc[nd][2] = acc[nd][2] * r1 + ps1;
      acc[nd][3] = acc[nd][3] * r1 + ps1;
    }
  }

  float* o_bh = o + bh * n * D;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + 2 * t;
    *reinterpret_cast<float2*>(o_bh + (size_t)row0 * D + c) =
        make_float2(acc[nd][0] / (l0 + 1e-6f), acc[nd][1] / (l0 + 1e-6f));
    *reinterpret_cast<float2*>(o_bh + (size_t)row1 * D + c) =
        make_float2(acc[nd][2] / (l1 + 1e-6f), acc[nd][3] / (l1 + 1e-6f));
  }
}

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

// The softmax chain probe (stage 3; the other stages are fkp_probe_sm90's):
// q [b, hq, n, d], k and v [b, hkv, s, d] bf16 contiguous; o [b, hq, n, d]
// f32. d in {64, 128}, n and s multiples of 64, hq a multiple of hkv. zero
// must be 0.f. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue without one for arguments outside these.
extern "C" int fkp_probe(const void* q, const void* k, const void* v, void* o,
                         int b, int hq, int hkv, int n, int s, int d, int stage,
                         float zero, void* stream) {
  if (n % kBlockM || s % kBlockN || hkv < 1 || hq % hkv || stage != kChain ||
      v == nullptr || (d != 64 && d != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(n / kBlockM, hq, b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  float* of = static_cast<float*>(o);
  if (d == 64) {
    probe_kernel<64><<<grid, kThreads, 0, st>>>(qb, kb, vb, of, hq, hkv, n, s, zero);
  } else {
    probe_kernel<128><<<grid, kThreads, 0, st>>>(qb, kb, vb, of, hq, hkv, n, s, zero);
  }
  return static_cast<int>(cudaGetLastError());
}

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
