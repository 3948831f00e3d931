// Split-KV single-token GQA decode over an int8 cache with both products
// int8 x int8, for Hopper (sm_90a).
//
// Replaces flashattention_kernel_project_tpu/ops/flash_decode.py::
// _decode_kernel_int8_mxu (reached through flash_decode_int8(mxu=True)).
// Each (batch row, KV head, split) block emits the unnormalized partials
// (m, l, y) of the G = Hq / Hkv query rows of its group over its split's
// live keys, as the cast kernel (_decode_kernel_int8, kernel 7) does,
// but in the TPU kernel's arithmetic:
// - q is quantized per row: qsc = (max|q| == 0 ? 1 : max|q|) / 127,
//   q_i8 = round(q / qsc), and the row's score scale is qs = qsc * sm_scale;
// - the score of key j is f32(q_i8 . k_i8) * (qs * ks[j]), an exact int32
//   dot;
// - over the split, m = max s, e = exp(s - m) (0 where masked), l = sum e;
// - the weights ew = e * vs[j] are requantized per row over the whole
//   split: r = max ew, rs = (r == 0 ? 1 : r) / 127, ei = int8(floor(ew /
//   rs + 0.5));
// - y = f32(ei . v_i8) * rs, again an exact int32 sum.
// The split is the requantization group, so the wrapper sizes block_s by
// the JAX rule (a multiple of 32 keys) and the split count is part of the
// function. With a sliding window the split's live keys are its sink and
// band ranges (decode_core.cuh's window_ranges), as in the JAX mask.
//
// Design: one block of 128 threads per split, grid (B, Hkv, n_splits), in
// three phases, with the split's scores (f32 [G][block_s]) and weights
// (int8 [G][block_s]) in dynamic shared memory, 5 * G * block_s bytes
// (opted in past 48 KB; the wrapper refuses a split that does not fit the
// 227 KB a block may hold):
//   0. every warp quantizes its q rows (decode_core.cuh's quantize_q_rows);
//   1. scores: the threads of a key each load 16 (at
//      G = 8, 8) bytes of its K row, 8 keys in flight a thread, and __dp4a
//      them against the row's int8 q bytes; integer shuffles sum the key's
//      partial dots exactly;
//   2. row statistics: block-wide max, exp, l and r over shared memory,
//      then the int8 weights;
//   3. output: a thread takes 4 consecutive keys' pieces of V (two such
//      sets in flight), transposes them 4 x 4 bytes (mma.cuh's transpose4)
//      so that a word holds one dim of the 4 keys, and __dp4a's it against
//      the 4 keys' weights; the int32 sums meet across the block by integer
//      shuffles and shared-memory atomics, exact in any order.
// What bounds it on the H100: bytes, as every decode: a
// key costs 2 * d + 8 bytes and 4 * G * d integer operations, far below the
// card's ridge, so the CUDA cores' __dp4a keeps up and the tensor cores
// (mma.m16n8k32, which would waste 12 of its 16 rows at G = 4) would buy
// nothing. The two phases stream K and then V, each with a thread's 128
// bytes in flight.

#include "decode_core.cuh"
#include "mma.cuh"

namespace {

using fkp_dec::kNegInf;
using fkp_dec::kThreads;
using fkp_dec::kWarps;
using fkp_mma::transpose4;

constexpr int kKeys = 8;  // keys a thread has in flight in phases 1 and 3

// x[gi] for gi < G reduced over the block (max, or sum), in every thread;
// red: kWarps x G floats of shared memory, free again on return
template <int G, bool kMax>
__device__ __forceinline__ void block_reduce(float (&x)[G], float (*red)[G]) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, x[gi], off);
      x[gi] = kMax ? fmaxf(x[gi], o) : x[gi] + o;
    }
    if (lane == 0) red[warp][gi] = x[gi];
  }
  __syncthreads();
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    float r = red[0][gi];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, red[w][gi]) : r + red[w][gi];
    x[gi] = r;
  }
  __syncthreads();
}

// Launch bounds with a minimum of one block per SM: with the thread count
// alone, ptxas spilled 8 bytes in the d = 64, G = 2 instance (as in
// paged_decode.cu).
template <int D, int G>
__global__ void __launch_bounds__(kThreads, 1)
    flash_decode_mxu_kernel(const __nv_bfloat16* __restrict__ q,
                            const int8_t* __restrict__ k,
                            const float* __restrict__ k_scale,
                            const int8_t* __restrict__ v,
                            const float* __restrict__ v_scale,
                            const int* __restrict__ lengths,
                            float* __restrict__ m_out,
                            float* __restrict__ l_out,
                            float* __restrict__ y_out, int hkv, int s,
                            int n_splits, int block_s, float sm_scale,
                            int window, int sinks) {
  constexpr int kWords = G == 8 ? 2 : 4;    // words of a key row a thread
  constexpr int kDims = 4 * kWords;         // the dims it holds
  constexpr int kTpk = D / kDims;           // threads per key
  constexpr int kGroups = kThreads / kTpk;  // keys per block step
  using Raw = fkp_dec::Raw<kWords>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sc = reinterpret_cast<float*>(smem);                // [G][block_s]
  int8_t* ei = reinterpret_cast<int8_t*>(sc + G * block_s);  // [G][block_s]
  __shared__ __align__(16) int8_t q_s[G][D];
  __shared__ float qs_s[G];
  __shared__ float rs_s[G];
  __shared__ int y_s[G][D];
  __shared__ float red[kWarps][G];

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int split = blockIdx.z;
  const int len = min(max(lengths[b], 0), s);  // lengths above S clamp to S
  const int start = split * block_s;
  int s0, e0, s1, e1;
  fkp_dec::window_ranges(start, min(start + block_s, len), len, window, sinks,
                         s0, e0, s1, e1);
  const size_t part = ((size_t)b * hkv + kvh) * n_splits + split;
  float* m_p = m_out + part * G;
  float* l_p = l_out + part * G;
  float* y_p = y_out + part * G * D;
  if (s0 >= e0 && s1 >= e1) {  // dead split: no K/V loads
    for (int i = threadIdx.x; i < G * D; i += kThreads) y_p[i] = 0.f;
    if (threadIdx.x < G) {
      m_p[threadIdx.x] = kNegInf;
      l_p[threadIdx.x] = 0.f;
    }
    return;
  }
  const size_t bh = (size_t)b * hkv + kvh;
  const int8_t* k_h = k + bh * s * D;
  const int8_t* v_h = v + bh * s * D;
  const float* ks_h = k_scale + bh * s;
  const float* vs_h = v_scale + bh * s;
  // split positions [0, n_buf) hold the live ranges (and a gap between them)
  const int n_buf = (s1 < e1 ? e1 : e0) - start;
  const int lane = threadIdx.x % 32;
  const int grp = threadIdx.x / kTpk;
  const int c0 = (threadIdx.x % kTpk) * kDims;

  // 0. the q rows to int8; every score to NEG_INF, the output sums to 0
  fkp_dec::quantize_q_rows<D, G>(q + bh * G * D, sm_scale, q_s, qs_s);
  for (int i = threadIdx.x; i < G * n_buf; i += kThreads) {
    sc[(i / n_buf) * block_s + i % n_buf] = kNegInf;
  }
  for (int i = threadIdx.x; i < G * D; i += kThreads) (&y_s[0][0])[i] = 0;
  __syncthreads();

  // 1. scores of the live keys. `base` and the range's end are uniform
  // across the block, so the shuffles see full warps.
  {
    int qi[G][kWords];
    float qs[G];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        qi[gi][w] = *reinterpret_cast<const int*>(&q_s[gi][c0 + 4 * w]);
      }
      qs[gi] = qs_s[gi];
    }
#pragma unroll 1
    for (int range = 0; range < 2; ++range) {
      const int lo = range == 0 ? s0 : s1;
      const int hi = range == 0 ? e0 : e1;
      for (int base = lo; base < hi; base += kGroups * kKeys) {
        Raw kr[kKeys];
        float ks[kKeys];
#pragma unroll
        for (int u = 0; u < kKeys; ++u) {
          const int key = base + u * kGroups + grp;
          kr[u] = Raw{};
          ks[u] = 0.f;
          if (key < hi) {
            kr[u] = *reinterpret_cast<const Raw*>(k_h + (size_t)key * D + c0);
            ks[u] = ks_h[key];
          }
        }
#pragma unroll
        for (int u = 0; u < kKeys; ++u) {
          const int key = base + u * kGroups + grp;
          const int* kw = reinterpret_cast<const int*>(&kr[u]);
#pragma unroll
          for (int gi = 0; gi < G; ++gi) {
            int dot = 0;
#pragma unroll
            for (int w = 0; w < kWords; ++w) dot = __dp4a(kw[w], qi[gi][w], dot);
#pragma unroll
            for (int off = kTpk / 2; off > 0; off >>= 1) {
              dot += __shfl_xor_sync(0xffffffffu, dot, off);
            }
            if (key < hi && c0 == 0) {
              sc[gi * block_s + key - start] =
                  static_cast<float>(dot) * (qs[gi] * ks[u]);
            }
          }
        }
      }
    }
  }
  __syncthreads();

  // 2. the row statistics over the split, then the int8 weights
  float mx[G], lsum[G], r[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    mx[gi] = kNegInf;
    lsum[gi] = r[gi] = 0.f;
  }
  for (int j = threadIdx.x; j < n_buf; j += kThreads) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) mx[gi] = fmaxf(mx[gi], sc[gi * block_s + j]);
  }
  block_reduce<G, true>(mx, red);
  for (int j = threadIdx.x; j < n_buf; j += kThreads) {
    const int key = start + j;
    const bool live = (key >= s0 && key < e0) || (key >= s1 && key < e1);
    const float vs = live ? vs_h[key] : 0.f;
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float ew = 0.f;  // e * vs[j], in place of the score
      if (live) {
        const float e = expf(sc[gi * block_s + j] - mx[gi]);
        lsum[gi] += e;
        ew = e * vs;
      }
      sc[gi * block_s + j] = ew;
      r[gi] = fmaxf(r[gi], ew);
    }
  }
  block_reduce<G, false>(lsum, red);
  block_reduce<G, true>(r, red);
  float rs[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    rs[gi] = (r[gi] == 0.f ? 1.f : r[gi]) * (1.f / 127.f);
    if (threadIdx.x == gi) rs_s[gi] = rs[gi];
  }
  // ew >= 0, so floor(x + 0.5) rounds half up, as the JAX kernel; phase 3
  // reads words of 4 weights, so the positions up to the next 4 are 0
  const int n_pad = (n_buf + 3) & ~3;
  for (int j = threadIdx.x; j < n_pad; j += kThreads) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      ei[gi * block_s + j] =
          j < n_buf ? static_cast<int8_t>(floorf(sc[gi * block_s + j] / rs[gi] + 0.5f))
                    : int8_t{0};
    }
  }
  __syncthreads();

  // 3. y = ei . v: 4 consecutive keys a set, from a multiple of 4 at or
  // below the range's start; V rows outside [lo, hi) load as 0, so a set
  // that straddles a range's edge adds nothing of the keys outside it
  int acc[G][kDims];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
#pragma unroll
    for (int i = 0; i < kDims; ++i) acc[gi][i] = 0;
  }
#pragma unroll 1
  for (int range = 0; range < 2; ++range) {
    const int lo = range == 0 ? s0 : s1;
    const int hi = range == 0 ? e0 : e1;
    if (lo >= hi) continue;
    for (int base = start + ((lo - start) & ~3); base < hi; base += kGroups * kKeys) {
      Raw vr[kKeys];
#pragma unroll
      for (int u = 0; u < kKeys; ++u) {
        const int key = base + ((u / 4) * kGroups + grp) * 4 + u % 4;
        vr[u] = Raw{};
        if (key >= lo && key < hi) {
          vr[u] = *reinterpret_cast<const Raw*>(v_h + (size_t)key * D + c0);
        }
      }
#pragma unroll
      for (int set = 0; set < kKeys / 4; ++set) {
        const int key0 = base + (set * kGroups + grp) * 4;
        if (key0 >= hi) continue;
        int eiw[G];  // the 4 keys' weights of each row
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          eiw[gi] = *reinterpret_cast<const int*>(&ei[gi * block_s + key0 - start]);
        }
#pragma unroll
        for (int w = 0; w < kWords; ++w) {
          uint32_t rows[4], cols[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            rows[i] = reinterpret_cast<const uint32_t*>(&vr[set * 4 + i])[w];
          }
          transpose4(rows, cols);  // cols[i]: dim c0 + 4w + i of the 4 keys
#pragma unroll
          for (int gi = 0; gi < G; ++gi) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[gi][4 * w + i] =
                  __dp4a(static_cast<int>(cols[i]), eiw[gi], acc[gi][4 * w + i]);
            }
          }
        }
      }
    }
  }
  // the key groups' sums: across the warp's groups by shuffles, then the
  // warps through shared memory
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
#pragma unroll
    for (int i = 0; i < kDims; ++i) {
#pragma unroll
      for (int off = kTpk; off < 32; off <<= 1) {
        acc[gi][i] += __shfl_xor_sync(0xffffffffu, acc[gi][i], off);
      }
      if (lane < kTpk) atomicAdd(&y_s[gi][c0 + i], acc[gi][i]);
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    y_p[idx] = static_cast<float>((&y_s[0][0])[idx]) * rs_s[idx / D];
  }
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (threadIdx.x == gi) {
      m_p[gi] = mx[gi];
      l_p[gi] = lsum[gi];
    }
  }
}

}  // namespace

// q [b, hq, d] bf16; k/v [b, hkv, s, d] int8 and their scales
// k_scale/v_scale [b, hkv, s, 1] f32, all contiguous; lengths [b] int32;
// m, l [b, hkv, n_splits, G] and y [b, hkv, n_splits, G, d] f32, G = hq/hkv
// in {1, 2, 4, 8}, d in {64, 128}. Split i covers keys [i*block_s,
// (i+1)*block_s), block_s a multiple of 32; it takes 5 * G * block_s bytes
// of dynamic shared memory. window > 0: the band of the last `window` keys
// plus the first `sinks`; 0: every key below the length. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue without one
// for a block_s that is not a multiple of 32.
extern "C" int fkp_flash_decode_mxu(const void* q, const void* k,
                                    const void* k_scale, const void* v,
                                    const void* v_scale, const void* lengths,
                                    void* m, void* l, void* y, int b, int hq,
                                    int hkv, int s, int d, int n_splits,
                                    int block_s, float sm_scale, int window,
                                    int sinks, void* stream) {
  if (block_s <= 0 || block_s % 32) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(b, hkv, n_splits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return fkp_dec::dispatch(d, hq / hkv, [&](auto dc, auto gc) {
    constexpr int D = decltype(dc)::value;
    constexpr int G = decltype(gc)::value;
    const auto kernel = &flash_decode_mxu_kernel<D, G>;
    const size_t smem = (size_t)5 * G * block_s;
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    }
    kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k),
        static_cast<const float*>(k_scale), static_cast<const int8_t*>(v),
        static_cast<const float*>(v_scale), static_cast<const int*>(lengths),
        static_cast<float*>(m), static_cast<float*>(l), static_cast<float*>(y),
        hkv, s, n_splits, block_s, sm_scale, window, sinks);
  });
}
