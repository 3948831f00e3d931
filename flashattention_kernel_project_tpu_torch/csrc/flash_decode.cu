// Split-KV single-token GQA decode for Hopper (sm_90a).
//
// Replaces flashattention_kernel_project_tpu/ops/flash_decode.py::
// _decode_kernel (reached through flash_decode) for a bf16 cache: each
// (batch, KV head, split) program emits the unnormalized partials (m, l, y)
// of the G = Hq / Hkv query rows of its group over its split's keys below
// lengths[b]; merge_partials combines the splits outside the kernel.
//
// What bounds it on the H100: bytes. Each key costs 4*d bytes of K and V and
// 4*G*d flops, G flops per byte at G = 4, far below the ~295 flop/byte
// ridge, so the roof is the 3.35 TB/s of HBM and tensor cores would buy
// nothing. What matters is reading only live keys, with wide loads and
// enough loads in flight to cover device-memory latency.
//
// Design: grid (B, Hkv, n_splits), one 128-thread block per split, chosen by
// the wrapper so that B*Hkv*n_splits blocks fill the 132 SMs (the TPU ran
// its grid serially and used one split per 4096 keys). A split with no live
// key returns after writing (NEG_INF, 0, 0), with no K/V loads. In a live
// split every thread loads 16 bytes (8 dims) of a key row, d/8 threads share
// a key, and each group of d/8 threads keeps its own online (m, l, acc) for
// all G rows over the keys it visits; the loop is unrolled so that every
// thread has 4 K and 4 V loads in flight. The groups' states are merged
// through shared memory at the end. p stays f32 in the PV product, where the
// JAX kernel casts it to the value dtype: rounding p to bf16 widens the gap
// between the bf16 model's cached-decode logits and its full forward
// (ROADMAP.md, section C), and the arithmetic here is on CUDA cores, where
// f32 costs nothing extra.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // finite, as NEG_INF in ops/softmax.py
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kVec = 8;     // bf16 per 16-byte load
constexpr int kUnroll = 4;  // keys per group in flight

__device__ __forceinline__ void unpack8(const uint4& r, float (&f)[kVec]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

template <int D, int G>
__global__ void __launch_bounds__(kThreads)
    flash_decode_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const int* __restrict__ lengths,
                        float* __restrict__ m_out, float* __restrict__ l_out,
                        float* __restrict__ y_out, int hkv, int s, int n_splits,
                        int block_s, float sm_scale) {
  constexpr int kTpk = D / kVec;             // threads per key
  constexpr int kKeysPerWarp = 32 / kTpk;
  constexpr int kGroups = kWarps * kKeysPerWarp;  // keys per block step
  __shared__ float sh_m[kGroups][G];
  __shared__ float sh_l[kGroups][G];
  __shared__ float sh_acc[kGroups][G][D];

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int split = blockIdx.z;
  const int len = min(max(lengths[b], 0), s);  // lengths above S clamp to S
  const int start = split * block_s;
  const int end = min(start + block_s, len);
  const size_t part = ((size_t)b * hkv + kvh) * n_splits + split;
  float* m_p = m_out + part * G;
  float* l_p = l_out + part * G;
  float* y_p = y_out + part * G * D;

  if (start >= end) {  // dead split: no K/V loads
    for (int i = threadIdx.x; i < G * D; i += kThreads) y_p[i] = 0.f;
    if (threadIdx.x < G) {
      m_p[threadIdx.x] = kNegInf;
      l_p[threadIdx.x] = 0.f;
    }
    return;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = warp * kKeysPerWarp + lane / kTpk;
  const int c0 = (lane % kTpk) * kVec;

  // the group's q rows: q heads kvh*G .. kvh*G + G - 1 (contiguous grouping)
  float qv[G][kVec];
  const __nv_bfloat16* q_b = q + ((size_t)b * hkv + kvh) * G * D + c0;
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    unpack8(*reinterpret_cast<const uint4*>(q_b + gi * D), qv[gi]);
  }

  float m[G], l[G], acc[G][kVec];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[gi][i] = 0.f;
  }

  const size_t kv_off = ((size_t)b * hkv + kvh) * s * D + c0;
  const __nv_bfloat16* k_bh = k + kv_off;
  const __nv_bfloat16* v_bh = v + kv_off;

  // `base` and `end` are uniform across the block, so every lane runs every
  // iteration and the shuffles below see full warps
  for (int base = start; base < end; base += kGroups * kUnroll) {
    uint4 kr[kUnroll], vr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int key = base + u * kGroups + grp;
      kr[u] = make_uint4(0u, 0u, 0u, 0u);
      vr[u] = make_uint4(0u, 0u, 0u, 0u);
      if (key < end) {
        kr[u] = *reinterpret_cast<const uint4*>(k_bh + (size_t)key * D);
        vr[u] = *reinterpret_cast<const uint4*>(v_bh + (size_t)key * D);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool live = base + u * kGroups + grp < end;
      float kf[kVec], vf[kVec];
      unpack8(kr[u], kf);
      unpack8(vr[u], vf);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < kVec; ++i) dot = fmaf(qv[gi][i], kf[i], dot);
#pragma unroll
        for (int off = kTpk / 2; off > 0; off >>= 1) {
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        }
        if (live) {
          const float sv = dot * sm_scale;
          const float mn = fmaxf(m[gi], sv);
          const float corr = expf(m[gi] - mn);
          const float p = expf(sv - mn);
          l[gi] = l[gi] * corr + p;
#pragma unroll
          for (int i = 0; i < kVec; ++i) acc[gi][i] = fmaf(p, vf[i], acc[gi][i] * corr);
          m[gi] = mn;
        }
      }
    }
  }

  // merge the groups' states; a group that saw no key holds (NEG_INF, 0, 0)
  // and weighs exp(NEG_INF - mx) == 0, since group 0 saw key `start`
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (lane % kTpk == 0) {
      sh_m[grp][gi] = m[gi];
      sh_l[grp][gi] = l[gi];
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) sh_acc[grp][gi][c0 + i] = acc[gi][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int gi = idx / D;
    const int d = idx % D;
    float mx = kNegInf;
    for (int r = 0; r < kGroups; ++r) mx = fmaxf(mx, sh_m[r][gi]);
    float y = 0.f;
    for (int r = 0; r < kGroups; ++r) y += sh_acc[r][gi][d] * expf(sh_m[r][gi] - mx);
    y_p[idx] = y;
  }
  if (threadIdx.x < G) {
    const int gi = threadIdx.x;
    float mx = kNegInf;
    for (int r = 0; r < kGroups; ++r) mx = fmaxf(mx, sh_m[r][gi]);
    float lt = 0.f;
    for (int r = 0; r < kGroups; ++r) lt += sh_l[r][gi] * expf(sh_m[r][gi] - mx);
    m_p[gi] = mx;
    l_p[gi] = lt;
  }
}

template <int D>
int launch_d(dim3 grid, cudaStream_t st, int g, const __nv_bfloat16* q,
             const __nv_bfloat16* k, const __nv_bfloat16* v, const int* len,
             float* m, float* l, float* y, int hkv, int s, int n_splits,
             int block_s, float sm_scale) {
  switch (g) {
    case 1:
      flash_decode_kernel<D, 1><<<grid, kThreads, 0, st>>>(
          q, k, v, len, m, l, y, hkv, s, n_splits, block_s, sm_scale);
      break;
    case 2:
      flash_decode_kernel<D, 2><<<grid, kThreads, 0, st>>>(
          q, k, v, len, m, l, y, hkv, s, n_splits, block_s, sm_scale);
      break;
    case 4:
      flash_decode_kernel<D, 4><<<grid, kThreads, 0, st>>>(
          q, k, v, len, m, l, y, hkv, s, n_splits, block_s, sm_scale);
      break;
    case 8:
      flash_decode_kernel<D, 8><<<grid, kThreads, 0, st>>>(
          q, k, v, len, m, l, y, hkv, s, n_splits, block_s, sm_scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [b, hq, d], k/v [b, hkv, s, d] bf16 contiguous, lengths [b] int32;
// m, l [b, hkv, n_splits, G] and y [b, hkv, n_splits, G, d] f32, G = hq/hkv
// in {1, 2, 4, 8}, d in {64, 128}. Split i covers keys
// [i*block_s, (i+1)*block_s). Returns cudaGetLastError() after the launch.
extern "C" int fkp_flash_decode(const void* q, const void* k, const void* v,
                                const void* lengths, void* m, void* l, void* y,
                                int b, int hq, int hkv, int s, int d,
                                int n_splits, int block_s, float sm_scale,
                                void* stream) {
  const dim3 grid(b, hkv, n_splits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = hq / hkv;
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* lp = static_cast<const int*>(lengths);
  auto* mp = static_cast<float*>(m);
  auto* lo = static_cast<float*>(l);
  auto* yp = static_cast<float*>(y);
  if (d == 64) {
    return launch_d<64>(grid, st, g, qp, kp, vp, lp, mp, lo, yp, hkv, s,
                        n_splits, block_s, sm_scale);
  }
  if (d == 128) {
    return launch_d<128>(grid, st, g, qp, kp, vp, lp, mp, lo, yp, hkv, s,
                         n_splits, block_s, sm_scale);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
