// The streaming single-token GQA decode for Hopper (sm_90a): one new token
// per sequence against a linear bf16 cache, K and V streamed through a
// hand-written double-buffered copy pipeline.
//
// Replaces flashattention_kernel_project_tpu/ops/streaming.py::
// _streaming_kernel (streaming_decode), the TPU rebuild of the reference's
// cp.async ping-pong and warp-specialisation rungs: K/V stay in device
// memory and are copied tile by tile into a two-slot VMEM ring by explicit
// DMAs, the copy of tile t + 1 in flight while tile t computes, with an
// online (m, l, acc) per query row. Here the pipeline is cp.async into a
// two-stage shared-memory ring (not a producer warp with mbarriers): one
// 128-thread block per (sequence, KV head) streams the sequence's keys
// below its length in 64-key tiles; every thread issues its 16-byte pieces
// of tile t + 1 before waiting for tile t (cp.async.wait_group 1), so one
// tile is always in flight under the products of the other. Keys at or
// past the length are zero-filled, never read, and the loop stops at the
// length. The G = Hq / Hkv query rows of the group are the A operand of
// mma.sync m16n8k16 (rows G..15 zero); each of the 4 warps takes 16 keys of
// a tile, S = Q K^T from ldmatrix fragments of the K tile, then keeps its
// own online (m, l, acc) and multiplies P V from ldmatrix.trans fragments
// of the V tile; the warps' states merge through shared memory at the end
// and the block writes the normalised rows. A length of 0 gives 0.
//
// Precision (the port's policy, ROADMAP.md section C): scores in f32 from
// the bf16 q and k (JAX rounds q * sm_scale to bf16 first), exp2 in f32 in
// the log2 domain, p into the PV product as a bf16 hi + lo pair (about 16
// bits; JAX rounds p to the value type).
//
// What bounds it on the H100: bytes. Each key costs 4 * d bytes of K and V
// and 4 * G * d flops, G flops a byte, far below the ~295 flop/byte ridge;
// at run_all.py's rung (B 256, 8/1 heads, S 4096, d 128) the 537 MB of K/V
// take 0.160 ms at 3.35 TB/s. 256 blocks of 68 KB of shared memory fit at
// once, two or three an SM, each with a 32 KB tile in flight.

#include "mma.cuh"

namespace {

using fkp_mma::cp_async_16;
using fkp_mma::mma_16816;

constexpr float kNegInf = -1e30f;  // finite, as NEG_INF in ops/softmax.py
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;  // keys a tile, 16 a warp

template <int D>
constexpr int kStride = D + 8;  // bf16 a shared-memory row: ldmatrix rows on distinct banks

template <int D>
constexpr int smem_bytes() {
  return 2 * 2 * kTile * kStride<D> * 2;  // {K, V} x two stages, bf16
}

// tile t's K and V rows (keys t * kTile ..) into stage st; keys at or past
// len are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* sk, __nv_bfloat16* sv,
                                          const __nv_bfloat16* k,
                                          const __nv_bfloat16* v, int t, int len) {
  constexpr int kPieces = D / 8;
  for (int i = threadIdx.x; i < kTile * kPieces; i += kThreads) {
    const int r = i / kPieces, c = (i % kPieces) * 8;
    const int key = t * kTile + r;
    const bool live = key < len;
    const size_t off = live ? (size_t)key * D + c : 0;
    cp_async_16(sk + r * kStride<D> + c, k + off, live);
    cp_async_16(sv + r * kStride<D> + c, v + off, live);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    streaming_decode_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const int* __restrict__ lengths,
                            __nv_bfloat16* __restrict__ out, int hkv, int g,
                            int s, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  // stage st's K tile, its V tile right after it (computed, not an array
  // of pointers, which would live in local memory)
  constexpr int kTileElems = kTile * kStride<D>;
  auto k_tile = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(smem) + 2 * st * kTileElems;
  };
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int len = min(max(lengths[b], 0), s);  // lengths above S count as S
  const int n_tiles = (len + kTile - 1) / kTile;
  const size_t bh = (size_t)b * hkv + kvh;
  k += bh * s * D;
  v += bh * s * D;
  const __nv_bfloat16* q_g = q + bh * g * D;  // q heads kvh * g .. + g - 1
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = lane / 4, quad = lane % 4;  // this thread's C row and pair

  // the A fragments of Q (row `row`; rows 8..15 are zero, as are rows >= g)
  uint32_t qa[D / 16][2];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* p = q_g + row * D + kk * 16 + quad * 2;
    qa[kk][0] = row < g ? *reinterpret_cast<const uint32_t*>(p) : 0u;
    qa[kk][1] = row < g ? *reinterpret_cast<const uint32_t*>(p + 8) : 0u;
  }
  float m = kNegInf, l = 0.f;  // row `row` over this warp's keys (l: this thread's)
  float acc[D / 8][4];          // [.][0..1]: row `row`, dims n * 8 + 2 * quad + e
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  if (n_tiles > 0) load_tile<D>(k_tile(0), k_tile(0) + kTileElems, k, v, 0, len);
  fkp_mma::cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {
      load_tile<D>(k_tile(st ^ 1), k_tile(st ^ 1) + kTileElems, k, v, t + 1, len);
    }
    fkp_mma::cp_async_commit();   // an empty group on the last tile
    fkp_mma::cp_async_wait<1>();  // tile t has landed, t + 1 may be in flight
    __syncthreads();

    // S = Q K^T over the warp's keys key0 + j * 8 + 2 * quad + e
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t bk[4];
      fkp_mma::load_b_nk(bk, k_tile(st), kStride<D>, warp * 16, kk * 16, lane);
      const uint32_t a[4] = {qa[kk][0], 0u, qa[kk][1], 0u};
      mma_16816(sc[0], a, bk[0], bk[1]);
      mma_16816(sc[1], a, bk[2], bk[3]);
    }
    const int key0 = t * kTile + warp * 16 + quad * 2;
    float z[2][2], mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        z[j][e] = key0 + j * 8 + e < len ? sc[j][e] * scale_log2 : kNegInf;
        mx = fmaxf(mx, z[j][e]);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float corr = exp2f(m - m_new);
    float p[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // a dead key adds nothing, even while m_new is kNegInf
        p[j][e] = key0 + j * 8 + e < len ? exp2f(z[j][e] - m_new) : 0.f;
      }
    }
    l = l * corr + (p[0][0] + p[0][1]) + (p[1][0] + p[1][1]);
    m = m_new;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= corr;
      acc[n][1] *= corr;
    }
    // P (row `row`, the warp's 16 keys) as the A operand, a bf16 hi + lo pair
    uint32_t hi[4] = {0u, 0u, 0u, 0u}, lo[4] = {0u, 0u, 0u, 0u};
    fkp_mma::split_bf16(p[0][0], p[0][1], hi[0], lo[0]);
    fkp_mma::split_bf16(p[1][0], p[1][1], hi[2], lo[2]);
#pragma unroll
    for (int nn = 0; nn < D / 16; ++nn) {
      uint32_t bv[4];
      fkp_mma::load_b_kn(bv, k_tile(st) + kTileElems, kStride<D>, warp * 16, nn * 16, lane);
      mma_16816(acc[2 * nn], hi, bv[0], bv[1]);
      mma_16816(acc[2 * nn], lo, bv[0], bv[1]);
      mma_16816(acc[2 * nn + 1], hi, bv[2], bv[3]);
      mma_16816(acc[2 * nn + 1], lo, bv[2], bv[3]);
    }
    __syncthreads();  // stage st is refilled at t + 1
  }

  // merge the warps' states through shared memory (free after the loop); a
  // warp that saw no live key holds (kNegInf, 0, 0) and weighs 0
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  float* sm_m = reinterpret_cast<float*>(smem);  // [kWarps][8]
  float* sm_l = sm_m + kWarps * 8;               // [kWarps][8]
  float* sm_acc = sm_l + kWarps * 8;             // [kWarps][8][D]
  if (row < g) {
    if (quad == 0) {
      sm_m[warp * 8 + row] = m;
      sm_l[warp * 8 + row] = l;
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      float* dst = sm_acc + (warp * 8 + row) * D + n * 8 + quad * 2;
      dst[0] = acc[n][0];
      dst[1] = acc[n][1];
    }
  }
  __syncthreads();
  __nv_bfloat16* out_g = out + bh * g * D;
  for (int i = threadIdx.x; i < g * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * 8 + r]);
    float lt = 0.f, y = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = exp2f(sm_m[w * 8 + r] - mx);
      lt += sm_l[w * 8 + r] * c;
      y += sm_acc[(w * 8 + r) * D + d] * c;
    }
    out_g[i] = __float2bfloat16(y / (lt == 0.f ? 1.f : lt));
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, int b, int hkv, int g, int s, float scale_log2,
           cudaStream_t st) {
  constexpr int kSmem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      streaming_decode_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  streaming_decode_kernel<D><<<dim3(b, hkv), kThreads, kSmem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), hkv, g, s, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [b, hq, d], k/v [b, hkv, s, d] bf16 contiguous, lengths [b] int32 (keys
// [0, min(lengths, s)) attended); out [b, hq, d] bf16. g = hq / hkv <= 8, d
// in {64, 128}; scale_log2 = sm_scale * log2(e). Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for another d or g).
extern "C" int fkp_streaming_decode(const void* q, const void* k, const void* v,
                                    const void* lengths, void* out, int b, int hq,
                                    int hkv, int s, int d, float scale_log2,
                                    void* stream) {
  const int g = hq / hkv;
  if (g < 1 || g > 8 || g * hkv != hq) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch<64>(q, k, v, lengths, out, b, hkv, g, s, scale_log2, st);
  if (d == 128) return launch<128>(q, k, v, lengths, out, b, hkv, g, s, scale_log2, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
