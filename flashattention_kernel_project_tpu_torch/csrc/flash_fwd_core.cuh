// The mma.sync attention forward of flash_fwd_q.cu: the dense forward, O
// and LSE, over an 8-bit cache (ROADMAP A.14.12b: the next to move onto
// the Hopper kernel). Its other flavours are Hopper kernels now: the dense
// bf16 forward (flash_fwd.cu) and the ragged forward's wgmma route
// (flash_fwd_ragged.cu) flash_fwd_sm90.cuh's, the paged extend and the
// ragged forward's slab route paged_extend_sm90.cuh's; they take this
// header's disciplines, guard and helpers and compute the same function.
// One block body, `fwd_block<D, kWindow, kDisc, KV>`, behind the kernel
// `flash_fwd_q_kernel<D, KV, kWindow, kDisc>` (KV = int8_t or
// __nv_fp8_e4m3).
//
// Softmax in the log2 domain (scores times sm_scale * log2(e)), the online
// (m, l, acc) rescale with exp2, causal and tail masks, GQA with q head h
// reading KV head h / (Hq / Hkv). Query row i of batch row b sees key j iff
// j < kv_len(b) and, when causal, j <= pos(i), the row's position, and,
// with a sliding window (window > 0, causal only), j > pos(i) - window or
// j < sinks (the band of the last `window` positions and the first `sinks`
// keys, the StreamingLLM attention sinks), with kv_len = S and pos(i) = i +
// one static q_offset.
//
// Precision differs from the TPU kernels in two places, both toward f32.
// The scale multiplies the f32 scores instead of a bf16-rounded q, and p
// enters the PV product as a bf16 hi + lo pair (about 16 bits, two MMAs)
// instead of one bf16 value. Rounding p to bf16 in either this or the decode
// kernel widens the gap between the bf16 model's cached-decode logits and
// its full forward (ROADMAP.md, section C).
//
// What bounds it on the H100: at prefill shapes (N = S in the hundreds to
// thousands, d = 128) the two products do 4*N*S*d flops against about
// 2*(N + 2*S)*d bytes of device memory, far above the card's ~295 flop/byte
// ridge, so tensor-core issue and the softmax arithmetic between the two
// products bound it, not HBM.
//
// Design: one block of 4 warps per (64-query tile, q head, batch row). Each
// warp owns 16 query rows and keeps its Q fragments, running (m, l) and the
// O accumulator in registers for the whole key loop, so scores and
// probabilities never touch shared or device memory. 64-key K/V tiles are
// staged in shared memory (rows padded by 8 bf16 so fragment reads are free
// of bank conflicts) and shared by the 4 warps. Both products are
// mma.sync m16n8k16 bf16 -> f32; the score accumulator's register layout is
// the A-operand layout of the PV product, so p is repacked in registers.
// Key tiles past the row's bound (kv_len, and the causal diagonal of the
// tile's last query) are never loaded, and the heaviest causal query tiles
// are scheduled first. With a window, the key loop visits the sink tiles
// [0, ceil(sinks / 64)) and then the tiles from the band's first key for
// the q tile's first row to the diagonal, each once (a sink tile that the
// band reaches is a band tile): the tiles in the gap are never loaded, so a
// window of W keys costs O(N * W), as the TPU kernel's windowed grid does.
// The window is a template switch (kWindow), so the causal instances
// compile as they did before it existed: as a runtime term it cost the
// causal dense forward about a tenth of its time at 4096 keys on the H100.
//
// The softmax discipline is a third template switch (kDisc), as the TPU
// kernel's `stable` is a static argument:
// - kOnline (stable=True): the running max m with the rescale of l and acc
//   at every tile.
// - kFixed (stable=False, the fixed-max discipline): m stays 0 for the
//   row's whole life, so the tile max, its four shuffles and the rescale
//   are gone; p = exp2(s), a masked lane's exp2(NEG_INF) is exactly 0, LSE
//   = ln(l), and a row with no key still gives O = 0 and LSE = NEG_INF. It
//   holds while every |s| (log2 domain) stays below 78 (_SAFE_BOUND of the
//   TPU kernel): p then lies in [2^-78, 2^78], l and acc in f32 far from
//   overflow, and the bf16 hi + lo split keeps its 16 bits, since bf16 has
//   f32's exponent range. Outside it p overflows to inf and the output
//   turns non-finite: the failure is loud, never a silent drift.
// - kHybrid (stable="auto", dense only): each warp picks the discipline of
//   its own 16 rows. It holds their Q fragments in registers, so it takes
//   max_r ||q_r||^2 over them with seven shuffles, once, before the key
//   loop, and runs fixed-max iff max_r ||q_r|| * |scale| * log2(e) *
//   k_max < 78 (Cauchy-Schwarz bounds every score of those rows), online
//   otherwise; a NaN or inf bound runs online. k_max = max_t ||k_t|| is a
//   device f32 scalar read by pointer: the host never reads it. The TPU
//   kernel takes the q half of the bound outside the kernel, per 512- or
//   1024-row block, because a cross-lane reduce is dear there. The tile's
//   products and softmax are compiled in both disciplines and each warp
//   runs its own: a runtime branch around the max and the rescale alone
//   left a fixed-max warp paying for the tile max and the masked select,
//   at the online kernel's speed. A warp whose bound breaches runs exactly
//   the online code, so on such inputs "auto" equals the online kernel.
// The switch is compile-time for the reason kWindow is: a runtime term in
// the key loop costs the causal online forward.
//
// 8-bit caches (one f32 scale per key and head for K and one for V): each
// thread loads its 16-byte pieces of the tile's 8-bit K and V rows into
// registers, all at once, and widens them exactly to bf16 in the shared
// tiles, so the tensor-core operands are the cache's own values; the tile's
// scales go to shared memory beside them. The K scale multiplies the f32
// score column before the mask and the max; the V scale folds into the p
// column (after l has summed it) before the bf16 hi + lo split. Half the
// K/V bytes of bf16 cross device memory. The 8-bit tile does not go through
// cp.async: a staging copy of it beside the bf16 tiles (16 KB more at
// d = 128) would pass the 48 KB of static shared memory a block may hold.
// The dense flavour over an 8-bit cache (flash_fwd_q.cu) writes its LSE
// from registers, as the bf16 one does: no shared memory is added.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"
#include "widen.cuh"

namespace fkp_fwd {

using fkp_mma::mma_16816;
using fkp_mma::pack_bf16;
using fkp_mma::split_bf16;

constexpr float kNegInf = -1e30f;  // finite, as NEG_INF in ops/softmax.py
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kBlockM = 64;  // query rows per block (16 per warp)
constexpr int kBlockN = 64;  // keys per shared-memory tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// the softmax discipline: stable=True, stable=False, stable="auto"
enum Disc : int { kOnline = 0, kFixed = 1, kHybrid = 2 };
// the log2-domain score bound under which fixed-max is sound (_SAFE_BOUND)
constexpr float kSafeBound = 78.f;

// q[row, col:col+2] as a bf16 pair (zero past the last row).
template <int D>
__device__ __forceinline__ uint32_t load_q_pair(const __nv_bfloat16* q_bh,
                                                int row, int col, int n) {
  if (row >= n) return 0u;
  return *reinterpret_cast<const uint32_t*>(q_bh + (size_t)row * D + col);
}

// What an 8-bit flavour adds (null for bf16): the scale buffers [b, hkv,
// s, 1].
struct QuantArgs {
  const float* k_scale;
  const float* v_scale;
};

// The fixed-max range guard's outputs (the dense fixed-max instances; null
// when off). count: an int32 to which the breaching rows are added. pairs
// (the packed d=64 call; null: each head's row counts): one bit per (b, KV
// head pair, group member, row), zeroed by the caller, so that a row counts
// once when either head of a KV pair breaches there, as the TPU's paired
// kernel counts it.
struct GuardArgs {
  int* count;
  unsigned* pairs;
};

// Sets the pairs bit of head h's row (its KV pair's, group member's) and
// says whether it was clear: the first of the pair's two heads to breach
// there counts the row. Not inlined: inline, the index and the atomic
// slowed the packed d=64 kernel's key loop by a tenth (ptxas reallocated
// it), though they run only for a breaching row.
static __device__ __noinline__ bool first_of_pair(unsigned* pairs, int b,
                                                  int h, int hq, int hkv,
                                                  int n, int row) {
  const int group = hq / hkv;
  const size_t pair = (size_t)b * (hkv / 2) + h / group / 2;
  const size_t i = (pair * group + h % group) * n + row;
  const unsigned bit = 1u << (i % 32);
  return (atomicOr(pairs + i / 32, bit) & bit) == 0u;
}

// 16 8-bit cache values (one 16-byte load) widened exactly to 16 bf16 at
// dst (16-byte aligned)
template <class KV>
__device__ __forceinline__ void widen16_bf16(const uint4& r, __nv_bfloat16* dst) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&r);
  uint32_t out[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float f[4];
    fkp::Widen<KV>::word(w[i], f);
    out[2 * i] = pack_bf16(f[0], f[1]);
    out[2 * i + 1] = pack_bf16(f[2], f[3]);
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(out[0], out[1], out[2], out[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(out[4], out[5], out[6], out[7]);
}

// a compile-time bool as a type, to pick a generic lambda's instance
template <bool B>
struct Bool {
  static constexpr bool value = B;
};

// the sum of squares of a bf16 pair
__device__ __forceinline__ float sq_bf16x2(uint32_t w) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  return f.x * f.x + f.y * f.y;
}

// q [b, hq, n, D], o [b, hq, n, D] bf16; lse [b, hq, n] f32; k/v [b, hkv,
// s, D], every row sees keys [0, s) and the static q_offset.
// KV: the cache's element type (int8_t or __nv_fp8_e4m3, with qa's
// scales). kDisc: the discipline;
// k_max (kHybrid only): the device scalar max_t ||k_t|| of the keys as
// they enter the scores (dequantized for 8 bits). gd (dense fixed-max
// only; null when off): the range guard's count of breaching rows, added to
// after the key loop (see the epilogue); the other instances compile no
// guard.
template <int D, bool kWindow, int kDisc, class KV>
__device__ __forceinline__ void fwd_block(
    const __nv_bfloat16* __restrict__ q, const KV* __restrict__ k,
    const KV* __restrict__ v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int hq, int hkv, int n, int s, float scale_log2,
    int causal, int q_offset, int window, int sinks,
    QuantArgs qa, const float* __restrict__ k_max,
    GuardArgs gd) {
  static_assert(sizeof(KV) == 1, "the mma.sync core serves 8-bit caches");
  constexpr int kStride = D + 8;  // padded shared-memory row, in bf16
  __shared__ __align__(16) __nv_bfloat16 k_s[kBlockN * kStride];
  __shared__ __align__(16) __nv_bfloat16 v_s[kBlockN * kStride];
  // the tile's K and V scales
  __shared__ float kvs_s[2][kBlockN];
  const unsigned short* v_u16 = reinterpret_cast<const unsigned short*>(v_s);

  const int m_block = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hkv);  // contiguous GQA grouping
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row (and row + 8)
  const int t = lane % 4;  // fragment column pair

  // keys [0, kv_len), query i at position pos(i)
  const int kv_len = s;
  const int q_off = q_offset;

  const size_t bh = (size_t)b * hq + h;
  const __nv_bfloat16* q_bh = q + bh * n * D;
  // the head's first K/V row and scale
  const size_t kv_head = ((size_t)b * hkv + kvh) * s * D;
  const KV* k_bh = k + kv_head;
  const KV* v_bh = v + kv_head;
  const size_t scale_head = ((size_t)b * hkv + kvh) * s;

  const int row0 = m_block * kBlockM + warp * 16 + g;
  const int row1 = row0 + 8;
  const int pos0 = row0 + q_off;
  const int pos1 = row1 + q_off;
  // the band: key j is in row i's band iff j > band(i) or j < sinks
  const int band0 = pos0 - window;
  const int band1 = pos1 - window;

  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = load_q_pair<D>(q_bh, row0, c, n);
    qf[kk][1] = load_q_pair<D>(q_bh, row1, c, n);
    qf[kk][2] = load_q_pair<D>(q_bh, row0, c + 8, n);
    qf[kk][3] = load_q_pair<D>(q_bh, row1, c + 8, n);
  }

  // this warp's discipline (uniform in the warp): fixed-max keeps m at 0
  bool fixed = kDisc == kFixed;
  if constexpr (kDisc == kHybrid) {
    // ||q_r||^2 of rows row0 and row1: this thread's columns, then the
    // row's four threads; then the max over the warp's 16 rows
    float n0 = 0.f, n1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      n0 += sq_bf16x2(qf[kk][0]) + sq_bf16x2(qf[kk][2]);
      n1 += sq_bf16x2(qf[kk][1]) + sq_bf16x2(qf[kk][3]);
    }
    n0 += __shfl_xor_sync(0xffffffffu, n0, 1);
    n0 += __shfl_xor_sync(0xffffffffu, n0, 2);
    n1 += __shfl_xor_sync(0xffffffffu, n1, 1);
    n1 += __shfl_xor_sync(0xffffffffu, n1, 2);
    float nmax = fmaxf(n0, n1);
    nmax = fmaxf(nmax, __shfl_xor_sync(0xffffffffu, nmax, 4));
    nmax = fmaxf(nmax, __shfl_xor_sync(0xffffffffu, nmax, 8));
    nmax = fmaxf(nmax, __shfl_xor_sync(0xffffffffu, nmax, 16));
    const float bound = sqrtf(nmax) * fabsf(scale_log2) * __ldg(k_max);
    fixed = bound < kSafeBound;  // false for a NaN or inf bound
  }

  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  }
  // running max, log2 domain (fixed-max: 0 for the row's whole life)
  float m0 = fixed ? 0.f : kNegInf, m1 = m0;
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums

  int n_tiles = (kv_len + kBlockN - 1) / kBlockN;
  if (causal) {
    // the tile's last position
    const int last_key = m_block * kBlockM + kBlockM - 1 + q_off;
    n_tiles = last_key < 0 ? 0 : min(n_tiles, last_key / kBlockN + 1);
  }
  // the tile's first position, the tightest causal bound
  const int first_pos = m_block * kBlockM + q_off;
  // sliding window: the sink tiles below the band, then the band's tiles
  // from the one holding the first row's first band key
  int band_tile = 0, n_sink_tiles = 0;
  if constexpr (kWindow) {
    band_tile = min(max(first_pos - (window - 1), 0) / kBlockN, n_tiles);
    n_sink_tiles = min((sinks + kBlockN - 1) / kBlockN, band_tile);
  }
  const int n_visit = n_sink_tiles + n_tiles - band_tile;

  for (int it = 0; it < n_visit; ++it) {
    const int j = it < n_sink_tiles ? it : band_tile + it - n_sink_tiles;
    const int key0 = j * kBlockN;
    __syncthreads();  // every warp is done with the previous tile
    {
      // the 8-bit tile: every thread's 16-byte pieces (16 dims) of the K
      // and V rows go to registers, all loads out at once; then they widen
      // into the bf16 tiles. Rows past kv_len are zero, their scales too.
      constexpr int kPerRow = D / 16;
      constexpr int kPieces = kBlockN * kPerRow / kThreads;
      uint4 kc[kPieces], vc[kPieces];
#pragma unroll
      for (int u = 0; u < kPieces; ++u) {
        const int i = threadIdx.x + u * kThreads;
        const int key = key0 + i / kPerRow;
        const int c = (i % kPerRow) * 16;
        kc[u] = make_uint4(0u, 0u, 0u, 0u);
        vc[u] = make_uint4(0u, 0u, 0u, 0u);
        if (key < kv_len) {
          const size_t off = (size_t)key * D + c;
          kc[u] = *reinterpret_cast<const uint4*>(k_bh + off);
          vc[u] = *reinterpret_cast<const uint4*>(v_bh + off);
        }
      }
      if (threadIdx.x < kBlockN) {
        const int key = key0 + threadIdx.x;
        float ks = 0.f, vs = 0.f;
        if (key < kv_len) {
          const size_t so = scale_head + (size_t)key;
          ks = qa.k_scale[so];
          vs = qa.v_scale[so];
        }
        kvs_s[0][threadIdx.x] = ks;
        kvs_s[1][threadIdx.x] = vs;
      }
#pragma unroll
      for (int u = 0; u < kPieces; ++u) {
        const int i = threadIdx.x + u * kThreads;
        const int r = i / kPerRow;
        const int c = (i % kPerRow) * 16;
        widen16_bf16<KV>(kc[u], k_s + r * kStride + c);
        widen16_bf16<KV>(vc[u], v_s + r * kStride + c);
      }
    }
    __syncthreads();

    // the tile's two products and softmax in one discipline (kF:
    // fixed-max); the hybrid compiles both and each warp runs its own
    auto tile = [&](auto fixed_max) {
      constexpr bool kF = decltype(fixed_max)::value;
      // S = Q K^T: 16 rows x 64 keys per warp, as 8 n-tiles of 8 keys
      float sc[kBlockN / 8][4];
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
        sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const __nv_bfloat16* kp =
              k_s + (nt * 8 + g) * kStride + kk * 16 + 2 * t;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kp);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kp + 8);
          mma_16816(sc[nt], qf[kk], b0, b1);
        }
      }

      // masks: element e of n-tile nt is (row0 if e < 2 else row1,
      // key0 + nt*8 + 2t + (e & 1))
      [[maybe_unused]] float tmax0 = kNegInf, tmax1 = kNegInf;  // online
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = key0 + nt * 8 + 2 * t + (e & 1);
          const int pos = e < 2 ? pos0 : pos1;
          const int band = e < 2 ? band0 : band1;
          const bool ok = col < kv_len && (!causal || (col <= pos &&
                          (!kWindow || col > band || col < sinks)));
          // the key's K scale on its f32 score before the mask and max
          const float sl = scale_log2 * kvs_s[0][col - key0];
          sc[nt][e] = ok ? sc[nt][e] * sl : kNegInf;
          if constexpr (!kF) {
            if (e < 2) {
              tmax0 = fmaxf(tmax0, sc[nt][e]);
            } else {
              tmax1 = fmaxf(tmax1, sc[nt][e]);
            }
          }
        }
      }
      if constexpr (!kF) {  // the online rescale (fixed-max: none)
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
        l0 *= r0;
        l1 *= r1;
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
          acc[nd][0] *= r0;
          acc[nd][1] *= r0;
          acc[nd][2] *= r1;
          acc[nd][3] *= r1;
        }
      }

      // p = exp2(s - m), zeroed where masked: with the finite NEG_INF, a row
      // that has seen no key yet has m == NEG_INF and exp2(s - m) == 1 there
      // (fixed-max: m == 0 and a masked lane's exp2(NEG_INF) is exactly 0).
      // l sums p in f32; p enters the PV product as a bf16 hi + lo pair.
      uint32_t p_hi[kBlockN / 16][4], p_lo[kBlockN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int nt = 2 * kk + half;
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if constexpr (kF) {
              p[e] = exp2f(sc[nt][e]);
            } else {
              const int col = key0 + nt * 8 + 2 * t + (e & 1);
              const int pos = e < 2 ? pos0 : pos1;
              const int band = e < 2 ? band0 : band1;
              const bool ok = col < kv_len && (!causal || (col <= pos &&
                              (!kWindow || col > band || col < sinks)));
              p[e] = ok ? exp2f(sc[nt][e] - (e < 2 ? m0 : m1)) : 0.f;
            }
          }
          l0 += p[0] + p[1];
          l1 += p[2] + p[3];
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // the V scale folds into p after l
            p[e] *= kvs_s[1][nt * 8 + 2 * t + (e & 1)];
          }
          split_bf16(p[0], p[1], p_hi[kk][2 * half], p_lo[kk][2 * half]);
          split_bf16(p[2], p[3], p_hi[kk][2 * half + 1], p_lo[kk][2 * half + 1]);
        }
      }

      // acc += P V: B operand element (k, n) is V[key k][dim n]
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        const unsigned short* vp = v_u16 + (kk * 16 + 2 * t) * kStride + g;
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
          const unsigned short* vq = vp + nd * 8;
          const uint32_t b0 = (uint32_t)vq[0] | ((uint32_t)vq[kStride] << 16);
          const uint32_t b1 =
              (uint32_t)vq[8 * kStride] | ((uint32_t)vq[9 * kStride] << 16);
          mma_16816(acc[nd], p_hi[kk], b0, b1);
          mma_16816(acc[nd], p_lo[kk], b0, b1);
        }
      }
    };
    if constexpr (kDisc == kHybrid) {
      if (fixed) {
        tile(Bool<true>{});
      } else {
        tile(Bool<false>{});
      }
    } else {
      tile(Bool<kDisc == kFixed>{});
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  // a row with no visible key has l == 0 and acc == 0: output 0, LSE NEG_INF
  const float safe0 = l0 == 0.f ? 1.f : l0;
  const float safe1 = l1 == 0.f ? 1.f : l1;
  __nv_bfloat16* o_bh = o + bh * n * D;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (row0 < n) {
      *reinterpret_cast<__nv_bfloat162*>(o_bh + (size_t)row0 * D + c) =
          __floats2bfloat162_rn(acc[nd][0] / safe0, acc[nd][1] / safe0);
    }
    if (row1 < n) {
      *reinterpret_cast<__nv_bfloat162*>(o_bh + (size_t)row1 * D + c) =
          __floats2bfloat162_rn(acc[nd][2] / safe1, acc[nd][3] / safe1);
    }
  }
  if (t == 0) {
    float* lse_bh = lse + bh * n;
    if (row0 < n) lse_bh[row0] = l0 == 0.f ? kNegInf : m0 * kLn2 + logf(l0);
    if (row1 < n) lse_bh[row1] = l1 == 0.f ? kNegInf : m1 * kLn2 + logf(l1);
  }
  if constexpr (kDisc == kFixed) {
    if (gd.count != nullptr) {
      // The fixed-max range guard (the TPU kernel's guard=True): with m
      // pinned at 0, l itself witnesses the range, so a row breaches when l
      // is not finite or leaves [2^-100, 2^120], or an element of its acc is
      // not finite. Only real rows count: row < n, and, when causal, a
      // position >= 0 (a row before the first key has l == 0 by right). The
      // row's acc lies with its 4 threads t; each warp adds its count once.
      // O and LSE above are what they are without the guard.
      int nf0 = 0, nf1 = 0;  // a non-finite acc element of row0, of row1
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        nf0 |= !isfinite(acc[nd][0]) || !isfinite(acc[nd][1]);
        nf1 |= !isfinite(acc[nd][2]) || !isfinite(acc[nd][3]);
      }
      nf0 |= __shfl_xor_sync(0xffffffffu, nf0, 1);
      nf0 |= __shfl_xor_sync(0xffffffffu, nf0, 2);
      nf1 |= __shfl_xor_sync(0xffffffffu, nf1, 1);
      nf1 |= __shfl_xor_sync(0xffffffffu, nf1, 2);
      // a breaching row counts unless it is paired and the other head of
      // its KV pair set the pair's bit first
      const auto counts = [&](int row, int pos, float l, int nf) {
        if (t != 0 || row >= n || (causal && pos < 0)) return false;
        if (!nf && isfinite(l) && l <= 0x1p120f && l >= 0x1p-100f) {
          return false;
        }
        return gd.pairs == nullptr ||
               first_of_pair(gd.pairs, b, h, hq, hkv, n, row);
      };
      const int cnt =
          __popc(__ballot_sync(0xffffffffu, counts(row0, pos0, l0, nf0))) +
          __popc(__ballot_sync(0xffffffffu, counts(row1, pos1, l1, nf1)));
      if (lane == 0 && cnt > 0) atomicAdd(gd.count, cnt);
    }
  }
}

// The kernel (KV = int8_t or __nv_fp8_e4m3). Launch bounds with a minimum
// of one block per SM: with the thread count alone, ptxas held the d=64
// instances at 128 registers and spilled. k_max: the hybrid discipline's
// device scalar (null otherwise); gd: the range guard's outputs (null:
// off).
template <int D, class KV, bool kWindow = false, int kDisc = kOnline>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_q_kernel(const __nv_bfloat16* __restrict__ q,
                       const KV* __restrict__ k, const KV* __restrict__ v,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                       int hq, int hkv, int n, int s, float scale_log2,
                       int causal, int q_offset, int window, int sinks,
                       QuantArgs qa, const float* __restrict__ k_max,
                       GuardArgs gd) {
  fwd_block<D, kWindow, kDisc>(q, k, v, o, lse, hq, hkv, n, s, scale_log2,
                               causal, q_offset, window, sinks, qa, k_max, gd);
}

// The instance the entry launches for its head dim d, band (window > 0)
// and discipline. `pick(D, W, Disc)` names the instance from three
// std::integral_constants, e.g.
//   [](auto D, auto W, auto C) {
//     return &flash_fwd_q_kernel<decltype(D)::value, KV,
//                                decltype(W)::value, decltype(C)::value>; }
// Returns nullptr for d not in {64, 128} or another discipline, which the
// entry turns into cudaErrorInvalidValue.
template <class Pick>
auto pick_instance(int d, bool window, int disc, Pick pick) {
  using Ptr = decltype(pick(std::integral_constant<int, 64>{},
                            std::false_type{},
                            std::integral_constant<int, kOnline>{}));
  auto by_disc = [&](auto D, auto W) -> Ptr {
    if (disc == kOnline) return pick(D, W, std::integral_constant<int, kOnline>{});
    if (disc == kFixed) return pick(D, W, std::integral_constant<int, kFixed>{});
    if (disc == kHybrid) return pick(D, W, std::integral_constant<int, kHybrid>{});
    return nullptr;
  };
  auto by_band = [&](auto D) -> Ptr {
    return window ? by_disc(D, std::true_type{}) : by_disc(D, std::false_type{});
  };
  if (d == 64) return by_band(std::integral_constant<int, 64>{});
  if (d == 128) return by_band(std::integral_constant<int, 128>{});
  return Ptr{};
}

}  // namespace fkp_fwd
