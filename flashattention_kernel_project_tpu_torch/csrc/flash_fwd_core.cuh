// The tiled attention forward shared by flash_fwd.cu (the dense forward, O
// and LSE) and flash_fwd_ragged.cu (per-row KV lengths and query offsets,
// O only). One template, `flash_fwd_kernel<D, kRagged>`; each source file
// instantiates its own flavour.
//
// Softmax in the log2 domain (scores times sm_scale * log2(e)), the online
// (m, l, acc) rescale with exp2, causal and tail masks, GQA with q head h
// reading KV head h / (Hq / Hkv). Query i of batch row b sees key j iff
// j < kv_len(b) and, when causal, j <= i + q_off(b); the dense flavour has
// kv_len = S and one static q_offset, the ragged flavour reads both per row
// from device memory and keeps S as the K/V row stride only.
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
// are scheduled first. The ragged flavour skips the mask on tiles that lie
// wholly inside every row's bound, as the TPU kernel does. Left for later:
// wgmma, TMA loads and warp specialisation (the FlashAttention-3 structure),
// and double-buffered K/V tiles.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fkp_fwd {

constexpr float kNegInf = -1e30f;  // finite, as NEG_INF in ops/softmax.py
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kBlockM = 64;  // query rows per block (16 per warp)
constexpr int kBlockN = 64;  // keys per shared-memory tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 inputs, f32 accumulate.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// q[row, col:col+2] as a bf16 pair (zero past the last row).
template <int D>
__device__ __forceinline__ uint32_t load_q_pair(const __nv_bfloat16* q_bh,
                                                int row, int col, int n) {
  if (row >= n) return 0u;
  return *reinterpret_cast<const uint32_t*>(q_bh + (size_t)row * D + col);
}

// p as a bf16 pair hi + lo with hi = bf16(p), lo = bf16(p - hi): about 16
// significant bits, where bf16 alone keeps 8.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

// q [b, hq, n, D], k/v [b, hkv, s, D], o [b, hq, n, D] bf16; lse [b, hq, n]
// f32 (dense flavour only). Dense: every row sees keys [0, s) and the static
// q_offset. Ragged: row b sees keys [0, min(kv_lens[b], s)) and the offset
// q_offsets[b].
// Launch bounds with a minimum of one block per SM: with the thread count
// alone, ptxas held the d=64 instances at 128 registers and spilled.
template <int D, bool kRagged>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int hq, int hkv, int n, int s, float scale_log2,
                     int causal, int q_offset, const int* __restrict__ kv_lens,
                     const int* __restrict__ q_offsets) {
  constexpr int kStride = D + 8;  // padded shared-memory row, in bf16
  __shared__ __align__(16) __nv_bfloat16 k_s[kBlockN * kStride];
  __shared__ __align__(16) __nv_bfloat16 v_s[kBlockN * kStride];
  const unsigned short* v_u16 = reinterpret_cast<const unsigned short*>(v_s);

  const int m_block = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hkv);  // contiguous GQA grouping
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row (and row + 8)
  const int t = lane % 4;  // fragment column pair

  // the row's bounds: keys [0, kv_len), query i at position i + q_off
  const int kv_len = kRagged ? min(max(kv_lens[b], 0), s) : s;
  const int q_off = kRagged ? q_offsets[b] : q_offset;

  const size_t bh = (size_t)b * hq + h;
  const __nv_bfloat16* q_bh = q + bh * n * D;
  const __nv_bfloat16* k_bh = k + ((size_t)b * hkv + kvh) * s * D;
  const __nv_bfloat16* v_bh = v + ((size_t)b * hkv + kvh) * s * D;

  const int row0 = m_block * kBlockM + warp * 16 + g;
  const int row1 = row0 + 8;

  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = load_q_pair<D>(q_bh, row0, c, n);
    qf[kk][1] = load_q_pair<D>(q_bh, row1, c, n);
    qf[kk][2] = load_q_pair<D>(q_bh, row0, c + 8, n);
    qf[kk][3] = load_q_pair<D>(q_bh, row1, c + 8, n);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  }
  float m0 = kNegInf, m1 = kNegInf;  // running max, log2 domain
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums

  int n_tiles = (kv_len + kBlockN - 1) / kBlockN;
  if (causal) {
    const int last_key = m_block * kBlockM + kBlockM - 1 + q_off;
    n_tiles = last_key < 0 ? 0 : min(n_tiles, last_key / kBlockN + 1);
  }
  // the first query of the tile, whose causal bound is the tightest
  const int first_pos = m_block * kBlockM + q_off;

  for (int j = 0; j < n_tiles; ++j) {
    const int key0 = j * kBlockN;
    // a tile wholly inside every row's bound needs no mask (uniform across
    // the block)
    const bool full = kRagged && key0 + kBlockN <= kv_len &&
                      (!causal || key0 + kBlockN - 1 <= first_pos);
    __syncthreads();  // every warp is done with the previous tile
    constexpr int kVecPerRow = D / 8;
    for (int i = threadIdx.x; i < kBlockN * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow;
      const int c = (i % kVecPerRow) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (key0 + r < kv_len) {
        kv = *reinterpret_cast<const uint4*>(k_bh + (size_t)(key0 + r) * D + c);
        vv = *reinterpret_cast<const uint4*>(v_bh + (size_t)(key0 + r) * D + c);
      }
      *reinterpret_cast<uint4*>(k_s + r * kStride + c) = kv;
      *reinterpret_cast<uint4*>(v_s + r * kStride + c) = vv;
    }
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp, as 8 n-tiles of 8 keys
    float sc[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kp = k_s + (nt * 8 + g) * kStride + kk * 16 + 2 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kp);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kp + 8);
        mma_16816(sc[nt], qf[kk], b0, b1);
      }
    }

    // masks: element e of n-tile nt is (row0 if e < 2 else row1,
    // key0 + nt*8 + 2t + (e & 1))
    float tmax0 = kNegInf, tmax1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = key0 + nt * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row0 : row1;
        const bool ok = full || (col < kv_len && (!causal || col <= row + q_off));
        sc[nt][e] = ok ? sc[nt][e] * scale_log2 : kNegInf;
        if (e < 2) {
          tmax0 = fmaxf(tmax0, sc[nt][e]);
        } else {
          tmax1 = fmaxf(tmax1, sc[nt][e]);
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
    l0 *= r0;
    l1 *= r1;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      acc[nd][0] *= r0;
      acc[nd][1] *= r0;
      acc[nd][2] *= r1;
      acc[nd][3] *= r1;
    }

    // p = exp2(s - m), zeroed where masked: with the finite NEG_INF, a row
    // that has seen no key yet has m == NEG_INF and exp2(s - m) == 1 there.
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
          const int col = key0 + nt * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? row0 : row1;
          const bool ok = full || (col < kv_len && (!causal || col <= row + q_off));
          p[e] = ok ? exp2f(sc[nt][e] - (e < 2 ? m0 : m1)) : 0.f;
        }
        l0 += p[0] + p[1];
        l1 += p[2] + p[3];
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
  if (!kRagged && t == 0) {
    float* lse_bh = lse + bh * n;
    if (row0 < n) lse_bh[row0] = l0 == 0.f ? kNegInf : m0 * kLn2 + logf(l0);
    if (row1 < n) lse_bh[row1] = l1 == 0.f ? kNegInf : m1 * kLn2 + logf(l1);
  }
}

}  // namespace fkp_fwd
