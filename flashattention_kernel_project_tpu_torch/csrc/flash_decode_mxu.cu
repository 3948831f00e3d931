// Split-KV single-token GQA decode over an int8 cache with both products
// int8 x int8 (kernel 8), for Hopper (sm_90a): its instances (d in {64,
// 128} x G = Hq / Hkv in {1, 2, 4, 8} x with and without a window: 16), the
// arrival counters of its split merge and its C entries.
//
// Replaces flashattention_kernel_project_tpu/ops/flash_decode.py::
// _decode_kernel_int8_mxu (:171, pallas_call :557), reached through
// flash_decode_int8(mxu=True), and the merge of its splits
// (merge_partials, a jnp reduction after the pallas_call). Each (batch
// row, KV head, split) block computes the partials (m, l, y) of the
// group's G = Hq / Hkv query rows over its split's live keys in the TPU
// kernel's arithmetic:
// - q is quantized per row: qsc = (max|q| == 0 ? 1 : max|q|) / 127,
//   q_i8 = round(q / qsc), and the row's score scale is qs = qsc * sm_scale;
// - the score of key j is f32(q_i8 . k_i8) * (qs * ks[j]), an exact int32
//   dot;
// - over the split, m = max s, e = expf(s - m) (0 where masked), l = sum e;
// - the weights ew = e * vs[j] are requantized per row over the whole
//   split: r = max ew, rs = (r == 0 ? 1 : r) / 127, ei = int8(floorf(ew /
//   rs + 0.5));
// - y = f32(ei . v_i8) * rs, again an exact int32 sum.
// The split is the requantization group, so the wrapper sizes block_s by
// the JAX rule (a multiple of 32 keys) and the split count is part of the
// function. With a sliding window the split's live keys are its sink and
// band ranges (flash_decode_sm90.cuh's window_ranges), as in the JAX mask.
// With one split the block normalises its rows into out; with more, the
// last block of a (batch row, KV head) to arrive merges the splits on the
// card (flash_decode_sm90.cuh's merge_rows, on counters of its own).
//
// What bounds it on the H100: bytes, as every decode. A key costs 2 * d + 8
// bytes and 4 * G * d integer operations, far below the card's ridge; the
// CUDA-core design it replaced spent its time with few bytes in flight (a
// thread's 8 keys x 16 bytes, in three phases a split, the second with no
// load at all) and left the split merge to plain torch after the launch.
// What the design does about it:
// - One ring, K's tiles then V's. A producer warp, one thread of which
//   issues the loads, brings the split's K tiles and then its V tiles as
//   TMA boxes of 64 keys x d bytes over [B * Hkv, S, d], 128B-swizzled at
//   d = 128 and 64B-swizzled at d = 64 (kernel 7's byte tiles), through a
//   32 KB ring (4 stages at d = 128, 8 at d = 64) of full and empty
//   mbarriers; its lanes read each K tile's 64 K scales into the stage and
//   its V scales into the split's row in shared memory. (A 40 KB ring, the
//   scales read by the consumers instead, and the tiles visited from a
//   different one in each block measured no faster, tools/ab_8bit.py.) A
//   box may start at any key row, so each live range is cut into tiles
//   from its first key rounded down to a multiple of 4 (a split starts on
//   a multiple of 32), with no other special case; rows past S are
//   zero-filled. The producer runs on into V as soon as the consumers
//   release K's stages, so V's first tiles land while the consumers
//   compute the split's statistics.
// - The QK products on int8 mma.sync m16n8k32: the group's G rows (int8,
//   quantized in the block) are A, padded to 16 rows; the row-major K tile
//   is the K-major B operand as ldmatrix reads it, each consumer warp 16
//   keys of a tile. The int32 dots are exact; each score goes to the
//   split's f32 row in shared memory (JAX's scale order), and each row's
//   max is kept as the scores come.
// - The statistics between K's tiles and V's, over the split in shared
//   memory: 128 / G threads a row (a warp a row at G = 4: no block
//   barrier), 4 positions a thread at a time; one pass for e, l and the
//   weights e * vs in place of the scores and their max r, one for the
//   int8 weights beside them. The split's 4 * G + 4 bytes of f32 scores
//   and V scales and G bytes of int8 weights a key fit the 227 KB at JAX's
//   4096-key split at G = 8.
// - The PV products on the CUDA cores: each thread takes 8 dims of 4 keys,
//   transposes the 4 x 4 bytes of each half (mma.cuh's transpose4) so that
//   a word holds one dim of the 4 keys, and __dp4a's it with the 4 keys'
//   int8 weights of each row; a weight word is masked to the tile's range
//   where a 4-key group crosses its edge. The int32 sums meet across the
//   threads by shuffles and across the warps in the ring's memory, exact in
//   any order.
// - The merge in registers (flash_decode_sm90.cuh's merge_rows, as kernels
//   6 and 7 take it): each thread loads the m, l and y of its outputs' row
//   for a chunk of splits at once and folds them in, with no barrier.

#include "flash_decode_sm90.cuh"

namespace fkp_dec90 {
namespace {

using fkp_mma::mma_16832_s8;
using fkp_mma::transpose4;

// one a (batch row, KV head); every completed launch leaves them at 0
__device__ int g_mxu_counters[kMaxCounters];

// What a launch of kernel 8 takes besides the two TMA maps: q [b, hkv * G,
// D] bf16; k_scale, v_scale [b, hkv, s, 1] f32; lengths [b] int32; the
// partials m, l [b, hkv, n_splits, G] and y [b, hkv, n_splits, G, D] f32 (m
// in natural-log units, NEG_INF with l = 0 and y = 0 for a split with no
// live key); out [b, hq, D] bf16, or null (the partials alone).
struct MxuParams {
  const __nv_bfloat16* q;
  const float* k_scale;
  const float* v_scale;
  const int* lengths;
  float* m;
  float* l;
  float* y;
  __nv_bfloat16* out;
  int hkv, s, n_splits, block_s;
  float sm_scale;
  int window, sinks;
};

// The ring and the split's arrays in dynamic shared memory, after up to 1
// KB of alignment slack: kStages byte tiles of 64 keys x D (1024-byte
// aligned, the swizzle's period), each stage's 64 K scales (f32), then the
// split's scores [G][block_s] f32, its V scales [block_s] f32 and its
// weights [G][block_s] int8 (ops/flash_decode.py::_mxu_smem_bytes counts
// the same).
template <int D>
struct LayoutMxu {
  static constexpr int kTileBytes = kTile * D;
  static constexpr int kStages = 32768 / kTileBytes;  // 4 at d = 128, 8 at 64
  static constexpr int kRing = kStages * kTileBytes;
  static constexpr int kSplitOff = kRing + kStages * kTile * 4;
  static_assert(kRing >= kWarps * 8 * D * 4, "the warps' sums reuse the ring");
};

template <int D, int G>
constexpr size_t mxu_smem_bytes(int block_s) {
  return 1024 + LayoutMxu<D>::kSplitOff + (size_t)(5 * G + 4) * block_s;
}

// The group's G query rows [G, D] (bf16) quantized to int8 with one
// symmetric scale a row into q_s, one consumer warp a row, as JAX's wrapper
// does in XLA before its kernel (flash_decode.py:485-490): s = (qmax == 0 ?
// 1 : qmax) * (1 / 127), q_s = round(q / s), qs_s = s * scale. qmax is the
// row's largest |q|; rounding is half to even (rintf), as jnp.round and
// torch.round. The caller syncs before reading q_s.
template <int D, int G>
__device__ __forceinline__ void quantize_q_rows(
    const __nv_bfloat16* __restrict__ q_g, float scale, int8_t (*q_s)[D],
    float* qs_s) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int gi = warp; gi < G; gi += kWarps) {
    float x[D / 32];
    float mx = 0.f;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      x[i] = __bfloat162float(q_g[gi * D + lane + 32 * i]);
      mx = fmaxf(mx, fabsf(x[i]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    const float s = (mx == 0.f ? 1.f : mx) * (1.f / 127.f);
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      q_s[gi][lane + 32 * i] = static_cast<int8_t>(rintf(x[i] / s));
    }
    if (lane == 0) qs_s[gi] = s * scale;
  }
}

// x reduced (max, or sum) over the kTpr consecutive consumer threads of a
// row: shuffles within the warp, then, where a row spans warps, through
// red [kWarps] (a slot array of this reduction's own) and named barrier 1.
template <int kTpr, bool kMax>
__device__ __forceinline__ float row_reduce(float x, float* red) {
#pragma unroll
  for (int off = (kTpr < 32 ? kTpr : 32) / 2; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, x, off);
    x = kMax ? fmaxf(x, o) : x + o;
  }
  if constexpr (kTpr > 32) {
    constexpr int kSpan = kTpr / 32;  // warps a row
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) red[warp] = x;
    fkp_sm90::named_sync(1, kConsumers);
    const int first = warp / kSpan * kSpan;
    x = red[first];
#pragma unroll
    for (int w = 1; w < kSpan; ++w) {
      x = kMax ? fmaxf(x, red[first + w]) : x + red[first + w];
    }
  }
  return x;
}

// One block per (split, KV head, batch row): threads 0..127 the consumer
// warps, 128..159 the producer warp. Maps: k and v over [b * hkv, s, D]
// bytes in boxes of 64 keys x D bytes, swizzled (byte_addr). counters:
// kMaxCounters ints, 0 between launches (read only when out is set and
// n_splits > 1).
template <int D, int G, bool kWindow>
__global__ void __launch_bounds__(kThreads, 3)
    flash_decode_mxu_kernel(const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const MxuParams p, int* __restrict__ counters) {
  using L = LayoutMxu<D>;
  constexpr int kS = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kS];  // full, empty
  __shared__ __align__(16) int8_t q8[G][D];
  __shared__ float sh_qs[G], sh_m[G], sh_l[G], sh_rs[G];
  __shared__ float sh_wm[kWarps][G];  // each warp's row maxima over its keys
  __shared__ float red[2][kWarps];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const int bs = p.block_s;
  const auto tile_s = [&](int st) { return base + L::kTileBytes * st; };
  float* const ks_s = reinterpret_cast<float*>(base_ptr + L::kRing);  // [kS][64]
  float* const sc = reinterpret_cast<float*>(base_ptr + L::kSplitOff);  // [G][bs]
  float* const vs_s = sc + G * bs;                                  // [bs]
  int8_t* const ei = reinterpret_cast<int8_t*>(vs_s + bs);         // [G][bs]
  const auto full_bar = [&](int st) { return smem_u32(&bars[st]); };
  const auto empty_bar = [&](int st) { return smem_u32(&bars[kS + st]); };

  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int len = min(max(p.lengths[b], 0), p.s);  // lengths above S count as S
  const int start = split * bs;
  int s0, e0, s1, e1;
  window_ranges<kWindow>(start, min(start + bs, len), len, p.window, p.sinks,
                         s0, e0, s1, e1);
  // each live range in 64-key tiles from its first key rounded down to a
  // multiple of 4 (start is a multiple of 32); keys outside the tile's range
  // are masked (the same list for producer and consumers, K's then V's)
  const int a0 = s0 & ~3, a1 = s1 & ~3;
  const int n0 = s0 < e0 ? (e0 - a0 + kTile - 1) / kTile : 0;
  const int n_tiles = n0 + (s1 < e1 ? (e1 - a1 + kTile - 1) / kTile : 0);
  const size_t bh = (size_t)b * p.hkv + kvh;
  const auto tile_key = [&](int i) {
    return i < n0 ? a0 + i * kTile : a1 + (i - n0) * kTile;
  };
  // tile i's range: keys at or past its end, or before its start, masked
  const auto tile_lo = [&](int i) { return i < n0 ? s0 : s1; };
  const auto tile_hi = [&](int i) { return i < n0 ? e0 : e1; };

  if (threadIdx.x == 0) {
    for (int st = 0; st < kS; ++st) {
      mbar_init(full_bar(st), 1);
      mbar_init(empty_bar(st), kWarps);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  if (threadIdx.x >= kConsumers) {  // the producer warp
    const float* ks_bh = p.k_scale + bh * p.s;
    const float* vs_bh = p.v_scale + bh * p.s;
    for (int it = 0; it < 2 * n_tiles; ++it) {
      const int st = it % kS;
      const bool is_k = it < n_tiles;
      const int key0 = tile_key(is_k ? it : it - n_tiles);
      // a K tile's scales (0 past the length), in flight while the wait
      // passes: K's into the stage, V's into the split's row
      float sk[2];
      if (is_k) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int key = key0 + lane + 32 * u;
          sk[u] = key < len ? __ldg(ks_bh + key) : 0.f;
          const float sv = key < len ? __ldg(vs_bh + key) : 0.f;
          if (key - start < bs) vs_s[key - start] = sv;
        }
      }
      // the stage's previous tile released by every consumer warp (the
      // first round passes at once)
      mbar_wait(empty_bar(st), ((it / kS) & 1) ^ 1);
      if (is_k) {
#pragma unroll
        for (int u = 0; u < 2; ++u) ks_s[st * kTile + lane + 32 * u] = sk[u];
      }
      __syncwarp();
      if (lane == 0) {
        mbar_expect_tx(full_bar(st), L::kTileBytes);
        tma_load(tile_s(st), is_k ? &k_map : &v_map, full_bar(st), 0, key0,
                 (int)bh);
      }
    }
    return;
  }

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = lane / 4, t = lane % 4;  // this thread's fragment row and pair
  const int w16 = warp * 16;             // the warp's keys in a tile
  // the int32 sums of y: this thread's 8 dims (dg * 8 ..) over the keys of
  // its 4-key groups, a row each
  constexpr int kDimGroups = D / 8;
  constexpr int kKeyGroups = kConsumers / kDimGroups;  // 8 at d = 128, 16 at 64
  const int dg = tid % kDimGroups, kg = tid / kDimGroups;
  int acc[G][8];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[gi][i] = 0;
  }

  if (n_tiles > 0) {
    // 0. the q rows to int8
    quantize_q_rows<D, G>(p.q + bh * G * D, p.sm_scale, q8, sh_qs);
    fkp_sm90::named_sync(1, kConsumers);

    // 1. scores: row g's A fragments (m16n8k32: bytes 4t.. and 16 + 4t.. of
    // each 32-dim step; rows 8..15 and rows >= G zero), then each K tile's
    // exact int32 dots over the warp's 16 keys, scaled into the split's row
    // and the row's max kept
    uint32_t qa[D / 32][4];
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) {
      qa[kk][0] = g < G ? *reinterpret_cast<const uint32_t*>(&q8[g][kk * 32 + 4 * t]) : 0u;
      qa[kk][1] = 0u;
      qa[kk][2] = g < G ? *reinterpret_cast<const uint32_t*>(&q8[g][kk * 32 + 16 + 4 * t])
                        : 0u;
      qa[kk][3] = 0u;
    }
    const float qs = g < G ? sh_qs[g] : 0.f;
    float mrun = kNegInf;  // row g's max over this thread's live scores
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kS;
      const int key0 = tile_key(it);
      const int lo = tile_lo(it), hi = tile_hi(it);
      mbar_wait(full_bar(st), (it / kS) & 1);
      int si[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk) {
        // matrix i: keys w16 + (i / 2) * 8 .., dims kk * 32 + (i % 2) * 16 ..
        uint32_t bk[4];
        ldsm_x4(bk, byte_addr<D>(tile_s(st), w16 + lane % 8 + lane / 16 * 8,
                                 kk * 32 + lane / 8 % 2 * 16));
        mma_16832_s8(si[0], qa[kk], bk[0], bk[1]);
        mma_16832_s8(si[1], qa[kk], bk[2], bk[3]);
      }
      if (g < G) {
        const float* const ksc = ks_s + st * kTile;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float2 kp = *reinterpret_cast<const float2*>(ksc + w16 + j * 8 + 2 * t);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = key0 + w16 + j * 8 + 2 * t + e;
            if (key >= lo && key < hi) {
              const float x = static_cast<float>(si[j][e]) * (qs * (e ? kp.y : kp.x));
              sc[g * bs + key - start] = x;
              mrun = fmaxf(mrun, x);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar(st));  // this warp is done with it
    }
    // row g's max over the warp's keys (its quad's four threads)
    mrun = fmaxf(mrun, __shfl_xor_sync(0xffffffffu, mrun, 1));
    mrun = fmaxf(mrun, __shfl_xor_sync(0xffffffffu, mrun, 2));
    if (g < G && t == 0) sh_wm[warp][g] = mrun;
    fkp_sm90::named_sync(1, kConsumers);  // every score, V scale and max stored

    // 2. the statistics of each row over the split's live positions, 128 / G
    // threads a row, 4 positions a thread at a time: m, e = exp(s - m), l,
    // the weights e * vs in place of the scores and their max r; then the
    // weights requantized to int8 (floor(ew / rs + 0.5), which rounds half
    // up as ew >= 0, JAX's)
    constexpr int kTpr = kConsumers / G;  // threads a row
    const int gr = tid / kTpr, jr = tid % kTpr;
    const int n_buf = (s1 < e1 ? e1 : e0) - start;
    const auto live = [&](int j) {
      const int key = start + j;
      return !kWindow || (key >= s0 && key < e0) || (key >= s1 && key < e1);
    };
    float* const row = sc + gr * bs;
    float mx = sh_wm[0][gr];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, sh_wm[w][gr]);
    float lsum = 0.f, r = 0.f;
    // (j4 + 3 < block_s: block_s and j4 are multiples of 4)
    for (int j4 = 4 * jr; j4 < n_buf; j4 += 4 * kTpr) {
      float4 x = *reinterpret_cast<const float4*>(row + j4);
      const float4 vs4 = *reinterpret_cast<const float4*>(vs_s + j4);
      float* const xs = reinterpret_cast<float*>(&x);
      const float* const vv = reinterpret_cast<const float*>(&vs4);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (j4 + u < n_buf && live(j4 + u)) {
          const float e = expf(xs[u] - mx);
          lsum += e;
          xs[u] = e * vv[u];  // e * vs[j], in place of the score
          r = fmaxf(r, xs[u]);
        }
      }
      *reinterpret_cast<float4*>(row + j4) = x;
    }
    lsum = row_reduce<kTpr, false>(lsum, red[0]);
    r = row_reduce<kTpr, true>(r, red[1]);
    const float rs = (r == 0.f ? 1.f : r) * (1.f / 127.f);
    int8_t* const wrow = ei + gr * bs;
    for (int j4 = 4 * jr; j4 < n_buf; j4 += 4 * kTpr) {
      const float4 x = *reinterpret_cast<const float4*>(row + j4);
      const float* const xs = reinterpret_cast<const float*>(&x);
      uint32_t w = 0u;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (j4 + u < n_buf && live(j4 + u)) {
          w |= static_cast<uint32_t>(static_cast<uint8_t>(
                   static_cast<int8_t>(floorf(xs[u] / rs + 0.5f))))
               << (8 * u);
        }
      }
      *reinterpret_cast<uint32_t*>(wrow + j4) = w;
    }
    if (jr == 0) {
      sh_m[gr] = mx;
      sh_l[gr] = lsum;
      sh_rs[gr] = rs;
    }
    fkp_sm90::named_sync(1, kConsumers);  // every weight and row stored

    // 3. y = ei . v over the V tiles: each thread 8 dims of a 4-key group a
    // pass, the group's 4 x 8 bytes transposed into 8 words of one dim each
    constexpr int kPasses = kTile / (4 * kKeyGroups);  // 2 at d = 128, 1 at 64
    for (int it = 0; it < n_tiles; ++it) {
      const int ring = n_tiles + it;
      const int st = ring % kS;
      const int key0 = tile_key(it);
      const int lo = tile_lo(it), hi = tile_hi(it);
      mbar_wait(full_bar(st), (ring / kS) & 1);
#pragma unroll
      for (int ps = 0; ps < kPasses; ++ps) {
        const int r0 = (ps * kKeyGroups + kg) * 4;  // the group's first row
        const int key = key0 + r0;
        if (key >= hi || key + 4 <= lo) continue;
        uint32_t msk = 0xffffffffu;  // the group's keys inside [lo, hi)
        if (key < lo || key + 4 > hi) {
          msk = 0u;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (key + i >= lo && key + i < hi) msk |= 0xffu << (8 * i);
          }
        }
        uint32_t words[2][4];  // [half][key]: dims dg * 8 + 4 half ..
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint2 x = *reinterpret_cast<const uint2*>(
              base_ptr + (byte_addr<D>(tile_s(st), r0 + i, dg * 8 / 16 * 16) - base) +
              dg * 8 % 16);
          words[0][i] = x.x;
          words[1][i] = x.y;
        }
        uint32_t cols[2][4];  // [half][dim]: the 4 keys' bytes of one dim
        transpose4(words[0], cols[0]);
        transpose4(words[1], cols[1]);
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          const int w = static_cast<int>(
              *reinterpret_cast<const uint32_t*>(ei + gi * bs + key - start) & msk);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[gi][i] = __dp4a(static_cast<int>(cols[i / 4][i % 4]), w, acc[gi][i]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar(st));  // this warp is done with it
    }
  }

  // the key groups' sums: across the warp's groups by shuffles, then the
  // warps' through the ring's memory (free: every tile was waited for)
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int off = kDimGroups; off < 32; off <<= 1) {
        acc[gi][i] += __shfl_xor_sync(0xffffffffu, acc[gi][i], off);
      }
    }
  }
  int* const y_s = reinterpret_cast<int*>(base_ptr);  // [kWarps][G][D]
  fkp_sm90::named_sync(1, kConsumers);
  if (lane < kDimGroups) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
#pragma unroll
      for (int i = 0; i < 8; i += 4) {
        *reinterpret_cast<int4*>(y_s + (warp * G + gi) * D + dg * 8 + i) =
            make_int4(acc[gi][i], acc[gi][i + 1], acc[gi][i + 2], acc[gi][i + 3]);
      }
    }
  }
  fkp_sm90::named_sync(1, kConsumers);
  const bool single = p.out != nullptr && p.n_splits == 1;
  const size_t part = bh * p.n_splits + split;
  for (int i = tid; i < G * D; i += kConsumers) {
    const int gi = i / D;
    float yv = 0.f, lv = 0.f;
    if (n_tiles > 0) {
      int tot = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) tot += y_s[(w * G + gi) * D + i % D];
      yv = static_cast<float>(tot) * sh_rs[gi];
      lv = sh_l[gi];
    }
    if (single) {
      p.out[bh * G * D + i] = __float2bfloat16(lv == 0.f ? 0.f : yv / lv);
    } else {
      p.y[part * G * D + i] = yv;
      if (i % D == 0) {
        p.m[part * G + gi] = n_tiles > 0 ? sh_m[gi] : kNegInf;
        p.l[part * G + gi] = lv;
      }
    }
  }
  if (p.out == nullptr || single) return;
  merge_rows<D, G>(p.m, p.l, p.y, p.out, p.n_splits, bh, counters);
}

// Launches instance <D, G, kWindow> on a grid of (n_splits, hkv, b);
// returns a CUDA error code (the shared-memory attribute's,
// cudaErrorInvalidValue where a map cannot be encoded, else
// cudaGetLastError() after the launch).
template <int D, int G, bool kWindow>
int launch_mxu(const MxuParams& p, const void* k, const void* v, int b,
               cudaStream_t stream) {
  const auto kernel = &flash_decode_mxu_kernel<D, G, kWindow>;
  const size_t bytes = mxu_smem_bytes<D, G>(p.block_s);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  int* counters = nullptr;
  err = cudaGetSymbolAddress(reinterpret_cast<void**>(&counters), g_mxu_counters);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr CUtensorMapSwizzle kSwizzle =
      D == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap km, vm;
  if (!fkp_sm90::encode_tiled(&km, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, k, D,
                              p.s, b * p.hkv, kTile, D, kSwizzle) ||
      !fkp_sm90::encode_tiled(&vm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, v, D,
                              p.s, b * p.hkv, kTile, D, kSwizzle)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<dim3(p.n_splits, p.hkv, b), kThreads, bytes, stream>>>(km, vm, p,
                                                                  counters);
  return static_cast<int>(cudaGetLastError());
}

// The instance for the call's d, g and window (by_shape).
int launch_mxu_any(int d, int g, const MxuParams& p, const void* k,
                   const void* v, int b, cudaStream_t stream) {
  return by_shape(d, g, p.window, [&](auto dc, auto gc, auto wc) {
    return launch_mxu<decltype(dc)::value, decltype(gc)::value,
                      decltype(wc)::value>(p, k, v, b, stream);
  });
}

// The call's arguments as the kernel takes them, or false: the shape
// (valid), block_s a multiple of 32, the scales given.
bool mxu_args(MxuParams& p, const void* q, const void* k_scale,
              const void* v_scale, const void* lengths, void* m, void* l,
              void* y, void* out, int b, int hq, int hkv, int s, int n_splits,
              int block_s, float sm_scale, int window, int sinks) {
  if (!valid(b, hq, hkv, s, n_splits, block_s) || block_s % 32 || !k_scale ||
      !v_scale) {
    return false;
  }
  p = MxuParams{static_cast<const __nv_bfloat16*>(q),
                static_cast<const float*>(k_scale),
                static_cast<const float*>(v_scale),
                static_cast<const int*>(lengths),
                static_cast<float*>(m),
                static_cast<float*>(l),
                static_cast<float*>(y),
                static_cast<__nv_bfloat16*>(out),
                hkv, s, n_splits, block_s, sm_scale, window, sinks};
  return true;
}

}  // namespace
}  // namespace fkp_dec90

// q [b, hq, d] bf16; k/v [b, hkv, s, d] int8 and their scales
// k_scale/v_scale [b, hkv, s, 1] f32, all contiguous, k and v 16-byte
// aligned; lengths [b] int32 (keys [0, min(lengths, s)) attended); the
// partials of each split: m, l [b, hkv, n_splits, G] and y [b, hkv,
// n_splits, G, d] f32, G = hq/hkv in {1, 2, 4, 8}, d in {64, 128} (m in
// natural-log units, NEG_INF with l = 0 and y = 0 for a split with no live
// key). Split i covers keys [i*block_s, (i+1)*block_s), block_s a multiple
// of 32; the block takes ops/flash_decode.py::_mxu_smem_bytes of shared
// memory. window > 0: the band of the last `window` keys plus the first
// `sinks`; 0: every key below the length. Returns cudaGetLastError() after
// the launch (or the error of the shared-memory attribute), or
// cudaErrorInvalidValue without one for a shape outside these or inputs a
// TMA map cannot describe.
extern "C" int fkp_flash_decode_mxu(const void* q, const void* k,
                                    const void* k_scale, const void* v,
                                    const void* v_scale, const void* lengths,
                                    void* m, void* l, void* y, int b, int hq,
                                    int hkv, int s, int d, int n_splits,
                                    int block_s, float sm_scale, int window,
                                    int sinks, void* stream) {
  fkp_dec90::MxuParams p;
  if (!m || !l || !y ||
      !fkp_dec90::mxu_args(p, q, k_scale, v_scale, lengths, m, l, y, nullptr,
                           b, hq, hkv, s, n_splits, block_s, sm_scale, window,
                           sinks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return fkp_dec90::launch_mxu_any(d, hq / hkv, p, k, v, b,
                                   static_cast<cudaStream_t>(stream));
}

// The same call merged on the card: out [b, hq, d] bf16 takes the
// normalised rows (0 for a row that sees no key). With n_splits > 1, m, l
// and y (as fkp_flash_decode_mxu's, y 16-byte aligned) are the splits'
// workspace and b * hkv is at most 2^18; with one split they are unread
// and may be null. Returns as fkp_flash_decode_mxu.
extern "C" int fkp_flash_decode_mxu_out(const void* q, const void* k,
                                        const void* k_scale, const void* v,
                                        const void* v_scale,
                                        const void* lengths, void* out,
                                        void* m, void* l, void* y, int b,
                                        int hq, int hkv, int s, int d,
                                        int n_splits, int block_s,
                                        float sm_scale, int window, int sinks,
                                        void* stream) {
  fkp_dec90::MxuParams p;
  if (!out ||
      (n_splits > 1 && (!m || !l || !y || reinterpret_cast<uintptr_t>(y) % 16 ||
                        (long long)b * hkv > fkp_dec90::kMaxCounters)) ||
      !fkp_dec90::mxu_args(p, q, k_scale, v_scale, lengths, m, l, y, out, b,
                           hq, hkv, s, n_splits, block_s, sm_scale, window,
                           sinks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return fkp_dec90::launch_mxu_any(d, hq / hkv, p, k, v, b,
                                   static_cast<cudaStream_t>(stream));
}
