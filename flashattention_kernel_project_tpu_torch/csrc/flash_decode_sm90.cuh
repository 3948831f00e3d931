// The linear-cache decodes for Hopper (sm_90a): one new token per
// sequence against a linear bf16 KV cache, split over the keys, with
// 64-key K/V tiles through a TMA ring, both products on the tensor cores,
// and the splits merged on the card. flash_decode_sm90.cu builds its
// instances (d in {64, 128} x G = Hq / Hkv in {1, 2, 4, 8} x with and
// without a window: 16) and the C entries. The same block over an 8-bit
// cache (kernel 7, flash_decode_q_sm90_kernel below: the ring, the split
// merge and the entries' contract, over byte tiles widened in registers)
// is built by flash_decode_q.cu (int8, and the 8-bit entries) and
// flash_decode_q_fp8.cu (e4m3), whose head says what it replaces. The int8
// x int8 decode (kernel 8, flash_decode_mxu.cu) takes this header's byte
// tiles, window ranges and split merge (merge_rows, all three kernels').
//
// Replaces flashattention_kernel_project_tpu/ops/flash_decode.py::
// _decode_kernel (:38, pallas_call :392), reached through flash_decode for
// a bf16 cache, with its sliding window and sinks (:60-67, _clamp_to_live
// :254), and the merge of its splits (merge_partials, a jnp reduction
// after the pallas_call). Each (batch row, KV head, split) block computes
// the partials (m, l, y) of the group's G query rows over the split's keys
// below lengths[b] (with a window, only the band's keys and the sinks),
// and the split's partials are merged into the normalised output in q's
// dtype on the card. Also replaces ops/streaming.py::_streaming_kernel
// (:45, pallas_call :229): streaming_decode computes flash_decode's
// function with one program a (sequence, KV head), which is this kernel at
// one split of S rounded up to whole 64-key tiles.
//
// What bounds it on the H100: bytes. Each key costs 4 * d bytes of K and V
// and 4 * G * d flops, at most 2 flops a byte (G = 8), far below the ~295
// flop/byte ridge: the 3.35 TB/s of HBM is the roof. What matters is
// having enough bytes in flight, spending few instructions per key, and,
// at small batch, enough blocks to keep every SM loading. What the design
// does about it:
// - Key tiles through a TMA ring. A producer warp, one thread of which
//   issues the loads, brings each tile's K and V as boxes of 64 keys x 64
//   dims (128-byte rows, 128B-swizzled) from 3-D maps over [B * Hkv, S, d]
//   into a ring of 3 stages (32 KB a stage at d = 128), tracked by full and
//   empty mbarriers. No consumer register or instruction goes to a load,
//   and 2 blocks an SM (4 at d = 64) keep up to 192 KB in flight. A box
//   may start at any key row, so a split that does not start on a
//   multiple of 64 needs no special case; rows past S are zero-filled, and
//   keys past the split's end or the length are masked in the scores.
// - Both products on mma.sync m16n8k16, one softmax a tile. The group's G
//   query rows are the A operand, zero-padded to 16 rows (rows G..15 and
//   8..15 are padding); each of the 4 consumer warps takes 16 keys of a
//   tile: S = Q K^T from ldmatrix fragments of the swizzled K tile, then
//   one max a row (two shuffles), one rescale and one exp2 a (row, key),
//   in the log2 domain in f32, and P V from ldmatrix.trans fragments of
//   the V tile with p as a bf16 hi + lo pair (about 16 bits of p, the
//   precision of the earlier decodes). The CUDA-core decode body this
//   replaced gave one key to 16 threads, each with its own online state
//   for all G rows: two exp2 and four shuffles a key and row, and the
//   accumulator rescaled a key at a time. The warps' states merge through
//   shared memory (the ring's, free after the loop).
// - Splits sized for any batch by the wrapper (ops/flash_decode.py::
//   default_n_splits: whole 64-key tiles, at least two a split, and as
//   many as fill the SMs at the blocks an SM holds; one split where B *
//   Hkv already fills the card). A split with no live key loads nothing.
//   Under a window a split visits its sink keys, then its band (two key
//   ranges, window_ranges below), each in tiles from its first key.
// - The merge on the card. With one split the block normalises its rows
//   and writes them in q's dtype. With more, each block writes its f32
//   partials, and the last block of a (batch row, KV head) to arrive, by
//   an atomic counter, merges them and writes the output; it then resets
//   the counter to 0. The counters are a zero-initialised device array of
//   the library, so a launch needs no memset and a CUDA graph replays it
//   as it is: every completed launch leaves them at 0. A launch that faults
//   leaves the context unusable, and a refused one never touched them. Two
//   launches running at once on two streams of one device would share
//   them: the wrapper's callers run one decode at a time a device.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"
#include "sm90.cuh"
#include "widen.cuh"

namespace fkp_dec90 {

using fkp_mma::mma_16816;
using fkp_mma::split_bf16;
using fkp::widen4;
using fkp_sm90::kBoxCols;
using fkp_sm90::mbar_arrive;
using fkp_sm90::mbar_expect_tx;
using fkp_sm90::mbar_init;
using fkp_sm90::mbar_wait;
using fkp_sm90::smem_u32;
using fkp_sm90::tma_load;

constexpr float kNegInf = -1e30f;  // finite, as NEG_INF in ops/softmax.py
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTile = 64;           // keys a tile, 16 a consumer warp
constexpr int kStages = 3;          // the ring's depth
constexpr int kWarps = 4;           // consumer warps
constexpr int kConsumers = kWarps * 32;
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kBoxBytes = kTile * 128;     // 64 keys x 64 dims, bf16
// arrival counters, one a (batch row, KV head): a call with more splits
// than one takes at most this many pairs
constexpr int kMaxCounters = 1 << 18;

// Shared memory of the d instances: the ring's stages, each K then V,
// every box 1024-byte aligned (the 128B swizzle's period), after up to 1 KB
// of alignment slack. kMinBlocks: the blocks an SM holds at that size
// (ops/flash_decode.py::_blocks_per_sm computes the same).
template <int D>
struct Layout {
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kTileBytes = kBoxes * kBoxBytes;  // K or V
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kBytes = 1024 + kStages * kStageBytes;
  static constexpr int kMinBlocks = D == 64 ? 4 : 2;
};

// Shared memory of the 8-bit instances: the ring's stages, each the K
// tile's 64 rows of D bytes, then V's, then the tile's 64 K and 64 V
// scales (f32), rounded up to 1 KB so that every tile keeps the swizzle's
// 1024-byte alignment, after up to 1 KB of alignment slack (52 KB at
// d = 128, 28 KB at d = 64). kMinBlocks: the blocks an SM holds, set by
// the registers (__launch_bounds__), whose shared memory the SM holds too
// (ops/flash_decode.py::_blocks_per_sm_q computes the same).
template <int D>
struct LayoutQ {
  static constexpr int kTileBytes = kTile * D;  // K or V, a byte a value
  static constexpr int kScaleOff = 2 * kTileBytes;  // in a stage: K's, then V's
  static constexpr int kStageBytes =
      (2 * kTileBytes + 2 * kTile * 4 + 1023) / 1024 * 1024;
  static constexpr int kBytes = 1024 + kStages * kStageBytes;
  static constexpr int kMinBlocks = D == 64 ? 4 : 3;
  // (2 KB a block besides: its static shared memory and the 1 KB the
  // runtime reserves)
  static_assert(kMinBlocks * (kBytes + 2048) <= 233472,
                "the SM holds kMinBlocks blocks' shared memory");
  static_assert(kStages * kStageBytes >= kWarps * 8 * D * 4,
                "the warps' states reuse the ring");
};

// What a launch takes besides the two TMA maps. m, l [b, hkv, n_splits,
// G] and y [b, hkv, n_splits, G, D] f32 hold each split's partials (m in
// natural-log units, NEG_INF and l = 0 for a split with no live key);
// out [b, hq, D] bf16 takes the merged rows, or is null (partials only).
struct Params {
  const __nv_bfloat16* q;
  const int* lengths;
  float* m;
  float* l;
  float* y;
  __nv_bfloat16* out;
  int hkv, s, n_splits, block_s;
  float scale_log2;
  int window, sinks;
  // the 8-bit instances' per-token scales [b, hkv, s, 1] f32 (null for bf16)
  const float* k_scale = nullptr;
  const float* v_scale = nullptr;
};

// The live keys of the split [start, end) of a sequence of `len` keys
// under a sliding window (kWindow): the sink keys [0, min(sinks, len)) and
// the band [max(len - window, 0), len), as at most two disjoint ranges
// [s0, e0) and [s1, e1) (one where they touch; an empty range has s >= e).
// Without a window: [start, end) itself. Kernel 8 (flash_decode_mxu.cu)
// takes the same ranges.
template <bool kWindow>
__device__ __forceinline__ void window_ranges(int start, int end, int len,
                                              int window, int sinks, int& s0,
                                              int& e0, int& s1, int& e1) {
  s0 = start;
  e0 = end;
  s1 = e1 = 0;
  if (!kWindow) return;
  const int sink_end = min(end, min(sinks, len));  // [start, sink_end)
  const int band_start = max(start, max(len - window, 0));  // [.., end)
  const bool has_sinks = sink_end > start;
  const bool has_band = end > band_start;
  if (has_sinks && has_band && sink_end < band_start) {  // a gap between
    e0 = sink_end;
    s1 = band_start;
    e1 = end;
  } else if (has_sinks && !has_band) {
    e0 = sink_end;
  } else if (!has_sinks) {
    s0 = band_start;  // the band, or nothing (band_start >= end)
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The shared address of the 16 bytes at (row r, columns c..c+7, c a
// multiple of 8) of a K or V tile at `tile`: boxes of 64 columns, one after
// the other, each 64 rows of 128 bytes in which 16-byte chunk x of row r
// lies at chunk x ^ (r % 8) (the 128B swizzle).
__device__ __forceinline__ uint32_t tile_addr(uint32_t tile, int r, int c) {
  return tile + (c / kBoxCols) * kBoxBytes + r * 128 +
         ((((c % kBoxCols) / 8) ^ (r % 8)) << 4);
}

// The arrival of a block of (b, kvh) that has written its split's
// partials, by its kConsumers threads: whether it is the last of the
// n_splits blocks to arrive, by the pair's counter, which the last resets
// to 0 for the next launch.
__device__ __forceinline__ bool last_to_arrive(int n_splits, size_t bh,
                                               int* __restrict__ counters) {
  __shared__ int sh_last;
  // every block's partials are written before its arrival
  __threadfence();
  fkp_sm90::named_sync(1, kConsumers);
  if (threadIdx.x == 0) {
    const int arrived = atomicAdd(counters + bh, 1) + 1;
    sh_last = arrived == n_splits;
    if (sh_last) counters[bh] = 0;
  }
  fkp_sm90::named_sync(1, kConsumers);
  return sh_last;
}

// The split merge on the card, by the kConsumers threads of a block that
// has written its split's partials (m in natural-log units, l, y at
// [bh, split] of m, l [.., n_splits, G] and y [.., n_splits, G, D], y
// 16-byte aligned): the last block of (b, kvh) to arrive merges the
// splits' partials into out [bh * G, D] bf16, each thread kCols outputs
// of one row, with no shared memory or barrier. It loads the m, l and y
// of a chunk of splits at once, into registers, and folds them into its
// running max and sums; rows that see no key give 0. (The merge it
// replaced went to L2 for a chunk's m and l and then for its y a few
// splits at a time, with the row weights computed by G threads between
// two barriers: 0.0035 ms against 0.0018 a call at 9 splits of kernel 8,
// tools/ab_8bit.py mxu.)
template <int D, int G>
__device__ __forceinline__ void merge_rows(const float* m, const float* l,
                                           const float* y, __nv_bfloat16* out,
                                           int n_splits, size_t bh,
                                           int* __restrict__ counters) {
  if (!last_to_arrive(n_splits, bh, counters)) return;
#if defined(FKP_DEC_PROBE) && FKP_DEC_PROBE == 1
  return;  // a probe (tools/ab_decode.py): the arrival without the merge
#endif
  __threadfence();
  constexpr int kCols = G * D >= kConsumers ? G * D / kConsumers : 1;
  constexpr int kChunk = 64 / (2 + kCols);  // splits a chunk
  using Vec = typename std::conditional<
      kCols % 4 == 0, float4,
      typename std::conditional<kCols == 2, float2, float>::type>::type;
  constexpr int kVecs = kCols * 4 / sizeof(Vec);  // vectors a split
  const int i0 = threadIdx.x * kCols;  // the thread's first output
  if (i0 >= G * D) return;
  const int row = i0 / D;
  const int n = n_splits;
  const float* m_r = m + bh * n * G + row;
  const float* l_r = l + bh * n * G + row;
  const float* y_r = y + bh * n * G * D + i0;
  float m_run = kNegInf, l_run = 0.f, y_run[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) y_run[c] = 0.f;
  for (int c0 = 0; c0 < n; c0 += kChunk) {
    float mv[kChunk], lv[kChunk];
    Vec yv[kChunk][kVecs];
#pragma unroll
    for (int sp = 0; sp < kChunk; ++sp) {
      const bool in = c0 + sp < n;
      mv[sp] = in ? __ldcg(m_r + (size_t)(c0 + sp) * G) : kNegInf;
      lv[sp] = in ? __ldcg(l_r + (size_t)(c0 + sp) * G) : 0.f;
#pragma unroll
      for (int v = 0; v < kVecs; ++v) {
        yv[sp][v] = in ? __ldcg(reinterpret_cast<const Vec*>(
                             y_r + (size_t)(c0 + sp) * G * D) + v)
                       : Vec{};
      }
    }
    float mc = m_run;
#pragma unroll
    for (int sp = 0; sp < kChunk; ++sp) mc = fmaxf(mc, mv[sp]);
    const float scale = expf(m_run - mc);  // the earlier sums'
    l_run *= scale;
#pragma unroll
    for (int c = 0; c < kCols; ++c) y_run[c] *= scale;
#pragma unroll
    for (int sp = 0; sp < kChunk; ++sp) {
      // a split with no live key (or past n) weighs nothing
      const float w = lv[sp] == 0.f ? 0.f : expf(mv[sp] - mc);
      l_run += lv[sp] * w;
      const float* const ys = reinterpret_cast<const float*>(yv[sp]);
#pragma unroll
      for (int c = 0; c < kCols; ++c) y_run[c] += w * ys[c];
    }
    m_run = mc;
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    out[bh * G * D + i0 + c] =
        __float2bfloat16(l_run == 0.f ? 0.f : y_run[c] / l_run);
  }
}

// The block's end, after the consumer warps have stored their states
// (sh_m, sh_l: each warp's row max, log2 domain, and sum; sh_acc: its
// [kWarps][G][D] f32 rows, in the ring's memory) and met at named barrier
// 1: the warps' states merged, then with one split the block's rows
// normalised into out, else its partials written and, by the last block
// of (b, kvh) to arrive, the splits merged into out (merge_rows). Out
// null: the partials alone. Called by the kConsumers threads.
template <int D, int G>
__device__ __forceinline__ void finish(const Params& p, int split, size_t bh,
                                       const float (*sh_m)[G],
                                       const float (*sh_l)[G], float* sh_acc,
                                       int* __restrict__ counters) {
  const int tid = threadIdx.x;
  const bool single = p.out != nullptr && p.n_splits == 1;
  const size_t part = bh * p.n_splits + split;
  for (int i = tid; i < G * D; i += kConsumers) {
    const int r = i / D;
    float mw = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mw = fmaxf(mw, sh_m[w][r]);
    float lt = 0.f, yt = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = exp2f(sh_m[w][r] - mw);
      lt += sh_l[w][r] * c;
      yt += sh_acc[(w * G + r) * D + i % D] * c;
    }
    if (single) {
      p.out[bh * G * D + i] = __float2bfloat16(lt == 0.f ? 0.f : yt / lt);
    } else {
      p.y[part * G * D + i] = yt;
      if (i % D == 0) {
        p.m[part * G + r] = lt == 0.f ? kNegInf : mw * kLn2;
        p.l[part * G + r] = lt;
      }
    }
  }
  if (p.out == nullptr || single) return;
  merge_rows<D, G>(p.m, p.l, p.y, p.out, p.n_splits, bh, counters);
}

// The shared address of bytes (row r, c..c+15, c a multiple of 16) of an
// 8-bit K or V tile at `tile` as the TMA lands it: rows of D bytes,
// 128B-swizzled at d = 128 (16-byte chunk x of row r at x ^ (r % 8)),
// 64B-swizzled at d = 64 (at x ^ (r / 2 % 4)), so that ldmatrix over 8 key
// rows of one column, and a warp's 16-byte row pieces, meet no bank
// conflict.
template <int D>
__device__ __forceinline__ uint32_t byte_addr(uint32_t tile, int r, int c) {
  const uint32_t off = r * D + c;
  return tile + (off ^ (((off >> 7) & (D == 128 ? 7u : 3u)) << 4));
}

// One block per (split, KV head, batch row): threads 0..127 are the
// consumer warps, 128..159 the producer warp. Maps: k and v over [b * hkv,
// s, D] in boxes of 64 keys x 64 dims. counters: kMaxCounters ints, 0
// between launches (read only when out is set and n_splits > 1).
template <int D, int G, bool kWindow>
__global__ void __launch_bounds__(kThreads, Layout<D>::kMinBlocks)
    flash_decode_sm90_kernel(const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             const Params p, int* __restrict__ counters) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];  // full, empty
  __shared__ float sh_m[kWarps][G];
  __shared__ float sh_l[kWarps][G];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const auto k_s = [&](int st) { return base + L::kStageBytes * st; };
  const auto v_s = [&](int st) { return k_s(st) + L::kTileBytes; };
  const auto full_bar = [&](int st) { return smem_u32(&bars[st]); };
  const auto empty_bar = [&](int st) { return smem_u32(&bars[kStages + st]); };

  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int len = min(max(p.lengths[b], 0), p.s);  // lengths above S count as S
  const int start = split * p.block_s;
  int s0, e0, s1, e1;
  window_ranges<kWindow>(start, min(start + p.block_s, len), len, p.window,
                         p.sinks, s0, e0, s1, e1);
  const int n0 = s0 < e0 ? (e0 - s0 + kTile - 1) / kTile : 0;
  const int n_tiles = n0 + (s1 < e1 ? (e1 - s1 + kTile - 1) / kTile : 0);
  // tile `it`'s first key and the end of its range: keys at or past the
  // end are masked (the same list for producer and consumers)
  const auto tile_key = [&](int it) {
    return it < n0 ? s0 + it * kTile : s1 + (it - n0) * kTile;
  };
  const size_t bh = (size_t)b * p.hkv + kvh;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_bar(st), 1);
      mbar_init(empty_bar(st), kWarps);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp: one thread loads
    if (threadIdx.x == kConsumers) {
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        // the stage's previous tile released by every consumer warp (the
        // first round passes at once)
        mbar_wait(empty_bar(st), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full_bar(st), L::kStageBytes);
        const int key0 = tile_key(it);
#pragma unroll
        for (int x = 0; x < L::kBoxes; ++x) {
          tma_load(k_s(st) + x * kBoxBytes, &k_map, full_bar(st),
                   x * kBoxCols, key0, (int)bh);
          tma_load(v_s(st) + x * kBoxBytes, &v_map, full_bar(st),
                   x * kBoxCols, key0, (int)bh);
        }
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = lane / 4, quad = lane % 4;  // this thread's C row and pair
  float m = kNegInf, l = 0.f;  // row `row` over this warp's keys (l: this thread's)
  float acc[D / 8][4];          // [.][0..1]: row `row`, dims n * 8 + 2 * quad + e
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  if (n_tiles > 0) {
    // the A fragments of Q: row `row` of the group (q heads kvh * G ..);
    // rows 8..15 are zero, as are rows >= G
    const __nv_bfloat16* q_g = p.q + bh * G * D;
    uint32_t qa[D / 16][2];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const __nv_bfloat16* qp = q_g + row * D + kk * 16 + quad * 2;
      qa[kk][0] = row < G ? *reinterpret_cast<const uint32_t*>(qp) : 0u;
      qa[kk][1] = row < G ? *reinterpret_cast<const uint32_t*>(qp + 8) : 0u;
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages;
      const int end = it < n0 ? e0 : e1;
      mbar_wait(full_bar(st), (it / kStages) & 1);

      // S = Q K^T over the warp's keys warp * 16 + j * 8 + 2 * quad + e
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t bk[4];
        ldsm_x4(bk, tile_addr(k_s(st), warp * 16 + lane % 8 + lane / 16 * 8,
                              kk * 16 + lane / 8 % 2 * 8));
        const uint32_t a[4] = {qa[kk][0], 0u, qa[kk][1], 0u};
        mma_16816(sc[0], a, bk[0], bk[1]);
        mma_16816(sc[1], a, bk[2], bk[3]);
      }
      // the tile's softmax for row `row` over the warp's 16 keys: one max
      // (the quad's four threads hold them), one rescale, one exp2 a key
      const int key0 = tile_key(it) + warp * 16 + quad * 2;
      float z[2][2], mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          z[j][e] = key0 + j * 8 + e < end ? sc[j][e] * p.scale_log2 : kNegInf;
          mx = fmaxf(mx, z[j][e]);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m, mx);
      const float corr = exp2f(m - m_new);
      float pr[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // a masked key adds nothing, even while m_new is kNegInf
          pr[j][e] = key0 + j * 8 + e < end ? exp2f(z[j][e] - m_new) : 0.f;
        }
      }
      l = l * corr + (pr[0][0] + pr[0][1]) + (pr[1][0] + pr[1][1]);
      m = m_new;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][0] *= corr;
        acc[n][1] *= corr;
      }
      // P (row `row`, the warp's 16 keys) as the A operand, a bf16 hi + lo pair
      uint32_t hi[4] = {0u, 0u, 0u, 0u}, lo[4] = {0u, 0u, 0u, 0u};
      split_bf16(pr[0][0], pr[0][1], hi[0], lo[0]);
      split_bf16(pr[1][0], pr[1][1], hi[2], lo[2]);
#pragma unroll
      for (int nn = 0; nn < D / 16; ++nn) {
        uint32_t bv[4];
        ldsm_x4_t(bv, tile_addr(v_s(st), warp * 16 + lane % 8 + lane / 8 % 2 * 8,
                                nn * 16 + lane / 16 * 8));
        mma_16816(acc[2 * nn], hi, bv[0], bv[1]);
        mma_16816(acc[2 * nn], lo, bv[0], bv[1]);
        mma_16816(acc[2 * nn + 1], hi, bv[2], bv[3]);
        mma_16816(acc[2 * nn + 1], lo, bv[2], bv[3]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar(st));  // this warp is done with it
    }
  }

  // merge the warps' states through shared memory (the ring's, free once
  // every warp has left the loop); a warp that saw no live key holds
  // (kNegInf, 0, 0) and weighs 0
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  float* const sh_acc = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)));
  fkp_sm90::named_sync(1, kConsumers);
  if (row < G) {
    if (quad == 0) {
      sh_m[warp][row] = m;
      sh_l[warp][row] = l;
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      float* dst = sh_acc + (warp * G + row) * D + n * 8 + quad * 2;
      dst[0] = acc[n][0];
      dst[1] = acc[n][1];
    }
  }
  fkp_sm90::named_sync(1, kConsumers);
  finish<D, G>(p, split, bh, sh_m, sh_l, sh_acc, counters);
}

// The 8-bit decode (kernel 7): one block per (split, KV head, batch row)
// as the bf16 kernel's, over an int8 or e4m3 cache (KV) with per-token
// scales p.k_scale, p.v_scale [b, hkv, s, 1]. Maps: k and v over [b * hkv,
// s, D] bytes in boxes of 64 keys x D bytes, swizzled (byte_addr). The
// producer warp's lanes read each tile's 64 K and 64 V scales (0 past the
// length) into the stage beside it before the first lane issues its two
// boxes: a scale row is 16-byte aligned for a bulk copy only where s and
// the tile's first key are multiples of 4. Each consumer warp takes 16
// keys of a tile, its K and V widened exactly to bf16 in registers, never
// in shared memory:
// - S = Q K^T: ldmatrix over the byte tile gives each thread 4 bytes of a
//   key row, dims 4t..4t+3 of a 16-dim column, which widen to the B
//   fragment (k 2t, 2t+1 | 2t+8, 2t+9, n g) of those dims taken in that
//   order; q's A fragment takes its dims in the same order (one 8-byte
//   load a column, once), so the sum over the dims is the same.
// - O^T += V^T P^T: the output's dims are the rows of the product and the
//   group's G <= 8 query rows its 8 columns, so p, the score
//   accumulator's layout, is the B fragment as it stands (a bf16 hi + lo
//   pair) and each accumulator register is a real output: D / 16 m-tiles
//   of 4, two products each. Thread (g, t) takes output dims g * D / 8 ..
//   + D / 8 - 1 (m-tile mt: rows g and g + 8 are dims g * D / 8 + 2 mt and
//   + 1), so its A fragments (keys 2t, 2t + 1, 2t + 8, 2t + 9) come from
//   the 16 (d 64: 8) bytes of those four key rows at its dims, one load a
//   row, paired by PRMT before the widening.
// The K scale multiplies the f32 score column before the mask and the
// max; the V scale folds into p after l has summed it (JAX's order). A
// tile that ends inside it zeroes its V rows past the end, so that a
// masked key adds 0 and never 0 * NaN.
template <int D, int G, class KV, bool kWindow>
__global__ void __launch_bounds__(kThreads, LayoutQ<D>::kMinBlocks)
    flash_decode_q_sm90_kernel(const __grid_constant__ CUtensorMap k_map,
                               const __grid_constant__ CUtensorMap v_map,
                               const Params p, int* __restrict__ counters) {
  using L = LayoutQ<D>;
  static_assert(G <= 8, "the group's rows are the 8 columns of P^T");
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];  // full, empty
  __shared__ float sh_m[kWarps][G];
  __shared__ float sh_l[kWarps][G];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const auto k_s = [&](int st) { return base + L::kStageBytes * st; };
  const auto v_s = [&](int st) { return k_s(st) + L::kTileBytes; };
  const auto scales = [&](int st) {  // K's 64, then V's
    return reinterpret_cast<float*>(base_ptr + L::kStageBytes * st + L::kScaleOff);
  };
  const auto full_bar = [&](int st) { return smem_u32(&bars[st]); };
  const auto empty_bar = [&](int st) { return smem_u32(&bars[kStages + st]); };

  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int len = min(max(p.lengths[b], 0), p.s);  // lengths above S count as S
  const int start = split * p.block_s;
  int s0, e0, s1, e1;
  window_ranges<kWindow>(start, min(start + p.block_s, len), len, p.window,
                         p.sinks, s0, e0, s1, e1);
  const int n0 = s0 < e0 ? (e0 - s0 + kTile - 1) / kTile : 0;
  const int n_tiles = n0 + (s1 < e1 ? (e1 - s1 + kTile - 1) / kTile : 0);
  const auto tile_key = [&](int it) {
    return it < n0 ? s0 + it * kTile : s1 + (it - n0) * kTile;
  };
  const size_t bh = (size_t)b * p.hkv + kvh;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
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
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages;
      const int key0 = tile_key(it);
      float sk[2], sv[2];  // in flight while the wait passes
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int key = key0 + lane + 32 * u;
        sk[u] = key < len ? __ldg(ks_bh + key) : 0.f;
        sv[u] = key < len ? __ldg(vs_bh + key) : 0.f;
      }
      // the stage's previous tile released by every consumer warp (the
      // first round passes at once)
      mbar_wait(empty_bar(st), ((it / kStages) & 1) ^ 1);
      float* const sc = scales(st);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        sc[lane + 32 * u] = sk[u];
        sc[kTile + lane + 32 * u] = sv[u];
      }
      __syncwarp();
      if (lane == 0) {
        mbar_expect_tx(full_bar(st), 2 * L::kTileBytes);
        tma_load(k_s(st), &k_map, full_bar(st), 0, key0, (int)bh);
        tma_load(v_s(st), &v_map, full_bar(st), 0, key0, (int)bh);
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;  // this thread's fragment row and pair
  const int w16 = warp * 16;             // the warp's keys in a tile
  float m = kNegInf, l = 0.f;  // row g over this warp's keys (l: this thread's)
  // O^T, m-tile mt: (row 2t, dim pd), (2t + 1, pd), (2t, pd + 1), (2t + 1,
  // pd + 1), pd = g * D / 8 + 2 mt
  float acc[D / 16][4];
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt) acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;

  if (n_tiles > 0) {
    // q row g's A fragments (rows 8..15 and rows >= G zero), column c's
    // dims 4t, 4t + 1 | 4t + 2, 4t + 3
    const __nv_bfloat16* q_g = p.q + bh * G * D;
    uint32_t qa[D / 16][2];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const uint2 x = g < G ? *reinterpret_cast<const uint2*>(q_g + g * D + c * 16 + 4 * t)
                            : make_uint2(0u, 0u);
      qa[c][0] = x.x;
      qa[c][1] = x.y;
    }
    const int vcol = g * (D / 8);  // this thread's output dims and V bytes
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages;
      const int end = it < n0 ? e0 : e1;
      const int key0 = tile_key(it);
      mbar_wait(full_bar(st), (it / kStages) & 1);
      // the warp's K fragments (matrix i: keys (i % 2) * 8.., column
      // 2 c2 + i / 2), its four V rows' bytes and its keys' scales
      uint32_t kr[D / 32][4];
#pragma unroll
      for (int c2 = 0; c2 < D / 32; ++c2) {
        ldsm_x4(kr[c2], byte_addr<D>(k_s(st), w16 + lane / 8 % 2 * 8 + lane % 8,
                                     (2 * c2 + lane / 16) * 16));
      }
      uint32_t vw[4][D / 32];  // keys 2t, 2t + 1, 2t + 8, 2t + 9
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint8_t* src =
            base_ptr + (byte_addr<D>(v_s(st), w16 + 2 * t + i % 2 + i / 2 * 8,
                                     vcol & ~15) - base) + vcol % 16;
        if constexpr (D == 128) {
          const uint4 x = *reinterpret_cast<const uint4*>(src);
          vw[i][0] = x.x;
          vw[i][1] = x.y;
          vw[i][2] = x.z;
          vw[i][3] = x.w;
        } else {
          const uint2 x = *reinterpret_cast<const uint2*>(src);
          vw[i][0] = x.x;
          vw[i][1] = x.y;
        }
      }
      const float* const sc = scales(st);
      float2 ks[2], vs[2];  // keys w16 + j * 8 + 2t + e
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        ks[j] = *reinterpret_cast<const float2*>(sc + w16 + j * 8 + 2 * t);
        vs[j] = *reinterpret_cast<const float2*>(sc + kTile + w16 + j * 8 + 2 * t);
      }

      // S = Q K^T over the warp's keys w16 + j * 8 + 2t + e
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int c2 = 0; c2 < D / 32; ++c2) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 2 * c2 + h;
          const uint32_t a[4] = {qa[c][0], 0u, qa[c][1], 0u};
          uint32_t b0, b1;
          widen4<KV>(kr[c2][2 * h], b0, b1);
          mma_16816(s[0], a, b0, b1);
          widen4<KV>(kr[c2][2 * h + 1], b0, b1);
          mma_16816(s[1], a, b0, b1);
        }
      }
      // the tile's softmax for row g over the warp's 16 keys: the K scale
      // on the score column, one max (the quad's four threads hold it), one
      // rescale, one exp2 a key
      const int kb = key0 + w16 + 2 * t;
      float z[2][2], mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float k_sc = e ? ks[j].y : ks[j].x;
          z[j][e] = kb + j * 8 + e < end ? s[j][e] * (p.scale_log2 * k_sc) : kNegInf;
          mx = fmaxf(mx, z[j][e]);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m, mx);
      const float corr = exp2f(m - m_new);
      float pr[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // a masked key adds nothing, even while m_new is kNegInf
          pr[j][e] = kb + j * 8 + e < end ? exp2f(z[j][e] - m_new) : 0.f;
        }
      }
      l = l * corr + (pr[0][0] + pr[0][1]) + (pr[1][0] + pr[1][1]);
      m = m_new;
      // P^T's B fragments (keys 2t, 2t + 1 | 2t + 8, 2t + 9 of row g), the
      // V scale folded in after l, as a bf16 hi + lo pair
      uint32_t p_hi[2], p_lo[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        split_bf16(pr[j][0] * vs[j].x, pr[j][1] * vs[j].y, p_hi[j], p_lo[j]);
      }
      // the rescale of rows 2t and 2t + 1, held by lanes 8t and 8t + 4
      const float ca = __shfl_sync(0xffffffffu, corr, 8 * t);
      const float cb = __shfl_sync(0xffffffffu, corr, 8 * t + 4);
      if (key0 + kTile > end) {  // the tile ends inside it: no bytes past it
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (key0 + w16 + 2 * t + i % 2 + i / 2 * 8 >= end) {
#pragma unroll
            for (int x = 0; x < D / 32; ++x) vw[i][x] = 0u;
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < D / 16; ++mt) {
        acc[mt][0] *= ca;
        acc[mt][1] *= cb;
        acc[mt][2] *= ca;
        acc[mt][3] *= cb;
        // bytes 2 mt and 2 mt + 1 of each row's D / 8: (key 2t, 2t + 1)
        // pairs of dims pd and pd + 1, then (2t + 8, 2t + 9)
        const uint32_t sel = mt % 2 ? 0x7362u : 0x5140u;
        uint32_t a[4];
        widen4<KV>(__byte_perm(vw[0][mt / 2], vw[1][mt / 2], sel), a[0], a[1]);
        widen4<KV>(__byte_perm(vw[2][mt / 2], vw[3][mt / 2], sel), a[2], a[3]);
        mma_16816(acc[mt], a, p_hi[0], p_hi[1]);
        mma_16816(acc[mt], a, p_lo[0], p_lo[1]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar(st));  // this warp is done with it
    }
  }

  // the warps' states into shared memory (the ring's, free once every
  // warp has left the loop), then the bf16 kernel's end
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  float* const sh_acc = reinterpret_cast<float*>(base_ptr);
  fkp_sm90::named_sync(1, kConsumers);
  if (g < G && t == 0) {
    sh_m[warp][g] = m;
    sh_l[warp][g] = l;
  }
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt) {
    const int pd = g * (D / 8) + 2 * mt;
    if (2 * t < G) {
      *reinterpret_cast<float2*>(sh_acc + (warp * G + 2 * t) * D + pd) =
          make_float2(acc[mt][0], acc[mt][2]);
    }
    if (2 * t + 1 < G) {
      *reinterpret_cast<float2*>(sh_acc + (warp * G + 2 * t + 1) * D + pd) =
          make_float2(acc[mt][1], acc[mt][3]);
    }
  }
  fkp_sm90::named_sync(1, kConsumers);
  finish<D, G>(p, split, bh, sh_m, sh_l, sh_acc, counters);
}

// the call's shape as the kernels take it, or false
inline bool valid(int b, int hq, int hkv, int s, int n_splits, int block_s) {
  return b > 0 && hkv > 0 && hq % hkv == 0 && s > 0 && n_splits > 0 &&
         block_s > 0 && b <= 65535 && hkv <= 65535;
}

// Launches the 8-bit instance <D, G, KV, kWindow> on a grid of (n_splits,
// hkv, b); returns a CUDA error code (the shared-memory attribute's,
// cudaErrorInvalidValue where a map cannot be encoded, else
// cudaGetLastError() after the launch).
template <int D, int G, class KV, bool kWindow>
int launch_q(const Params& p, const void* k, const void* v, int b,
             int* counters, cudaStream_t stream) {
  const auto kernel = &flash_decode_q_sm90_kernel<D, G, KV, kWindow>;
  constexpr int kBytes = LayoutQ<D>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
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
  kernel<<<dim3(p.n_splits, p.hkv, b), kThreads, kBytes, stream>>>(km, vm, p,
                                                                   counters);
  return static_cast<int>(cudaGetLastError());
}

// launch(D, G, kWindow) with each an std::integral_constant, for d (64,
// 128), g (1, 2, 4, 8) and the window (> 0: the band's instance); returns
// its result, or cudaErrorInvalidValue for another d or g. The bf16 and
// the 8-bit entries pick their instance by it.
template <class Launch>
int by_shape(int d, int g, int window, Launch&& launch) {
  const auto by_window = [&](auto dc, auto gc) {
    return window > 0 ? launch(dc, gc, std::true_type{})
                      : launch(dc, gc, std::false_type{});
  };
  const auto by_group = [&](auto dc) {
    switch (g) {
      case 1: return by_window(dc, std::integral_constant<int, 1>{});
      case 2: return by_window(dc, std::integral_constant<int, 2>{});
      case 4: return by_window(dc, std::integral_constant<int, 4>{});
      case 8: return by_window(dc, std::integral_constant<int, 8>{});
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  };
  if (d == 64) return by_group(std::integral_constant<int, 64>{});
  if (d == 128) return by_group(std::integral_constant<int, 128>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// The 8-bit instance of KV for the call's d, g and window (by_shape).
// flash_decode_q.cu builds the int8 instances, flash_decode_q_fp8.cu the
// e4m3 ones.
template <class KV>
int launch_q_any(int d, int g, const Params& p, const void* k, const void* v,
                 int b, int* counters, cudaStream_t stream) {
  return by_shape(d, g, p.window, [&](auto dc, auto gc, auto wc) {
    return launch_q<decltype(dc)::value, decltype(gc)::value, KV,
                    decltype(wc)::value>(p, k, v, b, counters, stream);
  });
}

int launch_e4m3(int d, int g, const Params& p, const void* k, const void* v,
                int b, int* counters, cudaStream_t stream);  // flash_decode_q_fp8.cu

}  // namespace fkp_dec90
