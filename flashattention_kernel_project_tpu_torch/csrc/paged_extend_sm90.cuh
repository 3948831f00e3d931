// The paged extend for Hopper (sm_90a): the T chunk tokens of each
// sequence against its page pool, split over the pages, with 64-key K/V
// tiles brought by TMA boxes that follow the block table into a ring, both
// products on the tensor cores, and the splits merged on the card.
// paged_extend.cu builds the bf16 instances and the C entries,
// paged_extend_q.cu the 8-bit ones (int8 and e4m3). The paged decode is
// the same block at T = 1 (paged_decode_sm90_kernel below, built by
// paged_decode*.cu, whose head says what it replaces): its G query rows
// are one 16-row slab, its mask j < len needs no old_lens (null), and it
// adds the ring's depth as a template argument, the int8 score product
// (kQInt8) and the copy probe (kCopy).
//
// Replaces flashattention_kernel_project_tpu/ops/paged_decode.py::
// _paged_extend_kernel (:397, pallas_call :568), reached through
// paged_flash_extend (:486) over a bf16 pool, and its quant=True flavour
// over an int8 or e4m3 pool with lane-major f32 scale pages [n_pages, Hkv,
// 1, page] (the K scale on the score row, the V scale folded into the exp
// weights, :408-415, :439-448, :470), read in place through the table.
// q is [B, Hq, T, D] with the chunk already appended to the pages: chunk
// token tr of row b sits at position old_len[b] + tr and sees the keys
// j < new_len[b] with j <= old_len[b] + tr. As the TPU kernel does, the
// GQA group and the chunk fold into the query rows of one KV head: row
// gi * T + tr holds q head kvh * G + gi and chunk token tr, and the q block
// of a (batch row, KV head) is contiguous in [B, Hkv, G * T, D]. Only the
// pages below new_len[b] are read: dead table entries cost nothing.
//
// What bounds it on the H100: bytes. Each live key costs 4 * d bytes of K
// and V in bf16 (2 * d + 8 in 8 bits) and 4 * G * T * d flops, so at most
// about 2 * G * T flops a byte (40 at the serving verify, G 4 and T 5), far
// under the ~295 flop/byte ridge: the 3.35 TB/s of HBM is the roof. What
// counts is having enough bytes in flight on every SM, few instructions a
// key, and enough blocks at a batch of 8 sequences. What the design does
// about it:
// - Splits over the keys, sized to fill the card by the wrapper
//   (ops/paged_decode.py::extend_n_splits: whole 64-key tiles, at least two
//   a split, as many as bring B * Hkv * row tiles blocks to 132 SMs times
//   the blocks an SM holds, at most kMaxSplits; one where the pairs fill
//   the card). The rule reads the table's capacity, never the lengths,
//   which stay on the device: at the serving verify (B 8, Hkv 4, pages of
//   128, 16 a row) 8 splits of 256 keys, 256 blocks. A split with no live
//   key loads nothing.
// - TMA boxes that follow the block table. A producer warp, one thread of
//   which issues the loads, reads each tile's table entries and brings its
//   K and V rows as boxes of gcd(page, 64) rows (64 at pages of 64 and 128,
//   32 at 32 and 96, else 16), each at its page's row, from 3-D maps over
//   the pool seen as [n_pages * Hkv, page, D], into a ring of 3 stages
//   tracked by full and empty mbarriers. Every box lands 1024-byte aligned,
//   so the boxes of a tile make one 64-row tile of the 128B swizzle. Boxes
//   at or past new_len are not issued (the unissued rows of a bf16 tile's
//   V are zeroed once, so that a masked key adds 0 and never 0 * NaN); the
//   rows of a live box past new_len or past a row's causal bound are masked
//   in the scores. The 8-bit pool's boxes are whole rows of D bytes,
//   unswizzled, with the scale rows of the same table entries beside them
//   (1-D bulk copies of the box's scales).
// - 8-bit tiles widen in shared memory: after a stage lands, the consumer
//   warps widen its K and V bytes exactly to bf16 (e4m3 by widen.cuh, int8
//   by a PRMT and an FADD a value, below) into one swizzled bf16 tile,
//   zero at keys past new_len, with the tile's scales, release the stage to
//   the producer, and run the bf16 products on the widened tile, while the
//   next stages load. With one slab (16 rows: the decode) each warp widens
//   the 16 keys it alone reads and waits on no other warp; with more slabs
//   the warps share every key and widen the tile together between two
//   consumer barriers.
// - Folded rows as the A operand of mma.sync m16n8k16, in 16-row slabs,
//   kRows = 16, 32 or 64 rows a block (the wrapper picks the fewest slabs
//   that hold G * T rows, up to 4; more rows take more row tiles in the
//   grid, e.g. G 8 and T 9 two of 64); the block's rows of q are staged
//   once in shared memory, swizzled, and each tile reads its A fragments
//   there (held in registers for the whole loop they spilled). The 4
//   consumer warps share each 64-key tile: with one slab each warp takes
//   16 of its keys (the linear decode's layout), with two slabs two warps
//   a slab take 32 keys each, with three or four one warp a slab takes all
//   64 (at three the fourth warp's rows are padding and it skips the
//   products). Rows past G * T load zeros and write nothing. A tile's
//   scores are f32, scaled in the log2 domain after the product (the 8-bit
//   K scale with them), one max a row and tile, one rescale, one exp2 a
//   (row, key); p enters P V as a bf16 hi + lo pair (about 16 bits of p,
//   the port's precision, ROADMAP.md section C). The warps of a slab merge
//   their (m, l, acc) through shared memory after the loop.
// - The merge on the card, one launch a call. Only the splits that start
//   below new_len run (the blocks of the others exit at once). With one
//   such split the block normalises its rows and writes them in bf16.
//   With more, each of their blocks writes its f32 partials (m in
//   natural-log units, l, y; m = NEG_INF and l = 0 for a row with no live
//   key in the split, which may be a row whose causal bound lies before
//   the split while the chunk's last token sees it) to a workspace, and the
//   last of them for a (batch row, KV head, row tile) to arrive, by an
//   atomic counter, merges them (a split with l = 0 weighs exactly 0) and
//   resets the counter to 0. The counters are a zero-initialised device
//   array of the library (paged_extend.cu's, not the linear decode's), so
//   a launch needs no memset and a CUDA graph replays it as it is. Two
//   launches running at once on two streams of one device would share
//   them: the callers run one extend at a time a device.
// - Registers: at most 200 a thread (__maxnreg__), so that two blocks of
//   five warps share an SM (one block at 64 rows: 255).

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

namespace fkp_ext90 {

using fkp_mma::mma_16816;
using fkp_mma::pack_bf16;
using fkp_mma::split_bf16;
using fkp_sm90::bulk_load;
using fkp_sm90::kBoxCols;
using fkp_sm90::mbar_arrive;
using fkp_sm90::mbar_expect_tx;
using fkp_sm90::mbar_init;
using fkp_sm90::mbar_wait;
using fkp_sm90::named_sync;
using fkp_sm90::smem_u32;
using fkp_sm90::tma_load;

constexpr float kNegInf = -1e30f;  // finite, as NEG_INF in ops/softmax.py
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTile = 64;                  // keys a tile
constexpr int kStages = 3;                 // the extend's ring depth
constexpr int kWarps = 4;                  // consumer warps
constexpr int kConsumers = kWarps * 32;
constexpr int kThreads = kConsumers + 32;  // and the producer warp
// arrival counters, one a (batch row, KV head, row tile): a call with more
// splits than one takes at most this many
constexpr int kMaxCounters = 1 << 18;
constexpr int kMaxSplits = 64;             // splits a call takes
constexpr int kMinPage = 16;               // pages of 16 to 128 rows in steps of 16
constexpr int kMaxPage = 128;
constexpr int kDecodeRows = 16;            // the decode's block: one slab of G rows

// What a block computes: attention (the extend, and the decode over a bf16
// or 8-bit pool), the decode's int8 score product over an int8 pool
// (q_int8), or the decode's copy probe (copy_only, bf16).
enum Mode : int { kAttend = 0, kQInt8 = 1, kCopy = 2 };

// The cache a block reads: a page pool through the block table, or a
// linear cache [b * hkv, s_max, D] (the ragged forward's slab route), as
// the causal online unbanded call (kLinearPlain: the linear speculative
// verify) or with causal, the band and fixed-max as runtime arguments
// (kLinearGeneral). As runtime arguments in every linear instance they
// cost the verify 39% (0.0230 ms against 0.0165, tools/ab_ragged.py).
enum Cache : int { kPaged = 0, kLinearPlain = 1, kLinearGeneral = 2 };

// Shared memory of the (D, kRows, KV, kDepth) instances: the ring's kDepth stages (a
// bf16 stage: K then V, each D / 64 boxes of 64 rows x 128 bytes; an 8-bit
// stage: K and V rows of D bytes, then their 64 + 64 f32 scales, rounded
// to 1 KB), the widened bf16 K and V tile of the 8-bit instances, the
// block's kRows rows of Q (bf16, in the same swizzled boxes of kRows
// rows; under kQInt8 the int8 rows, [kRows][D]), after up to 1 KB of
// alignment slack. After the key loop the ring holds the warps'
// accumulators ([kWarps][16][kAccStride] f32), then the split merge's
// weights and sums of l ([2][kMaxSplits][64] f32).
template <int D, int kRows, class KV, int kDepth = kStages>
struct Layout {
  static constexpr bool kQuant = sizeof(KV) == 1;
  static constexpr int kTileBytes = kTile * D * (int)sizeof(KV);  // K or V
  static constexpr int kScaleBytes = kQuant ? 2 * kTile * 4 : 0;
  static constexpr int kStageBytes =
      (2 * kTileBytes + kScaleBytes + 1023) / 1024 * 1024;
  static constexpr int kWideBytes = kQuant ? 2 * kTile * D * 2 : 0;
  static constexpr int kAccStride = D + 4;  // floats, off the banks' period
  static constexpr int kRing = kDepth * kStageBytes + kWideBytes;
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kMerge = kWarps * 16 * kAccStride * 4 > 2 * kMaxSplits * 64 * 4
                                    ? kWarps * 16 * kAccStride * 4
                                    : 2 * kMaxSplits * 64 * 4;
  static_assert(kRing >= kMerge, "the merge reuses the ring");
  static constexpr int kBytes = 1024 + kRing + kQBytes;
  // blocks an SM holds: two, but one for 64 rows (their 64 keys a warp
  // need more than two blocks' registers); and the registers a thread
  // that allows (two blocks of five warps: 200; __launch_bounds__ with a
  // minimum of two blocks gave ptxas 168, and the 8-bit instances spilled)
  static constexpr int kMinBlocks = kRows == 64 ? 1 : 2;
  static constexpr int kMaxRegs = kMinBlocks == 2 ? 200 : 255;
};

// What a launch takes besides the two TMA maps. q [b, hkv, rows, D] bf16
// (the folded group: rows = G * T); tables [b, max_pages]; new_lens,
// old_lens [b]; k_scale, v_scale the 8-bit scale pools (null for bf16);
// m, l [pairs, n_splits, kRows] and y [pairs, n_splits, kRows, D] f32 the
// splits' partials, pairs = b * hkv * row_tiles (row tile the fastest);
// out [b, hkv, rows, D] bf16, or null (partials only). The decode passes
// t = 1 and old_lens null: its rows see the keys j < new_len.
struct Params {
  const __nv_bfloat16* q;
  const int* tables;
  const int* new_lens;
  const int* old_lens;
  const float* k_scale;
  const float* v_scale;
  float* m;
  float* l;
  float* y;
  __nv_bfloat16* out;
  int hkv, t, rows, row_tiles, page, max_pages, n_splits, block_s, box_rows;
  float scale_log2;
  // the linear cache's ragged forward in its general instances
  // (kLinearGeneral) alone: causal or not, the band (window > 0: the last
  // `window` positions and the first `sinks` keys), fixed-max (m pinned at
  // 0)
  int causal, window, sinks, fixed;
};

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
// multiple of 8) of a bf16 tile of kRows rows at `tile` (K and V: 64):
// boxes of 64 columns, one after the other, each kRows rows of 128 bytes
// in which 16-byte chunk x of row r lies at chunk x ^ (r % 8) (the 128B
// swizzle; a TMA box of 16 or 32 rows at a 1024-byte boundary keeps the
// pattern).
template <int kRows = kTile>
__device__ __forceinline__ uint32_t tile_addr(uint32_t tile, int r, int c) {
  return tile + (c / kBoxCols) * (kRows * 128) + r * 128 +
         ((((c % kBoxCols) / 8) ^ (r % 8)) << 4);
}

// The 8-bit K tile of the int8 score product (kQInt8) lands by TMA in
// the 128B swizzle (D = 128: 16-byte chunk x of row r at x ^ (r % 8)) or
// the 64B one (D = 64: at x ^ (r / 2 % 4)), so that ldmatrix reads 8 key
// rows of one 16-byte column without bank conflicts: the shared address of
// bytes (row r, c..c+15) of the stage's K tile at `tile`.
template <int D>
__device__ __forceinline__ uint32_t k8_addr(uint32_t tile, int r, int c) {
  const uint32_t off = r * D + c;
  return tile + (off ^ (((off >> 7) & (D == 128 ? 7u : 3u)) << 4));
}

// One block per (split, KV head x row tile, batch row): threads 0..127 are
// the consumer warps, 128..159 the producer warp. kRows: the folded rows a
// block holds (16, 32 or 64), which is also the keys a warp takes of each
// tile. kDepth: the ring's stages. Maps: k and v over the pool as
// [n_pages * hkv, page, D] in boxes of box_rows rows (bf16: x 64 dims,
// 128B-swizzled; 8-bit: x D bytes, K swizzled under kQInt8 (k8_addr)).
// counters: kMaxCounters ints, 0 between launches (read only when out is
// set and n_splits > 1). kQInt8 (int8 pool, the decode): the block's q
// rows quantized to int8 in the log2 domain, one scale a row, and the
// scores as int8 mma.sync m16n8k32 products over the stage's K bytes,
// never widened ((f32(dot) * ks[j]) * qs in log2 units); V widens as in
// the 8-bit instances. kCopy (bf16, the decode's copy probe, partials
// only): the same loads and no math; each split with a live key gives
// y[r] = k + v in f32 at its first key row + r, m = l = 0 (0 rows at a
// split with none).
template <int D, int kRows, class KV, int kDepth, int kMode,
          int kCache = kPaged>
__device__ __forceinline__ void paged_block(const CUtensorMap* k_map,
                                            const CUtensorMap* v_map,
                                            const Params& p,
                                            int* __restrict__ counters) {
  using L = Layout<D, kRows, KV, kDepth>;
  constexpr bool kQuant = L::kQuant;
  constexpr bool kQi8 = kMode == kQInt8;
  static_assert(!kQi8 || std::is_same_v<KV, int8_t>,
                "the int8 score product reads an int8 pool");
  static_assert(kMode != kCopy || !kQuant, "the copy probe reads a bf16 pool");
  // (the decode's modes hold one slab, so every warp runs the products)
  static_assert(kMode == kAttend || kRows == kDecodeRows, "a decode mode");
  constexpr int kSlabWarps = kTile / kRows;  // warps that share a slab's keys
  constexpr int kNt = kRows / 8;             // 8-key n-tiles a warp a tile
  // one slab: each warp alone reads its 16 keys of a tile, and widens them
  // itself
  constexpr bool kWarpWiden = kSlabWarps == kWarps;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kDepth];  // full, empty
  __shared__ float sh_m[kWarps][16];
  __shared__ float sh_l[kWarps][16];
  __shared__ float sh_lsum[kRows];
  __shared__ float sh_sc[2][kQuant ? kTile : 1];  // the widened tile's K, V scales
  __shared__ float sh_qs[kQi8 ? kRows : 1];       // kQInt8: the rows' q scales
  __shared__ int sh_last;
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const auto k_s = [&](int st) { return base + L::kStageBytes * st; };
  const auto v_s = [&](int st) { return k_s(st) + L::kTileBytes; };
  const auto sc_s = [&](int st) { return v_s(st) + L::kTileBytes; };
  const uint32_t wide = base + kDepth * L::kStageBytes;  // 8-bit: K, then V
  const uint32_t q_s = base + L::kRing;                  // the block's Q rows
  const auto full_bar = [&](int st) { return smem_u32(&bars[st]); };
  const auto empty_bar = [&](int st) { return smem_u32(&bars[kDepth + st]); };

  const int split = blockIdx.x;
  const int kvh = blockIdx.y / p.row_tiles;
  const int rt = blockIdx.y % p.row_tiles;
  const int b = blockIdx.z;
  // the live keys: below new_len (a length past the table's capacity
  // counts as the capacity), in this split; a decode's row (old_lens null)
  // sits at new_len - 1 and sees them all
  const int nl = min(max(p.new_lens[b], 0), p.max_pages * p.page);
  const int old = p.old_lens != nullptr ? p.old_lens[b] : nl - 1;
  const int start = split * p.block_s;
  int end = min(start + p.block_s, nl);
  // a linear cache (the slab route); its general instances read causal,
  // the band and fixed-max from the Params
  constexpr bool kLinear = kCache != kPaged;
  constexpr bool kRuntime = kCache == kLinearGeneral;
  // kLinear, causal: no row of the call sees a key past the last chunk
  // token's position
  if (kLinear && (!kRuntime || p.causal)) end = min(end, old + p.t);
  const int n_tiles = end > start ? (end - start + kTile - 1) / kTile : 0;
  // the tiles the block visits, the same list for the producer and the
  // consumers: the split's n_tiles, but with a band (kRuntime, window > 0)
  // its sink tiles and then its tiles from the one holding chunk token 0's
  // first band key (a split with neither loads nothing)
  int n_sink = n_tiles, first_band = n_tiles;
  if constexpr (kRuntime) {
    if (p.window > 0) {
      n_sink = min(max((p.sinks - start + kTile - 1) / kTile, 0), n_tiles);
      first_band = max(min(max(old - p.window + 1 - start, 0) / kTile, n_tiles),
                       n_sink);
    }
  }
  const int n_visit = n_sink + n_tiles - first_band;
  const auto tile_of = [&](int it) {
    return it < n_sink ? it : first_band + it - n_sink;
  };
  // the splits that start below new_len: with the output, only they run
  // (the rest exit at once), and with at most one the first block writes
  // the rows itself (zeros where new_len is 0)
  const int n_live = min(p.n_splits, (nl + p.block_s - 1) / p.block_s);
  if (p.out != nullptr && split >= max(n_live, 1)) return;
  const size_t bh = (size_t)b * p.hkv + kvh;
  const size_t pair = bh * p.row_tiles + rt;
  const size_t part = pair * p.n_splits + split;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int st = 0; st < kDepth; ++st) {
      mbar_init(full_bar(st), 1);
      mbar_init(empty_bar(st), kWarps);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (!kQuant && !kLinear) {
    // a last tile with unissued boxes: zero its stage's V, so that those
    // rows (weighted 0) cannot bring NaN bits into P V; earlier tiles of
    // the stage, if any, overwrite it with pool rows
    const int key_last = start + (n_tiles - 1) * kTile;
    if (n_tiles > 0 && tid < kConsumers &&
        (end - key_last + p.box_rows - 1) / p.box_rows * p.box_rows < kTile) {
      uint4* v0 = reinterpret_cast<uint4*>(
          base_ptr + (v_s((n_tiles - 1) % kDepth) - base));
      for (int i = tid; i < L::kTileBytes / 16; i += kConsumers) {
        v0[i] = make_uint4(0u, 0u, 0u, 0u);
      }
      fkp_sm90::fence_proxy_async();  // before the TMA writes there
    }
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp: one thread loads
    if constexpr (kLinear) {
      // the linear cache [b * hkv, s_max, D]: a tile is one box of 64 rows
      // at row key0 of the (b, kvh) plane (rows past s_max read as zeros),
      // no table. 8-bit: the warp's lanes read the tile's 64 + 64 scales
      // (0 past new_len) into the stage beside it before the first lane's
      // arrival (the scale rows are not 16-byte aligned for a bulk copy
      // unless s_max is a multiple of 4)
      const int lane = tid % 32;
      if (!kQuant && lane != 0) return;
      const int head = b * p.hkv + kvh;
      for (int it = 0; it < n_visit; ++it) {
        const int st = it % kDepth;
        const int key0 = start + tile_of(it) * kTile;
        [[maybe_unused]] float sk[2], sv[2];
        if constexpr (kQuant) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int key = key0 + lane + 32 * u;
            const size_t at = bh * p.page + key;  // page = s_max
            sk[u] = key < nl ? __ldg(p.k_scale + at) : 0.f;
            sv[u] = key < nl ? __ldg(p.v_scale + at) : 0.f;
          }
        }
        mbar_wait(empty_bar(st), ((it / kDepth) & 1) ^ 1);
        if constexpr (kQuant) {
          float* const sc = reinterpret_cast<float*>(base_ptr + (sc_s(st) - base));
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            sc[lane + 32 * u] = sk[u];
            sc[kTile + lane + 32 * u] = sv[u];
          }
          __syncwarp();
        }
        if (lane == 0) {
          mbar_expect_tx(full_bar(st), kTile * 2 * D * (int)sizeof(KV));
          if constexpr (kQuant) {
            tma_load(k_s(st), k_map, full_bar(st), 0, key0, head);
            tma_load(v_s(st), v_map, full_bar(st), 0, key0, head);
          } else {
#pragma unroll
            for (int x = 0; x < D / kBoxCols; ++x) {
              tma_load(k_s(st) + x * (kTile * 128), k_map, full_bar(st),
                       x * kBoxCols, key0, head);
              tma_load(v_s(st) + x * (kTile * 128), v_map, full_bar(st),
                       x * kBoxCols, key0, head);
            }
          }
        }
      }
    } else if (tid == kConsumers) {
      const int* table = p.tables + (size_t)b * p.max_pages;
      const int boxes = kTile / p.box_rows;
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kDepth;
        // the stage's previous tile released by every consumer warp (the
        // first round passes at once)
        mbar_wait(empty_bar(st), ((it / kDepth) & 1) ^ 1);
        const int key0 = start + it * kTile;
        const int live = min(boxes, (end - key0 + p.box_rows - 1) / p.box_rows);
        mbar_expect_tx(full_bar(st), live * p.box_rows *
                                         (2 * D * (int)sizeof(KV) + (kQuant ? 8 : 0)));
        for (int i = 0; i < live; ++i) {
          const int key = key0 + i * p.box_rows;
          const int head = __ldg(table + key / p.page) * p.hkv + kvh;
          const int row = key % p.page;
          if constexpr (kQuant) {
            const uint32_t off = i * p.box_rows * D;
            tma_load(k_s(st) + off, k_map, full_bar(st), 0, row, head);
            tma_load(v_s(st) + off, v_map, full_bar(st), 0, row, head);
            const size_t s_off = (size_t)head * p.page + row;
            bulk_load(sc_s(st) + i * p.box_rows * 4, p.k_scale + s_off,
                      p.box_rows * 4, full_bar(st));
            bulk_load(sc_s(st) + (kTile + i * p.box_rows) * 4, p.v_scale + s_off,
                      p.box_rows * 4, full_bar(st));
          } else {
#pragma unroll
            for (int x = 0; x < D / kBoxCols; ++x) {
              const uint32_t off = x * (kTile * 128) + i * p.box_rows * 128;
              tma_load(k_s(st) + off, k_map, full_bar(st), x * kBoxCols, row,
                       head);
              tma_load(v_s(st) + off, v_map, full_bar(st), x * kBoxCols, row,
                       head);
            }
          }
        }
      }
    }
    return;
  }

  const int warp = tid / 32;
  const int lane = tid % 32;
  if constexpr (kMode == kCopy) {
    // the copy probe: wait for each tile and release it; the first holds
    // the split's key rows start + r (r < rows < 16 <= box_rows: its first
    // box, always issued), read whole, past new_len or not
    float* const y_p = p.y + part * kRows * D;
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kDepth;
      mbar_wait(full_bar(st), (it / kDepth) & 1);
      if (it == 0) {
        for (int i = tid; i < p.rows * D; i += kConsumers) {
          const int r = i / D, c = i % D;
          const auto at = [&](uint32_t t) {
            return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                base_ptr + (tile_addr(t, r, c - c % 8) - base) + (c % 8) * 2));
          };
          y_p[i] = at(k_s(0)) + at(v_s(0));
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar(st));
    }
    if (n_tiles == 0) {
      for (int i = tid; i < p.rows * D; i += kConsumers) y_p[i] = 0.f;
    }
    if (tid < p.rows) p.m[part * kRows + tid] = p.l[part * kRows + tid] = 0.f;
    return;
  }
  const int g = lane / 4, quad = lane % 4;  // this thread's C rows g, g + 8 and pair
  const int slab = warp / kSlabWarps;
  const int key_off = (warp % kSlabWarps) * kRows;  // the warp's keys in a tile
  // this thread's folded rows and the end of each one's keys in the split
  // (its causal bound old_len + tr; padding rows see none)
  const int r0 = rt * kRows + slab * 16 + g;
  const int r1 = r0 + 8;
  const bool causal = !kRuntime || p.causal;
  const int lim0 = r0 >= p.rows ? 0 : causal ? min(end, old + r0 % p.t + 1) : end;
  const int lim1 = r1 >= p.rows ? 0 : causal ? min(end, old + r1 % p.t + 1) : end;
  // kRuntime with a band: key j is in row r's band iff j > band(r) or
  // j < sinks (band(r) = its position - window)
  const bool banded = kRuntime && p.window > 0;
  const int band0 = banded ? old + r0 % p.t - p.window : -1;
  const int band1 = banded ? old + r1 % p.t - p.window : -1;
  const auto sees = [&](int key, int lim, int band) {
    if constexpr (kRuntime) {
      return key < lim && (key > band || key < p.sinks);
    } else {
      return key < lim;
    }
  };
  // kRuntime, fixed-max: m pinned at 0 for the row's whole life
  const bool fixed = kRuntime && p.fixed;
  const bool slab_live = rt * kRows + slab * 16 < p.rows;  // uniform in the warp

  float m0 = fixed ? 0.f : kNegInf, m1 = m0;  // rows g, g + 8 over the warp's keys
  float l0 = 0.f, l1 = 0.f;          // this thread's share of their sums
  float acc[D / 8][4];               // [.][0..1] row g, [.][2..3] row g + 8
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  if (n_visit > 0) {
    const __nv_bfloat16* q_bh = p.q + bh * p.rows * D;
    // kQInt8: this thread's A fragments of the int8 q rows (m16n8k32: rows
    // g and g + 8, bytes 4 quad.. and 16 + 4 quad.. of each 32-dim step)
    // and the two rows' scales
    [[maybe_unused]] uint32_t qa8[kQi8 ? D / 32 : 1][4];
    [[maybe_unused]] float qs0 = 0.f, qs1 = 0.f;
    if constexpr (kQi8) {
      // the rows quantized once, one warp a row, in the log2 domain as
      // JAX's wrapper does (paged_decode.py:1011-1024): qf = q * scale_log2,
      // s = max|qf| / 127 (1 where it is 0), round half to even, clip to
      // +-127; int8 rows [kRows][D] where the bf16 rows would lie
      int8_t* const q8 = reinterpret_cast<int8_t*>(base_ptr + (q_s - base));
      for (int r = warp; r < kRows; r += kWarps) {
        const int row = rt * kRows + r;
        float x[D / 32];
        float mx = 0.f;
#pragma unroll
        for (int i = 0; i < D / 32; ++i) {
          x[i] = row < p.rows
                     ? __bfloat162float(q_bh[(size_t)row * D + lane + 32 * i]) *
                           p.scale_log2
                     : 0.f;
          mx = fmaxf(mx, fabsf(x[i]));
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        }
        const float s = mx == 0.f ? 1.f : mx / 127.f;
#pragma unroll
        for (int i = 0; i < D / 32; ++i) {
          q8[r * D + lane + 32 * i] =
              static_cast<int8_t>(fminf(fmaxf(rintf(x[i] / s), -127.f), 127.f));
        }
        if (lane == 0) sh_qs[r] = s;
      }
      named_sync(1, kConsumers);
      const int ra = slab * 16 + g, rb = ra + 8;
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk) {
        const int c = kk * 32 + quad * 4;
        qa8[kk][0] = *reinterpret_cast<const uint32_t*>(q8 + ra * D + c);
        qa8[kk][1] = *reinterpret_cast<const uint32_t*>(q8 + rb * D + c);
        qa8[kk][2] = *reinterpret_cast<const uint32_t*>(q8 + ra * D + c + 16);
        qa8[kk][3] = *reinterpret_cast<const uint32_t*>(q8 + rb * D + c + 16);
      }
      qs0 = sh_qs[ra];
      qs1 = sh_qs[rb];
    } else {
      // the block's rows of the folded group into shared memory, zero past
      // it; each tile reads its A fragments from there (held in registers
      // for the whole loop, they spilled at 32 and 64 rows)
      for (int i = tid; i < kRows * D / 8; i += kConsumers) {
        const int r = i / (D / 8), c = i % (D / 8) * 8;
        const int row = rt * kRows + r;
        *reinterpret_cast<uint4*>(base_ptr + (tile_addr<kRows>(q_s, r, c) - base)) =
            row < p.rows
                ? *reinterpret_cast<const uint4*>(q_bh + (size_t)row * D + c)
                : make_uint4(0u, 0u, 0u, 0u);
      }
      named_sync(1, kConsumers);
    }
    for (int it = 0; it < n_visit; ++it) {
      const int st = it % kDepth;
      const int key0 = start + tile_of(it) * kTile;
      mbar_wait(full_bar(st), (it / kDepth) & 1);
      uint32_t kt = k_s(st), vt = v_s(st);
#if defined(FKP_DEC_PROBE) && FKP_DEC_PROBE == 2
      // a probe (tools/ab_paged_decode.py): the loads alone
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar(st));
      continue;
#endif
      if constexpr (kQuant) {
        // widen the stage's 8-bit K and V rows (kQInt8: V alone) into the
        // bf16 tile, zero at keys past new_len, and take the tile's scales;
        // then release the stage (kQInt8: after the scores, which read its
        // K). In one slab (16 rows) each warp widens the 16 keys it alone
        // reads, with no barrier but its own; with more slabs the warps
        // share every key and widen the tile together, between two
        // barriers (every warp done with the previous tile, then with
        // this one's widening)
        constexpr int kPieces = kTile * D / 16;  // 16-byte pieces of a tile
        constexpr int kFirst = kQi8 ? 1 : 0;     // K stays 8-bit under kQInt8
        constexpr int kPart = kWarpWiden ? 16 * D / 16 : kPieces;  // pieces a part
        const int part_tid = kWarpWiden ? lane : tid;
        if constexpr (kWarpWiden) {
          __syncwarp();  // every lane done with the previous tile's rows
        } else {
          named_sync(1, kConsumers);
        }
        const uint8_t* ring = base_ptr + (k_s(st) - base);
        // two pieces at a time (unrolled whole it spilled at 32 and 64 rows
        // and, at 16, ran the decode at 8192 keys 24% slower on an H100);
        // V alone (the int8 score product) unrolled whole, 11% faster there
        // (tools/ab_paged_decode.py)
        constexpr int kWidenUnroll = kQi8 ? 4 : 2;
#pragma unroll(kWidenUnroll)
        for (int k = 0; k < (2 - kFirst) * kPart / (kWarpWiden ? 32 : kConsumers);
             ++k) {
          const int i = part_tid + k * (kWarpWiden ? 32 : kConsumers);
          const int kv = kFirst + i / kPart;  // 0: K, 1: V
          const int r = (kWarpWiden ? key_off : 0) + i % kPart / (D / 16);
          const int c = i % (D / 16) * 16;
          uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
          if (key0 + r < nl) {
            fkp::widen16<KV>(*reinterpret_cast<const uint4*>(
                            ring + kv * L::kTileBytes + r * D + c),
                        lo, hi);
          }
          const uint32_t t0 = wide + kv * (kTile * D * 2);
          *reinterpret_cast<uint4*>(base_ptr + (tile_addr(t0, r, c) - base)) = lo;
          *reinterpret_cast<uint4*>(base_ptr + (tile_addr(t0, r, c + 8) - base)) = hi;
        }
        const int key_s = kWarpWiden ? key_off + lane : tid;  // a key's scales
        if (kWarpWiden ? lane < 16 : tid < kTile) {
          const float* scales = reinterpret_cast<const float*>(
              base_ptr + (sc_s(st) - base));
          const bool live = key0 + key_s < nl;
          sh_sc[0][key_s] = live ? scales[key_s] : 0.f;
          sh_sc[1][key_s] = live ? scales[kTile + key_s] : 0.f;
        }
        __syncwarp();
        if constexpr (!kQi8) {
          if (lane == 0) mbar_arrive(empty_bar(st));  // this warp is done with it
          kt = wide;
        }
        if constexpr (!kWarpWiden) named_sync(1, kConsumers);
        vt = wide + kTile * D * 2;
      }
#if defined(FKP_DEC_PROBE) && FKP_DEC_PROBE == 3
      // a probe (tools/ab_paged_decode.py): the loads and the widening alone
      if constexpr (!kQuant || kQi8) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_bar(st));
      }
      continue;
#endif
      if (slab_live) {
        // S = Q K^T over the warp's keys key_off + j * 8 + 2 * quad + e
        float sc[kNt][4];
#pragma unroll
        for (int j = 0; j < kNt; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
        if constexpr (kQi8) {
          // exact int32 dots of the int8 q rows and the stage's K bytes,
          // 32 dims a step (ldmatrix takes a pair of int8 as one b16)
          int si[kNt][4];
#pragma unroll
          for (int j = 0; j < kNt; ++j) si[j][0] = si[j][1] = si[j][2] = si[j][3] = 0;
#pragma unroll
          for (int kk = 0; kk < D / 32; ++kk) {
#pragma unroll
            for (int jj = 0; jj < kNt / 2; ++jj) {
              uint32_t bk[4];
              ldsm_x4(bk, k8_addr<D>(kt, key_off + jj * 16 + lane % 8 + lane / 16 * 8,
                                     kk * 32 + lane / 8 % 2 * 16));
              fkp_mma::mma_16832_s8(si[2 * jj], qa8[kk], bk[0], bk[1]);
              fkp_mma::mma_16832_s8(si[2 * jj + 1], qa8[kk], bk[2], bk[3]);
            }
          }
#pragma unroll
          for (int j = 0; j < kNt; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[j][e] = static_cast<float>(si[j][e]);
          }
          // the stage's K read by this warp: release it
          __syncwarp();
          if (lane == 0) mbar_arrive(empty_bar(st));
        } else {
          // (two 16-dim steps unrolled at a time: with more, ptxas ran the
          // fragment loads of several steps ahead and spilled)
#pragma unroll 2
          for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t qa[4];  // rows slab * 16 .. + 15, columns kk * 16 .. + 15
            ldsm_x4(qa, tile_addr<kRows>(q_s, slab * 16 + lane % 16,
                                         kk * 16 + lane / 16 * 8));
#pragma unroll
            for (int jj = 0; jj < kNt / 2; ++jj) {
              uint32_t bk[4];
              ldsm_x4(bk, tile_addr(kt, key_off + jj * 16 + lane % 8 + lane / 16 * 8,
                                    kk * 16 + lane / 8 % 2 * 8));
              mma_16816(sc[2 * jj], qa, bk[0], bk[1]);
              mma_16816(sc[2 * jj + 1], qa, bk[2], bk[3]);
            }
          }
        }
        // the tile's softmax for rows g and g + 8 over the warp's keys: one
        // max a row (the quad's four threads hold it), one rescale, one exp2
        // a (row, key); a masked key scores NEG_INF and weighs 0
        const int kb = key0 + key_off + quad * 2;
        float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kb + j * 8 + (e & 1);
            const bool ok = sees(key, e < 2 ? lim0 : lim1, e < 2 ? band0 : band1);
            if constexpr (kQi8) {  // (f32(dot) * ks) * qs, as the TPU kernel
              sc[j][e] = ok ? (sc[j][e] * sh_sc[0][key - key0]) * (e < 2 ? qs0 : qs1)
                            : kNegInf;
            } else {
              float sl = p.scale_log2;
              if constexpr (kQuant) sl *= sh_sc[0][key - key0];
              sc[j][e] = ok ? sc[j][e] * sl : kNegInf;
            }
          }
          mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
          mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float mn0 = fixed ? 0.f : fmaxf(m0, mx0);
        const float mn1 = fixed ? 0.f : fmaxf(m1, mx1);
        const float corr0 = exp2f(m0 - mn0), corr1 = exp2f(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
        l0 *= corr0;
        l1 *= corr1;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          acc[n][0] *= corr0;
          acc[n][1] *= corr0;
          acc[n][2] *= corr1;
          acc[n][3] *= corr1;
        }
        // p (the V scale folded in after l has summed it), then P V with p
        // as the A operand, a bf16 hi + lo pair, 16 keys at a time
#pragma unroll
        for (int kc = 0; kc < kNt / 2; ++kc) {
          float pv[2][4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = kb + (2 * kc + h) * 8 + (e & 1);
              const bool ok = sees(key, e < 2 ? lim0 : lim1, e < 2 ? band0 : band1);
              const float pr =
                  ok ? exp2f(sc[2 * kc + h][e] - (e < 2 ? mn0 : mn1)) : 0.f;
              if (e < 2) {
                l0 += pr;
              } else {
                l1 += pr;
              }
              pv[h][e] = pr;
              if constexpr (kQuant) pv[h][e] = ok ? pr * sh_sc[1][key - key0] : 0.f;
            }
          }
          uint32_t hi[4], lo[4];
          split_bf16(pv[0][0], pv[0][1], hi[0], lo[0]);
          split_bf16(pv[0][2], pv[0][3], hi[1], lo[1]);
          split_bf16(pv[1][0], pv[1][1], hi[2], lo[2]);
          split_bf16(pv[1][2], pv[1][3], hi[3], lo[3]);
#pragma unroll
          for (int nn = 0; nn < D / 16; ++nn) {
            uint32_t bv[4];
            ldsm_x4_t(bv, tile_addr(vt, key_off + kc * 16 + lane % 8 + lane / 8 % 2 * 8,
                                    nn * 16 + lane / 16 * 8));
            mma_16816(acc[2 * nn], hi, bv[0], bv[1]);
            mma_16816(acc[2 * nn], lo, bv[0], bv[1]);
            mma_16816(acc[2 * nn + 1], hi, bv[2], bv[3]);
            mma_16816(acc[2 * nn + 1], lo, bv[2], bv[3]);
          }
        }
      }
      if constexpr (!kQuant) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_bar(st));  // this warp is done with it
      }
    }
  }

  // merge the states of a slab's warps through shared memory (the ring's,
  // free once every warp has left the loop); a warp that saw no live key
  // of a row holds (NEG_INF, 0, 0) for it and weighs 0
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  float* const sh_acc = reinterpret_cast<float*>(base_ptr);
  constexpr int kStride = L::kAccStride;
  named_sync(1, kConsumers);
  if (quad == 0) {
    sh_m[warp][g] = m0;
    sh_m[warp][g + 8] = m1;
    sh_l[warp][g] = l0;
    sh_l[warp][g + 8] = l1;
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    float* dst = sh_acc + (warp * 16 + g) * kStride + n * 8 + quad * 2;
    *reinterpret_cast<float2*>(dst) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(dst + 8 * kStride) = make_float2(acc[n][2], acc[n][3]);
  }
  named_sync(1, kConsumers);
  const bool single = p.out != nullptr && n_live <= 1;
  __nv_bfloat16* const out_bh = p.out ? p.out + bh * p.rows * D : nullptr;
  // the block's real rows (the rest are padding, written nowhere)
  const int live_rows = min(kRows, p.rows - rt * kRows);
  for (int i = tid; i < live_rows * D; i += kConsumers) {
    const int r = i / D;  // the block's row: slab r / 16, row r % 16
    const int w0 = r / 16 * kSlabWarps;
    float mw = kNegInf;
#pragma unroll
    for (int w = 0; w < kSlabWarps; ++w) mw = fmaxf(mw, sh_m[w0 + w][r % 16]);
    float lt = 0.f, yt = 0.f;
#pragma unroll
    for (int w = 0; w < kSlabWarps; ++w) {
      const float c = exp2f(sh_m[w0 + w][r % 16] - mw);
      lt += sh_l[w0 + w][r % 16] * c;
      yt += sh_acc[((w0 + w) * 16 + r % 16) * kStride + i % D] * c;
    }
    if (single) {
      out_bh[(size_t)(rt * kRows + r) * D + i % D] =
          __float2bfloat16(lt == 0.f ? 0.f : yt / lt);
    } else {
      p.y[part * kRows * D + i] = yt;
      if (i % D == 0) {
        p.m[part * kRows + r] = lt == 0.f ? kNegInf : mw * kLn2;
        p.l[part * kRows + r] = lt;
      }
    }
  }
  if (p.out == nullptr || single) return;

  // More live splits than one: the last of their blocks of (b, kvh, rt) to
  // arrive merges their partials (written by each before its arrival) and
  // resets the counter for the next launch.
  __threadfence();
  named_sync(1, kConsumers);
  if (tid == 0) {
    const int arrived = atomicAdd(counters + pair, 1) + 1;
    sh_last = arrived == n_live;
    if (sh_last) counters[pair] = 0;
  }
  named_sync(1, kConsumers);
  if (!sh_last) return;
#if defined(FKP_EXT_PROBE) && FKP_EXT_PROBE == 1
  return;  // a probe (tools/ab_paged_extend.py): the arrival without the merge
#endif
  __threadfence();
  // every live split's m and l in shared memory, then each row's max, the
  // splits' weights (0 for a split with l = 0) and the weighted sum of l
  // (one thread a row), then each thread's outputs (kPer of them, in
  // registers, four at a time) summed over the splits' y in 16-byte
  // loads, those of two splits in flight at once (four at 16 rows, one at
  // 64). The merge is bound by the bytes one SM has in flight from L2, so
  // the loads are as wide as they go and issued unconditionally (a
  // padding row's are in the workspace and discarded; 4-byte loads took
  // twice as long); the padding rows are not written
  float* const w_s = sh_acc;                      // [n_live][kRows]: m, then weights
  float* const l_s = sh_acc + kMaxSplits * kRows;  // [n_live][kRows]
  const int n = p.n_splits;
  const float* m_pr = p.m + pair * n * kRows;
  const float* l_pr = p.l + pair * n * kRows;
  const float* y_pr = p.y + pair * n * kRows * D;
  for (int j = tid; j < n_live * kRows; j += kConsumers) {
    w_s[j] = __ldcg(m_pr + j);
    l_s[j] = __ldcg(l_pr + j);
  }
  named_sync(1, kConsumers);
  if (tid < live_rows) {
    float mx = kNegInf;
    for (int sp = 0; sp < n_live; ++sp) mx = fmaxf(mx, w_s[sp * kRows + tid]);
    float lsum = 0.f;
    for (int sp = 0; sp < n_live; ++sp) {
      const float ls = l_s[sp * kRows + tid];
      const float w = ls == 0.f ? 0.f : exp2f((w_s[sp * kRows + tid] - mx) * kLog2e);
      w_s[sp * kRows + tid] = w;
      lsum += ls * w;
    }
    sh_lsum[tid] = lsum;
  }
  named_sync(1, kConsumers);
  constexpr int kPer = kRows * D / 4 / kConsumers;  // 4-output groups a thread
  float4 yg[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) yg[u] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll(kRows == 64 ? 1 : kRows == 16 ? 4 : 2)
  for (int sp = 0; sp < n_live; ++sp) {
    const float4* y_sp = reinterpret_cast<const float4*>(y_pr + (size_t)sp * kRows * D);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i4 = tid + u * kConsumers;
      const float w = w_s[sp * kRows + i4 * 4 / D];
      const float4 v = __ldcg(y_sp + i4);
      yg[u].x += w * v.x;
      yg[u].y += w * v.y;
      yg[u].z += w * v.z;
      yg[u].w += w * v.w;
    }
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i4 = tid + u * kConsumers;
    const int r = i4 * 4 / D;
    if (r < live_rows) {
      const float lg = sh_lsum[r] == 0.f ? 1.f : sh_lsum[r];  // 0 stays 0
      const uint2 o = make_uint2(pack_bf16(yg[u].x / lg, yg[u].y / lg),
                                 pack_bf16(yg[u].z / lg, yg[u].w / lg));
      *reinterpret_cast<uint2*>(out_bh + (size_t)rt * kRows * D + i4 * 4) = o;
    }
  }
}

// The paged extend: instance <D, kRows, KV>, the ring of kStages. At most
// 200 registers a thread (__maxnreg__), so that two blocks of five warps
// share an SM (one block at 64 rows: 255).
template <int D, int kRows, class KV>
__global__ void __maxnreg__((Layout<D, kRows, KV>::kMaxRegs))
    paged_extend_sm90_kernel(const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             const Params p, int* __restrict__ counters) {
  paged_block<D, kRows, KV, kStages, kAttend>(&k_map, &v_map, p, counters);
}

// The paged decode (the block at T = 1, one slab of G <= 16 rows):
// instance <D, KV, ring depth, mode>.
template <int D, class KV, int kDepth, int kMode>
__global__ void __maxnreg__((Layout<D, kDecodeRows, KV, kDepth>::kMaxRegs))
    paged_decode_sm90_kernel(const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             const Params p, int* __restrict__ counters) {
  paged_block<D, kDecodeRows, KV, kDepth, kMode>(&k_map, &v_map, p, counters);
}

// Launches `kernel`, an instance over <D, kRows, KV, kDepth, kMode>, on a
// grid of (n_splits, hkv * row_tiles, b) over a pool of n_pages pages;
// returns a CUDA error code (the shared-memory attribute's,
// cudaErrorInvalidValue where a map cannot be encoded, else
// cudaGetLastError() after the launch).
template <int D, int kRows, class KV, int kDepth, int kMode, class Kernel>
int launch_on(Kernel kernel, const Params& p, const void* k_pages,
              const void* v_pages, int n_pages, int b, int* counters,
              cudaStream_t stream) {
  constexpr int kBytes = Layout<D, kRows, KV, kDepth>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap km, vm;
  const int heads = n_pages * p.hkv;
  bool ok;
  if constexpr (sizeof(KV) == 1) {
    // the int8 score product reads K in place: swizzled (k8_addr)
    const CUtensorMapSwizzle k_swizzle =
        kMode != kQInt8 ? CU_TENSOR_MAP_SWIZZLE_NONE
                        : (D == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                    : CU_TENSOR_MAP_SWIZZLE_64B);
    ok = fkp_sm90::encode_tiled(&km, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, k_pages,
                                D, p.page, heads, p.box_rows, D, k_swizzle) &&
         fkp_sm90::encode_tiled(&vm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, v_pages,
                                D, p.page, heads, p.box_rows, D,
                                CU_TENSOR_MAP_SWIZZLE_NONE);
  } else {
    ok = fkp_sm90::encode_map(&km, k_pages, D, p.page, heads, p.box_rows) &&
         fkp_sm90::encode_map(&vm, v_pages, D, p.page, heads, p.box_rows);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<dim3(p.n_splits, p.hkv * p.row_tiles, b), kThreads, kBytes,
           stream>>>(km, vm, p, counters);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int kRows, class KV>
int launch(const Params& p, const void* k_pages, const void* v_pages,
           int n_pages, int b, int* counters, cudaStream_t stream) {
  return launch_on<D, kRows, KV, kStages, kAttend>(
      &paged_extend_sm90_kernel<D, kRows, KV>, p, k_pages, v_pages, n_pages, b,
      counters, stream);
}

// The extend's instance for d (64, 128) and block_rows (16, 32, 64) over
// KV; cudaErrorInvalidValue for another d or block_rows.
template <class KV>
int launch_any(int d, int block_rows, const Params& p, const void* k_pages,
               const void* v_pages, int n_pages, int b, int* counters,
               cudaStream_t stream) {
  const auto by_rows = [&](auto dc) {
    constexpr int kD = decltype(dc)::value;
    switch (block_rows) {
      case 16: return launch<kD, 16, KV>(p, k_pages, v_pages, n_pages, b, counters, stream);
      case 32: return launch<kD, 32, KV>(p, k_pages, v_pages, n_pages, b, counters, stream);
      case 64: return launch<kD, 64, KV>(p, k_pages, v_pages, n_pages, b, counters, stream);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  };
  if (d == 64) return by_rows(std::integral_constant<int, 64>{});
  if (d == 128) return by_rows(std::integral_constant<int, 128>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// The 8-bit instances (paged_extend_q.cu): int8 (fp8 == 0) or e4m3.
int launch_8bit(int fp8, int d, int block_rows, const Params& p,
                const void* k_pages, const void* v_pages, int n_pages, int b,
                int* counters, cudaStream_t stream);

// The decode's instance <d, KV, kDepth, kMode> for d in {64, 128};
// cudaErrorInvalidValue for another d.
template <class KV, int kDepth, int kMode>
int launch_decode(int d, const Params& p, const void* k_pages,
                  const void* v_pages, int n_pages, int b, int* counters,
                  cudaStream_t stream) {
  const auto go = [&](auto dc) {
    constexpr int kD = decltype(dc)::value;
    return launch_on<kD, kDecodeRows, KV, kDepth, kMode>(
        &paged_decode_sm90_kernel<kD, KV, kDepth, kMode>, p, k_pages, v_pages,
        n_pages, b, counters, stream);
  };
  if (d == 64) return go(std::integral_constant<int, 64>{});
  if (d == 128) return go(std::integral_constant<int, 128>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// The decode's instances by source, so that nvcc builds them in parallel:
// the bf16 ring of depth 2 and the copy probe are paged_decode.cu's (with
// the C entries); the bf16 depths 3 and 4 paged_decode_deep.cu's; int8 and
// e4m3 (fp8 == 1) at depth 2 paged_decode_q.cu's, at 3 and 4
// paged_decode_q_deep.cu's; the int8 score product at every depth
// paged_decode_qi8.cu's. Each returns cudaErrorInvalidValue for a depth or
// d it lacks.
int decode_bf16_deep(int depth, int d, const Params& p, const void* k_pages,
                     const void* v_pages, int n_pages, int b, int* counters,
                     cudaStream_t stream);
int decode_8bit(int fp8, int d, const Params& p, const void* k_pages,
                const void* v_pages, int n_pages, int b, int* counters,
                cudaStream_t stream);
int decode_8bit_deep(int fp8, int depth, int d, const Params& p,
                     const void* k_pages, const void* v_pages, int n_pages,
                     int b, int* counters, cudaStream_t stream);
int decode_qi8(int depth, int d, const Params& p, const void* k_pages,
               const void* v_pages, int n_pages, int b, int* counters,
               cudaStream_t stream);

// The call's shape as the kernels take it, or false: pages of 16 to 128
// rows in steps of 16, splits of whole 64-key tiles, at most kMaxSplits of
// them, 16, 32 or 64 folded rows a block; with out set and more than one
// split the workspace and at most kMaxCounters (batch row, KV head, row
// tile) triples; without out the partials' buffers.
inline bool valid(int b, int hq, int hkv, int t, int page, int max_pages,
                  int n_pages, int n_splits, int block_s, int block_rows,
                  const void* out, const void* m, const void* l, const void* y) {
  if (b <= 0 || hkv <= 0 || hq % hkv || t <= 0 || max_pages <= 0 ||
      n_pages <= 0 || page % 16 || page < kMinPage || page > kMaxPage ||
      n_splits < 1 || n_splits > kMaxSplits || block_s <= 0 ||
      block_s % kTile || (block_rows != 16 && block_rows != 32 &&
                          block_rows != 64)) {
    return false;
  }
  const long long rows = (long long)(hq / hkv) * t;
  const long long row_tiles = (rows + block_rows - 1) / block_rows;
  if (b > 65535 || hkv * row_tiles > 65535 ||
      (long long)n_pages * hkv > 0x7fffffffLL) {
    return false;
  }
  const bool parts = !out || n_splits > 1;
  if (parts && (!m || !l || !y)) return false;
  return !(out && n_splits > 1 && b * hkv * row_tiles > kMaxCounters);
}

// the Params of a call (k_scale and v_scale null for bf16, old_lens null
// for the decode)
inline Params params(const void* q, const void* tables, const void* new_lens,
                     const void* old_lens, const void* k_scale,
                     const void* v_scale, void* out, void* m, void* l, void* y,
                     int hq, int hkv, int t, int page, int max_pages,
                     int n_splits, int block_s, int block_rows,
                     float scale_log2) {
  const int rows = (hq / hkv) * t;
  int box_rows = 64;  // gcd(page, 64)
  while (page % box_rows) box_rows /= 2;
  return Params{static_cast<const __nv_bfloat16*>(q),
                static_cast<const int*>(tables),
                static_cast<const int*>(new_lens),
                static_cast<const int*>(old_lens),
                static_cast<const float*>(k_scale),
                static_cast<const float*>(v_scale),
                static_cast<float*>(m),
                static_cast<float*>(l),
                static_cast<float*>(y),
                static_cast<__nv_bfloat16*>(out),
                hkv, t, rows, (rows + block_rows - 1) / block_rows, page,
                max_pages, n_splits, block_s, box_rows, scale_log2};
}

// The ragged forward's slab route over a linear cache [b, hkv, s_max, D]
// (flash_attention_ragged / _kv_quant at T < 9: the linear speculative
// verify and short chunks): the block over a linear cache, instance <D,
// kRows, KV, kCache (kLinearPlain or kLinearGeneral)>, seen as a pool of
// one page of s_max rows a batch row with an implicit table. Its instances
// and C entry are ragged_slab.cu's (bf16, with the arrival counters, a
// zeroed array of its own), ragged_slab_q.cu's (int8) and
// ragged_slab_fp8.cu's (e4m3).
template <int D, int kRows, class KV, int kCache>
__global__ void __maxnreg__((Layout<D, kRows, KV>::kMaxRegs))
    ragged_slab_sm90_kernel(const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const Params p, int* __restrict__ counters) {
  paged_block<D, kRows, KV, kStages, kAttend, kCache>(&k_map, &v_map, p,
                                                      counters);
}

// Launches the slab route's instance on a grid of (n_splits, hkv *
// row_tiles, b), its maps 3-D over k and v as [b * hkv, s_max, D] in boxes
// of 64 rows; returns a CUDA error code as launch_on.
template <int D, int kRows, class KV, int kCache>
int launch_linear(const Params& p, const void* k, const void* v, int b,
                  int* counters, cudaStream_t stream) {
  const auto kernel = &ragged_slab_sm90_kernel<D, kRows, KV, kCache>;
  constexpr int kBytes = Layout<D, kRows, KV>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap km, vm;
  const int planes = b * p.hkv;
  bool ok;
  if constexpr (sizeof(KV) == 1) {
    ok = fkp_sm90::encode_tiled(&km, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, k, D,
                                p.page, planes, kTile, D,
                                CU_TENSOR_MAP_SWIZZLE_NONE) &&
         fkp_sm90::encode_tiled(&vm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, v, D,
                                p.page, planes, kTile, D,
                                CU_TENSOR_MAP_SWIZZLE_NONE);
  } else {
    ok = fkp_sm90::encode_map(&km, k, D, p.page, planes, kTile) &&
         fkp_sm90::encode_map(&vm, v, D, p.page, planes, kTile);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<dim3(p.n_splits, p.hkv * p.row_tiles, b), kThreads, kBytes,
           stream>>>(km, vm, p, counters);
  return static_cast<int>(cudaGetLastError());
}

// The slab route's instance for d (64, 128), block_rows (16, 32, 64) and
// the call (kLinearPlain for a causal online call with no band, else
// kLinearGeneral; a probe build, tools/ab_ragged.py's -DFKP_SLAB_PROBE=2,
// takes kLinearGeneral for every call) over KV; cudaErrorInvalidValue for
// another d or block_rows.
template <class KV>
int launch_linear_any(int d, int block_rows, const Params& p, const void* k,
                      const void* v, int b, int* counters, cudaStream_t stream) {
#if defined(FKP_SLAB_PROBE) && FKP_SLAB_PROBE != 2
#error "FKP_SLAB_PROBE takes only 2 (every call on kLinearGeneral)"
#elif defined(FKP_SLAB_PROBE)
  const bool plain = false;
#else
  const bool plain = p.causal && p.window <= 0 && !p.fixed;
#endif
  const auto by_cache = [&](auto dc, auto rc) {
    constexpr int kD = decltype(dc)::value;
    constexpr int kR = decltype(rc)::value;
    return plain ? launch_linear<kD, kR, KV, kLinearPlain>(p, k, v, b, counters, stream)
                 : launch_linear<kD, kR, KV, kLinearGeneral>(p, k, v, b, counters,
                                                             stream);
  };
  const auto by_rows = [&](auto dc) {
    switch (block_rows) {
      case 16: return by_cache(dc, std::integral_constant<int, 16>{});
      case 32: return by_cache(dc, std::integral_constant<int, 32>{});
      case 64: return by_cache(dc, std::integral_constant<int, 64>{});
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  };
  if (d == 64) return by_rows(std::integral_constant<int, 64>{});
  if (d == 128) return by_rows(std::integral_constant<int, 128>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// The slab route's 8-bit instances: int8 (ragged_slab_q.cu) and e4m3
// (ragged_slab_fp8.cu).
int linear_int8(int d, int block_rows, const Params& p, const void* k,
                const void* v, int b, int* counters, cudaStream_t stream);
int linear_e4m3(int d, int block_rows, const Params& p, const void* k,
                const void* v, int b, int* counters, cudaStream_t stream);

// The slab route's call as the kernels take it, or false: a cache of s_max
// > 0 rows cut into n_splits (1 to kMaxSplits) splits of block_s keys
// (whole 64-key tiles) that cover it, 16, 32 or 64 folded rows a block,
// the grid's limits, and with more than one split the workspace and at
// most kMaxCounters (batch row, KV head, row tile) triples.
inline bool linear_valid(int b, int hq, int hkv, int t, int s_max,
                         int n_splits, int block_s, int block_rows,
                         const void* m, const void* l, const void* y) {
  if (b <= 0 || hkv <= 0 || hq % hkv || t <= 0 || s_max <= 0 ||
      n_splits < 1 || n_splits > kMaxSplits || block_s <= 0 ||
      block_s % kTile || (long long)n_splits * block_s < s_max ||
      (block_rows != 16 && block_rows != 32 && block_rows != 64)) {
    return false;
  }
  const long long rows = (long long)(hq / hkv) * t;
  const long long row_tiles = (rows + block_rows - 1) / block_rows;
  if (b > 65535 || hkv * row_tiles > 65535 || (long long)b * hkv > 0x7fffffffLL) {
    return false;
  }
  if (n_splits > 1 && (!m || !l || !y || b * hkv * row_tiles > kMaxCounters)) {
    return false;
  }
  return true;
}

// the Params of a slab call: the linear cache as a pool of one page of
// s_max rows a batch row (page = s_max, one page a row, boxes of 64 rows);
// q_offsets in the place of old_lens
inline Params linear_params(const void* q, const void* kv_lens,
                            const void* q_offsets, const void* k_scale,
                            const void* v_scale, void* out, void* m, void* l,
                            void* y, int hq, int hkv, int t, int s_max,
                            int n_splits, int block_s, int block_rows,
                            float scale_log2, int causal, int window,
                            int sinks, int fixed) {
  const int rows = (hq / hkv) * t;
  return Params{static_cast<const __nv_bfloat16*>(q),
                nullptr,
                static_cast<const int*>(kv_lens),
                static_cast<const int*>(q_offsets),
                static_cast<const float*>(k_scale),
                static_cast<const float*>(v_scale),
                static_cast<float*>(m),
                static_cast<float*>(l),
                static_cast<float*>(y),
                static_cast<__nv_bfloat16*>(out),
                hkv, t, rows, (rows + block_rows - 1) / block_rows, s_max, 1,
                n_splits, block_s, kTile, scale_log2, causal, window, sinks,
                fixed};
}

}  // namespace fkp_ext90
