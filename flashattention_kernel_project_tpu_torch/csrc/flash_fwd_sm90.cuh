// The dense attention forward for Hopper (sm_90a): wgmma, TMA and a K/V
// ring. flash_fwd.cu, flash_fwd_fixed.cu and flash_fwd_hybrid.cu each build
// the instances of one discipline (kDisc) from this header, for d in
// {64, 128} with and without a band (kWindow), in blocks of 128 or 64 query
// rows (kRows): 24 instances in all. The same block body (fwd_block) is
// the dense forward over an 8-bit cache behind flash_fwd_q_sm90_kernel
// (flash_fwd_q.cu's head describes it) and the ragged forward's wgmma
// route behind flash_fwd_ragged_sm90_kernel (flash_fwd_ragged.cu's head
// describes it: per-row bounds read on the device, no LSE); over an 8-bit
// cache it takes 64-key byte tiles widened to bf16 by the producer
// warpgroup. Its stage switch (kStage) keeps one stage of it alone: the
// stage probes of probes_sm90.cu. The Hopper primitives it shares with the bf16 GEMM and the
// backward (mbarriers, the TMA load, the wgmma descriptor and products,
// fence, commit and wait, the map encoder) are sm90.cuh's.
//
// Replaces flashattention_kernel_project_tpu/ops/flash_attention.py::
// _fwd_kernel (:92, pallas_call :1375/:1380) in its three disciplines, with
// a static q_offset and the optional sliding window with sinks, and
// _fwd_kernel_packed (:710, pallas_call :1526), the fixed-max d=64 forward
// (the TPU pairs two KV heads there because a d=64 product fills half of
// its 128-deep matrix unit; wgmma is 16 deep, so the fixed-max d=64
// instance computes it as it stands). It computes what the mma.sync
// forward it replaced computed: the same masks, disciplines, empty-row
// rule, range guard and precision (the scale on f32 scores, p into PV as
// a bf16 hi + lo pair, two products); flash_fwd_core.cuh's notes describe
// them.
//
// What bounds it on the H100: at prefill shapes (N = S in the hundreds to
// thousands, d = 128) the two products do 4*N*S*d flops (6*N*S*d with the
// second PV product) against about 2*(N + 2*S)*d bytes of device memory,
// far above the card's ~295 flop/byte ridge: tensor-core issue and the
// softmax arithmetic between the products bound it. The mma.sync design
// reached 13.5% of the bf16 peak at bench.py's shape: its PV gathered V's
// B fragments two bytes at a time, its K/V tiles were loaded through
// registers between two block barriers with no second buffer, and every
// tile paid the causal compare and select. What each choice here does
// about that:
// - wgmma (m64nNk16, f32 accumulators in registers), the only path to the
//   full tensor-core rate: S = Q K^T with both operands read from shared
//   memory by descriptor (K stored [key][dim] is the K-major B operand),
//   O += P V with p from registers (the accumulator's layout is the
//   A-fragment layout, repacked to a bf16 hi + lo pair in place) and V read
//   as it lies, MN-major (transposed): no fragment gathers.
// - TMA: one producer thread loads Q once and every K/V tile as two 3-D
//   boxes of 128 rows x 64 dims (a 128-byte row, swizzled 128B; d = 128
//   takes two per tile) from maps over [b*h, rows, d], so rows past n or s
//   are zero-filled, never the next head's. No consumer register or
//   instruction is spent on loads.
// - A ring of 3 K/V stages (d = 128: 32 KB Q + 3 x 64 KB = 224 KB of the
//   227 at 128 rows; d = 64: 16 + 3 x 32) with full/empty mbarriers: the next tiles
//   load while the consumers compute, where the mma.sync design waited for
//   each tile. With 2 stages the d=128 kernel ran 23% slower: a stage is
//   released only when its PV product is done, a tile after its QK.
// - 128 query rows a block, two consumer warpgroups of 64 (4 warps of 16
//   rows each, the wgmma row split) sharing the ring: each tile read from
//   device memory or L2 serves 128 rows. Where a grid of 64-row blocks
//   fits in one wave of the SMs (the serving prefill), blocks of 64 rows
//   and one consumer warpgroup: twice the blocks (block_rows below). A
//   producer warpgroup, one thread of which issues the loads, gives its
//   registers to the consumers by setmaxnreg (24 and 240 a thread): a
//   consumer holds S (64 f32), O (64 at d = 128) and the previous tile's p
//   pair (64) at once. Under ptxas's 168-register cap for 288 threads (a
//   producer warp, no setmaxnreg) the d=128 instances spilled.
// - The key loop is software-pipelined (FlashAttention-3's intra-warpgroup
//   overlap): tile j's QK and tile j-1's PV go out together, and tile j's
//   softmax runs while that PV is in flight; O's rescale by tile j's max
//   waits for it. The two warpgroups of a 128-row block take turns to issue
//   their products (ping-pong, two named barriers), so one's softmax runs
//   under the other's products: 11% of the online kernel's time at
//   bench.py's shape, none for fixed-max, which has no rescale chain.
//   Every wgmma issue and wait lies on control flow uniform in the
//   warpgroup: with them under the data-dependent branches of a tile
//   skip, ptxas serialized them.
// - The mask only where a 128-key tile crosses the causal diagonal, the key
//   tail (s) or a band edge, classified once per warpgroup (uniform across
//   its 128 threads); the other tiles run a copy of the softmax compiled
//   without it. A masked score is -inf, so p needs no second test.
// - Heaviest causal query tiles first, as before; with a window, the sink
//   tiles and then the band's tiles, each once.
// The hybrid decides per warp (16 rows) as before, from the Q tile in
// shared memory; only the softmax and the rescale branch on it, never a
// wgmma, which is .sync.aligned over the warpgroup.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_fwd_core.cuh"
#include "mma.cuh"
#include "sm90.cuh"
#include "widen.cuh"

namespace fkp_sm90 {

using fkp_fwd::Bool;
using fkp_fwd::GuardArgs;
using fkp_fwd::kFixed;
using fkp_fwd::kHybrid;
using fkp_fwd::kLn2;
using fkp_fwd::kNegInf;
using fkp_fwd::kOnline;
using fkp_fwd::kSafeBound;
using fkp_mma::split_bf16;

constexpr int kN = 128;                 // keys a K/V tile
constexpr int kBoxBytes = kN * 128;     // a K or V box: 128 keys of 128 bytes

// The threads of a block of kRows query rows (64 or 128): a consumer
// warpgroup for each 64 rows, then the producer warpgroup; over an 8-bit
// cache (kQuant) a loading warp and widening warps, four at 64 rows and
// three at 128 (a 128-row block's consumers take twice as long over a
// tile, and its 384 threads leave 168 registers a thread, enough for
// either role). Only the bf16 instances trade registers by setmaxnreg:
// the 8-bit widening warps ran 15% slower at 152 than at 168, and below
// (tools/ab_8bit.py).
template <int kRows, bool kQuant = false>
struct Block {
  static constexpr int kConsumers = kRows * 2;
  static constexpr int kWideners = !kQuant ? 0 : kRows == 64 ? 128 : 96;
  static constexpr int kThreads = kConsumers + (kQuant ? 32 + kWideners : 128);
};
// registers a thread after setmaxnreg in the bf16 instances: the producer
// gives up what the consumers take (128 * 24 + 256 * 240 <= 65536)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// Shared memory of the (d, kRows, KV) instance: Q (boxes of kRows rows),
// then the ring's stages, each K then V, every box 1024-byte aligned (the
// 128B swizzle's period), after up to 1 KB of alignment slack. The 8-bit
// instances (the dense and the ragged forward over an int8 or e4m3 cache)
// take tiles of 64 keys and add, after the ring of widened bf16 stages,
// each stage's 64 K and 64 V scales (f32, in a KB) and a ring of 3 byte
// stages, the 8-bit K and V tiles as the TMA brings them ([key][D] bytes,
// unswizzled). At d = 128: Q (16 KB at 64 rows, 32 at 128), 3 widened
// stages (96 KB), their scales (3 KB) and 3 byte stages (48 KB), 163 KB
// (179 KB) of the 227. With 128-key tiles the byte stages and the widened
// ones passed the 227 at three stages each, and at two a widened stage is
// free only when the consumers need it again, so the widening would not
// overlap the products.
template <int D, int kRows, class KV = __nv_bfloat16>
struct Layout {
  static constexpr bool kQuant = sizeof(KV) == 1;
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kKeys = kQuant ? 64 : kN;  // keys a K/V tile
  static constexpr int kBox = kKeys * 128;        // a K or V box: 128 bytes a key
  static constexpr int kStages = 3;               // bf16 (widened) stages
  static constexpr int kByteStages = kQuant ? 3 : 0;
  static constexpr int kQBox = kRows * 128;
  static constexpr int kQTile = kBoxes * kQBox;
  static constexpr int kTile = kBoxes * kBox;     // K or V
  static constexpr int kScales = kQuant ? 1024 : 0;  // a stage's K, V scales
  static constexpr int kByteTile = kKeys * D;     // an 8-bit K or V tile
  static constexpr int kScaleOff = kQTile + 2 * kStages * kTile;
  static constexpr int kByteOff = kScaleOff + kStages * kScales;
  static constexpr int kBytes = 1024 + kByteOff + kByteStages * 2 * kByteTile;
  static_assert(kBytes <= 232448, "past the 227 KB a block may hold");
};

// the sum of squares of 8 bf16
__device__ __forceinline__ float sq_bf16x8(const uint4& w) {
  return fkp_fwd::sq_bf16x2(w.x) + fkp_fwd::sq_bf16x2(w.y) +
         fkp_fwd::sq_bf16x2(w.z) + fkp_fwd::sq_bf16x2(w.w);
}

// The ragged flavour's per-row bounds and 8-bit scales: kv_lens and
// q_offsets [b] int32 on the device (row b sees keys j < min(kv_lens[b], s)
// and its query i sits at position i + q_offsets[b]); k_scale, v_scale
// [b, hkv, s, 1] f32 (8-bit caches; null for bf16).
struct RaggedPtrs {
  const int* kv_lens;
  const int* q_offsets;
  const float* k_scale;
  const float* v_scale;
};

// What a block of fwd_block runs: the whole forward (kForward), or one stage
// of it alone, the stage probes of probes_sm90.cu (ops/probes.py's copy,
// qk, pv, softmax chain, qk_kt and qk_packed; their numbers are its stage
// numbers): the K/V ring with each stage waited on and released and no
// products (kProbeCopy), the QK products (kProbeQK) or the PV products
// (kProbePV), each as the forward issues them; the forward's softmax on
// synthesized scores, with no products (kProbeChain); the QK products over
// K^T [b*hkv, D, s], read as the MN-major B operand, with no V stream
// (kProbeQKT); the QK products with no V stream (kProbePacked: the packed
// operands at D = 2d).
enum FwdStage : int {
  kProbeCopy = 0,
  kProbeQK = 1,
  kProbePV = 2,
  kProbeChain = 3,
  kProbeQKT = 4,
  kProbePacked = 5,
  kForward = -1
};

// whether a block at `stage` streams V (every stage but the K-only probes)
__host__ __device__ constexpr bool stage_reads_v(int stage) {
  return stage != kProbeQKT && stage != kProbePacked;
}

// The block body. One block per (kRows-row query tile, q head, batch row):
// the first kRows * 2 threads are the consumer warpgroups, 64 rows each,
// the last 128 the producer warpgroup. Maps: q over [b*hq, n, d] in boxes of
// kRows rows, k and v over [b*hkv, s, d] in boxes of 128 keys, 64 dims a
// box (8-bit: whole rows of D bytes, unswizzled). The other arguments as
// fkp_flash_fwd takes them; kRagged reads s and q_offset of the block's
// row from rp and writes no LSE (lse null); KV the cache's type. A probe
// stage (kStage, bf16, online, no band, not ragged) writes f32 [b, hq, n,
// D] at o in place of O (each row: the copy's sum over the rows j *
// block_k of k + v, the QK stages' score sum broadcast over D, the PV's
// q[row, 0] * sum_k v[k], the chain's acc / (l + 1e-6)) and no LSE.
// kProbeQKT's k map is over K^T [b*hkv, D, s] in boxes of 64 keys x D dim
// rows; kProbeQKT and kProbePacked read no v map.
template <int D, bool kWindow, int kDisc, int kRows, class KV, bool kRagged,
          int kStage = kForward>
__device__ __forceinline__ void fwd_block(
    const CUtensorMap* q_map, const CUtensorMap* k_map,
    const CUtensorMap* v_map, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int hq, int hkv, int n, int s, float scale_log2,
    int causal, int q_offset, int window, int sinks,
    const float* __restrict__ k_max, GuardArgs gd, RaggedPtrs rp,
    int block_k = 0) {
  using L = Layout<D, kRows, KV>;
  constexpr bool kQuant = L::kQuant;
  static_assert(!kRagged || kDisc != kHybrid, "the ragged forward has no hybrid");
  constexpr int kM = kRows;
  using Threads = Block<kRows, kQuant>;
  constexpr int kConsumers = Threads::kConsumers;
  constexpr bool kPingPong = kRows == 128;  // two consumer warpgroups
  // the probe stages that issue the QK products
  [[maybe_unused]] constexpr bool kQKStage =
      kStage == kProbeQK || kStage == kProbeQKT || kStage == kProbePacked;
  [[maybe_unused]] constexpr bool kLoadV = stage_reads_v(kStage);
  extern __shared__ uint8_t smem_raw[];
  // Q, full, empty; the 8-bit instances' byte stages: full, empty
  __shared__ __align__(8) uint64_t bars[1 + 2 * L::kStages + 2 * L::kByteStages];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t q_s = base;
  const auto k_s = [&](int st) { return base + L::kQTile + L::kTile * 2 * st; };
  const auto v_s = [&](int st) { return k_s(st) + L::kTile; };
  const auto sc_s = [&](int st) { return base + L::kScaleOff + L::kScales * st; };
  const auto kb_s = [&](int bs) { return base + L::kByteOff + L::kByteTile * 2 * bs; };
  const uint32_t q_bar = smem_u32(&bars[0]);
  const auto full_bar = [&](int st) { return smem_u32(&bars[1 + st]); };
  const auto empty_bar = [&](int st) {
    return smem_u32(&bars[1 + L::kStages + st]);
  };
  const auto byte_full = [&](int bs) {
    return smem_u32(&bars[1 + 2 * L::kStages + bs]);
  };
  const auto byte_empty = [&](int bs) {
    return smem_u32(&bars[1 + 2 * L::kStages + L::kByteStages + bs]);
  };

  const int m_block = gridDim.x - 1 - blockIdx.x;  // heaviest causal first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hkv);  // contiguous GQA grouping
  const int row_first = m_block * kM;
  const int row_last = min(row_first + kM, n) - 1;  // the block's last real row
  [[maybe_unused]] const int s_max = s;  // the K/V rows (the maps')
  if constexpr (kRagged) {
    // the row's bounds, read once a block: keys [0, kv_len) with kv_len
    // clamped to s, queries from position q_offsets[b]
    s = min(max(__ldg(rp.kv_lens + b), 0), s);
    q_offset = __ldg(rp.q_offsets + b);
  }

  // the key tiles the block visits, the same list for producer and
  // consumers: up to the last real row's diagonal; with a window the sink
  // tiles below the band, then the band's tiles from the one holding the
  // first row's first band key
  int n_tiles = (s + L::kKeys - 1) / L::kKeys;
  if (causal) {
    const int last_key = row_last + q_offset;
    n_tiles = last_key < 0 ? 0 : min(n_tiles, last_key / L::kKeys + 1);
  }
  int band_tile = 0, n_sink_tiles = 0;
  if constexpr (kWindow) {
    band_tile = min(max(row_first + q_offset - (window - 1), 0) / L::kKeys, n_tiles);
    n_sink_tiles = min((sinks + L::kKeys - 1) / L::kKeys, band_tile);
  }
  const int n_visit = n_sink_tiles + n_tiles - band_tile;
  const auto tile_of = [&](int it) {
    return it < n_sink_tiles ? it : band_tile + it - n_sink_tiles;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int st = 0; st < L::kStages; ++st) {
      // a bf16 stage fills by the TMA's bytes (one arrival); a widened one
      // by the widening warps' arrivals
      mbar_init(full_bar(st), kQuant ? Threads::kWideners / 32 : 1);
      mbar_init(empty_bar(st), kConsumers / 32);  // one arrival a warp
    }
    for (int bs = 0; bs < L::kByteStages; ++bs) {
      mbar_init(byte_full(bs), 1);
      mbar_init(byte_empty(bs), Threads::kWideners / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup
    const int qh = b * hq + h;
    const int kh = b * hkv + kvh;
    if constexpr (!kQuant) {
      // one thread loads Q and the K/V tiles into the ring
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
      if (threadIdx.x == kConsumers) {
        mbar_expect_tx(q_bar, L::kQTile);
        for (int x = 0; x < L::kBoxes; ++x) {
          tma_load(q_s + x * L::kQBox, q_map, q_bar, x * kBoxCols, row_first,
                   qh);
        }
        for (int it = 0; it < n_visit; ++it) {
          const int st = it % L::kStages;
          const int key0 = tile_of(it) * L::kKeys;
          // the stage's previous tile released by every consumer warp (the
          // first round passes at once)
          mbar_wait(empty_bar(st), ((it / L::kStages) & 1) ^ 1);
          mbar_expect_tx(full_bar(st), (kLoadV ? 2 : 1) * L::kTile);
          if constexpr (kStage == kProbeQKT) {
            // K^T: the tile's two boxes of 64 keys x D dim rows, D * 128
            // bytes apart in the stage's K slot
            for (int x = 0; x < kN / kBoxCols; ++x) {
              tma_load(k_s(st) + x * D * 128, k_map, full_bar(st),
                       key0 + x * kBoxCols, 0, kh);
            }
          } else {
            for (int x = 0; x < L::kBoxes; ++x) {
              tma_load(k_s(st) + x * L::kBox, k_map, full_bar(st),
                       x * kBoxCols, key0, kh);
              if constexpr (kLoadV) {
                tma_load(v_s(st) + x * L::kBox, v_map, full_bar(st),
                         x * kBoxCols, key0, kh);
              }
            }
          }
        }
      }
    } else {
      // 8-bit: warp 0's first thread loads Q and the byte tiles into the
      // byte ring; the widening warps widen each byte tile exactly to the
      // swizzled bf16 K and V tiles of a ring stage (the layout the bf16
      // TMA boxes give, which the products' descriptors read), zero at keys
      // past kv_len, with the tile's scales beside them (0 there too),
      // while the consumers multiply the stages before it: each thread
      // loads all its 16-byte pieces of the tile at once (8 at 64 rows and
      // d 128), then widens and stores them (with three warps and two
      // pieces in flight the widening set the pace of a 64-row block: 0.033
      // ms at the serving chunk against 0.018 with the widening taken out,
      // tools/ab_ragged.py; the first thread also loading, in place of a
      // warp of its own, cost the chunk 8%).
      const int pw = (threadIdx.x - kConsumers) / 32;
      if (pw == 0) {
        if (threadIdx.x == kConsumers) {
          mbar_expect_tx(q_bar, L::kQTile);
          for (int x = 0; x < L::kBoxes; ++x) {
            tma_load(q_s + x * L::kQBox, q_map, q_bar, x * kBoxCols,
                     row_first, qh);
          }
          for (int it = 0; it < n_visit; ++it) {
            const int bs = it % L::kByteStages;
            mbar_wait(byte_empty(bs), ((it / L::kByteStages) & 1) ^ 1);
            mbar_expect_tx(byte_full(bs), 2 * L::kByteTile);
            tma_load(kb_s(bs), k_map, byte_full(bs), 0, tile_of(it) * L::kKeys, kh);
            tma_load(kb_s(bs) + L::kByteTile, v_map, byte_full(bs), 0,
                     tile_of(it) * L::kKeys, kh);
          }
        }
        return;
      }
      constexpr int kWideners = Threads::kWideners;
      const int wt = threadIdx.x - kConsumers - 32;  // 0 .. kWideners - 1
      const int lane = threadIdx.x % 32;
      const size_t plane = (size_t)kh * s_max;  // the (b, kvh) scale row
      constexpr int kPieces = L::kKeys * D / 16;  // 16-byte pieces of a byte tile
      // a thread's pieces, K and V (the last may lie past the tile's 2 *
      // kPieces where kWideners does not divide them)
      constexpr int kEach = (2 * kPieces + kWideners - 1) / kWideners;
      constexpr bool kWhole = kEach * kWideners == 2 * kPieces;
      static_assert(L::kKeys <= kWideners, "a widening thread a key's scales");
      for (int it = 0; it < n_visit; ++it) {
        const int bs = it % L::kByteStages;
        const int st = it % L::kStages;
        const int key0 = tile_of(it) * L::kKeys;
        // the tile's scales first (their loads in flight while the waits
        // pass), then the byte tile, then a free stage
        float* const sc = reinterpret_cast<float*>(base_ptr + (sc_s(st) - base));
        const bool live = wt < L::kKeys && key0 + wt < s;  // key key0 + wt
        const float ks = live ? __ldg(rp.k_scale + plane + key0 + wt) : 0.f;
        const float vs = live ? __ldg(rp.v_scale + plane + key0 + wt) : 0.f;
        mbar_wait(byte_full(bs), (it / L::kByteStages) & 1);
        mbar_wait(empty_bar(st), ((it / L::kStages) & 1) ^ 1);
        const uint8_t* const bytes = base_ptr + (kb_s(bs) - base);
        // (a probe, tools/ab_ragged.py's -DFKP_RAGGED_PROBE=2: the loads
        // without the widening, the output unchecked; no other value builds)
#if defined(FKP_RAGGED_PROBE) && FKP_RAGGED_PROBE != 2
#error "FKP_RAGGED_PROBE takes only 2 (the 8-bit tiles left unwidened)"
#elif defined(FKP_RAGGED_PROBE)
        constexpr bool kWiden = false;
#else
        constexpr bool kWiden = true;
#endif
        uint4 raw[kEach];
#pragma unroll
        for (int u = 0; u < kEach; ++u) {
          const int i = wt + u * kWideners;
          if (kWhole || i < 2 * kPieces) {
            raw[u] = *reinterpret_cast<const uint4*>(
                bytes + i / kPieces * L::kByteTile + i % kPieces * 16);
          }
        }
#pragma unroll
        for (int u = 0; kWiden && u < kEach; ++u) {
          const int i = wt + u * kWideners;
          if (!kWhole && i >= 2 * kPieces) break;
          const int kv = i / kPieces;  // 0: K, 1: V
          const int r = i % kPieces / (D / 16);
          const int c = i % (D / 16) * 16;
          uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
          if (key0 + r < s) fkp::widen16<KV>(raw[u], lo, hi);
          // (row r, columns c..c+15) of the 128B-swizzled tile: box c / 64,
          // 16-byte chunks (c % 64) / 8 and the next, each at chunk ^ (r % 8)
          uint8_t* const box = base_ptr + ((kv ? v_s(st) : k_s(st)) - base) +
                               c / kBoxCols * L::kBox + r * 128;
          const int ch = c % kBoxCols / 8;
          *reinterpret_cast<uint4*>(box + ((ch ^ (r % 8)) << 4)) = lo;
          *reinterpret_cast<uint4*>(box + (((ch + 1) ^ (r % 8)) << 4)) = hi;
        }
        if (wt < L::kKeys) {
          sc[wt] = ks;
          sc[L::kKeys + wt] = vs;
        }
        fkp_sm90::fence_proxy_async();  // the tiles are wgmma's operands
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(full_bar(st));
          mbar_arrive(byte_empty(bs));
        }
      }
    }
    return;
  }

  if constexpr (!kQuant) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
  }
  const int wg = threadIdx.x / 128;
  const int warp = threadIdx.x / 32 % 4;  // in the warpgroup
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // accumulator row (and row + 8)
  const int t = lane % 4;  // accumulator column pair
  const int wg_first = row_first + wg * 64;      // the warpgroup's rows
  const int wg_last = min(wg_first + 64, n) - 1;  // < wg_first: none real
  const int row0 = wg_first + warp * 16 + g;
  const int row1 = row0 + 8;
  const int pos0 = row0 + q_offset;
  const int pos1 = row1 + q_offset;
  // the band: key j is in row i's band iff j > band(i) or j < sinks
  const int band0 = pos0 - window;
  const int band1 = pos1 - window;
  const int first_pos = wg_first + q_offset;
  const int last_pos = wg_last + q_offset;

  mbar_wait(q_bar, 0);
  // this warp's discipline (uniform in the warp): fixed-max keeps m at 0
  bool fixed = kDisc == kFixed;
  if constexpr (kDisc == kHybrid) {
    // ||q_r||^2 of rows row0 and row1 from the swizzled Q tile (16-byte
    // chunk c of tile row r lies at chunk c ^ (r % 8)): this thread's two
    // chunks a box, then the row's four threads; then the max over the
    // warp's 16 rows. Rows past n are zero-filled.
    const int r = wg * 64 + warp * 16 + g;  // row1 is r + 8: the same swizzle
    float n0 = 0.f, n1 = 0.f;
#pragma unroll
    for (int x = 0; x < L::kBoxes; ++x) {
#pragma unroll
      for (int c = 2 * t; c < 2 * t + 2; ++c) {
        const uint8_t* p =
            base_ptr + x * L::kQBox + r * 128 + ((c ^ (r % 8)) << 4);
        n0 += sq_bf16x8(*reinterpret_cast<const uint4*>(p));
        n1 += sq_bf16x8(*reinterpret_cast<const uint4*>(p + 8 * 128));
      }
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

  float acc[D / 2];  // O: element 4 * nd + e at (row0 if e < 2 else row1,
                     // column nd * 8 + 2t + (e & 1))
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sc[L::kKeys / 2];  // S, the same layout over the tile's keys; then p
#pragma unroll
  for (int i = 0; i < L::kKeys / 2; ++i) sc[i] = 0.f;
  // running max, log2 domain (fixed-max: 0 for the row's whole life)
  float m0 = fixed ? 0.f : kNegInf, m1 = m0;
  float l0 = 0.f, l1 = 0.f;  // this thread's share of the row sums
  uint32_t p_hi[L::kKeys / 16][4], p_lo[L::kKeys / 16][4];  // p as PV's A fragments
  // The loop is software-pipelined: tile j's S = Q K^T goes out with tile
  // j-1's O += P V, and tile j's softmax runs while that PV product is in
  // flight; O's rescale by tile j's max waits for it. So tile j-1's p
  // (p_hi/p_lo) and stage stay live across an iteration. Every wgmma issue
  // and wait lies on control flow uniform in the warpgroup.
  // (kProbeQKT: B is K^T [dim][key], read MN-major as O += P V reads V: 16
  // dim rows, 2048 bytes, a step down both 64-key boxes, D * 128 bytes apart)
  const auto issue_qk = [&](int st) {  // S = Q K^T, 16 dims (32 bytes) a step
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = kk % 4 * 32;
      const uint64_t dq =
          desc(q_s + kk / 4 * L::kQBox + wg * 64 * 128 + col, 16, 1024);
      if constexpr (kStage == kProbeQKT) {
        wgmma_ss_n128<0, 1>(sc, dq, desc(k_s(st) + kk * 2048, D * 128, 1024),
                            kk > 0);
      } else {
        const uint64_t dk = desc(k_s(st) + kk / 4 * L::kBox + col, 16, 1024);
        if constexpr (L::kKeys == 128) {
          wgmma_ss_n128(sc, dq, dk, kk > 0);
        } else {
          wgmma_ss_n64<0, 0>(sc, dq, dk, kk > 0);
        }
      }
    }
    wgmma_commit();
  };
  // O += P V: the hi product, then the lo one, over 16 keys at a time (a
  // 2048-byte step down V's rows); V's 64-dim boxes are the MN-major atoms,
  // one box apart
  const auto issue_pv = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < L::kKeys / 16; ++kk) {
      const uint64_t dv = desc(v_s(st) + kk * 2048, L::kBox, 1024);
      wgmma_rs<D>(acc, p_hi[kk], dv);
      wgmma_rs<D>(acc, p_lo[kk], dv);
    }
    wgmma_commit();
  };
  const auto release = [&](int st) {  // this warp is done with the stage
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar(st));
  };
  // The tile's softmax in one discipline (kF: fixed-max), with or without
  // the mask, into sc in place: p = exp2(s - m), l sums p in f32. A masked
  // score is -inf: it leaves the max alone (m starts at the finite NEG_INF
  // and only rises, so it stays finite) and its p = exp2(-inf - m) is
  // exactly 0, as the mma.sync kernel's second test of the mask made it,
  // without keeping the tile's 64 mask bits live. Online, r0 and r1 are
  // the factors O takes for the new max (1 for a fixed-max warp).
  float r0 = 1.f, r1 = 1.f;
  // the stage's scales (8-bit): K's 64 then V's, 0 past kv_len
  const auto scales = [&](int st) {
    return reinterpret_cast<const float*>(base_ptr + (sc_s(st) - base));
  };
  // (8-bit: the K scale of each key multiplies its score column with the
  // log2-domain scale, before the mask and the max)
  const auto softmax = [&](int key0, const float* ksc, auto fixed_max,
                           auto masked) {
    constexpr bool kF = decltype(fixed_max)::value;
    constexpr bool kMask = decltype(masked)::value;
    // element e of n-tile nt: (row0 if e < 2 else row1,
    // key0 + nt * 8 + 2t + (e & 1))
    const auto visible = [&](int nt, int e) {
      const int col = key0 + nt * 8 + 2 * t + (e & 1);
      const int pos = e < 2 ? pos0 : pos1;
      const int band = e < 2 ? band0 : band1;
      return col < s && (!causal || (col <= pos && (!kWindow || col > band ||
                                                    col < sinks)));
    };
    [[maybe_unused]] float tmax0 = kNegInf, tmax1 = kNegInf;  // online
#pragma unroll
    for (int nt = 0; nt < L::kKeys / 8; ++nt) {
      [[maybe_unused]] float2 kpair;
      if constexpr (kQuant) {
        kpair = *reinterpret_cast<const float2*>(ksc + nt * 8 + 2 * t);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = sc[4 * nt + e];
        float sl = scale_log2;
        if constexpr (kQuant) sl *= (e & 1) ? kpair.y : kpair.x;
        if constexpr (kMask) {
          x = visible(nt, e) ? x * sl : __int_as_float(0xff800000);
        } else {
          x *= sl;
        }
        if constexpr (!kF) {
          if (e < 2) {
            tmax0 = fmaxf(tmax0, x);
          } else {
            tmax1 = fmaxf(tmax1, x);
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
      r0 = exp2f(m0 - mn0);
      r1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      l0 *= r0;
      l1 *= r1;
    }
#pragma unroll
    for (int nt = 0; nt < L::kKeys / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = sc[4 * nt + e];
        x = kF ? exp2f(x) : exp2f(x - (e < 2 ? m0 : m1));
      }
      l0 += sc[4 * nt] + sc[4 * nt + 1];
      l1 += sc[4 * nt + 2] + sc[4 * nt + 3];
    }
  };
  // tile `it`'s softmax in this warp's discipline, masked unless every
  // row of the warpgroup sees every key of it (uniform in the warpgroup):
  // below s, below the first row's diagonal, and all sinks or inside the
  // last row's band
  const auto tile_softmax = [&](int it) {
    const int key0 = tile_of(it) * L::kKeys;
    const float* const ksc = kQuant ? scales(it % L::kStages) : nullptr;
    const bool full = key0 + L::kKeys <= s &&
                      (!causal || key0 + L::kKeys - 1 <= first_pos) &&
                      (!kWindow || key0 + L::kKeys <= sinks ||
                       key0 > last_pos - window);
    const auto run = [&](auto masked) {
      if constexpr (kDisc == kHybrid) {
        if (fixed) {  // uniform in the warp; no wgmma inside
          softmax(key0, ksc, Bool<true>{}, masked);
        } else {
          softmax(key0, ksc, Bool<false>{}, masked);
        }
      } else {
        softmax(key0, ksc, Bool<kDisc == kFixed>{}, masked);
      }
    };
    if (full) {
      run(Bool<false>{});
    } else {
      run(Bool<true>{});
    }
  };
  // O's rescale (online, and the hybrid's online warps), then p into the A
  // fragments as a bf16 hi + lo pair: fragment kk holds keys 16kk..16kk+15,
  // n-tiles 2kk and 2kk + 1. 8-bit: each key's V scale folds into its p
  // column first (l has summed p without it), from stage st's scales.
  const auto to_fragments = [&]([[maybe_unused]] int st) {
    if constexpr (kQuant) {
      const float* const vsc = scales(st) + L::kKeys;
#pragma unroll
      for (int nt = 0; nt < L::kKeys / 8; ++nt) {
        const float2 vpair = *reinterpret_cast<const float2*>(vsc + nt * 8 + 2 * t);
        sc[4 * nt] *= vpair.x;
        sc[4 * nt + 1] *= vpair.y;
        sc[4 * nt + 2] *= vpair.x;
        sc[4 * nt + 3] *= vpair.y;
      }
    }
    if (kDisc == kOnline || (kDisc == kHybrid && !fixed)) {
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        acc[4 * nd] *= r0;
        acc[4 * nd + 1] *= r0;
        acc[4 * nd + 2] *= r1;
        acc[4 * nd + 3] *= r1;
      }
    }
#pragma unroll
    for (int kk = 0; kk < L::kKeys / 16; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nt = 2 * kk + half;
        split_bf16(sc[4 * nt], sc[4 * nt + 1], p_hi[kk][2 * half],
                   p_lo[kk][2 * half]);
        split_bf16(sc[4 * nt + 2], sc[4 * nt + 3], p_hi[kk][2 * half + 1],
                   p_lo[kk][2 * half + 1]);
      }
    }
  };
  // Ping-pong (128-row blocks): the two warpgroups take turns to issue
  // their products (named barriers 1 and 2 over 256 threads: one
  // warpgroup waits there, the other arrives), so that one's softmax runs
  // under the other's products. Warpgroup 1 lets warpgroup 0 go first and
  // skips its last arrival, so that every arrival is waited for.
  const int turn = 1 + wg;
  const int other_turn = 2 - wg;
  if constexpr (kStage != kForward) {
    static_assert(!kQuant && !kRagged && !kWindow && kDisc == kOnline,
                  "the probes run the bf16 online block without a band");
    // Q's column 0 at row rr of the tile (row rr's first 16-byte chunk lies
    // at chunk rr % 8 of its 128-byte row; rows past n are zeros)
    const int qrow = wg * 64 + warp * 16 + g;  // row0's row of the tile
    const auto col0 = [&](int rr) {
      return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
          base_ptr + rr * 128 + ((rr % 8) << 4)));
    };
    if constexpr (kStage == kProbePV) {
      // p = q[row, 0] at every key, into the A fragments the softmax fills
      const float x0 = col0(qrow), x1 = col0(qrow + 8);
#pragma unroll
      for (int kk = 0; kk < L::kKeys / 16; ++kk) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          split_bf16(x0, x0, p_hi[kk][2 * half], p_lo[kk][2 * half]);
          split_bf16(x1, x1, p_hi[kk][2 * half + 1], p_lo[kk][2 * half + 1]);
        }
      }
    }
    // kProbeChain: row i's scores are q[i, 0] * 0.001 at every key (JAX's
    // synthesized tile) plus zero * key, where zero is 0 for every block_k
    // the entry takes (>= 1) but read at run time: the compiler cannot
    // prove a row's scores equal, so it keeps one exp2 a score in the key
    // loop instead of hoisting it (zc: zero times the thread's key offsets
    // in a tile, element e of n-tile nt at 8 nt + 2t + (e & 1))
    [[maybe_unused]] float base0 = 0.f, base1 = 0.f, zero = 0.f;
    [[maybe_unused]] float zc[L::kKeys / 4];
    if constexpr (kStage == kProbeChain) {
      base0 = col0(qrow) * 0.001f;
      base1 = col0(qrow + 8) * 0.001f;
      zero = static_cast<float>(block_k < 1);
#pragma unroll
      for (int i = 0; i < L::kKeys / 4; ++i) {
        zc[i] = zero * static_cast<float>(i / 2 * 8 + 2 * t + i % 2);
      }
    }
    float rs0 = 0.f, rs1 = 0.f;  // QK: this thread's share of the score sums
    constexpr bool kProducts = kStage != kProbeCopy && kStage != kProbeChain;
    if (kProducts && kPingPong && wg == 1 && n_visit > 0) named_arrive(other_turn);
    for (int it = 0; it < n_visit; ++it) {
      const int st = it % L::kStages;
      mbar_wait(full_bar(st), (it / L::kStages) & 1);
      if constexpr (kStage == kProbeCopy) {
        // the tile's rows j * block_k, in key order: acc += f32(k) + f32(v)
        // at this thread's columns 8nd + 2t, + 1 (box nd / 8, 16-byte chunk
        // nd % 8, swizzled by the row)
        const int key0 = tile_of(it) * L::kKeys;
        for (int r = (block_k - key0 % block_k) % block_k;
             r < L::kKeys && key0 + r < s; r += block_k) {
#pragma unroll
          for (int nd = 0; nd < D / 8; ++nd) {
            const uint32_t at = nd / 8 * L::kBox + r * 128 +
                                (((nd % 8) ^ (r % 8)) << 4) + 4 * t;
            const float2 kf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                base_ptr + (k_s(st) - base) + at));
            const float2 vf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                base_ptr + (v_s(st) - base) + at));
            acc[4 * nd] += kf.x + vf.x;
            acc[4 * nd + 1] += kf.y + vf.y;
          }
        }
      } else if constexpr (kStage == kProbeChain) {
        // the tile's scores into S's registers, as the QK product fills
        // them; the forward's softmax on them (online, masked past s); then,
        // in place of O += P V, acc = acc * r + the row's sum of p. The sum
        // is the one the softmax adds to l (JAX's chain also sums p once
        // for both): this thread's share, l's increment over the rescaled
        // l, with acc a share of the row's too, summed over the row's four
        // threads at the end as l is
        const float zk = zero * static_cast<float>(tile_of(it) * L::kKeys);
        const float b0 = base0 + zk, b1 = base1 + zk;
#pragma unroll
        for (int nt = 0; nt < L::kKeys / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sc[4 * nt + e] = (e < 2 ? b0 : b1) + zc[2 * nt + (e & 1)];
          }
        }
        const float l0_was = l0, l1_was = l1;
        tile_softmax(it);
        const float ps0 = l0 - l0_was * r0, ps1 = l1 - l1_was * r1;
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
          acc[4 * nd] = acc[4 * nd] * r0 + ps0;
          acc[4 * nd + 1] = acc[4 * nd + 1] * r0 + ps0;
          acc[4 * nd + 2] = acc[4 * nd + 2] * r1 + ps1;
          acc[4 * nd + 3] = acc[4 * nd + 3] * r1 + ps1;
        }
      } else {
        if (kPingPong) named_sync(turn);
        wgmma_fence();
        if constexpr (kQKStage) {
          issue_qk(st);
        } else {
          issue_pv(st);
        }
        if (kPingPong && (wg == 0 || it + 1 < n_visit)) named_arrive(other_turn);
        wgmma_wait<0>();
        if constexpr (kQKStage) {
          pin(sc);
#pragma unroll
          for (int nt = 0; nt < L::kKeys / 8; ++nt) {
            rs0 += sc[4 * nt] + sc[4 * nt + 1];
            rs1 += sc[4 * nt + 2] + sc[4 * nt + 3];
          }
        } else {
          pin(acc);
        }
      }
      release(st);
    }
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
    if constexpr (kStage == kProbeChain) {  // the rows' acc and l, then acc / (l + 1e-6)
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 1);
        acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 2);
      }
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      l0 += 1e-6f;
      l1 += 1e-6f;
    }
    float* const out = reinterpret_cast<float*>(o) + ((size_t)b * hq + h) * n * D;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const int c = nd * 8 + 2 * t;
      float2 w0, w1;
      if constexpr (kStage == kProbeCopy) {  // every row holds the same sums
        w0 = w1 = make_float2(acc[4 * nd], acc[4 * nd + 1]);
      } else if constexpr (kQKStage) {
        w0 = make_float2(rs0, rs0);
        w1 = make_float2(rs1, rs1);
      } else if constexpr (kStage == kProbeChain) {
        w0 = make_float2(acc[4 * nd] / l0, acc[4 * nd + 1] / l0);
        w1 = make_float2(acc[4 * nd + 2] / l1, acc[4 * nd + 3] / l1);
      } else {
        w0 = make_float2(acc[4 * nd], acc[4 * nd + 1]);
        w1 = make_float2(acc[4 * nd + 2], acc[4 * nd + 3]);
      }
      if (row0 < n) *reinterpret_cast<float2*>(out + (size_t)row0 * D + c) = w0;
      if (row1 < n) *reinterpret_cast<float2*>(out + (size_t)row1 * D + c) = w1;
    }
    return;
  }
  if (n_visit > 0) {
    if (kPingPong && wg == 1) named_arrive(other_turn);
    mbar_wait(full_bar(0), 0);
    if (kPingPong) named_sync(turn);
    wgmma_fence();
    issue_qk(0);
    if (kPingPong && (wg == 0 || n_visit > 1)) named_arrive(other_turn);
    wgmma_wait<0>();
    pin(sc);
    tile_softmax(0);
    to_fragments(0);
    for (int it = 1; it < n_visit; ++it) {
      const int st = it % L::kStages;
      const int prev = (it - 1) % L::kStages;
      mbar_wait(full_bar(st), (it / L::kStages) & 1);
      if (kPingPong) named_sync(turn);
      wgmma_fence();
      issue_qk(st);
      issue_pv(prev);
      if (kPingPong && (wg == 0 || it + 1 < n_visit)) {
        named_arrive(other_turn);
      }
      wgmma_wait<1>();  // S; the previous tile's PV may still run
      pin(sc);
      tile_softmax(it);
      wgmma_wait<0>();
      pin(acc);
      pin(sc);
      release(prev);
      to_fragments(st);
    }
    const int last = (n_visit - 1) % L::kStages;
    wgmma_fence();
    issue_pv(last);
    wgmma_wait<0>();
    pin(acc);
    release(last);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  // a row with no visible key has l == 0 and acc == 0: output 0, LSE NEG_INF
  const float safe0 = l0 == 0.f ? 1.f : l0;
  const float safe1 = l1 == 0.f ? 1.f : l1;
  const size_t bh = (size_t)b * hq + h;
  __nv_bfloat16* o_bh = o + bh * n * D;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (row0 < n) {
      *reinterpret_cast<__nv_bfloat162*>(o_bh + (size_t)row0 * D + c) =
          __floats2bfloat162_rn(acc[4 * nd] / safe0, acc[4 * nd + 1] / safe0);
    }
    if (row1 < n) {
      *reinterpret_cast<__nv_bfloat162*>(o_bh + (size_t)row1 * D + c) =
          __floats2bfloat162_rn(acc[4 * nd + 2] / safe1,
                                acc[4 * nd + 3] / safe1);
    }
  }
  if (!kRagged && t == 0) {
    float* lse_bh = lse + bh * n;
    if (row0 < n) lse_bh[row0] = l0 == 0.f ? kNegInf : m0 * kLn2 + logf(l0);
    if (row1 < n) lse_bh[row1] = l1 == 0.f ? kNegInf : m1 * kLn2 + logf(l1);
  }
  if constexpr (kDisc == kFixed && !kRagged) {
    if (gd.count != nullptr) {
      // The fixed-max range guard, as flash_fwd_core.cuh's epilogue: a row
      // breaches when l is not finite or leaves [2^-100, 2^120], or an
      // element of its acc is not finite; only real rows count (row < n,
      // and, when causal, a position >= 0). Each warp adds its count once.
      int nf0 = 0, nf1 = 0;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        nf0 |= !isfinite(acc[4 * nd]) || !isfinite(acc[4 * nd + 1]);
        nf1 |= !isfinite(acc[4 * nd + 2]) || !isfinite(acc[4 * nd + 3]);
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
               fkp_fwd::first_of_pair(gd.pairs, b, h, hq, hkv, n, row);
      };
      const int cnt =
          __popc(__ballot_sync(0xffffffffu, counts(row0, pos0, l0, nf0))) +
          __popc(__ballot_sync(0xffffffffu, counts(row1, pos1, l1, nf1)));
      if (lane == 0 && cnt > 0) atomicAdd(gd.count, cnt);
    }
  }
}

// The dense forward: instance <D, kWindow, kDisc, kRows> over bf16 K/V.
template <int D, bool kWindow, int kDisc, int kRows>
__global__ void __launch_bounds__(Block<kRows>::kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int hq, int hkv, int n,
                          int s, float scale_log2, int causal, int q_offset,
                          int window, int sinks,
                          const float* __restrict__ k_max, GuardArgs gd) {
  fwd_block<D, kWindow, kDisc, kRows, __nv_bfloat16, false>(
      &q_map, &k_map, &v_map, o, lse, hq, hkv, n, s, scale_log2, causal,
      q_offset, window, sinks, k_max, gd, RaggedPtrs{});
}

// The dense forward over an 8-bit cache (flash_attention_kv_quant):
// instance <D, kWindow, kDisc, kRows, KV (int8_t or __nv_fp8_e4m3)> over
// K/V [b, hkv, s, D] bytes with per-token scales k_scale, v_scale [b,
// hkv, s, 1] f32; O, LSE and the fixed-max guard as the bf16 kernel's.
template <int D, bool kWindow, int kDisc, int kRows, class KV>
__global__ void __launch_bounds__(Block<kRows, true>::kThreads, 1)
    flash_fwd_q_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            __nv_bfloat16* __restrict__ o,
                            float* __restrict__ lse, int hq, int hkv, int n,
                            int s, float scale_log2, int causal, int q_offset,
                            int window, int sinks,
                            const float* __restrict__ k_max, GuardArgs gd,
                            const float* __restrict__ k_scale,
                            const float* __restrict__ v_scale) {
  fwd_block<D, kWindow, kDisc, kRows, KV, false>(
      &q_map, &k_map, &v_map, o, lse, hq, hkv, n, s, scale_log2, causal,
      q_offset, window, sinks, k_max, gd,
      RaggedPtrs{nullptr, nullptr, k_scale, v_scale});
}

// The ragged forward's wgmma route (the prefill chunks): instance <D,
// kWindow, kDisc (online or fixed-max), kRows, KV (bf16, int8_t or
// __nv_fp8_e4m3; 8-bit at 64 rows only)> over a cache [b, hkv, s_max, D].
template <int D, bool kWindow, int kDisc, int kRows, class KV>
__global__ void __launch_bounds__(Block<kRows, sizeof(KV) == 1>::kThreads, 1)
    flash_fwd_ragged_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                                 const __grid_constant__ CUtensorMap k_map,
                                 const __grid_constant__ CUtensorMap v_map,
                                 __nv_bfloat16* __restrict__ o, int hq,
                                 int hkv, int n, int s_max, float scale_log2,
                                 int causal, int window, int sinks,
                                 RaggedPtrs rp) {
  fwd_block<D, kWindow, kDisc, kRows, KV, true>(
      &q_map, &k_map, &v_map, o, nullptr, hq, hkv, n, s_max, scale_log2,
      causal, 0, window, sinks, nullptr, GuardArgs{}, rp);
}

// What fkp_flash_fwd passes to the instance it launches.
struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  void* lse;
  const float* k_max;
  GuardArgs gd;
  int b, hq, hkv, n, s;
  float scale_log2;
  int causal, q_offset, window, sinks;
  cudaStream_t stream;
  // the 8-bit forward's per-token scales [b, hkv, s, 1] f32 (null for bf16)
  const float* k_scale = nullptr;
  const float* v_scale = nullptr;
};

// Launches instance <D, kWindow, kDisc, kRows>; returns a CUDA error code
// (the shared-memory attribute's, cudaErrorInvalidValue where a map cannot
// be encoded, else cudaGetLastError() after the launch).
template <int D, bool kWindow, int kDisc, int kRows>
int launch(const FwdArgs& a) {
  const auto kernel = &flash_fwd_sm90_kernel<D, kWindow, kDisc, kRows>;
  constexpr int kBytes = Layout<D, kRows>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap qm, km, vm;
  if (!encode_map(&qm, a.q, D, a.n, a.b * a.hq, kRows) ||
      !encode_map(&km, a.k, D, a.s, a.b * a.hkv, kN) ||
      !encode_map(&vm, a.v, D, a.s, a.b * a.hkv, kN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((a.n + kRows - 1) / kRows, a.hq, a.b);
  kernel<<<grid, Block<kRows>::kThreads, kBytes, a.stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(a.o), static_cast<float*>(a.lse),
      a.hq, a.hkv, a.n, a.s, a.scale_log2, a.causal, a.q_offset, a.window,
      a.sinks, a.k_max, a.gd);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of 64 query rows where their grid fits in one wave of the card's
// SMs (the serving prefill: 512 tokens at 16 q heads make 128 blocks), 128
// elsewhere. A 64-row block has one consumer warpgroup, so no ping-pong,
// and each K/V tile serves half the rows: on the H100 it ran 11-16% faster
// than a 128-row one at 256 and 512 tokens and 19-37% slower from 1024 up
// (PERF.md).
inline int block_rows(const FwdArgs& a) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return 128;
  }
  return (long long)((a.n + 63) / 64) * a.hq * a.b <= sms ? 64 : 128;
}

// The instances of one discipline, by d (64 or 128), band and block rows;
// -1 for another d. flash_fwd.cu builds kOnline's, flash_fwd_fixed.cu
// kFixed's and flash_fwd_hybrid.cu kHybrid's, each in its own nvcc process.
template <int kDisc>
int launch_disc(int d, const FwdArgs& a) {
  const auto by_rows = [&](auto D, auto W) {
    constexpr int kD = decltype(D)::value;
    constexpr bool kW = decltype(W)::value;
    return block_rows(a) == 64 ? launch<kD, kW, kDisc, 64>(a)
                               : launch<kD, kW, kDisc, 128>(a);
  };
  const auto by_band = [&](auto D) {
    return a.window > 0 ? by_rows(D, std::true_type{})
                        : by_rows(D, std::false_type{});
  };
  if (d == 64) return by_band(std::integral_constant<int, 64>{});
  if (d == 128) return by_band(std::integral_constant<int, 128>{});
  return -1;
}

int launch_fixed(int d, const FwdArgs& a);   // flash_fwd_fixed.cu
int launch_hybrid(int d, const FwdArgs& a);  // flash_fwd_hybrid.cu

// The TMA maps of an 8-bit K and V [heads, s, d] for the 8-bit instances:
// whole rows of d bytes, unswizzled, `keys` rows a box; false if either
// cannot be encoded.
inline bool encode_byte_maps(CUtensorMap* km, CUtensorMap* vm, const void* k,
                             const void* v, int d, int s, int heads, int keys) {
  return encode_tiled(km, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, k, d, s, heads,
                      keys, d, CU_TENSOR_MAP_SWIZZLE_NONE) &&
         encode_tiled(vm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, v, d, s, heads,
                      keys, d, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// Launches the 8-bit instance <D, kWindow, kDisc, kRows, KV>; returns a
// CUDA error code as `launch`.
template <int D, bool kWindow, int kDisc, int kRows, class KV>
int launch_q(const FwdArgs& a) {
  using L = Layout<D, kRows, KV>;
  const auto kernel = &flash_fwd_q_sm90_kernel<D, kWindow, kDisc, kRows, KV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap qm, km, vm;
  if (!encode_map(&qm, a.q, D, a.n, a.b * a.hq, kRows) ||
      !encode_byte_maps(&km, &vm, a.k, a.v, D, a.s, a.b * a.hkv, L::kKeys)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((a.n + kRows - 1) / kRows, a.hq, a.b);
  kernel<<<grid, Block<kRows, true>::kThreads, L::kBytes, a.stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(a.o), static_cast<float*>(a.lse),
      a.hq, a.hkv, a.n, a.s, a.scale_log2, a.causal, a.q_offset, a.window,
      a.sinks, a.k_max, a.gd, a.k_scale, a.v_scale);
  return static_cast<int>(cudaGetLastError());
}

// The 8-bit instances of one cache type and discipline, by d (64 or 128),
// band and block rows (block_rows, as the bf16 forward picks them). The
// hybrid and the banded instances take 64-row blocks alone: at 128 rows,
// with both softmax paths or the band's terms, their consumers spilled at
// d 128 within the 168 registers a thread (and with a setmaxnreg split the
// widening warps did), while the hybrid's 64-row blocks ran within 4% of
// its 128-row ones. -1 for another d.
template <class KV, int kDisc>
int launch_q_disc(int d, const FwdArgs& a) {
  const auto by_rows = [&](auto D, auto W) {
    constexpr int kD = decltype(D)::value;
    constexpr bool kW = decltype(W)::value;
    if constexpr (kDisc == fkp_fwd::kHybrid || kW) {
      return launch_q<kD, kW, kDisc, 64, KV>(a);
    } else {
      return block_rows(a) == 64 ? launch_q<kD, kW, kDisc, 64, KV>(a)
                                 : launch_q<kD, kW, kDisc, 128, KV>(a);
    }
  };
  const auto by_band = [&](auto D) {
    return a.window > 0 ? by_rows(D, std::true_type{})
                        : by_rows(D, std::false_type{});
  };
  if (d == 64) return by_band(std::integral_constant<int, 64>{});
  if (d == 128) return by_band(std::integral_constant<int, 128>{});
  return -1;
}

// The dense 8-bit instances by source, one cache type and discipline
// each, so that nvcc builds them in parallel: int8 flash_fwd_q.cu (online,
// with the C entry), flash_fwd_q_fixed.cu and flash_fwd_q_hybrid.cu; e4m3
// flash_fwd_q_fp8.cu, flash_fwd_q_fp8_fixed.cu and
// flash_fwd_q_fp8_hybrid.cu.
int launch_q_int8_fixed(int d, const FwdArgs& a);
int launch_q_int8_hybrid(int d, const FwdArgs& a);
int launch_q_e4m3(int d, const FwdArgs& a);
int launch_q_e4m3_fixed(int d, const FwdArgs& a);
int launch_q_e4m3_hybrid(int d, const FwdArgs& a);

// What fkp_flash_fwd_ragged passes to the wgmma route's instance: rows
// the block rows (64 or 128; the 8-bit instances take 64).
struct RaggedArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  RaggedPtrs rp;
  int b, hq, hkv, n, s_max;
  float scale_log2;
  int causal, window, sinks, rows;
  cudaStream_t stream;
};

// Launches the ragged instance <D, kWindow, kDisc, kRows, KV>; returns a
// CUDA error code as `launch`.
template <int D, bool kWindow, int kDisc, int kRows, class KV>
int launch_ragged(const RaggedArgs& a) {
  using L = Layout<D, kRows, KV>;
  const auto kernel = &flash_fwd_ragged_sm90_kernel<D, kWindow, kDisc, kRows, KV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap qm, km, vm;
  bool ok = encode_map(&qm, a.q, D, a.n, a.b * a.hq, kRows);
  if constexpr (L::kQuant) {
    ok = ok && encode_byte_maps(&km, &vm, a.k, a.v, D, a.s_max, a.b * a.hkv,
                                L::kKeys);
  } else {
    ok = ok && encode_map(&km, a.k, D, a.s_max, a.b * a.hkv, L::kKeys) &&
         encode_map(&vm, a.v, D, a.s_max, a.b * a.hkv, L::kKeys);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((a.n + kRows - 1) / kRows, a.hq, a.b);
  kernel<<<grid, Block<kRows, L::kQuant>::kThreads, L::kBytes, a.stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(a.o), a.hq, a.hkv, a.n, a.s_max,
      a.scale_log2, a.causal, a.window, a.sinks, a.rp);
  return static_cast<int>(cudaGetLastError());
}

// The ragged instances of one cache type and discipline, by d (64 or
// 128), band and block rows; cudaErrorInvalidValue for another d or rows.
template <class KV, int kDisc>
int launch_ragged_disc(int d, const RaggedArgs& a) {
  const auto by_rows = [&](auto D, auto W) {
    constexpr int kD = decltype(D)::value;
    constexpr bool kW = decltype(W)::value;
    if (a.rows == 64) return launch_ragged<kD, kW, kDisc, 64, KV>(a);
    if constexpr (sizeof(KV) == 2) {
      if (a.rows == 128) return launch_ragged<kD, kW, kDisc, 128, KV>(a);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  };
  const auto by_band = [&](auto D) {
    return a.window > 0 ? by_rows(D, std::true_type{})
                        : by_rows(D, std::false_type{});
  };
  if (d == 64) return by_band(std::integral_constant<int, 64>{});
  if (d == 128) return by_band(std::integral_constant<int, 128>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// The ragged instances by source, so that nvcc builds them in parallel:
// bf16 online (with the C entries) flash_fwd_ragged.cu, bf16 fixed-max
// flash_fwd_ragged_fixed.cu, int8 flash_fwd_ragged_q.cu and e4m3
// flash_fwd_ragged_fp8.cu, each 8-bit source both disciplines.
int launch_ragged_fixed(int d, const RaggedArgs& a);
int launch_ragged_int8(int d, int disc, const RaggedArgs& a);
int launch_ragged_e4m3(int d, int disc, const RaggedArgs& a);

}  // namespace fkp_sm90
