// The attention backward for Hopper (sm_90a), kernel A: dK and dV, and in
// the fused-dq schedule dQ's partials too. wgmma, TMA and a Q/dO ring.
// flash_bwd_kv64.cu, flash_bwd_kv128.cu, flash_bwd_fused64.cu and
// flash_bwd_fused128.cu each build the instances of one (d, kFuseDq) from
// this header, with and without a band (kWindow): 8 instances in all. The
// Hopper primitives are sm90.cuh's; kernel B (dQ alone, the two-kernel
// schedule) is flash_bwd_dq_sm90.cuh's; flash_bwd.cu holds the entries.
//
// Replaces flashattention_kernel_project_tpu/ops/flash_attention.py::
// _bwd_dkdv_kernel (:1949, pallas_call :2553) in both of its modes: the
// FlashAttention-2 recompute from the forward's saved logsumexp,
// KV-stationary as JAX's grid (b, hkv, n_kv, group * n_q). For each key it
// sums, over every query of the GQA group that sees it,
//   p   = exp2(s * sm_scale * log2e - lse * log2e)  (masked: 0)
//   dV += p dO,   dS = p (dO.v - delta),   dK += sm_scale dS q
// with delta = rowsum(O * dO) and lse * log2e computed by the wrapper, and
// with kFuseDq (JAX fuse_dq=True) also each (query tile, key block) pair's
// dQ partial dS K, summed into an f32 dq_accum by reduce-adds in L2 (JAX
// writes the partials out and sums them in XLA; Hopper's f32 reduce-adds
// are FlashAttention-2's and -3's answer). Scores, p, dS and the
// accumulators are f32; p and dS are rounded to bf16 only as wgmma
// operands. A query row that sees no key (lse = NEG_INF) contributes
// nothing: its p is masked to 0.
//
// What bounds it on the H100: four products of 2*d flops per visible
// (query, key) pair (five with dQ) against K/V read once and Q, dO, lse
// and delta once per key block: far above the ~295 flop/byte ridge at
// training shapes, so tensor-core issue and the elementwise chain between
// the products bound it; with kFuseDq also the reduce-adds, 32 KB per
// (64-row query tile, 128-key block) pair into L2. The mma.sync design it
// replaces reached 15% of its bound: ldmatrix fragments, loads through
// registers between two block barriers, 32-row query tiles and masks on
// every tile. What each choice here does about that:
// - One block a (128-key block, KV head, batch), the key block the grid's
//   slow dimension, so that the heaviest blocks (the low ones: causal, they
//   see the most queries; with a window they hold the sinks) start first
//   across every head and batch: two consumer warpgroups of 64 keys each
//   and a producer warpgroup that gives its registers to them (setmaxnreg
//   24 and 240). K and V are loaded once by TMA and stay in
//   shared memory; dK and dV (64 + 64 f32 a thread at d = 128) stay in
//   registers for the block's life and are written once, the GQA group
//   summed inside the block with no atomics.
// - The producer streams the group's q heads x their live 64-row Q and dO
//   tiles (boxes of 64 rows x 64 dims, 128B-swizzled, zero past n), with
//   lse and delta (1-D bulk loads from the wrapper's arrays, padded to 64
//   rows), through a ring of 3 stages with full/empty mbarriers: the next
//   tile loads while the consumers compute. The live tiles are the
//   causally live ones; with a window those whose rows still hold a key of
//   the block in their band, all of them where the block holds sink keys.
// - The products, per consumer warpgroup (M = its 64 keys):
//     S^T  = K Q^T     wgmma SS, both K-major (the forward's QK)
//     dP^T = V dO^T    wgmma SS
//     dV  += P^T dO    wgmma RS: P^T repacked from its accumulator to bf16
//                      A fragments; dO read MN-major (the forward's V)
//     dK  += dS^T Q    wgmma RS, Q read MN-major
//   with kFuseDq, dS^T also goes to shared memory in bf16 ([128 keys][64
//   rows], 128B-swizzled, two buffers) and dQ = dS K is a wgmma SS with dS
//   read transposed (MN-major A) and K MN-major. At d = 128 each warpgroup
//   takes 64 of dQ's columns over the block's 128 keys (a named barrier
//   over both warpgroups orders the dS^T writes before the reads); at d =
//   64 each takes its own 64 keys, all columns. Either way a warpgroup adds
//   64 x 64 f32 a tile: it writes them to a staging tile in shared memory
//   (two 128B-swizzled boxes of 32 columns) and one thread adds them to
//   dq_accum by two TMA tensor reduce-adds (cp.reduce.async.bulk), rows
//   past n clipped by the map. 16-byte atomics from registers took 0.73
//   ms at the training shape on the H100, the TMA reduce-adds 0.31
//   (PERF.md).
// - The mask only on tiles that cross the causal diagonal, a band edge or a
//   tail, classified once per warpgroup; the other tiles take a copy of the
//   elementwise code compiled without it. Every wgmma issue and wait lies
//   on control flow uniform in the warpgroup.
// Tried and dropped (PERF.md): 16-byte atomics for the dq reduce (above);
// the forward's ping-pong of the two warpgroups' product groups (within 3%
// either way at the four timed shapes on the H100).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"
#include "sm90.cuh"

// The probes of tools/ab_bwd.py's builds (-DFKP_BWD_PROBE; the library
// builds 0, the kernel): with kFuseDq, 1 computes dQ's partials but adds
// none of them to dq_accum, 2 computes none (dS^T is still written to
// shared memory). Their times against 0 say what the reduce-adds and the
// dQ product cost (PERF.md); their dq is wrong, so they are never a path.
#ifndef FKP_BWD_PROBE
#define FKP_BWD_PROBE 0
#endif

namespace fkp_bwd_sm90 {

using namespace fkp_sm90;
using fkp_mma::pack_bf16;

template <bool B>
using Bool = std::integral_constant<bool, B>;

constexpr int kKeys = 128;          // keys a block: a warpgroup's 64 each
constexpr int kRows = 64;           // query rows a ring stage (lse padding)
constexpr int kConsumers = 256;     // the two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
// registers a thread after setmaxnreg: the producer gives up what the
// consumers take (128 * 24 + 256 * 240 <= 65536)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;

// What the entries pass to the instance they launch. lse2 and delta are
// [b * hq, n_pad] f32 (n_pad = n rounded up to 64 rows; lse2 = lse * log2e).
struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse2;
  const float* delta;
  void* dk;
  void* dv;
  void* dq;  // kernel A: the f32 dq_accum (kFuseDq); kernel B: bf16 dq
  int b, hq, hkv, n, s;
  float sm_scale;
  int causal, q_offset, window, sinks;
  cudaStream_t stream;
};

__host__ __device__ inline int padded_rows(int n) {
  return (n + kRows - 1) / kRows * kRows;
}

// Shared memory of kernel A at (d, kFuseDq): K and V (boxes of 128 keys x
// 64 dims), with kFuseDq two dS^T buffers and the two warpgroups' dQ
// staging tiles, the ring's Q and dO tiles
// (boxes of 64 rows), every box 1024-byte aligned (the 128B swizzle's
// period), then each stage's lse and delta (64 f32 each), after up to 1 KB
// of alignment slack.
template <int D, bool kFuseDq>
struct Layout {
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kStages = 3;
  static constexpr int kKBox = kKeys * 128;
  static constexpr int kKTile = kBoxes * kKBox;  // K or V
  static constexpr int kQBox = kRows * 128;
  static constexpr int kQTile = kBoxes * kQBox;  // Q or dO
  static constexpr int kDs = kKeys * kRows * 2;  // a dS^T buffer
  static constexpr int kDsBytes = kFuseDq ? 2 * kDs : 0;
  // with kFuseDq, each warpgroup's 64 x 64 f32 dQ partial as two
  // 128B-swizzled boxes of 32 columns, the TMA reduce-adds' source
  static constexpr int kDqStage = kRows * 64 * 4;
  static constexpr int kDqBytes = kFuseDq ? 2 * kDqStage : 0;
  static constexpr int kRing = kStages * 2 * kQTile;
  static constexpr int kRowBytes = 2 * kRows * 4;  // lse and delta a stage
  static constexpr int kBytes = 1024 + 2 * kKTile + kDsBytes + kDqBytes +
                                kRing + kStages * kRowBytes;
};

// One block per (KV head and batch, 128-key block): the first 256 threads are
// the consumer warpgroups, 64 keys each, the last 128 the producer
// warpgroup. Maps: q and dout over [b*hq, n, d] in boxes of 64 rows, k and
// v over [b*hkv, s, d] in boxes of 128 keys, 64 dims a box; with kFuseDq,
// dq_map over the f32 dq_accum [b*hq, n, d] in boxes of 64 rows x 32
// columns (unused otherwise).
template <int D, bool kWindow, bool kFuseDq>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap dq_map,
                          const float* __restrict__ lse2,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv,
                          float* __restrict__ dq_accum, int hq, int hkv, int n,
                          int s, float sm_scale, int causal, int q_offset,
                          int window, int sinks) {
  using L = Layout<D, kFuseDq>;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];  // K/V, full, empty
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t k_s = base;
  const uint32_t v_s = k_s + L::kKTile;
  const uint32_t ds_s = v_s + L::kKTile;
  const uint32_t dq_stage = ds_s + L::kDsBytes;
  const uint32_t ring = dq_stage + L::kDqBytes;
  const auto q_s = [&](int st) { return ring + st * 2 * L::kQTile; };
  const auto do_s = [&](int st) { return q_s(st) + L::kQTile; };
  const auto rows_s = [&](int st) {  // lse2 then delta
    return ring + L::kRing + st * L::kRowBytes;
  };
  const uint32_t kv_bar = smem_u32(&bars[0]);
  const auto full_bar = [&](int st) { return smem_u32(&bars[1 + st]); };
  const auto empty_bar = [&](int st) {
    return smem_u32(&bars[1 + kStages + st]);
  };

  // the key block is the grid's slow dimension: the blocks of the low key
  // blocks, which see the most queries (causal) or hold the sinks, are
  // dispatched first across every (KV head, batch)
  const int key0 = blockIdx.y * kKeys;
  const int kvh = blockIdx.x % hkv;
  const int b = blockIdx.x / hkv;
  const int group = hq / hkv;
  const int n_pad = padded_rows(n);

  // the query tiles each q head of the group visits, the same list for
  // producer and consumers: causally live (a row at or past the block's
  // first key); with a window and no sink key in the block, only those
  // whose first row's band still reaches the block's last key
  int qt_begin = 0, qt_end = (n + kRows - 1) / kRows;
  if (causal) qt_begin = max(key0 - q_offset, 0) / kRows;
  if (kWindow && key0 >= sinks) {
    const int last_row = key0 + kKeys - 1 + window - 1 - q_offset;
    qt_end = last_row < 0 ? 0 : min(qt_end, last_row / kRows + 1);
  }
  const int per_head = max(qt_end - qt_begin, 0);
  const int n_items = group * per_head;

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_bar(st), 1);
      mbar_init(empty_bar(st), kConsumers / 32);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup: one thread loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (threadIdx.x == kConsumers) {
      const int kh = b * hkv + kvh;
      mbar_expect_tx(kv_bar, 2 * L::kKTile);
      for (int x = 0; x < L::kBoxes; ++x) {
        tma_load(k_s + x * L::kKBox, &k_map, kv_bar, x * kBoxCols, key0, kh);
        tma_load(v_s + x * L::kKBox, &v_map, kv_bar, x * kBoxCols, key0, kh);
      }
      for (int it = 0; it < n_items; ++it) {
        const int st = it % kStages;
        const int qh = b * hq + kvh * group + it / per_head;
        const int q0 = (qt_begin + it % per_head) * kRows;
        // the stage's previous tile released by every consumer warp (the
        // first round passes at once)
        mbar_wait(empty_bar(st), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full_bar(st), 2 * L::kQTile + L::kRowBytes);
        for (int x = 0; x < L::kBoxes; ++x) {
          tma_load(q_s(st) + x * L::kQBox, &q_map, full_bar(st), x * kBoxCols,
                   q0, qh);
          tma_load(do_s(st) + x * L::kQBox, &do_map, full_bar(st),
                   x * kBoxCols, q0, qh);
        }
        const size_t row = (size_t)qh * n_pad + q0;
        bulk_load(rows_s(st), lse2 + row, kRows * 4, full_bar(st));
        bulk_load(rows_s(st) + kRows * 4, delta + row, kRows * 4, full_bar(st));
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
  const int wg = threadIdx.x / 128;
  const int warp = threadIdx.x / 32 % 4;  // in the warpgroup
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // accumulator row (and row + 8)
  const int t = lane % 4;  // accumulator column pair
  const int kw0 = key0 + wg * 64;  // the warpgroup's first key
  const int kr0 = kw0 + warp * 16 + g;  // this thread's two keys
  const int kr1 = kr0 + 8;
  const float scale_log2 = sm_scale * kLog2e;

  float dk_acc[D / 2], dv_acc[D / 2];  // element 4 * nd + e at (kr0 if e < 2
                                        // else kr1, column nd*8 + 2t + (e & 1))
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  const auto release = [&](int st) {  // this warp is done with the stage
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar(st));
  };
  // p = exp2(s * scale - lse2) in place over the tile's accumulator
  // (element e of n-tile nt at key kr0 if e < 2 else kr1, query q0 + nt*8 +
  // 2t + (e & 1)), masked (0) where the key is not visible to the query
  const auto probs = [&](float (&sc)[32], const float* lse_s, int q0,
                         auto masked) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + nt * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = sc[4 * nt + e];
        const float p = exp2f(x * scale_log2 - ((e & 1) ? l2.y : l2.x));
        if constexpr (decltype(masked)::value) {
          const int row = q0 + nt * 8 + 2 * t + (e & 1);
          const int key = e < 2 ? kr0 : kr1;
          const int pos = row + q_offset;
          const bool ok = row < n && key < s &&
                          (!causal || (key <= pos && (!kWindow ||
                                                      key > pos - window ||
                                                      key < sinks)));
          x = ok ? p : 0.f;
        } else {
          x = p;
        }
      }
    }
  };
  // bf16 A fragments of a 64 x 64 f32 accumulator: fragment kk holds
  // columns 16kk..16kk+15, n-tiles 2kk and 2kk + 1
  const auto fragments = [](const float (&acc)[32], uint32_t (&f)[4][4]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nt = 2 * kk + half;
        f[kk][2 * half] = pack_bf16(acc[4 * nt], acc[4 * nt + 1]);
        f[kk][2 * half + 1] = pack_bf16(acc[4 * nt + 2], acc[4 * nt + 3]);
      }
    }
  };

  mbar_wait(kv_bar, 0);
  for (int it = 0; it < n_items; ++it) {
    const int st = it % kStages;
    const int h = kvh * group + it / per_head;
    const int q0 = (qt_begin + it % per_head) * kRows;
    const float* lse_s =
        reinterpret_cast<const float*>(base_ptr + (rows_s(st) - base));
    const float* delta_s = lse_s + kRows;
    mbar_wait(full_bar(st), (it / kStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T over the warpgroup's 64 keys, 16 dims
    // (32 bytes) a step along the swizzled rows
    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = kk / 4 * L::kKBox + wg * 64 * 128 + kk % 4 * 32;
      const uint32_t qoff = kk / 4 * L::kQBox + kk % 4 * 32;
      wgmma_ss_n64<0, 0>(sc, desc(k_s + off, 16, 1024),
                         desc(q_s(st) + qoff, 16, 1024), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = kk / 4 * L::kKBox + wg * 64 * 128 + kk % 4 * 32;
      const uint32_t qoff = kk / 4 * L::kQBox + kk % 4 * 32;
      wgmma_ss_n64<0, 0>(dp, desc(v_s + off, 16, 1024),
                         desc(do_s(st) + qoff, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // S^T
    pin(sc);
    // every (key, query) pair of the warpgroup's tile visible: below s and
    // n, below the first row's diagonal, and all sinks or inside the last
    // row's band (uniform in the warpgroup)
    const int first_pos = q0 + q_offset;
    const int last_pos = q0 + kRows - 1 + q_offset;
    const bool full = q0 + kRows <= n && kw0 + 64 <= s &&
                      (!causal || (kw0 + 63 <= first_pos &&
                                   (!kWindow || kw0 + 64 <= sinks ||
                                    kw0 > last_pos - window)));
    if (full) {
      probs(sc, lse_s, q0, Bool<false>{});
    } else {
      probs(sc, lse_s, q0, Bool<true>{});
    }
    wgmma_wait<0>();  // dP^T
    pin(dp);
    // dS^T = P^T (dP^T - delta), in place; then P^T and dS^T as bf16 A
    // fragments, so that the f32 tiles die before the products that read
    // the fragments are issued (dK, dV and a tile's S^T, dP^T and P^T at
    // once spilled at d = 128)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 dl = *reinterpret_cast<const float2*>(delta_s + nt * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dp[4 * nt + e] = sc[4 * nt + e] * (dp[4 * nt + e] - ((e & 1) ? dl.y : dl.x));
      }
    }
    uint32_t pf[4][4], df[4][4];
    fragments(sc, pf);
    fragments(dp, df);
    const uint32_t ds_buf = ds_s + (it & 1) * L::kDs;
    if constexpr (kFuseDq) {
      // dS^T into the buffer [128 keys][64 rows] bf16: 16-byte chunk c of
      // row r at chunk c ^ (r % 8) (the 128B swizzle); this thread's rows
      // r and r + 8 (r % 8 == g), chunk nt, 4 bytes at 4t
      const int r = wg * 64 + warp * 16 + g;
      uint8_t* buf = base_ptr + (ds_buf - base);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int off = (((2 * kk + half) ^ g) << 4) + 4 * t;
          *reinterpret_cast<uint32_t*>(buf + r * 128 + off) = df[kk][2 * half];
          *reinterpret_cast<uint32_t*>(buf + (r + 8) * 128 + off) =
              df[kk][2 * half + 1];
        }
      }
    }
    // dV += P^T dO and dK += dS^T Q: 16 queries (a 2048-byte step down the
    // tile's rows) a step; dO's and Q's 64-dim boxes are the MN-major
    // atoms, one box apart
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<D>(dv_acc, pf[kk], desc(do_s(st) + kk * 2048, L::kQBox, 1024));
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<D>(dk_acc, df[kk], desc(q_s(st) + kk * 2048, L::kQBox, 1024));
    }
    wgmma_commit();
    float dq[32];
    if constexpr (kFuseDq && FKP_BWD_PROBE != 2) {
      // dQ = dS K: dS read transposed from the buffer (MN-major A, 16 keys
      // a 2048-byte step), K MN-major. d = 128: this warpgroup's 64
      // columns (K's box wg) over the block's 128 keys, once both
      // warpgroups wrote theirs; d = 64: its own 64 keys, every column.
      fence_proxy_async();
      constexpr int kSteps = D == 128 ? 8 : 4;
      const uint32_t a0 = ds_buf + (D == 128 ? 0 : wg * 64 * 128);
      const uint32_t b0 = k_s + (D == 128 ? wg * L::kKBox : wg * 64 * 128);
      if constexpr (D == 128) {
        named_sync(1, kConsumers);
      } else {
        named_sync(1 + wg, 128);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        wgmma_ss_n64<1, 1>(dq, desc(a0 + kk * 2048, L::kKBox, 1024),
                           desc(b0 + kk * 2048, L::kKBox, 1024), kk > 0);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
    pin(dk_acc);
    pin(dv_acc);
    pin(pf);
    pin(df);
    release(st);
    if constexpr (kFuseDq && FKP_BWD_PROBE == 1) {
      // the probe without the reduce-adds: keep the product live by one
      // test, write nothing
      uint32_t bits = 0;
#pragma unroll
      for (int i = 0; i < 32; ++i) bits |= __float_as_uint(dq[i]);
      if (bits == 0x7fc00001u) dq_accum[0] = 0.f;
    } else if constexpr (kFuseDq && FKP_BWD_PROBE == 0) {
      // the partial into the warpgroup's staging boxes (64 rows x 32
      // columns, 16-byte chunk c of row r at chunk c ^ (r % 8)) once its
      // previous reduce-adds have read them, then two TMA reduce-adds from
      // one thread; rows past n are clipped by the map
      pin(dq);
      const bool issuer = threadIdx.x % 128 == 0;
      const uint32_t own = dq_stage + wg * L::kDqStage;
      if (issuer) bulk_wait<true>();
      named_sync(3 + wg, 128);
      uint8_t* box0 = base_ptr + (own - base);
      const int r0 = warp * 16 + g;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint8_t* box = box0 + j / 4 * (L::kDqStage / 2);
        const int off = ((((j % 4) * 2 + (t >> 1)) ^ g) << 4) + (t & 1) * 8;
        *reinterpret_cast<float2*>(box + r0 * 128 + off) =
            make_float2(dq[4 * j], dq[4 * j + 1]);
        *reinterpret_cast<float2*>(box + (r0 + 8) * 128 + off) =
            make_float2(dq[4 * j + 2], dq[4 * j + 3]);
      }
      fence_proxy_async();
      named_sync(3 + wg, 128);
      if (issuer) {
        const int col0 = D == 128 ? wg * 64 : 0;
        const int qh = b * hq + h;
        tma_reduce_add(&dq_map, own, col0, q0, qh);
        tma_reduce_add(&dq_map, own + L::kDqStage / 2, col0 + 32, q0, qh);
        bulk_commit();
      }
    }
  }
  if constexpr (kFuseDq) {
    if (threadIdx.x % 128 == 0) bulk_wait<false>();  // before the block exits
  }

  // one sm_scale on dK (the chain rule through s = sm_scale * q.k); keys at
  // or past s are not written
  const size_t kv_off = ((size_t)b * hkv + kvh) * s * D;
  __nv_bfloat16* dk_bh = dk + kv_off;
  __nv_bfloat16* dv_bh = dv + kv_off;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (kr0 < s) {
      *reinterpret_cast<__nv_bfloat162*>(dk_bh + (size_t)kr0 * D + c) =
          __floats2bfloat162_rn(dk_acc[4 * nd] * sm_scale,
                                dk_acc[4 * nd + 1] * sm_scale);
      *reinterpret_cast<__nv_bfloat162*>(dv_bh + (size_t)kr0 * D + c) =
          __floats2bfloat162_rn(dv_acc[4 * nd], dv_acc[4 * nd + 1]);
    }
    if (kr1 < s) {
      *reinterpret_cast<__nv_bfloat162*>(dk_bh + (size_t)kr1 * D + c) =
          __floats2bfloat162_rn(dk_acc[4 * nd + 2] * sm_scale,
                                dk_acc[4 * nd + 3] * sm_scale);
      *reinterpret_cast<__nv_bfloat162*>(dv_bh + (size_t)kr1 * D + c) =
          __floats2bfloat162_rn(dv_acc[4 * nd + 2], dv_acc[4 * nd + 3]);
    }
  }
}

// Launches instance <D, kWindow, kFuseDq>; returns a CUDA error code (the
// shared-memory attribute's, cudaErrorInvalidValue where a map cannot be
// encoded, else cudaGetLastError() after the launch).
template <int D, bool kWindow, bool kFuseDq>
int launch_kernel_a(const BwdArgs& a) {
  const auto kernel = &flash_bwd_sm90_kernel<D, kWindow, kFuseDq>;
  constexpr int kBytes = Layout<D, kFuseDq>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap qm, dom, km, vm, dqm;
  if (!encode_map(&qm, a.q, D, a.n, a.b * a.hq, kRows) ||
      !encode_map(&dom, a.dout, D, a.n, a.b * a.hq, kRows) ||
      !encode_map(&km, a.k, D, a.s, a.b * a.hkv, kKeys) ||
      !encode_map(&vm, a.v, D, a.s, a.b * a.hkv, kKeys) ||
      !(kFuseDq ? encode_tiled(&dqm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.dq,
                               D, a.n, a.b * a.hq, kRows)
                : encode_map(&dqm, a.q, D, a.n, a.b * a.hq, kRows))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(a.hkv * a.b, (a.s + kKeys - 1) / kKeys);
  kernel<<<grid, kThreads, kBytes, a.stream>>>(
      qm, dom, km, vm, dqm, a.lse2, a.delta, static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), static_cast<float*>(a.dq), a.hq,
      a.hkv, a.n, a.s, a.sm_scale, a.causal, a.q_offset, a.window, a.sinks);
  return static_cast<int>(cudaGetLastError());
}

// Kernel A at (d, kFuseDq), with or without a band; each instantiated in
// a source of its own (flash_bwd_kv64.cu, ...), so that nvcc builds them
// in parallel.
template <int D, bool kFuseDq>
int launch_dkdv(const BwdArgs& a) {
  return a.window > 0 ? launch_kernel_a<D, true, kFuseDq>(a)
                      : launch_kernel_a<D, false, kFuseDq>(a);
}

extern template int launch_dkdv<64, false>(const BwdArgs&);
extern template int launch_dkdv<128, false>(const BwdArgs&);
extern template int launch_dkdv<64, true>(const BwdArgs&);
extern template int launch_dkdv<128, true>(const BwdArgs&);

}  // namespace fkp_bwd_sm90
