// The attention backward for Hopper (sm_90a), kernel B: dQ alone, the
// two-kernel schedule's second half (kernel A without kFuseDq gives dK and
// dV). wgmma, TMA and a K/V ring on the dense forward's skeleton.
// flash_bwd_dq64.cu and flash_bwd_dq128.cu each build the instances of
// one d from this header, with and without a band (kWindow).
//
// Replaces flashattention_kernel_project_tpu/ops/flash_attention.py::
// _bwd_dq_kernel (:2203, pallas_call :2695), the fuse_dq=False dq:
// Q-stationary, for each query row
//   dq = sm_scale * sum_j p_j (dO.v_j - delta) k_j,  p = exp(s - lse),
// p masked to 0 where key j is not visible, so that a row that sees no key
// gets dq = 0. Scores, p, dS and the accumulator are f32; p and dS are
// rounded to bf16 only as wgmma operands.
//
// What bounds it on the H100: three products of 2*d flops per visible
// (query, key) pair, K and V re-read per 128-row block from L2: tensor-core
// issue and the elementwise chain bound it, as in the forward. The design
// is the forward's (flash_fwd_sm90.cuh), with what the backward changes:
// - One block a (128-row query tile, q head, batch), the heaviest causal
//   tiles first across every head and batch (the row block is the grid's
//   slow dimension): two consumer warpgroups of 64 rows and a producer warpgroup
//   (setmaxnreg 24 and 240). Q and dO are loaded once by TMA and stay in
//   shared memory; each row's lse and delta are read once into registers.
// - The producer streams the 64-key K/V tiles through a 4-stage ring (d =
//   128: 32 KB Q + 32 KB dO + 4 x 32 KB), in the forward's order: with a
//   window the sink tiles, then the band's tiles, each once. 64-key tiles
//   keep S, dP and the dQ accumulator (32 + 32 + 64 f32 a thread at d =
//   128) inside the register budget with no spill.
// - The products, per consumer warpgroup (M = its 64 rows):
//     S  = Q K^T      wgmma SS, both K-major (the forward's QK)
//     dP = dO V^T     wgmma SS
//     dQ += dS K      wgmma RS: dS repacked from its accumulator to bf16 A
//                     fragments, K read MN-major (the forward's V)
// - The mask only on tiles that cross the diagonal, a band edge or the key
//   tail, classified once per warpgroup. Every wgmma issue and wait lies on
//   control flow uniform in the warpgroup.
// dq x sm_scale is written once in bf16; there are no atomics.
// Tried and dropped (PERF.md): the forward's intra-warpgroup overlap (tile
// j's S and dP issued with tile j-1's dQ): 8% slower at the training shape
// on the H100, and ptxas serialized the d = 64 instances' wgmma.

#pragma once

#include "flash_bwd_sm90.cuh"

namespace fkp_bwd_sm90 {

constexpr int kDqRows = 128;  // query rows a kernel-B block
constexpr int kDqKeys = 64;   // keys a K/V tile

// Shared memory of kernel B at d: Q and dO (boxes of 128 rows x 64 dims),
// then the ring's stages, each K then V (boxes of 64 keys), every box
// 1024-byte aligned, after up to 1 KB of alignment slack.
template <int D>
struct DqLayout {
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kStages = 4;
  static constexpr int kQBox = kDqRows * 128;
  static constexpr int kQTile = kBoxes * kQBox;  // Q or dO
  static constexpr int kKBox = kDqKeys * 128;
  static constexpr int kKTile = kBoxes * kKBox;  // K or V
  static constexpr int kBytes = 1024 + 2 * kQTile + kStages * 2 * kKTile;
};

// One block per (q head and batch, 128-row query tile): the first 256 threads
// are the consumer warpgroups, 64 rows each, the last 128 the producer
// warpgroup. Maps: q and dout over [b*hq, n, d] in boxes of 128 rows, k
// and v over [b*hkv, s, d] in boxes of 64 keys, 64 dims a box.
template <int D, bool kWindow>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap do_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             const float* __restrict__ lse2,
                             const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dq, int hq, int hkv,
                             int n, int s, float sm_scale, int causal,
                             int q_offset, int window, int sinks) {
  using L = DqLayout<D>;
  constexpr int kStages = L::kStages;
  constexpr int kN = kDqKeys;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];  // Q/dO, full, empty
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t do_s = q_s + L::kQTile;
  const auto k_s = [&](int st) { return do_s + L::kQTile + st * 2 * L::kKTile; };
  const auto v_s = [&](int st) { return k_s(st) + L::kKTile; };
  const uint32_t q_bar = smem_u32(&bars[0]);
  const auto full_bar = [&](int st) { return smem_u32(&bars[1 + st]); };
  const auto empty_bar = [&](int st) {
    return smem_u32(&bars[1 + kStages + st]);
  };

  // heaviest causal tiles first across every (q head, batch): the row
  // block is the grid's slow dimension
  const int m_block = gridDim.y - 1 - blockIdx.y;
  const int h = blockIdx.x % hq;
  const int b = blockIdx.x / hq;
  const int kvh = h / (hq / hkv);  // contiguous GQA grouping
  const int row_first = m_block * kDqRows;
  const int row_last = min(row_first + kDqRows, n) - 1;

  // the key tiles the block visits, as the forward's: up to the last real
  // row's diagonal; with a window the sink tiles below the band, then the
  // band's tiles from the one holding the first row's first band key
  int n_tiles = (s + kN - 1) / kN;
  if (causal) {
    const int last_key = row_last + q_offset;
    n_tiles = last_key < 0 ? 0 : min(n_tiles, last_key / kN + 1);
  }
  int band_tile = 0, n_sink_tiles = 0;
  if constexpr (kWindow) {
    band_tile = min(max(row_first + q_offset - (window - 1), 0) / kN, n_tiles);
    n_sink_tiles = min((sinks + kN - 1) / kN, band_tile);
  }
  const int n_visit = n_sink_tiles + n_tiles - band_tile;
  const auto tile_of = [&](int it) {
    return it < n_sink_tiles ? it : band_tile + it - n_sink_tiles;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
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
      const int qh = b * hq + h;
      const int kh = b * hkv + kvh;
      mbar_expect_tx(q_bar, 2 * L::kQTile);
      for (int x = 0; x < L::kBoxes; ++x) {
        tma_load(q_s + x * L::kQBox, &q_map, q_bar, x * kBoxCols, row_first, qh);
        tma_load(do_s + x * L::kQBox, &do_map, q_bar, x * kBoxCols, row_first,
                 qh);
      }
      for (int it = 0; it < n_visit; ++it) {
        const int st = it % kStages;
        const int key0 = tile_of(it) * kN;
        mbar_wait(empty_bar(st), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full_bar(st), 2 * L::kKTile);
        for (int x = 0; x < L::kBoxes; ++x) {
          tma_load(k_s(st) + x * L::kKBox, &k_map, full_bar(st),
                   x * kBoxCols, key0, kh);
          tma_load(v_s(st) + x * L::kKBox, &v_map, full_bar(st),
                   x * kBoxCols, key0, kh);
        }
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
  const int wg_first = row_first + wg * 64;      // the warpgroup's rows
  const int wg_last = min(wg_first + 64, n) - 1;  // < wg_first: none real
  const int row0 = wg_first + warp * 16 + g;
  const int row1 = row0 + 8;
  const int pos0 = row0 + q_offset;
  const int pos1 = row1 + q_offset;
  const int first_pos = wg_first + q_offset;
  const int last_pos = wg_last + q_offset;
  const float scale_log2 = sm_scale * kLog2e;
  const size_t bh = (size_t)b * hq + h;
  const size_t rows = bh * padded_rows(n);
  const float lse0 = row0 < n ? lse2[rows + row0] : 0.f;
  const float lse1 = row1 < n ? lse2[rows + row1] : 0.f;
  const float delta0 = row0 < n ? delta[rows + row0] : 0.f;
  const float delta1 = row1 < n ? delta[rows + row1] : 0.f;

  float acc[D / 2];  // dQ: element 4 * nd + e at (row0 if e < 2 else row1,
                     // column nd * 8 + 2t + (e & 1))
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const auto release = [&](int st) {  // this warp is done with the stage
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar(st));
  };
  // p = exp2(s * scale - lse2) in place (element e of n-tile nt at row0 if
  // e < 2 else row1, key key0 + nt*8 + 2t + (e & 1)), masked (0) where the
  // key is not visible to the row
  const auto probs = [&](float (&sc)[32], int key0, auto masked) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = sc[4 * nt + e];
        const float p = exp2f(x * scale_log2 - (e < 2 ? lse0 : lse1));
        if constexpr (decltype(masked)::value) {
          const int col = key0 + nt * 8 + 2 * t + (e & 1);
          const int pos = e < 2 ? pos0 : pos1;
          const bool ok = col < s && (!causal || (col <= pos && (!kWindow ||
                                                                 col > pos - window ||
                                                                 col < sinks)));
          x = ok ? p : 0.f;
        } else {
          x = p;
        }
      }
    }
  };

  mbar_wait(q_bar, 0);
  for (int it = 0; it < n_visit; ++it) {
    const int st = it % kStages;
    const int key0 = tile_of(it) * kN;
    mbar_wait(full_bar(st), (it / kStages) & 1);
    // S = Q K^T and dP = dO V^T over the warpgroup's 64 rows, 16 dims a step
    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t qoff = kk / 4 * L::kQBox + wg * 64 * 128 + kk % 4 * 32;
      const uint32_t koff = kk / 4 * L::kKBox + kk % 4 * 32;
      wgmma_ss_n64<0, 0>(sc, desc(q_s + qoff, 16, 1024),
                         desc(k_s(st) + koff, 16, 1024), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t qoff = kk / 4 * L::kQBox + wg * 64 * 128 + kk % 4 * 32;
      const uint32_t koff = kk / 4 * L::kKBox + kk % 4 * 32;
      wgmma_ss_n64<0, 0>(dp, desc(do_s + qoff, 16, 1024),
                         desc(v_s(st) + koff, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // S
    pin(sc);
    // every (row, key) pair of the warpgroup's tile visible: below s, below
    // the first row's diagonal, and all sinks or inside the last row's band
    const bool full = key0 + kN <= s &&
                      (!causal || (key0 + kN - 1 <= first_pos &&
                                   (!kWindow || key0 + kN <= sinks ||
                                    key0 > last_pos - window)));
    if (full) {
      probs(sc, key0, Bool<false>{});
    } else {
      probs(sc, key0, Bool<true>{});
    }
    wgmma_wait<0>();  // dP
    pin(dp);
    // dS = P (dP - delta), then its bf16 A fragments: fragment kk holds keys
    // 16kk..16kk+15, n-tiles 2kk and 2kk + 1
    uint32_t df[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 4 * (2 * kk + half);
        df[kk][2 * half] = pack_bf16(sc[i] * (dp[i] - delta0),
                                     sc[i + 1] * (dp[i + 1] - delta0));
        df[kk][2 * half + 1] = pack_bf16(sc[i + 2] * (dp[i + 2] - delta1),
                                         sc[i + 3] * (dp[i + 3] - delta1));
      }
    }
    // dQ += dS K: 16 keys (a 2048-byte step down K's rows) a step; K's
    // 64-dim boxes are the MN-major atoms, one box apart
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<D>(acc, df[kk], desc(k_s(st) + kk * 2048, L::kKBox, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
    pin(df);
    release(st);
  }

  // one sm_scale on dQ; rows at or past n are not written
  __nv_bfloat16* dq_bh = dq + bh * n * D;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (row0 < n) {
      *reinterpret_cast<__nv_bfloat162*>(dq_bh + (size_t)row0 * D + c) =
          __floats2bfloat162_rn(acc[4 * nd] * sm_scale, acc[4 * nd + 1] * sm_scale);
    }
    if (row1 < n) {
      *reinterpret_cast<__nv_bfloat162*>(dq_bh + (size_t)row1 * D + c) =
          __floats2bfloat162_rn(acc[4 * nd + 2] * sm_scale,
                                acc[4 * nd + 3] * sm_scale);
    }
  }
}

// Launches instance <D, kWindow>; returns a CUDA error code, as
// launch_kernel_a.
template <int D, bool kWindow>
int launch_kernel_b(const BwdArgs& a) {
  const auto kernel = &flash_bwd_dq_sm90_kernel<D, kWindow>;
  constexpr int kBytes = DqLayout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap qm, dom, km, vm;
  if (!encode_map(&qm, a.q, D, a.n, a.b * a.hq, kDqRows) ||
      !encode_map(&dom, a.dout, D, a.n, a.b * a.hq, kDqRows) ||
      !encode_map(&km, a.k, D, a.s, a.b * a.hkv, kDqKeys) ||
      !encode_map(&vm, a.v, D, a.s, a.b * a.hkv, kDqKeys)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(a.hq * a.b, (a.n + kDqRows - 1) / kDqRows);
  kernel<<<grid, kThreads, kBytes, a.stream>>>(
      qm, dom, km, vm, a.lse2, a.delta, static_cast<__nv_bfloat16*>(a.dq),
      a.hq, a.hkv, a.n, a.s, a.sm_scale, a.causal, a.q_offset, a.window,
      a.sinks);
  return static_cast<int>(cudaGetLastError());
}

// Kernel B at d, with or without a band; each d instantiated in a source
// of its own (flash_bwd_dq64.cu, flash_bwd_dq128.cu).
template <int D>
int launch_dq(const BwdArgs& a) {
  return a.window > 0 ? launch_kernel_b<D, true>(a)
                      : launch_kernel_b<D, false>(a);
}

extern template int launch_dq<64>(const BwdArgs&);
extern template int launch_dq<128>(const BwdArgs&);

}  // namespace fkp_bwd_sm90
