// The batched GEMM with the row softmax in its epilogue, for Hopper
// (sm_90a): wgmma, TMA and a K ring, one sweep over N. gemm_softmax.cu's
// entries launch it for every call with bf16 operands, K and N multiples
// of 8, 16-byte-aligned bases and K > 0 (ops/gemm.py::softmax_epilogue_path);
// gemm_softmax_sm90.cu builds its four instances (tiles of 128 x 256 and
// 128 x 128, rows and resident) in an nvcc process of its own.
//
// Replaces flashattention_kernel_project_tpu/ops/gemm.py::
// _batched_softmax_epilogue_kernel (:334, pallas_call :422; the rows form,
// batched_matmul_softmax_epilogue's default) and
// _batched_softmax_epilogue_resident_kernel (:458, pallas_call :627;
// resident=True) on those calls; the rest stay on gemm_softmax.cu's
// mma.sync kernels. The functions:
// - rows: C[b] = softmax_rows(scale * A[b] @ B[b] + bias[col]) with the row
//   max subtracted, columns past N masked, a row sum of 0 counted as 1;
// - resident: fixed-max, e = exp2 of the log2-domain scores with no max
//   subtracted, l their row sum, e rounded to the output type times (1 / l)
//   rounded to it; an l-range witness counts the real rows whose l is not
//   finite, above 2^120 or below 2^-100 (the wrapper then launches the
//   rows form gated on that count, which overwrites C).
//
// What bounds it on the H100: at config 3 (32 x 2048^3, bf16) the
// products are 550 GFLOP against 0.8 GB of inputs and outputs, so the
// tensor cores' rate bounds it (0.556 ms at 989 TFLOP/s). The mma.sync
// kernels it replaces ran the products on the old core (23% of the rate at
// 4096^3), the rows form twice. What each choice here does about that:
// - The skeleton of gemm_sm90.cuh (its ring, producer, products, maps and
//   stores): a producer warpgroup whose first thread streams 64-deep K
//   slices by TMA into a ring of 4 stages (128 x 256 tiles) or 6 (128 x
//   128), two consumer warpgroups issuing wgmma m64nNk16 from shared memory.
// - The work unit is a band: 128 rows of one batch, all of N, owned by a
//   cluster of two CTAs, one an SM, that split its N tiles (even and odd)
//   and walk the bands persistently. A band re-reads its A rows for every
//   N tile; with one CTA a band the 132 bands in flight held 67 MB of A at
//   config 3, past the 50 MB L2, and the products alone ran at the speed
//   of HBM (0.79 ms); with two, 0.72 ms (PERF.md). In a band the producer
//   streams the CTA's tiles in order and runs on into the next band's
//   slices while the consumers finish this one. Each consumer warpgroup
//   owns 64 whole rows, each warp 16, and the four lanes of a quad hold all
//   of a row's columns of a tile, so a row reduction in a CTA is two xor
//   shuffles in a quad.
// - One sweep: each tile's epilogue runs on the accumulator in registers.
//   z = acc * scale * log2(e) + bias[col] * log2(e), columns past N masked.
//   Rows: the running row max m_t after tile t, e = exp2(z - m_t) written
//   to C rounded to the output type, l = l * exp2(m_(t-1) - m_t) + the
//   tile's f32 e, and m_t written to a workspace [batch, M, tiles] of f32
//   (from the wrapper: any N fits, 4 MB at config 3 against 268 MB of C;
//   shared memory would bound N). Resident: e = exp2(z), l its sum.
// - The band's end, in each consumer warp for its 16 rows: l summed over
//   the quad, then (m, l) sent to the same warp of the other CTA (its
//   shared memory and an mbarrier there, through the cluster) and merged
//   with its own; rows: the warp's tile maxima turned into the factors
//   exp2(m_t - m) / l in the workspace; resident: the witness, and 1 / l
//   rounded to the output type into shared memory. Then the band goes to
//   the rescalers and the consumers go on to the next band.
// - The rescalers (the producer warpgroup's other three warps) rescale C
//   in place a band behind, while the next band's products run: 8 KB
//   boxes of C by TMA into two staging buffers after the ring, scaled in
//   shared memory by their rows' factors, stored back by TMA. Done by the
//   consumers themselves, the rescale cost 0.25 ms at config 3 with the
//   tensor cores idle; through registers at 40 a thread it spilled and had
//   too few bytes in flight.
// Precision: as the rows form of gemm_softmax.cu, exp2 and the sums run in
// f32; but e is rounded to the output type before the rescale, so a bf16
// output rounds twice (ops/gemm.py::_softmax_epilogue_tiles_plain mirrors
// it; ROADMAP.md, section C). The function is unchanged: exp2(z - m_t) *
// exp2(m_t - m) is exp2(z - m). The grid, the band order and every sum's
// order are fixed, with no atomics on C, and the merge gives both CTAs
// the same bits: a call is deterministic, so the gated rows launch after a
// resident one gives the rows call's bits.

#pragma once

#include "gemm_sm90.cuh"

namespace fkp_gemm_softmax_sm90 {

using namespace fkp_gemm_sm90;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;  // finite, as NEG_INF in ops/softmax.py

// the probes of tools/ab_gemm.py softmax (FKP_GEMM_PROBE, gemm_sm90.cuh's 1
// to 3; 4: the epilogue without the band's end and the rescale); the
// library builds 0
constexpr bool kEpilogue = FKP_GEMM_PROBE == 0 || FKP_GEMM_PROBE == 4;
constexpr bool kFinish = FKP_GEMM_PROBE == 0;

constexpr int kWarps = kConsumers / 32;  // consumer warps, 16 rows each
// the rescalers: the producer warpgroup's warps 1-3 (warp 0's first thread
// loads A and B); their first thread moves C by TMA through two staging
// buffers after the ring, each a box of kBN columns x c_rows(kBN, bf16)
// rows of C (8 KB)
constexpr int kRescalers = 96;
constexpr int kCBox = 8192;
constexpr int kStaging = 2 * kCBox;
constexpr int kMaxCRows = kCBox / (128 * 2);  // 128-column bf16 boxes

__host__ __device__ constexpr int c_rows(int bn, bool bf16) {
  return kCBox / (bn * (bf16 ? 2 : 4));
}

// exp2 on the SFU, subnormal results flushed to 0 (a probability below
// 2^-126 is 0 at either output type's scale)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One staged box of C (`rows` rows of kBN elements at shared address
// `box`) times its rows' factors `f`, rounded to T, in place: the
// rescalers' 16-byte pieces in turn (rescaler `tid`).
template <class T, int kBN>
__device__ __forceinline__ void scale_box(uint32_t box, int rows, const float* f,
                                          int tid) {
  constexpr int kPer = 16 / sizeof(T);
  constexpr int kPieces = kBN / kPer;  // a row's pieces, a power of 2
  for (int p = tid; p < rows * kPieces; p += kRescalers) {
    const uint32_t at = box + p * 16;
    uint4 v;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(at));
    const float fr = f[p / kPieces];
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int x = 0; x < kPer; ++x) e[x] = T(static_cast<float>(e[x]) * fr);
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(at), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
  }
}

// The block's small shared state (besides the ring and C's boxes).
struct Sync {
  // by band parity: the other CTA's (m, l) of each row, written there, and
  // an mbarrier a consumer warp that the other CTA's warp arrives on
  uint64_t peer_bar[2][kWarps];
  float2 peer[2][kBM];
  // by band parity: the band's merged (m, 1 / l) by row (resident), and
  // mbarriers on which the consumers hand the band to the rescalers (every
  // consumer thread arrives) and the rescalers hand it back (every one)
  float2 stats[2][kBM];
  uint64_t band_full[2], band_empty[2];
  // by staging buffer: the TMA load of its box of C, and its rows' factors
  uint64_t c_full[2];
  float c_f[2][kMaxCRows];
};

// A CTA's walk over the bands: bands first, first + step, ... below count
// (m_tiles of 128 rows a batch), its N tiles rank, rank + 2, ... below
// n_tiles. Each role computes it after its setmaxnreg (values live across
// that instruction were spilled).
struct Walk {
  int rank, first, step, count, m_tiles, n_tiles;
  __device__ __forceinline__ Walk(const Out& o, int batch, int bn)
      : rank(cluster_rank()), first(blockIdx.x / 2), step(gridDim.x / 2),
        count(batch * ((o.m + kBM - 1) / kBM)), m_tiles((o.m + kBM - 1) / kBM),
        n_tiles((o.n + bn - 1) / bn) {}
};

// The rescalers' loop (rescaler `tid`), a band behind the consumers: for
// each band, the boxes of C of this CTA's tiles (kRows rows each) by TMA
// into the two staging buffers at `staging`, each scaled in place by its
// rows' factors (tile_max's, rows form; 1 / l from the stats, resident)
// and stored back by TMA.
template <class T, int kBN, bool kResident>
__device__ __forceinline__ void rescale_bands(const CUtensorMap* c_map, const Out& o,
                                              int batch, const float* tile_max,
                                              Sync& sh, uint32_t staging, int tid) {
  constexpr int kRows = c_rows(kBN, sizeof(T) == 2);
  constexpr int kChunks = kBM / kRows;
  const Walk w(o, batch, kBN);
  const int boxes = (w.n_tiles - w.rank + 1) / 2 * kChunks;  // a band's
  int it = 0, box = 0;  // bands and boxes done
  for (int t = w.first; t < w.count; t += w.step, ++it) {
    const int par = it & 1;
    const int b = t / w.m_tiles, row0 = (t - b * w.m_tiles) * kBM;
    mbar_wait(smem_u32(&sh.band_full[par]), (it >> 1) & 1);
    // box k of the band: tile rank + 2 (k / kChunks), rows (k % kChunks) *
    // kRows.. of the band, into buffer `buf` once the store that last
    // read that buffer is done with it
    const auto load = [&](int k, int buf) {
      bulk_wait<true>();
      fence_proxy_async_all();  // the consumers' e, seen by the TMA load
      mbar_expect_tx(smem_u32(&sh.c_full[buf]), kCBox);
      tma_load(staging + buf * kCBox, c_map, smem_u32(&sh.c_full[buf]),
               (w.rank + 2 * (k / kChunks)) * kBN, row0 + k % kChunks * kRows, b);
    };
    if (tid == 0 && boxes > 0) load(0, box & 1);
    for (int k = 0; k < boxes; ++k, ++box) {
      const int buf = box & 1;
      if (tid == 0 && k + 1 < boxes) load(k + 1, buf ^ 1);
      const int nt = w.rank + 2 * (k / kChunks), r0 = k % kChunks * kRows;
      if (tid < kRows) {  // the factors of the box's rows
        const int r = r0 + tid;
        sh.c_f[buf][tid] =
            row0 + r >= o.m ? 0.f
            : kResident     ? sh.stats[par][r].y
                            : tile_max[((size_t)b * o.m + row0 + r) * w.n_tiles + nt];
      }
      mbar_wait(smem_u32(&sh.c_full[buf]), (box >> 1) & 1);
      named_sync(1, kRescalers);  // the box and its factors are in
      scale_box<T, kBN>(staging + buf * kCBox, kRows, sh.c_f[buf], tid);
      fence_proxy_async();  // the scaled box, seen by the TMA store
      named_sync(1, kRescalers);
      if (tid == 0) {
        tma_store(c_map, staging + buf * kCBox, nt * kBN, row0 + r0, b);
        bulk_commit();
      }
    }
    mbar_arrive(smem_u32(&sh.band_empty[par]));
  }
  if (tid == 0) bulk_wait<false>();  // the last stores have landed
}

// C [batch, m, n] through the maps of encode_ab, by clusters of two CTAs.
// A cluster owns a band (128 rows of one batch, all of N) at a time:
// cluster i takes bands i, i + clusters, ...; its CTA of rank r the N
// tiles r, r + 2, ..., so that the two read A's slices together and only
// half as many A bands are in flight as there are SMs (one band a block
// kept 132 bands' A, 67 MB at config 3, past the 50 MB L2). In each CTA
// the first 256 threads are the consumer warpgroups, 64 rows of the band
// each, the last 128 the producer warpgroup. At the band's end each
// consumer warp sends its rows' (m, l) to the same warp of the other CTA
// (its shared memory, an mbarrier there) and merges the two; the order of
// the merge's operands does not change its bits, so both CTAs hold the
// same (m, l). tile_max: [batch, m, ceil(n / kBN)] f32 (rows); witness: a
// device count (resident, counted by rank 0); gate: null, or a device
// count on which every block returns at once while it is 0 (rows).
template <int kBN, bool kResident>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
    gemm_softmax_sm90_kernel(const __grid_constant__ CUtensorMap a_map,
                             const __grid_constant__ CUtensorMap b_map,
                             const __grid_constant__ CUtensorMap c_map, Out o,
                             const float* bias, float* tile_max, int* witness,
                             const int* gate, int k, int batch,
                             float scale_log2) {
  if (gate != nullptr && *gate == 0) return;
  using L = Layout<kBN>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * L::kStages];  // full, empty
  __shared__ __align__(8) Sync sh;
  Ring<kBN> ring{(smem_u32(smem_raw) + 1023u) & ~1023u, smem_u32(bars)};

  if (threadIdx.x == 0) {
    for (int p = 0; p < 2; ++p) {
      for (int w = 0; w < kWarps; ++w) mbar_init(smem_u32(&sh.peer_bar[p][w]), 8);
      mbar_init(smem_u32(&sh.band_full[p]), kConsumers);
      mbar_init(smem_u32(&sh.band_empty[p]), kRescalers);
      mbar_init(smem_u32(&sh.c_full[p]), 1);
    }
    ring.init();  // and the fence that shows the inits to the cluster
  }
  cluster_sync();  // both CTAs' barriers ready before any remote arrival

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup
    producer_regs();
    const int tid = threadIdx.x - kConsumers - 32;  // the rescalers' 0..95
    if (threadIdx.x == kConsumers) {  // one thread loads
      const Walk w(o, batch, kBN);
      const int n_k = (k + kBK - 1) / kBK;
      for (int t = w.first; t < w.count; t += w.step) {
        const int b = t / w.m_tiles, row0 = (t - b * w.m_tiles) * kBM;
        for (int nt = w.rank; nt < w.n_tiles; nt += 2) {
          load_tile(ring, &a_map, &b_map, b, row0, nt * kBN, o.n, n_k,
                    t == w.first && nt == w.rank);
        }
      }
    } else if (kFinish && tid >= 0) {  // the rescalers
      const uint32_t staging = ring.base + L::kStages * L::kStage;
      if (o.bf16) {
        rescale_bands<__nv_bfloat16, kBN, kResident>(&c_map, o, batch, tile_max, sh,
                                                     staging, tid);
      } else {
        rescale_bands<float, kBN, kResident>(&c_map, o, batch, tile_max, sh, staging, tid);
      }
    }
    return;
  }

  consumer_regs();
  const Walk walk(o, batch, kBN);
  const int rank = walk.rank, n_tiles = walk.n_tiles;
  const int n_k = (k + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;
  const int w = threadIdx.x / 32;         // consumer warp
  const int warp = w % 4;                 // in the warpgroup
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // accumulator row (and row + 8)
  const int q = lane % 4;  // accumulator column pair
  int it = 0;              // bands done
  for (int t = walk.first; t < walk.count; t += walk.step, ++it) {
    const int b = t / walk.m_tiles;
    const int wrow0 = (t - b * walk.m_tiles) * kBM + wg * 64 + warp * 16;  // the warp's rows
    const size_t bbase = (size_t)b * o.m * o.n;
    // rows g and g + 8 of the warp: the running max over this CTA's tiles
    // (rows) and this thread's part of l, over its columns
    float m_run[2] = {kResident ? 0.f : kNegInf, kResident ? 0.f : kNegInf};
    float l[2] = {0.f, 0.f};
    // row g's tile maxima (rows form; row g + 8's lie 8 rows on)
    float* const tm_row = kResident ? nullptr
                                    : tile_max + ((size_t)b * o.m + wrow0 + g) * n_tiles;
    for (int nt = rank; nt < n_tiles; nt += 2) {
      const int col0 = nt * kBN;
      float acc[kBN / 2];
      mma_tile(ring, acc, wg, lane, n_k);
      if (!kEpilogue) {  // keep the products live: one test, no store
        uint32_t bits = 0;
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) bits |= __float_as_uint(acc[i]);
        if (bits == 0x7fc00001u) static_cast<float*>(o.c)[0] = 0.f;
        continue;
      }
      if (kResident) {  // e = exp2(z) in one pass, l its sum
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const bool live = col0 + 8 * j < o.n;
          const float2 bj = live ? __ldg(reinterpret_cast<const float2*>(
                                       bias + col0 + 8 * j + 2 * q))
                                 : make_float2(0.f, 0.f);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& z = acc[4 * j + e];
            z = live ? exp2_ftz(fmaf(z, scale_log2, (e & 1 ? bj.y : bj.x) * kLog2e)) : 0.f;
            l[e >> 1] += z;
          }
        }
      } else {
        // z in place; an 8-column block lies wholly inside or past n. A
        // quarter of 64 columns a branch, so that no more than its bias
        // pairs are loaded ahead (with all of them this form spilled)
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int j0 = 0; j0 < kBN / 8; j0 += 8) {
          if (col0 + 8 * j0 < o.n) {
#pragma unroll
            for (int j = j0; j < j0 + 8; ++j) {
              const bool live = col0 + 8 * j < o.n;
              const float2 bj = live ? __ldg(reinterpret_cast<const float2*>(
                                           bias + col0 + 8 * j + 2 * q))
                                     : make_float2(0.f, 0.f);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                float& z = acc[4 * j + e];
                z = live ? fmaf(z, scale_log2, (e & 1 ? bj.y : bj.x) * kLog2e) : kNegInf;
                mx[e >> 1] = fmaxf(mx[e >> 1], z);
              }
            }
          } else {
#pragma unroll
            for (int i = 4 * j0; i < 4 * j0 + 32; ++i) acc[i] = kNegInf;
          }
        }
        // the running max over the quad; l follows it
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          const float m_new = fmaxf(m_run[h], mx[h]);
          l[h] *= exp2_ftz(m_run[h] - m_new);
          m_run[h] = m_new;
        }
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const bool live = col0 + 8 * j < o.n;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& z = acc[4 * j + e];
            z = live ? exp2_ftz(z - m_run[e >> 1]) : 0.f;
            l[e >> 1] += z;
          }
        }
      }
      // this thread's pieces lie in row g + 8 (q & 1) of its warp's 16
      const int row = wrow0 + g + 8 * (q & 1);
      if (o.bf16) {
        store_bf16x8<kBN>(o, bbase, row, col0, acc, q);
      } else {
        store_f32x4<kBN>(o, bbase, row, col0, acc, q);
      }
      if (!kResident && q == 0) {
        if (wrow0 + g < o.m) tm_row[nt] = m_run[0];
        if (wrow0 + g + 8 < o.m) tm_row[8 * n_tiles + nt] = m_run[1];
      }
    }
    if (!kFinish) continue;
    // the band's finish: l over the quad; (m, l) to the other CTA's warp
    // and its (m, l) merged in; 1 / l; the witness
    const int par = it & 1;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
    const int brow = wg * 64 + warp * 16 + g;  // rows brow, brow + 8 of the band
    if (q == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        st_cluster_f32x2(cluster_addr(smem_u32(&sh.peer[par][brow + 8 * h]), rank ^ 1),
                         m_run[h], l[h]);
      }
      mbar_arrive_cluster(cluster_addr(smem_u32(&sh.peer_bar[par][w]), rank ^ 1));
    }
    mbar_wait_cluster(smem_u32(&sh.peer_bar[par][w]), (it >> 1) & 1);
    int breach = 0;
    float m_h[2], inv_h[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 p = sh.peer[par][brow + 8 * h];
      float m_all = m_run[h], l_all;
      if (kResident) {
        l_all = l[h] + p.y;
      } else {
        m_all = fmaxf(m_run[h], p.x);
        l_all = l[h] * exp2_ftz(m_run[h] - m_all) + p.y * exp2_ftz(p.x - m_all);
      }
      float inv = 1.f / (l_all == 0.f ? 1.f : l_all);
      if (kResident) {
        const bool bad = !isfinite(l_all) || l_all > 0x1p120f || l_all < 0x1p-100f;
        breach += rank == 0 && q == 0 && bad && wrow0 + g + 8 * h < o.m;
        // (1 / l) rounded to the output type, as the TPU kernel multiplies
        if (o.bf16) inv = __bfloat162float(__float2bfloat16(inv));
      }
      m_h[h] = m_all;
      inv_h[h] = inv;
    }
    if (kResident) {
      breach = __reduce_add_sync(0xffffffffu, breach);
      if (lane == 0 && breach > 0) atomicAdd(witness, breach);
    }
    if (!kResident) {
      // the warp's tile maxima become the factors exp2(m_t - m) / l of
      // their rows and tiles, in place (row r = e % 16, the i-th tile of
      // this CTA = e / 16); rows past m have none
      const int own = (n_tiles - rank + 1) / 2;
      __syncwarp();  // the quads' maxima are written
      for (int e0 = 0; e0 < 16 * own; e0 += 32) {
        const int e = e0 + lane, r = e % 16, src = (r & 7) * 4;
        const float m0 = __shfl_sync(0xffffffffu, m_h[0], src);
        const float m1 = __shfl_sync(0xffffffffu, m_h[1], src);
        const float i0 = __shfl_sync(0xffffffffu, inv_h[0], src);
        const float i1 = __shfl_sync(0xffffffffu, inv_h[1], src);
        if (e < 16 * own && wrow0 + r < o.m) {
          float& f = tm_row[(r - g) * n_tiles + rank + 2 * (e / 16)];
          f = exp2_ftz(f - (r < 8 ? m0 : m1)) * (r < 8 ? i0 : i1);
        }
      }
    }
    // hand the band to the rescalers once they are done with the stats of
    // the band two before (the first two pass at once)
    mbar_wait(smem_u32(&sh.band_empty[par]), ((it >> 1) & 1) ^ 1);
    if (kResident && q == 0) {
      sh.stats[par][brow] = make_float2(m_h[0], inv_h[0]);
      sh.stats[par][brow + 8] = make_float2(m_h[1], inv_h[1]);
    }
    fence_proxy_async_all();  // this thread's e, for the rescalers' TMA loads
    mbar_arrive(smem_u32(&sh.band_full[par]));  // and its maxima and stats
  }
}

// The band kernel's tile width (128 or 256): gemm_sm90.cuh's tile_n, but
// 128 wherever N <= 256, where 256-column tiles would give a band one tile
// and leave the cluster's second CTA without products.
inline int band_tile_n(int batch, int m, int n, int sms) {
  return n <= 256 ? 128 : tile_n(batch, m, n, sms);
}

// The softmax epilogue's wgmma launch for a [batch, m, k] and b [batch, k,
// n] bf16, contiguous, k > 0, k and n multiples of 8, 16-byte-aligned
// bases, bias 8-byte aligned, into o (bf16 or f32): the tile width of
// band_tile_n, one block an SM, in clusters of two. Resident:
// witness a device int32 the launch adds to; else tile_max holds batch * m
// * ceil(n / 128) f32 and gate is null or a device int32.
// gemm_softmax_sm90.cu builds it. A CUDA error code.
int launch_softmax(const void* a, const void* b, const float* bias,
                   const Out& o, float* tile_max, int* witness,
                   const int* gate, int batch, int k, float scale_log2,
                   bool resident, cudaStream_t stream);

}  // namespace fkp_gemm_softmax_sm90
