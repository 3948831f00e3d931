// The ragged forward's slab route for Hopper (sm_90a): the linear
// speculative verify and short chunks (T < 9) on the paged extend's block
// (paged_extend_sm90.cuh) over a linear cache. This source builds the
// bf16 instances (d in {64, 128} x 16, 32 or 64 folded rows a block x the
// plain and the general call: 12), the route's arrival counters and its C
// entry; ragged_slab_q.cu the int8 instances (12) and ragged_slab_fp8.cu
// the e4m3 ones (12).
//
// Replaces, with flash_fwd_ragged.cu's wgmma route (T >= 9),
// flashattention_kernel_project_tpu/ops/flash_attention.py::
// _fwd_kernel_ragged (:1582, pallas_call :1830), reached through
// flash_attention_ragged (:1862) and flash_attention_ragged_kv_quant
// (:1902): query i of row b sees key j iff j < min(kv_lens[b], s_max) and,
// when causal, j <= i + q_offsets[b], and with a window j > i +
// q_offsets[b] - window or j < sinks; a row that sees no key gives 0.
//
// What bounds it on the H100 at the verify (B 8, 16/4 heads, T 5, S_max
// 2048, d 128): bytes. A row's live keys cost 4 * d bytes of K and V in
// bf16 (2 * d + 8 in 8 bits) and 4 * G * T * d flops, about 2 * G * T = 40
// flops a byte, far under the ~295 ridge. The mma.sync kernel it replaces
// gave each q head a 4-warp block of 64 query rows (5 live at T 5) that
// read its KV head's K/V once per q head (G = 4 times the bytes) and
// walked all of the row's keys in series. Here, as kernel 11 does over a
// page pool: the G * T rows of a KV head fold into 16-row slabs of one
// block, so K/V are read once a KV head; the keys split over blocks
// (ops/paged_decode.py::ragged_plan, extend_n_splits over s_max) with only
// the splits below kv_len running and the last block to arrive merging
// them, one launch a call. The linear cache is a pool of one page of s_max
// rows a batch row: the maps are 3-D over [b * hkv, s_max, D], a tile one
// box of 64 rows at row 64 * t of its (b, kvh) plane (zeros past s_max),
// no table; 8-bit scales are read by the producer warp into the stage
// (a bulk copy needs 16-byte aligned rows, which s_max % 4 != 0 breaks).
// What kernel 11 never needed: an arbitrary q_offsets[b] (every instance),
// and causal=False, the band (a split visits its sink tiles and its band
// tiles, a split with neither loads nothing) and the fixed-max discipline
// (m pinned at 0), uniform runtime arguments (Params: causal, window,
// sinks, fixed) of the general instances (kLinearGeneral). The causal
// online unbanded call, the linear verify, takes instances of its own
// (kLinearPlain): with those arguments at run time in every instance it
// took 0.0230 ms against 0.0165 (+39%, tools/ab_ragged.py), past the 5%
// that would have kept one instance set.

#include "paged_extend_sm90.cuh"

namespace fkp_ext90 {
namespace {

// one a (batch row, KV head, row tile) of the slab route; every completed
// launch leaves them at 0 (the paged extend's and decode's are their own)
__device__ int g_ragged_counters[kMaxCounters];

int* ragged_counters() {
  int* c = nullptr;
  return cudaGetSymbolAddress(reinterpret_cast<void**>(&c),
                              g_ragged_counters) == cudaSuccess
             ? c
             : nullptr;
}

}  // namespace
}  // namespace fkp_ext90

// q [b, hq, t, d] bf16 contiguous (read as [b, hkv, G * t, d]); k/v
// [b, hkv, s_max, d] bf16 (kv_type 0), int8 (1) or e4m3 (2), contiguous
// and 16-byte aligned, with k_scale, v_scale [b, hkv, s_max, 1] f32 for 8
// bits (null for bf16); kv_lens, q_offsets [b] int32 on the device. The
// keys are cut into n_splits splits of block_s keys (a multiple of 64; n_splits *
// block_s >= s_max), block_rows (16, 32 or 64) folded rows a block. o [b,
// hq, t, d] bf16; with n_splits > 1, m, l [b, hkv, row_tiles, n_splits,
// block_rows] and y [..., block_rows, d] f32 are the splits' workspace
// (b * hkv * row_tiles at most 2^18). scale_log2 = sm_scale * log2(e);
// causal; window (> 0, causal only) and sinks the band; fixed 1 for
// fixed-max. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue without one for a shape outside these or inputs a
// TMA map cannot describe.
extern "C" int fkp_ragged_slab(const void* q, const void* k,
                               const void* k_scale, const void* v,
                               const void* v_scale, const void* kv_lens,
                               const void* q_offsets, void* o, void* m,
                               void* l, void* y, int b, int hq, int hkv, int t,
                               int s_max, int d, int n_splits, int block_s,
                               int block_rows, float scale_log2, int causal,
                               int window, int sinks, int fixed, int kv_type,
                               void* stream) {
  if (!fkp_ext90::linear_valid(b, hq, hkv, t, s_max, n_splits, block_s,
                               block_rows, m, l, y) ||
      kv_type < 0 || kv_type > 2 || (kv_type && (!k_scale || !v_scale))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int* c = fkp_ext90::ragged_counters();
  if (!c) return static_cast<int>(cudaGetLastError());
  const fkp_ext90::Params p = fkp_ext90::linear_params(
      q, kv_lens, q_offsets, k_scale, v_scale, o, m, l, y, hq, hkv, t, s_max,
      n_splits, block_s, block_rows, scale_log2, causal, window, sinks, fixed);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_type == 1) {
    return fkp_ext90::linear_int8(d, block_rows, p, k, v, b, c, st);
  }
  if (kv_type == 2) {
    return fkp_ext90::linear_e4m3(d, block_rows, p, k, v, b, c, st);
  }
  return fkp_ext90::launch_linear_any<__nv_bfloat16>(d, block_rows, p, k, v,
                                                     b, c, st);
}
