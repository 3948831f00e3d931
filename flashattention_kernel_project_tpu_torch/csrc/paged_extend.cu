// Causal multi-token GQA extend against a paged KV cache, for Hopper
// (sm_90a): the verify step of speculative decoding over the page pool.
// This source builds the bf16 instances of paged_extend_sm90.cuh's kernel
// (d in {64, 128} x 16, 32 or 64 folded rows a block: 6), the arrival
// counters of its split merge, and the C entries of both flavours (the
// 8-bit instances are paged_extend_q.cu's). The kernel's design, bound and
// the TPU kernel it replaces (paged_decode.py::_paged_extend_kernel, bf16
// and quant=True) are described in the header.

#include "paged_extend_sm90.cuh"

namespace fkp_ext90 {
namespace {

// one a (batch row, KV head, row tile); every completed launch leaves them
// at 0
__device__ int g_counters[kMaxCounters];

int* counters() {
  int* c = nullptr;
  return cudaGetSymbolAddress(reinterpret_cast<void**>(&c), g_counters) ==
                 cudaSuccess
             ? c
             : nullptr;
}

}  // namespace
}  // namespace fkp_ext90

// q [b, hq, t, d] bf16 contiguous (read as [b, hkv, G * t, d]); k/v pages
// [n_pages, hkv, page, d] bf16 contiguous and 16-byte aligned; block_tables
// [b, max_pages], new_lens and old_lens [b] int32 on the device. Chunk
// token tr of row b sees keys j < min(new_lens[b], max_pages * page) with
// j <= old_lens[b] + tr. The keys are cut into n_splits splits of block_s
// keys (a multiple of 64), at most 64; block_rows (16, 32 or 64) folded
// rows a block. o [b, hq, t, d] bf16 takes the normalised rows (0 for a row
// that sees no key); with n_splits > 1, m, l [b, hkv, row_tiles, n_splits,
// block_rows] and y [..., block_rows, d] f32 (row_tiles = ceil(G * t /
// block_rows)) are the splits' workspace, and b * hkv * row_tiles is at
// most 2^18; with one split they may be null. o null: the kernel writes
// every split's partials to m, l and y (m in natural-log units, NEG_INF
// with l = 0 and y = 0 for a row with no live key in the split) and
// nothing else. scale_log2 = sm_scale * log2(e). d in {64, 128}, pages of
// 16 to 128 rows in steps of 16. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue without one for a shape outside these
// or inputs a TMA map cannot describe.
extern "C" int fkp_paged_extend(const void* q, const void* k_pages,
                                const void* v_pages, const void* block_tables,
                                const void* new_lens, const void* old_lens,
                                void* o, void* m, void* l, void* y, int b,
                                int hq, int hkv, int t, int page, int d,
                                int max_pages, int n_pages, int n_splits,
                                int block_s, int block_rows, float scale_log2,
                                void* stream) {
  if (!fkp_ext90::valid(b, hq, hkv, t, page, max_pages, n_pages, n_splits,
                        block_s, block_rows, o, m, l, y)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int* c = fkp_ext90::counters();
  if (!c) return static_cast<int>(cudaGetLastError());
  const fkp_ext90::Params p = fkp_ext90::params(
      q, block_tables, new_lens, old_lens, nullptr, nullptr, o, m, l, y, hq,
      hkv, t, page, max_pages, n_splits, block_s, block_rows, scale_log2);
  return fkp_ext90::launch_any<__nv_bfloat16>(
      d, block_rows, p, k_pages, v_pages, n_pages, b, c,
      static_cast<cudaStream_t>(stream));
}

// The same over an 8-bit pool: k/v pages [n_pages, hkv, page, d] int8
// (fp8 == 0) or e4m3 (fp8 == 1) and their scale pages [n_pages, hkv, 1,
// page] f32, contiguous and 16-byte aligned; the rest as fkp_paged_extend.
extern "C" int fkp_paged_extend_q(const void* q, const void* k_pages,
                                  const void* k_scale_pages,
                                  const void* v_pages,
                                  const void* v_scale_pages,
                                  const void* block_tables,
                                  const void* new_lens, const void* old_lens,
                                  void* o, void* m, void* l, void* y, int b,
                                  int hq, int hkv, int t, int page, int d,
                                  int max_pages, int n_pages, int n_splits,
                                  int block_s, int block_rows,
                                  float scale_log2, int fp8, void* stream) {
  if (!fkp_ext90::valid(b, hq, hkv, t, page, max_pages, n_pages, n_splits,
                        block_s, block_rows, o, m, l, y) ||
      !k_scale_pages || !v_scale_pages) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int* c = fkp_ext90::counters();
  if (!c) return static_cast<int>(cudaGetLastError());
  const fkp_ext90::Params p = fkp_ext90::params(
      q, block_tables, new_lens, old_lens, k_scale_pages, v_scale_pages, o, m,
      l, y, hq, hkv, t, page, max_pages, n_splits, block_s, block_rows,
      scale_log2);
  return fkp_ext90::launch_8bit(fp8, d, block_rows, p, k_pages, v_pages,
                                n_pages, b, c,
                                static_cast<cudaStream_t>(stream));
}
