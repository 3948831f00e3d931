// Causal multi-token GQA extend against a paged KV cache, for Hopper
// (sm_90a): the verify step of speculative decoding over the page pool.
//
// Replaces flashattention_kernel_project_tpu/ops/paged_decode.py::
// _paged_extend_kernel (reached through paged_flash_extend) for a bf16 pool.
// The chunk's T tokens are already appended to the pages; chunk token tr of
// row b sits at position old_lens[b] + tr and sees keys j < new_lens[b] and
// j <= old_lens[b] + tr. Only pages below new_lens[b] are read, so dead
// table entries (the junk page 0) cost nothing.
//
// It is the paged flavour of the tiled forward in flash_fwd_core.cuh (the
// design, precision and bound are described there). As the TPU kernel does,
// it folds the GQA group and the chunk into the rows of one query tile, row
// gi * T + tr, so each block reads its KV head's pages once for the whole
// group: one block per (64-row tile of the G * T folded rows, KV head, batch
// row). G * T above 64 (G = 8 and T >= 9) takes a second tile, not a
// truncation; rows past G * T load zeros and write nothing. Key rows are
// addressed one by one through the block table, because a 64-key tile
// spans several pages of 16 or 32 rows. At the serving shape (B = 8,
// Hkv = 4, G = 4, T = 5) the grid is 32 blocks of 20 live rows, bound by the
// bytes of the live pages, which one block per (row, KV head) streams alone:
// splitting over pages, as the paged decode does, is left for later.

#include "flash_fwd_core.cuh"

using fkp_fwd::flash_fwd_kernel;
using fkp_fwd::kBlockM;
using fkp_fwd::kPaged;
using fkp_fwd::kThreads;
using fkp_fwd::PagedArgs;

// q [b, hq, t, d] bf16 contiguous (read as [b, hkv, G * t, d]); k/v pages
// [n_pages, hkv, page, d] bf16 contiguous; block_tables [b, max_pages],
// new_lens and old_lens [b] int32 on the device; o [b, hq, t, d] bf16.
// scale_log2 = sm_scale * log2(e). d in {64, 128}. Returns
// cudaGetLastError() after the launch.
extern "C" int fkp_paged_extend(const void* q, const void* k_pages,
                                const void* v_pages, const void* block_tables,
                                const void* new_lens, const void* old_lens,
                                void* o, int b, int hq, int hkv, int t,
                                int page, int d, int max_pages,
                                float scale_log2, void* stream) {
  const int rows = (hq / hkv) * t;  // the folded group
  const dim3 grid((rows + kBlockM - 1) / kBlockM, hkv, b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k_pages);
  const auto* vp = static_cast<const __nv_bfloat16*>(v_pages);
  auto* op = static_cast<__nv_bfloat16*>(o);
  const auto* lens = static_cast<const int*>(new_lens);
  const auto* offs = static_cast<const int*>(old_lens);
  const PagedArgs pg{static_cast<const int*>(block_tables), page, max_pages,
                     t};
  // the folded q is one "head" per KV head: hq = hkv, n = rows
  if (d == 64) {
    flash_fwd_kernel<64, kPaged><<<grid, kThreads, 0, st>>>(
        qp, kp, vp, op, nullptr, hkv, hkv, rows, 0, scale_log2, 1, 0, lens,
        offs, pg);
  } else if (d == 128) {
    flash_fwd_kernel<128, kPaged><<<grid, kThreads, 0, st>>>(
        qp, kp, vp, op, nullptr, hkv, hkv, rows, 0, scale_log2, 1, 0, lens,
        offs, pg);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
