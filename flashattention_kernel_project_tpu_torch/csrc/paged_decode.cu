// Split-KV single-token GQA decode against a paged KV cache, for Hopper
// (sm_90a).
//
// Replaces both schedules of flashattention_kernel_project_tpu/ops/
// paged_decode.py::paged_flash_decode for a bf16 pool, and both schedules
// of paged_flash_decode_quant (_paged_gather_kernel_q and
// _paged_decode_kernel_q) for an int8 or e4m3 pool whose per-token scales
// lie lane-major in scale pages [n_pages, Hkv, 1, page]:
// - _paged_gather_kernel (gather=True, the engine's path): several pages per
//   program. Here the wrapper sizes the splits for occupancy, about two
//   blocks per SM, as the linear decode does; the TPU sized its spans in
//   bytes because it ran the grid serially.
// - _paged_decode_kernel (gather=False): one page per program. Here one page
//   per split.
// One kernel serves both: the schedules differ only in pages per split. Its
// int8 instance with the int8 score product (q_int8=True, which JAX takes
// only with gather=True over an int8 pool) replaces _paged_gather_kernel_q's
// q_int8 branch (paged_decode.py:915-928).
//
// The gather's probe options (paged_decode.py:124-125, :165-210, :832,
// :880-898): `slots`, the depth of the TPU's DMA ring (slots - 1 splits in
// flight), is here the depth of the key loop's loads in flight (kUnroll of
// decode_core.cuh: 4, 8 or 12 keys a group for slots 2, 3, 4), with the
// output bit-equal at every depth; slots = 2 is the instance every other
// path runs. copy_only (bf16, built at slots = 2 only: deeper loads do not
// move the gather's floor) is the same gather with no score or PV math:
// each live split gives y[g] = k + v at its first key row start + g, the
// wrapper sums the splits, and the time is the gather's byte floor. The
// kernels and their launcher are in paged_decode.cuh; the slots 3 and 4
// instances compile in paged_decode_slots3.cu and paged_decode_slots4.cu,
// beside this file. ptxas reports each depth's registers and spills in the
// build log (the deepest spills at G = 4 over an 8-bit pool and at G = 8
// over bf16; PERF.md).
//
// Each (batch row, KV head, split) block reads the page ids of its split
// from block_tables[b] itself (the TPU had them on the scalar-prefetch
// channel) and emits the unnormalized partials (m, l, y) of the group's G
// query rows over its keys below lengths[b]; merge_partials combines the
// splits outside the kernel. The block's work is decode_partials in
// decode_core.cuh, where its design and bound (bytes) are described: only
// the key-row address differs from the linear cache, key j of row b living
// at row j % page of page block_tables[b, j / page]. Keys at or past
// lengths[b] are never visited, so table entries past a row's pages (valid
// ids, typically the junk page 0) cost nothing, a split past the row's
// length loads nothing, and a row of length 0 gives zeros. Page ids may come
// in any order. The 8-bit kernel reads each key's scales through the same
// table entry as its values; the JAX wrapper gathered the scales into a
// linear buffer first (an XLA take) because a TPU DMA of one 512-byte scale
// row cost more than it moved.

#include "paged_decode.cuh"

using fkp_paged::Args;

namespace fkp_paged {
template int launch<4>(const Args&);
}  // namespace fkp_paged

namespace {

// a's launch at the depth of `slots`: slots - 1 sets of 4 keys a group in
// flight (decode_core.cuh); cudaErrorInvalidValue for slots outside {2, 3, 4}
int launch_slots(const Args& a, int slots) {
  switch (slots) {
    case 2: return fkp_paged::launch<4>(a);
    case 3: return fkp_paged::launch<8>(a);
    case 4: return fkp_paged::launch<12>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [b, hq, d], k/v pages [n_pages, hkv, page, d] bf16 contiguous,
// block_tables [b, max_pages] and lengths [b] int32; m, l [b, hkv, n_splits,
// G] and y [b, hkv, n_splits, G, d] f32, G = hq/hkv in {1, 2, 4, 8}, d in
// {64, 128}. Split i covers table entries [i*pages_per_split,
// (i+1)*pages_per_split). slots in {2, 3, 4}; copy_only: the copy probe's
// partials (decode_core.cuh), at slots = 2 only. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue without one for slots outside
// {2, 3, 4} or copy_only with slots != 2.
extern "C" int fkp_paged_decode(const void* q, const void* k_pages,
                                const void* v_pages, const void* block_tables,
                                const void* lengths, void* m, void* l, void* y,
                                int b, int hq, int hkv, int page, int d,
                                int max_pages, int n_splits,
                                int pages_per_split, float sm_scale, int slots,
                                int copy_only, void* stream) {
  return launch_slots(
      Args{q, k_pages, nullptr, v_pages, nullptr, block_tables, lengths, m, l,
           y, b, hq, hkv, page, d, max_pages, n_splits, pages_per_split,
           sm_scale, fkp_paged::kBf16, copy_only,
           static_cast<cudaStream_t>(stream)},
      slots);
}

// q [b, hq, d] bf16; k/v pages [n_pages, hkv, page, d] int8 (fp8 == 0) or
// e4m3 (fp8 == 1) and their scale pages [n_pages, hkv, 1, page] f32, all
// contiguous; block_tables, lengths, m, l, y, the splits and slots as
// fkp_paged_decode. Returns cudaGetLastError() after the launch.
extern "C" int fkp_paged_decode_q(const void* q, const void* k_pages,
                                  const void* k_scale_pages,
                                  const void* v_pages,
                                  const void* v_scale_pages,
                                  const void* block_tables,
                                  const void* lengths, void* m, void* l,
                                  void* y, int b, int hq, int hkv, int page,
                                  int d, int max_pages, int n_splits,
                                  int pages_per_split, float sm_scale, int fp8,
                                  int slots, void* stream) {
  return launch_slots(
      Args{q, k_pages, k_scale_pages, v_pages, v_scale_pages, block_tables,
           lengths, m, l, y, b, hq, hkv, page, d, max_pages, n_splits,
           pages_per_split, sm_scale,
           fp8 ? fkp_paged::kFp8 : fkp_paged::kInt8, 0,
           static_cast<cudaStream_t>(stream)},
      slots);
}

// paged_flash_decode_quant(q_int8=True) over an int8 pool: arguments as
// fkp_paged_decode_q (without fp8), scale_log2 = sm_scale * log2(e). Each
// block quantizes its group's q rows, folded by scale_log2, to int8 and
// takes the scores as int8 x int8 products (decode_core.cuh). Returns
// cudaGetLastError() after the launch.
extern "C" int fkp_paged_decode_qi8(const void* q, const void* k_pages,
                                    const void* k_scale_pages,
                                    const void* v_pages,
                                    const void* v_scale_pages,
                                    const void* block_tables,
                                    const void* lengths, void* m, void* l,
                                    void* y, int b, int hq, int hkv, int page,
                                    int d, int max_pages, int n_splits,
                                    int pages_per_split, float scale_log2,
                                    int slots, void* stream) {
  return launch_slots(
      Args{q, k_pages, k_scale_pages, v_pages, v_scale_pages, block_tables,
           lengths, m, l, y, b, hq, hkv, page, d, max_pages, n_splits,
           pages_per_split, scale_log2, fkp_paged::kQInt8, 0,
           static_cast<cudaStream_t>(stream)},
      slots);
}
