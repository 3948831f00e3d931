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

#include "decode_core.cuh"

namespace {

using fkp_dec::kThreads;

// key j of row b lives in page table[j / page], at row j % page; its
// scales at entry j % page of the same page of the scale pool
struct PagedRows {
  const int* table;    // block_tables[b]
  size_t page_stride;  // elements per page of the pool: hkv * page * d
  int page;
  int d;
  __device__ __forceinline__ size_t offset(int key) const {
    const int pid = __ldg(table + key / page);
    return (size_t)pid * page_stride + (size_t)(key % page) * d;
  }
  // floats per page of a scale pool: page_stride / d = hkv * page
  __device__ __forceinline__ size_t scale(int key) const {
    const int pid = __ldg(table + key / page);
    return (size_t)pid * (page_stride / d) + key % page;
  }
};

// Launch bounds with a minimum of one block per SM: with the thread count
// alone, ptxas spilled 8 bytes in the G = 2 instances.
template <int D, int G>
__global__ void __launch_bounds__(kThreads, 1)
    paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k_pages,
                        const __nv_bfloat16* __restrict__ v_pages,
                        const int* __restrict__ block_tables,
                        const int* __restrict__ lengths,
                        float* __restrict__ m_out, float* __restrict__ l_out,
                        float* __restrict__ y_out, int hkv, int page,
                        int max_pages, int n_splits, int pages_per_split,
                        float sm_scale) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int split = blockIdx.z;
  // the table holds max_pages pages: keys past them are not attended
  const int len = min(max(lengths[b], 0), max_pages * page);
  const int span = pages_per_split * page;
  const int start = split * span;
  const int end = min(start + span, len);
  const size_t part = ((size_t)b * hkv + kvh) * n_splits + split;
  const size_t head = (size_t)kvh * page * D;  // the head's rows in a page
  const PagedRows rows{block_tables + (size_t)b * max_pages,
                       (size_t)hkv * page * D, page, D};
  fkp_dec::decode_partials<D, G>(
      q + ((size_t)b * hkv + kvh) * G * D, k_pages + head, v_pages + head,
      nullptr, nullptr, rows, start, end, sm_scale, m_out + part * G,
      l_out + part * G, y_out + part * G * D);
}

// the same over an 8-bit pool (T = int8_t or __nv_fp8_e4m3) with its
// scale pools [n_pages, hkv, 1, page]; kQInt8 (int8 only): the int8 score
// product of decode_core.cuh, sm_scale then the log2-domain scale
template <int D, int G, class T, bool kQInt8 = false>
__global__ void __launch_bounds__(kThreads, 1)
    paged_decode_q_kernel(const __nv_bfloat16* __restrict__ q,
                          const T* __restrict__ k_pages,
                          const float* __restrict__ k_scale_pages,
                          const T* __restrict__ v_pages,
                          const float* __restrict__ v_scale_pages,
                          const int* __restrict__ block_tables,
                          const int* __restrict__ lengths,
                          float* __restrict__ m_out, float* __restrict__ l_out,
                          float* __restrict__ y_out, int hkv, int page,
                          int max_pages, int n_splits, int pages_per_split,
                          float sm_scale) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int split = blockIdx.z;
  const int len = min(max(lengths[b], 0), max_pages * page);
  const int span = pages_per_split * page;
  const int start = split * span;
  const int end = min(start + span, len);
  const size_t part = ((size_t)b * hkv + kvh) * n_splits + split;
  const size_t head = (size_t)kvh * page * D;
  const size_t scale_head = (size_t)kvh * page;  // the head's scale row
  const PagedRows rows{block_tables + (size_t)b * max_pages,
                       (size_t)hkv * page * D, page, D};
  fkp_dec::decode_partials<D, G, T, PagedRows, kQInt8>(
      q + ((size_t)b * hkv + kvh) * G * D, k_pages + head, v_pages + head,
      k_scale_pages + scale_head, v_scale_pages + scale_head, rows, start,
      end, sm_scale, m_out + part * G, l_out + part * G, y_out + part * G * D);
}

}  // namespace

// q [b, hq, d], k/v pages [n_pages, hkv, page, d] bf16 contiguous,
// block_tables [b, max_pages] and lengths [b] int32; m, l [b, hkv, n_splits,
// G] and y [b, hkv, n_splits, G, d] f32, G = hq/hkv in {1, 2, 4, 8}, d in
// {64, 128}. Split i covers table entries [i*pages_per_split,
// (i+1)*pages_per_split). Returns cudaGetLastError() after the launch.
extern "C" int fkp_paged_decode(const void* q, const void* k_pages,
                                const void* v_pages, const void* block_tables,
                                const void* lengths, void* m, void* l, void* y,
                                int b, int hq, int hkv, int page, int d,
                                int max_pages, int n_splits,
                                int pages_per_split, float sm_scale,
                                void* stream) {
  const dim3 grid(b, hkv, n_splits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return fkp_dec::dispatch(d, hq / hkv, [&](auto dc, auto gc) {
    paged_decode_kernel<decltype(dc)::value, decltype(gc)::value>
        <<<grid, kThreads, 0, st>>>(
            static_cast<const __nv_bfloat16*>(q),
            static_cast<const __nv_bfloat16*>(k_pages),
            static_cast<const __nv_bfloat16*>(v_pages),
            static_cast<const int*>(block_tables),
            static_cast<const int*>(lengths), static_cast<float*>(m),
            static_cast<float*>(l), static_cast<float*>(y), hkv, page,
            max_pages, n_splits, pages_per_split, sm_scale);
  });
}

// q [b, hq, d] bf16; k/v pages [n_pages, hkv, page, d] int8 (fp8 == 0) or
// e4m3 (fp8 == 1) and their scale pages [n_pages, hkv, 1, page] f32, all
// contiguous; block_tables, lengths, m, l, y and the splits as
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
                                  void* stream) {
  const dim3 grid(b, hkv, n_splits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return fkp_dec::dispatch_8bit(d, hq / hkv, fp8, [&](auto dc, auto gc, auto tc) {
    using T = typename decltype(tc)::type;
    paged_decode_q_kernel<decltype(dc)::value, decltype(gc)::value, T>
        <<<grid, kThreads, 0, st>>>(
            static_cast<const __nv_bfloat16*>(q),
            static_cast<const T*>(k_pages),
            static_cast<const float*>(k_scale_pages),
            static_cast<const T*>(v_pages),
            static_cast<const float*>(v_scale_pages),
            static_cast<const int*>(block_tables),
            static_cast<const int*>(lengths), static_cast<float*>(m),
            static_cast<float*>(l), static_cast<float*>(y), hkv, page,
            max_pages, n_splits, pages_per_split, sm_scale);
  });
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
                                    void* stream) {
  const dim3 grid(b, hkv, n_splits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return fkp_dec::dispatch(d, hq / hkv, [&](auto dc, auto gc) {
    paged_decode_q_kernel<decltype(dc)::value, decltype(gc)::value, int8_t,
                          true><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const int8_t*>(k_pages),
        static_cast<const float*>(k_scale_pages),
        static_cast<const int8_t*>(v_pages),
        static_cast<const float*>(v_scale_pages),
        static_cast<const int*>(block_tables),
        static_cast<const int*>(lengths), static_cast<float*>(m),
        static_cast<float*>(l), static_cast<float*>(y), hkv, page, max_pages,
        n_splits, pages_per_split, scale_log2);
  });
}
