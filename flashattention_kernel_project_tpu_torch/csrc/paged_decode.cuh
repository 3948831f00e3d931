// The paged decode's kernels and their launcher, shared by paged_decode.cu
// (slots = 2, the depth of every serving path, and the C entries) and
// paged_decode_slots3.cu, paged_decode_slots4.cu (the deeper gathers), so
// that nvcc compiles the three depths' instances in parallel. What the
// kernels compute and replace: paged_decode.cu.

#pragma once

#include "decode_core.cuh"

namespace fkp_paged {

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
// alone, ptxas spilled 8 bytes in the G = 2 instances. kUnroll: the keys a
// group has in flight (slots); kCopyOnly: the copy probe.
template <int D, int G, int kUnroll, bool kCopyOnly>
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
  fkp_dec::decode_partials<D, G, __nv_bfloat16, PagedRows, false, kUnroll,
                           kCopyOnly>(
      q + ((size_t)b * hkv + kvh) * G * D, k_pages + head, v_pages + head,
      nullptr, nullptr, rows, start, end, sm_scale, m_out + part * G,
      l_out + part * G, y_out + part * G * D);
}

// the same over an 8-bit pool (T = int8_t or __nv_fp8_e4m3) with its
// scale pools [n_pages, hkv, 1, page]; kQInt8 (int8 only): the int8 score
// product of decode_core.cuh, sm_scale then the log2-domain scale; kUnroll
// as above
template <int D, int G, class T, bool kQInt8, int kUnroll>
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
  fkp_dec::decode_partials<D, G, T, PagedRows, kQInt8, kUnroll>(
      q + ((size_t)b * hkv + kvh) * G * D, k_pages + head, v_pages + head,
      k_scale_pages + scale_head, v_scale_pages + scale_head, rows, start,
      end, sm_scale, m_out + part * G, l_out + part * G, y_out + part * G * D);
}


// The cache a launch reads: bf16, int8 or e4m3 values, or int8 with the
// int8 score product (q_int8).
enum Kind : int { kBf16 = 0, kInt8 = 1, kFp8 = 2, kQInt8 = 3 };

// One launch's arguments (the C entries' in paged_decode.cu); k_scale and
// v_scale are null for bf16.
struct Args {
  const void* q;
  const void* k_pages;
  const void* k_scale;
  const void* v_pages;
  const void* v_scale;
  const void* block_tables;
  const void* lengths;
  void* m;
  void* l;
  void* y;
  int b, hq, hkv, page, d, max_pages, n_splits, pages_per_split;
  float sm_scale;
  int kind;
  int copy_only;  // bf16 only: the copy probe
  cudaStream_t stream;
};

// Launches the instance of a's kind, d and G with kUnroll keys a group in
// flight; returns cudaGetLastError() after it, or cudaErrorInvalidValue
// without a launch for a d or G the kernels lack, and for copy_only at any
// depth but slots = 2 (kUnroll 4), the only one built for it. Instantiated
// once per depth: <4> in paged_decode.cu, <8> and <12> in their own sources.
template <int kUnroll>
int launch(const Args& a) {
  const dim3 grid(a.b, a.hkv, a.n_splits);
  const auto* q = static_cast<const __nv_bfloat16*>(a.q);
  const auto* tables = static_cast<const int*>(a.block_tables);
  const auto* lengths = static_cast<const int*>(a.lengths);
  auto* m = static_cast<float*>(a.m);
  auto* l = static_cast<float*>(a.l);
  auto* y = static_cast<float*>(a.y);
  if (a.copy_only && kUnroll != 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.kind == kBf16) {
    return fkp_dec::dispatch(a.d, a.hq / a.hkv, [&](auto dc, auto gc) {
      const auto go = [&](auto copy) {
        paged_decode_kernel<decltype(dc)::value, decltype(gc)::value, kUnroll,
                            decltype(copy)::value>
            <<<grid, kThreads, 0, a.stream>>>(
                q, static_cast<const __nv_bfloat16*>(a.k_pages),
                static_cast<const __nv_bfloat16*>(a.v_pages), tables, lengths,
                m, l, y, a.hkv, a.page, a.max_pages, a.n_splits,
                a.pages_per_split, a.sm_scale);
      };
      if constexpr (kUnroll == 4) {
        if (a.copy_only) {
          go(std::true_type{});
          return;
        }
      }
      go(std::false_type{});
    });
  }
  return fkp_dec::dispatch_8bit(
      a.d, a.hq / a.hkv, a.kind == kFp8, [&](auto dc, auto gc, auto tc) {
        using T = typename decltype(tc)::type;
        const auto go = [&](auto qi8) {
          paged_decode_q_kernel<decltype(dc)::value, decltype(gc)::value, T,
                                decltype(qi8)::value, kUnroll>
              <<<grid, kThreads, 0, a.stream>>>(
                  q, static_cast<const T*>(a.k_pages),
                  static_cast<const float*>(a.k_scale),
                  static_cast<const T*>(a.v_pages),
                  static_cast<const float*>(a.v_scale), tables, lengths, m, l,
                  y, a.hkv, a.page, a.max_pages, a.n_splits,
                  a.pages_per_split, a.sm_scale);
        };
        if constexpr (std::is_same<T, int8_t>::value) {
          if (a.kind == kQInt8) {
            go(std::true_type{});
            return;
          }
        }
        go(std::false_type{});
      });
}

extern template int launch<8>(const Args&);
extern template int launch<12>(const Args&);

}  // namespace fkp_paged
