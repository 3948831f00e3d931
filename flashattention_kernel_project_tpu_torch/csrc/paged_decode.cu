// The paged decode for Hopper (sm_90a): one query token a sequence against
// its page pool, split over the pages and merged on the card, one launch a
// call. The block is paged_extend_sm90.cuh's at T = 1
// (paged_decode_sm90_kernel): 64-key K/V tiles brought by TMA boxes that
// follow the block table into a ring, both products on mma.sync, 8-bit
// tiles widened in shared memory, the split merge by the last block to
// arrive. This source builds its bf16 instances at the ring depth of every
// serving path (2) and the copy probe, the split merge's arrival counters
// and the C entries; the other instances are paged_decode_deep.cu's (bf16
// at depths 3 and 4), paged_decode_q.cu's and paged_decode_q_deep.cu's
// (int8 and e4m3) and paged_decode_qi8.cu's (the int8 score product).
//
// Replaces flashattention_kernel_project_tpu/ops/paged_decode.py's
// - _paged_gather_kernel (:107, pallas_call :336; gather=True, the
//   engine's path) and _paged_decode_kernel (:41, pallas_call :381;
//   gather=False, one page a program) over a bf16 pool;
// - their 8-bit forms _paged_gather_kernel_q (:824, pallas_call :1087) and
//   _paged_decode_kernel_q (:758, pallas_call :1124) over an int8 or e4m3
//   pool with lane-major f32 scale pages [n_pages, Hkv, 1, page], read in
//   place through the table;
// - the gather's q_int8 branch (:915-928, :999-1024), the int8 score
//   product over an int8 pool;
// - and the gather's probe options: `slots`, the depth of the TPU's DMA
//   ring, is here the depth of the TMA ring (2, 3 or 4 stages; each
//   split's keys are summed in the same order at every depth, so the
//   output is bit-equal), and copy_only, the same loads with no score or
//   PV math (slots = 2, partials only: each split with a live key gives
//   y[g] = k + v at its first key row + g, which the wrapper sums).
// Key j of row b lives at row j % page of page block_tables[b, j / page];
// only the keys j < lengths[b] are attended (a length past the table's
// capacity counts as max_pages * page), and a row of length 0 gives zeros.
//
// What bounds it on the H100: bytes. Each live key costs 4 * d bytes of K
// and V in bf16 (2 * d + 8 in 8 bits) and 4 * G * d flops, so at most G
// flops a byte (G <= 8), far under the ~295 flop/byte ridge: the 3.35 TB/s
// of HBM is the roof. What the design does about it:
// - Loads that cost no threads: one producer thread keeps up to `slots`
//   64-key tiles in flight a block (32 KB of K and V in bf16 at d 128), as
//   TMA boxes of gcd(page, 64) rows, each at its page's row through the
//   block table; keys at or past the length are not loaded.
// - Enough blocks: splits of whole 64-key tiles sized from the table's
//   capacity, never from the lengths, which stay on the device, so that
//   B * Hkv * splits reaches the blocks the card holds (ops/
//   paged_decode.py::decode_plan: 8 splits of 256 keys at the serving
//   shape, B 8, Hkv 4, 16 pages of 128; one split where B * Hkv fills the
//   card). gather=False takes splits of the fewest whole pages that make
//   whole tiles (lcm(page, 64) keys), at most 64 of them.
// - Few instructions a key: a KV head's G query rows are one 16-row slab,
//   the A operand of mma.sync m16n8k16, each of the 4 consumer warps taking
//   16 keys of a tile; 8-bit tiles widen exactly once in shared memory; the
//   int8 score product runs mma.sync m16n8k32 on the K bytes as they land
//   (swizzled by the TMA), with s32 sums, the exact integer dot of __dp4a.
// - No work after the kernel: the last block of a (batch row, KV head) to
//   arrive merges the splits' f32 partials and writes the bf16 rows (with
//   one live split the block writes them itself, and a row of length 0 gets
//   zeros from its first split's block), so the wrapper runs no torch op
//   after the launch.
// p enters P V as a bf16 hi + lo pair (about 16 bits of p; ROADMAP.md
// section C). The arrival counters are this source's g_dec_counters (the
// extend keeps its own), 0 between launches, so a launch needs no memset
// and a CUDA graph replays it as it is; two decodes running at once on two
// streams of one device would share them, so the callers run one at a time
// a device.

#include "paged_extend_sm90.cuh"

namespace fkp_ext90 {
namespace {

// one a (batch row, KV head); every completed launch leaves them at 0
__device__ int g_dec_counters[kMaxCounters];

int* dec_counters() {
  int* c = nullptr;
  return cudaGetSymbolAddress(reinterpret_cast<void**>(&c), g_dec_counters) ==
                 cudaSuccess
             ? c
             : nullptr;
}

// The decode's shape as the kernels take it: G = hq / hkv in {1, 2, 4, 8},
// slots in {2, 3, 4}, and the extend's rules at t = 1 in one slab.
bool decode_valid(int b, int hq, int hkv, int page, int max_pages,
                  int n_pages, int n_splits, int block_s, int slots,
                  const void* o, const void* m, const void* l, const void* y) {
  const int g = hkv > 0 ? hq / hkv : 0;
  return (g == 1 || g == 2 || g == 4 || g == 8) && slots >= 2 && slots <= 4 &&
         valid(b, hq, hkv, 1, page, max_pages, n_pages, n_splits, block_s,
               kDecodeRows, o, m, l, y);
}

}  // namespace
}  // namespace fkp_ext90

// q [b, hq, d] bf16 contiguous (read as [b, hkv, G, d]); k/v pages
// [n_pages, hkv, page, d] bf16 contiguous and 16-byte aligned;
// block_tables [b, max_pages] and lengths [b] int32 on the device. Row b
// sees the keys j < min(lengths[b], max_pages * page), cut into n_splits
// splits of block_s keys (a multiple of 64), at most 64. o [b, hq, d] bf16
// takes the normalised rows (0 for a row of length 0); with n_splits > 1,
// m, l [b, hkv, n_splits, 16] and y [..., 16, d] f32 are the splits'
// workspace and b * hkv is at most 2^18; with one split they may be null.
// o null: the kernel writes every split's partials to m, l and y (rows G
// and up are padding; m in natural-log units, NEG_INF with l = 0 and y = 0
// for a split with no live key). scale_log2 = sm_scale * log2(e); slots in
// {2, 3, 4}, the ring's depth; copy_only (slots 2, o null): the copy
// probe's partials. G = hq / hkv in {1, 2, 4, 8}, d in {64, 128}, pages of
// 16 to 128 rows in steps of 16. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue without one for a call outside these or
// inputs a TMA map cannot describe.
extern "C" int fkp_paged_decode(const void* q, const void* k_pages,
                                const void* v_pages, const void* block_tables,
                                const void* lengths, void* o, void* m, void* l,
                                void* y, int b, int hq, int hkv, int page,
                                int d, int max_pages, int n_pages,
                                int n_splits, int block_s, float scale_log2,
                                int slots, int copy_only, void* stream) {
  using namespace fkp_ext90;
  if (!decode_valid(b, hq, hkv, page, max_pages, n_pages, n_splits, block_s,
                    slots, o, m, l, y) ||
      (copy_only && (slots != 2 || o != nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int* c = dec_counters();
  if (!c) return static_cast<int>(cudaGetLastError());
  const Params p = params(q, block_tables, lengths, nullptr, nullptr, nullptr,
                          o, m, l, y, hq, hkv, 1, page, max_pages, n_splits,
                          block_s, kDecodeRows, scale_log2);
  const auto s = static_cast<cudaStream_t>(stream);
  if (copy_only) {
    return launch_decode<__nv_bfloat16, 2, kCopy>(d, p, k_pages, v_pages,
                                                  n_pages, b, c, s);
  }
  if (slots == 2) {
    return launch_decode<__nv_bfloat16, 2, kAttend>(d, p, k_pages, v_pages,
                                                    n_pages, b, c, s);
  }
  return decode_bf16_deep(slots, d, p, k_pages, v_pages, n_pages, b, c, s);
}

// The same over an 8-bit pool: k/v pages [n_pages, hkv, page, d] int8
// (fp8 == 0) or e4m3 (fp8 == 1) and their scale pages [n_pages, hkv, 1,
// page] f32, contiguous and 16-byte aligned; q_int8 (int8 only): the int8
// score product, q quantized per row in the log2 domain. The rest as
// fkp_paged_decode (no copy probe).
extern "C" int fkp_paged_decode_q(const void* q, const void* k_pages,
                                  const void* k_scale_pages,
                                  const void* v_pages,
                                  const void* v_scale_pages,
                                  const void* block_tables,
                                  const void* lengths, void* o, void* m,
                                  void* l, void* y, int b, int hq, int hkv,
                                  int page, int d, int max_pages, int n_pages,
                                  int n_splits, int block_s, float scale_log2,
                                  int fp8, int q_int8, int slots,
                                  void* stream) {
  using namespace fkp_ext90;
  if (!decode_valid(b, hq, hkv, page, max_pages, n_pages, n_splits, block_s,
                    slots, o, m, l, y) ||
      !k_scale_pages || !v_scale_pages || (q_int8 && fp8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int* c = dec_counters();
  if (!c) return static_cast<int>(cudaGetLastError());
  const Params p = params(q, block_tables, lengths, nullptr, k_scale_pages,
                          v_scale_pages, o, m, l, y, hq, hkv, 1, page,
                          max_pages, n_splits, block_s, kDecodeRows,
                          scale_log2);
  const auto s = static_cast<cudaStream_t>(stream);
  if (q_int8) return decode_qi8(slots, d, p, k_pages, v_pages, n_pages, b, c, s);
  if (slots == 2) return decode_8bit(fp8, d, p, k_pages, v_pages, n_pages, b, c, s);
  return decode_8bit_deep(fp8, slots, d, p, k_pages, v_pages, n_pages, b, c, s);
}
