// The 8-bit linear-cache decode for Hopper (sm_90a), kernel 7: the int8
// instances of flash_decode_sm90.cuh's 8-bit kernel (d in {64, 128} x G in
// {1, 2, 4, 8} x with and without a window: 16), the arrival counters of
// its split merge and its C entries; flash_decode_q_fp8.cu builds the e4m3
// instances, so that nvcc builds the two in parallel.
//
// Replaces flashattention_kernel_project_tpu/ops/flash_decode.py::
// _decode_kernel_int8 (:102, pallas_call :557), reached through
// flash_decode_int8 and flash_decode_fp8 (mxu=False) for an int8 or e4m3
// cache with one f32 scale per key and head, with its window and sinks
// (:126-131), and the merge of its splits (merge_partials, a jnp reduction
// after the pallas_call). The kernel reads the scales in the cache's own
// [B, Hkv, S, 1] layout; the JAX wrapper relaid them out lane-major for
// the TPU's vector unit. Its design and bound are the header's: a key costs
// 2 * d + 8 bytes, half of bf16's, and the HBM stream is the roof.

#include "flash_decode_sm90.cuh"

namespace fkp_dec90 {
namespace {

// one a (batch row, KV head); every completed launch leaves them at 0
__device__ int g_q_counters[kMaxCounters];

// The instance for the cache's type (fp8: e4m3, else int8); returns as
// launch_q.
int launch_8bit(int fp8, int d, int g, const Params& p, const void* k,
                const void* v, int b, cudaStream_t stream) {
  int* counters = nullptr;
  const cudaError_t err = cudaGetSymbolAddress(
      reinterpret_cast<void**>(&counters), g_q_counters);
  if (err != cudaSuccess) return static_cast<int>(err);
  return fp8 ? launch_e4m3(d, g, p, k, v, b, counters, stream)
             : launch_q_any<int8_t>(d, g, p, k, v, b, counters, stream);
}

}  // namespace
}  // namespace fkp_dec90

// q [b, hq, d] bf16; k/v [b, hkv, s, d] int8 (fp8 == 0) or e4m3 (fp8 == 1)
// and their scales k_scale/v_scale [b, hkv, s, 1] f32, all contiguous, k
// and v 16-byte aligned; lengths [b] int32 (keys [0, min(lengths, s))
// attended); the partials of each split: m, l [b, hkv, n_splits, G] and y
// [b, hkv, n_splits, G, d] f32, G = hq/hkv in {1, 2, 4, 8}, d in {64, 128}
// (m in natural-log units, NEG_INF with l = 0 and y = 0 for a split with
// no live key). Split i covers keys [i*block_s, (i+1)*block_s). window >
// 0: the band of the last `window` keys plus the first `sinks`; 0: every
// key below the length. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue without one for a shape outside these or inputs a
// TMA map cannot describe.
extern "C" int fkp_flash_decode_q(const void* q, const void* k,
                                  const void* k_scale, const void* v,
                                  const void* v_scale, const void* lengths,
                                  void* m, void* l, void* y, int b, int hq,
                                  int hkv, int s, int d, int n_splits,
                                  int block_s, float sm_scale, int window,
                                  int sinks, int fp8, void* stream) {
  if (!fkp_dec90::valid(b, hq, hkv, s, n_splits, block_s) || !m || !l || !y ||
      !k_scale || !v_scale) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fkp_dec90::Params p{
      static_cast<const __nv_bfloat16*>(q), static_cast<const int*>(lengths),
      static_cast<float*>(m), static_cast<float*>(l), static_cast<float*>(y),
      nullptr, hkv, s, n_splits, block_s, sm_scale * fkp_dec90::kLog2e,
      window, sinks};
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  return fkp_dec90::launch_8bit(fp8, d, hq / hkv, p, k, v, b,
                                static_cast<cudaStream_t>(stream));
}

// The same call merged on the card: out [b, hq, d] bf16 takes the
// normalised rows (0 for a row that sees no key). With n_splits > 1, m, l
// and y (as fkp_flash_decode_q's, y 16-byte aligned) are the splits'
// workspace and b * hkv is at most 2^18; with one split they are unread
// and may be null. Returns as fkp_flash_decode_q.
extern "C" int fkp_flash_decode_q_out(const void* q, const void* k,
                                      const void* k_scale, const void* v,
                                      const void* v_scale, const void* lengths,
                                      void* out, void* m, void* l, void* y,
                                      int b, int hq, int hkv, int s, int d,
                                      int n_splits, int block_s,
                                      float sm_scale, int window, int sinks,
                                      int fp8, void* stream) {
  if (!fkp_dec90::valid(b, hq, hkv, s, n_splits, block_s) || !out ||
      !k_scale || !v_scale ||
      (n_splits > 1 && (!m || !l || !y ||
                        reinterpret_cast<uintptr_t>(y) % 16 ||
                        (long long)b * hkv > fkp_dec90::kMaxCounters))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fkp_dec90::Params p{
      static_cast<const __nv_bfloat16*>(q), static_cast<const int*>(lengths),
      static_cast<float*>(m), static_cast<float*>(l), static_cast<float*>(y),
      static_cast<__nv_bfloat16*>(out), hkv, s, n_splits, block_s,
      sm_scale * fkp_dec90::kLog2e, window, sinks};
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  return fkp_dec90::launch_8bit(fp8, d, hq / hkv, p, k, v, b,
                                static_cast<cudaStream_t>(stream));
}
