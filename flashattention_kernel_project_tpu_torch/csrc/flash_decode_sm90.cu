// The bf16 linear-cache decode for Hopper (sm_90a): the 16 instances of
// flash_decode_sm90.cuh's kernel (d in {64, 128} x G in {1, 2, 4, 8} x
// with and without a window), the arrival counters of its split merge, and
// its C entries. The kernel's design, bound and the TPU kernel it replaces
// (flash_decode.py::_decode_kernel) are described in the header.

#include "flash_decode_sm90.cuh"

namespace fkp_dec90 {
namespace {

// one a (batch row, KV head); every completed launch leaves them at 0
__device__ int g_counters[kMaxCounters];

// Launches instance <D, G, kWindow> on a grid of (n_splits, hkv, b);
// returns a CUDA error code (the shared-memory attribute's,
// cudaErrorInvalidValue where a map cannot be encoded, else
// cudaGetLastError() after the launch).
template <int D, int G, bool kWindow>
int launch(const Params& p, const void* k, const void* v, int b,
           cudaStream_t stream) {
  const auto kernel = &flash_decode_sm90_kernel<D, G, kWindow>;
  constexpr int kBytes = Layout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int* counters = nullptr;
  err = cudaGetSymbolAddress(reinterpret_cast<void**>(&counters), g_counters);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap km, vm;
  if (!fkp_sm90::encode_map(&km, k, D, p.s, b * p.hkv, kTile) ||
      !fkp_sm90::encode_map(&vm, v, D, p.s, b * p.hkv, kTile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<dim3(p.n_splits, p.hkv, b), kThreads, kBytes, stream>>>(km, vm, p,
                                                                   counters);
  return static_cast<int>(cudaGetLastError());
}

// The instance for the call's d, g and window (by_shape).
int launch_any(int d, int g, const Params& p, const void* k, const void* v,
               int b, cudaStream_t stream) {
  return by_shape(d, g, p.window, [&](auto dc, auto gc, auto wc) {
    return launch<decltype(dc)::value, decltype(gc)::value, decltype(wc)::value>(
        p, k, v, b, stream);
  });
}

}  // namespace
}  // namespace fkp_dec90

// q [b, hq, d], k/v [b, hkv, s, d] bf16 contiguous and 16-byte aligned,
// lengths [b] int32 (keys [0, min(lengths, s)) attended); the partials of
// each split: m, l [b, hkv, n_splits, G] and y [b, hkv, n_splits, G, d]
// f32, G = hq/hkv in {1, 2, 4, 8}, d in {64, 128} (m in natural-log units,
// NEG_INF with l = 0 and y = 0 for a split with no live key). Split i
// covers keys [i*block_s, (i+1)*block_s). window > 0: the band of the last
// `window` keys plus the first `sinks`; 0: every key below the length.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// without one for a shape outside these or inputs a TMA map cannot
// describe.
extern "C" int fkp_flash_decode(const void* q, const void* k, const void* v,
                                const void* lengths, void* m, void* l, void* y,
                                int b, int hq, int hkv, int s, int d,
                                int n_splits, int block_s, float sm_scale,
                                int window, int sinks, void* stream) {
  if (!fkp_dec90::valid(b, hq, hkv, s, n_splits, block_s) || !m || !l || !y) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const fkp_dec90::Params p{
      static_cast<const __nv_bfloat16*>(q), static_cast<const int*>(lengths),
      static_cast<float*>(m), static_cast<float*>(l), static_cast<float*>(y),
      nullptr, hkv, s, n_splits, block_s, sm_scale * fkp_dec90::kLog2e,
      window, sinks};
  return fkp_dec90::launch_any(d, hq / hkv, p, k, v, b,
                               static_cast<cudaStream_t>(stream));
}

// The same call merged on the card: out [b, hq, d] bf16 takes the
// normalised rows (0 for a row that sees no key). With n_splits > 1, m, l
// and y (as fkp_flash_decode's, y 16-byte aligned) are the splits'
// workspace and b * hkv is at most 2^18; with one split they are unread
// and may be null. Returns as fkp_flash_decode.
extern "C" int fkp_flash_decode_out(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* out, void* m, void* l, void* y,
                                    int b, int hq, int hkv, int s, int d,
                                    int n_splits, int block_s, float sm_scale,
                                    int window, int sinks, void* stream) {
  if (!fkp_dec90::valid(b, hq, hkv, s, n_splits, block_s) || !out ||
      (n_splits > 1 && (!m || !l || !y ||
                        reinterpret_cast<uintptr_t>(y) % 16 ||
                        (long long)b * hkv > fkp_dec90::kMaxCounters))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const fkp_dec90::Params p{
      static_cast<const __nv_bfloat16*>(q), static_cast<const int*>(lengths),
      static_cast<float*>(m), static_cast<float*>(l), static_cast<float*>(y),
      static_cast<__nv_bfloat16*>(out), hkv, s, n_splits, block_s,
      sm_scale * fkp_dec90::kLog2e, window, sinks};
  return fkp_dec90::launch_any(d, hq / hkv, p, k, v, b,
                               static_cast<cudaStream_t>(stream));
}
