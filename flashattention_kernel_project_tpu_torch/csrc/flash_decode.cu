// Split-KV single-token GQA decode for Hopper (sm_90a) over an 8-bit
// linear cache (kernel 7).
//
// Replaces flashattention_kernel_project_tpu/ops/flash_decode.py::
// _decode_kernel_int8 (reached through flash_decode_int8 and
// flash_decode_fp8) for an int8 or e4m3 cache with one f32 scale per key
// and head: each (batch, KV head, split) program emits the unnormalized
// partials (m, l, y) of the G = Hq / Hkv query rows of its group over its
// split's keys below lengths[b]; merge_partials combines the splits outside
// the kernel. The block's work is decode_partials in decode_core.cuh, where
// its design and bound are described. With a sliding window (window > 0)
// the query at position len - 1 sees keys [len - window, len) and the first
// `sinks` (JAX flash_decode.py:126-131): a split reads only the keys of
// those two ranges that fall in it, and a split with none returns at once,
// as the TPU kernel's `live` test and `_clamp_to_live` skip it. The kernel
// reads the scales in the cache's own [B, Hkv, S, 1] layout; the JAX
// wrapper relaid them out lane-major for the TPU's vector unit. (A bf16
// cache takes flash_decode_sm90.cuh's kernel.)
//
// Grid (B, Hkv, n_splits), one 128-thread block per split, chosen by the
// wrapper so that B*Hkv*n_splits blocks fill the 132 SMs (the TPU ran its
// grid serially and used one split per 4096 keys).

#include "decode_core.cuh"

namespace {

using fkp_dec::kThreads;

// key j of a linear cache lives at row j, its scales at entry j
struct LinearRows {
  int d;
  __device__ __forceinline__ size_t offset(int key) const {
    return (size_t)key * d;
  }
  __device__ __forceinline__ size_t scale(int key) const { return key; }
};

// The group's partials over an 8-bit cache (T = int8_t or __nv_fp8_e4m3)
// with its scales [b, hkv, s, 1]
template <int D, int G, class T>
__global__ void __launch_bounds__(kThreads)
    flash_decode_q_kernel(const __nv_bfloat16* __restrict__ q,
                          const T* __restrict__ k,
                          const float* __restrict__ k_scale,
                          const T* __restrict__ v,
                          const float* __restrict__ v_scale,
                          const int* __restrict__ lengths,
                          float* __restrict__ m_out, float* __restrict__ l_out,
                          float* __restrict__ y_out, int hkv, int s,
                          int n_splits, int block_s, float sm_scale,
                          int window, int sinks) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int split = blockIdx.z;
  const int len = min(max(lengths[b], 0), s);
  const int start = split * block_s;
  int s0, e0, s1, e1;
  fkp_dec::window_ranges(start, min(start + block_s, len), len, window, sinks,
                         s0, e0, s1, e1);
  const size_t part = ((size_t)b * hkv + kvh) * n_splits + split;
  const size_t bh = (size_t)b * hkv + kvh;
  fkp_dec::decode_partials<D, G>(
      q + bh * G * D, k + bh * s * D, v + bh * s * D, k_scale + bh * s,
      v_scale + bh * s, LinearRows{D}, s0, e0, sm_scale, m_out + part * G,
      l_out + part * G, y_out + part * G * D, s1, e1);
}

}  // namespace

// q [b, hq, d] bf16; k/v [b, hkv, s, d] int8 (fp8 == 0) or e4m3 (fp8 == 1)
// and their scales k_scale/v_scale [b, hkv, s, 1] f32, all contiguous;
// lengths [b] int32; m, l [b, hkv, n_splits, G] and y [b, hkv, n_splits,
// G, d] f32, G = hq/hkv in {1, 2, 4, 8}, d in {64, 128}. Split i covers
// keys [i*block_s, (i+1)*block_s). window > 0: the band of the last
// `window` keys plus the first `sinks`; 0: every key below the length.
// Returns cudaGetLastError() after the launch.
extern "C" int fkp_flash_decode_q(const void* q, const void* k,
                                  const void* k_scale, const void* v,
                                  const void* v_scale, const void* lengths,
                                  void* m, void* l, void* y, int b, int hq,
                                  int hkv, int s, int d, int n_splits,
                                  int block_s, float sm_scale, int window,
                                  int sinks, int fp8, void* stream) {
  const dim3 grid(b, hkv, n_splits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return fkp_dec::dispatch_8bit(d, hq / hkv, fp8, [&](auto dc, auto gc, auto tc) {
    using T = typename decltype(tc)::type;
    flash_decode_q_kernel<decltype(dc)::value, decltype(gc)::value, T>
        <<<grid, kThreads, 0, st>>>(
            static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k),
            static_cast<const float*>(k_scale), static_cast<const T*>(v),
            static_cast<const float*>(v_scale),
            static_cast<const int*>(lengths), static_cast<float*>(m),
            static_cast<float*>(l), static_cast<float*>(y), hkv, s, n_splits,
            block_s, sm_scale, window, sinks);
  });
}
