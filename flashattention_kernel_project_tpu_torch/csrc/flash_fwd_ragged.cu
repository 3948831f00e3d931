// Ragged GQA attention forward for Hopper (sm_90a): per-row KV lengths and
// causal query offsets, O only.
//
// Replaces flashattention_kernel_project_tpu/ops/flash_attention.py::
// _fwd_kernel_ragged (reached through flash_attention_ragged) for a bf16
// cache, stable=True: chunked prefill and the prefix-cache suffix, where a
// chunk of T queries attends a live KV cache of S_max rows of which row b
// holds kv_lens[b]. Query i of row b sees key j iff j < kv_lens[b] and, when
// causal, j <= i + q_offsets[b]. A row that sees no key gives zeros.
//
// It is the ragged flavour of the tiled forward in flash_fwd_core.cuh (the
// design, precision and bound are described there). What this flavour adds:
// - The bounds stay on the device. kv_lens and q_offsets arrive as int32
//   pointers and each block reads its row's pair, so the host never syncs to
//   learn them (one sync per layer per chunk otherwise).
// - Live key tiles are counted per (batch row, query tile) from those
//   bounds: tiles past kv_len or past the causal diagonal of the tile's last
//   query are never loaded, as the TPU kernel's `live` test skips them.
// - Tiles wholly inside every row's bound skip the mask.
// - K and V are the cache buffers themselves, [B, Hkv, S_max, D]: S_max is
//   the row stride and kv_len the bound.
// Tile size: 64 query rows, as the dense forward. In serving, T is the
// prefill chunk (256) for all but a prompt's last chunk, which pads its
// tile; a smaller tile for short chunks would pay only on that last chunk.

#include "flash_fwd_core.cuh"

using fkp_fwd::flash_fwd_kernel;
using fkp_fwd::kBlockM;
using fkp_fwd::kThreads;

// q [b, hq, n, d], k/v [b, hkv, s_max, d] bf16 contiguous, kv_lens and
// q_offsets [b] int32 on the device; o [b, hq, n, d] bf16. scale_log2 =
// sm_scale * log2(e). d in {64, 128}. Returns cudaGetLastError() after the
// launch.
extern "C" int fkp_flash_fwd_ragged(const void* q, const void* k,
                                    const void* v, void* o,
                                    const void* kv_lens, const void* q_offsets,
                                    int b, int hq, int hkv, int n, int s_max,
                                    int d, float scale_log2, int causal,
                                    void* stream) {
  const dim3 grid((n + kBlockM - 1) / kBlockM, hq, b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(o);
  const auto* lens = static_cast<const int*>(kv_lens);
  const auto* offs = static_cast<const int*>(q_offsets);
  if (d == 64) {
    flash_fwd_kernel<64, fkp_fwd::kRagged><<<grid, kThreads, 0, st>>>(
        qp, kp, vp, op, nullptr, hq, hkv, n, s_max, scale_log2, causal, 0,
        lens, offs, fkp_fwd::PagedArgs{});
  } else if (d == 128) {
    flash_fwd_kernel<128, fkp_fwd::kRagged><<<grid, kThreads, 0, st>>>(
        qp, kp, vp, op, nullptr, hq, hkv, n, s_max, scale_log2, causal, 0,
        lens, offs, fkp_fwd::PagedArgs{});
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
