// The ragged forward's wgmma route for Hopper (sm_90a): the prefill chunks
// (T >= 9) against a live cache, on the dense forward's kernel
// (flash_fwd_sm90.cuh: wgmma, TMA and a K/V ring) in its ragged flavour.
// This source builds the bf16 online instances and the C entry;
// flash_fwd_ragged_fixed.cu the bf16 fixed-max ones, flash_fwd_ragged_q.cu
// and flash_fwd_ragged_fp8.cu the int8 and e4m3 ones, so that nvcc builds
// the four in parallel. The short chunks and the linear speculative verify
// (T < 9) take the slab route (ragged_slab.cu); the wrapper picks the
// route from static shapes (ops/paged_decode.py::ragged_plan).
//
// Replaces, with the slab route, flashattention_kernel_project_tpu/ops/
// flash_attention.py::_fwd_kernel_ragged (:1582, pallas_call :1830),
// reached through flash_attention_ragged (:1862) over a bf16 cache and
// flash_attention_ragged_kv_quant (:1902) over an int8 or e4m3 one with
// per-token scales [B, Hkv, S_max, 1], online and fixed-max ("auto" is
// online, as the TPU kernel has no hybrid), with the optional window and
// sinks. Query i of row b sees key j iff j < min(kv_lens[b], S_max) and,
// when causal, j <= i + q_offsets[b] (and, with a window, j lies in the
// band of the last `window` positions or among the first `sinks` keys); a
// row that sees no key gives zeros.
//
// What bounds it on the H100: at the serving chunk (T 256 against 768
// live keys, d 128) the products, about 2 * G * T flops a K/V byte (2048),
// far above the ~295 ridge; the mma.sync kernel it replaces reached 3.7%
// of the bf16 peak there. The ragged flavour adds to the dense kernel:
// - the row's bounds read once a block from the int32 pointers (the host
//   never learns them), s = min(kv_len, S_max) and the offset, so that the
//   tile list (past kv_len and the causal diagonal never loaded), the
//   classification of interior tiles (no mask) and the band follow them,
//   uniform over a block: one block is one batch row's;
// - K/V maps 3-D over the cache [B * Hkv, S_max, D]: rows past S_max are
//   zero-filled and never the next head's;
// - no LSE;
// - 8-bit instances (64-row blocks, 64-key tiles): the byte tiles come by
//   TMA into a ring of 3 byte stages from a loading warp, and four
//   widening warps widen each exactly to the swizzled bf16 K-major K and
//   MN-major V tiles the products' descriptors read (e4m3 by widen.cuh,
//   int8 by a PRMT and an FADD a value), with the tile's scales, into a
//   ring of 3 widened stages, while the consumers multiply (the paged
//   extend's consumers widen between two of their barriers, 0.006 ms over
//   bf16 at the serving verify). The K scale goes on the score column after the product, the V
//   scale folds into p after l has summed it, as kernels 11 and 12 do.
//   Shared memory (flash_fwd_sm90.cuh's Layout): 163 KB at d = 128.
// Block rows: 64 where the grid of 64-row blocks fits one wave of the SMs
// (the serving chunk: 4 x 16 blocks), 128 elsewhere (bf16); ragged_plan
// picks them, from static shapes.

#include "flash_fwd_sm90.cuh"

// q [b, hq, n, d] bf16; k/v [b, hkv, s_max, d] bf16 (kv_type 0), int8 (1)
// or e4m3 (2), and for 8 bits k_scale, v_scale [b, hkv, s_max, 1] f32 (null
// for bf16), all contiguous and 16-byte aligned; kv_lens, q_offsets [b]
// int32 on the device; o [b, hq, n, d] bf16. scale_log2 = sm_scale *
// log2(e). d in {64, 128}. window > 0 (causal only): the band plus
// `sinks`; 0: none. disc: 0 online, 1 fixed-max. block_rows: 64 or 128
// (bf16 only). Returns cudaGetLastError() after the launch (or the error of
// the instance's shared-memory attribute), or cudaErrorInvalidValue without
// one for arguments outside these or inputs a TMA map cannot describe.
extern "C" int fkp_flash_fwd_ragged(const void* q, const void* k,
                                    const void* k_scale, const void* v,
                                    const void* v_scale, void* o,
                                    const void* kv_lens, const void* q_offsets,
                                    int b, int hq, int hkv, int n, int s_max,
                                    int d, float scale_log2, int causal,
                                    int window, int sinks, int disc,
                                    int kv_type, int block_rows, void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv || n <= 0 || s_max <= 0 ||
      (disc != fkp_fwd::kOnline && disc != fkp_fwd::kFixed) || kv_type < 0 ||
      kv_type > 2 || (kv_type && (!k_scale || !v_scale)) ||
      b > 65535 || hq > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const fkp_sm90::RaggedArgs a{
      q, k, v, o,
      fkp_sm90::RaggedPtrs{static_cast<const int*>(kv_lens),
                           static_cast<const int*>(q_offsets),
                           static_cast<const float*>(k_scale),
                           static_cast<const float*>(v_scale)},
      b, hq, hkv, n, s_max, scale_log2, causal, window, sinks, block_rows,
      static_cast<cudaStream_t>(stream)};
  if (kv_type == 1) return fkp_sm90::launch_ragged_int8(d, disc, a);
  if (kv_type == 2) return fkp_sm90::launch_ragged_e4m3(d, disc, a);
  if (disc == fkp_fwd::kFixed) return fkp_sm90::launch_ragged_fixed(d, a);
  return fkp_sm90::launch_ragged_disc<__nv_bfloat16, fkp_fwd::kOnline>(d, a);
}
