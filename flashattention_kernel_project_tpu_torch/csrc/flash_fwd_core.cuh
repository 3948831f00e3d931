// What the Hopper attention kernels share of the earlier mma.sync forward
// core: the softmax disciplines, the fixed-max range guard's outputs and
// helpers, and the notes on the function they all compute. The dense
// forward (flash_fwd.cu, and its 8-bit form, flash_fwd_q.cu) and the
// ragged forward's wgmma route (flash_fwd_ragged.cu) are
// flash_fwd_sm90.cuh's kernels, the paged extend and the ragged forward's
// slab route paged_extend_sm90.cuh's; the mma.sync block body that the
// dense 8-bit forward was the last to use is gone.
//
// Softmax in the log2 domain (scores times sm_scale * log2(e)), the online
// (m, l, acc) rescale with exp2, causal and tail masks, GQA with q head h
// reading KV head h / (Hq / Hkv). Query row i of batch row b sees key j iff
// j < kv_len(b) and, when causal, j <= pos(i), the row's position, and,
// with a sliding window (window > 0, causal only), j > pos(i) - window or
// j < sinks (the band of the last `window` positions and the first `sinks`
// keys, the StreamingLLM attention sinks), with kv_len = S and pos(i) = i +
// one static q_offset.
//
// Precision differs from the TPU kernels in two places, both toward f32.
// The scale multiplies the f32 scores instead of a bf16-rounded q, and p
// enters the PV product as a bf16 hi + lo pair (about 16 bits, two MMAs)
// instead of one bf16 value. Rounding p to bf16 in either the forward or the
// decode kernels widens the gap between the bf16 model's cached-decode logits and
// its full forward (ROADMAP.md, section C).
//
// The softmax discipline is a template switch (kDisc), as the TPU
// kernel's `stable` is a static argument:
// - kOnline (stable=True): the running max m with the rescale of l and acc
//   at every tile.
// - kFixed (stable=False, the fixed-max discipline): m stays 0 for the
//   row's whole life, so the tile max, its four shuffles and the rescale
//   are gone; p = exp2(s), a masked lane's exp2(NEG_INF) is exactly 0, LSE
//   = ln(l), and a row with no key still gives O = 0 and LSE = NEG_INF. It
//   holds while every |s| (log2 domain) stays below 78 (_SAFE_BOUND of the
//   TPU kernel): p then lies in [2^-78, 2^78], l and acc in f32 far from
//   overflow, and the bf16 hi + lo split keeps its 16 bits, since bf16 has
//   f32's exponent range. Outside it p overflows to inf and the output
//   turns non-finite: the failure is loud, never a silent drift.
// - kHybrid (stable="auto", dense only): each warp picks the discipline of
//   its own 16 rows. It reads their Q rows once, before the key loop,
//   takes max_r ||q_r||^2 over them with shuffles, and runs fixed-max iff max_r ||q_r|| * |scale| * log2(e) *
//   k_max < 78 (Cauchy-Schwarz bounds every score of those rows), online
//   otherwise; a NaN or inf bound runs online. k_max = max_t ||k_t|| is a
//   device f32 scalar read by pointer: the host never reads it. The TPU
//   kernel takes the q half of the bound outside the kernel, per 512- or
//   1024-row block, because a cross-lane reduce is dear there. The tile's
//   products and softmax are compiled in both disciplines and each warp
//   runs its own: a runtime branch around the max and the rescale alone
//   left a fixed-max warp paying for the tile max and the masked select,
//   at the online kernel's speed. A warp whose bound breaches runs exactly
//   the online code, so on such inputs "auto" equals the online kernel.
// The switch is compile-time for the reason kWindow is: a runtime term in
// the key loop costs the causal online forward.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fkp_fwd {

constexpr float kNegInf = -1e30f;  // finite, as NEG_INF in ops/softmax.py
constexpr float kLn2 = 0.6931471805599453f;

// the softmax discipline: stable=True, stable=False, stable="auto"
enum Disc : int { kOnline = 0, kFixed = 1, kHybrid = 2 };
// the log2-domain score bound under which fixed-max is sound (_SAFE_BOUND)
constexpr float kSafeBound = 78.f;

// The fixed-max range guard's outputs (the dense fixed-max instances; null
// when off). count: an int32 to which the breaching rows are added. pairs
// (the packed d=64 call; null: each head's row counts): one bit per (b, KV
// head pair, group member, row), zeroed by the caller, so that a row counts
// once when either head of a KV pair breaches there, as the TPU's paired
// kernel counts it.
struct GuardArgs {
  int* count;
  unsigned* pairs;
};

// Sets the pairs bit of head h's row (its KV pair's, group member's) and
// says whether it was clear: the first of the pair's two heads to breach
// there counts the row. Not inlined: inline, the index and the atomic
// slowed the packed d=64 kernel's key loop by a tenth (ptxas reallocated
// it), though they run only for a breaching row.
static __device__ __noinline__ bool first_of_pair(unsigned* pairs, int b,
                                                  int h, int hq, int hkv,
                                                  int n, int row) {
  const int group = hq / hkv;
  const size_t pair = (size_t)b * (hkv / 2) + h / group / 2;
  const size_t i = (pair * group + h % group) * n + row;
  const unsigned bit = 1u << (i % 32);
  return (atomicOr(pairs + i / 32, bit) & bit) == 0u;
}

// a compile-time bool as a type, to pick a generic lambda's instance
template <bool B>
struct Bool {
  static constexpr bool value = B;
};

// the sum of squares of a bf16 pair
__device__ __forceinline__ float sq_bf16x2(uint32_t w) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  return f.x * f.x + f.y * f.y;
}

}  // namespace fkp_fwd
