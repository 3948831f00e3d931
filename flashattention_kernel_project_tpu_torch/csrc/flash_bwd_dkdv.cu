// Attention backward for Hopper (sm_90a), first kernel: dK and dV.
//
// Replaces flashattention_kernel_project_tpu/ops/flash_attention.py::
// _bwd_dkdv_kernel (reached through _bwd_pallas._run_dkdv with
// fuse_dq=False): the FlashAttention-2 recompute with the forward's saved
// logsumexp, KV-stationary. For each key it sums, over every query of the
// GQA group that sees it,
//   p  = exp(s - lse),  s = sm_scale * q.k
//   dV += p * dO
//   dK += sm_scale * p * (dO.v - delta) * q,  delta = rowsum(O * dO).
//
// What bounds it on the H100: four products of 2*d flops per (query, key)
// pair against K/V read once and Q/dO re-read once per key tile: far above
// the ~295 flop/byte ridge at training shapes, so the rate of tensor-core
// instructions and the elementwise chain between the products bound it.
//
// Design: one block of 4 warps per (64-key tile, KV head, batch), as the
// JAX grid (b, hkv, n_kv, group * n_q). Each warp owns 16 keys and keeps
// their dK and dV accumulators (16 x D each, f32) in registers for the
// whole loop over the group's q heads and their causally live query tiles
// (the JAX `live` / `i_min`; with a sliding window only the tiles whose
// rows still hold a key of the tile in their band, unless it holds sink
// keys, JAX :1993-2007), so the group's contributions are summed in
// the block and written once, with no atomics. K and V stay in shared
// memory for the block's life; each query tile's Q, dO, lse and delta are
// staged in shared memory and shared by the 4 warps. The products are
// mma.sync m16n8k16 with fragments from ldmatrix:
//   S^T  = K Q^T        (keys are the M rows, so the S^T accumulator is
//                        already the A operand of the next two products)
//   dV  += P^T dO
//   dP^T = V dO^T
//   dK  += dS^T Q,      dS^T = P^T * (dP^T - delta)
// p and ds are rounded to bf16 only as MMA operands; scores, p, ds and the
// accumulators are f32. p = exp2(s * sm_scale * log2e - lse * log2e) is
// zeroed by the causal and tail masks themselves: a query row that sees no
// key carries lse = NEG_INF, for which exp2 would overflow.
// The query tile is 32 rows at d = 128 and 64 at d = 64: with dK and dV
// alone taking 128 registers a thread at d = 128, the smaller tile keeps
// the S^T and dP^T tiles small enough that ptxas spills nothing.
// The window is a template switch (kWindow): as a runtime term it cost the
// causal kernel about a quarter of its time at the training shape on the
// H100.
// Left for later: wgmma, TMA, double-buffered Q/dO tiles, and the fused
// dq schedule of the JAX default (fuse_dq=True).

#include "flash_bwd_common.cuh"

namespace {

using namespace fkp_bwd;

constexpr int kBlockN = 64;  // keys per block (16 per warp)

template <int D>
__host__ __device__ constexpr int block_q() { return D == 128 ? 32 : 64; }

template <int D>
constexpr int smem_bytes() {
  return (2 * kBlockN + 2 * block_q<D>()) * (D + 8) * 2 + 2 * block_q<D>() * 4;
}

template <int D, bool kWindow>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int hq, int hkv,
                          int n, int s, float sm_scale, int causal,
                          int q_offset, int window, int sinks) {
  constexpr int kBlockQ = block_q<D>();
  constexpr int kStride = D + 8;  // padded row, in bf16: ldmatrix rows hit distinct banks
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* v_s = k_s + kBlockN * kStride;
  __nv_bfloat16* q_s = v_s + kBlockN * kStride;
  __nv_bfloat16* do_s = q_s + kBlockQ * kStride;
  float* lse_s = reinterpret_cast<float*>(do_s + kBlockQ * kStride);  // log2 domain
  float* delta_s = lse_s + kBlockQ;

  const int key0 = blockIdx.x * kBlockN;  // low tiles see the most queries: first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = hq / hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wkey = warp * 16;  // the warp's first key row in the tile
  const float scale_log2 = sm_scale * kLog2e;

  const size_t kv_off = ((size_t)b * hkv + kvh) * s * D;
  load_tile<D>(k_s, kStride, k + kv_off, key0, kBlockN, s);
  load_tile<D>(v_s, kStride, v + kv_off, key0, kBlockN, s);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nd][e] = dv_acc[nd][e] = 0.f;
  }

  // causal: query i sees key j iff j <= i + q_offset, so the first query
  // that sees any key of this tile is key0 - q_offset
  const int q_first = causal ? max(key0 - q_offset, 0) : 0;
  const int qt_begin = q_first / kBlockQ;
  int n_qt = (n + kBlockQ - 1) / kBlockQ;
  // sliding window (causal only): a tile with no sink key is seen only by
  // rows whose band still reaches its last key, pos < key_last + window
  if (kWindow && key0 >= sinks) {
    const int last_row = key0 + kBlockN - 1 + window - 1 - q_offset;
    n_qt = last_row < 0 ? 0 : min(n_qt, last_row / kBlockQ + 1);
  }
  const int key_r0 = key0 + wkey + g;  // this thread's two key rows
  const int key_r1 = key_r0 + 8;

  for (int hh = 0; hh < group; ++hh) {
    const size_t bh = (size_t)b * hq + kvh * group + hh;
    const __nv_bfloat16* q_bh = q + bh * n * D;
    const __nv_bfloat16* do_bh = dout + bh * n * D;
    for (int qt = qt_begin; qt < n_qt; ++qt) {
      const int q0 = qt * kBlockQ;
      __syncthreads();  // the previous tile's readers are done
      load_tile<D>(q_s, kStride, q_bh, q0, kBlockQ, n);
      load_tile<D>(do_s, kStride, do_bh, q0, kBlockQ, n);
      for (int i = threadIdx.x; i < kBlockQ; i += kThreads) {
        const bool in = q0 + i < n;
        lse_s[i] = in ? lse[bh * n + q0 + i] * kLog2e : 0.f;
        delta_s[i] = in ? delta[bh * n + q0 + i] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T: 16 keys x kBlockQ queries per warp
      float st[kBlockQ / 8][4];
#pragma unroll
      for (int nt = 0; nt < kBlockQ / 8; ++nt) {
        st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        load_a(a, k_s, kStride, wkey, kk * 16, lane);
#pragma unroll
        for (int np = 0; np < kBlockQ / 16; ++np) {
          uint32_t bq[4];
          load_b_nk(bq, q_s, kStride, np * 16, kk * 16, lane);
          mma_16816(st[2 * np], a, bq[0], bq[1]);
          mma_16816(st[2 * np + 1], a, bq[2], bq[3]);
        }
      }

      // P^T, masked: element e of n-tile nt is (key_r0 if e < 2 else
      // key_r1, query q0 + nt*8 + 2t + (e & 1))
#pragma unroll
      for (int nt = 0; nt < kBlockQ / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = nt * 8 + 2 * t + (e & 1);
          const int kj = e < 2 ? key_r0 : key_r1;
          const int pos = q0 + qi + q_offset;
          const bool ok = q0 + qi < n && kj < s &&
                          (!causal || (kj <= pos && (!kWindow ||
                                                     kj > pos - window ||
                                                     kj < sinks)));
          st[nt][e] = ok ? exp2f(st[nt][e] * scale_log2 - lse_s[qi]) : 0.f;
        }
      }

      // dV += P^T dO: A from the P^T registers, B = dO stored [query][dim]
#pragma unroll
      for (int kk = 0; kk < kBlockQ / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16(st[2 * kk][0], st[2 * kk][1]),
                               pack_bf16(st[2 * kk][2], st[2 * kk][3]),
                               pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                               pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t bd[4];
          load_b_kn(bd, do_s, kStride, kk * 16, np * 16, lane);
          mma_16816(dv_acc[2 * np], a, bd[0], bd[1]);
          mma_16816(dv_acc[2 * np + 1], a, bd[2], bd[3]);
        }
      }

      // dP^T = V dO^T
      float dpt[kBlockQ / 8][4];
#pragma unroll
      for (int nt = 0; nt < kBlockQ / 8; ++nt) {
        dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        load_a(a, v_s, kStride, wkey, kk * 16, lane);
#pragma unroll
        for (int np = 0; np < kBlockQ / 16; ++np) {
          uint32_t bd[4];
          load_b_nk(bd, do_s, kStride, np * 16, kk * 16, lane);
          mma_16816(dpt[2 * np], a, bd[0], bd[1]);
          mma_16816(dpt[2 * np + 1], a, bd[2], bd[3]);
        }
      }

      // dS^T = P^T * (dP^T - delta), in place
#pragma unroll
      for (int nt = 0; nt < kBlockQ / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dpt[nt][e] = st[nt][e] * (dpt[nt][e] - delta_s[nt * 8 + 2 * t + (e & 1)]);
        }
      }

      // dK += dS^T Q: B = Q stored [query][dim]
#pragma unroll
      for (int kk = 0; kk < kBlockQ / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
                               pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
                               pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
                               pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t bq[4];
          load_b_kn(bq, q_s, kStride, kk * 16, np * 16, lane);
          mma_16816(dk_acc[2 * np], a, bq[0], bq[1]);
          mma_16816(dk_acc[2 * np + 1], a, bq[2], bq[3]);
        }
      }
    }
  }

  // one sm_scale on dK (chain rule through s = sm_scale * q.k), none on dV
  __nv_bfloat16* dk_bh = dk + kv_off;
  __nv_bfloat16* dv_bh = dv + kv_off;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (key_r0 < s) {
      *reinterpret_cast<__nv_bfloat162*>(dk_bh + (size_t)key_r0 * D + c) =
          __floats2bfloat162_rn(dk_acc[nd][0] * sm_scale, dk_acc[nd][1] * sm_scale);
      *reinterpret_cast<__nv_bfloat162*>(dv_bh + (size_t)key_r0 * D + c) =
          __floats2bfloat162_rn(dv_acc[nd][0], dv_acc[nd][1]);
    }
    if (key_r1 < s) {
      *reinterpret_cast<__nv_bfloat162*>(dk_bh + (size_t)key_r1 * D + c) =
          __floats2bfloat162_rn(dk_acc[nd][2] * sm_scale, dk_acc[nd][3] * sm_scale);
      *reinterpret_cast<__nv_bfloat162*>(dv_bh + (size_t)key_r1 * D + c) =
          __floats2bfloat162_rn(dv_acc[nd][2], dv_acc[nd][3]);
    }
  }
}

template <int D, bool kWindow>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dk, void* dv, int b,
           int hq, int hkv, int n, int s, float sm_scale, int causal,
           int q_offset, int window, int sinks, cudaStream_t st) {
  constexpr int kSmem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<D, kWindow>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kBlockN - 1) / kBlockN, hkv, b);
  flash_bwd_dkdv_kernel<D, kWindow><<<grid, kThreads, kSmem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), hq, hkv,
      n, s, sm_scale, causal, q_offset, window, sinks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, dout [b, hq, n, d], k/v [b, hkv, s, d] bf16 contiguous; lse (natural
// log) and delta [b, hq, n] f32; dk/dv [b, hkv, s, d] bf16, every row
// written (zero for a key that no row sees). d in {64, 128}. window > 0
// (causal only): the forward's band plus `sinks`; 0: none. Returns
// cudaGetLastError() after the launch.
extern "C" int fkp_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv, int b,
                                  int hq, int hkv, int n, int s, int d,
                                  float sm_scale, int causal, int q_offset,
                                  int window, int sinks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto run = [&](auto fn) {
    return fn(q, k, v, dout, lse, delta, dk, dv, b, hq, hkv, n, s, sm_scale,
              causal, q_offset, window, sinks, st);
  };
  const bool win = window > 0;
  if (d == 64) return run(win ? &launch<64, true> : &launch<64, false>);
  if (d == 128) return run(win ? &launch<128, true> : &launch<128, false>);
  return static_cast<int>(cudaErrorInvalidValue);
}
