// Attention backward for Hopper (sm_90a), second kernel: dQ.
//
// Replaces flashattention_kernel_project_tpu/ops/flash_attention.py::
// _bwd_dq_kernel (the two-kernel form of _bwd_pallas, fuse_dq=False):
// Q-stationary, for each query row
//   dq = sm_scale * sum_j p_j (dO.v_j - delta) k_j,  p = exp(s - lse).
// The JAX default (fuse_dq=True) takes dq as per-KV-block partials from the
// dK/dV kernel and sums them outside; on the H100 that costs atomics or an
// n_kv x |q| partials buffer, so this kernel recomputes s and dp instead.
//
// What bounds it on the H100: three products of 2*d flops per (query, key)
// pair; K/V are re-read once per query tile from L2. The rate of
// tensor-core instructions and the elementwise chain bound it, as in the
// forward.
//
// Design: one block of 4 warps per (64-query tile, q head, batch), the
// heaviest causal tiles first, over the causally live 64-key tiles (with a
// sliding window, the forward's tiles: the sink tiles, then the band's from
// the first row's first band key, JAX :2258-2269). Each
// warp owns 16 query rows: their dQ (16 x D f32), lse and delta stay in
// registers. Q and dO are staged in shared memory once, K and V per key
// tile; fragments come from ldmatrix. Products (mma.sync m16n8k16):
//   S  = Q K^T,  dP = dO V^T,  dQ += dS K,  dS = P * (dP - delta)
// with p and ds rounded to bf16 only as MMA operands. p is zeroed by the
// masks themselves, so a row that sees no key (lse = NEG_INF) gets dq = 0.
// The window stays a runtime term here (a template switch in the forward
// and dK/dV): with it, the causal kernel ran 15% faster than without it at
// the training shape on the H100 (tools/time_kernels.py).
// Left for later: wgmma, TMA, double-buffered K/V tiles.

#include "flash_bwd_common.cuh"

namespace {

using namespace fkp_bwd;

constexpr int kBlockM = 64;  // query rows per block (16 per warp)
constexpr int kBlockN = 64;  // keys per shared-memory tile

template <int D>
constexpr int smem_bytes() {
  return (2 * kBlockM + 2 * kBlockN) * (D + 8) * 2;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int hq, int hkv, int n,
                        int s, float sm_scale, int causal, int q_offset,
                        int window, int sinks) {
  constexpr int kStride = D + 8;  // padded row, in bf16
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* do_s = q_s + kBlockM * kStride;
  __nv_bfloat16* k_s = do_s + kBlockM * kStride;
  __nv_bfloat16* v_s = k_s + kBlockN * kStride;

  const int m_block = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wrow = warp * 16;  // the warp's first row in the tile
  const float scale_log2 = sm_scale * kLog2e;

  const size_t bh = (size_t)b * hq + h;
  const __nv_bfloat16* k_bh = k + ((size_t)b * hkv + kvh) * s * D;
  const __nv_bfloat16* v_bh = v + ((size_t)b * hkv + kvh) * s * D;
  const int q0 = m_block * kBlockM;
  load_tile<D>(q_s, kStride, q + bh * n * D, q0, kBlockM, n);
  load_tile<D>(do_s, kStride, dout + bh * n * D, q0, kBlockM, n);

  const int row0 = q0 + wrow + g;  // this thread's two query rows
  const int row1 = row0 + 8;
  const float lse0 = row0 < n ? lse[bh * n + row0] * kLog2e : 0.f;
  const float lse1 = row1 < n ? lse[bh * n + row1] * kLog2e : 0.f;
  const float delta0 = row0 < n ? delta[bh * n + row0] : 0.f;
  const float delta1 = row1 < n ? delta[bh * n + row1] : 0.f;

  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  }

  int n_tiles = (s + kBlockN - 1) / kBlockN;
  if (causal) {
    const int last_key = q0 + kBlockM - 1 + q_offset;
    n_tiles = last_key < 0 ? 0 : min(n_tiles, last_key / kBlockN + 1);
  }
  // sliding window (causal only): the sink tiles below the band, then the
  // band's tiles from the one holding the first row's first band key
  const int wnd = window > 0 ? window : (1 << 30);
  int band_tile = 0, n_sink_tiles = 0;
  if (window > 0) {
    band_tile = min(max(q0 + q_offset - (window - 1), 0) / kBlockN, n_tiles);
    n_sink_tiles = min((sinks + kBlockN - 1) / kBlockN, band_tile);
  }
  const int n_visit = n_sink_tiles + n_tiles - band_tile;

  for (int it = 0; it < n_visit; ++it) {
    const int j = it < n_sink_tiles ? it : band_tile + it - n_sink_tiles;
    const int key0 = j * kBlockN;
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(k_s, kStride, k_bh, key0, kBlockN, s);
    load_tile<D>(v_s, kStride, v_bh, key0, kBlockN, s);
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp
    float sc[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      load_a(a, q_s, kStride, wrow, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < kBlockN / 16; ++np) {
        uint32_t bk[4];
        load_b_nk(bk, k_s, kStride, np * 16, kk * 16, lane);
        mma_16816(sc[2 * np], a, bk[0], bk[1]);
        mma_16816(sc[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // P, masked: element e of n-tile nt is (row0 if e < 2 else row1,
    // key key0 + nt*8 + 2t + (e & 1))
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = key0 + nt * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row0 : row1;
        const int pos = row + q_offset;
        const bool ok = row < n && col < s &&
                        (!causal || (col <= pos && (col > pos - wnd || col < sinks)));
        sc[nt][e] = ok ? exp2f(sc[nt][e] * scale_log2 - (e < 2 ? lse0 : lse1)) : 0.f;
      }
    }

    // dP = dO V^T
    float dp[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      load_a(a, do_s, kStride, wrow, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < kBlockN / 16; ++np) {
        uint32_t bv[4];
        load_b_nk(bv, v_s, kStride, np * 16, kk * 16, lane);
        mma_16816(dp[2 * np], a, bv[0], bv[1]);
        mma_16816(dp[2 * np + 1], a, bv[2], bv[3]);
      }
    }

    // dS = P * (dP - delta), in place
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      dp[nt][0] = sc[nt][0] * (dp[nt][0] - delta0);
      dp[nt][1] = sc[nt][1] * (dp[nt][1] - delta0);
      dp[nt][2] = sc[nt][2] * (dp[nt][2] - delta1);
      dp[nt][3] = sc[nt][3] * (dp[nt][3] - delta1);
    }

    // dQ += dS K: A from the dS registers, B = K stored [key][dim]
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                             pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                             pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                             pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t bk[4];
        load_b_kn(bk, k_s, kStride, kk * 16, np * 16, lane);
        mma_16816(acc[2 * np], a, bk[0], bk[1]);
        mma_16816(acc[2 * np + 1], a, bk[2], bk[3]);
      }
    }
  }

  // one sm_scale on dQ
  __nv_bfloat16* dq_bh = dq + bh * n * D;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (row0 < n) {
      *reinterpret_cast<__nv_bfloat162*>(dq_bh + (size_t)row0 * D + c) =
          __floats2bfloat162_rn(acc[nd][0] * sm_scale, acc[nd][1] * sm_scale);
    }
    if (row1 < n) {
      *reinterpret_cast<__nv_bfloat162*>(dq_bh + (size_t)row1 * D + c) =
          __floats2bfloat162_rn(acc[nd][2] * sm_scale, acc[nd][3] * sm_scale);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int b, int hq,
           int hkv, int n, int s, float sm_scale, int causal, int q_offset,
           int window, int sinks, cudaStream_t st) {
  constexpr int kSmem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kBlockM - 1) / kBlockM, hq, b);
  flash_bwd_dq_kernel<D><<<grid, kThreads, kSmem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), hq, hkv, n, s, sm_scale, causal, q_offset,
      window, sinks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, dout [b, hq, n, d], k/v [b, hkv, s, d] bf16 contiguous; lse (natural
// log) and delta [b, hq, n] f32; dq [b, hq, n, d] bf16, every row written.
// d in {64, 128}. window and sinks as fkp_flash_bwd_dkdv. Returns
// cudaGetLastError() after the launch.
extern "C" int fkp_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int b, int hq,
                                int hkv, int n, int s, int d, float sm_scale,
                                int causal, int q_offset, int window,
                                int sinks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64) {
    return launch<64>(q, k, v, dout, lse, delta, dq, b, hq, hkv, n, s,
                      sm_scale, causal, q_offset, window, sinks, st);
  }
  if (d == 128) {
    return launch<128>(q, k, v, dout, lse, delta, dq, b, hq, hkv, n, s,
                       sm_scale, causal, q_offset, window, sinks, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
