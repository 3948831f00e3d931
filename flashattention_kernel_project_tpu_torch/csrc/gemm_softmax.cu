// The batched GEMM with a fused scale + bias + row-softmax epilogue for
// Hopper (sm_90a): C[b] = softmax_rows(scale * A[b] @ B[b] + bias[col]).
//
// The entries below take one of two designs by the call's path
// (ops/gemm.py::softmax_epilogue_path): K and N multiples of 8 with
// 16-byte-aligned bases and K > 0 go to the wgmma kernel of
// gemm_softmax_sm90.cuh (built in gemm_softmax_sm90.cu: one sweep, the
// softmax in its epilogue, both forms); every other call to the mma.sync
// kernels of this file, described from here on, which read A and B
// element by element (any shape).
//
// Replaces flashattention_kernel_project_tpu/ops/gemm.py::
// _batched_softmax_epilogue_kernel (batched_matmul_softmax_epilogue,
// through _batched_softmax_epilogue_rows; BASELINE.json config 3). The TPU
// kernel keeps the whole N-wide f32 row of a 512-row block in VMEM (a 14 MB
// budget) and runs the softmax on it before the single store. A Hopper block
// has 227 KB of shared memory and 256 KB of registers per SM: at N = 2048 a
// 16-row f32 band is already 128 KB, and a block of 16 rows would re-read
// all of B for every 16 rows of C. So the block here owns 128 rows and sweeps
// N twice in 128-column tiles of the GEMM core (gemm_core.cuh):
// - sweep 1 computes each tile's scores z = (scale * acc + bias) * log2(e)
//   and folds them into a running (m, l) per row and thread, in the log2
//   domain; the threads that share a row then merge their (m, l) by
//   shuffles and through shared memory;
// - sweep 2 computes each tile again and writes exp2(z - m) / l.
// It is one launch, any N works, and no score ever goes to device memory;
// the price is twice the GEMM's operations. Columns past N are masked out
// of the max and the sum (the TPU kernel's padded-column mask); a row whose
// sum is 0 gives 0.
//
// Precision: exp2 and the normalisation run in f32 and round once, to the
// output type. The TPU kernel takes exp2 at the output type (bf16) after the
// max subtraction and multiplies by a bf16 reciprocal; the port keeps f32
// there, as its attention kernels do (ROADMAP.md, section C).
//
// What bounds it on the H100: at config 3 (32 x 2048^3, bf16) the function
// is 2*B*M*N*K = 550 GFLOP against 0.8 GB of inputs and outputs, so
// the tensor-core rate bounds it (0.556 ms at 989 TFLOP/s); this kernel
// runs twice those products on mma.sync. The one-sweep form is
// gemm_softmax_resident_kernel below. bf16 inputs only.
//
// The resident form: gemm_softmax_resident_kernel replaces
// flashattention_kernel_project_tpu/ops/gemm.py::
// _batched_softmax_epilogue_resident_kernel (resident=True). The TPU kernel
// keeps A's row panel resident over one sweep of N, takes exp2 of the
// log2-domain scores with no max subtracted (fixed-max), writes the
// unnormalised e into a whole-row VMEM buffer, sums l, scales the buffer in
// place by 1/l and stores it once; an l-range witness counts the real rows
// whose l is non-finite, above 2^120 or below 2^-100, and the call then
// returns the rows kernel's output instead. A 128-row bf16 panel at N = 2048
// is 512 KB, past the 227 KB of shared memory, so here the output itself is
// the row buffer: a block owns 128 rows, sweeps N once, stores each tile's
// e (rounded to the output type) to C and sums l from the f32 e; then it
// merges l per row, adds its witness count to a device int, and rescales its
// own rows of C in place (they were just written, mostly still in L2): e
// times (1/l) rounded to the output type, the TPU kernel's arithmetic. The
// fallback needs no host sync: the wrapper launches this kernel (the
// default one above) after it with `gate` pointing at the count, and
// that launch returns at once while the count is 0, else overwrites C with
// the two-sweep result. Half the products of the two-sweep kernel, plus
// one read and one write of C.

#include "gemm_core.cuh"
#include "gemm_softmax_sm90.cuh"

namespace {

using namespace fkp_gemm_core;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;  // finite, as NEG_INF in ops/softmax.py

// (m, l) <- the merge of two partial row states, log2 domain
__device__ __forceinline__ void merge(float& m, float& l, float m2, float l2) {
  const float mm = fmaxf(m, m2);
  l = l * exp2f(m - mm) + l2 * exp2f(m2 - mm);
  m = mm;
}

// two blocks an SM: at most 128 registers a thread
// gate: null, or a device count; while it is 0 every block returns at once
__global__ void __launch_bounds__(kThreads, 2)
    gemm_softmax_kernel(const __nv_bfloat16* a, const __nv_bfloat16* b,
                        const float* bias, Out o, int k, float scale_log2,
                        const int* gate) {
  if (gate != nullptr && *gate == 0) return;
  __shared__ SmemBf16 s;
  __shared__ float part_m[4][kBM], part_l[4][kBM];  // by warp column, row
  const int m = o.m, n = o.n;
  const int row0 = blockIdx.x * kBM;
  a += (size_t)blockIdx.y * m * k;
  b += (size_t)blockIdx.y * k * n;
  const size_t base = (size_t)blockIdx.y * m * n;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wn = warp % 4;
  const int lrow = (warp / 4) * 64 + lane / 4;  // + i * 16 + h * 8
  const int ccol = wn * 32 + (lane % 4) * 2;    // + j * 8 + e
  float acc[4][4][4];

  // z of acc[i][j][h * 2 + e] in place; masked columns get kNegInf
  auto scores = [&](int col0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + ccol + j * 8 + e;
        const bool live = col < n;
        const float bl = live ? bias[col] * kLog2e : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float& z = acc[i][j][h * 2 + e];
            z = live ? fmaf(z, scale_log2, bl) : kNegInf;
          }
        }
      }
    }
  };

  // sweep 1: each thread's running (m, l) over its columns, rows i * 2 + h
  float rm[8], rl[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) rm[r] = kNegInf, rl[r] = 0.f;
  for (int col0 = 0; col0 < n; col0 += kBN) {
    tile_bf16<false>(acc, s, a, b, row0, col0, m, n, k);
    scores(col0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mx = fmaxf(mx, fmaxf(acc[i][j][h * 2], acc[i][j][h * 2 + 1]));
        }
        const float m_new = fmaxf(rm[i * 2 + h], mx);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float z = acc[i][j][h * 2 + e];
            // a masked column adds nothing, even while m_new is kNegInf
            sum += z == kNegInf ? 0.f : exp2f(z - m_new);
          }
        }
        rl[i * 2 + h] = rl[i * 2 + h] * exp2f(rm[i * 2 + h] - m_new) + sum;
        rm[i * 2 + h] = m_new;
      }
    }
  }
  // the 4 lanes of a row group, then the 4 warps along n
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      merge(rm[r], rl[r], __shfl_xor_sync(0xffffffffu, rm[r], off),
            __shfl_xor_sync(0xffffffffu, rl[r], off));
    }
  }
  if (lane % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      part_m[wn][lrow + (r / 2) * 16 + (r % 2) * 8] = rm[r];
      part_l[wn][lrow + (r / 2) * 16 + (r % 2) * 8] = rl[r];
    }
  }
  __syncthreads();
  float inv[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = lrow + (r / 2) * 16 + (r % 2) * 8;
    float mr = part_m[0][row], lr = part_l[0][row];
#pragma unroll
    for (int w = 1; w < 4; ++w) merge(mr, lr, part_m[w][row], part_l[w][row]);
    rm[r] = mr;
    inv[r] = 1.f / (lr == 0.f ? 1.f : lr);
  }

  // sweep 2: the same tiles again, normalised
  for (int col0 = 0; col0 < n; col0 += kBN) {
    tile_bf16<false>(acc, s, a, b, row0, col0, m, n, k);
    scores(col0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = i * 2 + h;
          store2<kPlain>(o, base, row0 + lrow + i * 16 + h * 8, col0 + ccol + j * 8,
                        exp2f(acc[i][j][h * 2] - rm[r]) * inv[r],
                        exp2f(acc[i][j][h * 2 + 1] - rm[r]) * inv[r]);
        }
      }
    }
  }
}

// C[i] = C[i] * inv, rounded to T, for the n elements of one row of C
// (offset `idx` elements), the threads `tid` of `threads` in turn.
template <class T>
__device__ __forceinline__ void rescale_row(T* c, size_t idx, int n, float inv,
                                            int tid, int threads) {
  for (int j = tid; j < n; j += threads) {
    c[idx + j] = T(static_cast<float>(c[idx + j]) * inv);
  }
}

// witness: a device count, plus the block's real rows whose l left
// [2^-100, 2^120] or is not finite
__global__ void __launch_bounds__(kThreads, 2)
    gemm_softmax_resident_kernel(const __nv_bfloat16* a, const __nv_bfloat16* b,
                                 const float* bias, Out o, int k,
                                 float scale_log2, int* witness) {
  __shared__ SmemBf16 s;
  __shared__ float part_l[4][kBM];  // l by warp column, row
  __shared__ float inv_l[kBM];
  __shared__ int bad;
  const int m = o.m, n = o.n;
  const int row0 = blockIdx.x * kBM;
  a += (size_t)blockIdx.y * m * k;
  b += (size_t)blockIdx.y * k * n;
  const size_t base = (size_t)blockIdx.y * m * n;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wn = warp % 4;
  const int lrow = (warp / 4) * 64 + lane / 4;  // + i * 16 + h * 8
  const int ccol = wn * 32 + (lane % 4) * 2;    // + j * 8 + e
  if (threadIdx.x == 0) bad = 0;
  for (int i = threadIdx.x; i < 4 * kBM; i += kThreads) part_l[i / kBM][i % kBM] = 0.f;
  float acc[4][4][4];

  // the one sweep: e = exp2(z) with no max subtracted, stored rounded to
  // the output type; l sums the f32 e over the live columns, a tile's sum
  // added to part_l (in shared memory, so that no register holds l across
  // the products: with it the 16-byte instance, since removed, spilled)
  for (int col0 = 0; col0 < n; col0 += kBN) {
    tile_bf16<false>(acc, s, a, b, row0, col0, m, n, k);
    float rl[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // rows i * 2 + h
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + ccol + j * 8;
      const bool live0 = col < n, live1 = col + 1 < n;
      const float bl0 = live0 ? bias[col] * kLog2e : 0.f;
      const float bl1 = live1 ? bias[col + 1] * kLog2e : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float e0 = live0 ? exp2f(fmaf(acc[i][j][h * 2], scale_log2, bl0)) : 0.f;
          const float e1 = live1 ? exp2f(fmaf(acc[i][j][h * 2 + 1], scale_log2, bl1)) : 0.f;
          rl[i * 2 + h] += e0 + e1;
          store2<kPlain>(o, base, row0 + lrow + i * 16 + h * 8, col, e0, e1);
        }
      }
    }
    // the 4 lanes of a row group; one lane adds for them (no other thread
    // writes that row's entry of this warp column)
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      rl[r] += __shfl_xor_sync(0xffffffffu, rl[r], 1);
      rl[r] += __shfl_xor_sync(0xffffffffu, rl[r], 2);
      if (lane % 4 == 0) part_l[wn][lrow + (r / 2) * 16 + (r % 2) * 8] += rl[r];
    }
  }
  __syncthreads();  // part_l complete, and every e of the block's rows is in C
  if (threadIdx.x < kBM) {
    const int row = threadIdx.x;
    const float l = part_l[0][row] + part_l[1][row] + part_l[2][row] + part_l[3][row];
    const bool breach = !isfinite(l) || l > 0x1p120f || l < 0x1p-100f;
    if (breach && row0 + row < m) atomicAdd(&bad, 1);
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    // (1 / l) rounded to the output type, as the TPU kernel multiplies
    inv_l[row] = o.bf16 ? __bfloat162float(__float2bfloat16(inv)) : inv;
  }
  __syncthreads();
  if (threadIdx.x == 0 && bad > 0) atomicAdd(witness, bad);
  // rescale the block's rows in place: a warp a row at a time
  const int rows = min(kBM, m - row0);
  for (int r = warp; r < rows; r += kThreads / 32) {
    const size_t idx = base + (size_t)(row0 + r) * n;
    if (o.bf16) {
      rescale_row(static_cast<__nv_bfloat16*>(o.c), idx, n, inv_l[r], lane, 32);
    } else {
      rescale_row(static_cast<float*>(o.c), idx, n, inv_l[r], lane, 32);
    }
  }
}

}  // namespace

// a [batch, m, k], b [batch, k, n] bf16 contiguous, bias f32 [n]; c [batch,
// m, n] bf16 (bf16_out) or f32. scale_log2 = scale * log2(e). path
// (ops/gemm.py::softmax_epilogue_path): 2 the wgmma kernel
// (gemm_softmax_sm90.cuh: k and n multiples of 8, a and b 16-byte
// aligned, k > 0; cudaErrorInvalidValue for k <= 0), which takes
// tile_max, a device f32 workspace of batch * m * ceil(n / 128); else the
// mma.sync kernel below, reading element by element (any shape; tile_max
// null). gate: null, or a device int32 count (the resident kernel's
// witness) that the launch returns at once on while it is 0.
// Returns cudaGetLastError() after the launch, or the wgmma launch's error
// code.
extern "C" int fkp_gemm_softmax(const void* a, const void* b, const void* bias,
                                void* c, const void* gate, void* tile_max,
                                int batch, int m, int n, int k,
                                float scale_log2, int bf16_out, int path,
                                void* stream) {
  const Out o{c, nullptr, nullptr, m, n, bf16_out};
  const auto tbias = static_cast<const float*>(bias);
  const auto tgate = static_cast<const int*>(gate);
  const auto s = static_cast<cudaStream_t>(stream);
  if (path == 2) {
    if (k <= 0) return static_cast<int>(cudaErrorInvalidValue);
    return fkp_gemm_softmax_sm90::launch_softmax(
        a, b, tbias, o, static_cast<float*>(tile_max), nullptr, tgate, batch, k,
        scale_log2, false, s);
  }
  const dim3 grid((m + kBM - 1) / kBM, batch);
  gemm_softmax_kernel<<<grid, kThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(a),
                                                static_cast<const __nv_bfloat16*>(b),
                                                tbias, o, k, scale_log2, tgate);
  return static_cast<int>(cudaGetLastError());
}

// The resident form (one sweep, fixed-max): arguments as fkp_gemm_softmax
// without tile_max, with c's every element written, and `witness` a device
// int32 to which the launch adds its count of breaching rows (the caller
// zeroes it). Returns cudaGetLastError() after the launch, or the wgmma
// launch's error code.
extern "C" int fkp_gemm_softmax_resident(const void* a, const void* b,
                                         const void* bias, void* c, void* witness,
                                         int batch, int m, int n, int k,
                                         float scale_log2, int bf16_out,
                                         int path, void* stream) {
  const Out o{c, nullptr, nullptr, m, n, bf16_out};
  const auto tbias = static_cast<const float*>(bias);
  const auto tw = static_cast<int*>(witness);
  const auto s = static_cast<cudaStream_t>(stream);
  if (path == 2) {
    if (k <= 0) return static_cast<int>(cudaErrorInvalidValue);
    return fkp_gemm_softmax_sm90::launch_softmax(a, b, tbias, o, nullptr, tw,
                                                 nullptr, batch, k, scale_log2,
                                                 true, s);
  }
  const dim3 grid((m + kBM - 1) / kBM, batch);
  gemm_softmax_resident_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b), tbias,
      o, k, scale_log2, tw);
  return static_cast<int>(cudaGetLastError());
}
