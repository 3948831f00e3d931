// Tile helpers shared by the two backward kernels (flash_bwd_dkdv.cu,
// flash_bwd_dq.cu): the tile loader here, and from mma.cuh mma.sync
// m16n8k16 bf16 -> f32, the ldmatrix fragment loads from padded
// shared-memory tiles and bf16 packing. With mma.cuh's fragment layouts,
// the accumulators of two neighbouring n-tiles are, packed to bf16, the
// A fragment of one 16-wide k-tile: the register repack every product
// chain of the backward uses.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace fkp_bwd {

using fkp_mma::load_a;
using fkp_mma::load_b_kn;
using fkp_mma::load_b_nk;
using fkp_mma::mma_16816;
using fkp_mma::pack_bf16;

constexpr float kNegInf = -1e30f;  // finite, as NEG_INF in ops/softmax.py
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// Copy rows [row0, row0 + rows) of a [len, D] bf16 matrix into a padded
// shared tile, zero past `len`; 16-byte vectors, all threads of the block.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int stride,
                                          const __nv_bfloat16* src, int row0,
                                          int rows, int len) {
  constexpr int kVecPerRow = D / 8;
  for (int i = threadIdx.x; i < rows * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < len) {
      x = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    }
    *reinterpret_cast<uint4*>(dst + r * stride + c) = x;
  }
}

}  // namespace fkp_bwd
