// The stage probes copy, qk, pv, softmax chain, qk_kt and qk_packed for
// Hopper (sm_90a): the dense forward's block (flash_fwd_sm90.cuh's
// fwd_block) with all but one stage taken out, its stage switch kStage, so
// that the forward's time splits into the K/V stream, the QK products, the
// softmax and the PV products by subtraction, and the QK stage runs over
// the operands the TPU's variants ask about.
//
// Replaces flashattention_kernel_project_tpu/ops/probes.py::_make_probe
// (:50, pallas_call :64) with _copy_kernel_factory (:83, copy_probe),
// _qk_kernel_factory (:106, qk_probe) and _pv_kernel_factory (:262,
// pv_probe), softmax_chain_probe (:328, pallas_call :338, with
// _softmax_chain_kernel_factory :287), qk_kt_probe (:129, pallas_call :162)
// and qk_packed_probe (:184, pallas_call :236), with JAX's outputs
// (ops/probes.py's plain versions): f32 [b, hq, n, d], each row the sum
// over key tiles of k[j * block_k] + v[j * block_k] (copy), its score sum
// sum_k q . k broadcast over d (qk, qk_kt, qk_packed), q[row, 0] *
// sum_k v[k] (pv), or the online chain's acc / (l + 1e-6) on the scores
// q[row, 0] * 0.001 at every key (chain).
//
// Each probe keeps the forward's grid and block rows (block_rows: 128-row
// ping-pong blocks, 64-row blocks where one wave holds the grid), its TMA
// producer, K/V ring and setmaxnreg split, and issues its products as the
// forward does:
// - copy: the ring, each stage waited on and released; each consumer
//   thread adds the rows j * block_k that lie in the tile at its columns.
//   No products.
// - qk: the SS wgmma of S = Q K^T a tile (V streamed, as JAX's grid streams
//   it), the two warpgroups in turns; each row's scores summed in f32. No
//   softmax.
// - pv: the RS wgmma of O += P V a tile on p's bf16 hi + lo pair (two
//   products a 16-key slice), p = q[row, 0] at every key in the A
//   fragments the softmax would fill (hi = q[row, 0], lo = 0); K streamed.
// - chain: the forward's softmax (its `softmax` lambda: the online max,
//   rescale, exp2 of every score and l, unmasked but for the tile past s)
//   on scores the consumers write into the registers the QK product would
//   fill, q[row, 0] * 0.001 (Q's shared tile) plus zero * key with zero a
//   value read at run time (0 for every block_k the entry takes), so the
//   compiler keeps one exp2 a score; in place of the PV product, acc =
//   acc * r + the row's sum of p over the D columns. The scores stand in
//   the log2 domain (scale 1, as JAX's chain takes no scale): the add that
//   writes each one costs what the forward's scale multiply costs, which
//   folds away. A row's scores are equal, so p = 1 and the output is JAX's
//   with exp2 for exp. K and V streamed, each stage waited on and
//   released; no products. It splits the forward's softmax from its
//   products and loads.
// - qk_kt: qk's products with K transposed to [b, hkv, d, s] by the wrapper
//   (as JAX transposes it in XLA): each tile two TMA boxes of 64 keys x d
//   dim rows, read by the SS wgmma as its MN-major B operand (imm-trans-b
//   1), as the PV product reads V; no V stream (JAX's kernel takes none).
//   It answers qk_kt_probe's question, whether the NN form costs anything.
// - qk_packed: qk at D = 2d over the operands the wrapper packs as JAX
//   packs them in XLA (two heads' q rows side by side, [G * N, 2d], against
//   block-diagonal [2 * block_k, 2d] K tiles: pairs = hkv / 2 heads of G * N
//   rows and 2S keys), the zero quadrants multiplied as the TPU multiplies
//   them; no V stream.
// A change to the forward's loads or products moves its probes with it.
// block_q sets no hardware tile here; block_k only says which key rows the
// copy adds (the TPU kernel's tile rows).
//
// What bounds each on the H100: qk, qk_kt and pv do 2*N*S*d flops a head
// (pv twice over, the pair; qk_packed twice the unpacked products, the zero
// quadrants) against ~2*(N + 2*S)*d bytes, far above the ~295 flop/byte
// ridge: the tensor cores' issue rate (989 TFLOP/s) bounds them.
// The copy moves K and V once per query block, N / rows times the K/V
// bytes, mostly from L2; its device-memory bound is the inputs and the
// output once. The chain is bound by the exp2 unit (16 results a clock an
// SM): one exp2 a score and one a tile's row rescale.

#include "flash_fwd_sm90.cuh"

namespace fkp_sm90 {

// Probe stage kStage (kProbeCopy, kProbeQK, kProbePV, kProbeChain,
// kProbeQKT or kProbePacked) at head dim D in blocks of kRows query rows
// (the chain's scale 1: its scores stand in the log2 domain): maps as
// flash_fwd_sm90_kernel's (kProbeQKT: k over K^T, launch_probe's; kProbeQKT
// and kProbePacked read no v map); o [b, hq, n, D] f32.
template <int D, int kStage, int kRows>
__global__ void __launch_bounds__(Block<kRows>::kThreads, 1)
    probe_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      float* __restrict__ o, int hq, int hkv, int n, int s,
                      int block_k) {
  fwd_block<D, false, fkp_fwd::kOnline, kRows, __nv_bfloat16, false, kStage>(
      &q_map, &k_map, &v_map, reinterpret_cast<__nv_bfloat16*>(o), nullptr,
      hq, hkv, n, s, 1.f, 0, 0, 0, 0, nullptr, GuardArgs{}, RaggedPtrs{},
      block_k);
}

// Launches instance <D, kStage, kRows>; returns a CUDA error code as
// flash_fwd_sm90.cuh's `launch`.
template <int D, int kStage, int kRows>
int launch_probe(const FwdArgs& a, int block_k) {
  const auto kernel = &probe_sm90_kernel<D, kStage, kRows>;
  constexpr int kBytes = Layout<D, kRows>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // K^T [b*hkv, D, s]: boxes of 64 keys (128 bytes, swizzled) x D dim
  // rows, keys past s zero-filled; no V map where the stage reads no V
  CUtensorMap qm, km, vm{};
  const bool k_ok = kStage == kProbeQKT
                        ? encode_map(&km, a.k, a.s, D, a.b * a.hkv, D)
                        : encode_map(&km, a.k, D, a.s, a.b * a.hkv, kN);
  if (!encode_map(&qm, a.q, D, a.n, a.b * a.hq, kRows) || !k_ok ||
      (stage_reads_v(kStage) &&
       !encode_map(&vm, a.v, D, a.s, a.b * a.hkv, kN))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((a.n + kRows - 1) / kRows, a.hq, a.b);
  kernel<<<grid, Block<kRows>::kThreads, kBytes, a.stream>>>(
      qm, km, vm, static_cast<float*>(a.o), a.hq, a.hkv, a.n, a.s, block_k);
  return static_cast<int>(cudaGetLastError());
}

// The instances of one stage, by d (64 or 128) and block rows; -1 for
// another d.
template <int kStage>
int launch_stage(int d, const FwdArgs& a, int block_k) {
  const bool wide = block_rows(a) == 128;
  if (d == 64) {
    return wide ? launch_probe<64, kStage, 128>(a, block_k)
                : launch_probe<64, kStage, 64>(a, block_k);
  }
  if (d == 128) {
    return wide ? launch_probe<128, kStage, 128>(a, block_k)
                : launch_probe<128, kStage, 64>(a, block_k);
  }
  return -1;
}

}  // namespace fkp_sm90

// One probe stage on the Hopper forward's block (0 copy, 1 qk, 2 pv, 3 the
// softmax chain, 4 qk with K^T, 5 qk over the packed operands): q [b, hq,
// n, d], k and v [b, hkv, s, d] bf16, contiguous and 16-byte aligned
// (stage 4: k is K^T [b, hkv, d, s], s a multiple of 8; stages 4 and 5 read
// no v, which may be null); o [b, hq, n, d] f32. d in {64, 128}, n and s >=
// 1, hq a multiple of hkv, block_k >= 1 (the copy's key rows j * block_k).
// Returns cudaGetLastError() after the launch (or the error of the
// instance's shared-memory attribute), or cudaErrorInvalidValue without one
// for arguments outside these or inputs a TMA map cannot describe.
extern "C" int fkp_probe_sm90(const void* q, const void* k, const void* v,
                              void* o, int b, int hq, int hkv, int n, int s,
                              int d, int stage, int block_k, void* stream) {
  if (n < 1 || s < 1 || hkv < 1 || hq % hkv || block_k < 1 ||
      (d != 64 && d != 128) ||
      (fkp_sm90::stage_reads_v(stage) && v == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fkp_sm90::FwdArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.b = b;
  a.hq = hq;
  a.hkv = hkv;
  a.n = n;
  a.s = s;
  a.stream = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case fkp_sm90::kProbeCopy:
      return fkp_sm90::launch_stage<fkp_sm90::kProbeCopy>(d, a, block_k);
    case fkp_sm90::kProbeQK:
      return fkp_sm90::launch_stage<fkp_sm90::kProbeQK>(d, a, block_k);
    case fkp_sm90::kProbePV:
      return fkp_sm90::launch_stage<fkp_sm90::kProbePV>(d, a, block_k);
    case fkp_sm90::kProbeChain:
      return fkp_sm90::launch_stage<fkp_sm90::kProbeChain>(d, a, block_k);
    case fkp_sm90::kProbeQKT:
      return fkp_sm90::launch_stage<fkp_sm90::kProbeQKT>(d, a, block_k);
    case fkp_sm90::kProbePacked:
      return fkp_sm90::launch_stage<fkp_sm90::kProbePacked>(d, a, block_k);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
