"""The GEMM ladder: tiled, batched, fused-epilogue and softmax-epilogue
products with f32 accumulation.

Counterpart of flashattention_kernel_project_tpu/ops/gemm.py. On a CUDA
tensor the products are the hand-written Hopper kernels: csrc/gemm.cu's
entry for `matmul`, `matmul_bf16`, `batched_matmul` and
`matmul_fused_epilogue`, which takes one of three kernels by `gemm_path`:
for aligned shapes with K > 0, with or without the fused epilogue, the
wgmma kernel of csrc/gemm_sm90.cuh (two bf16 operands) or of
csrc/gemm_f32_sm90.cuh (two f32 operands: JAX's Precision.HIGHEST, each
operand split exactly into three bf16 pieces and six bf16 products summed
in f32, `_matmul_f32_split_plain`), the epilogue in their 16-byte stores;
else the mma.sync core (bf16 on the tensor cores, float32 in full float32
FFMA, never TF32).
`batched_matmul_softmax_epilogue` takes csrc/gemm_softmax.cu's entries,
which pick by `softmax_epilogue_path`: for aligned shapes the one-sweep
wgmma kernel of csrc/gemm_softmax_sm90.cuh (the softmax in its epilogue,
the rows form and the resident fixed-max one), else the mma.sync kernels
(the two-sweep rows kernel and the one-sweep fixed-max kernel); the
resident form falls back to the rows form on the device. On a CPU tensor
each takes its plain version in PyTorch, the same function in float32.
`matmul_xla` is the ladder's library rung, torch.matmul, as the JAX
package's is XLA's own dot. The TPU kernels' block sizes (block_m, block_n,
block_k) size VMEM blocks and do not change the function: the CUDA kernels
pick their own tiles, and ragged shapes need no padding.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from flashattention_kernel_project_tpu_torch.ops import _build
from flashattention_kernel_project_tpu_torch.ops.softmax import _LOG2E

_TYPES = (torch.float32, torch.bfloat16)


def _check_types(a, b, out_dtype):
    if a.dtype not in _TYPES or b.dtype != a.dtype:
        raise TypeError(f"the CUDA GEMMs take two f32 or two bf16 operands, "
                        f"got {a.dtype} and {b.dtype}")
    if out_dtype not in _TYPES:
        raise TypeError(f"out_dtype must be f32 or bf16, got {out_dtype}")
    if b.device != a.device:
        raise ValueError(f"b is on {b.device}, a on {a.device}")


def _aligned(*tensors) -> bool:
    """Whether the kernels may copy 16-byte pieces: each row of every
    operand a multiple of 16 bytes long, every base 16-byte aligned."""
    return all(t.shape[-1] * t.element_size() % 16 == 0 and t.data_ptr() % 16 == 0
               for t in tensors)


# fkp_gemm's paths (csrc/gemm.cu): the mma.sync core reading element by
# element or in 16-byte pieces, the bf16 wgmma kernel (csrc/gemm_sm90.cuh)
# or the f32 one (csrc/gemm_f32_sm90.cuh)
PATH_ELEMENTWISE, PATH_ALIGNED, PATH_SM90, PATH_SM90_F32 = 0, 1, 2, 3


def gemm_path(a_dtype, b_dtype, a_shape, b_shape, aligned: bool,
              epilogue: bool) -> int:
    """The kernel a CUDA call of the GEMMs takes, by type and shape alone
    (fkp_gemm's `path`, a [.., M, K] @ b [.., K, N]): with K > 0 and
    `aligned` operands (`_aligned`: K and N multiples of 16 bytes' worth of
    elements, 16-byte bases, which is what a TMA map asks of a tensor), the
    bf16 wgmma kernel (PATH_SM90) for two bf16 operands and the f32 one
    (PATH_SM90_F32) for two f32 operands, with or without the fused
    epilogue (`epilogue` picks no route: both kernels take it as a switch
    of their stores); else the mma.sync core, in 16-byte pieces where
    aligned (PATH_ALIGNED: K = 0), element by element where not."""
    del epilogue
    if not aligned:
        return PATH_ELEMENTWISE
    if a_shape[-1] == 0:
        return PATH_ALIGNED
    if a_dtype == b_dtype == torch.bfloat16:
        return PATH_SM90
    if a_dtype == b_dtype == torch.float32:
        return PATH_SM90_F32
    return PATH_ALIGNED


def softmax_epilogue_path(a_dtype, b_dtype, a_shape, b_shape,
                          aligned: bool) -> int:
    """The kernel a CUDA call of `batched_matmul_softmax_epilogue` takes,
    by type and shape alone (the entries' `path`, a [B, M, K] @ b [B, K,
    N]): `gemm_path`'s PATH_SM90 (two bf16 operands, K > 0, `aligned`) is
    the wgmma kernel of csrc/gemm_softmax_sm90.cuh; every other call
    (PATH_ELEMENTWISE) the mma.sync kernels of csrc/gemm_softmax.cu, which
    read element by element. A documented route, not a fallback: the
    wrapper raises on f32 operands before it."""
    path = gemm_path(a_dtype, b_dtype, a_shape, b_shape, aligned, epilogue=False)
    return PATH_SM90 if path == PATH_SM90 else PATH_ELEMENTWISE


@functools.cache
def _gemm_kernel():
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    return _build.kernel("fkp_gemm", [vp] * 5 + [i32] * 8 + [vp])


def _gemm_cuda(wrapper, a, b, out_dtype, bias=None, residual=None):
    """C = a @ b (a [B, M, K], b [B, K, N]), through the epilogue when bias
    and residual are given, launched on the current stream on the kernel
    `gemm_path` picks, counted in `wrapper.launches` and, on a wgmma
    kernel, also in `wrapper.sm90_launches` (bf16) or
    `wrapper.f32x_launches` (f32)."""
    _check_types(a, b, out_dtype)
    a, b = a.contiguous(), b.contiguous()
    batch, m, k = a.shape
    n = b.shape[-1]
    c = torch.empty((batch, m, n), dtype=out_dtype, device=a.device)
    if bias is not None:
        # f32 and 16-byte aligned: the wgmma kernels read them in 16-byte
        # pieces
        bias, residual = (
            x if x.data_ptr() % 16 == 0 else x.clone()
            for x in (bias.to(a.device, torch.float32).contiguous(),
                      residual.to(a.device, torch.float32).contiguous()))
    path = gemm_path(a.dtype, b.dtype, a.shape, b.shape, _aligned(a, b),
                     bias is not None)
    rc = _gemm_kernel()(
        a.data_ptr(), b.data_ptr(), c.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if residual is None else residual.data_ptr(),
        batch, m, n, k, int(a.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16), int(bias is not None), path,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    wrapper.launches += 1
    if path == PATH_SM90:
        wrapper.sm90_launches += 1
    elif path == PATH_SM90_F32:
        wrapper.f32x_launches += 1
    _build.check(rc, "gemm")
    return c


def _matmul_plain(a, b, out_dtype):
    """The kernels' function in plain PyTorch: float32 products, f32 out
    rounded to out_dtype. bf16 operands widen exactly."""
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def _f32_pieces(x):
    """The exact split of csrc/gemm_f32_sm90.cuh in plain PyTorch: x (f32)
    as (hi, hf, mid, lo), f32 tensors of bf16 values. hi is x with its low
    16 bits cleared, mid the same of x - hi, lo of x - hi - mid, each with
    x's sign (a zero piece of a negative x is -0), so that hi + mid + lo ==
    x bit for bit wherever x's bits lie at or above 2^-133 (every |x| >=
    2^-110); a non-finite x keeps hi (a NaN as the quiet NaN) and has
    mid = lo = 0; hf is hi where x is finite, else 0."""
    x = x.float()
    sign = x.view(torch.int32) & -2 ** 31

    def cut(v):
        return ((v.view(torch.int32) & -65536) | sign).view(torch.float32)

    hi = cut(x)
    mid = cut(x - hi)
    lo = cut(x - hi - mid)
    finite = torch.isfinite(x)
    zero = torch.zeros_like(x)
    hi = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), hi)
    return (hi, torch.where(finite, hi, zero), torch.where(finite, mid, zero),
            torch.where(finite, lo, zero))


def _matmul_f32_split_plain(a, b, out_dtype):
    """The f32 wgmma kernel's function in plain PyTorch: a and b split
    exactly into bf16 pieces (`_f32_pieces`), the six products JAX's
    Precision.HIGHEST keeps (smallest first, hi.hi last; the five lower ones
    on hf, so that an inf or NaN meets the other operand only in hi.hi)
    summed in f32, rounded to out_dtype. For the tests and chip_smoke.py;
    the port's path calls `matmul`."""
    ah, ahf, am, al = _f32_pieces(a)
    bh, bhf, bm, bl = _f32_pieces(b)
    mm = torch.matmul
    c = mm(al, bhf) + mm(ahf, bl) + mm(am, bhf) + mm(ahf, bm) + mm(am, bm)
    return (c + mm(ah, bh)).to(out_dtype)


def _dims(a, b, batched: bool):
    rank = 3 if batched else 2
    if a.dim() != rank or b.dim() != rank or a.shape[-1] != b.shape[-2] or (
            batched and a.shape[0] != b.shape[0]):
        raise ValueError(f"shapes {tuple(a.shape)} @ {tuple(b.shape)} do not "
                         f"make a{' batched' if batched else ''} product")


def _empty(a, b, out_dtype):
    """An output with no element: nothing to launch."""
    return torch.zeros((*a.shape[:-1], b.shape[-1]), dtype=out_dtype,
                       device=a.device)


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           out_dtype=torch.float32) -> torch.Tensor:
    """C = A @ B with f32 accumulation: a [M, K], b [K, N], both f32 (f32
    products: six bf16 passes on the card where aligned, as JAX's
    Precision.HIGHEST, else FFMA) or both bf16; C [M, N] in out_dtype (f32
    or bf16). CPU tensors run the plain version; CUDA tensors launch
    csrc/gemm.cu or raise."""
    _dims(a, b, batched=False)
    if a.device.type == "cpu":
        return _matmul_plain(a, b, out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"no GEMM for device {a.device}")
    if a.shape[0] == 0 or b.shape[1] == 0:
        return _empty(a, b, out_dtype)
    return _gemm_cuda(matmul, a[None], b[None], out_dtype)[0]


def matmul_bf16(a: torch.Tensor, b: torch.Tensor, **kw) -> torch.Tensor:
    """The tensor-core rung: `matmul` of a and b rounded to bf16 (f32
    accumulation, f32 out by default)."""
    return matmul(a.to(torch.bfloat16), b.to(torch.bfloat16), **kw)


def matmul_xla(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The ladder's library rung: one torch.matmul with an f32 result (bf16
    operands widen exactly, so their products are exact as in XLA's dot
    with preferred_element_type f32)."""
    return torch.matmul(a.float(), b.float())


def batched_matmul(a: torch.Tensor, b: torch.Tensor, *,
                   out_dtype=torch.float32) -> torch.Tensor:
    """C[i] = A[i] @ B[i]: a [B, M, K], b [B, K, N] -> [B, M, N], the batch
    on the kernel's third grid axis. Types as `matmul`."""
    _dims(a, b, batched=True)
    if a.device.type == "cpu":
        return _matmul_plain(a, b, out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"no GEMM for device {a.device}")
    if 0 in (a.shape[0], a.shape[1], b.shape[2]):
        return _empty(a, b, out_dtype)
    return _gemm_cuda(batched_matmul, a, b, out_dtype)


def _fused_epilogue_plain(a, b, bias, residual, out_dtype):
    c = torch.matmul(a.float(), b.float()) + bias.float()
    return (torch.relu(c) + residual.float()).to(out_dtype)


def matmul_fused_epilogue(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor,
                          residual: torch.Tensor, *,
                          out_dtype=torch.float32) -> torch.Tensor:
    """C = ReLU(A @ B + bias[col]) + residual, the epilogue in f32 on the
    accumulator before the single store: a [M, K], b [K, N], bias [N],
    residual [M, N] (any float type, read as f32). Types as `matmul`;
    launches counted as `matmul`'s (`.launches`, and of those
    `.sm90_launches` and `.f32x_launches` on the wgmma kernels)."""
    _dims(a, b, batched=False)
    m, n = a.shape[0], b.shape[1]
    if tuple(bias.shape) != (n,) or tuple(residual.shape) != (m, n):
        raise ValueError(f"bias {tuple(bias.shape)} and residual "
                         f"{tuple(residual.shape)} must be ({n},) and ({m}, {n})")
    if a.device.type == "cpu":
        return _fused_epilogue_plain(a, b, bias, residual, out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"no GEMM for device {a.device}")
    if m == 0 or n == 0:
        return _empty(a, b, out_dtype)
    return _gemm_cuda(matmul_fused_epilogue, a[None], b[None], out_dtype, bias,
                      residual)[0]


def _softmax_epilogue_plain(a, b, bias, scale, out_dtype):
    """The kernel's function in plain PyTorch, in f32: scores in the log2
    domain, the row max subtracted, exp2, one reciprocal of the row sum (a
    sum of 0 counts as 1)."""
    z = torch.matmul(a.float(), b.float()) * (scale * _LOG2E) + bias.float() * _LOG2E
    e = torch.exp2(z - z.amax(dim=-1, keepdim=True))
    s = e.sum(dim=-1, keepdim=True)
    return (e * (1.0 / torch.where(s == 0.0, 1.0, s))).to(out_dtype)


def _softmax_epilogue_tiles_plain(a, b, bias, scale, out_dtype, tile_n):
    """The wgmma rows kernel's arithmetic in plain PyTorch
    (csrc/gemm_softmax_sm90.cuh), in f32, at its tile width tile_n (128 or
    256): a row's tiles of tile_n columns split between the two CTAs of a
    cluster, rank r taking tiles r, r + 2, ... in order; each rank keeps
    its own running row max m_t after its tile t, e = exp2(z - m_t)
    rounded to out_dtype and l = l * exp2(m_prev - m_t) + the tile's
    unrounded e; then the two ranks' (m, l) merge into m = max(m_0, m_1), l
    = l_0 * exp2(m_0 - m) + l_1 * exp2(m_1 - m), and each tile's rounded e
    times exp2(m_t - m) * (1 / l) (an l of 0 counts as 1), rounded to
    out_dtype. `_softmax_epilogue_plain`'s function, with e rounded once
    more before the rescale where out_dtype is bf16; the kernel differs
    from it only in the order of its sums and its exp2 (ex2.approx). For
    the tests and chip_smoke.py, as `_matmul_f32_split_plain`; the
    wrapper's CPU path stays `_softmax_epilogue_plain`."""
    z = torch.matmul(a.float(), b.float()) * (scale * _LOG2E) + bias.float() * _LOG2E
    n_tiles = -(-z.shape[-1] // tile_n)
    tiles, ranks = [None] * n_tiles, []
    for rank in (0, 1):
        m = torch.full((*z.shape[:-1], 1), -1e30, device=z.device)
        l = torch.zeros_like(m)
        for t in range(rank, n_tiles, 2):
            zt = z[..., t * tile_n:(t + 1) * tile_n]
            m_t = torch.maximum(m, zt.amax(dim=-1, keepdim=True))
            e = torch.exp2(zt - m_t)
            l = l * torch.exp2(m - m_t) + e.sum(dim=-1, keepdim=True)
            m = m_t
            tiles[t] = (e.to(out_dtype), m_t)
        ranks.append((m, l))
    (m0, l0), (m1, l1) = ranks
    m = torch.maximum(m0, m1)
    l = l0 * torch.exp2(m0 - m) + l1 * torch.exp2(m1 - m)
    inv = 1.0 / torch.where(l == 0.0, 1.0, l)
    return torch.cat([(e.float() * (torch.exp2(m_t - m) * inv)).to(out_dtype)
                      for e, m_t in tiles], dim=-1)


# the l-range of the fixed-max form (JAX gemm.py:598-603): a real row whose
# l is not finite or leaves [2^-100, 2^120] breaches it
_L_LO, _L_HI = 2.0 ** -100, 2.0 ** 120


def _softmax_epilogue_resident_plain(a, b, bias, scale, out_dtype):
    """The resident kernel's function in plain PyTorch: fixed-max e =
    exp2(z) in f32 with no max subtracted, l its row sum, e rounded to
    out_dtype times (1/l) rounded to out_dtype (an l of 0 counts as 1); the
    l-range witness (the count of rows that breach it, a 0-d int32 tensor),
    and where it is above 0, the rows structure's output instead (read on
    the host: this is the reference, not the card's path). Returns (output,
    witness)."""
    z = torch.matmul(a.float(), b.float()) * (scale * _LOG2E) + bias.float() * _LOG2E
    e = torch.exp2(z)
    l = e.sum(dim=-1, keepdim=True)
    bad = ~torch.isfinite(l) | (l > _L_HI) | (l < _L_LO)
    witness = bad.sum().to(torch.int32)
    if witness > 0:
        return _softmax_epilogue_plain(a, b, bias, scale, out_dtype), witness
    inv = (1.0 / torch.where(l == 0.0, 1.0, l)).to(out_dtype)
    return e.to(out_dtype) * inv, witness


@functools.cache
def _softmax_kernel():
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    return _build.kernel("fkp_gemm_softmax",
                         [vp] * 6 + [i32] * 4 + [ctypes.c_float, i32, i32, vp])


@functools.cache
def _resident_kernel():
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    return _build.kernel("fkp_gemm_softmax_resident",
                         [vp] * 5 + [i32] * 4 + [ctypes.c_float, i32, i32, vp])


def batched_matmul_softmax_epilogue(
    a: torch.Tensor,
    b: torch.Tensor,
    bias: torch.Tensor,
    *,
    scale: float = 1.0,
    out_dtype=torch.float32,
    resident: bool | None = None,
) -> torch.Tensor:
    """C[i] = softmax_rows(scale * A[i] @ B[i] + bias[col]): a [B, M, K],
    b [B, K, N], bias [N] -> [B, M, N] in out_dtype, the softmax fused on
    the f32 accumulator (BASELINE.json config 3). `resident` None or False
    (the JAX default) is the rows structure: the row max subtracted, one
    sweep over N on the wgmma route and two on the mma.sync route.
    resident=True is the TPU's A-resident fixed-max form: one sweep, exp2
    with no max subtracted, and an l-range
    witness (a real row whose l is not finite or leaves [2^-100, 2^120])
    that sends the call to the rows structure's output; the last call's
    witness count stays on `batched_matmul_softmax_epilogue.witness`, a
    0-d int32 tensor on the inputs' device (reading it from the card
    synchronises; the call itself does not). CPU tensors run the plain
    versions; CUDA tensors launch csrc/gemm_softmax.cu's entries (bf16
    operands), on the kernel `softmax_epilogue_path` picks, or raise.
    Launches are counted: `.launches` the rows form on its own,
    `.resident_launches` the resident form, `.fallback_launches` the rows
    form gated on the witness (launched after every resident one; it
    returns at once while the witness is 0), and `.sm90_launches` those of
    the three that took the wgmma kernel (csrc/gemm_softmax_sm90.cuh)."""
    _dims(a, b, batched=True)
    bsz, m, k = a.shape
    n = b.shape[2]
    if tuple(bias.shape) != (n,):
        raise ValueError(f"bias {tuple(bias.shape)} must be ({n},)")
    fn = batched_matmul_softmax_epilogue
    if a.device.type == "cpu":
        if not resident:
            return _softmax_epilogue_plain(a, b, bias, scale, out_dtype)
        out, fn.witness = _softmax_epilogue_resident_plain(a, b, bias, scale,
                                                           out_dtype)
        return out
    if a.device.type != "cuda":
        raise ValueError(f"no GEMM for device {a.device}")
    _check_types(a, b, out_dtype)
    if a.dtype != torch.bfloat16:
        raise TypeError("the CUDA softmax-epilogue GEMM takes bf16 operands, "
                        f"got {a.dtype}")
    if 0 in (bsz, m, n):
        if resident:
            fn.witness = torch.zeros((), dtype=torch.int32, device=a.device)
        return _empty(a, b, out_dtype)
    a, b = a.contiguous(), b.contiguous()
    bias = bias.to(a.device, torch.float32).contiguous()
    if bias.data_ptr() % 16:  # the wgmma kernel reads it in pairs
        bias = bias.clone()
    c = torch.empty((bsz, m, n), dtype=out_dtype, device=a.device)
    path = softmax_epilogue_path(a.dtype, b.dtype, a.shape, b.shape, _aligned(a, b))
    sm90 = int(path == PATH_SM90)
    # the rows form's tile maxima on the wgmma kernel: room for its
    # narrower tiles (128 columns)
    tile_max = (torch.empty((bsz, m, -(-n // 128)), dtype=torch.float32,
                            device=a.device) if sm90 else None)
    args = (bsz, m, n, k, float(scale * _LOG2E), int(out_dtype == torch.bfloat16),
            path, torch.cuda.current_stream(a.device).cuda_stream)
    gate = None
    if resident:
        witness = torch.zeros((), dtype=torch.int32, device=a.device)
        rc = _resident_kernel()(a.data_ptr(), b.data_ptr(), bias.data_ptr(),
                                c.data_ptr(), witness.data_ptr(), *args)
        fn.resident_launches += 1
        fn.sm90_launches += sm90
        _build.check(rc, "gemm_softmax_resident")
        fn.witness, gate = witness, witness.data_ptr()
    rc = _softmax_kernel()(a.data_ptr(), b.data_ptr(), bias.data_ptr(),
                           c.data_ptr(), gate,
                           None if tile_max is None else tile_max.data_ptr(), *args)
    if resident:
        fn.fallback_launches += 1
    else:
        fn.launches += 1
    fn.sm90_launches += sm90
    _build.check(rc, "gemm_softmax")
    return c


# kernel launches, for showing that a path ran the kernels (matmul_bf16
# counts in matmul's); `.sm90_launches` and `.f32x_launches` count those of
# `.launches` that took the bf16 and the f32 wgmma kernel (matmul,
# batched_matmul and matmul_fused_epilogue; the softmax epilogue's
# `.sm90_launches`: those of its three counts that took its wgmma kernel)
matmul.launches = 0
matmul.sm90_launches = 0
matmul.f32x_launches = 0
batched_matmul.launches = 0
batched_matmul.sm90_launches = 0
batched_matmul.f32x_launches = 0
matmul_fused_epilogue.launches = 0
matmul_fused_epilogue.sm90_launches = 0
matmul_fused_epilogue.f32x_launches = 0
batched_matmul_softmax_epilogue.launches = 0
batched_matmul_softmax_epilogue.resident_launches = 0
batched_matmul_softmax_epilogue.fallback_launches = 0
batched_matmul_softmax_epilogue.sm90_launches = 0
# the resident form's last witness count (None before the first such call)
batched_matmul_softmax_epilogue.witness = None
