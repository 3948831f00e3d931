"""8-bit quantization: the per-token KV-cache scales and the weight-only
decode parameters.

Counterpart of flashattention_kernel_project_tpu/ops/quant.py. The
quantizers are plain PyTorch and bit-equal to the JAX package's: the
scale is absmax / 127 (int8) or absmax / 448 (e4m3, its largest normal
value) in float32, with absmax floored at 1e-8; the values are x / scale
in float32, rounded half to even and clipped to +-127 for int8, or cast
(round to nearest even) to torch.float8_e4m3fn. The fused-dequant
attention kernels that read these caches live in ops/flash_decode.py,
ops/paged_decode.py and ops/flash_attention.py.

The 8-bit GEMMs of the ladder are here too: `matmul_int8_weights` and
`matmul_fp8_weights` (bf16 activations times int8 or e4m3 weights, a scale
per output column on the f32 accumulator) and `matmul_int8` (int8 times
int8, an exact int32 sum, row and column scales). On a CUDA tensor they
launch the hand-written Hopper kernels csrc/gemm_w8.cu and csrc/gemm_i8.cu;
on a CPU tensor their plain versions. The engine does not call them: it
multiplies by the widened 8-bit weights outside any kernel, as the JAX
engine does.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from flashattention_kernel_project_tpu_torch.ops import _build
from flashattention_kernel_project_tpu_torch.ops.gemm import _aligned

_INT8_MAX = 127.0
_E4M3_MAX = 448.0  # the largest normal e4m3 value
_8BIT = (torch.int8, torch.float8_e4m3fn)  # the cache types


def _absmax_scale(x32, axis, top):
    absmax = x32.abs().amax(dim=axis, keepdim=True)
    return absmax.clamp(min=1e-8) / top


def quantize_int8(x: torch.Tensor, axis: int = -1):
    """Symmetric absmax int8 quantization along `axis`: (values int8,
    scales float32 with `axis` kept as size 1)."""
    x32 = x.float()
    scale = _absmax_scale(x32, axis, _INT8_MAX)
    q = torch.round(x32 / scale).clamp(-_INT8_MAX, _INT8_MAX)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32):
    return (q.float() * scale).to(dtype)


def quantize_fp8(x: torch.Tensor):
    """e4m3 quantization with one scale for the whole tensor: (values
    float8_e4m3fn, scale float32 0-d)."""
    scale = x.float().abs().amax().clamp(min=1e-8) / _E4M3_MAX
    return (x.float() / scale).to(torch.float8_e4m3fn), scale


def quantize_fp8_tokenwise(x: torch.Tensor, axis: int = -1):
    """e4m3 quantization with a scale per slice along `axis` (the per-token
    KV-cache form; the scale keeps `axis` as size 1, as quantize_int8)."""
    x32 = x.float()
    scale = _absmax_scale(x32, axis, _E4M3_MAX)
    return (x32 / scale).to(torch.float8_e4m3fn), scale


def dequantize_fp8(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32):
    return (q.float() * scale).to(dtype)


def quantize_fp8_weights(w: torch.Tensor):
    """Per-output-column e4m3 weights: w [K, N] -> (w_q [K, N], scale
    [1, N] float32)."""
    return quantize_fp8_tokenwise(w, axis=0)


def quantizer_for(dtype: torch.dtype):
    """The per-token quantizer that fills a cache of `dtype` (int8 or
    float8_e4m3fn)."""
    if dtype == torch.int8:
        return quantize_int8
    if dtype == torch.float8_e4m3fn:
        return quantize_fp8_tokenwise
    raise TypeError(f"no 8-bit quantizer for {dtype}")


def cache_dtype(quant_fmt: str) -> torch.dtype:
    """The cache element type of a quant_fmt ("int8" or "fp8")."""
    fmts = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
    if quant_fmt not in fmts:
        raise ValueError(f"quant_fmt must be 'int8' or 'fp8', got {quant_fmt!r}")
    return fmts[quant_fmt]


def quantize_kv(k: torch.Tensor, v: torch.Tensor, *, fmt: str = "int8"):
    """Per-token symmetric 8-bit quantization of a KV cache: k, v
    [..., S, D] -> (k_q, k_scale [..., S, 1], v_q, v_scale)."""
    quantizer = quantizer_for(cache_dtype(fmt))
    k_q, k_scale = quantizer(k, axis=-1)
    v_q, v_scale = quantizer(v, axis=-1)
    return k_q, k_scale, v_q, v_scale


def check_8bit_cache(q, k_q, k_scale, v_q, v_scale, scale_shape, what):
    """Device, dtype, layout and shape checks of an 8-bit cache or pool and
    its f32 scales, shared by the 8-bit kernels' wrappers."""
    if k_q.dtype not in _8BIT or v_q.dtype != k_q.dtype:
        raise TypeError(f"the CUDA {what} takes an int8 or float8_e4m3fn "
                        f"cache; got {k_q.dtype} and {v_q.dtype}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA {what} takes a bf16 q; got {q.dtype}")
    if v_q.shape != k_q.shape:
        raise ValueError(f"k {tuple(k_q.shape)} and v {tuple(v_q.shape)} differ")
    for name, x in (("q", q), ("k", k_q), ("v", v_q), ("k_scale", k_scale),
                    ("v_scale", v_scale)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    for name, x in (("k_scale", k_scale), ("v_scale", v_scale)):
        if x.dtype != torch.float32 or tuple(x.shape) != tuple(scale_shape):
            raise ValueError(f"{name} must be float32 {tuple(scale_shape)}, got "
                             f"{x.dtype} {tuple(x.shape)}")


_OUT_TYPES = (torch.float32, torch.bfloat16)  # the kernels' output types


def _check_gemm_out(out_dtype, device):
    if device.type == "cuda" and out_dtype not in _OUT_TYPES:
        raise TypeError(f"the CUDA 8-bit GEMMs write f32 or bf16, not {out_dtype}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no GEMM for device {device}")


def _matmul_w8_plain(x, w_q, w_scale, out_dtype):
    """The weight-only kernel's function in plain PyTorch: x rounded to bf16
    (the TPU kernel's first step), the 8-bit weights widened (exact), the
    product in float32, times the column scales, rounded once."""
    x = x.to(torch.bfloat16).float()
    return (torch.matmul(x, w_q.float()) * w_scale).to(out_dtype)


@functools.cache
def _w8_kernel():
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    return _build.kernel("fkp_gemm_w8", [vp] * 4 + [i32] * 6 + [vp])


def _matmul_w8(fn, x, w_q, w_scale, out_dtype):
    """out = (bf16(x) @ widen(w_q)) * w_scale: the plain version for CPU
    tensors, csrc/gemm_w8.cu (counted in `fn.launches`) for CUDA ones."""
    if x.dim() != 2 or w_q.dim() != 2 or x.shape[1] != w_q.shape[0]:
        raise ValueError(f"shapes x {tuple(x.shape)} @ w_q {tuple(w_q.shape)} "
                         "do not make a product")
    m, n = x.shape[0], w_q.shape[1]
    if tuple(w_scale.shape) != (1, n):
        raise ValueError(f"w_scale must be (1, {n}), got {tuple(w_scale.shape)}")
    if not x.is_floating_point() or w_q.dtype not in _8BIT:
        raise TypeError(f"{fn.__name__} takes a float x and int8 or e4m3 "
                        f"weights, got {x.dtype} and {w_q.dtype}")
    _check_gemm_out(out_dtype, x.device)
    if x.device.type == "cpu":
        return _matmul_w8_plain(x, w_q, w_scale, out_dtype)
    for name, t in (("w_q", w_q), ("w_scale", w_scale)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if w_scale.dtype != torch.float32:
        raise TypeError(f"w_scale must be float32, got {w_scale.dtype}")
    if m == 0 or n == 0:
        return torch.zeros((m, n), dtype=out_dtype, device=x.device)
    x = x.to(torch.bfloat16).contiguous()
    w_q, w_scale = w_q.contiguous(), w_scale.contiguous()
    c = torch.empty((m, n), dtype=out_dtype, device=x.device)
    rc = _w8_kernel()(
        x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(), c.data_ptr(), m, n,
        x.shape[1], int(w_q.dtype == torch.float8_e4m3fn),
        int(out_dtype == torch.bfloat16), int(_aligned(x, w_q)),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    fn.launches += 1
    _build.check(rc, "gemm_w8")
    return c


def matmul_int8_weights(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                        *, out_dtype=torch.float32) -> torch.Tensor:
    """out = x @ (w_q * w_scale), the dequantization on the f32 accumulator:
    x [M, K] any float type (rounded to bf16 first, as the TPU kernel does),
    w_q [K, N] int8 (or e4m3: the kernel is one), w_scale [1, N] float32
    (`quantize_int8(w, axis=0)`). Returns [M, N] in out_dtype (f32 or bf16
    on the card). CPU tensors run the plain version; CUDA tensors launch
    csrc/gemm_w8.cu or raise."""
    return _matmul_w8(matmul_int8_weights, x, w_q, w_scale, out_dtype)


def matmul_fp8_weights(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                       *, out_dtype=torch.float32) -> torch.Tensor:
    """`matmul_int8_weights` with float8_e4m3fn weights (a TypeError for
    another type, where JAX asserts), from `quantize_fp8_weights`. The
    products stay bf16: the e4m3 values widen exactly."""
    if w_q.dtype != torch.float8_e4m3fn:
        raise TypeError(f"matmul_fp8_weights takes float8_e4m3fn weights, got {w_q.dtype}")
    return _matmul_w8(matmul_fp8_weights, x, w_q, w_scale, out_dtype)


def _matmul_i8_plain(a_q, a_scale, b_q, b_scale, out_dtype):
    """The int8 kernel's function in plain PyTorch. The int32 sum is taken
    through float64, exact for int8 operands at any K below about 2^38
    (torch has no int32 product on CUDA); then f32, times the row scales,
    times the column scales, each step rounded as the kernel rounds it."""
    acc = torch.matmul(a_q.double(), b_q.double()).float()
    return (acc * a_scale * b_scale).to(out_dtype)


@functools.cache
def _i8_kernel():
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    return _build.kernel("fkp_gemm_i8", [vp] * 5 + [i32] * 5 + [vp])


def matmul_int8(a_q: torch.Tensor, a_scale: torch.Tensor, b_q: torch.Tensor,
                b_scale: torch.Tensor, *, out_dtype=torch.float32) -> torch.Tensor:
    """out = (f32(a_q @ b_q) * a_scale) * b_scale, both operands int8 and the
    sum exact in int32: a_q [M, K], b_q [K, N] int8, a_scale [M, 1] and
    b_scale [1, N] float32. Returns [M, N] in out_dtype (f32 or bf16 on the
    card). CPU tensors run the plain version; CUDA tensors launch
    csrc/gemm_i8.cu or raise."""
    if a_q.dim() != 2 or b_q.dim() != 2 or a_q.shape[1] != b_q.shape[0]:
        raise ValueError(f"shapes a_q {tuple(a_q.shape)} @ b_q {tuple(b_q.shape)} "
                         "do not make a product")
    m, n = a_q.shape[0], b_q.shape[1]
    if tuple(a_scale.shape) != (m, 1) or tuple(b_scale.shape) != (1, n):
        raise ValueError(f"a_scale {tuple(a_scale.shape)} and b_scale "
                         f"{tuple(b_scale.shape)} must be ({m}, 1) and (1, {n})")
    if a_q.dtype != torch.int8 or b_q.dtype != torch.int8:
        raise TypeError(f"matmul_int8 takes int8 operands, got {a_q.dtype} and {b_q.dtype}")
    _check_gemm_out(out_dtype, a_q.device)
    if a_q.device.type == "cpu":
        return _matmul_i8_plain(a_q, a_scale, b_q, b_scale, out_dtype)
    for name, t in (("b_q", b_q), ("a_scale", a_scale), ("b_scale", b_scale)):
        if t.device != a_q.device:
            raise ValueError(f"{name} is on {t.device}, a_q on {a_q.device}")
    if a_scale.dtype != torch.float32 or b_scale.dtype != torch.float32:
        raise TypeError("the scales must be float32")
    if m == 0 or n == 0:
        return torch.zeros((m, n), dtype=out_dtype, device=a_q.device)
    a_q, b_q = a_q.contiguous(), b_q.contiguous()
    a_scale, b_scale = a_scale.contiguous(), b_scale.contiguous()
    c = torch.empty((m, n), dtype=out_dtype, device=a_q.device)
    rc = _i8_kernel()(
        a_q.data_ptr(), b_q.data_ptr(), a_scale.data_ptr(), b_scale.data_ptr(),
        c.data_ptr(), m, n, a_q.shape[1], int(out_dtype == torch.bfloat16),
        int(_aligned(a_q, b_q)), torch.cuda.current_stream(a_q.device).cuda_stream,
    )
    matmul_int8.launches += 1
    _build.check(rc, "gemm_i8")
    return c


# kernel launches, for showing that a path ran the kernels
matmul_int8_weights.launches = 0
matmul_fp8_weights.launches = 0
matmul_int8.launches = 0
