"""8-bit quantization: the per-token KV-cache scales and the weight-only
decode parameters.

Counterpart of flashattention_kernel_project_tpu/ops/quant.py. The
quantizers are plain PyTorch and bit-equal to the JAX package's: the
scale is absmax / 127 (int8) or absmax / 448 (e4m3, its largest normal
value) in float32, with absmax floored at 1e-8; the values are x / scale
in float32, rounded half to even and clipped to +-127 for int8, or cast
(round to nearest even) to torch.float8_e4m3fn. The fused-dequant
attention kernels that read these caches live in ops/flash_decode.py,
ops/paged_decode.py and ops/flash_attention.py. The JAX package's
weight-only and int8 x int8 GEMM kernels are not ported: the engine
multiplies by the widened 8-bit weights outside any kernel, as the JAX
engine does.
"""

from __future__ import annotations

import torch

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


def _gemm_not_ported(name):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"{name}: the 8-bit GEMM kernels are ROADMAP item A.11; the engine "
            "multiplies by the widened 8-bit weights instead"
        )

    fn.__name__ = name
    return fn


matmul_int8_weights = _gemm_not_ported("matmul_int8_weights")
matmul_fp8_weights = _gemm_not_ported("matmul_fp8_weights")
matmul_int8 = _gemm_not_ported("matmul_int8")
