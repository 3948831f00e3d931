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
launch the hand-written Hopper kernels by a route fixed by type and shape
before the launch (`w8_path`, `i8_path`): aligned calls the wgmma kernels
csrc/gemm_w8_sm90.cu (tiles by `w8_plan`) and csrc/gemm_i8_sm90.cu (after
its transposing pass), the others the mma.sync kernels csrc/gemm_w8.cu and
csrc/gemm_i8.cu; on a CPU tensor their plain versions. The engine does not
call them: it multiplies by the widened 8-bit weights outside any kernel,
as the JAX engine does.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from flashattention_kernel_project_tpu_torch.ops import _build
from flashattention_kernel_project_tpu_torch.ops.gemm import PATH_ELEMENTWISE, PATH_SM90

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


def _route(k: int, n: int, k_unit: int, bases_aligned: bool) -> int:
    """`w8_path` / `i8_path`: PATH_SM90 where K > 0, every TMA map's rows
    are whole 16-byte pieces (K a multiple of k_unit, N of 16) and the
    bases 16-byte aligned; else PATH_ELEMENTWISE, the mma.sync kernel,
    which reads element by element."""
    if k > 0 and k % k_unit == 0 and n % 16 == 0 and bases_aligned:
        return PATH_SM90
    return PATH_ELEMENTWISE


def w8_path(k: int, n: int, bases_aligned: bool) -> int:
    """The kernel a CUDA call of `matmul_int8_weights` /
    `matmul_fp8_weights` takes (x [M, K] as bf16, w_q [K, N] 8-bit), by
    shape and alignment alone, before the launch: PATH_SM90 (the wgmma
    kernel, csrc/gemm_w8_sm90.cu) where K > 0, K is a multiple of 8 (x's
    bf16 rows), N of 16 (w_q's byte rows) and both bases are 16-byte
    aligned; else gemm_w8.cu's mma.sync kernel (PATH_ELEMENTWISE). An f32 x
    is rounded to a bf16 copy first, so its own alignment does not
    count. A documented route, not a fallback."""
    return _route(k, n, 8, bases_aligned)


def i8_path(k: int, n: int, bases_aligned: bool) -> int:
    """The kernel a CUDA call of `matmul_int8` takes (a_q [M, K], b_q [K,
    N] int8), as `w8_path`: PATH_SM90 (csrc/gemm_i8_sm90.cu: the
    transposing pass, then the wgmma kernel) where K > 0, K and N are
    multiples of 16 (the byte rows of a_q, b_q and B^T) and both bases are
    16-byte aligned; else gemm_i8.cu's mma.sync kernel (PATH_ELEMENTWISE)."""
    return _route(k, n, 16, bases_aligned)


# kernel 19's wgmma tiles: (rows of x, columns of C)
W8_TILES = ((256, 128), (128, 128), (64, 64), (16, 64))


def w8_plan(m: int, n: int, sms: int) -> tuple[int, int]:
    """The tile (rows of x, columns of C) of kernel 19's wgmma kernel for an
    [M, N] output on a card of `sms` SMs. M > 64: 256 x 128 (128 x 128
    where M <= 128), two consumer warpgroups of 64 columns, where that grid
    has at least one tile an SM; else, and for M <= 64, one warpgroup's 64
    columns at two blocks an SM, by 16 rows where M <= 16, else 64. The
    decode shape (M 8, N 11008) takes 172 tiles of 16 x 64 for 132 SMs.
    Each tile sums the whole of K: no split."""
    if m > 64:
        rows = 128 if m <= 128 else 256
        if -(-m // rows) * -(-n // 128) >= sms:
            return rows, 128
        return 64, 64
    return (16 if m <= 16 else 64), 64


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _w8_kernel():
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    return _build.kernel("fkp_gemm_w8", [vp] * 4 + [i32] * 5 + [vp])


@functools.cache
def _w8_sm90_kernel():
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    return _build.kernel("fkp_gemm_w8_sm90", [vp] * 4 + [i32] * 7 + [vp])


def _matmul_w8(fn, x, w_q, w_scale, out_dtype):
    """out = (bf16(x) @ widen(w_q)) * w_scale: the plain version for CPU
    tensors; for CUDA ones the kernel `w8_path` names, csrc/gemm_w8_sm90.cu
    (counted in `fn.launches` and `fn.sm90_launches`) or csrc/gemm_w8.cu
    (in `fn.launches`)."""
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
    k = x.shape[1]
    path = w8_path(k, n, x.data_ptr() % 16 == 0 and w_q.data_ptr() % 16 == 0)
    kernel = _w8_sm90_kernel() if path == PATH_SM90 else _w8_kernel()
    c = torch.empty((m, n), dtype=out_dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    fp8, bf16_out = int(w_q.dtype == torch.float8_e4m3fn), int(out_dtype == torch.bfloat16)
    if path == PATH_SM90:
        rows, cols = w8_plan(m, n, _sms(x.device.index))
        rc = kernel(x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(), c.data_ptr(),
                    m, n, k, fp8, bf16_out, rows, cols, stream)
        fn.sm90_launches += 1
    else:
        rc = kernel(x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(), c.data_ptr(),
                    m, n, k, fp8, bf16_out, stream)
    fn.launches += 1
    _build.check(rc, "gemm_w8_sm90" if path == PATH_SM90 else "gemm_w8")
    return c


def matmul_int8_weights(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                        *, out_dtype=torch.float32) -> torch.Tensor:
    """out = x @ (w_q * w_scale), the dequantization on the f32 accumulator:
    x [M, K] any float type (rounded to bf16 first, as the TPU kernel does),
    w_q [K, N] int8 (or e4m3: the kernel is one), w_scale [1, N] float32
    (`quantize_int8(w, axis=0)`). Returns [M, N] in out_dtype (f32 or bf16
    on the card). CPU tensors run the plain version; CUDA tensors launch
    the kernel `w8_path` names (csrc/gemm_w8_sm90.cu or csrc/gemm_w8.cu) or
    raise."""
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
    return _build.kernel("fkp_gemm_i8", [vp] * 5 + [i32] * 4 + [vp])


@functools.cache
def _i8_sm90_kernel():
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    return _build.kernel("fkp_gemm_i8_sm90", [vp] * 5 + [i32] * 4 + [vp])


@functools.cache
def _transpose_kernel():
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    return _build.kernel("fkp_gemm_i8_transpose", [vp] * 2 + [i32] * 2 + [vp])


def _transpose_i8_cuda(b_q: torch.Tensor) -> torch.Tensor:
    """B^T [N, K] of a CUDA int8 b_q [K, N] (contiguous, K and N multiples
    of 16, a 16-byte-aligned base) by csrc/gemm_i8_sm90.cu's transposing
    pass, counted in `matmul_int8.transpose_launches`; its plain version
    is b_q.t().contiguous()."""
    k, n = b_q.shape
    if b_q.dtype != torch.int8 or not b_q.is_contiguous() or k % 16 or n % 16 or (
            b_q.data_ptr() % 16):
        raise ValueError(f"the transposing pass takes a contiguous int8 [K, N] with "
                         f"K and N multiples of 16 and a 16-byte-aligned base, got "
                         f"{b_q.dtype} {tuple(b_q.shape)}")
    kernel = _transpose_kernel()
    bt = torch.empty((n, k), dtype=torch.int8, device=b_q.device)
    rc = kernel(b_q.data_ptr(), bt.data_ptr(), k, n,
                torch.cuda.current_stream(b_q.device).cuda_stream)
    matmul_int8.transpose_launches += 1
    _build.check(rc, "gemm_i8_transpose")
    return bt


def matmul_int8(a_q: torch.Tensor, a_scale: torch.Tensor, b_q: torch.Tensor,
                b_scale: torch.Tensor, *, out_dtype=torch.float32) -> torch.Tensor:
    """out = (f32(a_q @ b_q) * a_scale) * b_scale, both operands int8 and the
    sum exact in int32: a_q [M, K], b_q [K, N] int8, a_scale [M, 1] and
    b_scale [1, N] float32. Returns [M, N] in out_dtype (f32 or bf16 on the
    card). CPU tensors run the plain version; CUDA tensors launch the
    kernels `i8_path` names or raise: csrc/gemm_i8_sm90.cu's transposing
    pass (counted in `.transpose_launches`) and wgmma kernel (in
    `.launches` and `.sm90_launches`), or csrc/gemm_i8.cu (in
    `.launches`)."""
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
    k = a_q.shape[1]
    path = i8_path(k, n, a_q.data_ptr() % 16 == 0 and b_q.data_ptr() % 16 == 0)
    kernel = _i8_sm90_kernel() if path == PATH_SM90 else _i8_kernel()
    bt = _transpose_i8_cuda(b_q) if path == PATH_SM90 else None
    c = torch.empty((m, n), dtype=out_dtype, device=a_q.device)
    stream = torch.cuda.current_stream(a_q.device).cuda_stream
    bf16_out = int(out_dtype == torch.bfloat16)
    if path == PATH_SM90:
        rc = kernel(a_q.data_ptr(), bt.data_ptr(), a_scale.data_ptr(),
                    b_scale.data_ptr(), c.data_ptr(), m, n, k, bf16_out, stream)
        matmul_int8.sm90_launches += 1
    else:
        rc = kernel(a_q.data_ptr(), b_q.data_ptr(), a_scale.data_ptr(),
                    b_scale.data_ptr(), c.data_ptr(), m, n, k, bf16_out, stream)
    matmul_int8.launches += 1
    _build.check(rc, "gemm_i8_sm90" if path == PATH_SM90 else "gemm_i8")
    return c


# kernel launches, for showing that a path ran the kernels: all of a
# wrapper's GEMM launches, those on the wgmma kernels, and kernel 20's
# transposing passes
matmul_int8_weights.launches = matmul_int8_weights.sm90_launches = 0
matmul_fp8_weights.launches = matmul_fp8_weights.sm90_launches = 0
matmul_int8.launches = matmul_int8.sm90_launches = 0
matmul_int8.transpose_launches = 0
