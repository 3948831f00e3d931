"""Row softmax and the online-softmax state machine.

Counterpart of flashattention_kernel_project_tpu/ops/softmax.py. `softmax`
is the row softmax over the last axis: on a CUDA tensor the hand-written
Hopper kernel in csrc/softmax.cu, on a CPU tensor `_softmax_plain`, the same
function in plain PyTorch. The state machine (`SoftmaxState`, `init_state`,
`tile_state`, `merge`, `finalize`, `online_softmax_reference`) is plain
PyTorch on every device, as it is plain jnp in the JAX package: the
unnormalized streaming discipline, whose merge is associative and
commutative, so any partition of the key axis (key tiles, split-KV shards,
ring hops) combines with one function. NEG_INF and _LOG2E are the constants
the attention kernels' plain versions share.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from flashattention_kernel_project_tpu_torch.ops import _build

NEG_INF = float(-1e30)  # finite -inf stand-in, as the kernels use it
_LOG2E = 1.4426950408889634  # log2(e): the softmaxes run in the log2 domain


def _softmax_plain(x: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: f32, the log2 domain, one
    reciprocal of the row sum multiplied over the row, out in x's type."""
    xf = x.float()
    m = xf.amax(dim=-1, keepdim=True)
    e = torch.exp2((xf - m) * _LOG2E)
    r = 1.0 / e.sum(dim=-1, keepdim=True)
    return (e * r).to(x.dtype)


@functools.cache
def _kernel():
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    return _build.kernel("fkp_softmax", [vp, vp, i32, i32, i32, i32, vp])


def _softmax_cuda(x: torch.Tensor) -> torch.Tensor:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the CUDA softmax takes f32 or bf16, got {x.dtype}")
    x = x.contiguous()
    y = torch.empty_like(x)
    n = x.shape[-1]
    rows = x.numel() // n if n else 0
    if rows == 0:
        return y
    vec = (n * x.element_size() % 16 == 0 and x.data_ptr() % 16 == 0
           and y.data_ptr() % 16 == 0)
    rc = _kernel()(x.data_ptr(), y.data_ptr(), rows, n,
                   int(x.dtype == torch.bfloat16), int(vec),
                   torch.cuda.current_stream(x.device).cuda_stream)
    softmax.launches += 1
    _build.check(rc, "softmax")
    return y


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Row softmax over the last axis, any leading dims, computed in f32,
    out in x's type. CPU tensors run the plain version; CUDA tensors launch
    csrc/softmax.cu (f32 or bf16) or raise."""
    if x.device.type == "cpu":
        return _softmax_plain(x)
    if x.device.type == "cuda":
        return _softmax_cuda(x)
    raise ValueError(f"no softmax for device {x.device}")


softmax.launches = 0  # kernel launches, for showing that a path ran the kernel


class SoftmaxState(NamedTuple):
    """Unnormalized streaming softmax partial over some slice of keys.

    m: running row max            [..., rows]
    l: running sum of exp(s - m)  [..., rows]
    y: running exp-weighted V sum [..., rows, d_v]  (unnormalized)
    """

    m: torch.Tensor
    l: torch.Tensor  # noqa: E741
    y: torch.Tensor


def init_state(rows_shape: tuple[int, ...], d_v: int, dtype=torch.float32,
               device=None) -> SoftmaxState:
    return SoftmaxState(
        m=torch.full(rows_shape, NEG_INF, dtype=dtype, device=device),
        l=torch.zeros(rows_shape, dtype=dtype, device=device),
        y=torch.zeros((*rows_shape, d_v), dtype=dtype, device=device),
    )


def tile_state(scores: torch.Tensor, values: torch.Tensor) -> SoftmaxState:
    """State of one tile: scores [..., rows, cols], values [..., cols, d_v].
    Masked-out entries must already be NEG_INF in `scores`."""
    m = scores.amax(dim=-1)
    e = torch.exp(scores - m[..., None])
    return SoftmaxState(m=m, l=e.sum(dim=-1), y=e @ values)


def merge(a: SoftmaxState, b: SoftmaxState) -> SoftmaxState:
    """Associative and commutative merge (up to rounding): m = max, l and y
    rescaled to it and summed."""
    m = torch.maximum(a.m, b.m)
    ea = torch.exp(a.m - m)
    eb = torch.exp(b.m - m)
    return SoftmaxState(
        m=m,
        l=a.l * ea + b.l * eb,
        y=a.y * ea[..., None] + b.y * eb[..., None],
    )


def finalize(state: SoftmaxState, eps: float = 0.0) -> torch.Tensor:
    """O = y / l, the single final normalize of the streaming discipline."""
    return state.y / (state.l + eps)[..., None]


def online_softmax_reference(x: torch.Tensor, block_cols: int = 512) -> torch.Tensor:
    """Row softmax by the online (m, l) loop over column blocks, in f32: the
    executable spec of the fused attention kernels' softmax, without the
    attention around it. Out in x's type."""
    n = x.shape[-1]
    xf = x.float()
    pad = (-n) % block_cols
    xp = torch.nn.functional.pad(xf, (0, pad), value=NEG_INF)
    m = torch.full(x.shape[:-1], NEG_INF, dtype=torch.float32, device=x.device)
    l = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    for tile in xp.split(block_cols, dim=-1):
        m_new = torch.maximum(m, tile.amax(dim=-1))
        l = l * torch.exp(m - m_new) + torch.exp(tile - m_new[..., None]).sum(dim=-1)
        m = m_new
    return (torch.exp(xf - m[..., None]) / l[..., None]).to(x.dtype)
