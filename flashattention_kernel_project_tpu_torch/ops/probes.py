"""Stage probes: the attention forward stripped to one stage each.

Counterpart of flashattention_kernel_project_tpu/ops/probes.py
(`copy_probe`, `qk_probe`, `pv_probe`, `softmax_chain_probe`,
`qk_kt_probe`, `qk_packed_probe`, `stream_copy_probe`), with JAX's names
and outputs. Each probe keeps one stage of the forward (the K/V stream, the
QK product, the softmax chain, the PV product), so that the forward's time
splits into stages by subtraction, as benchmarks/profile_attention.py does.
On a CUDA tensor each launches its kernel or raises: `copy_probe`,
`qk_probe`, `pv_probe`, `softmax_chain_probe`, `qk_kt_probe` and
`qk_packed_probe` the Hopper forward's own block with the other stages
taken out (csrc/probes_sm90.cu's fkp_probe_sm90, on flash_fwd_sm90.cuh's
fwd_block: its grid and block rows, TMA ring, wgmma products and softmax;
the chain runs the forward's softmax on synthesized scores, qk_kt reads
K^T as the MN-major operand, qk_packed is the QK stage at D = 2d over the
packed operands; `probe_sizes` says which sizes a stage passes), the
stream copy its own kernel (csrc/probes.cu); on a CPU tensor each runs
its plain PyTorch version, in float32. Each counts its launches.

block_q and block_k set no hardware tile on Hopper; they are kept because
`copy_probe`'s output depends on block_k (it adds key row j * block_k of
each tile). Unlike JAX, whose grid truncates and leaves the tail rows
unwritten, every probe raises ValueError unless block_q divides N and
block_k divides S. On the card the probes take bf16 q, k, v with d in
{64, 128} (`qk_packed_probe`: 2d in {64, 128}), N and S multiples of 64
and Hq a multiple of Hkv; `stream_copy_probe` takes float32 or bf16. The
TPU's `block_rows` of the stream copy is not a parameter: the kernel picks
its own tiles.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from flashattention_kernel_project_tpu_torch.ops import _build
from flashattention_kernel_project_tpu_torch.ops.softmax import NEG_INF

# the stage numbers of csrc/flash_fwd_sm90.cuh's FwdStage (copy, qk, pv,
# the softmax chain, qk_kt, qk_packed: csrc/probes_sm90.cu)
_COPY, _QK, _PV, _CHAIN, _QKT, _PACKED = range(6)
_KERNEL_DIMS = (64, 128)
_TILE = 64  # the kernel's query and key tile


def _check_blocks(n: int, s: int, block_q: int, block_k: int) -> None:
    if block_q < 1 or block_k < 1 or n % block_q or s % block_k:
        raise ValueError(f"block_q={block_q} must divide N={n} and "
                         f"block_k={block_k} must divide S={s}")


def _check_heads(q, k) -> int:
    """q [B, Hq, N, D] against k [B, Hkv, S, D]: the group size Hq / Hkv."""
    if q.dim() != 4 or k.dim() != 4 or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"shapes q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "do not match")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"q heads {q.shape[1]} not a multiple of kv heads "
                         f"{k.shape[1]}")
    return q.shape[1] // k.shape[1]


def _per_q_head(x, group):
    """[B, Hkv, ...] -> [B, Hq, ...]: q head h reads KV head h // group."""
    return x.repeat_interleave(group, dim=1)


def _copy_plain(q, k, v, block_k):
    """Every row: the sum over key tiles of k[j * block_k] + v[j * block_k],
    taken tile by tile in key order, in float32."""
    b, hq, n, d = q.shape
    rows = k[:, :, ::block_k].float() + v[:, :, ::block_k].float()
    acc = torch.zeros(b, k.shape[1], d, dtype=torch.float32, device=q.device)
    for j in range(rows.shape[2]):
        acc = acc + rows[:, :, j]
    group = hq // k.shape[1]
    return _per_q_head(acc, group)[:, :, None, :].expand(b, hq, n, d).contiguous()


def _score_sums(q, k):
    """Each row's score sum over the keys, sum_k q . k, in float32 [B, Hq, N]."""
    group = q.shape[1] // k.shape[1]
    k_sum = _per_q_head(k.float().sum(dim=2), group)  # [B, Hq, D]
    return (q.float() * k_sum[:, :, None, :]).sum(dim=-1)


def _qk_plain(q, k):
    return _score_sums(q, k)[..., None].expand(q.shape).contiguous()


def _pv_plain(q, v):
    """q[..., 0] in v's dtype times sum_k v[k], in float32."""
    group = q.shape[1] // v.shape[1]
    p = q[..., 0].to(v.dtype).float()  # [B, Hq, N]
    v_sum = _per_q_head(v.float().sum(dim=2), group)  # [B, Hq, D]
    return p[..., None] * v_sum[:, :, None, :]


def _chain_plain(q, s, block_k):
    """The online (m, l, rescale, exp) chain over s keys in tiles of block_k
    on the scores q[..., 0] * 0.001 (every key of a row alike), in float32:
    acc (a row's d columns alike) / (l + 1e-6)."""
    b, hq, n, d = q.shape
    sc = q[..., 0].float() * 0.001  # [B, Hq, N]
    m = torch.full_like(sc, NEG_INF)
    l = torch.zeros_like(sc)
    acc = torch.zeros(b, hq, n, d, dtype=torch.float32, device=q.device)
    for _ in range(s // block_k):
        s_tile = sc[..., None].expand(b, hq, n, block_k)
        m_next = torch.maximum(m, s_tile.amax(dim=-1))
        scale = torch.exp(m - m_next)
        p_sum = torch.exp(s_tile - m_next[..., None]).sum(dim=-1)
        l = l * scale + p_sum
        acc = acc * scale[..., None] + p_sum[..., None]
        m = m_next
    return acc / (l[..., None] + 1e-6)


def _packed_plain(q, k):
    """[B, Hkv/2, G, N, 2d]: each row the score sums of its pair's two q
    heads (KV heads 2p and 2p + 1, group member g), broadcast over 2d."""
    b, hq, n, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    sums = _score_sums(q, k).reshape(b, hkv // 2, 2, group, n).sum(dim=2)
    return sums[..., None].expand(b, hkv // 2, group, n, 2 * d).contiguous()


@functools.cache
def _kernel_sm90():
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    return _build.kernel("fkp_probe_sm90", [vp] * 4 + [i32] * 8 + [vp])


@functools.cache
def _kernel_stream():
    vp = ctypes.c_void_p
    return _build.kernel("fkp_stream_copy",
                         [vp, vp, ctypes.c_longlong, ctypes.c_int, vp])


def _check_cuda(what, *tensors, dims=_KERNEL_DIMS):
    q = tensors[0]
    for x in tensors:
        if x.device != q.device:
            raise ValueError(f"{what}: inputs on {x.device} and {q.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA {what} takes bf16, got {x.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{what}: inputs must be contiguous and 16-byte aligned")
    n, d = q.shape[-2], q.shape[-1]
    if d not in dims:
        raise ValueError(f"the CUDA {what} takes d in {dims}, got {d}")
    if n % _TILE or tensors[1].shape[2] % _TILE:
        raise ValueError(f"the CUDA {what} takes N and S multiples of {_TILE}")


def probe_sizes(stage: int, q, k):
    """The sizes (hq, hkv, n, s, d) that the CUDA launch of probe `stage`
    passes to csrc/probes_sm90.cu's fkp_probe_sm90 for the caller's q
    [B, Hq, N, d] and k [B, Hkv, S, d]. qk_packed's are its packed
    operands': the Hkv / 2 pairs as both head counts, G * N rows, 2S keys
    and 2d; qk_kt's are qk's (the kernel reads K^T [B, Hkv, d, S] by
    them). Reads shapes only."""
    hq, n, d = q.shape[1], q.shape[2], q.shape[3]
    hkv, s = k.shape[1], k.shape[2]
    if stage == _PACKED:
        pairs = hkv // 2
        return pairs, pairs, hq // hkv * n, 2 * s, 2 * d
    if stage in (_COPY, _QK, _PV, _CHAIN, _QKT):
        return hq, hkv, n, s, d
    raise ValueError(f"no probe stage {stage}")


def _launch(probe, stage, q, k, operands, block_k, out):
    """One launch of the stage's kernel on `operands` (q, k, v as the kernel
    reads them: K^T for qk_kt, the packed q and K for qk_packed, v None
    where it reads none) through fkp_probe_sm90, every stage's entry, at
    the sizes `probe_sizes` gives for the caller's q and k, counted in
    probe.launches."""
    hq, hkv, n, s, d = probe_sizes(stage, q, k)
    kq, kk, kv = operands
    ptrs = (kq.data_ptr(), kk.data_ptr(), 0 if kv is None else kv.data_ptr(),
            out.data_ptr())
    rc = _kernel_sm90()(*ptrs, q.shape[0], hq, hkv, n, s, d, stage, block_k,
                        torch.cuda.current_stream(q.device).cuda_stream)
    probe.launches += 1
    _build.check(rc, probe.__name__)


def _kv_call(probe, stage, q, k, v, block_q, block_k, plain):
    """A probe over (q, k, v): the checks, then `plain()` on CPU tensors or
    the stage's kernel on CUDA tensors, counted in `probe.launches`."""
    _check_heads(q, k)
    if v.shape != k.shape:
        raise ValueError(f"v {tuple(v.shape)} must match k {tuple(k.shape)}")
    _check_blocks(q.shape[2], k.shape[2], block_q, block_k)
    if q.device.type == "cpu":
        return plain()
    if q.device.type != "cuda":
        raise ValueError(f"no {probe.__name__} for device {q.device}")
    _check_cuda(probe.__name__, q, k, v)
    b, hq, n, d = q.shape
    out = torch.empty(b, hq, n, d, dtype=torch.float32, device=q.device)
    _launch(probe, stage, q, k, (q, k, v), block_k, out)
    return out


def copy_probe(q, k, v, *, block_q: int = 512, block_k: int = 512):
    """The K/V stream alone: every K and V tile loaded, no products, no
    exp. q [B, Hq, N, D], k and v [B, Hkv, S, D]; returns float32
    [B, Hq, N, D] whose every row holds the sum over key tiles of
    k[j * block_k] + v[j * block_k] (q head h reads KV head h // (Hq / Hkv)).
    block_q must divide N and block_k S (ValueError)."""
    return _kv_call(copy_probe, _COPY, q, k, v, block_q, block_k,
                    lambda: _copy_plain(q, k, v, block_k))


def qk_probe(q, k, v, *, block_q: int = 512, block_k: int = 512):
    """The QK products alone: each row's score sum, sum_k q . k, broadcast
    over d (v is streamed, as in the fused kernel, and unused). Shapes and
    blocks as copy_probe's."""
    return _kv_call(qk_probe, _QK, q, k, v, block_q, block_k,
                    lambda: _qk_plain(q, k))


def pv_probe(q, k, v, *, block_q: int = 512, block_k: int = 512):
    """The PV products alone, on a probability tile synthesized from q:
    p = q[..., 0] (in v's dtype) at every key, so row i holds
    q[i, 0] * sum_k v[k]. Shapes and blocks as copy_probe's."""
    return _kv_call(pv_probe, _PV, q, k, v, block_q, block_k,
                    lambda: _pv_plain(q, v))


def softmax_chain_probe(q, k, v, *, block_q: int = 512, block_k: int = 512):
    """The online-softmax chain alone (tile max, m, the rescale of l and
    acc, exp of every score, no products) on the scores q[..., 0] * 0.001
    at every key; returns acc / (l + 1e-6). Shapes and blocks as
    copy_probe's."""
    return _kv_call(softmax_chain_probe, _CHAIN, q, k, v, block_q, block_k,
                    lambda: _chain_plain(q, k.shape[2], block_k))


# kernel launches, for showing that a path ran the kernel
copy_probe.launches = 0
qk_probe.launches = 0
pv_probe.launches = 0
softmax_chain_probe.launches = 0


def qk_kt_probe(q, k, v, *, block_q: int = 512, block_k: int = 512):
    """qk_probe with K transposed to [B, Hkv, D, S] before the kernel (in
    torch, as JAX transposes it in XLA), so the kernel reads [dim][key]
    tiles, as wgmma's MN-major B operand: the same output as qk_probe. v
    is not read (JAX's kernel takes none)."""
    _check_heads(q, k)
    b, hq, n, d = q.shape
    s = k.shape[2]
    _check_blocks(n, s, block_q, block_k)
    if q.device.type == "cpu":
        return _qk_plain(q, k)
    if q.device.type != "cuda":
        raise ValueError(f"no qk_kt_probe for device {q.device}")
    _check_cuda("qk_kt_probe", q, k)
    kt = k.transpose(-1, -2).contiguous()
    out = torch.empty(b, hq, n, d, dtype=torch.float32, device=q.device)
    _launch(qk_kt_probe, _QKT, q, k, (q, kt, None), block_k, out)
    return out


qk_kt_probe.launches = 0


def _pack(q, k, block_k):
    """JAX's packed operands (probes.py:199-218): q [B, Hkv/2, G * N, 2d],
    the two heads of a KV pair side by side; K [B, Hkv/2, 2S, 2d], each
    block_k tile block-diagonal [[k_A, 0], [0, k_B]]."""
    b, hq, n, d = q.shape
    _, hkv, s, _ = k.shape
    pairs, group = hkv // 2, hq // hkv
    q_in = (q.reshape(b, pairs, 2, group, n, d).permute(0, 1, 3, 4, 2, 5)
            .reshape(b, pairs, group * n, 2 * d).contiguous())
    k_a = k[:, 0::2].reshape(b, pairs, s // block_k, block_k, d)
    k_b = k[:, 1::2].reshape(b, pairs, s // block_k, block_k, d)
    z = torch.zeros_like(k_a)
    kp = torch.cat([torch.cat([k_a, z], -1), torch.cat([z, k_b], -1)], -2)
    return q_in, kp.reshape(b, pairs, 2 * s, 2 * d).contiguous()


def qk_packed_probe(q, k, *, block_q: int = 256, block_k: int = 512):
    """The QK products at the packed d <= 64 shape: two heads' q rows side
    by side ([G * N, 2d]) against block-diagonal [2 * block_k, 2d] K tiles,
    built in torch (as JAX builds them in XLA) and multiplied whole, zero
    quadrants included. q [B, Hq, N, d], k [B, Hkv, S, d] with Hkv even;
    returns float32 [B, Hkv/2, G, N, 2d], each row the score sums of its
    pair's two q heads (KV heads 2p and 2p + 1, member g). On the card 2d
    must be 64 or 128."""
    group = _check_heads(q, k)
    b, hq, n, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    if hkv % 2:
        raise ValueError(f"qk_packed_probe needs an even number of kv heads, got {hkv}")
    _check_blocks(n, s, block_q, block_k)
    if q.device.type == "cpu":
        return _packed_plain(q, k)
    if q.device.type != "cuda":
        raise ValueError(f"no qk_packed_probe for device {q.device}")
    _check_cuda("qk_packed_probe", q, k, dims=tuple(x // 2 for x in _KERNEL_DIMS))
    q_in, kp = _pack(q, k, block_k)
    pairs = hkv // 2
    out = torch.empty(b, pairs, group * n, 2 * d, dtype=torch.float32,
                      device=q.device)
    _launch(qk_packed_probe, _PACKED, q, k, (q_in, kp, None), block_k, out)
    return out.reshape(b, pairs, group, n, 2 * d)


qk_packed_probe.launches = 0


def stream_copy_probe(x):
    """out = x + 1 over [R, C], in x's dtype: one read and one write of
    every element, the balanced streaming rate at the softmax rung's shape.
    CPU tensors run `x + 1`; CUDA tensors (float32 or bf16, contiguous)
    launch the kernel or raise."""
    if x.device.type == "cpu":
        return x + 1
    if x.device.type != "cuda":
        raise ValueError(f"no stream_copy_probe for device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the CUDA stream_copy_probe takes float32 or bf16, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("stream_copy_probe: x must be contiguous and 16-byte aligned")
    out = torch.empty_like(x)
    rc = _kernel_stream()(
        x.data_ptr(), out.data_ptr(), x.numel(), int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    stream_copy_probe.launches += 1
    _build.check(rc, "stream_copy_probe")
    return out


stream_copy_probe.launches = 0
