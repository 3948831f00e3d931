"""Parameters from the JAX package's layout.

The port keeps the JAX parameter tree's names, shapes and [in, out] weight
layout (models/transformer.py), so converting is a copy of each leaf. This
covers `init_params` trees, `fuse_decode_params` and
`quantize_decode_params` output alike (int8 and float8_e4m3fn leaves
included), and the arrays of an 8-bit KV cache. The input
is the tree with its leaves already turned into numpy arrays (for example
jax.tree.map(np.asarray, params)), so this module needs no JAX.
"""

from __future__ import annotations

import numpy as np
import torch


# ml_dtypes' types, which numpy does not know: their bits as an unsigned
# integer of the same width, viewed as the torch dtype
_BITS = {"bfloat16": (np.uint16, torch.bfloat16),
         "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def _leaf(x, device) -> torch.Tensor:
    a = np.array(x)  # a writable copy: JAX hands out read-only buffers
    if a.dtype.name in _BITS:
        bits, dtype = _BITS[a.dtype.name]
        return torch.from_numpy(a.view(bits)).view(dtype).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree, device) -> dict:
    """Nested dict of numpy arrays (embed, rms_final, layers.* stacked on a
    leading [L] axis, or the fused decode layout) -> the same dict of
    tensors on `device`, dtypes kept."""
    if isinstance(tree, dict):
        return {name: params_from_jax(sub, device) for name, sub in tree.items()}
    return _leaf(tree, device)
