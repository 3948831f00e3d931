"""Parameters from the JAX package's layout.

The port keeps the JAX parameter tree's names, shapes and [in, out] weight
layout (models/transformer.py), so converting is a copy of each leaf. This
covers `init_params` trees and `fuse_decode_params` output alike. The input
is the tree with its leaves already turned into numpy arrays (for example
jax.tree.map(np.asarray, params)), so this module needs no JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaf(x, device) -> torch.Tensor:
    a = np.array(x)  # a writable copy: JAX hands out read-only buffers
    if a.dtype.name == "bfloat16":  # ml_dtypes.bfloat16: no numpy-native type
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree, device) -> dict:
    """Nested dict of numpy arrays (embed, rms_final, layers.* stacked on a
    leading [L] axis, or the fused decode layout) -> the same dict of
    tensors on `device`, dtypes kept."""
    if isinstance(tree, dict):
        return {name: params_from_jax(sub, device) for name, sub in tree.items()}
    return _leaf(tree, device)
