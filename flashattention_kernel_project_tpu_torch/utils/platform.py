"""Device checks and the H100's published peaks.

Counterpart of flashattention_kernel_project_tpu/utils/platform.py. The JAX
package picks interpret mode when no TPU is attached; the port has no such
switch: a kernel wrapper takes its plain PyTorch version only for CPU
tensors, and a measurement that finds no Hopper card fails here.
"""

from __future__ import annotations

import subprocess

import torch

# NVIDIA H100 SXM, dense rates at the 700 W limit (data sheet and the
# Hopper architecture white paper). A card set below 700 W runs slower under
# load: state its power limit (card_label) beside every number.
H100_SMS = 132
H100_BF16_FLOPS = 989e12
H100_FP8_FLOPS = 1979e12
H100_TF32_FLOPS = 495e12
H100_FP32_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12
H100_SMEM_PER_BLOCK = 232_448  # bytes, as dynamic shared memory


def require_hopper(device: int = 0) -> str:
    """Raise unless CUDA is available and `device` is compute capability
    9.0 (Hopper, the sm_90a build target). Returns the device name."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's kernels need a Hopper GPU")
    cap = torch.cuda.get_device_capability(device)
    name = torch.cuda.get_device_name(device)
    if cap != (9, 0):
        raise RuntimeError(
            f"{name} has compute capability {cap}; the kernels are built "
            "for sm_90a and need (9, 0)"
        )
    return name


def card_label() -> str:
    """The card's name and power limit, as nvidia-smi reports them
    (one line per card), e.g. "NVIDIA H100 80GB HBM3, 700.00 W"."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()
