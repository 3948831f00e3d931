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
H100_INT8_OPS = 1979e12  # dense int8 tensor-core operations a second
H100_TF32_FLOPS = 495e12
H100_FP32_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12
H100_SMEM_PER_BLOCK = 232_448  # bytes, as dynamic shared memory
H100_SMEM_PER_SM = 233_472  # bytes an SM gives its blocks' shared memory
H100_SMEM_RESERVED_PER_BLOCK = 1024  # bytes the system keeps of each block's


def peak_flops(dtype: str = "bf16") -> float:
    """The H100's peak tensor-core operations a second for `dtype`, the
    counterpart of JAX's `tpu_peak_flops`. "fp32" is the effective f32
    product rate: as on the TPU, the port's f32 GEMM
    (`csrc/gemm_f32_sm90.cuh`) runs six bf16 products, so 1/6 of the bf16
    rate is the denominator of the executed path."""
    if dtype == "int8":
        return H100_INT8_OPS
    if dtype == "fp8":
        return H100_FP8_FLOPS
    if dtype in ("fp32", "f32", "float32"):
        return H100_BF16_FLOPS / 6.0
    return H100_BF16_FLOPS


def hbm_bandwidth() -> float:
    """The H100's peak device-memory bytes a second (JAX's
    `tpu_hbm_bandwidth`)."""
    return H100_HBM_BYTES_PER_S


def backend() -> str:
    """JAX's name for the platform the port's kernels run on, as
    `jax.default_backend()` gives it: "gpu" where CUDA is available, else
    "cpu" (where every wrapper takes its plain PyTorch version)."""
    return "gpu" if torch.cuda.is_available() else "cpu"


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
