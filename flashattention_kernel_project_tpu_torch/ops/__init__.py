"""Attention kernels: forward (prefill) and split-KV decode. The modules
are not re-exported here, so `ops.flash_attention` names the module (and
its `_fwd.launches` counter), not the function."""

from flashattention_kernel_project_tpu_torch.ops import (  # noqa: F401
    flash_attention,
    flash_decode,
    softmax,
)
