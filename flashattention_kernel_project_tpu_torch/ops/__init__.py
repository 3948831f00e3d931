"""Attention kernels: forward (prefill), ragged forward (chunked prefill),
split-KV decode over a linear cache and over a page pool, and the
multi-token extend over a page pool (the speculative verify). The modules
are not re-exported here, so `ops.flash_attention` names the module (and
its `_fwd.launches` counter), not the function."""

from flashattention_kernel_project_tpu_torch.ops import (  # noqa: F401
    flash_attention,
    flash_decode,
    paged_decode,
    softmax,
)
