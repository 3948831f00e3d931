"""Attention kernels: forward (prefill), ragged forward (chunked prefill),
split-KV decode over a linear cache and over a page pool, and the
multi-token extend over a page pool (the speculative verify), each over a
bf16 or an 8-bit (int8, e4m3) cache; and the 8-bit quantizers. The modules
are not re-exported here, so `ops.flash_attention` names the module (and
its `_fwd.launches` counter), not the function; the functions the kernel
modules' names do not shadow are (`k_max_norm`, the cacheable half of
stable="auto"'s bound, and the dense 8-bit forward)."""

from flashattention_kernel_project_tpu_torch.ops import (  # noqa: F401
    flash_attention,
    flash_decode,
    paged_decode,
    quant,
    softmax,
)
from flashattention_kernel_project_tpu_torch.ops.flash_attention import (  # noqa: F401
    flash_attention_kv_quant,
    flash_attention_kv_quant_with_lse,
    k_max_norm,
)
