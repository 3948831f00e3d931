"""Kernels: the GEMM ladder (tiled, batched, fused-epilogue and
softmax-epilogue products, the latter also in its resident fixed-max form,
and the 8-bit GEMMs: weight-only int8 and e4m3, int8 x int8), the row
softmax and the online-softmax state machine; attention: forward
(prefill), ragged forward (chunked prefill), split-KV decode over a linear
cache and over a page pool, the streaming decode (a double-buffered copy
pipeline), and the multi-token extend over a page pool (the speculative
verify), each over a bf16 or an 8-bit (int8, e4m3) cache; and the 8-bit
quantizers. The kernel modules are not re-exported here, so
`ops.flash_attention` names the module (and its `_fwd.launches` counter),
not the function, and `ops.softmax` the module whose `softmax` is the row
softmax; the functions the module names do not shadow are (the GEMMs, the
8-bit GEMMs, `streaming_decode`, the state machine, `k_max_norm`, the
cacheable half of stable="auto"'s bound, and the dense 8-bit forward)."""

from flashattention_kernel_project_tpu_torch.ops import (  # noqa: F401
    flash_attention,
    flash_decode,
    gemm,
    paged_decode,
    probes,
    quant,
    softmax,
    streaming,
)
from flashattention_kernel_project_tpu_torch.ops.gemm import (  # noqa: F401
    batched_matmul,
    batched_matmul_softmax_epilogue,
    matmul,
    matmul_bf16,
    matmul_fused_epilogue,
    matmul_xla,
)
from flashattention_kernel_project_tpu_torch.ops.quant import (  # noqa: F401
    dequantize_fp8,
    dequantize_int8,
    matmul_fp8_weights,
    matmul_int8,
    matmul_int8_weights,
    quantize_fp8,
    quantize_fp8_weights,
    quantize_int8,
    quantize_kv,
)
from flashattention_kernel_project_tpu_torch.ops.streaming import (  # noqa: F401
    streaming_decode,
)
from flashattention_kernel_project_tpu_torch.ops.softmax import (  # noqa: F401
    SoftmaxState,
    finalize,
    init_state,
    merge,
    online_softmax_reference,
    tile_state,
)
from flashattention_kernel_project_tpu_torch.ops.flash_attention import (  # noqa: F401
    flash_attention_kv_quant,
    flash_attention_kv_quant_with_lse,
    flash_attention_ragged,
    flash_attention_ragged_kv_quant,
    flash_attention_with_lse,
    k_max_norm,
)
from flashattention_kernel_project_tpu_torch.ops.flash_decode import (  # noqa: F401
    flash_decode_fp8,
    flash_decode_int8,
    merge_partials,
)
from flashattention_kernel_project_tpu_torch.ops.paged_decode import (  # noqa: F401
    PagePool,
    paged_append,
    paged_append_chunk,
    paged_append_chunk_quant,
    paged_append_quant,
    paged_flash_decode,
    paged_flash_decode_quant,
    paged_flash_extend,
)
