"""flashattention_kernel_project_tpu_torch: the port of
flashattention_kernel_project_tpu from JAX on a TPU to PyTorch and CUDA on
an NVIDIA H100.

The JAX package stays beside it as the reference; module names follow it:
  ops/      attention kernels: wrappers, plain PyTorch versions, and the
            loader that builds csrc/*.cu (hand-written CUDA for sm_90a)
  models/   the GQA decoder, its training step and checkpoints, the
            KV-cache engine and the serving scheduler
  runtime/  the native continuous-batching core and token loader (ctypes)
  utils/    device checks and H100 peaks, retries, error metrics, oracles

This package imports torch and never jax. Kernels build at first use, not
at import.
"""

__version__ = "0.1.0"

from flashattention_kernel_project_tpu_torch import models, ops, runtime, utils  # noqa: F401
from flashattention_kernel_project_tpu_torch.models.transformer import (  # noqa: F401
    TransformerConfig,
    init_params,
    forward,
    loss_fn,
    sgd_train_step,
    rms_norm,
    rope_tables,
    apply_rope,
)
from flashattention_kernel_project_tpu_torch.models.engine import (  # noqa: F401
    KVCache,
    init_cache,
    prefill,
    decode_step,
    decode_steps,
    fuse_decode_params,
    generate,
    speculative_accept,
    speculative_generate,
)
from flashattention_kernel_project_tpu_torch.models.checkpoint import (  # noqa: F401
    restore_checkpoint,
    save_checkpoint,
)
from flashattention_kernel_project_tpu_torch.runtime.data import (  # noqa: F401
    TokenLoader,
    write_token_file,
)
from flashattention_kernel_project_tpu_torch.ops.flash_attention import (  # noqa: F401
    flash_attention,
    flash_attention_with_lse,
)
from flashattention_kernel_project_tpu_torch.ops.flash_decode import (  # noqa: F401
    flash_decode,
    merge_partials,
)
