"""The GQA decoder (dense or Mixture-of-Experts, with its expert-parallel
form), its training step and tensor-parallel layout, checkpoints (sharded
ones through torch.distributed.checkpoint), the KV-cache engine and the
serving scheduler. Every public name of the JAX package's `models` is
here."""

from flashattention_kernel_project_tpu_torch.models import (  # noqa: F401
    checkpoint,
    convert,
    engine,
    moe,
    serving,
    transformer,
)
from flashattention_kernel_project_tpu_torch.models.checkpoint import (  # noqa: F401
    restore_checkpoint,
    save_checkpoint,
)
from flashattention_kernel_project_tpu_torch.models.engine import (  # noqa: F401
    KVCache,
    decode_step,
    decode_step_paged,
    decode_steps,
    extend,
    fuse_decode_params,
    generate,
    init_cache,
    init_paged_cache,
    paged_insert,
    prefill,
    quantize_decode_params,
    speculative_accept,
    speculative_generate,
)
from flashattention_kernel_project_tpu_torch.models.moe import (  # noqa: F401
    MoEConfig,
    init_moe_params,
    make_ep_moe,
    moe_ffn,
    moe_param_shardings,
)
from flashattention_kernel_project_tpu_torch.models.transformer import (  # noqa: F401
    TransformerConfig,
    apply_rope,
    forward,
    init_params,
    loss_fn,
    param_shardings,
    rms_norm,
    rope_tables,
    sgd_train_step,
)
