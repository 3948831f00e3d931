"""The GQA decoder, its training step, checkpoints, the KV-cache engine
and the serving scheduler."""

from flashattention_kernel_project_tpu_torch.models import (  # noqa: F401
    checkpoint,
    convert,
    engine,
    serving,
    transformer,
)
from flashattention_kernel_project_tpu_torch.models.checkpoint import (  # noqa: F401
    restore_checkpoint,
    save_checkpoint,
)
from flashattention_kernel_project_tpu_torch.models.transformer import (  # noqa: F401
    loss_fn,
    sgd_train_step,
)
