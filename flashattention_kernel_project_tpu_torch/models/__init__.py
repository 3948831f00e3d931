"""The GQA decoder, its KV-cache engine and the serving scheduler."""

from flashattention_kernel_project_tpu_torch.models import (  # noqa: F401
    convert,
    engine,
    serving,
    transformer,
)
