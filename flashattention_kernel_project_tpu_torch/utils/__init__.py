"""Device checks, retries, error metrics and numpy oracles."""

from flashattention_kernel_project_tpu_torch.utils import (  # noqa: F401
    health,
    oracles,
    platform,
    testing,
)
