"""Native host runtime: the continuous-batching core."""

from flashattention_kernel_project_tpu_torch.runtime import native  # noqa: F401
