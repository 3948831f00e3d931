"""Native host runtime: the continuous-batching core and the token loader."""

from flashattention_kernel_project_tpu_torch.runtime import data, native  # noqa: F401
from flashattention_kernel_project_tpu_torch.runtime.data import (  # noqa: F401
    TokenLoader,
    write_token_file,
)
