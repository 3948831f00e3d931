"""The port's `utils.platform.backend` against the JAX package's: the same
name for the same platform, "cpu" where there is no card (the tests run
with JAX_PLATFORMS=cpu), "gpu" where CUDA is available."""

import os
import subprocess
import sys

import jax
import torch

from flashattention_kernel_project_tpu.utils import platform as jplatform
from flashattention_kernel_project_tpu_torch.utils import platform


def test_backend_names_the_platform_as_jax_does():
    if torch.cuda.is_available():
        assert platform.backend() == "gpu"
        return
    assert platform.backend() == "cpu"
    if os.environ.get("JAX_PLATFORMS") == "cpu":
        assert platform.backend() == jplatform.backend() == jax.default_backend()


def test_backend_imports_no_jax():
    """backend() needs torch alone: a fresh interpreter that imports the
    port's platform module and calls it has loaded no JAX module."""
    code = ("import sys\n"
            "from flashattention_kernel_project_tpu_torch.utils import platform\n"
            "print(platform.backend(), any(m == 'jax' or m.startswith('jax.') "
            "for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], check=True, capture_output=True,
                         text=True, timeout=300,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.stdout.split() == [platform.backend(), "False"]
