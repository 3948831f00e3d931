"""Device checks, retries, error metrics and numpy oracles. Every public
name of the JAX package's `utils` is here, apart from the TPU's own
(`default_interpret`, `has_tpu`, `tpu_peak_flops`, `tpu_hbm_bandwidth`:
`platform` holds the H100's peaks, `require_hopper` and `card_label`
instead) and the benchmark harness (`benchmarking`, `BenchResult`,
`benchmark`, `benchmark_chained`; ROADMAP A.5)."""

from flashattention_kernel_project_tpu_torch.utils import (  # noqa: F401
    health,
    oracles,
    platform,
    testing,
)
from flashattention_kernel_project_tpu_torch.utils.testing import (  # noqa: F401
    assert_max_abs,
    assert_rel_l2,
    max_abs_diff,
    rel_l2,
)
