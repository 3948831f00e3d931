"""Device checks, retries, error metrics, numpy oracles and the benchmark
harness. Every public name of the JAX package's `utils` is here, apart
from the TPU's own (`default_interpret`, `has_tpu`, `tpu_peak_flops`,
`tpu_hbm_bandwidth`: `platform` holds the H100's peaks, `peak_flops`,
`hbm_bandwidth`, `require_hopper` and `card_label` instead)."""

from flashattention_kernel_project_tpu_torch.utils import (  # noqa: F401
    benchmarking,
    health,
    oracles,
    platform,
    testing,
)
from flashattention_kernel_project_tpu_torch.utils.benchmarking import (  # noqa: F401
    BenchResult,
    benchmark,
    benchmark_chained,
)
from flashattention_kernel_project_tpu_torch.utils.testing import (  # noqa: F401
    assert_max_abs,
    assert_rel_l2,
    max_abs_diff,
    rel_l2,
)
