"""Error metrics as assertions (numpy only).

Counterpart of flashattention_kernel_project_tpu/utils/testing.py: the
reference's two verification metrics, max-abs-diff for GEMMs and relative
L2 for attention; the numerics gate is <= 1e-2 max-abs against the fp32
oracle at matching bit-width (BASELINE.md).
"""

from __future__ import annotations

import numpy as np


def max_abs_diff(actual, expected) -> float:
    return float(np.max(np.abs(np.asarray(actual, np.float64)
                               - np.asarray(expected, np.float64))))


def rel_l2(actual, expected) -> float:
    a = np.asarray(actual, np.float64)
    e = np.asarray(expected, np.float64)
    denom = np.linalg.norm(e.ravel())
    return float(np.linalg.norm((a - e).ravel()) / max(denom, 1e-30))


def assert_max_abs(actual, expected, tol: float = 1e-2, msg: str = ""):
    d = max_abs_diff(actual, expected)
    assert d <= tol, f"max-abs-diff {d:.3e} > {tol:.1e} {msg}"


def assert_rel_l2(actual, expected, tol: float = 1e-2, msg: str = ""):
    d = rel_l2(actual, expected)
    assert d <= tol, f"rel-L2 {d:.3e} > {tol:.1e} {msg}"
