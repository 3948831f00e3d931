"""Error metrics as assertions (numpy only).

Counterpart of flashattention_kernel_project_tpu/utils/testing.py, cut to
what the port's tests and chip_smoke.py use.
"""

from __future__ import annotations

import numpy as np


def rel_l2(actual, expected) -> float:
    a = np.asarray(actual, np.float64)
    e = np.asarray(expected, np.float64)
    denom = np.linalg.norm(e.ravel())
    return float(np.linalg.norm((a - e).ravel()) / max(denom, 1e-30))


def assert_rel_l2(actual, expected, tol: float = 1e-2, msg: str = ""):
    d = rel_l2(actual, expected)
    assert d <= tol, f"rel-L2 {d:.3e} > {tol:.1e} {msg}"
