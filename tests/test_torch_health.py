"""The port's liveness probe (utils/health.py::device_healthcheck), as
tests/test_health.py runs the JAX package's, on the CPU."""

import torch

from flashattention_kernel_project_tpu_torch.utils import health


def test_healthcheck_ok_on_cpu():
    r = health.device_healthcheck(device="cpu")
    assert r["ok"], r
    assert r["latency_s"] < 30
    assert r["device"] == "cpu" and "error" not in r


def test_healthcheck_reports_a_failure_without_raising():
    r = health.device_healthcheck(device="no-such-device")
    assert not r["ok"] and "error" in r and r["device"] == "unknown"


def test_healthcheck_reports_a_missed_deadline(monkeypatch):
    import threading

    release = threading.Event()
    real_ones = torch.ones

    def wedged(*args, **kwargs):
        release.wait(5)
        return real_ones(*args, **kwargs)

    monkeypatch.setattr(torch, "ones", wedged)
    try:
        r = health.device_healthcheck(timeout_s=0.2, device="cpu")
    finally:
        release.set()
    assert not r["ok"] and "exceeded" in r["error"]
