"""The port's `utils.benchmarking` against the JAX package's, on the CPU.

BenchResult's numbers and report with JAX's platform peaks replaced, in
the test, by the H100's; `benchmark` and `benchmark_chained` fed one
scripted clock in both packages (the same iters, mean and min in every
pilot case); the port's chain feeding its output back; a CPU call never
touching torch.cuda; `_trace_device_us` on gzipped chrome traces the test
writes and on a real CPU profile."""

import dataclasses
import gzip
import inspect
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import pytest
import torch

from flashattention_kernel_project_tpu.utils import benchmarking as jbench
from flashattention_kernel_project_tpu.utils import platform as jplatform
from flashattention_kernel_project_tpu_torch.utils import benchmarking as bench
from flashattention_kernel_project_tpu_torch.utils import platform

# the H100 SXM's dense peaks (NVIDIA's data sheet): written out here, apart
# from the module under test
H100_PEAKS = {"bf16": 989e12, "int8": 1979e12, "fp8": 1979e12,
              "fp32": 989e12 / 6, "f32": 989e12 / 6, "float32": 989e12 / 6,
              "fp16": 989e12}
H100_HBM = 3.35e12
DTYPES = ["bf16", "int8", "fp8", "fp32"]


@pytest.mark.parametrize("dtype", sorted(H100_PEAKS))
def test_peak_flops_by_dtype(dtype):
    assert platform.peak_flops(dtype) == pytest.approx(H100_PEAKS[dtype], rel=1e-15)
    assert platform.hbm_bandwidth() == H100_HBM
    assert platform.peak_flops() == H100_PEAKS["bf16"]


@pytest.fixture
def h100_jax_peaks(monkeypatch):
    """JAX's platform peaks, for this test only, the H100's."""
    monkeypatch.setattr(jplatform, "tpu_peak_flops",
                        lambda dtype="bf16": H100_PEAKS.get(dtype, 989e12))
    monkeypatch.setattr(jplatform, "tpu_hbm_bandwidth", lambda: H100_HBM)


@pytest.mark.parametrize("flops", [None, 68_719_476_736])
@pytest.mark.parametrize("nbytes", [None, 33_554_432])
@pytest.mark.parametrize("dtype", DTYPES)
def test_bench_result_matches_jax(h100_jax_peaks, flops, nbytes, dtype):
    for mean_ms, min_ms in ((0.2121, 0.2098), (0.0091, 0.0089), (37.5, 12.0)):
        fields = dict(name="headline", mean_ms=mean_ms, min_ms=min_ms, iters=20,
                      flops=flops, bytes_accessed=nbytes)
        mine, ref = bench.BenchResult(**fields), jbench.BenchResult(**fields)
        for attr in ("tflops", "gbps"):
            a, b = getattr(mine, attr), getattr(ref, attr)
            assert (a is None) == (b is None) and (a is None) == (
                (flops if attr == "tflops" else nbytes) is None)
            if a is not None:
                assert a == pytest.approx(b, rel=1e-12)
        fa, fb = mine.roofline_fraction(dtype), ref.roofline_fraction(dtype)
        assert (fa is None) == (fb is None) == (flops is None and nbytes is None)
        if fa is not None:
            assert fa == pytest.approx(fb, rel=1e-12)
        assert mine.report(dtype) == ref.report(dtype)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)


def test_roofline_fraction_is_the_bound_over_the_time():
    """The larger fraction: the least time the card could take over the
    time measured (chip_smoke.py's bound_ms / ms)."""
    flops, nbytes, ms = 4 * 8 * 16 * 2048 * 128, 8_000_000, 0.0091
    r = bench.BenchResult("decode", ms, ms, 1, flops=flops, bytes_accessed=nbytes)
    bound_ms = max(flops / 989e12, nbytes / H100_HBM) * 1e3
    assert r.roofline_fraction() == pytest.approx(bound_ms / ms, rel=1e-12)


def test_public_signatures_match_jax():
    for fn in ("benchmark", "benchmark_chained", "benchmark_device", "capture_trace"):
        mine = inspect.signature(getattr(bench, fn)).parameters
        ref = inspect.signature(getattr(jbench, fn)).parameters
        assert [(p.name, p.kind, p.default) for p in mine.values()] == [
            (p.name, p.kind, p.default) for p in ref.values()], fn
    assert ([(f.name, f.default) for f in dataclasses.fields(bench.BenchResult)]
            == [(f.name, f.default) for f in dataclasses.fields(jbench.BenchResult)])


class ScriptedClock:
    """perf_counter for both packages: each timed rep reads 0.0 at its
    start and its scripted duration at its end, so that each difference is
    the duration exactly."""

    def __init__(self, durations):
        self.durations = list(durations)
        self.started = False
        self.calls = 0

    def perf_counter(self):
        self.calls += 1
        self.started = not self.started
        return 0.0 if self.started else self.durations.pop(0)


def _with_clock(monkeypatch, module, durations):
    clock = ScriptedClock(durations)
    monkeypatch.setattr(module, "time", types.SimpleNamespace(
        perf_counter=clock.perf_counter))
    return clock


@pytest.mark.parametrize("iters", [1, 5])
def test_benchmark_scripted_clock_matches_jax(monkeypatch, iters):
    durations = [0.0125, 0.0101, 0.0133, 0.0099, 0.011][:iters]
    jfn = jax.jit(lambda x: x * 2.0)
    jclock = _with_clock(monkeypatch, jbench, durations)
    ref = jbench.benchmark(jfn, jnp.ones(8), name="k", warmup=2, iters=iters,
                           flops=100)
    pclock = _with_clock(monkeypatch, bench, durations)
    mine = bench.benchmark(lambda x: x * 2.0, torch.ones(8), name="k", warmup=2,
                           iters=iters, flops=100)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert jclock.calls == pclock.calls == 2 * iters
    assert not jclock.durations and not pclock.durations


# pilot cases: (the pilot reps' durations, n2 reps first, then n1; the
# measure reps' durations, n1 first, then n2; min_delta_s; the n2 - n1 the
# rule must pick for n_pair (20, 120))
_MEASURE = [0.0021, 0.002, 0.0022, 0.0023, 0.002, 0.0024,
            0.0511, 0.0502, 0.0507, 0.0509, 0.0505, 0.0515]
PILOTS = {
    # pilot 0.009 over 100 iterations -> need int(0.05 / 9e-5) = 555
    "scaled": ([0.012, 0.011, 0.002, 0.0021], 0.05, 555),
    # a pilot <= 0, taken again with 3 reps: 0.0105 - 0.0011 -> 531
    "retried": ([0.001, 0.0012, 0.002, 0.0025,
                 0.0105, 0.011, 0.012, 0.0011, 0.0013, 0.0012], 0.05, 531),
    # <= 0 twice: n2 grows by 20 spans
    "grown": ([0.001, 0.001, 0.002, 0.002,
               0.001, 0.001, 0.001, 0.002, 0.002, 0.002], 0.05, 2000),
    # a pilot of 1e-7 asks for 50e6 iterations: capped at 100 spans
    "capped": ([0.0020001, 0.0030001, 0.002, 0.003], 5.0, 10000),
    # need <= span: n2 stays
    "kept": ([0.5, 0.6, 0.1, 0.1], 0.05, 100),
}


@pytest.mark.parametrize("case", sorted(PILOTS))
def test_benchmark_chained_scripted_clock_matches_jax(monkeypatch, case):
    pilot, min_delta_s, span = PILOTS[case]
    durations = pilot + _MEASURE
    kw = dict(name="chain", n_pair=(20, 120), reps=6, flops=7, bytes_accessed=9,
              min_delta_s=min_delta_s)
    jclock = _with_clock(monkeypatch, jbench, durations)
    ref = jbench.benchmark_chained(lambda x: x + 1.0, jnp.zeros(4), **kw)
    calls = []

    def count(x):
        calls.append(1)
        return x + 1.0

    pclock = _with_clock(monkeypatch, bench, durations)
    mine = bench.benchmark_chained(count, torch.zeros(4), **kw)
    assert mine.iters == ref.iters == span
    assert mine.mean_ms == ref.mean_ms and mine.min_ms == ref.min_ms
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert jclock.calls == pclock.calls == 2 * len(durations)
    assert not pclock.durations
    # one warm iteration, the pilot's and the measure's, each rep chained
    n1, n2 = 20, 20 + span
    pilot_iters = 2 * 120 + 2 * 20 + (3 * 120 + 3 * 20 if len(pilot) == 10 else 0)
    assert len(calls) == 1 + pilot_iters + 6 * (n1 + n2)


@pytest.mark.parametrize("n", [0, 1, 7, 64])
def test_chain_feeds_the_output_back(n):
    x = torch.arange(5, dtype=torch.float64)
    run = bench._Chain(lambda a: a + 1, (x,), bench._feed_first, 1)
    assert torch.equal(run(n)[0], x + n)
    assert torch.equal(x, torch.arange(5, dtype=torch.float64))  # not in place
    # a chain of the caller's: the output replaces the second argument
    y = torch.zeros(3)
    run = bench._Chain(lambda a, b: a + b, (torch.ones(3), y),
                       lambda out, a: (a[0], out), 1)
    a, b = run(n)
    assert torch.equal(a, torch.ones(3)) and torch.equal(b, torch.full((3,), float(n)))


def test_cpu_calls_never_touch_cuda(monkeypatch, tmp_path):
    def refuse(*a, **k):
        raise AssertionError("a CPU call reached torch.cuda")

    for attr in ("synchronize", "Stream", "CUDAGraph", "Event", "graph",
                 "current_stream"):
        monkeypatch.setattr(torch.cuda, attr, refuse)
    x = torch.randn(16, 16)
    r = bench.benchmark(torch.mm, x, x, warmup=1, iters=3)
    assert r.iters == 3 and r.mean_ms > 0
    r = bench.benchmark_chained(lambda a: a * 0.5, x, n_pair=(2, 6), reps=2,
                                min_delta_s=1e-4)
    assert r.iters >= 4
    assert bench.capture_trace(torch.mm, x, x, trace_dir=str(tmp_path), iters=2) \
        == str(tmp_path)
    with pytest.raises(ValueError, match="no device event"):
        bench._trace_device_us(str(tmp_path))
    with pytest.raises(ValueError, match="CUDA tensors"):
        bench.benchmark_device(torch.mm, x, x)


def _write_trace(path, events, mtime=None):
    with gzip.open(path, "wt") as f:
        json.dump({"schemaVersion": 1, "traceEvents": events}, f)
    if mtime is not None:
        os.utime(path, (mtime, mtime))


HOST = [
    {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 10.0, "dur": 500.0},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 11.0,
     "dur": 3.0},
    {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}},
]
DEVICE = [
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 90.0, "dur": 2.0},
    {"ph": "X", "cat": "kernel", "name": "void flash_decode_sm90_kernel<128>()",
     "ts": 100.0, "dur": 10.0},
    {"ph": "X", "cat": "kernel", "name": "void flash_decode_sm90_kernel<128>()",
     "ts": 120.0, "dur": 5.5},
    {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "ts": 130.0,
     "dur": 1.0},
    {"ph": "i", "cat": "kernel", "name": "an instant, not an op", "ts": 500.0},
    # an annotation on the card's timeline spans more than its kernels
    {"ph": "X", "cat": "gpu_user_annotation", "name": "range", "ts": 0.0,
     "dur": 1000.0},
]


def test_trace_device_span_and_per_op(tmp_path):
    _write_trace(tmp_path / "old.pt.trace.json.gz", HOST + DEVICE[1:2], mtime=1e9)
    sub = tmp_path / "plugins"
    sub.mkdir()
    _write_trace(sub / "new.pt.trace.json.gz", HOST + DEVICE, mtime=2e9)
    total, per_op = bench._trace_device_us(str(tmp_path))
    assert total == pytest.approx(131.0 - 90.0)
    assert per_op == {"Memcpy HtoD": 2.0,
                      "void flash_decode_sm90_kernel<128>()": 15.5,
                      "Memset (Device)": 1.0}


def test_trace_without_device_events_is_refused(tmp_path):
    _write_trace(tmp_path / "cpu.pt.trace.json.gz", HOST + DEVICE[-2:])
    with pytest.raises(ValueError, match="no device event"):
        bench._trace_device_us(str(tmp_path))
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        bench._trace_device_us(str(empty))
    (empty / "a.json").write_text("{}")  # not a gzipped trace
    with pytest.raises(FileNotFoundError):
        bench._trace_device_us(str(empty))


def test_benchmarking_imports_no_jax():
    """A fresh interpreter that imports the port's harness (and the utils
    namespace that exports it) has loaded no JAX module."""
    code = ("import sys\n"
            "from flashattention_kernel_project_tpu_torch.utils import benchmarking\n"
            "from flashattention_kernel_project_tpu_torch.utils import BenchResult\n"
            "print(any(m == 'jax' or m.startswith('jax.') or "
            "m.startswith('flashattention_kernel_project_tpu.') for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], check=True, capture_output=True,
                         text=True, timeout=300,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.stdout.split() == ["False"]
