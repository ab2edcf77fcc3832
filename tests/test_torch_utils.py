"""PyTorch port: the timers, RateLoop, the device trace helpers and the
polynomial root solvers against the JAX package's."""

import json
import time

import numpy as np
import pytest
import torch

from nautilus_tpu.utils import polynomial as jpoly
from nautilus_tpu.utils import timer as jtimer
from nautilus_tpu_torch.utils import polynomial as tpoly
from nautilus_tpu_torch.utils import timer as ttimer


def test_function_timer_prints_like_jax():
    got, want = [], []
    with ttimer.FunctionTimer("unit", printer=got.append) as t:
        time.sleep(0.002)
    with jtimer.FunctionTimer("unit", printer=want.append):
        pass
    assert t.elapsed_ms >= 2.0
    assert got[0].split(" took ")[0] == want[0].split(" took ")[0] == "unit"
    assert got[0].endswith(" ms") and want[0].endswith(" ms")


def test_cumulative_timer_reports_like_jax():
    reports = []
    for mod in (ttimer, jtimer):
        t = mod.CumulativeFunctionTimer(f"cumul-{mod.__name__}")
        assert t.mean_ms == 0.0
        for _ in range(3):
            with t.scope():
                pass
        assert t.invocations == 3 and t.total_s >= 0.0
        reports.append(t.report().split(":", 1)[1])
        lines = []
        mod.CumulativeFunctionTimer.report_all(printer=lines.append)
        assert any(line.startswith(t.name) for line in lines)
    assert reports[0].endswith("mean over 3 invocations")
    assert reports[1].endswith("mean over 3 invocations")


def test_rate_loop_paces_and_restarts_after_a_slow_pass():
    with pytest.raises(ValueError):
        ttimer.RateLoop(0)
    loop = ttimer.RateLoop(200.0)
    t0 = time.perf_counter()
    for _ in range(5):
        loop.sleep()
    assert time.perf_counter() - t0 >= 5 * 0.005 * 0.9
    time.sleep(0.02)              # an over-long pass: no burst of catch-up
    loop.sleep()
    t1 = time.perf_counter()
    loop.sleep()
    assert time.perf_counter() - t1 >= 0.005 * 0.9
    assert loop.period_s == jtimer.RateLoop(200.0).period_s


def test_profile_to_writes_a_chrome_trace_with_named_spans(tmp_path):
    with ttimer.profile_to(tmp_path / "prof") as prof:
        with ttimer.span("nautilus-span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    trace = tmp_path / "prof" / ttimer.TRACE_FILE
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("name") == "nautilus-span" for e in events)
    # No card: the card was busy for no time, read from the file or from
    # the session in memory.
    assert ttimer.device_busy_s(trace) == 0.0
    assert ttimer.device_busy_s(prof) == 0.0
    assert any(e.is_user_annotation()
               for e in prof.profiler.kineto_results.events())


def test_profile_to_without_a_directory_writes_nothing(tmp_path,
                                                       monkeypatch):
    monkeypatch.chdir(tmp_path)
    with ttimer.profile_to() as prof:
        torch.ones(8) * 2
    assert list(tmp_path.iterdir()) == []
    assert len(prof.profiler.kineto_results.events()) > 0


def test_device_busy_s_takes_the_union_of_the_cards_intervals(tmp_path):
    events = [{"ph": "X", "cat": "kernel", "ts": 0, "dur": 10},
              {"ph": "X", "cat": "kernel", "ts": 5, "dur": 10},    # overlaps
              {"ph": "X", "cat": "kernel", "ts": 6, "dur": 2},     # inside
              {"ph": "X", "cat": "kernel", "ts": 30, "dur": 5},
              {"ph": "X", "cat": "gpu_memcpy", "ts": 20, "dur": 4},
              {"ph": "X", "cat": "gpu_memset", "ts": 22, "dur": 4},
              {"ph": "X", "cat": "gpu_user_annotation", "ts": 0, "dur": 99},
              {"ph": "X", "cat": "cpu_op", "ts": 0, "dur": 100},
              {"ph": "i", "cat": "kernel", "ts": 50}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert ttimer.device_busy_s(path) == pytest.approx(26e-6)


@pytest.mark.parametrize("coeffs", [
    (1.0, -3.0, 2.0), (1.0, 2.0, 1.0), (1.0, 0.0, 1.0), (0.0, 2.0, -4.0),
    (0.0, 0.0, 1.0), (2.0, 1e8, 1.0), (-3.0, 0.5, 7.25)])
def test_solve_quadratic_matches_jax(coeffs):
    assert tpoly.solve_quadratic(*coeffs) == jpoly.solve_quadratic(*coeffs)


@pytest.mark.parametrize("coeffs", [
    (1.0, -6.0, 11.0, -6.0), (1.0, 0.0, 0.0, -8.0), (1.0, -3.0, 3.0, -1.0),
    (0.0, 1.0, -3.0, 2.0), (2.0, 0.0, -2.0, 0.0), (1.0, 1.0, 1.0, 1.0),
    (-0.5, 2.0, 0.25, -1.0)])
def test_solve_cubic_matches_jax(coeffs):
    got = tpoly.solve_cubic(*coeffs)
    assert got == jpoly.solve_cubic(*coeffs)
    for r in got:
        a, b, c, d = coeffs
        assert abs(((a * r + b) * r + c) * r + d) < 1e-6 * max(
            1.0, abs(r) ** 3)
    assert got == sorted(got)


def test_random_cubics_match_jax():
    rng = np.random.default_rng(0)
    for a, b, c, d in rng.normal(size=(200, 4)):
        assert tpoly.solve_cubic(a, b, c, d) == jpoly.solve_cubic(a, b, c, d)
