"""PyTorch port: the program's tracer (utils/timer: span, tracing, take)
on the 32-pose reverse traversal, on the CPU.

Off, the tracer records nothing and changes nothing; on, its spans nest as
the solver and auto-LC run them, count what the code did, and each span
has a profiler twin on the same clock."""

import dataclasses
import time

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from nautilus_tpu_torch.core.luaconf import load_config_text
from nautilus_tpu_torch.ingest.synthetic import reverse_traversal_problem
from nautilus_tpu_torch.kernels.csm import CSMParams
from nautilus_tpu_torch.loop_closure import matcher
from nautilus_tpu_torch.loop_closure.auto_lc import solve_auto_lc
from nautilus_tpu_torch.solve.solver import Solver
from nautilus_tpu_torch.utils import timer

CFG = """
translation_weight=1
rotation_weight=1
lc_translation_weight=3
lc_rotation_weight=3
lidar_constraint_amount_min=1
lidar_constraint_amount_max=3
outlier_threshold=0.25
max_lidar_range=10
csm_score_threshold=-3.5
keyframe_local_uncertainty_filtering=true
lc_match_window_size=2
accuracy_change_stop_threshold=0.0001
"""
LC_STAGES = ["lc.candidates", "lc.gate", "lc.csm", "lc.resolve"]
LM_PHASES = {"lm.factor", "lm.assemble", "lm.decide"}


@pytest.fixture(autouse=True)
def tracer_off():
    """Every test starts and ends with the tracer off and empty."""
    timer.tracing(False)
    timer.take()
    yield
    timer.tracing(False)
    timer.take()


@pytest.fixture(scope="module")
def built():
    """(config, state, the spans of the problem's build with tracing on)."""
    timer.tracing(True)
    try:
        state, _ = reverse_traversal_problem(3, device="cpu")
    finally:
        timer.tracing(False)
    return load_config_text(CFG), state, timer.take()


def fresh(state):
    return dataclasses.replace(state, solution=state.solution.copy(),
                               lc_factors=[])


def closed_map(cfg, state, linear_solver="auto"):
    """(sweep stats, auto-LC report, closed poses) from a fresh copy."""
    solver = Solver(fresh(state), cfg, linear_solver=linear_solver)
    stats = solver.solve_slam()
    rep = solve_auto_lc(solver, apply=True, verbose=False,
                        csm_params=CSMParams(scan_range=10.0, high_res=0.05))
    return stats, rep, solver.state.solution.copy()


def traced(fn):
    timer.tracing(True)
    try:
        out = fn()
    finally:
        timer.tracing(False)
    return out, timer.take()


def windows_without_walls(stats):
    return [dataclasses.replace(w, wall_s=0.0) for w in stats.windows]


def test_the_problem_build_is_named(built):
    _, _, spans = built
    assert [(s.name, s.parent) for s in spans] == [("preprocess", -1),
                                                   ("problem.build", -1)]


def test_tracing_off_records_nothing_and_opens_no_region(built, monkeypatch):
    cfg, state, _ = built

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert timer.span("a") is timer.span("b")
    closed_map(cfg, state)
    assert timer.take() == []


def test_tracing_changes_no_result(built):
    cfg, state, _ = built
    stats_off, rep_off, x_off = closed_map(cfg, state)
    (stats_on, rep_on, x_on), spans = traced(
        lambda: closed_map(cfg, state))
    assert spans
    np.testing.assert_array_equal(x_on, x_off)
    assert windows_without_walls(stats_on) == windows_without_walls(stats_off)
    assert rep_off.applied and rep_on.applied
    for field in ("candidates", "gated_pairs", "accepted", "csm_engine"):
        assert getattr(rep_on, field) == getattr(rep_off, field), field
    assert windows_without_walls(rep_on.resolve_stats) == \
        windows_without_walls(rep_off.resolve_stats)
    assert len(rep_on.csm_results) == len(rep_off.csm_results)
    for (s, t, score, tf), (s0, t0, score0, tf0) in zip(rep_on.csm_results,
                                                        rep_off.csm_results):
        assert (s, t, score) == (s0, t0, score0)
        np.testing.assert_array_equal(tf, tf0)


@pytest.mark.parametrize("linear_solver", ["band", "dense", "cg"])
def test_spans_nest_and_count_the_lm_steps(built, linear_solver):
    cfg, state, _ = built
    solver = Solver(fresh(state), cfg, linear_solver=linear_solver)
    stats, spans = traced(solver.solve_slam)
    assert solver.last_solver == linear_solver
    names = [s.name for s in spans]
    roots = [i for i, s in enumerate(spans) if s.parent < 0]
    assert [names[i] for i in roots] == ["solve.window"] * len(stats.windows)
    for s in spans:
        assert s.t0_ns <= s.t1_ns
        if s.parent >= 0:
            up = spans[s.parent]
            assert up.t0_ns <= s.t0_ns and s.t1_ns <= up.t1_ns
            want = {"lm.step": "solve.window"}.get(s.name, "lm.step")
            assert up.name == want, (s.name, up.name)
            assert s.name == "lm.step" or s.name in LM_PHASES
    assert names.count("lm.step") == sum(w.iterations for w in stats.windows)
    for w, i in zip(stats.windows, roots):
        steps = [j for j, s in enumerate(spans) if s.parent == i]
        assert len(steps) == w.iterations
        for j in steps:
            assert {s.name for s in spans if s.parent == j} == LM_PHASES


def test_lc_stages_lie_inside_the_call(built):
    cfg, state, _ = built
    solver = Solver(fresh(state), cfg)
    solver.solve_slam()
    t0 = time.time_ns()
    rep, spans = traced(lambda: solve_auto_lc(
        solver, apply=True, verbose=False,
        csm_params=CSMParams(scan_range=10.0, high_res=0.05)))
    t1 = time.time_ns()
    assert rep.applied
    roots = [s for s in spans if s.parent < 0]
    assert [s.name for s in roots] == LC_STAGES
    assert t0 <= roots[0].t0_ns and roots[-1].t1_ns <= t1
    for a, b in zip(roots, roots[1:]):
        assert a.t1_ns <= b.t0_ns
    assert sum(s.t1_ns - s.t0_ns for s in roots) <= t1 - t0
    # The re-solve is one window at the max window size.
    under = [s.name for s in spans
             if s.parent >= 0 and spans[s.parent].name == "lc.resolve"]
    assert under == ["solve.window"]
    gate = [s.name for s in spans
            if s.parent >= 0 and spans[s.parent].name == "lc.gate"]
    assert gate[0] == "lc.gate.build"
    assert set(gate[1:]) == {"lc.gate.factor"}


def test_gate_factorizations_count_the_gauge_groups(built, monkeypatch):
    cfg, state, _ = built
    solver = Solver(fresh(state), cfg)
    solver.solve_slam()
    groups = []
    band = matcher._cross_cov_blocks_band

    def counting(sys, fixed_pose, sources, targets):
        groups.append(fixed_pose)
        return band(sys, fixed_pose, sources, targets)

    monkeypatch.setattr(matcher, "_cross_cov_blocks_band", counting)
    rep, spans = traced(lambda: solve_auto_lc(
        solver, apply=False, verbose=False,
        csm_params=CSMParams(scan_range=10.0, high_res=0.05)))
    assert rep.gated_pairs and len(groups) >= 2
    assert [s.name for s in spans].count("lc.gate.factor") == len(groups)


def user_regions(prof):
    """{name: [(start ns, end ns)]} of the profiler's host annotations."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation() and e.device_type() != DeviceType.CUDA:
            out.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    return {k: sorted(v) for k, v in out.items()}


def test_each_span_has_a_profiler_twin_on_its_clock(built):
    cfg, state, _ = built
    solver = Solver(fresh(state), cfg, linear_solver="band")
    with timer.profile_to() as prof:
        # The session's first region pays the profiler's one-time set-up
        # of this thread between its clock read and the tracer's.
        with torch.profiler.record_function("warm-up"):
            pass
        _, spans = traced(solver.solve_slam)
    regions = user_regions(prof)
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append((s.t0_ns, s.t1_ns))
    assert set(by_name) == {"solve.window", "lm.step"} | LM_PHASES
    # A span reads its clock after its twin opens and before it closes, so
    # on one clock it lies inside the twin.  A thread descheduled between
    # the two reads only widens the twin, so each offset is bounded on one
    # side and their median on both.
    offsets = []
    for name, mine in by_name.items():
        twins = regions[name]
        assert len(twins) == len(mine), name
        for (a0, a1), (b0, b1) in zip(sorted(mine), twins):
            assert a0 - b0 >= -1_000_000 and b1 - a1 >= -1_000_000, name
            offsets += [a0 - b0, b1 - a1]
    assert np.median(offsets) <= 1_000_000


def test_a_profiler_sees_the_spans_with_tracing_off(built):
    cfg, state, _ = built
    solver = Solver(fresh(state), cfg, linear_solver="band")
    with timer.profile_to() as prof:
        with timer.span("outer"):
            stats = solver.solve_slam()
    regions = user_regions(prof)
    assert len(regions["outer"]) == 1
    assert len(regions["solve.window"]) == len(stats.windows)
    assert len(regions["lm.step"]) == sum(w.iterations for w in stats.windows)
    assert timer.take() == []
