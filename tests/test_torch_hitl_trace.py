"""PyTorch port: the curation step's spans (solve/hitl.py), on the CPU.

On the 24-pose office map with poses 12-23 moved 0.3 m in y, one line pair
on the doubled y = -2 wall: with tracing on, the step records one
``hitl.step`` holding one ``hitl.select`` and two ``hitl.solve``, each solve
as many ``lm.step`` spans as its SolveStats counts; with tracing off,
nothing is recorded."""

import numpy as np
import pytest

from nautilus_tpu_torch.core.luaconf import load_config_text
from nautilus_tpu_torch.ingest.synthetic import make_problem
from nautilus_tpu_torch.solve import hitl
from nautilus_tpu_torch.solve.solver import Solver
from nautilus_tpu_torch.utils import timer

CFG = ("translation_weight=1\nrotation_weight=1\n"
       "lidar_constraint_amount_min=1\nlidar_constraint_amount_max=3\n"
       "outlier_threshold=0.25\naccuracy_change_stop_threshold=0.0001\n"
       "hitl_line_width=0.1\nhitl_pose_point_threshold=10\n")
SHIFT = 0.3
LINES = ((2.0, -2.0), (10.0, -2.0), (2.0, -2.0 + SHIFT), (10.0, -2.0 + SHIFT))


@pytest.fixture(autouse=True)
def tracer_off():
    timer.tracing(False)
    timer.take()
    yield
    timer.tracing(False)
    timer.take()


def _swept():
    cfg = load_config_text(CFG)
    state, _ = make_problem(24, "office", num_beams=180, seed=0,
                            odom_noise_trans=0.02, odom_noise_rot=0.008,
                            device="cpu")
    solver = Solver(state, cfg)
    solver.solve_slam()
    state.solution[12:, 1] += SHIFT
    return solver


def _step(solver):
    return hitl.hitl_callback(solver, hitl.HitlSlamInputMsg.from_points(
        *LINES), verbose=False)


def _children(spans, parent):
    return [i for i, s in enumerate(spans) if s.parent == parent]


def test_a_step_records_its_selection_and_two_solves():
    solver = _swept()
    timer.tracing(True)
    try:
        stats = _step(solver)
    finally:
        timer.tracing(False)
    spans = timer.take()
    c = solver.state.hitl_constraints[-1]
    assert c.line_a_poses and c.line_b_poses
    roots = [i for i, s in enumerate(spans) if s.parent < 0]
    assert [spans[i].name for i in roots] == ["hitl.step"]
    step = spans[roots[0]]
    under = _children(spans, roots[0])
    assert [spans[i].name for i in under] == ["hitl.select", "hitl.solve",
                                              "hitl.solve"]
    for i in under:
        assert step.t0_ns <= spans[i].t0_ns <= spans[i].t1_ns <= step.t1_ns
    for i, st in zip(under[1:], stats):
        windows = _children(spans, i)
        assert {spans[j].name for j in windows} <= {"solve.window",
                                                    "hitl.build"}
        lm_steps = [j for w in windows for j in _children(spans, w)
                    if spans[j].name == "lm.step"]
        assert len(lm_steps) == sum(w.iterations for w in st.windows) > 0
    assert "hitl.build" in {s.name for s in spans}


def test_tracing_off_records_nothing():
    solver = _swept()
    stats = _step(solver)
    assert timer.take() == []
    assert all(w.iterations for st in stats for w in st.windows)
    assert np.all(np.isfinite(solver.state.line_poses))
