"""PyTorch port: a curation session held to the benchmark's plain reference
of the curation step (portbench/reference/curation.py), on the CPU in
float64.

Forty poses of the benchmark's building world at the lgrc2019 keys
(30 m, stop threshold 0.005, outlier 1 m), swept by the port.  Then
twice: the second half of the run moves 0.3 m in y (then x), so that the
horizontal (then vertical) walls both halves see show twice, and a line
pair is drawn on the two copies of one of them as the benchmark's
line-pair maker draws (portbench/line_pairs), and applied through the
port's hitl_callback.  The port's selection must be
the reference's, and each of its solves, rerun by the reference from the
same start for the port's per-window LM steps, must end where the
reference ends.  A fault planted in the port's solve (line B's rows
dropped) must fail that comparison; the benchmark's own tests
(portbench/tests/test_portbench_hitl_session.py) plant the others.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench import check, curation, line_pairs, program  # noqa: E402
from portbench.reference import curation as ref  # noqa: E402
from portbench.reference import world  # noqa: E402
from portbench.tests import hitl_faults  # noqa: E402

SEED = 2 ** 31 + 1611
N, BEAMS, SHIFT = 40, 360, 0.3
# Both engines run in float64.  What is left between them is the order of
# the sums: the port assembles a block band with a border and factors it
# by a block Cholesky scan, the reference assembles dense normal
# equations and solves them by LU.  Those differ by ~1e-15 relative per
# step, and LM's steps grow such a difference by the conditioning of the
# damped system: measured 3.8e-9 m or rad at most, and 3.8e-11 in the
# cost.  The bounds leave 25 times that.  A dropped line B moves the poses
# 0.11 m and the cost 18 %, line poses held fixed 0.32 and 1 %.
POSE_TOL = 1e-7
COST_RTOL = 1e-9


def _keys():
    conf = json.loads((ROOT / "portbench" / "configs"
                       / "lgrc2019.json").read_text())
    return conf, dict(conf["keys"], pose_number=N, solver_dtype="float64")


def _scans(conf):
    inp = conf["inputs"]
    return world.synthesize(N, inp["world"], BEAMS,
                            float(conf["keys"]["max_lidar_range"]),
                            float(inp["odom_noise_trans"]),
                            float(inp["odom_noise_rot"]), SEED)


def _pair(scans, x, keys, world_kind, axis):
    """The pair the benchmark's line-pair maker would draw on map x, among
    the walls of constant x (axis 0) or y (axis 1)."""
    labels = line_pairs.wall_labels(scans, world_kind)
    half = np.arange(N // 2)
    walls = world.make_world(world_kind)
    found = {w: c for w, c in line_pairs.copies(
        scans, x, labels, half, half + N // 2).items()
        if walls[w, 0, axis] == walls[w, 1, axis]}
    w, _ = line_pairs.choose(scans, x, found, float(keys["hitl_line_width"]),
                             int(keys["hitl_pose_point_threshold"]))
    seg_a, seg_b, _, _ = found[w]
    return np.concatenate([seg_a.reshape(-1), seg_b.reshape(-1)])


def _session(faults=(), axes=(1, 0)):
    """(scans, keys, steps) of the session, with faults planted in the port
    for its duration.  Before each step the second half of the run moves
    SHIFT across the walls of one direction, and the pair is drawn on one
    of them: for axis 1 a horizontal wall, for axis 0 a vertical one."""
    conf, keys = _keys()
    scans = _scans(conf)
    cfg = program.config(keys, "lgrc2019")
    sv, solves = curation.swept(scans, cfg, "cpu")
    steps = []
    with pytest.MonkeyPatch.context() as mp:
        for fault in faults:
            fault(mp)
        for axis in axes:
            sv.state.solution[N // 2:, axis] += SHIFT
            pair = _pair(scans, sv.state.solution, keys,
                         conf["inputs"]["world"], axis)
            steps += curation.curate(sv, solves, [pair])
    return scans, keys, steps


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several workers at once, and
    torch's thread pools in each of them would contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def sound():
    return _session()


def _worst(scans, keys, steps):
    """(largest pose or line pose difference in m or rad, largest relative
    cost gap) of the steps' solves against the reference's."""
    prob, cfg, odo, _ = check.problem(scans, keys)
    worst_x = worst_c = 0.0
    for k, st in enumerate(steps):
        rows = ref.rows_of([ref.Constraint(s.seg_a, s.nodes_a + s.nodes_b,
                                           s.points) for s in steps[:k + 1]])
        dense = ref.densified_odometry(st.x_in, cfg.w_max, cfg.tw, cfg.rw)
        starts = [(st.x_in, np.concatenate([st.lines_in, np.zeros((1, 3))])),
                  (st.solves[0].x, st.solves[0].lines)]
        for (x0, l0), solve, factors in zip(starts, st.solves, (dense, odo)):
            x_r, l_r = ref.sweep(prob, x0, l0, cfg, factors, rows,
                                 solve.iterations)
            worst_x = max(worst_x, float(np.max(np.abs(solve.x - x_r))),
                          float(np.max(np.abs(solve.lines - l_r))))
            c_ref = ref.cost_at(prob, x_r, l_r, cfg, factors, rows)
            c_prog = ref.cost_at(prob, solve.x, solve.lines, cfg, factors,
                                 rows)
            worst_c = max(worst_c, abs(c_prog - c_ref) / c_ref)
    return worst_x, worst_c


def test_both_lines_select_poses(sound):
    _, _, steps = sound
    assert len(steps) == 2
    for st in steps:
        assert len(st.nodes_a) >= 5 and len(st.nodes_b) >= 5


def test_selection_is_the_references(sound):
    scans, keys, steps = sound
    width = float(keys["hitl_line_width"])
    threshold = int(keys["hitl_pose_point_threshold"])
    for st in steps:
        a, b = ref.decisions(scans.points, scans.points_mask, st.x_in,
                             st.seg_a, st.seg_b, width, threshold)
        assert list(np.nonzero(a)[0]) == st.nodes_a
        assert list(np.nonzero(b)[0]) == st.nodes_b
        want = ref.selected_points(scans.points, scans.points_mask, st.x_in,
                                   st.seg_a, st.seg_b, width, threshold)
        assert want.nodes == st.nodes_a + st.nodes_b
        for p, q in zip(want.points, st.points):
            np.testing.assert_array_equal(p, q)


def test_solves_end_where_the_reference_ends(sound):
    worst_x, worst_c = _worst(*sound)
    assert worst_x <= POSE_TOL and worst_c <= COST_RTOL, (worst_x, worst_c)


@pytest.mark.parametrize("fault", [hitl_faults.drop_line_b])
def test_a_planted_fault_is_caught(fault):
    scans, keys, steps = _session([fault], axes=(1,))
    worst_x, worst_c = _worst(scans, keys, steps)
    assert worst_x > POSE_TOL and worst_c > COST_RTOL, (worst_x, worst_c)
