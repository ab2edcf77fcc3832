"""A run with the timed path broken underneath comes out not correct, and a
sound run comes out correct.  Each test skips the harness's look for a
card and drives the rest of a run (set-up, window, the reference's
judgement against the cell's limits file) on the CPU at 400 poses, with
one fault planted in the program:

- a step that returns its state unchanged (the sweep);
- a sweep that stops one window short (window 9 of 10);
- half of the batch left out (half the gated pairs never scan-matched);
- an answer altered where it is produced (every scan-match transform
  moved 5 cm).

The exchange between chips does not exist in this one-chip cell.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import run as harness  # noqa: E402

SEED = 2 ** 31 + 4242
POSES = 400


def _judge(tmp_path, workload):
    """A run of the cell at POSES poses: its configuration file copied with
    ``pose_number`` changed and nothing else."""
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    for entry in bench["configs"]:
        conf = harness.load_json(ROOT / entry["file"])
        conf["keys"]["pose_number"] = POSES
        path = tmp_path / f"{entry['name']}.json"
        path.write_text(json.dumps(conf))
        entry["file"] = str(path)
    run, judge, _, limits = harness.measure(workload, SEED, 0.1, False,
                                            "cpu", bench=bench)
    return harness.verdict(run, judge(), limits)


def _still(monkeypatch):
    from nautilus_tpu_torch.solve import solver
    monkeypatch.setattr(solver.Solver, "solve_slam",
                        lambda self, *a, **k: solver.SolveStats())


def _window_short(monkeypatch):
    from nautilus_tpu_torch.solve import solver

    def short(self, optimization_type="feature"):
        cfg = self.config
        return self._solve_windows(
            cfg.get_int("lidar_constraint_amount_min"),
            cfg.get_int("lidar_constraint_amount_max") - 1, optimization_type)
    monkeypatch.setattr(solver.Solver, "solve_slam", short)


def _half_pairs(monkeypatch):
    from nautilus_tpu_torch.loop_closure import auto_lc
    original = auto_lc.match_gated_pairs

    def half(state, gated, *a, **k):
        scores, tfs, best, n = original(state, gated, *a, **k)
        scores[len(scores) // 2:] = -np.inf
        return scores, tfs, best, n
    monkeypatch.setattr(auto_lc, "match_gated_pairs", half)


def _moved_matches(monkeypatch):
    from nautilus_tpu_torch.loop_closure import auto_lc
    original = auto_lc.csm_match_pairs

    def moved(*a, **k):
        scores, tfs = original(*a, **k)
        tfs = tfs.copy()
        tfs[:, 0] += 0.05
        return scores, tfs
    monkeypatch.setattr(auto_lc, "csm_match_pairs", moved)


@pytest.mark.parametrize("fault", [None, _still, _window_short, _half_pairs,
                                   _moved_matches])
def test_closed_map(monkeypatch, tmp_path, fault):
    if fault is not None:
        fault(monkeypatch)
    correct, shown = _judge(tmp_path, "gdc2020.autolc_map")
    assert correct == (fault is None), shown
    if fault is _window_short:
        assert shown["sweep_gap"]["value"] > shown["sweep_gap"]["limit"]
