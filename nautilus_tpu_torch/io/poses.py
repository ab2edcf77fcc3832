"""Pose-file write/read in the reference's text format (port of
nautilus_tpu/io/poses.py).

Save: ``timestamp x y theta`` lines with C++ std::fixed formatting
(6 decimals), exactly as reference WriteCallback (solver.cc:565-579).
Resume: poses matched back to nodes by the stringified fixed-format
timestamp, as reference LoadSolutionFromFile (main.cc:131-157).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np

from nautilus_tpu_torch.core.problem import SLAMState


def _fixed(x: float) -> str:
    """C++ std::fixed default formatting (6 decimals)."""
    return f"{x:.6f}"


def write_poses(state: SLAMState, path) -> None:
    """WriteCallback equivalent; empty path prints a warning and skips."""
    if not str(path):
        print("No output file specified, not writing!")
        return
    lines = []
    for ts, pose in zip(state.timestamps, state.solution):
        lines.append(f"{_fixed(ts)} {_fixed(pose[0])} {_fixed(pose[1])} "
                     f"{_fixed(pose[2])}")
    Path(path).write_text("\n".join(lines) + "\n")


def read_pose_file(path) -> Dict[str, np.ndarray]:
    """Parse a pose file into {fixed-format timestamp: [x, y, theta]}."""
    poses: Dict[str, np.ndarray] = {}
    text = Path(path).read_text()
    for line in text.splitlines():
        parts = line.split()
        if len(parts) != 4:
            continue
        ts, x, y, th = (float(p) for p in parts)
        poses[_fixed(ts)] = np.array([x, y, th], np.float64)
    return poses


def load_solution(state: SLAMState, path, verbose: bool = True) -> int:
    """LoadSolutionFromFile equivalent: overwrite matching nodes' solution
    poses by stringified-timestamp lookup.  Returns #nodes updated."""
    poses = read_pose_file(path)
    updated = 0
    for i, ts in enumerate(state.timestamps):
        key = _fixed(ts)
        if key in poses:
            state.solution[i] = poses[key]
            updated += 1
        elif verbose:
            print(f"Unable to find solution for timestamp {ts:f}")
    if verbose:
        print("Finished loading solution file.")
    return updated
