"""What every kind of traffic shares: the record of a run, the spans
around the calls into each layer, the measured window and the recorded
scans.

A mix (portbench/traffic/<mix>.json) names its kind and its parameters;
the kind is portbench/kinds/<kind>.py, found by name, whose ``drive(mix,
conf, seed, seconds, trace, device, t_start)`` sets up, runs the window
and returns ``(run, judge)``: the Run below, and a function that compares
what the window produced with the plain reference and returns {name:
value}.  A new kind is a new file there.

The seed draws orders and which unit the reference judges; it never
draws sizes: the work of a run is the same on every seed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
import traceback
from typing import Callable, Dict, List

from portbench.reference import world


@dataclasses.dataclass
class Run:
    """What one run measured and produced."""

    metric: str                          # the end-to-end metric's name
    value: float = float("nan")
    attempted: int = 0
    failed: int = 0
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    counts: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    unit_walls: List[float] = dataclasses.field(default_factory=list)
    unit_keys: list = dataclasses.field(default_factory=list)  # each unit's work
    # trace.profile's reading of one more unit; its "key" is that unit's work
    profiled: dict = None
    launches: list = None                # the profiled unit's kernel inputs
    setup_s: float = float("nan")
    peak: int = 0

    def add(self, table, name, value):
        getattr(self, table).setdefault(name, []).append(float(value))


def sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def peak_bytes(device):
    import torch
    if torch.device(device).type == "cuda":
        return torch.cuda.max_memory_allocated()
    return 0


class Spans:
    """Host-clock spans around the calls into each layer.  With sync, each
    boundary waits for the card first, and each span is also a profiler
    region named ``portbench.<name>``."""

    def __init__(self, run: Run, device, sync: bool):
        self.run, self.device, self.sync = run, device, sync

    @contextlib.contextmanager
    def __call__(self, name):
        import torch
        if self.sync:
            sync(self.device)
        t0 = time.perf_counter()
        with torch.profiler.record_function("portbench." + name):
            yield
            if self.sync:
                sync(self.device)
        self.run.add("spans", name, time.perf_counter() - t0)


def window(run: Run, seconds: float, unit: Callable[[], object],
           cycle: int = 1):
    """Units back to back until ``seconds`` have passed and the units
    attempted are a whole number of cycles (so that every run does the same
    work); a unit that raises counts as failed.  Returns the outputs of the
    units completed and sets the end-to-end value: the window's wall over
    them."""
    outs = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds or run.attempted % cycle:
        run.attempted += 1
        u0 = time.perf_counter()
        try:
            outs.append(unit())
        except Exception:
            run.failed += 1
            traceback.print_exc(file=sys.stderr)
            continue
        run.unit_walls.append(time.perf_counter() - u0)
    wall = time.perf_counter() - t0
    run.value = wall / len(outs) if outs else float("nan")
    return outs


def scans(conf, seeds):
    """One recorded run per seed: the same scans, each seed's drift."""
    k, inp = conf["keys"], conf["inputs"]
    base = world.raycast_run(int(k["pose_number"]), inp["world"],
                             int(inp["num_beams"]), float(k["max_lidar_range"]))
    return [world.with_drift(base, float(inp["odom_noise_trans"]),
                             float(inp["odom_noise_rot"]), s) for s in seeds]
