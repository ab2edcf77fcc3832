"""The kind ``hitl_session``: the window curates maps back to back, each
from a new state and solver (portbench/curation.py): preprocess, the
growing-window sweep, then the recording's line pairs (``line_pairs``,
keyed by the recording's drift seed) in order, each one curation step
through the port's hitl_callback.  The sessions cycle through the mix's
recordings (the seeds in ``drifts``) in an order drawn from the seed, and
the window ends on a whole cycle.  The end-to-end metric is the window's
wall over the sessions completed.  With tracing, the port's tracer is on
through the window and each session's ``hitl.*`` spans go into
``run.spans``; a program without them leaves those lists empty.

The comparison, on one session of the window drawn from the seed:

- ``sweep_gap``: the session's first sweep against the reference's float64
  sweep from the same initial poses, in which each window runs exactly the
  program's LM steps with the stop rule off, so that no stop decision
  moves the gap: the relative gap of the reference's cost at each
  solution's own correspondences, as check.cost_gap; inf when the program
  solved fewer windows.
- ``select_miss``: in every step, poses whose membership of line A or B
  differs from the reference's selection from the poses the program
  entered the step with; a pose whose decision changes between widths
  (1 - select_band) w and (1 + select_band) w is not counted.
- ``hitl_gap``: in one step drawn from the seed, every window of its two
  solves against the reference's (reference/curation.window_gap): from
  the poses and line poses the program started the window with, under the
  correspondences there, with the program's selected poses (the on-line
  points of each are the reference's, from the poses the program entered
  that step with) and the window's LM steps, the relative gap of the reference's cost with the
  constraints' rows at the program's window end to the cost where the
  reference ends; the largest.  Compared window by window, so that
  neither a stop decision nor a correspondence that flips between the
  float32 and float64 poses at a later window's start moves the gap
  (compared solve by solve, sound runs read up to 0.1 on some steps);
  inf when the program solved fewer windows.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import check, curation, program, traffic
from portbench.reference import curation as ref


def drive(mix, conf, seed, seconds, trace, device, t_start):
    import torch
    cfg = program.config(conf["keys"], conf["name"])
    run = traffic.Run("map_s")
    drifts = mix["drifts"]
    order = [drifts[k] for k in
             np.random.default_rng(seed).permutation(len(drifts))]
    runs = traffic.scans(conf, order)
    pairs = [mix["line_pairs"][str(d)] for d in order]
    if torch.device(device).type == "cuda":
        program.build_kernels()
    curation.session(runs[0], cfg, device, pairs[0])        # warm-up
    traffic.sync(device)
    run.setup_s = time.perf_counter() - t_start
    spans = traffic.Spans(run, device, sync=trace)
    made = []

    def unit():
        k = len(made) % len(runs)
        try:
            out = curation.session(runs[k], cfg, device, pairs[k], spans)
        finally:
            for name, s in curation.take() if trace else ():
                if name.startswith("hitl."):
                    run.add("spans", name, s)
        made.append(k)
        run.unit_keys.append(order[k])
        run.add("counts", "lm_steps", sum(out.sweep.iterations))
        for st in out.steps:
            run.add("counts", "hitl.lm_steps",
                    sum(sum(s.iterations) for s in st.solves))
            run.add("counts", "hitl.selected_poses",
                    len(st.nodes_a) + len(st.nodes_b))
        return out

    if trace:
        curation.take()
        curation.tracing(True)
    try:
        outs = traffic.window(run, seconds, unit, cycle=len(runs))
    finally:
        curation.tracing(False)
    if trace:
        from portbench import trace as tr
        run.profiled = tr.profile(
            lambda: curation.session(
                runs[0], cfg, device, pairs[0],
                traffic.Spans(traffic.Run("x"), device, False)), device)
        run.profiled["key"] = order[0]
    run.peak = traffic.peak_bytes(device)

    def judge(k=None, step=None):
        """The comparison on the window's k-th session and its step-th
        curation step (each drawn from the seed when None)."""
        if not outs:
            return {}
        rng = np.random.default_rng(seed)
        k_drawn = int(rng.integers(len(outs)))
        k = k_drawn if k is None else k
        step_drawn = int(rng.integers(len(outs[k].steps)))
        return compare(runs[made[k]], conf["keys"], outs[k],
                       step_drawn if step is None else step,
                       float(mix["select_band"]))
    return run, judge


def compare(scans, keys, out: curation.SessionOut, step, band):
    prob, cfg, odo, _ = check.problem(scans, keys)
    width = float(keys["hitl_line_width"])
    threshold = int(keys["hitl_pose_point_threshold"])
    return {"sweep_gap": _sweep_gap(prob, cfg, odo, scans.initial_poses,
                                    out.sweep),
            "select_miss": float(sum(
                select_miss(scans, s, width, threshold, band)
                for s in out.steps)),
            "hitl_gap": hitl_gap(prob, cfg, odo, scans, out, step, width)}


def constraint(scans, st: curation.Step, width):
    """The step's constraint as the reference makes it: the poses the
    program selected, each with the points the reference finds on its line
    from the poses the program entered the step with."""
    _, _, on_a, on_b = ref.on_line_counts(scans.points, scans.points_mask,
                                          st.x_in, st.seg_a, st.seg_b, width)
    pts = scans.points.astype(np.float64)
    return ref.Constraint(st.seg_a, st.nodes_a + st.nodes_b,
                          [pts[v][on_a[v]] for v in st.nodes_a]
                          + [pts[v][on_b[v]] for v in st.nodes_b])


def hitl_gap(prob, cfg, odo, scans, out: curation.SessionOut, step, width):
    """The largest relative gap of a window of the step's two solves."""
    st = out.steps[step]
    rows = ref.rows_of([constraint(scans, s, width)
                        for s in out.steps[:step + 1]])
    dense = ref.densified_odometry(st.x_in, cfg.w_max, cfg.tw, cfg.rw)
    start = (st.x_in, np.concatenate([st.lines_in, np.zeros((1, 3))]))
    windows = range(cfg.w_min, cfg.w_max + 1)
    gap = 0.0
    for solve, factors in zip(st.solves, (dense, odo)):
        if not len(solve.iterations) == len(solve.windows) == len(windows):
            return float("inf")
        for w, steps, end in zip(windows, solve.iterations, solve.windows):
            gap = max(gap, ref.window_gap(prob, cfg, w, factors, rows, start,
                                          end, steps))
            start = end
    return gap


def _sweep_gap(prob, cfg, odo, x0, sweep: curation.Solve):
    """The program's sweep against the reference's from the same initial
    poses for the same per-window LM steps (check.cost_gap); inf when the
    program did not solve every window."""
    if len(sweep.iterations) != cfg.w_max - cfg.w_min + 1:
        return float("inf")
    x_ref = ref.sweep(prob, x0, np.zeros((0, 3)), cfg, odo, None,
                      sweep.iterations)[0]
    return check.cost_gap(prob, cfg, odo, sweep.x, x_ref)


def select_miss(scans, st: curation.Step, width, threshold, band):
    """Poses the program selected otherwise than the reference, from the
    poses the step entered with; poses whose decision moves inside the
    width band are not counted."""
    def decide(w):
        return ref.decisions(scans.points, scans.points_mask, st.x_in,
                             st.seg_a, st.seg_b, w, threshold)
    a, b = decide(width)
    n = len(a)
    prog_a, prog_b = np.zeros(n, bool), np.zeros(n, bool)
    prog_a[st.nodes_a] = True
    prog_b[st.nodes_b] = True
    steady = np.ones(n, bool)
    for w in ((1 - band) * width, (1 + band) * width):
        a_w, b_w = decide(w)
        steady &= (a_w == a) & (b_w == b)
    return int(np.sum(((a != prog_a) | (b != prog_b)) & steady))
