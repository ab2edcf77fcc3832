"""The kind ``closed_map``: the window builds maps back to back, each from a
new state and solver (nothing of the program carries from one map to the
next): preprocess, the growing-window sweep and, with ``"auto_lc": true``,
the loop closures and the re-solve.  The maps cycle through the mix's
recordings of one world, which differ in their odometry drift (the seeds
in ``drifts``), in an order drawn from the seed, and the window ends on a
whole cycle.  The end-to-end metric is the window's wall over the maps
completed.

The comparison, on one map of the window drawn from the seed:

- ``sweep_gap``: the program's swept poses against the reference's own
  10-window sweep from the same initial poses (check.cost_gap).
- ``cand_miss``: candidates the reference's chain does not share.
- ``gate_miss``: pairs gated against the reference's chi-square score,
  outside a band of ``gate_band`` around the threshold.
- ``csm_score_gap`` and ``csm_shift``: the reference matcher on a sample of
  ``check_csm_pairs`` gated pairs (score, and the transform in finest grid
  steps where either side accepts).
- ``closed_gap``: the program's closed poses against the reference's
  re-solve of the same closures, from the program's swept poses (the
  reference follows the program there: the sweep and the matches are
  judged by the numbers above).
"""

from __future__ import annotations

import time

import numpy as np

from portbench import check, program, traffic
from portbench.reference import csm as ref_csm
from portbench.reference import features, gate, referee


def drive(mix, conf, seed, seconds, trace, device, t_start):
    import torch
    cfg = program.config(conf["keys"], conf["name"])
    auto_lc = bool(mix.get("auto_lc", False))
    run = traffic.Run("map_s")
    drifts = mix["drifts"]
    order = [drifts[k] for k in
             np.random.default_rng(seed).permutation(len(drifts))]
    runs = traffic.scans(conf, order)
    if torch.device(device).type == "cuda":
        program.build_kernels()
    program.closed_map(runs[0], cfg, device, auto_lc)     # warm-up
    traffic.sync(device)
    run.setup_s = time.perf_counter() - t_start
    spans = traffic.Spans(run, device, sync=trace)
    made = []

    def unit():
        k = len(made) % len(runs)
        out = program.closed_map(runs[k], cfg, device, auto_lc, spans)
        made.append(k)
        run.unit_keys.append(order[k])
        run.add("counts", "lm_steps", out.lm_steps)
        run.add("counts", "gated_pairs", len(out.gated_pairs))
        return out

    outs = traffic.window(run, seconds, unit, cycle=len(runs))
    if trace:
        from portbench import trace as tr
        launches, undo = program.record_coarse_launches()
        try:
            run.profiled = tr.profile(
                lambda: program.closed_map(
                    runs[0], cfg, device, auto_lc,
                    traffic.Spans(traffic.Run("x"), device, False)),
                device, kernels=("fused_coarse_kernel",))
        finally:
            undo()
        run.profiled["key"] = order[0]
        run.launches = launches
    run.peak = traffic.peak_bytes(device)

    def judge(k=None):
        """The comparison on the window's k-th map (drawn from the seed
        when k is None)."""
        if not outs:
            return {}
        if k is None:
            k = int(np.random.default_rng(seed).integers(len(outs)))
        return compare(runs[made[k]], conf["keys"], outs[k], auto_lc, seed,
                       int(mix["check_csm_pairs"]), float(mix["gate_band"]))
    return run, judge


def compare(scans, keys, out, auto_lc, seed, csm_pairs, gate_band):
    prob, cfg, odo, normals = check.problem(scans, keys)
    x_ref = referee.sweep(prob, scans.initial_poses, cfg, odo)[0]
    got = {"sweep_gap": check.cost_gap(prob, cfg, odo, out.x_sweep, x_ref)}
    if not auto_lc:
        return got
    x = out.x_sweep
    scores = features.scatter_score(scans.points, scans.points_mask)
    follow = set(out.candidates)
    cands = gate.candidates(scores, x, follow)
    if keys["keyframe_local_uncertainty_filtering"]:
        prev = int(keys["local_uncertainty_prev_scans"])
        conds, scales = gate.uncertainty(scans.points, scans.points_mask,
                                         normals, x, cands, prev)
        cands = gate.keep_certain(
            cands, conds, scales,
            float(keys["local_uncertainty_condition_threshold"]),
            float(keys["local_uncertainty_scale_threshold"]), follow)
    got["cand_miss"] = float(len(set(cands) ^ set(out.candidates)))
    pairs = gate.range_pairs(cands, x, float(keys["lc_base_max_range"]),
                             float(keys["lc_max_range_scaling"]))
    chi = gate.chi_square(prob, x, cfg, odo, pairs)
    t = gate.CHI_SQUARE_THRESHOLD
    gated = set(map(tuple, out.gated_pairs))
    miss = len(gated - set(pairs))
    for p in pairs:
        if p in gated and chi[p] >= t * (1 + gate_band):
            miss += 1
        elif p not in gated and chi[p] < t / (1 + gate_band):
            miss += 1
    got["gate_miss"] = float(miss)
    threshold = float(keys["csm_score_threshold"])
    params = ref_csm.CSMParams(scan_range=float(keys["max_lidar_range"]))
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(out.csm), min(csm_pairs, len(out.csm)),
                      replace=False) if out.csm else []
    score_gap = shift = 0.0
    pts, msk = scans.points, scans.points_mask
    for k in pick:
        s, tt, score, tf = out.csm[k]
        ref_score, ref_tf = ref_csm.csm_match_cpu(
            pts[s][msk[s]], pts[tt][msk[tt]], params,
            float(check.wrap(x[s, 2] - x[tt, 2])))
        score_gap = max(score_gap, abs(score - float(ref_score)))
        if score >= threshold or ref_score >= threshold:
            step_t = params.high_res
            step_r = params.high_res / params.scan_range
            shift = max(shift,
                        float(np.max(np.abs(tf[:2] - ref_tf[:2]))) / step_t,
                        abs(float(check.wrap(tf[2] - ref_tf[2]))) / step_r)
    got["csm_score_gap"] = score_gap
    got["csm_shift"] = shift
    matches = [(s, tt, tf) for s, tt, score, tf in out.csm
               if score >= threshold]
    lc = referee.closures(x, matches, float(keys["lc_translation_weight"]),
                          float(keys["lc_rotation_weight"]))
    both = referee.join(odo, lc)
    # The program re-solves only when it accepted a closure.
    x_rc = referee.sweep(prob, x, cfg, both, w_min=cfg.w_max)[0] \
        if matches else x
    got["closed_gap"] = check.cost_gap(prob, cfg, both, out.x_closed, x_rc)
    return got
