"""Draw the line pairs of a curation cell's mix on the plain reference's
float64 maps, and print what each line selects there and in the port.

    python3 portbench/line_pairs.py --workload lgrc2019.hitl_session [--write]

For each recording of the mix (its ``drifts``) the reference
(portbench/reference/curation.py) sweeps from the recording's initial
poses in float64 under Ceres' stop rule.  Then, up to PAIRS times, as a
curator draws on the map in front of them:

1. each scan point is labelled with the world wall it was raycast from,
   by the ground-truth pose;
2. for every wall, a line is fitted to the points that first-pass poses
   (those before n - lap, lap being the poses of one lap of the
   trajectory) put on it in the current map, and one to the points that
   second-pass poses (from lap on) put on it; both segments span the
   stretch of the wall that both passes show, less END metres at each end;
3. of the walls not drawn before whose copies lie at least SEPARATION
   metres apart at the stretch's middle and whose segments each select at
   least MIN_POSES poses (the reference's selection, segments rounded to
   the millimetre as committed), the pair is the one whose copies lie
   closest: the largest doublings stay for the later steps, so that as
   many steps as possible find one;
4. the reference's curation step with that pair moves the map.

A recording whose map has no such wall left gets fewer pairs.  The
recordings are drawn in parallel processes on the CPU.  On a CUDA card
the port then curates each recording with its pairs (portbench/curation.py)
and the line also holds, per step, the poses each line selects in the
port and how far the port's poses lie from the reference's (largest and
median distance in the plane, m) after the sweep and after each step.
It prints one JSON line per recording and, with --write, puts the pairs
into the mix file.  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import check, curation, program, run as harness  # noqa: E402
from portbench import traffic  # noqa: E402
from portbench.reference import curation as ref  # noqa: E402
from portbench.reference import world  # noqa: E402

END = 0.3
SEPARATION = 0.2
MIN_POSES = 5
MIN_STRETCH = 1.0
PAIRS = 6                    # at most, per recording


def wall_labels(scans, kind):
    """[N, P] index of the world wall each point was raycast from (-1 for
    padding)."""
    walls = world.make_world(kind)
    pts = ref.transform(
        torch.as_tensor(scans.gt)[:, None, :],
        torch.as_tensor(scans.points).to(torch.float64))
    d = ref.segment_distance(pts[:, :, None, :],
                             torch.as_tensor(walls[:, 0]),
                             torch.as_tensor(walls[:, 1])).numpy()
    label = np.argmin(d, -1)
    ok = scans.points_mask & (np.min(d, -1) < 1e-3)
    return np.where(ok, label, -1)


def _fit(p):
    """(centroid, unit direction) of points p [k, 2]."""
    c = p.mean(0)
    u = np.linalg.svd(p - c, full_matrices=False)[2][0]
    return c, u


def copies(scans, x, labels, first, second):
    """{wall: (segment A, segment B, separation, stretch)} for the walls
    both passes show, in map x."""
    world_pts = ref.transform(torch.as_tensor(x)[:, None, :],
                              torch.as_tensor(scans.points).to(torch.float64)
                              ).numpy()
    out = {}
    for w in np.unique(labels[labels >= 0]):
        pa = world_pts[first][labels[first] == w]
        pb = world_pts[second][labels[second] == w]
        if len(pa) < 20 or len(pb) < 20:
            continue
        ca, ua = _fit(pa)
        cb, ub = _fit(pb)
        ta, tb = (pa - ca) @ ua, (pb - ca) @ ua
        lo = max(ta.min(), tb.min()) + END
        hi = min(ta.max(), tb.max()) - END
        if hi - lo < MIN_STRETCH:
            continue
        seg_a = np.stack([ca + lo * ua, ca + hi * ua])
        seg_b = np.stack([cb + ((s - cb) @ ub) * ub for s in seg_a])
        mid = seg_b.mean(0) - ca
        sep = abs(mid[0] * ua[1] - mid[1] * ua[0])
        out[int(w)] = (np.round(seg_a, 3), np.round(seg_b, 3), float(sep),
                       float(hi - lo))
    return out


def choose(scans, x, found, width, threshold):
    """(wall or None, [[wall, separation, poses on A, poses on B] of every
    wall in ``found``]): of the walls in ``found`` (as copies() returns
    them) whose copies lie at least SEPARATION apart and whose lines each
    select at least MIN_POSES poses, the one whose copies lie closest."""
    table = []
    for w, (seg_a, seg_b, sep, _) in sorted(found.items(),
                                            key=lambda kv: kv[1][2]):
        a, b = ref.decisions(scans.points, scans.points_mask, x, seg_a, seg_b,
                             width, threshold)
        table.append([w, round(sep, 4), int(a.sum()), int(b.sum())])
    for w, sep, a, b in table:
        if sep >= SEPARATION and min(a, b) >= MIN_POSES:
            return w, table
    return None, table


def draw(conf, drift, pairs=PAIRS):
    """(pairs, notes, maps) for one recording, drawn on the reference's
    maps; maps holds the reference's poses after the sweep and after each
    step."""
    keys = conf["keys"]
    scans = traffic.scans(conf, [drift])[0]
    width = float(keys["hitl_line_width"])
    threshold = int(keys["hitl_pose_point_threshold"])
    n = len(scans.gt)
    turned = np.unwrap(scans.gt[:, 2]) - scans.gt[0, 2]
    lap = int(np.argmax(np.abs(turned) >= 2 * np.pi))
    if lap == 0:
        raise ValueError("the trajectory does not close a lap")
    first, second = np.arange(0, n - lap), np.arange(lap, n)
    labels = wall_labels(scans, conf["inputs"]["world"])
    prob, cfg, odo, _ = check.problem(scans, keys)
    x, lines = ref.sweep(prob, scans.initial_poses, np.zeros((0, 3)), cfg,
                         odo, None, None)
    drawn, notes, maps, used, constraints = [], [], [x], set(), []
    for _ in range(pairs):
        found = {w: c for w, c in copies(scans, x, labels, first,
                                         second).items() if w not in used}
        w, table = choose(scans, x, found, width, threshold)
        if w is None:
            notes.append({"walls": table, "drawn": False})
            break
        used.add(w)
        seg_a, seg_b, sep, stretch = found[w]
        x, lines, constraints = ref.session_step(
            prob, cfg, odo, scans.points, scans.points_mask, x, lines,
            constraints, seg_a, seg_b, width, threshold)
        drawn.append([float(v) for v in np.concatenate(
            [seg_a.reshape(-1), seg_b.reshape(-1)])])
        maps.append(x)
        notes.append({"wall": w, "separation": sep, "stretch": stretch,
                      "poses": next(t[2:] for t in table if t[0] == w),
                      "walls": table})
    return drawn, notes, maps


def _draw_one(args):
    torch.set_num_threads(2)
    return draw(*args)


def _in_the_port(conf, drift, pairs, maps):
    """Per step, the poses on A and on B in the port's curation of the
    recording, and the plane distance of the port's poses to the
    reference's (largest, median) after the sweep and after each step."""
    scans = traffic.scans(conf, [drift])[0]
    out = curation.session(scans, program.config(conf["keys"], conf["name"]),
                           "cuda", pairs)
    xs = [out.sweep.x] + [st.solves[-1].x for st in out.steps]

    def apart(a, b):
        d = np.hypot(*(a[:, :2] - b[:, :2]).T)
        return [round(float(d.max()), 4), round(float(np.median(d)), 4)]
    return {"poses": [[len(st.nodes_a), len(st.nodes_b)]
                      for st in out.steps],
            "apart": [apart(a, b) for a, b in zip(xs, maps)]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--write", action="store_true")
    args = ap.parse_args(argv)
    harness.cache_env()
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell, conf, mix = harness.cell_files(bench, args.workload)
    drifts = mix["drifts"]
    # Fork before anything touches a card.
    with multiprocessing.get_context("fork").Pool(len(drifts)) as pool:
        results = pool.map(_draw_one, [(conf, d) for d in drifts])
    drawn = {}
    for d, (pairs, notes, maps) in zip(drifts, results):
        drawn[str(d)] = pairs
        line = {"drift": d, "pairs": pairs, "notes": notes}
        if torch.cuda.is_available():
            line["port"] = _in_the_port(conf, d, pairs, maps)
        print(json.dumps(line), flush=True)
    if args.write:
        mix["line_pairs"] = drawn
        path = harness.BENCH / "traffic" / f"{cell['traffic']}.json"
        path.write_text(json.dumps(mix, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
