"""PyTorch port: an independent exhaustive oracle for the CSM refinement
pyramid (port of tests/test_csm_oracle.py).

The port's matcher (kernels/csm.py) replaced the reference's high-res
rasterized lookup table (solver.cc:56 ctor -> third_party CSM, 0.01 m
cells) with a continuous K-nearest Gaussian refinement pyramid, as the JAX
package does.  Its parity tests compare against the JAX package and against
baseline/cpu_csm.py — the SAME algorithm — so they cannot catch an
algorithmic error in the replacement itself.

This oracle is the reference's actual formulation, independently
implemented: rasterize the Gaussian occupancy model onto a dense
high-res lookup table, then EXHAUSTIVELY score every (theta, ty, tx) on
the fine grid by table lookup.  No pyramid, no K-nearest truncation, no
shared code with the port's matcher.  The tests pin that the pyramid's
argmax, in the pair engine and in the stage engine, lands within ~one
high-res cell / one fine rotation step of the exhaustive argmax, and that
its score matches the exhaustive maximum, across random worlds and seeded
rotations, on the port's synthetic worlds.
"""

import numpy as np
import pytest
import torch

from nautilus_tpu_torch.ingest.synthetic import (make_world, raycast,
                                                 scan_to_points)
from nautilus_tpu_torch.kernels.csm import (CSMParams, csm_match,
                                            csm_match_pairs)

# Small geometry so the exhaustive grid stays tractable: ~60 rotations x
# 21x21 translations x ~200 points of pure numpy lookups per case.
PARAMS = CSMParams(scan_range=5.0, trans_range=0.5, low_res=0.25,
                   high_res=0.05, rotation_restriction=0.3)


def exhaustive_lookup_match(src, tgt, params, rotation_center=0.0):
    """Brute-force (score, [tx, ty, theta]) via a rasterized table.

    Table: occ[cell] = clip(sum_q exp(-|c - q|^2 / 2 sigma^2), 1) at cell
    centers over [-hw, hw] (the reference builds this by Gaussian-smearing
    a raster; evaluating the model at cell centers is the same table
    without the convolution approximation).  Score(theta, t) = mean_p
    log(occ[cell(R(theta) p + t)] + 1e-6) — the matcher's score
    definition, evaluated by LOOKUP like the reference, not by the
    matcher's code path.
    """
    res = params.high_res
    hw = params.table_halfwidth
    cells = int(round(2 * hw / res))
    centers = -hw + (np.arange(cells) + 0.5) * res
    cx, cy = np.meshgrid(centers, centers)           # [cells, cells]
    d2 = ((cx[..., None] - tgt[None, None, :, 0]) ** 2
          + (cy[..., None] - tgt[None, None, :, 1]) ** 2)
    occ = np.minimum(np.exp(-d2 / (2 * params.sigma ** 2)).sum(-1), 1.0)
    log_table = np.log(occ + 1e-6)                   # [cy, cx]

    rot_step = params.high_res / params.scan_range
    n_rot = int(np.ceil(2 * params.rotation_restriction / rot_step))
    thetas = (rotation_center - params.rotation_restriction
              + (np.arange(n_rot) + 0.5) * (2 * params.rotation_restriction
                                            / n_rot))
    n_off = int(round(params.trans_range / res))
    toff = (np.arange(2 * n_off + 1) - n_off) * res  # translation grid

    best = (-np.inf, None)
    for th in thetas:
        c, s = np.cos(th), np.sin(th)
        pr = src @ np.array([[c, s], [-s, c]])       # R(th) p, row-vector
        ix = np.floor((pr[:, 0, None] + toff[None, :] + hw) / res)
        iy = np.floor((pr[:, 1, None] + toff[None, :] + hw) / res)
        ix = np.clip(ix, 0, cells - 1).astype(int)   # [P, Wx]
        iy = np.clip(iy, 0, cells - 1).astype(int)   # [P, Wy]
        vals = log_table[iy[:, :, None], ix[:, None, :]]   # [P, Wy, Wx]
        scores = vals.sum(0) / len(src)
        k = np.argmax(scores)
        wy, wx = k // scores.shape[1], k % scores.shape[1]
        if scores[wy, wx] > best[0]:
            best = (scores[wy, wx],
                    np.array([toff[wx], toff[wy], th]))
    return best


def _pad(c, p=512):
    out = np.zeros((p, 2), np.float32)
    m = np.zeros(p, bool)
    out[:len(c)] = c[:p]
    m[:min(len(c), p)] = True
    return torch.as_tensor(out), torch.as_tensor(m)


def _case(world_kind, seed, rot_offset=0.0):
    """A random overlapping pair with a seeded rotation, study-style."""
    rng = np.random.default_rng(seed)
    world = make_world(world_kind)
    lo, hi = {"room": (-3, 3), "office": (-7, 7)}[world_kind]
    for _ in range(50):
        base = np.array([rng.uniform(lo, hi), rng.uniform(lo, hi),
                         rng.uniform(-np.pi, np.pi)])
        if np.nanmin(raycast(world, base, 90, max_range=5.0)) > 0.8:
            break
    d = np.array([rng.uniform(-0.35, 0.35), rng.uniform(-0.35, 0.35),
                  rot_offset + rng.uniform(-0.25, 0.25)])
    pose_a = base + d
    cl_a = scan_to_points(raycast(world, pose_a, 360, max_range=5.0),
                          max_range=5.0).astype(np.float32)
    cl_b = scan_to_points(raycast(world, base, 360, max_range=5.0),
                          max_range=5.0).astype(np.float32)
    return cl_a, cl_b, float(d[2])


def _holds_to_oracle(cl_a, cl_b, center):
    """The pair engine (csm_match) and the stage engine (csm_match_pairs,
    the auto-LC path) against the exhaustive oracle."""
    if len(cl_a) < 30 or len(cl_b) < 30:
        pytest.skip("degenerate scan")
    a, ma = _pad(cl_a)
    b, mb = _pad(cl_b)
    score_p, tr_p = csm_match(a, ma, b, mb, PARAMS, rotation_center=center)
    s_st, tr_st = csm_match_pairs(torch.stack([a, b]), torch.stack([ma, mb]),
                                  [0], [1], PARAMS, rotation_centers=[center],
                                  engine="stage")
    score_o, tr_o = exhaustive_lookup_match(
        cl_a.astype(np.float64), cl_b.astype(np.float64), PARAMS,
        rotation_center=center)
    rot_step = PARAMS.high_res / PARAMS.scan_range
    for score_p, tr_p in ((float(score_p), tr_p.numpy()),
                          (float(s_st[0]), tr_st[0])):
        tr_p = tr_p.astype(np.float64)
        # One high-res cell / one fine rotation step of slack, plus the
        # half-cell quantization the lookup oracle itself carries.
        assert abs(tr_p[0] - tr_o[0]) <= 1.5 * PARAMS.high_res, (tr_p, tr_o)
        assert abs(tr_p[1] - tr_o[1]) <= 1.5 * PARAMS.high_res, (tr_p, tr_o)
        d_th = np.arctan2(np.sin(tr_p[2] - tr_o[2]),
                          np.cos(tr_p[2] - tr_o[2]))
        assert abs(d_th) <= 1.5 * rot_step, (tr_p, tr_o)
        # Same model, so the scores must agree at the optimum (the oracle
        # reads cell centers where the matcher evaluates continuously:
        # allow the sub-cell difference).
        assert abs(score_p - score_o) <= 0.15, (score_p, score_o)


@pytest.mark.parametrize("world_kind,seed", [
    ("office", 0), ("office", 3), ("office", 11),
    ("room", 1), ("room", 7),
])
def test_pyramid_matches_exhaustive_argmax(world_kind, seed):
    _holds_to_oracle(*_case(world_kind, seed))


@pytest.mark.parametrize("seed", [2, 9])
def test_pyramid_matches_exhaustive_reverse_traversal(seed):
    """Seeded rotation window at theta ~ pi (reverse traversal, the
    auto-LC case the reference seeds via both scans' solution headings,
    solver.cc:634-638): the pyramid must still track the exhaustive
    argmax around the seeded center."""
    _holds_to_oracle(*_case("office", seed, rot_offset=np.pi))
