"""PyTorch port: Hough-accumulator normals against the JAX package, on the
same numpy clouds.

The votes are integer counts, so the winning bin matches exactly unless an
angle sits within rounding of a bin edge (rsqrt and acos differ in the last
bit between the packages) in a point whose two best bins tie or differ by
one vote.  Where the bins agree the normal is the cosine and sine of a mean
of the same float32 angles, up to acos: near |x| = 1 (a wall facing the x
axis) acos turns a 1-ulp difference of the line normal's x component into
1 / sqrt(1 - x^2) as much, 1.3e-5 at worst on these worlds.  So the normals
are held to 1e-4, and a point beyond that counts as a changed bin (a bin is
0.196 rad wide): none occurs on the synthetic worlds below.
"""

import numpy as np
import pytest
import torch

from nautilus_tpu.core import preprocess as jpre
from nautilus_tpu.ingest.synthetic import synthesize
from nautilus_tpu_torch.core import preprocess as tpre

ATOL = 1e-4
WORLDS = [("office", 10, 180, 0), ("building", 8, 240, 1), ("room", 8, 240, 4)]


def _both(kind, n, beams, seed, **kw):
    raw, _ = synthesize(n, kind, num_beams=beams, seed=seed)
    jn = np.asarray(jpre.compute_normals(
        raw.points, raw.points_mask, jpre.NormalParams(method="hough", **kw)))
    tn = tpre.compute_normals(
        torch.as_tensor(raw.points), torch.as_tensor(raw.points_mask),
        tpre.NormalParams(method="hough", **kw)).numpy()
    return raw, jn, tn


@pytest.mark.parametrize("kind,n,beams,seed", WORLDS)
def test_hough_normals_match_jax(kind, n, beams, seed):
    raw, jn, tn = _both(kind, n, beams, seed)
    valid = raw.points_mask
    assert tn.shape == jn.shape
    np.testing.assert_array_equal(tn[~valid], 0.0)
    err = np.abs(tn - jn).max(axis=-1)[valid]
    # No point of these worlds lands in another bin: every normal agrees.
    assert (err > ATOL).sum() == 0, (int((err > ATOL).sum()), err.max())
    norms = np.linalg.norm(tn[valid], axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)


def test_hough_params_change_the_result_as_in_jax():
    raw, jn, tn = _both("office", 6, 180, 2, k_neighbors=8, bin_number=16,
                        mean_distance=0.2)
    np.testing.assert_allclose(tn, jn, atol=ATOL, rtol=0)
    _, _, base = _both("office", 6, 180, 2)
    assert np.abs(tn - base).max() > 1e-3


def test_hough_vote_ties_take_the_first_bin():
    """Three collinear neighbours along x and three along y around the
    centre give two bins with equal votes; the lower bin wins, as
    jnp.argmax picks it."""
    pts = np.zeros((1, 128, 2), np.float32)
    pts[0, :7] = [[0, 0], [0.05, 0], [0.1, 0], [-0.05, 0],
                  [0, 0.05], [0, 0.1], [0, -0.05]]
    mask = np.zeros((1, 128), bool)
    mask[0, :7] = True
    params = dict(method="hough", k_neighbors=6, mean_distance=0.1)
    jn = np.asarray(jpre.compute_normals(pts, mask,
                                         jpre.NormalParams(**params)))
    tn = tpre.compute_normals(torch.as_tensor(pts), torch.as_tensor(mask),
                              tpre.NormalParams(**params)).numpy()
    np.testing.assert_allclose(tn[0, :7], jn[0, :7], atol=ATOL, rtol=0)


def test_hough_agrees_with_pca_on_walls():
    """The two estimators agree within 20 degrees on most points (normals
    are lines: compare |cos|); 0.64 of them on this world.  The accumulator
    bins angles in [0, pi], so a wall facing the x axis splits its votes
    between the bins at 0 and at pi, in the JAX package too."""
    raw, _ = synthesize(8, "room", num_beams=240, seed=4)
    pts, msk = torch.as_tensor(raw.points), torch.as_tensor(raw.points_mask)
    hough = tpre.compute_normals(pts, msk, tpre.NormalParams(method="hough"))
    pca = tpre.compute_normals(pts, msk, tpre.NormalParams())
    cos = torch.abs(torch.sum(hough * pca, dim=-1))[msk]
    assert float((cos > np.cos(np.deg2rad(20))).float().mean()) > 0.5


def test_unknown_normal_method_raises():
    raw, _ = synthesize(2, "room", num_beams=120, seed=0)
    with pytest.raises(ValueError, match="normal method"):
        tpre.compute_normals(torch.as_tensor(raw.points),
                             torch.as_tensor(raw.points_mask),
                             tpre.NormalParams(method="ransac"))
