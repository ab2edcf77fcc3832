"""PyTorch port: the relative pose error (utils/metrics.rpe) against the JAX
package's, float64 numpy on both sides."""

import numpy as np
import pytest

from nautilus_tpu.utils import metrics as jmetrics
from nautilus_tpu_torch.utils import metrics as tmetrics


def _trajectory(n=40, seed=0):
    rng = np.random.default_rng(seed)
    th = np.cumsum(rng.normal(0, 0.1, n))
    xy = np.cumsum(np.stack([np.cos(th), np.sin(th)], axis=1) * 0.5, axis=0)
    return np.concatenate([xy, th[:, None]], axis=1)


def _drifted(ref, seed):
    """ref with a random walk added to its positions and headings, and
    headings past +-pi so that the wrap is exercised."""
    rng = np.random.default_rng(seed)
    est = ref.copy()
    est[:, :2] += np.cumsum(rng.normal(0, 0.01, est[:, :2].shape), axis=0)
    est[:, 2] += np.cumsum(rng.normal(0, 0.02, len(est))) + 2 * np.pi
    return est


@pytest.mark.parametrize("delta", [1, 5, 39])
def test_rpe_matches_jax(delta):
    ref = _trajectory()
    est = _drifted(ref, seed=delta)
    got = tmetrics.rpe(est, ref, delta=delta)
    want = jmetrics.rpe(est, ref, delta=delta)
    assert set(got) == set(want) == {"trans_rmse", "trans_mean", "rot_rmse"}
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-12, abs=0)
    assert got["trans_rmse"] > 0 and got["rot_rmse"] > 0
    # Gauge invariance: a rigid motion of est changes nothing.
    c, s = np.cos(0.9), np.sin(0.9)
    moved = est.copy()
    moved[:, :2] = est[:, :2] @ np.array([[c, -s], [s, c]]).T + [-3.0, 7.0]
    moved[:, 2] += 0.9
    again = tmetrics.rpe(moved, ref, delta=delta)
    for key in want:
        assert again[key] == pytest.approx(got[key], rel=1e-9, abs=1e-12)


def test_rpe_needs_more_poses_than_delta():
    ref = _trajectory(n=3)
    with pytest.raises(ValueError, match="need more than 3 poses, got 3"):
        tmetrics.rpe(ref, ref, delta=3)
    with pytest.raises(ValueError):
        jmetrics.rpe(ref, ref, delta=3)
