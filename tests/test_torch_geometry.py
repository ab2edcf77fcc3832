"""PyTorch port: SE(2) geometry helpers against the JAX package."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nautilus_tpu.core import geometry as jgeo
from nautilus_tpu_torch.core import geometry as tgeo

RNG = np.random.default_rng(7)
POSE = RNG.normal(size=(5, 3)).astype(np.float32) * [3, 3, 2]
POSE2 = RNG.normal(size=(5, 3)).astype(np.float32) * [3, 3, 2]
PTS = RNG.normal(size=(5, 9, 2)).astype(np.float32) * 4


def _both(name, *args):
    j = getattr(jgeo, name)(*[jnp.asarray(a) for a in args])
    t = getattr(tgeo, name)(*[torch.as_tensor(a) for a in args])
    return np.asarray(j), t.numpy()


@pytest.mark.parametrize("name,args", [
    ("angle_mod", (POSE[:, 2] * 5,)),
    ("angle_diff", (POSE[:, 2], POSE2[:, 2])),
    ("angle_dist", (POSE[:, 2], POSE2[:, 2])),
    ("rot2d", (POSE[:, 2],)),
    ("pose_transform_points", (POSE[:, None], PTS)),
    ("pose_inverse_transform_points", (POSE[:, None], PTS)),
    ("relative_pose_transform_points", (POSE[:, None], POSE2[:, None], PTS)),
    ("compose_relative", (POSE, POSE2)),
    ("distance_to_line_segment", (PTS, POSE[:, None, :2], POSE2[:, None, :2])),
    ("scatter_matrix_score", (PTS, PTS[..., 0] > -2)),
])
def test_geometry_matches_jax(name, args):
    j, t = _both(name, *args)
    # Float32 transcendental functions differ in the last bits.
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)


def test_normals_similar_and_degenerate_segment():
    n1 = np.array([[1.0, 0.0], [0.0, 1.0]], np.float32)
    n2 = np.array([[0.99, 0.1], [1.0, 0.0]], np.float32)
    j, t = _both("normals_similar", n1, n2, 0.9)
    np.testing.assert_array_equal(t, j)
    seg = np.zeros((1, 2), np.float32)
    j, t = _both("distance_to_line_segment", PTS[0], seg, seg)
    np.testing.assert_allclose(t, np.linalg.norm(PTS[0], axis=-1), rtol=1e-6)
