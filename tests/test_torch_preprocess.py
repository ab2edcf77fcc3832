"""PyTorch port: normals + feature selection against the JAX package."""

import numpy as np
import pytest
import torch

from nautilus_tpu.core.preprocess import preprocess as jax_preprocess
from nautilus_tpu.ingest.synthetic import synthesize
from nautilus_tpu_torch.core import preprocess as tpre


@pytest.mark.parametrize("kind,n,beams,seed", [
    ("office", 24, 180, 0), ("building", 16, 360, 1), ("room", 12, 360, 4)])
def test_preprocess_matches_jax(kind, n, beams, seed):
    raw, _ = synthesize(n, kind, num_beams=beams, seed=seed)
    jn, jpi, jpm, jei, jem, jsc = jax_preprocess(raw.points, raw.points_mask)
    tn, tpi, tpm, tei, tem, tsc = [t.numpy() for t in tpre.preprocess(
        raw.points, raw.points_mask, "cpu")]
    # Normals: float32 PCA, last-bit differences in the eigenvector math.
    np.testing.assert_allclose(tn, jn, atol=1e-5, rtol=0)
    # Scores come out bit-identical (fixed summation order), so the greedy
    # selection visits candidates in the same order.
    np.testing.assert_array_equal(tsc, jsc)
    np.testing.assert_array_equal(tpm, jpm)
    np.testing.assert_array_equal(tpi, jpi)
    np.testing.assert_array_equal(tem, jem)
    np.testing.assert_array_equal(tei, jei)


def test_fixed_order_sums_match_plain_sums():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(3, 5, 768)), dtype=torch.float32)
    torch.testing.assert_close(tpre._sum_fixed(x), x.sum(-1), rtol=1e-5,
                               atol=1e-4)
    w = torch.as_tensor(rng.random((2, 64, 128)) > 0.5, dtype=torch.float32)
    p = torch.as_tensor(rng.normal(size=(2, 128, 2)), dtype=torch.float32)
    torch.testing.assert_close(tpre._matmul_fixed(w, p), w @ p, rtol=1e-5,
                               atol=1e-4)


def test_preprocess_takes_hough_normals():
    """preprocess takes method="hough" (tests/test_torch_hough.py holds the
    estimator to the JAX package), and only the normals change."""
    raw, _ = synthesize(4, "room", num_beams=180, seed=0)
    out = tpre.preprocess(raw.points, raw.points_mask, "cpu",
                          normal_params=tpre.NormalParams(method="hough"))
    pca = tpre.preprocess(raw.points, raw.points_mask, "cpu")
    normals = out[0].numpy()
    assert normals.shape == raw.points.shape
    np.testing.assert_allclose(
        np.linalg.norm(normals[raw.points_mask], axis=-1), 1.0, atol=1e-5)
    # Only the normals depend on the estimator.
    for a, b in zip(out[1:], pca[1:]):
        assert torch.equal(a, b)
