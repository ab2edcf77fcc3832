"""PyTorch port: the fused CSM coarse stage, the stage-major matcher and
the pair-major matcher against the JAX package (Pallas kernel in interpret
mode)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nautilus_tpu.ingest.synthetic import make_problem
from nautilus_tpu.kernels.csm import CSMParams as JParams
from nautilus_tpu.kernels.csm import csm_match as jax_csm_match
from nautilus_tpu.kernels.csm import csm_match_pairs as jax_match_pairs
from nautilus_tpu.kernels.csm_pallas import fused_coarse_pallas
from nautilus_tpu_torch.kernels import csm_coarse
from nautilus_tpu_torch.kernels.csm import (CSMParams, csm_match,
                                            csm_match_pairs)
from nautilus_tpu_torch.kernels.csm_correlate import correlate


def _coarse_inputs(seed=5, C=2, P=48, R=8, cells=16, noff=5):
    """The inputs of tests/test_loop_closure.py's fused-kernel test."""
    rng = np.random.default_rng(seed)
    T = cells + noff - 1
    pts = rng.uniform(-3.5, 3.5, (C, P, 2)).astype(np.float32)
    mask = rng.random((C, P)) > 0.2
    parked = np.where(mask[..., None], pts, 1e6).astype(np.float32)
    thetas = rng.uniform(-1.5, 1.5, (C, R)).astype(np.float32)
    tables = rng.normal(size=(C, T, T)).astype(np.float32)
    return parked, thetas, tables


KW = dict(cells=16, noff=5, halfwidth=4.0, res=0.5)


def test_reference_matches_pallas_interpret():
    parked, thetas, tables = _coarse_inputs()
    ref = np.asarray(fused_coarse_pallas(
        jnp.asarray(parked), jnp.asarray(thetas), jnp.asarray(tables),
        rot_block=4, interpret=True, **KW))
    before = csm_coarse.fused_coarse.launches
    out = csm_coarse.fused_coarse(torch.as_tensor(parked),
                                  torch.as_tensor(thetas),
                                  torch.as_tensor(tables), **KW).numpy()
    assert csm_coarse.fused_coarse.launches == before   # CPU: plain version
    assert out.shape == ref.shape == (2, 8, 5, 5)
    # Same float32 table values summed in another order.
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(out.reshape(2, -1).argmax(1),
                                  ref.reshape(2, -1).argmax(1))


def test_out_of_raster_and_masked_pairs_score_zero():
    parked, thetas, tables = _coarse_inputs()
    parked[0] = 1e6                     # every point masked (parked)
    parked[1] = np.float32(50.0)        # every point outside the raster
    out = csm_coarse.fused_coarse(torch.as_tensor(parked),
                                  torch.as_tensor(thetas),
                                  torch.as_tensor(tables), **KW)
    assert torch.all(out == 0)


def test_wrapper_rejects_bad_inputs():
    parked, thetas, tables = [torch.as_tensor(a) for a in _coarse_inputs()]
    with pytest.raises(TypeError):
        csm_coarse.fused_coarse(parked.double(), thetas, tables, **KW)
    with pytest.raises(ValueError):
        csm_coarse.fused_coarse(parked, thetas, tables[:, 1:], **KW)
    with pytest.raises(ValueError):
        csm_coarse.fused_coarse(parked.transpose(0, 1), thetas, tables, **KW)
    with pytest.raises(ValueError):
        csm_coarse.fused_coarse(parked, thetas, tables, cells=4, noff=17,
                                halfwidth=4.0, res=0.5)


@pytest.fixture(scope="module")
def pairs():
    state, _ = make_problem(16, "office", num_beams=360, seed=0)
    pts = np.asarray(state.problem.points)
    msk = np.asarray(state.problem.points_mask)
    ss = np.array([0, 3, 5, 10, 12, 2])
    tt = np.array([1, 5, 9, 11, 14, 15])
    centers = np.arctan2(np.sin(state.solution[ss, 2] - state.solution[tt, 2]),
                         np.cos(state.solution[ss, 2] - state.solution[tt, 2]))
    return pts, msk, ss, tt, centers


@pytest.mark.parametrize("coarse_f32", [False, True])
def test_csm_match_pairs_matches_jax(pairs, coarse_f32):
    pts, msk, ss, tt, centers = pairs
    kw = dict(scan_range=10.0, high_res=0.05, coarse_f32=coarse_f32)
    js, jtr = jax_match_pairs(pts, msk, ss, tt, JParams(**kw),
                              rotation_centers=centers)
    ts, ttr = csm_match_pairs(torch.tensor(pts), torch.tensor(msk),
                              ss, tt, CSMParams(**kw),
                              rotation_centers=centers, pair_chunk=4)
    np.testing.assert_allclose(ts, js, atol=1e-4, rtol=0)
    # Transforms agree to the finest grid step (high_res in translation,
    # high_res / scan_range in rotation).
    np.testing.assert_allclose(ttr[:, :2], jtr[:, :2], atol=0.05 + 1e-6,
                               rtol=0)
    np.testing.assert_allclose(ttr[:, 2], jtr[:, 2], atol=0.005 + 1e-6,
                               rtol=0)


@pytest.mark.parametrize("coarse_f32", [False, True])
def test_pair_engine_matches_jax(pairs, coarse_f32):
    pts, msk, ss, tt, centers = pairs
    kw = dict(scan_range=10.0, high_res=0.05, coarse_f32=coarse_f32)
    js, jtr = jax_match_pairs(pts, msk, ss, tt, JParams(**kw),
                              rotation_centers=centers, engine="pair")
    before = correlate.launches
    ts, ttr = csm_match_pairs(torch.tensor(pts), torch.tensor(msk), ss, tt,
                              CSMParams(**kw), rotation_centers=centers,
                              engine="pair", pair_chunk=4)
    assert correlate.launches == before           # CPU: the plain version
    assert ts.shape == (6,) and ttr.shape == (6, 3)
    # The tolerances of test_csm_match_pairs_matches_jax above.
    np.testing.assert_allclose(ts, js, atol=1e-4, rtol=0)
    np.testing.assert_allclose(ttr[:, :2], jtr[:, :2], atol=0.05 + 1e-6,
                               rtol=0)
    np.testing.assert_allclose(ttr[:, 2], jtr[:, 2], atol=0.005 + 1e-6,
                               rtol=0)


def test_csm_match_matches_jax(pairs):
    """The single-pair GetTransformation contract, rotation window centred
    away from zero."""
    pts, msk, ss, tt, centers = pairs
    kw = dict(scan_range=10.0, high_res=0.05)
    s, t = int(ss[1]), int(tt[1])
    js, jtr = jax_csm_match(jnp.asarray(pts[s]), jnp.asarray(msk[s]),
                            jnp.asarray(pts[t]), jnp.asarray(msk[t]),
                            JParams(**kw), float(centers[1]))
    ts, ttr = csm_match(torch.tensor(pts[s]), torch.tensor(msk[s]),
                        torch.tensor(pts[t]), torch.tensor(msk[t]),
                        CSMParams(**kw), float(centers[1]))
    assert ts.shape == () and ttr.shape == (3,)
    np.testing.assert_allclose(float(ts), float(js), atol=1e-4, rtol=0)
    np.testing.assert_allclose(ttr[:2].numpy(), np.asarray(jtr)[:2],
                               atol=0.05 + 1e-6, rtol=0)
    np.testing.assert_allclose(float(ttr[2]), float(jtr[2]),
                               atol=0.005 + 1e-6, rtol=0)


def test_pair_engine_matches_stage_engine():
    """As tests/test_loop_closure.py does for the JAX engines: the same
    public entry point through both engines, on the same pairs."""
    state, _ = make_problem(12, "office", num_beams=360, seed=9)
    pts = torch.tensor(np.asarray(state.problem.points))
    msk = torch.tensor(np.asarray(state.problem.points_mask))
    src = np.array([1, 2, 3, 5, 9])
    tgt = np.array([0, 0, 1, 4, 8])
    centers = np.asarray(state.solution[src, 2] - state.solution[tgt, 2],
                         np.float32)
    params = CSMParams(scan_range=10.0, high_res=0.05)
    s1, t1 = csm_match_pairs(pts, msk, src, tgt, params,
                             rotation_centers=centers, engine="pair",
                             pair_chunk=2)
    s2, t2 = csm_match_pairs(pts, msk, src, tgt, params,
                             rotation_centers=centers, engine="stage")
    assert s1.shape == (5,) and t1.shape == (5, 3)
    # The JAX engines agree to 1e-5; so do the port's.
    np.testing.assert_allclose(s1, s2, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t1, t2, atol=1e-5)
    with pytest.raises(ValueError, match="engine"):
        csm_match_pairs(pts, msk, src, tgt, params, engine="grouped")
