"""PyTorch port: feature association against the JAX package."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nautilus_tpu.ingest.synthetic import make_problem
from nautilus_tpu.solve import correspond as jcorr
from nautilus_tpu_torch.core.problem import problem_from_numpy
from nautilus_tpu_torch.solve import correspond as tcorr


@pytest.fixture(scope="module")
def problems():
    state, _ = make_problem(20, "office", num_beams=180, seed=3,
                            odom_noise_trans=0.02, odom_noise_rot=0.008)
    arrays = {f: np.asarray(getattr(state.problem, f))
              for f in state.problem._fields}
    x = state.solution.astype(np.float32)
    return state.problem, problem_from_numpy(arrays, "cpu"), x


def test_make_pairs_identical():
    a, b = jcorr.make_pairs(17, 4), tcorr.make_pairs(17, 4)
    np.testing.assert_array_equal(a.src, b.src)
    np.testing.assert_array_equal(a.tgt, b.tgt)


@pytest.mark.parametrize("feature", ["planar", "edge"])
@pytest.mark.parametrize("gate,window", [(False, 2), (True, 3)])
def test_associate_bitwise(problems, feature, gate, window):
    jprob, tprob, x = problems
    pairs = jcorr.make_pairs(jprob.num_nodes, 3)
    j = jcorr.associate(jprob, jnp.asarray(x), jnp.asarray(pairs.src),
                        jnp.asarray(pairs.tgt), window, 0.25,
                        feature=feature, use_normal_gate=gate)
    t = tcorr.associate(tprob, torch.as_tensor(x),
                        torch.as_tensor(pairs.src, dtype=torch.int64),
                        torch.as_tensor(pairs.tgt, dtype=torch.int64),
                        window, 0.25, feature=feature, use_normal_gate=gate)
    # Matched indices (first index on ties) and validity are bitwise equal,
    # so the gathered matches are the same points.
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    m = t.mask.numpy()
    np.testing.assert_array_equal(t.tgt_pts.numpy()[m],
                                  np.asarray(j.tgt_pts)[m])
    np.testing.assert_array_equal(t.tgt_nrm.numpy()[m],
                                  np.asarray(j.tgt_nrm)[m])
    np.testing.assert_array_equal(t.src_pts.numpy(), np.asarray(j.src_pts))
    assert m.sum() > 0
