"""PyTorch port: the CPU scan-match twin (nautilus_tpu_torch/baseline/
cpu_csm.py) against the JAX package's twin, and against the port's stage
engine (the fused coarse stage) and pair engine (the correlation stage) on
the CPU.

The two twins are the same numpy float32 program on the same clouds: equal
to the bit.  The engines against the twin: the JAX package's bars, scores
within 2e-3 and transforms within 2e-2 (tests/test_cpu_csm.py).  The
engines round the coarse table through bfloat16 unless ``coarse_f32``; the
twin scores the float32 table, and the last two tests show that on a
normal scan both precisions land on the same transform."""

import numpy as np
import pytest
import torch

from nautilus_tpu.baseline import cpu_csm as jcpu_csm
from nautilus_tpu.kernels.csm import CSMParams as JParams
from nautilus_tpu_torch.baseline.cpu_csm import (csm_match_batch_cpu,
                                                 csm_match_cpu)
from nautilus_tpu_torch.ingest.synthetic import (make_world, raycast,
                                                 scan_to_points)
from nautilus_tpu_torch.kernels.csm import (CSMParams, csm_match,
                                            csm_match_batch, csm_match_pairs)

SCORE_ATOL = 2e-3
TRANSFORM_ATOL = 2e-2
PARAMS = CSMParams(scan_range=10.0, high_res=0.05)
JPARAMS = JParams(scan_range=10.0, high_res=0.05)
ENGINES = ("stage", "pair")


def _pad(c, p=1024):
    out = np.zeros((p, 2), np.float32)
    m = np.zeros(p, bool)
    out[:len(c)] = c
    m[:len(c)] = True
    return torch.as_tensor(out), torch.as_tensor(m)


def _scan_at(world, pose):
    return scan_to_points(raycast(world, pose, 720, max_range=10),
                          max_range=10).astype(np.float32)


def _pair_at(true_t, pose_b=(1.0, 2.0, 0.3)):
    """Clouds of two poses: A at ``true_t`` in B's frame."""
    world = make_world("office")
    pose_b = np.asarray(pose_b)
    c, s = np.cos(pose_b[2]), np.sin(pose_b[2])
    ta = pose_b[:2] + np.array([[c, -s], [s, c]]) @ true_t[:2]
    pose_a = np.array([ta[0], ta[1], pose_b[2] + true_t[2]])
    return _scan_at(world, pose_a), _scan_at(world, pose_b)


def _engines(clouds, src, tgt, params, centers=None):
    """Both engines of csm_match_pairs on padded clouds."""
    padded = [_pad(c) for c in clouds]
    pts = torch.stack([p for p, _ in padded])
    msk = torch.stack([m for _, m in padded])
    return {e: csm_match_pairs(pts, msk, src, tgt, params,
                               rotation_centers=centers, engine=e)
            for e in ENGINES}


@pytest.mark.parametrize("true_t", [
    np.array([0.8, -0.5, 0.25]),
    np.array([-0.4, 1.1, -0.6]),
])
def test_cpu_matches_jax_twin_and_engines(true_t):
    cl_a, cl_b = _pair_at(true_t)
    s_c, tr_c = csm_match_cpu(cl_a, cl_b, PARAMS)
    js_c, jtr_c = jcpu_csm.csm_match_cpu(cl_a, cl_b, JPARAMS)
    assert s_c == js_c
    np.testing.assert_array_equal(tr_c, jtr_c)
    a, ma = _pad(cl_a)
    b, mb = _pad(cl_b)
    s_t, tr_t = csm_match(a, ma, b, mb, PARAMS)
    assert abs(s_c - float(s_t)) < SCORE_ATOL
    np.testing.assert_allclose(tr_c, tr_t.numpy(), atol=TRANSFORM_ATOL)
    for engine, (s_e, tr_e) in _engines([cl_a, cl_b], [0], [1],
                                        PARAMS).items():
        assert abs(s_c - s_e[0]) < SCORE_ATOL, engine
        np.testing.assert_allclose(tr_c, tr_e[0], atol=TRANSFORM_ATOL,
                                   err_msg=engine)


def test_cpu_batch_matches_jax_twin_and_engines():
    world = make_world("office")
    poses = [np.array([1.0, 2.0, 0.3]), np.array([1.4, 2.2, 0.5]),
             np.array([0.6, 1.5, -0.2])]
    clouds = [_scan_at(world, p) for p in poses]
    masks = [np.ones(len(c), bool) for c in clouds]
    args = ([clouds[1], clouds[2]], [masks[1], masks[2]],
            [clouds[0], clouds[0]], [masks[0], masks[0]])
    s_c, tr_c = csm_match_batch_cpu(*args, PARAMS)
    js_c, jtr_c = jcpu_csm.csm_match_batch_cpu(*args, JPARAMS)
    np.testing.assert_array_equal(s_c, js_c)
    np.testing.assert_array_equal(tr_c, jtr_c)
    padded = [_pad(c) for c in clouds]
    A = torch.stack([padded[i][0] for i in (1, 2)])
    MA = torch.stack([padded[i][1] for i in (1, 2)])
    B = torch.stack([padded[0][0]] * 2)
    MB = torch.stack([padded[0][1]] * 2)
    s_t, tr_t = csm_match_batch(A, MA, B, MB, PARAMS)
    np.testing.assert_allclose(s_c, s_t.numpy(), atol=SCORE_ATOL)
    np.testing.assert_allclose(tr_c, tr_t.numpy(), atol=TRANSFORM_ATOL)
    for engine, (s_e, tr_e) in _engines(clouds, [1, 2], [0, 0],
                                        PARAMS).items():
        np.testing.assert_allclose(s_c, s_e, atol=SCORE_ATOL, err_msg=engine)
        np.testing.assert_allclose(tr_c, tr_e, atol=TRANSFORM_ATOL,
                                   err_msg=engine)


def test_rotation_center_cpu():
    """The twin honors the seeded rotation window as the engines do."""
    true_t = np.array([0.3, -0.2, np.pi * 0.95])
    cl_a, cl_b = _pair_at(true_t)
    center = float(true_t[2]) + 0.1
    score, tr = csm_match_cpu(cl_a, cl_b, PARAMS, rotation_center=center)
    js, jtr = jcpu_csm.csm_match_cpu(cl_a, cl_b, JPARAMS,
                                     rotation_center=center)
    assert score == js
    np.testing.assert_array_equal(tr, jtr)
    d_th = np.arctan2(np.sin(tr[2] - true_t[2]), np.cos(tr[2] - true_t[2]))
    assert abs(d_th) < 0.06
    assert np.linalg.norm(tr[:2] - true_t[:2]) < 0.15
    for engine, (s_e, tr_e) in _engines([cl_a, cl_b], [0], [1], PARAMS,
                                        centers=[center]).items():
        assert abs(score - s_e[0]) < SCORE_ATOL, engine
        np.testing.assert_allclose(tr, tr_e[0], atol=TRANSFORM_ATOL,
                                   err_msg=engine)


def test_coarse_f32_escape_hatch_parity():
    """CSMParams(coarse_f32=True) scores the float32 coarse table, as the
    twin does; on a normal scan both precisions land on the same
    transform, and the float32 one on the twin's."""
    world = make_world("office")
    cl_a = _scan_at(world, np.array([1.6, 1.7, 0.55]))
    cl_b = _scan_at(world, np.array([1.0, 2.0, 0.3]))
    a, ma = _pad(cl_a)
    b, mb = _pad(cl_b)
    hi = PARAMS._replace(coarse_f32=True)
    s_lo, tr_lo = csm_match(a, ma, b, mb, PARAMS)
    s_hi, tr_hi = csm_match(a, ma, b, mb, hi)
    np.testing.assert_allclose(tr_lo.numpy(), tr_hi.numpy(),
                               atol=TRANSFORM_ATOL)
    assert abs(float(s_lo) - float(s_hi)) < SCORE_ATOL
    s_c, tr_c = csm_match_cpu(cl_a, cl_b, hi)
    assert abs(s_c - float(s_hi)) < SCORE_ATOL
    np.testing.assert_allclose(tr_c, tr_hi.numpy(), atol=TRANSFORM_ATOL)


def test_coarse_f32_stage_major_engine():
    world = make_world("office")
    poses = [np.array([1.0, 2.0, 0.3]), np.array([1.4, 2.2, 0.5]),
             np.array([0.6, 1.5, -0.2])]
    clouds = [_scan_at(world, p) for p in poses]
    hi = PARAMS._replace(coarse_f32=True)
    s_lo, tr_lo = _engines(clouds, [1, 2], [0, 0], PARAMS)["stage"]
    s_hi, tr_hi = _engines(clouds, [1, 2], [0, 0], hi)["stage"]
    np.testing.assert_allclose(tr_lo, tr_hi, atol=TRANSFORM_ATOL)
    np.testing.assert_allclose(s_lo, s_hi, atol=SCORE_ATOL)
