"""PyTorch port: the coarse CSM correlation (plain version of the CUDA
kernel) and the pair engine's coarse stage against the JAX package (the
Pallas kernel in interpret mode, and its XLA forms)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nautilus_tpu.kernels import csm as jcsm
from nautilus_tpu.kernels.csm_pallas import correlate_pallas
from nautilus_tpu_torch.kernels import csm as tcsm
from nautilus_tpu_torch.kernels.csm_correlate import (correlate,
                                                      correlate_reference)


def _bf16_inputs(seed=3, H=46, R=5, k=32):
    """The inputs of tests/test_loop_closure.py's correlate-paths test:
    normal values rounded through bfloat16, held in float32."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(H, H)).astype(np.float32)
    kernels = rng.normal(size=(R, k, k)).astype(np.float32)
    q = lambda a: np.array(jnp.asarray(a).astype(jnp.bfloat16)
                           .astype(jnp.float32))
    return q(table), q(kernels)


def test_reference_matches_pallas_interpret_and_matmul():
    table, kernels = _bf16_inputs()
    pallas = np.asarray(correlate_pallas(jnp.asarray(table),
                                         jnp.asarray(kernels),
                                         interpret=True))
    matmul = np.asarray(jcsm._correlate_matmul(jnp.asarray(table),
                                               jnp.asarray(kernels)))
    before = correlate.launches
    out = correlate(torch.as_tensor(table), torch.as_tensor(kernels)).numpy()
    assert correlate.launches == before        # CPU: the plain version
    np.testing.assert_array_equal(out, correlate_reference(
        torch.as_tensor(table)[None], torch.as_tensor(kernels)[None])[0])
    assert out.shape == pallas.shape == (5, 15, 15)
    # Same float32 values summed in another order.
    np.testing.assert_allclose(out, pallas, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(out, matmul, rtol=1e-5, atol=1e-4)


def test_integer_inputs_agree_exactly_with_pallas():
    """Integer tables and count rasters: every partial sum is an exact
    float32, so any summation order gives the same bits."""
    rng = np.random.default_rng(4)
    table = rng.integers(-8, 8, (30, 27)).astype(np.float32)
    kernels = (rng.random((3, 20, 19)) < 0.1) * rng.integers(1, 4, (3, 20, 19))
    kernels = kernels.astype(np.float32)
    pallas = np.asarray(correlate_pallas(jnp.asarray(table),
                                         jnp.asarray(kernels),
                                         interpret=True))
    out = correlate(torch.as_tensor(table), torch.as_tensor(kernels)).numpy()
    assert out.shape == (3, 11, 9)
    np.testing.assert_array_equal(out, pallas)


def test_batched_equals_per_pair():
    rng = np.random.default_rng(5)
    tables = torch.as_tensor(rng.normal(size=(3, 24, 24)).astype(np.float32))
    kernels = torch.as_tensor(rng.normal(size=(3, 4, 16, 16))
                              .astype(np.float32))
    out = correlate(tables, kernels)
    assert out.shape == (3, 4, 9, 9)
    for b in range(3):
        # One batched product against one per pair: same sums, exactly.
        torch.testing.assert_close(out[b], correlate(tables[b], kernels[b]),
                                   rtol=0, atol=0)


def test_wrapper_rejects_bad_inputs():
    table, kernels = [torch.as_tensor(a) for a in _bf16_inputs()]
    with pytest.raises(TypeError):
        correlate(table.double(), kernels)
    with pytest.raises(ValueError, match="contiguous"):
        correlate(table.T, kernels)
    with pytest.raises(ValueError):
        correlate(table, kernels[None])           # [H, W] takes [R, kh, kw]
    with pytest.raises(ValueError, match="does not fit"):
        correlate(table[None], torch.zeros((1, 2, 47, 10)))
    with pytest.raises(ValueError, match="offsets"):
        correlate(table, torch.zeros((5, 8, 8)))  # 39 x 39 offsets > 16 x 16
    with pytest.raises(ValueError, match="meta"):
        correlate(table, kernels.to("meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        correlate(table.to("meta"), kernels.to("meta"))


@pytest.mark.parametrize("coarse_f32", [False, True])
def test_search_stage_matches_jax(coarse_f32):
    """The pair engine's coarse stage (rotate, raster, correlate) on clouds
    shaped like scans, against JAX's _search_stage per pair."""
    rng = np.random.default_rng(6)
    params = tcsm.CSMParams(scan_range=6.0, coarse_f32=coarse_f32)
    B, P, R = 2, 200, 12
    r = rng.uniform(0.5, 6.0, (B, P))
    a = rng.uniform(-np.pi, np.pi, (B, P))
    pts = np.stack([r * np.cos(a), r * np.sin(a)], -1).astype(np.float32)
    mask = rng.random((B, P)) > 0.1
    thetas = rng.uniform(-1.5, 1.5, (B, R)).astype(np.float32)
    table, _ = tcsm.build_tables(torch.as_tensor(pts[::-1].copy()),
                                 torch.ones((B, P), dtype=torch.bool), params)
    table = tcsm._coarse_table(table, params)
    out = tcsm._search_stage(table, torch.as_tensor(pts),
                             torch.as_tensor(mask), torch.as_tensor(thetas),
                             params.low_res, params.scan_range).numpy()
    assert out.shape == (B, R, 15, 15)
    dt = jnp.float32 if coarse_f32 else jnp.bfloat16
    for b in range(B):
        ref = np.asarray(jcsm._search_stage(
            jnp.asarray(table[b].numpy()), jnp.asarray(pts[b]),
            jnp.asarray(mask[b]), jnp.asarray(thetas[b]), params.low_res,
            params.scan_range, params.trans_range, operand_dtype=dt))
        # The same counts and table values summed in another order.
        np.testing.assert_allclose(out[b], ref, rtol=1e-5, atol=1e-4)
