"""PyTorch port on a CUDA card: the hand-written CSM kernels (the fused
coarse stage and the correlation of the pair engine) against their plain
PyTorch versions.

The file imports no jax, so it also runs where jax is not installed (the
repository's conftest imports jax, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda -q tests/test_torch_cuda.py

Without a card every test skips.
"""

import numpy as np
import pytest
import torch

from nautilus_tpu_torch.kernels import csm, csm_coarse, csm_correlate

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


# (C, P, R, cells, noff, halfwidth, res, integer_tables)
CASES = {
    # The shapes of test_torch_csm.py (and of the JAX package's fused-kernel
    # test): random normal tables, summed in another order than plain.
    "small": (2, 48, 8, 16, 5, 4.0, 0.5, False),
    # T = 240: the 225 KB table and the points exceed the 227 KB of shared
    # memory a block may use, so the kernel reads the table from global
    # memory.  Integer-valued tables make every sum exact in float32, so
    # the two versions agree bit for bit whatever their order.
    "table_in_global": (2, 768, 16, 226, 15, 33.9, 0.3, True),
}


def _inputs(dev, C, P, R, cells, noff, halfwidth, integer_tables, seed=5):
    rng = np.random.default_rng(seed)
    T = cells + noff - 1
    pts = rng.uniform(-halfwidth, halfwidth, (C, P, 2))
    mask = rng.random((C, P)) > 0.2
    parked = np.where(mask[..., None], pts, 1e6).astype(np.float32)
    thetas = rng.uniform(-1.5, 1.5, (C, R)).astype(np.float32)
    tables = (rng.integers(-8, 8, (C, T, T)) if integer_tables
              else rng.normal(size=(C, T, T))).astype(np.float32)
    return [torch.as_tensor(a, device=dev) for a in (parked, thetas, tables)]


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain_on_card(dev, case):
    C, P, R, cells, noff, hw, res, integer_tables = CASES[case]
    parked, thetas, tables = _inputs(dev, C, P, R, cells, noff, hw,
                                     integer_tables)
    kw = dict(cells=cells, noff=noff, halfwidth=hw, res=res)
    T = cells + noff - 1
    assert csm_coarse.table_in_shared_memory(T, P) == (case == "small")
    before = csm_coarse.fused_coarse.launches
    out = csm_coarse.fused_coarse(parked, thetas, tables, **kw)
    ref = csm_coarse.fused_coarse_reference(parked, thetas, tables, **kw)
    torch.cuda.synchronize()
    assert csm_coarse.fused_coarse.launches == before + 1
    assert out.shape == (C, R, noff, noff)
    if integer_tables:
        assert bool(torch.any(out != 0))
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
    else:
        # Same float32 table values summed in another order.
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-4)


def test_masked_out_of_raster_and_empty_score_zero_on_card(dev):
    C, P, R, cells, noff, hw, res, _ = CASES["small"]
    parked, thetas, tables = _inputs(dev, C, P, R, cells, noff, hw, False)
    parked[0] = 1e6                     # every point masked (parked)
    parked[1] = 50.0                    # every point outside the raster
    kw = dict(cells=cells, noff=noff, halfwidth=hw, res=res)
    out = csm_coarse.fused_coarse(parked, thetas, tables, **kw)
    empty = csm_coarse.fused_coarse(parked[:, :0].contiguous(), thetas,
                                    tables, **kw)
    torch.cuda.synchronize()
    assert torch.all(out == 0)
    assert empty.shape == out.shape and torch.all(empty == 0)


# (B, H, R, kh, table kind): the correlation at the shapes of the pair
# engine, with rasters of rotated scan points as the engine builds them.
CORRELATE_CASES = {
    # Log-occupancy tables, as CSM's are: every term of a score has the same
    # sign, so the float32 sums differ from plain only in their last bits.
    "log_table": (2, 214, 16, 200, "log"),
    # Integer tables: every partial sum is exact, any order gives the same
    # bits.
    "integer": (2, 214, 16, 200, "integer"),
    # H = 240: the 225 KB table and the kernel's lists exceed the 227 KB of
    # shared memory a block may use, so the table is read from global memory.
    "table_in_global": (2, 240, 16, 226, "integer"),
}


def _correlate_inputs(dev, B, H, R, kh, kind, seed=7, P=768):
    rng = np.random.default_rng(seed)
    res = 0.3
    half = kh * res / 2
    r = rng.uniform(0.5, half, (B, P))
    a = rng.uniform(-np.pi, np.pi, (B, P))
    pts = torch.as_tensor(np.stack([r * np.cos(a), r * np.sin(a)], -1)
                          .astype(np.float32), device=dev)
    mask = torch.as_tensor(rng.random((B, P)) > 0.1, device=dev)
    thetas = torch.as_tensor(rng.uniform(-np.pi, np.pi, (B, R))
                             .astype(np.float32), device=dev)
    rot = csm._rotate(pts[:, None], thetas)
    rasters = csm._raster(rot.reshape(B * R, P, 2),
                          mask[:, None].expand(B, R, P).reshape(B * R, P),
                          half, res, kh).reshape(B, R, kh, kh)
    if kind == "log":
        occ = rng.random((B, H, H)) * (rng.random((B, H, H)) < 0.3)
        tables = np.log(occ + 1e-6)
    else:
        tables = rng.integers(-8, 8, (B, H, H))
    tables = torch.as_tensor(tables.astype(np.float32), device=dev)
    return tables.to(torch.bfloat16).to(torch.float32), rasters


@pytest.mark.parametrize("case", list(CORRELATE_CASES))
def test_correlate_matches_plain_on_card(dev, case):
    B, H, R, kh, kind = CORRELATE_CASES[case]
    tables, rasters = _correlate_inputs(dev, B, H, R, kh, kind)
    assert csm_correlate.table_in_shared_memory(H, H) == (H == 214)
    before = csm_correlate.correlate.launches
    out = csm_correlate.correlate(tables, rasters)
    ref = csm_correlate.correlate_reference(tables, rasters)
    torch.cuda.synchronize()
    assert csm_correlate.correlate.launches == before + 1
    assert out.shape == (B, R, H - kh + 1, H - kh + 1)
    assert bool(torch.any(out != 0))
    if kind == "integer":
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
    else:
        # Same float32 values summed in another order.
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-4)
    k, p = out.reshape(B, -1).argmax(1), ref.reshape(B, -1).argmax(1)
    rows = torch.arange(B, device=dev)
    flat = ref.reshape(B, -1)
    assert bool(((k == p) | (flat[rows, k] == flat[rows, p])).all())


def test_correlate_empty_rasters_score_zero_on_card(dev):
    tables, rasters = _correlate_inputs(dev, 2, 46, 5, 32, "log")
    out = csm_correlate.correlate(tables, torch.zeros_like(rasters))
    single = csm_correlate.correlate(tables[0], rasters[0])
    torch.cuda.synchronize()
    assert torch.all(out == 0)
    torch.testing.assert_close(single, csm_correlate.correlate_reference(
        tables[:1], rasters[:1])[0], rtol=1e-5, atol=1e-4)
