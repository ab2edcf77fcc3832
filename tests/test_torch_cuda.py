"""PyTorch port on a CUDA card: the hand-written CSM kernels (the fused
coarse stage and the correlation of the pair engine) against their plain
PyTorch versions, at the main path's shapes and at the edges of their
launch plans (kernels/plan.py).

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
    # T = 240: the 225 KB table and the cell lists exceed the 227 KB of
    # shared memory a block may use, so the kernel reads the table from
    # global memory.  Integer-valued tables make every sum exact in float32,
    # so the two versions agree bit for bit whatever their order.
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


def _log_tables(rng, shape):
    """CSM-like log-occupancy tables rounded through bf16: every term of a
    score has the same sign."""
    occ = rng.random(shape) * (rng.random(shape) < 0.3)
    t = torch.as_tensor(np.log(occ + 1e-6).astype(np.float32))
    return t.to(torch.bfloat16).to(torch.float32)


def _coarse_check(dev, parked, thetas, tables, exact, **kw):
    before = csm_coarse.fused_coarse.launches
    out = csm_coarse.fused_coarse(parked, thetas, tables, **kw)
    ref = csm_coarse.fused_coarse_reference(parked, thetas, tables, **kw)
    torch.cuda.synchronize()
    assert csm_coarse.fused_coarse.launches == before + 1
    C, R = thetas.shape
    assert out.shape == (C, R, kw["noff"], kw["noff"])
    if exact:
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
    else:
        # Same float32 table values summed in another order.
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-4)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain_on_card(dev, case):
    C, P, R, cells, noff, hw, res, integer_tables = CASES[case]
    parked, thetas, tables = _inputs(dev, C, P, R, cells, noff, hw,
                                     integer_tables)
    kw = dict(cells=cells, noff=noff, halfwidth=hw, res=res)
    plan = csm_coarse.launch_plan(parked, thetas, tables, noff)
    assert plan.table_in_smem == (case == "small")
    out = _coarse_check(dev, parked, thetas, tables, integer_tables, **kw)
    if integer_tables:
        assert bool(torch.any(out != 0))


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


# (C, P, R, parking): the fused stage at the main path's widths (cells 200,
# noff 15, T 214, tables in shared memory) at the edges of its plan.
COARSE_EDGES = {
    # P not a multiple of 4 (the int4 list walk's scalar tail) nor of 32.
    "p767": (3, 767, 40, "some"),
    # Every point of a pair in one cell: the longest run of equal reads.
    "one_cell": (2, 768, 33, "one_cell"),
    # Every point parked: empty lists, scores 0.
    "all_parked": (2, 768, 17, "all"),
    # R below the warps of a block, and a rotation run split unevenly.
    "few_rotations": (5, 768, 3, "some"),
}


@pytest.mark.parametrize("case", list(COARSE_EDGES))
def test_fused_coarse_edges_on_card(dev, case):
    C, P, R, parking = COARSE_EDGES[case]
    rng = np.random.default_rng(11)
    params = csm.CSMParams()
    res, hw = params.low_res, params.scan_range
    cells = params.kernel_cells(res)
    noff = 2 * params.offset_cells(res) + 1
    pts = rng.uniform(-hw, hw, (C, P, 2)).astype(np.float32)
    if parking == "one_cell":
        pts[:] = rng.uniform(0.01, 0.29, (C, 1, 2)) + 3.0
    mask = rng.random((C, P)) > (1.0 if parking == "all" else 0.1)
    parked = torch.as_tensor(np.where(mask[..., None], pts, 1e6)
                             .astype(np.float32), device=dev)
    thetas = torch.as_tensor(rng.uniform(-np.pi, np.pi, (C, R))
                             .astype(np.float32), device=dev)
    if parking == "one_cell":
        thetas.zero_()
    tables = _log_tables(rng, (C, cells + noff - 1, cells + noff - 1)).to(dev)
    assert csm_coarse.launch_plan(parked, thetas, tables, noff).table_in_smem
    out = _coarse_check(dev, parked, thetas, tables, False, cells=cells,
                        noff=noff, halfwidth=hw, res=res)
    if parking == "all":
        assert torch.all(out == 0)
    else:
        assert bool(torch.all(out != 0))


# (B, H, R, kh, table kind): the correlation at the shapes of the pair
# engine, with rasters of rotated scan points as the engine builds them.
CORRELATE_CASES = {
    # Log-occupancy tables, as CSM's are: every term of a score has the same
    # sign, so the float32 sums differ from plain only in their last bits.
    "log_table": (2, 214, 16, 200, "log"),
    # Integer tables: every partial sum is exact, any order gives the same
    # bits.
    "integer": (2, 214, 16, 200, "integer"),
    # H = 240: the 225 KB table and the warps' lists exceed the 227 KB of
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
        tables = _log_tables(rng, (B, H, H))
    else:
        tables = torch.as_tensor(rng.integers(-8, 8, (B, H, H))
                                 .astype(np.float32))
    return tables.to(dev), rasters


def _correlate_check(dev, tables, rasters, exact):
    B = tables.shape[0]
    before = csm_correlate.correlate.launches
    out = csm_correlate.correlate(tables, rasters)
    ref = csm_correlate.correlate_reference(tables, rasters)
    torch.cuda.synchronize()
    assert csm_correlate.correlate.launches == before + 1
    H, W = tables.shape[1:]
    kh, kw = rasters.shape[2:]
    assert out.shape == (B, rasters.shape[1], H - kh + 1, W - kw + 1)
    if exact:
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
    else:
        # Same float32 values summed in another order.
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-4)
    k, p = out.reshape(B, -1).argmax(1), ref.reshape(B, -1).argmax(1)
    rows = torch.arange(B, device=dev)
    flat = ref.reshape(B, -1)
    assert bool(((k == p) | (flat[rows, k] == flat[rows, p])).all())
    return out


@pytest.mark.parametrize("case", list(CORRELATE_CASES))
def test_correlate_matches_plain_on_card(dev, case):
    B, H, R, kh, kind = CORRELATE_CASES[case]
    tables, rasters = _correlate_inputs(dev, B, H, R, kh, kind)
    assert csm_correlate.launch_plan(tables, rasters).table_in_smem \
        == (H == 214)
    out = _correlate_check(dev, tables, rasters, kind == "integer")
    assert bool(torch.any(out != 0))


def test_correlate_empty_rasters_score_zero_on_card(dev):
    tables, rasters = _correlate_inputs(dev, 2, 46, 5, 32, "log")
    out = csm_correlate.correlate(tables, torch.zeros_like(rasters))
    single = csm_correlate.correlate(tables[0], rasters[0])
    torch.cuda.synchronize()
    assert torch.all(out == 0)
    torch.testing.assert_close(single, csm_correlate.correlate_reference(
        tables[:1], rasters[:1])[0], rtol=1e-5, atol=1e-4)


# (B, H, R, kh, table kind): the correlation at the edges of its plan.
CORRELATE_EDGES = {
    # gdc_2020's 8.5 m range at the pair engine's batch: 57 x 57 rasters are
    # 12,996 bytes, so only every fourth raster starts 16-byte aligned.
    "unaligned_8.5m": (16, 71, 90, 57, "log"),
    "integer_8.5m": (16, 71, 90, 57, "integer"),
    # One pair and one rotation.
    "b1_r1": (1, 214, 1, 200, "log"),
    # Rotation counts that split unevenly over a pair's blocks and its warps.
    "uneven_runs": (3, 94, 37, 80, "log"),
}


@pytest.mark.parametrize("case", list(CORRELATE_EDGES))
def test_correlate_edges_on_card(dev, case):
    B, H, R, kh, kind = CORRELATE_EDGES[case]
    tables, rasters = _correlate_inputs(dev, B, H, R, kh, kind)
    out = _correlate_check(dev, tables, rasters, kind == "integer")
    assert bool(torch.any(out != 0))


@pytest.mark.parametrize("H, kh", [(94, 80), (17, 3)])
@pytest.mark.parametrize("kind", ["log", "integer"])
def test_correlate_dense_raster_on_card(dev, kind, H, kh):
    """Every raster cell non-zero (counts 1-3), the worst case for the
    kernel's non-zero scan; kh = 3 makes rasters of 36 bytes, mostly the
    unaligned head and tail."""
    rng = np.random.default_rng(3)
    tables = (_log_tables(rng, (2, H, H)) if kind == "log" else
              torch.as_tensor(rng.integers(-8, 8, (2, H, H))
                              .astype(np.float32))).to(dev)
    rasters = torch.as_tensor(rng.integers(1, 4, (2, 6, kh, kh))
                              .astype(np.float32), device=dev)
    _correlate_check(dev, tables, rasters, kind == "integer")


@pytest.mark.parametrize("shift", [1, 2, 3])
def test_correlate_unaligned_storage_on_card(dev, shift):
    """Tables and rasters that start 4, 8 or 12 bytes past a 16-byte
    boundary (contiguous views into a larger buffer)."""
    tables, rasters = _correlate_inputs(dev, 3, 71, 11, 57, "integer")
    tbuf = torch.empty(tables.numel() + shift, device=dev)
    rbuf = torch.empty(rasters.numel() + shift, device=dev)
    t = tbuf[shift:].view(tables.shape)
    r = rbuf[shift:].view(rasters.shape)
    t.copy_(tables)
    r.copy_(rasters)
    assert t.data_ptr() % 16 == 4 * shift and t.is_contiguous()
    _correlate_check(dev, t, r, True)
