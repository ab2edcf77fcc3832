"""PyTorch port on a CUDA card: the hand-written CSM kernels (the fused
coarse stage and the correlation of the pair engine) against their plain
PyTorch versions, at the main path's shapes and at the edges of their
launch plans (kernels/plan.py); the band scan's CUDA graphs against the
eager scan, bit for bit (solve/band.py).

The file imports no jax, so it also runs where jax is not installed (the
repository's conftest imports jax, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda -q tests/test_torch_cuda.py

Without a card every test skips.
"""

import numpy as np
import pytest
import torch

from nautilus_tpu_torch.kernels import csm, csm_coarse, csm_correlate
from nautilus_tpu_torch.solve import band
from nautilus_tpu_torch.solve.factors import BandedSystem
from nautilus_tpu_torch.solve.lm import LMParams
from nautilus_tpu_torch.utils import timer

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


# -- the solver's other routes on the card against the CPU -------------------

ROUTE_CFG = ("translation_weight=1\nrotation_weight=1\n"
             "lc_translation_weight=3\nlc_rotation_weight=3\n"
             "lidar_constraint_amount_min=1\nlidar_constraint_amount_max=3\n"
             "outlier_threshold=0.25\nmax_lidar_range=10\n"
             "accuracy_change_stop_threshold=0.0001\n")
# A closure between the forward and the return pass of the 32-pose reverse
# traversal, at the relative pose the ground truth gives.
ROUTE_CLOSURE = (10, 27, np.array([0.0, 0.4]), float(np.pi), 3.0, 3.0)


def _route_solve(device, kind, dtype):
    """solve_slam, then a re-solve with one closure over a cap of 0, on the
    32-pose reverse traversal."""
    from nautilus_tpu_torch.core.luaconf import load_config_text
    from nautilus_tpu_torch.core.problem import SLAMState
    from nautilus_tpu_torch.ingest.synthetic import reverse_traversal_problem
    from nautilus_tpu_torch.solve.solver import Solver
    state, _ = reverse_traversal_problem(3, device=device)
    if dtype == torch.float64:
        cast = {f: getattr(state.problem, f).double()
                for f in ("points", "normals", "initial_poses", "odom_trans",
                          "odom_rot")}
        state = SLAMState.from_problem(state.problem._replace(**cast),
                                       state.timestamps)
    cfg = load_config_text(ROUTE_CFG + "lr_factor_cap=0\n")
    solver = Solver(state, cfg, linear_solver=kind)
    first = solver.solve_slam()
    state.lc_factors.append(ROUTE_CLOSURE)
    second = solver.solve_max_window()
    return first.final_cost, second.final_cost, solver.last_solver, \
        state.solution


@pytest.mark.parametrize("kind,dtype,resolved,rtol,atol", [
    # Float32 on two devices: reduction order and transcendental last bits.
    ("dense", torch.float32, "dense", 1e-4, 1e-3),
    ("auto", torch.float32, "dense", 1e-4, 1e-3),
    # CG stops on float32 dot products: the bar between dense and CG.
    ("cg", torch.float32, "cg", 5e-3, 1e-2),
    ("auto", torch.float64, "dense", 1e-8, 1e-6),
    ("cg", torch.float64, "cg", 1e-6, 1e-4),
])
def test_solver_routes_on_card_match_cpu(dev, kind, dtype, resolved, rtol,
                                         atol):
    c1, c2, ckind, csol = _route_solve("cpu", kind, dtype)
    g1, g2, gkind, gsol = _route_solve(dev, kind, dtype)
    assert ckind == gkind == resolved
    assert g1 == pytest.approx(c1, rel=rtol)
    assert g2 == pytest.approx(c2, rel=rtol)
    assert np.all(np.isfinite(gsol))
    np.testing.assert_allclose(gsol, csol, atol=atol, rtol=0)


def test_fused_kernel_from_a_float64_problem_on_card(dev):
    """The stage engine on a float64 problem's clouds launches the kernel
    (the clouds are cast, not refused) and scores as the plain version does
    on the same clouds on the CPU, and exactly as the float32 problem."""
    from nautilus_tpu_torch.ingest.synthetic import reverse_traversal_problem
    state, _ = reverse_traversal_problem(3, device=dev)
    pts64 = state.problem.points.double()
    msk = state.problem.points_mask
    params = csm.CSMParams(scan_range=10.0, high_res=0.05)
    ss, tt = [8, 12, 30], [29, 25, 7]
    centers = np.full(3, np.pi, np.float32)
    before = csm_coarse.fused_coarse.launches
    s64, t64 = csm.csm_match_pairs(pts64, msk, ss, tt, params,
                                   rotation_centers=centers)
    assert csm_coarse.fused_coarse.launches == before + 1
    s32, t32 = csm.csm_match_pairs(state.problem.points, msk, ss, tt, params,
                                   rotation_centers=centers)
    np.testing.assert_array_equal(s64, s32)
    np.testing.assert_array_equal(t64, t32)
    sc, tc = csm.csm_match_pairs(pts64.cpu(), msk.cpu(), ss, tt, params,
                                 rotation_centers=centers)
    # Plain on the CPU against the kernel: the finest grid step.
    np.testing.assert_allclose(s64, sc, atol=1e-3)
    np.testing.assert_allclose(t64[:, :2], tc[:, :2], atol=0.05 + 1e-6)
    np.testing.assert_allclose(t64[:, 2], tc[:, 2], atol=0.05 / 10 + 1e-6)
    with pytest.raises(TypeError, match="float32"):
        csm_coarse.fused_coarse(
            pts64[:2].contiguous(), torch.zeros((2, 4), device=dev),
            torch.zeros((2, 20, 20), device=dev), cells=16, noff=5,
            halfwidth=4.0, res=0.5)


def test_all_type_sweep_on_card_matches_cpu(dev):
    """Optimization type ALL at the product's beam count (720 beams, P=768,
    so a chunk of 64 pairs is the [64, 768, 768] working set): per-window
    final costs within rtol 1e-3 and poses within 1e-3 of the CPU's.  The
    nearest-target search is exact up to float32 ties; the costs carry the
    two devices' reduction orders."""
    from nautilus_tpu_torch.core.luaconf import load_config_text
    from nautilus_tpu_torch.core.problem import SLAMProblem
    from nautilus_tpu_torch.ingest.synthetic import make_problem
    from nautilus_tpu_torch.solve.solver import Solver
    import dataclasses
    card, _ = make_problem(24, "building", num_beams=720, seed=1,
                           odom_noise_trans=0.02, odom_noise_rot=0.008,
                           device=dev)
    cpu = dataclasses.replace(
        card, solution=card.solution.copy(),
        problem=SLAMProblem(*[t.cpu() for t in card.problem]))
    cfg = load_config_text(ROUTE_CFG)
    stats = {}
    for name, st in (("card", card), ("cpu", cpu)):
        stats[name] = Solver(st, cfg).solve_slam(optimization_type="all")
    for g, c in zip(stats["card"].windows, stats["cpu"].windows):
        assert g.final_cost <= g.initial_cost
        assert g.final_cost == pytest.approx(c.final_cost, rel=1e-3)
    np.testing.assert_allclose(card.solution, cpu.solution, atol=1e-3, rtol=0)


def test_hough_normals_on_card_match_cpu(dev):
    """Where the winning bin is the same the normals agree within 1e-4 (the
    bar of tests/test_torch_hough.py); a point whose two best bins tie or
    differ by one vote may change bins on the last bit of rsqrt or acos, so
    one point in 10,000 may differ."""
    from nautilus_tpu_torch.core import preprocess as pre
    from nautilus_tpu_torch.ingest.synthetic import synthesize
    raw, _ = synthesize(40, "building", num_beams=720, seed=1)
    pts, msk = torch.as_tensor(raw.points), torch.as_tensor(raw.points_mask)
    params = pre.NormalParams(method="hough")
    ref = pre.compute_normals(pts, msk, params)
    out = pre.compute_normals(pts.to(dev), msk.to(dev), params).cpu()
    assert bool((out[~msk] == 0).all())
    err = (out - ref).abs().amax(dim=-1)[msk]
    assert int((err > 1e-4).sum()) <= 1e-4 * err.numel()
    np.testing.assert_allclose(
        torch.linalg.vector_norm(out, dim=-1)[msk].numpy(), 1.0, atol=1e-5)


# The scan at the main path's size: 1000 poses, w = 10, superblock 16, so
# K = 63 superblocks of S = 48 dofs.
K_SCAN, S_SCAN = 63, 48


@pytest.fixture
def graphs(monkeypatch):
    """A fresh graph cache for the test."""
    cache = band._GraphCache()
    monkeypatch.setattr(band, "_GRAPHS", cache)
    return cache


def _tridiag(dev, dtype, seed, bad_block=None):
    """A block-tridiagonal SPD system (A, B with B_0 = 0); bad_block
    negates one diagonal block, so its Cholesky fails."""
    g = torch.Generator().manual_seed(seed)
    A = torch.randn(K_SCAN, S_SCAN, S_SCAN, generator=g, dtype=torch.float64)
    A = A @ A.mT / S_SCAN + 8 * torch.eye(S_SCAN, dtype=torch.float64)
    B = torch.randn(K_SCAN, S_SCAN, S_SCAN, generator=g,
                    dtype=torch.float64) / S_SCAN ** 0.5
    B[0] = 0
    if bad_block is not None:
        A[bad_block] = -A[bad_block]
    return A.to(dev, dtype), B.to(dev, dtype)


def _rhs(dev, dtype, m, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(K_SCAN, S_SCAN, m, generator=g,
                       dtype=torch.float64).to(dev, dtype)


def _same_bits(a, b):
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    return a.dtype == b.dtype and torch.equal(a.view(ints[a.dtype]),
                                              b.view(ints[b.dtype]))


def _graph_scan(A, B, r):
    Ls, Cs, ok = band._scan(band._tridiag_cholesky, A, B)
    return Ls, Cs, ok, band._scan(band._tridiag_solve, Ls, Cs, r)


def _eager_scan(A, B, r):
    Ls, Cs, ok = band._tridiag_cholesky(A, B)
    return Ls, Cs, ok, band._tridiag_solve(Ls, Cs, r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [1, 3, 30])
def test_band_graph_scan_is_the_eager_scan_on_card(dev, graphs, dtype, m):
    """The capture's first replay and a later one give the eager scan's
    factors and solution bit for bit."""
    A, B = _tridiag(dev, dtype, seed=m)
    r = _rhs(dev, dtype, m, seed=100 + m)
    Le, Ce, oke, xe = _eager_scan(A, B, r)
    for _ in range(2):
        Ls, Cs, ok, x = _graph_scan(A, B, r)
        assert bool(ok) and bool(oke)
        assert _same_bits(Ls, Le) and _same_bits(Cs, Ce)
        assert _same_bits(x, xe)
    assert len(graphs.graphs) == 2 and not graphs.failed


def test_band_graph_replays_new_inputs_and_keeps_old_outputs_on_card(
        dev, graphs):
    """Two systems in a row each get their own answer, and a factorization
    handed out earlier keeps its values across later replays."""
    f32 = torch.float32
    (A1, B1), (A2, B2) = _tridiag(dev, f32, 1), _tridiag(dev, f32, 2)
    r1, r2 = _rhs(dev, f32, 3, 11), _rhs(dev, f32, 3, 12)
    first = _graph_scan(A1, B1, r1)
    held = [t.clone() for t in first]
    second = _graph_scan(A2, B2, r2)
    for got, want in zip(second, _eager_scan(A2, B2, r2)):
        assert torch.equal(got, want)
    for got, want in zip(first, _eager_scan(A1, B1, r1)):
        assert torch.equal(got, want)
    for got, want in zip(first, held):
        assert torch.equal(got, want)
    # The earlier factorization solved after the later one's replay.
    x1 = band._scan(band._tridiag_solve, first[0], first[1], r2)
    assert _same_bits(x1, band._tridiag_solve(held[0], held[1], r2))


def test_band_graph_reports_a_failed_cholesky_on_card(dev, graphs):
    """A non-SPD block, replayed through a graph captured on an SPD
    system, gives ok False and the eager scan's bits."""
    f32 = torch.float32
    _graph_scan(*_tridiag(dev, f32, 3), _rhs(dev, f32, 1, 13))
    A, B = _tridiag(dev, f32, 4, bad_block=5)
    r = _rhs(dev, f32, 1, 14)
    Ls, Cs, ok, x = _graph_scan(A, B, r)
    Le, Ce, oke, xe = _eager_scan(A, B, r)
    assert not bool(ok) and not bool(oke)
    assert _same_bits(Ls, Le) and _same_bits(Cs, Ce) and _same_bits(x, xe)
    assert len(graphs.graphs) == 2


def test_band_graph_spans_on_card(dev, graphs):
    """band.graph.capture once per key, band.graph.replay on every call."""
    f32 = torch.float32
    A, B = _tridiag(dev, f32, 5)
    timer.take()
    timer.tracing(True)
    try:
        for _ in range(3):
            Ls, Cs, _ = band._scan(band._tridiag_cholesky, A, B)
            for m in (1, 3):
                band._scan(band._tridiag_solve, Ls, Cs, _rhs(dev, f32, m, m))
    finally:
        timer.tracing(False)
    names = [sp.name for sp in timer.take()]
    assert names.count("band.graph.capture") == 3
    assert names.count("band.graph.replay") == 9
    assert names[:2] == ["band.graph.capture", "band.graph.replay"]


def _band_system(dev, n=1000, w=10, R=12, L=1, seed=0):
    """A diagonally dominant band system of the main path's size with
    Woodbury columns and a HITL border."""
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=g)
    diag = rnd(n, 3, 3)
    diag = diag @ diag.mT + 8 * w * torch.eye(3)
    sys = BandedSystem(diag=diag, band=0.5 * rnd(w, n, 3, 3), g=rnd(n, 3),
                       U=0.3 * rnd(3 * n, R), C=0.2 * rnd(n, L, 3, 3),
                       E=10 * torch.eye(3).repeat(L, 1, 1), gl=rnd(L, 3))
    return BandedSystem(*[t.to(dev) for t in sys])


@pytest.mark.parametrize("call", ["solve_damped_banded",
                                  "band_inverse_node_columns"])
def test_band_routes_with_graphs_are_eager_on_card(dev, graphs, monkeypatch,
                                                   call):
    """The band routes at N = 1000 (Woodbury columns, a HITL border) give
    the eager scan's bits."""
    sys = _band_system(dev)
    fixed = torch.zeros(3 * (sys.n + 1), dtype=torch.bool, device=dev)
    fixed[:3] = True
    if call == "solve_damped_banded":
        def run():
            return band.solve_damped_banded(
                sys, fixed, torch.tensor(1e2, device=dev), LMParams())[0]
    else:
        def run():
            return band.band_inverse_node_columns(
                sys, fixed, torch.arange(30, 39, device=dev))
    graphed = [run(), run()]
    monkeypatch.setattr(band, "_scan", lambda fn, *inputs: fn(*inputs))
    eager = run()
    assert torch.isfinite(eager).all()
    assert all(_same_bits(x, eager) for x in graphed)
    assert graphs.graphs and not graphs.failed


# -- the band assembly's correspondence moments (kernels/band_moments.py) ----

def _moments_graph(dev, dtype, n, w, s_planar, s_edge, window, seed=0,
                   lines=2):
    """(x [n + lines, 3], FactorGraph, BandLayout): planar and edge batches
    holding every pair of the delta-major layout of (n, w), scan-like:
    source points within 15 m, target points where x puts them within
    5 cm, unit normals, 15 % of the slots masked and every pair of delta
    above ``window`` masked (a window below w).  A slot count of 0 leaves
    the batch empty, as optimization type 'all' leaves the planar one."""
    from nautilus_tpu_torch.solve.correspond import make_pairs
    from nautilus_tpu_torch.solve.factors import (BandLayout, Correspondences,
                                                  FactorGraph,
                                                  make_odom_factors)
    rng = np.random.default_rng(seed)
    heading = np.cumsum(rng.normal(0.0, 0.05, n + lines))
    xy = np.cumsum(0.25 * np.stack([np.cos(heading), np.sin(heading)], -1),
                   0)
    x = np.concatenate([xy, heading[:, None]], -1)
    pairs = make_pairs(n, w)
    src, tgt = pairs.src, pairs.tgt
    t = lambda a, dt=dtype: torch.as_tensor(a, dtype=dt, device=dev)

    def batch(S):
        if S == 0:
            return Correspondences(
                t(src[:0], torch.int64), t(tgt[:0], torch.int64),
                *[t(np.zeros((0, 1, 2))) for _ in range(4)],
                t(np.zeros((0, 1), bool), torch.bool))
        q = len(src)
        p = rng.uniform(-15.0, 15.0, (q, S, 2))
        cs, ss = np.cos(x[src, 2])[:, None], np.sin(x[src, 2])[:, None]
        ct, st = np.cos(x[tgt, 2])[:, None], np.sin(x[tgt, 2])[:, None]
        dx = cs * p[..., 0] - ss * p[..., 1] + (x[src, 0] - x[tgt, 0])[:, None]
        dy = ss * p[..., 0] + cs * p[..., 1] + (x[src, 1] - x[tgt, 1])[:, None]
        q_t = np.stack([ct * dx + st * dy, -st * dx + ct * dy], -1)
        q_t += rng.normal(0.0, 0.05, q_t.shape)
        a_s, a_t = rng.uniform(-np.pi, np.pi, (2, q, S))
        mask = (rng.random((q, S)) < 0.85) & ((src - tgt) <= window)[:, None]
        return Correspondences(
            t(src, torch.int64), t(tgt, torch.int64), t(p), t(q_t),
            t(np.stack([np.cos(a_s), np.sin(a_s)], -1)),
            t(np.stack([np.cos(a_t), np.sin(a_t)], -1)), t(mask, torch.bool))

    odom = make_odom_factors(np.arange(n - 1), np.arange(1, n),
                             np.zeros((n - 1, 2)), np.zeros(n - 1), 1.0, 1.0,
                             dev, dtype)
    graph = FactorGraph(odom=odom, planar=batch(s_planar), edge=batch(s_edge))
    return t(x), graph, BandLayout(n, w)


# (n, w, planar slots, edge slots, window)
MOMENT_CASES = {
    "gdc2020": (1000, 10, 20, 10, 10),
    "lgrc2019": (350, 10, 20, 10, 10),
    # The sweep's early windows: pairs of delta above 3 all masked.
    "window_3": (350, 10, 20, 10, 3),
    # Optimization type 'all': no planar batch, every cloud point a slot,
    # more slots than a warp has lanes and not a multiple of 32.
    "all": (120, 10, 0, 77, 10),
    # Fewer poses than lidar_constraint_amount_max: the solver's w = n - 1,
    # and a layout whose w reaches n (its last delta has no pair).
    "n5_w4": (5, 4, 20, 10, 4),
    "n5_w5": (5, 5, 20, 10, 5),
}


def _moments_both(dev, dtype, case, seed=0):
    from nautilus_tpu_torch.solve import factors
    x, graph, layout = _moments_graph(dev, dtype, *MOMENT_CASES[case],
                                      seed=seed)
    kernel = factors._accumulate_banded(x, graph, layout)
    plain = factors._accumulate_banded_reference(x, graph, layout)
    torch.cuda.synchronize()
    return kernel, plain, layout


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", list(MOMENT_CASES))
def test_band_moments_match_plain_on_card(dev, case, dtype):
    """The kernel against the plain slice adds.  Each scalar term rounds as
    the plain version's (no FMA contraction, the same cos and sin), and
    below 64 slots a pair's slot sums and the costs add in torch.sum's
    order: the outputs are the plain version's bits.  That order is
    torch's private Reduce.cuh, read on torch 2.11.0+cu128: these exact
    cases say whether it still holds after a torch upgrade.  Whole clouds
    (the 'all' case) sum their slots in another order, so each output is
    held to the plain one relative to its largest entry: a few roundings of
    the largest partial sum, 1e-5 in float32 and 1e-12 in float64.  The
    band rows no pair reaches are exactly zero in both."""
    (diag, band_, gd, cost), plain, layout = _moments_both(dev, dtype, case)
    exact = max(MOMENT_CASES[case][2:4]) < 64
    rel = 0 if exact else 1e-5 if dtype == torch.float32 else 1e-12
    for got, want in zip((diag, band_, gd, cost), plain):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.isfinite(got).all()
        scale = float(want.abs().max())
        assert scale > 0
        assert float((got - want).abs().max()) <= rel * scale
    for d in range(1, layout.w + 1):
        assert torch.all(band_[d - 1, :d] == 0)
        assert torch.all(plain[1][d - 1, :d] == 0)


def test_band_moments_repeat_bit_for_bit_on_card(dev):
    """No atomics: two launches on equal inputs give equal bits."""
    from nautilus_tpu_torch.solve import factors
    x, graph, layout = _moments_graph(dev, torch.float32,
                                      *MOMENT_CASES["lgrc2019"])
    first = factors._accumulate_banded(x, graph, layout)
    second = factors._accumulate_banded(x, graph, layout)
    torch.cuda.synchronize()
    assert all(_same_bits(a, b) for a, b in zip(first, second))


def test_band_moments_count_one_launch_per_assembly_on_card(dev):
    """The counter rises by one per moment-form assembly and the profiler
    sees at most two kernel launches in one; the Jacobian form stays on the
    plain version."""
    from torch.profiler import ProfilerActivity, profile
    from nautilus_tpu_torch.kernels.band_moments import band_moments
    from nautilus_tpu_torch.solve import factors
    x, graph, layout = _moments_graph(dev, torch.float32,
                                      *MOMENT_CASES["lgrc2019"])
    before = band_moments.launches
    factors._accumulate_banded(x, graph, layout)
    assert band_moments.launches == before + 1
    factors.assemble_banded_system(x[:layout.n], graph, layout)
    assert band_moments.launches == before + 2
    factors.assemble_banded_system(x[:layout.n], graph, layout, True)
    factors._accumulate_banded(x, graph, layout, True)
    assert band_moments.launches == before + 2
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        factors._accumulate_banded(x, graph, layout)
        torch.cuda.synchronize()
    launches = [e for e in prof.events()
                if e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                              "cuLaunchKernel")]
    assert len(launches) <= 2


def test_band_moments_refuse_a_batch_off_the_layout_on_card(dev):
    from nautilus_tpu_torch.kernels.band_moments import band_moments
    x, graph, layout = _moments_graph(dev, torch.float32, 40, 4, 20, 10, 4)
    short = graph.planar._replace(
        **{f: getattr(graph.planar, f)[:-1] for f in graph.planar._fields})
    with pytest.raises(ValueError, match="pairs"):
        band_moments(x, short, graph.edge, layout)
    with pytest.raises(ValueError, match="src_pts"):
        band_moments(x, graph.planar._replace(
            src_pts=graph.planar.src_pts.double()), graph.edge, layout)
