"""The CSM kernels' launch plans (kernels/plan.py), checked on the CPU at
the three scan ranges, the main path's shapes and the table too large for
shared memory: they fit the card's shared memory, cover every (pair,
rotation) exactly once, keep bulk copies 16-byte aligned, and mirror the
constants of the CUDA sources."""

import re
from collections import Counter

import numpy as np
import pytest

from nautilus_tpu_torch.kernels import _build, csm, plan

# (scan range, pairs): the pair engine's batch and the stage engine's chunk
# (and the main path's last, partial chunk of the 539 gated pairs).
RANGES = [30.0, 12.0, 8.5]


def _shapes(scan_range):
    p = csm.CSMParams(scan_range=scan_range)
    res = p.low_res
    cells = p.kernel_cells(res)
    noff = 2 * p.offset_cells(res) + 1
    return cells, noff, cells + noff - 1, csm._coarse_rot_count(p)


CORRELATE = [(csm.PAIR_BATCH, *_shapes(r)) for r in RANGES] \
    + [(1, *_shapes(30.0)), (3, 80, 15, 94, 37), (2, 226, 15, 240, 16),
       (2, 242, 15, 256, 16)]
COARSE = [(C, *_shapes(r)) for r in RANGES for C in (csm.PAIR_CHUNK, 8, 27)] \
    + [(2, 226, 15, 240, 16)]


def _covers(p, pairs, R):
    seen = Counter()
    for block in range(p.grid):
        pair, r0, r1 = plan.rotation_range(block, p.blocks_per_pair, R)
        assert 0 <= pair < pairs and r0 < r1
        seen.update((pair, r) for r in range(r0, r1))
    assert seen == Counter((b, r) for b in range(pairs) for r in range(R))


def _lanes_ok(p, rows, cols):
    """Every offset summed by exactly one lane slot; where the table is in
    shared memory, the lanes' bases fall in distinct banks."""
    seen = Counter()
    for v in p.lanes:
        row, col, n = plan.unpack_lane(v)
        assert 0 <= n <= plan.SLOTS
        seen.update((row, col + s) for s in range(n))
    assert seen == Counter((r, c) for r in range(rows) for c in range(cols))
    if p.table_in_smem:
        assert plan.bank_multiplicity(p.lanes, p.stride) == 1


@pytest.mark.parametrize("B, cells, noff, T, R", CORRELATE)
def test_correlate_plan(B, cells, noff, T, R):
    p = plan.correlate_plan(B, T, T, R, cells, cells)
    assert p.smem_bytes <= plan.H100.smem_per_block == 232_448
    assert p.smem_bytes == plan.correlate_smem(T, p.stride, p.table_in_smem)
    assert T <= p.stride < T + plan.MAX_PAD
    # A 240 x 240 table (225 KB) and the lists exceed 227 KB: global memory.
    assert p.table_in_smem == (T < 240)
    assert p.warps == plan.MAX_WARPS
    assert p.blocks_per_sm * (p.smem_bytes + plan.SM_RESERVED_BYTES) \
        <= plan.H100.smem_per_sm
    assert p.grid == B * p.blocks_per_pair
    _covers(p, B, R)
    _lanes_ok(p, noff, noff)


@pytest.mark.parametrize("C, cells, noff, T, R", COARSE)
def test_coarse_plan(C, cells, noff, T, R):
    p = plan.coarse_plan(C, 768, R, T, noff)
    assert p.smem_bytes <= plan.H100.smem_per_block
    assert p.smem_bytes == plan.coarse_smem(T, p.stride, 768, p.warps,
                                            p.table_in_smem)
    assert p.table_in_smem == (T != 240)
    assert p.warps == plan.MAX_WARPS
    _covers(p, C, R)
    _lanes_ok(p, noff, noff)


def test_main_path_plans():
    """The main path's shapes get the planned layouts: 16 warps beside the
    183 KB table, unpadded and free of bank conflicts, one block per SM
    over eight (pair engine) or two (stage engine) blocks per pair."""
    c = plan.correlate_plan(16, 214, 214, 315, 200, 200)
    assert (c.table_in_smem, c.stride, c.warps, c.blocks_per_pair) \
        == (True, 214, 16, 8)
    assert c.blocks_per_sm == 1 and c.smem_bytes == 216_016
    f = plan.coarse_plan(64, 768, 315, 214, 15)
    assert (f.table_in_smem, f.stride, f.warps, f.blocks_per_pair) \
        == (True, 214, 16, 2)
    assert f.smem_bytes == 232_400
    # gdc_2020's 8.5 m range: a 71-word row stride puts two lane bases in
    # one bank whatever the split, so its rows are padded to 73 words.
    assert plan.correlate_plan(16, 71, 71, 90, 57, 57).stride == 73


@pytest.mark.parametrize("kh", [200, 80, 57, 3, 1])
@pytest.mark.parametrize("base", [0, 4, 8, 12, 4096 + 4])
def test_raster_pieces_aligned_and_exact(kh, base):
    """Every raster of a [4, kh, kh] batch starting at `base` is read once:
    plain-loaded head and tail under 16 bytes, bulk copies 16-byte aligned
    in address and size, at most one step each, in order."""
    K = kh * kh
    for r in range(4):
        start = base + 4 * K * r
        head, copies, tail = plan.raster_pieces(start, 4 * K)
        assert 0 <= head < 4 and 0 <= tail < 4 and copies
        covered = start + 4 * head
        for addr, size in copies:
            assert size % 16 == 0 and 0 <= size <= plan.CHUNK_BYTES
            assert size == 0 or addr % 16 == 0     # an empty chunk is no copy
            assert addr == covered
            covered += size
        assert covered + 4 * tail == start + 4 * K


def test_offset_window_limits_and_fallback():
    """At most 16 x 16 offsets; an unpadded stride that folds the bases
    onto few banks keeps the split with the fewest conflicts."""
    with pytest.raises(ValueError):
        plan.offset_window(17, 15, 214, pad=True)
    stride, lanes = plan.offset_window(15, 15, 240, pad=False)
    assert stride == 240 and plan.bank_multiplicity(lanes, 240) == 8
    stride, lanes = plan.offset_window(15, 15, 240, pad=True)
    assert stride > 240 and plan.bank_multiplicity(lanes, stride) == 1


def test_coarse_plan_refuses_points_that_do_not_fit():
    with pytest.raises(ValueError, match="cell list"):
        plan.coarse_plan(1, 70_000, 4, 214, 15)


@pytest.mark.parametrize("name, source", [
    ("CHUNK_BYTES", "csm_correlate.cu"), ("LIST_CAP", "csm_correlate.cu"),
    ("MAX_WARPS", "csm_correlate.cu"), ("MAX_WARPS", "csm_coarse.cu"),
    ("SLOTS", "csm_common.cuh"), ("ALIGN", "csm_common.cuh")])
def test_constants_mirror_the_sources(name, source):
    cname = {"CHUNK_BYTES": "kChunkBytes", "LIST_CAP": "kListCap",
             "MAX_WARPS": "kMaxWarps", "SLOTS": "kSlots",
             "ALIGN": "kAlign"}[name]
    text = (_build.CSRC / source).read_text()
    m = re.search(rf"constexpr (?:int|unsigned) {cname} = (\d+);", text)
    assert m and int(m.group(1)) == getattr(plan, name)


def test_library_key_covers_headers(tmp_path):
    """A header change rebuilds every kernel library."""
    src = tmp_path / "k.cu"
    src.write_text("int f() { return 0; }\n")
    (tmp_path / "common.cuh").write_text("// v1\n")
    first = _build.library_path(src)
    (tmp_path / "common.cuh").write_text("// v2\n")
    assert _build.library_path(src) != first
