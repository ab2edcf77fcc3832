"""Launch plans of the two CSM kernels: pure functions of the shapes and the
card's limits, so that the CPU tests can check them.

Both kernels run persistent blocks: one pair's table in shared memory per
block (bulk-copied, or copied row by row onto a padded row stride),
``blocks_per_pair`` blocks per pair, each over a contiguous run of
rotations, whose warps take one rotation at a time.

Each lane of a warp sums up to ``SLOTS`` neighbouring offsets of one row of
the ``rows x cols`` offset window (``window_lanes``): lanes 0-15 take
columns [0, x0) of rows 0-15, lanes 16-31 columns [x0, cols).  Its table
words for a window origin then lie at one base address plus 0..SLOTS-1,
so a lane reads them with one address and constant offsets.  The row
stride of the staged table and each row's split x0 are chosen so that the
32 lanes' bases fall in 32 distinct shared-memory banks.

Each launcher owns its kernel's shared-memory layout and sizes the launch
from it (``smem_bytes`` in ``csrc/csm_correlate.cu`` and
``csrc/csm_coarse.cu``).  This module mirrors the layout and the constants
only to decide what fits; ``tests/test_torch_kernel_plan.py`` checks that
the constants match the sources.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

LANES = 32
SLOTS = 8                  # offsets per lane: one row, neighbouring columns
MAX_ROWS = LANES // 2      # the window's rows and columns: at most 16 each
BANKS = 32
ALIGN = 16                 # bulk copies move 16-byte-aligned, 16-byte pieces
OVERREACH = SLOTS * 4      # bytes a lane's last slots may read past the table
SM_RESERVED_BYTES = 1024   # shared memory the card reserves per block
MAX_THREADS_PER_SM = 2048
REGISTERS_PER_SM = 65_536
# Both kernels are built with __launch_bounds__(MAX_WARPS * 32, 1): up to 128
# registers a thread, so one block of MAX_WARPS warps fills the register file.
MAX_REGISTERS = 128
MAX_PAD = 32               # words a staged table row may be padded by

CHUNK_BYTES = 2048         # csm_correlate.cu kChunkBytes: a warp's step
MAX_WARPS = 16             # kMaxWarps (both kernels)
LIST_CAP = 256             # csm_correlate.cu kListCap: entries of 8 bytes
MIN_SMEM_WARPS = 4         # csm_coarse.cu: fewer lists fit, table in global


class DeviceLimits(NamedTuple):
    smem_per_block: int    # cudaDevAttrMaxSharedMemoryPerBlockOptin
    smem_per_sm: int       # cudaDevAttrMaxSharedMemoryPerMultiprocessor
    sms: int               # cudaDevAttrMultiProcessorCount


H100 = DeviceLimits(smem_per_block=232_448, smem_per_sm=233_472, sms=132)


class Plan(NamedTuple):
    table_in_smem: bool
    stride: int            # row stride of the table as the kernel reads it
    warps: int
    smem_bytes: int
    blocks_per_sm: int
    blocks_per_pair: int
    grid: int
    lanes: Tuple[int, ...]   # [LANES] packed row | first col << 8 | n << 16


def _align(x: int, a: int = ALIGN) -> int:
    return -(-x // a) * a


def pack_lane(row: int, col: int, n: int) -> int:
    return row | col << 8 | n << 16


def unpack_lane(v: int) -> Tuple[int, int, int]:
    """(row, first column, columns) of a packed lane; n = 0: idle."""
    return v & 0xFF, (v >> 8) & 0xFF, v >> 16


def _split_bases(x0: int, cols: int) -> Tuple[int, ...]:
    """Column bases of one row's two lanes (a lane with no column drops)."""
    return tuple(b for b, n in ((0, x0), (x0, cols - x0)) if n > 0)


def _conflict_free_splits(rows: int, cols: int,
                          stride: int) -> Optional[Tuple[int, ...]]:
    """Per-row splits x0 whose lane bases fall in distinct banks, or None
    (depth-first over the rows)."""
    options = range(max(cols - SLOTS, 0), min(cols, SLOTS) + 1)
    splits, used = [], set()

    def go(row):
        if row == rows:
            return True
        for x0 in options:
            banks = {(row * stride + b) % BANKS for b in _split_bases(x0, cols)}
            if len(banks) < len(_split_bases(x0, cols)) or banks & used:
                continue
            used.update(banks)
            splits.append(x0)
            if go(row + 1):
                return True
            splits.pop()
            used.difference_update(banks)
        return False

    return tuple(splits) if go(0) else None


def window_lanes(rows: int, cols: int, splits) -> Tuple[int, ...]:
    """Packed lanes for per-row splits: lane r takes row r's columns
    [0, x0), lane 16 + r its columns [x0, cols)."""
    lanes = [pack_lane(0, 0, 0)] * LANES
    for row, x0 in enumerate(splits):
        lanes[row] = pack_lane(row, 0, x0)
        lanes[MAX_ROWS + row] = pack_lane(row, x0, cols - x0)
    return tuple(lanes)


def bank_multiplicity(lanes: Tuple[int, ...], stride: int) -> int:
    """Most lane bases in one bank: the shared-memory wavefronts one slot's
    read takes."""
    counts = [0] * BANKS
    for v in lanes:
        row, col, n = unpack_lane(v)
        if n:
            counts[(row * stride + col) % BANKS] += 1
    return max(counts)


def offset_window(rows: int, cols: int, width: int, pad: bool):
    """(row stride, lanes) of a rows x cols offset window over a table of
    row width ``width``: the narrowest stride from the width (up to MAX_PAD
    words more when ``pad``) with conflict-free splits; else the width and
    the uniform split with the fewest conflicts."""
    if not (1 <= rows <= MAX_ROWS and 1 <= cols <= MAX_ROWS):
        raise ValueError(f"{rows}x{cols} offsets: at most {MAX_ROWS} rows "
                         f"and {MAX_ROWS} columns fit")
    for stride in range(width, width + (MAX_PAD if pad else 1)):
        splits = _conflict_free_splits(rows, cols, stride)
        if splits is not None:
            return stride, window_lanes(rows, cols, splits)
    options = range(max(cols - SLOTS, 0), min(cols, SLOTS) + 1)
    lanes = min((window_lanes(rows, cols, (x0,) * rows) for x0 in options),
                key=lambda ls: bank_multiplicity(ls, width))
    return width, lanes


def _blocks(smem: int, warps: int, pairs: int, rotations: int,
            limits: DeviceLimits) -> Tuple[int, int, int]:
    threads = warps * LANES
    per_sm = max(1, min(limits.smem_per_sm // (smem + SM_RESERVED_BYTES),
                        MAX_THREADS_PER_SM // threads,
                        REGISTERS_PER_SM // (MAX_REGISTERS * threads)))
    per_pair = max(1, min(rotations, limits.sms * per_sm // pairs))
    return per_sm, per_pair, pairs * per_pair


def rotation_range(block: int, blocks_per_pair: int, R: int):
    """(pair, first rotation, end rotation) of a block, as the kernels
    compute it."""
    pair, j = divmod(block, blocks_per_pair)
    return pair, j * R // blocks_per_pair, (j + 1) * R // blocks_per_pair


def table_bytes(rows: int, stride: int) -> int:
    """Shared memory of a staged table of ``rows`` rows of ``stride`` words:
    16 bytes of slack let a bulk copy keep the source's alignment modulo 16,
    and OVERREACH bytes take the reads of slots past a window's last
    column."""
    return rows * stride * 4 + ALIGN + OVERREACH


def correlate_smem(H: int, stride: int, table_in_smem: bool) -> int:
    """Shared memory of csm_correlate.cu: the table barrier and the rotation
    counter, each warp's list of non-zero cells, the table."""
    return (ALIGN + MAX_WARPS * LIST_CAP * 8
            + (table_bytes(H, stride) if table_in_smem else 0))


@functools.lru_cache(maxsize=None)
def correlate_plan(B: int, H: int, W: int, R: int, kh: int, kw: int,
                   limits: DeviceLimits = H100) -> Plan:
    """Launch plan of the correlation of [B, H, W] tables with [B, R, kh, kw]
    rasters: MAX_WARPS warps, the table in shared memory where it fits."""
    oh, ow = H - kh + 1, W - kw + 1
    stride, lanes = offset_window(oh, ow, W, pad=True)
    in_smem = correlate_smem(H, stride, True) <= limits.smem_per_block
    if not in_smem:
        stride, lanes = offset_window(oh, ow, W, pad=False)
    smem = correlate_smem(H, stride, in_smem)
    per_sm, per_pair, grid = _blocks(smem, MAX_WARPS, B, R, limits)
    return Plan(in_smem, stride, MAX_WARPS, smem, per_sm, per_pair, grid,
                lanes)


def coarse_list_ints(P: int) -> int:
    """Ints of one warp's list of in-raster cells (int4-aligned)."""
    return _align(P, 4)


def coarse_smem(T: int, stride: int, P: int, warps: int,
                table_in_smem: bool) -> int:
    """Shared memory of csm_coarse.cu: per warp its list of in-raster cells;
    the table barrier and the rotation counter; the table."""
    return (warps * coarse_list_ints(P) * 4 + ALIGN
            + (table_bytes(T, stride) if table_in_smem else 0))


@functools.lru_cache(maxsize=None)
def coarse_plan(C: int, P: int, R: int, T: int, noff: int,
                limits: DeviceLimits = H100) -> Plan:
    """Launch plan of the fused coarse stage over [C, P] points, R rotations
    and [C, T, T] tables."""
    per_warp = coarse_list_ints(P) * 4
    stride, lanes = offset_window(noff, noff, T, pad=True)
    warps = (limits.smem_per_block
             - coarse_smem(T, stride, P, 0, True)) // per_warp
    in_smem = warps >= MIN_SMEM_WARPS
    if not in_smem:
        stride, lanes = offset_window(noff, noff, T, pad=False)
        warps = (limits.smem_per_block
                 - coarse_smem(T, stride, P, 0, False)) // per_warp
    if warps < 1:
        raise ValueError(f"P={P} points: one warp's cell list does not fit "
                         f"{limits.smem_per_block} bytes of shared memory")
    warps = min(MAX_WARPS, warps)
    smem = coarse_smem(T, stride, P, warps, in_smem)
    per_sm, per_pair, grid = _blocks(smem, warps, C, R, limits)
    return Plan(in_smem, stride, warps, smem, per_sm, per_pair, grid, lanes)


def raster_pieces(start: int, nbytes: int, chunk: int = CHUNK_BYTES):
    """How csm_correlate.cu reads one raster of ``nbytes`` at byte address
    ``start``: (head cells, [(address, bytes) of each step], tail cells).
    The steps cover the 16-byte-aligned interior with 16-byte loads (at
    least one step, possibly empty); the head and tail, under 16 bytes
    each, are read with 4-byte loads."""
    end = start + nbytes
    a0 = min(_align(start), end)
    a1 = max(end // ALIGN * ALIGN, a0)
    n_chunks = max(1, -(-(a1 - a0) // chunk))
    copies = [(a0 + i * chunk, max(0, min(chunk, a1 - a0 - i * chunk)))
              for i in range(n_chunks)]
    return (a0 - start) // 4, copies, (end - a1) // 4
