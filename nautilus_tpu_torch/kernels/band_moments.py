"""The band assembly's correspondence moments as one hand-written CUDA kernel
pair (``csrc/band_moments.cu``; its header says what bounds it and why it
exists: it replaces no TPU kernel).

``band_moments`` computes what ``solve/factors.py:_accumulate_banded``
returns for ``analytic="moments"``: (diag [n, 3, 3], band [w, n, 3, 3],
gd [n, 3], cost) of the planar (normal residual) and edge (point residual)
batches, straight from x and the batches' index and slot tensors, in two
launches where the plain version (``factors._accumulate_banded_reference``)
makes 414.  It adds in torch's order as read on torch 2.11.0+cu128, so
below 64 slots a pair its outputs are the plain version's bits; the cuda
tests' bit-for-bit cases check that order after a torch upgrade.
factors.py routes CUDA tensors here and keeps CPU tensors and the Jacobian
form on the plain version.

The kernel is built on first use (kernels/_build.py) and loaded with
``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from nautilus_tpu_torch.kernels import _build

SOURCE = _build.CSRC / "band_moments.cu"
PAIR_VALUES = 34      # per pair: three 3x3 blocks, the gradient, the cost
_SIGNATURES = {
    "nautilus_band_moments": (
        ctypes.c_int, [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_void_p] * 7
        + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
        + [ctypes.c_void_p] * 6),
}
# Sixteen values whose float32 sum torch's warps round to _DOWN_SUM when
# they shuffle down by 8, 4, 2, 1 (recent torch) and to 49805.578125 when
# by 1, 2, 4, 8.
_ORDER_ROW = (-0.641, 0.2, 0.00762, -12.0, 745.0, 0.00577, -1.89, 68300.0,
              -6650.0, 0.0667, 0.0144, -676.0, 0.00203, -0.463, 1.27,
              -11900.0)
_DOWN_SUM = 49805.5703125


def _load():
    return _build.load(SOURCE, _SIGNATURES)


def _check(x, batch, name: str, rows: int, normals: bool):
    """(Q, S) of one correspondence batch; raises on what the kernel does
    not take."""
    q = batch.src.shape[0]
    if q == 0:
        return 0, 0
    if q != rows:
        raise ValueError(f"{name} batch has {q} pairs; the band layout has "
                         f"{rows}")
    s = batch.src_pts.shape[1]
    fields = [("src", batch.src, torch.int64, (q,)),
              ("tgt", batch.tgt, torch.int64, (q,)),
              ("src_pts", batch.src_pts, x.dtype, (q, s, 2)),
              ("tgt_pts", batch.tgt_pts, x.dtype, (q, s, 2)),
              ("mask", batch.mask, torch.bool, (q, s))]
    if normals:
        fields += [("src_nrm", batch.src_nrm, x.dtype, (q, s, 2)),
                   ("tgt_nrm", batch.tgt_nrm, x.dtype, (q, s, 2))]
    for field, t, dtype, shape in fields:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}.{field} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}.{field} must be contiguous on "
                             f"{x.device}")
    return q, s


@functools.lru_cache(maxsize=None)
def _tree_down(device: torch.device) -> bool:
    """Whether torch.sum's warps on ``device`` combine by shuffling down
    width/2 first, as the kernel then must to give torch's bits; read once
    per device (one host read)."""
    row = torch.tensor(_ORDER_ROW, dtype=torch.float32, device=device)
    return float(torch.sum(row[None], dim=-1)) == _DOWN_SUM


def band_moments(x, planar, edge, layout):
    """(diag [n, 3, 3], band [w, n, 3, 3], gd [n, 3], cost []) of the planar
    and edge correspondence batches (factors.Correspondences in the
    delta-major layout, a factors.BandLayout of n nodes and half-bandwidth
    w) at x [M, 3], float32 or float64 on a CUDA card.  Counts one launch
    per assembly in ``band_moments.launches``."""
    if x.device.type != "cuda":
        raise ValueError(f"band_moments runs on a CUDA card, not {x.device}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"x must be float32 or float64, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [M, 3], got "
                         f"{tuple(x.shape)}")
    n, w = layout.n, layout.w
    rows = layout.offsets()[-1]
    qp, sp = _check(x, planar, "planar", rows, normals=True)
    qe, se = _check(x, edge, "edge", rows, normals=False)
    empty = lambda *shape: torch.empty(shape, dtype=x.dtype, device=x.device)
    diag, band, gd, cost = empty(n, 3, 3), empty(w, n, 3, 3), empty(n, 3), \
        empty()
    scratch = empty(PAIR_VALUES * (qp + qe) + qe * se)
    ptr = lambda t, q: t.data_ptr() if q else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _load().nautilus_band_moments(
            int(x.dtype == torch.float64), x.data_ptr(), x.shape[0],
            ptr(planar.src, qp), ptr(planar.tgt, qp),
            ptr(planar.src_pts, qp), ptr(planar.tgt_pts, qp),
            ptr(planar.src_nrm, qp), ptr(planar.tgt_nrm, qp),
            ptr(planar.mask, qp), qp, sp,
            ptr(edge.src, qe), ptr(edge.tgt, qe), ptr(edge.src_pts, qe),
            ptr(edge.tgt_pts, qe), ptr(edge.mask, qe), qe, se, n, w,
            int(_tree_down(x.device)), scratch.data_ptr(), diag.data_ptr(),
            band.data_ptr(), gd.data_ptr(), cost.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"band_moments kernel launch failed: CUDA error "
                           f"{rc}")
    band_moments.launches += 1
    return diag, band, gd, cost


band_moments.launches = 0
