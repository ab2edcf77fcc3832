"""Fused CSM coarse stage: the CUDA kernel, its wrapper and its plain version.

Replaces the TPU kernel ``nautilus_tpu/kernels/csm_pallas.py``
(``fused_coarse_pallas`` / ``_fused_coarse_kernel``).  For each pair c and
rotation r it rotates the pair's parked source points by ``thetas[c, r]``,
rasters them into ``[cells, cells]`` counts and correlates the raster
against the pair's coarse log table over ``noff x noff`` offsets.

- ``fused_coarse`` is the entry point.  A CUDA tensor always goes to the
  hand-written kernel (``csrc/csm_coarse.cu``; its header says what bounds
  it on the H100 and how it is laid out), a CPU tensor to the plain version.
- ``fused_coarse_reference`` is the plain PyTorch version: rotate, one-hot
  raster by ``scatter_add``, then the correlation as a batched im2col
  product, chunked over pairs.

The kernel is built on first use (kernels/_build.py) and loaded with
``ctypes``.
"""

from __future__ import annotations

import ctypes

import torch

from nautilus_tpu_torch.kernels import _build, plan

SOURCE = _build.CSRC / "csm_coarse.cu"
MAX_OFFSETS = plan.MAX_ROWS   # noff: offset rows and columns
_SIGNATURES = {
    "nautilus_csm_fused_coarse": (
        ctypes.c_int, [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_float] + [ctypes.c_int] * 3
        + [ctypes.c_void_p]),
}


def _load():
    return _build.load(SOURCE, _SIGNATURES)


def launch_plan(parked_pts, thetas, tables, noff: int) -> plan.Plan:
    """The kernel's launch plan for these CUDA tensors
    (kernels/plan.py:coarse_plan)."""
    C, P, _ = parked_pts.shape
    limits = _build.device_limits(_load(), parked_pts.device.index)
    return plan.coarse_plan(C, P, thetas.shape[1], tables.shape[1], noff,
                            plan.DeviceLimits(*limits))


def _check(parked_pts, thetas, tables, cells: int, noff: int):
    for name, t in (("parked_pts", parked_pts), ("thetas", thetas),
                    ("tables", tables)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != parked_pts.device:
            raise ValueError(f"{name} is on {t.device}, parked_pts on "
                             f"{parked_pts.device}")
    if parked_pts.dim() != 3 or parked_pts.shape[2] != 2:
        raise ValueError(f"parked_pts must be [C, P, 2], got "
                         f"{tuple(parked_pts.shape)}")
    C = parked_pts.shape[0]
    if thetas.dim() != 2 or thetas.shape[0] != C:
        raise ValueError(f"thetas must be [C={C}, R], got {tuple(thetas.shape)}")
    T = cells + noff - 1
    if tables.shape != (C, T, T):
        raise ValueError(f"tables must be [C={C}, T={T}, T], got "
                         f"{tuple(tables.shape)}")
    if not 1 <= noff <= MAX_OFFSETS:
        raise ValueError(f"noff={noff}: the kernel takes 1 <= noff <= "
                         f"{MAX_OFFSETS}")


def fused_coarse_reference(parked_pts, thetas, tables, *, cells: int,
                           noff: int, halfwidth: float, res: float,
                           pair_chunk: int = 4):
    """Plain PyTorch fused coarse stage: [C, R, noff, noff] float32.

    Rotate, raster the counts with ``scatter_add`` (exact: integer-valued
    floats), then correlate as one batched product of the rasters with the
    tables' im2col patches.  Chunked over pairs to bound the patch tensor.
    """
    C, P, _ = parked_pts.shape
    R = thetas.shape[1]
    dev = parked_pts.device
    out = torch.empty((C, R, noff, noff), dtype=torch.float32, device=dev)
    # A 0-dim device tensor, not a Python float: CUDA divides by a CPU
    # scalar as a multiply by its reciprocal, which can bin a point on a
    # cell edge differently from a true division.
    res_t = torch.tensor(res, dtype=torch.float32, device=dev)
    k = cells * cells
    for c0 in range(0, C, pair_chunk):
        c1 = min(c0 + pair_chunk, C)
        th = thetas[c0:c1, :, None]                      # [c, R, 1]
        ct, st = torch.cos(th), torch.sin(th)
        x = parked_pts[c0:c1, None, :, 0]                # [c, 1, P]
        y = parked_pts[c0:c1, None, :, 1]
        rx = ct * x - st * y
        ry = st * x + ct * y
        ix = torch.floor((rx + halfwidth) / res_t)
        iy = torch.floor((ry + halfwidth) / res_t)
        inside = (ix >= 0) & (ix < cells) & (iy >= 0) & (iy < cells)
        flat = torch.where(inside, iy * cells + ix, torch.zeros_like(ix))
        raster = torch.zeros((c1 - c0, R, k), dtype=torch.float32, device=dev)
        raster.scatter_add_(2, flat.long(), inside.to(torch.float32))
        patches = tables[c0:c1].unfold(1, cells, 1).unfold(2, cells, 1)
        patches = patches.reshape(c1 - c0, noff * noff, k)
        scores = torch.bmm(raster, patches.transpose(1, 2))
        out[c0:c1] = scores.reshape(c1 - c0, R, noff, noff)
    return out


def fused_coarse(parked_pts, thetas, tables, *, cells: int, noff: int,
                 halfwidth: float, res: float):
    """Fused coarse stage over pairs x rotations.

    parked_pts [C, P, 2] f32 (masked points parked far outside the raster),
    thetas [C, R] f32, tables [C, T, T] f32 with T = cells + noff - 1.
    Returns scores [C, R, noff, noff] f32 in [oy, ox] order — the contract
    of ``fused_coarse_pallas`` without its rot_block constraint.

    CUDA tensors run the kernel (and count a launch in
    ``fused_coarse.launches``); CPU tensors run ``fused_coarse_reference``.
    """
    _check(parked_pts, thetas, tables, cells, noff)
    dev = parked_pts.device
    if dev.type == "cpu":
        return fused_coarse_reference(parked_pts, thetas, tables, cells=cells,
                                      noff=noff, halfwidth=halfwidth, res=res)
    if dev.type != "cuda":
        raise ValueError(f"fused_coarse runs on cpu or cuda, not {dev}")
    C, P, _ = parked_pts.shape
    R = thetas.shape[1]
    T = tables.shape[1]
    out = torch.empty((C, R, noff, noff), dtype=torch.float32, device=dev)
    if C == 0 or R == 0 or P == 0:
        return out.zero_()
    if parked_pts.data_ptr() % 8:
        raise ValueError("parked_pts must be 8-byte aligned (read as float2)")
    p = launch_plan(parked_pts, thetas, tables, noff)
    lanes = _build.int_array(p.lanes)
    with torch.cuda.device(dev):
        cos_t = torch.cos(thetas)
        sin_t = torch.sin(thetas)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _load().nautilus_csm_fused_coarse(
            parked_pts.data_ptr(), cos_t.data_ptr(), sin_t.data_ptr(),
            tables.data_ptr(), out.data_ptr(), lanes, C, P, R, T, p.stride,
            cells, noff, float(halfwidth), float(res), int(p.table_in_smem),
            p.warps, p.blocks_per_pair, stream)
    if rc != 0:
        raise RuntimeError(f"csm_coarse kernel launch failed: CUDA error {rc}")
    fused_coarse.launches += 1
    return out


fused_coarse.launches = 0
