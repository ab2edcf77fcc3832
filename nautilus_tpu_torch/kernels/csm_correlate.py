"""Coarse CSM correlation: the CUDA kernel, its wrapper and its plain version.

Replaces the TPU kernel ``nautilus_tpu/kernels/csm_pallas.py``
(``correlate_pallas`` / ``_corr_kernel``), the coarse stage of the
pair-major CSM engine: the VALID 2-D cross-correlation

    out[b, r, oy, ox] = sum_{ky, kx} kernels[b, r, ky, kx]
                                     * tables[b, oy + ky, ox + kx]

of each pair's log table with the rasters of its rotated source scan.

- ``correlate`` is the entry point.  A CUDA tensor always goes to the
  hand-written kernel (``csrc/csm_correlate.cu``; its header says what
  bounds it on the H100 and how it is laid out), a CPU tensor to the plain
  version.
- ``correlate_reference`` is the plain PyTorch version: im2col patches of
  the table (``unfold``) and one batched float32 product, the form of the
  JAX package's ``_correlate_matmul``.

Tables must be finite: the kernel skips zero raster cells, which is exact
only because 0 * t = 0 for a finite t.  The kernel is built on first use
(kernels/_build.py) and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes

import torch

from nautilus_tpu_torch.kernels import _build, plan

SOURCE = _build.CSRC / "csm_correlate.cu"
MAX_OFFSETS = plan.MAX_ROWS   # offset rows and columns the kernel takes
_SIGNATURES = {
    "nautilus_csm_correlate": (
        ctypes.c_int, [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
        + [ctypes.c_void_p]),
}


def _load():
    return _build.load(SOURCE, _SIGNATURES)


def launch_plan(tables, kernels) -> plan.Plan:
    """The kernel's launch plan for CUDA tables [B, H, W] and kernels
    [B, R, kh, kw] (kernels/plan.py:correlate_plan)."""
    B, H, W = tables.shape
    R, kh, kw = kernels.shape[1:]
    limits = _build.device_limits(_load(), tables.device.index)
    return plan.correlate_plan(B, H, W, R, kh, kw, plan.DeviceLimits(*limits))


def _check(tables, kernels):
    for name, t in (("tables", tables), ("kernels", kernels)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if kernels.device != tables.device:
        raise ValueError(f"kernels are on {kernels.device}, tables on "
                         f"{tables.device}")
    if tables.dim() != 3 or kernels.dim() != 4 \
            or kernels.shape[0] != tables.shape[0]:
        raise ValueError(f"tables must be [B, H, W] and kernels [B, R, kh, kw],"
                         f" got {tuple(tables.shape)} and "
                         f"{tuple(kernels.shape)}")
    _, H, W = tables.shape
    kh, kw = kernels.shape[2:]
    if not (1 <= kh <= H and 1 <= kw <= W):
        raise ValueError(f"kernel {kh}x{kw} does not fit the {H}x{W} table")
    if max(H - kh + 1, W - kw + 1) > MAX_OFFSETS:
        raise ValueError(f"{H - kh + 1}x{W - kw + 1} offsets: the kernel takes "
                         f"at most {MAX_OFFSETS} rows and columns")


def correlate_reference(tables, kernels):
    """Plain PyTorch correlation, [B, R, oh, ow] float32: im2col patches of
    each table and one batched product with the flattened kernels."""
    B, H, W = tables.shape
    R, kh, kw = kernels.shape[1:]
    oh, ow = H - kh + 1, W - kw + 1
    patches = tables.unfold(1, kh, 1).unfold(2, kw, 1)     # [B, oh, ow, kh, kw]
    patches = patches.reshape(B, oh * ow, kh * kw)
    out = torch.bmm(kernels.reshape(B, R, kh * kw), patches.transpose(1, 2))
    return out.reshape(B, R, oh, ow)


def correlate(tables, kernels):
    """VALID correlation of tables [B, H, W] with kernels [B, R, kh, kw] ->
    [B, R, H-kh+1, W-kw+1] float32; an unbatched table [H, W] with kernels
    [R, kh, kw] gives [R, oh, ow] (the contract of ``correlate_pallas``).

    CUDA tensors run the kernel (and count a launch in
    ``correlate.launches``); CPU tensors run ``correlate_reference``.
    """
    single = tables.dim() == 2
    if single:
        if kernels.dim() != 3:
            raise ValueError(f"an [H, W] table takes [R, kh, kw] kernels, got "
                             f"{tuple(kernels.shape)}")
        tables, kernels = tables[None], kernels[None]
    _check(tables, kernels)
    dev = tables.device
    if dev.type == "cpu":
        out = correlate_reference(tables, kernels)
        return out[0] if single else out
    if dev.type != "cuda":
        raise ValueError(f"correlate runs on cpu or cuda, not {dev}")
    B, H, W = tables.shape
    R, kh, kw = kernels.shape[1:]
    out = torch.empty((B, R, H - kh + 1, W - kw + 1), dtype=torch.float32,
                      device=dev)
    if B == 0 or R == 0:
        return out[0] if single else out
    p = launch_plan(tables, kernels)
    lanes = _build.int_array(p.lanes)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _load().nautilus_csm_correlate(
            tables.data_ptr(), kernels.data_ptr(), out.data_ptr(), lanes, B,
            H, W, p.stride, R, kh, kw, int(p.table_in_smem), p.warps,
            p.blocks_per_pair, stream)
    if rc != 0:
        raise RuntimeError(f"csm_correlate kernel launch failed: CUDA error {rc}")
    correlate.launches += 1
    return out[0] if single else out


correlate.launches = 0
