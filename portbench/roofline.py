"""Least times of the program's hand-written kernels on one NVIDIA H100.

The peaks are NVIDIA's data sheet for the H100 SXM part (dense rates, at
the full 700 W power limit): 3.35 TB/s of HBM and 67 TFLOP/s in float32
outside the tensor cores, which counts a fused multiply-add as two
operations, so 33.5e12 lone adds per second.  A card set below 700 W runs
slower under load: every share is reported with the card's power limit.

The work is counted from a launch's own inputs: each input byte read once
and each output byte written once, and the operations these inputs need
(not the most they could).
"""

from __future__ import annotations

import shutil
import subprocess

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
F32_ADDS_PER_S = F32_FLOPS_PER_S / 2


def bound_ms(nbytes, t_ops_ms):
    """(least ms, "bytes" or "operations"): the larger of the bytes' time at
    the HBM rate and the operations' time."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_bytes, t_ops_ms), ("bytes" if t_bytes >= t_ops_ms
                                    else "operations")


def fused_coarse_work(parked, thetas, tables, *, cells, noff, halfwidth,
                      res):
    """Bytes and float32 adds of the fused coarse stage on these tensors:
    one add per in-raster point, rotation and offset, the points binned as
    the kernel bins them (a true division by the resolution)."""
    import torch
    res_t = torch.tensor(res, dtype=torch.float32, device=parked.device)
    ct = torch.cos(thetas)[..., None]
    st = torch.sin(thetas)[..., None]
    x, y = parked[:, None, :, 0], parked[:, None, :, 1]
    ix = torch.floor((ct * x - st * y + halfwidth) / res_t)
    iy = torch.floor((st * x + ct * y + halfwidth) / res_t)
    inside = int(((ix >= 0) & (ix < cells) & (iy >= 0) & (iy < cells)).sum())
    C, R = thetas.shape
    adds = inside * noff * noff
    nbytes = 4 * (parked.numel() + thetas.numel() + tables.numel()
                  + C * R * noff * noff)
    ms, by = bound_ms(nbytes, adds / F32_ADDS_PER_S * 1e3)
    return {"bytes": nbytes, "adds": adds, "bound_ms": ms, "bound_by": by}


def correlate_work(tables, rasters):
    """Bytes and multiply-adds of the correlation of tables [B, H, W] with
    rasters [B, R, kh, kw]: one per non-zero raster cell and offset."""
    B, H, W = tables.shape
    R, kh, kw = rasters.shape[1:]
    n_off = (H - kh + 1) * (W - kw + 1)
    nnz = int((rasters != 0).sum())
    nbytes = 4 * (tables.numel() + rasters.numel() + B * R * n_off)
    ms, by = bound_ms(nbytes, 2 * nnz * n_off / F32_FLOPS_PER_S * 1e3)
    return {"bytes": nbytes, "fmas": nnz * n_off, "bound_ms": ms,
            "bound_by": by}


def power_limit_w():
    """The first card's power limit in watts as nvidia-smi reads it, or
    None where it cannot be read."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run(
            [smi, "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (subprocess.SubprocessError, ValueError, IndexError):
        return None
