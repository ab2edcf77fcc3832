#!/usr/bin/env python3
"""How fast the correlation kernel's rasters stream from HBM on one CUDA card,
read two ways without the correlation's sums.

    python3 scripts/raster_stream_probe.py [--reps N]

Builds ``scripts/raster_stream_probe.cu`` (one nvcc, the port's flags) and
streams the pair engine's batch of rasters at the reference parameters
(``chip_smoke.py``'s phase-4 inputs: B=16 pairs, R=315 rotations of 200 x
200 cells, 806 MB) through

- 16-byte loads held one step ahead in registers, as
  ``csm_correlate.cu`` reads them, with 16 warps per block, at that
  kernel's shared memory (one block per SM) and with none;
- a ring of 2 KB shared-memory stages per warp, each filled by one 1-D
  bulk copy (TMA) on an mbarrier: 2 stages for 7 warps beside the staged
  table (the first design of ``csm_correlate.cu``), and 2 or 4 stages for
  16 warps with no table.

Each way counts every raster's non-zero cells by warp ballots, checked
against torch.  Prints one JSON line per way with CUDA-event ms, GB/s and
the share of the card's 3.35 TB/s, then the card's name and power limit.
Fails without a card, on a wrong count or on a stalled barrier.
"""

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = Path(__file__).with_suffix(".cu")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def build(tmp):
    from nautilus_tpu_torch.kernels import _build
    lib = Path(tmp) / "raster_stream_probe.so"
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                          str(SOURCE)], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{out.stdout}{out.stderr}")
    fn = ctypes.CDLL(str(lib)).raster_stream
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 \
        + [ctypes.POINTER(ctypes.c_int)] * 2 + [ctypes.c_void_p]
    return fn


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("raster_stream_probe: FAIL: no CUDA card", flush=True)
        return 1
    import nautilus_tpu_torch  # noqa: F401  (turns TF32 off)
    from nautilus_tpu_torch.kernels import plan
    smoke = _load("chip_smoke_helpers", ROOT / "chip_smoke.py")
    dev = torch.device("cuda")
    card = smoke.card_line()
    tables, rasters = smoke.correlate_inputs(dev, 30.0, 16, seed=4)
    B, R, kh, kw = rasters.shape
    H = tables.shape[1]
    nbytes = rasters.numel() * 4
    expected = (rasters != 0).sum((2, 3)).to(torch.int32)

    def round128(x):
        return -(-x // 128) * 128

    kernel_smem = round128(plan.correlate_plan(B, H, H, R, kh, kw).smem_bytes)
    table_smem = round128(plan.table_bytes(H, H) + plan.ALIGN)
    ways = [("registers", 0, 16, kernel_smem), ("registers", 0, 16, 0),
            ("ring", 2, 7, table_smem), ("ring", 2, 16, 0),
            ("ring", 4, 16, 0)]
    with tempfile.TemporaryDirectory() as tmp:
        fn = build(tmp)
        for name, stages, warps, reserve in ways:
            counts = torch.full((B, R), -1, dtype=torch.int32, device=dev)
            fault = torch.zeros(1, dtype=torch.int32, device=dev)
            per_sm, per_pair = ctypes.c_int(), ctypes.c_int()

            def run():
                rc = fn(rasters.data_ptr(), counts.data_ptr(),
                        fault.data_ptr(), B, R, kh * kw * 4, stages, warps,
                        reserve, ctypes.byref(per_sm), ctypes.byref(per_pair),
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"raster_stream failed: CUDA error {rc}")

            run()
            torch.cuda.synchronize()
            if int(fault.item()) or not torch.equal(counts, expected):
                print(f"raster_stream_probe: FAIL: {name} stages={stages} "
                      f"warps={warps}: fault={int(fault.item())}, counts "
                      f"equal={torch.equal(counts, expected)}", flush=True)
                return 1
            ms = smoke.cuda_ms(run, args.reps)
            print(json.dumps({
                "way": name, "stages": stages, "warps": warps,
                "reserved_smem": reserve, "blocks_per_sm": per_sm.value,
                "blocks_per_pair": per_pair.value, "B": B, "R": R, "kh": kh,
                "bytes": nbytes, "ms": ms, "GBps": nbytes / ms / 1e6,
                "share_of_hbm": nbytes / smoke.HBM_BYTES_PER_S * 1e3 / ms,
                "card": card}), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
