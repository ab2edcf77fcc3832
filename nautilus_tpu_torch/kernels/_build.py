"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

Each source under ``csrc/`` is compiled on first use into its own shared
library with a plain C interface, in ``build/nautilus_tpu_torch/`` at the
repository root, keyed by a hash of the source and the flags.  ``build_all``
starts one nvcc per source, all at once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nautilus_tpu_torch"
# No fast math and no fused multiply-add: the kernels then round each
# operation as the separate torch ops of their plain versions do.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Source file name -> {path, seconds, log} of its last build in this process.
build_info: Dict[str, dict] = {}
_libs: Dict[Path, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built from "
                       f"{CSRC} on a machine with the CUDA toolkit")


def library_path(source: Path) -> Path:
    """Where ``source``'s library is built, keyed by the source, the headers
    beside it and the flags."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}_{digest}.so"


def build_all(sources: Iterable[Path]) -> List[Path]:
    """Compile every source whose library is missing, one nvcc each, all
    started together; returns the library paths in the order given."""
    sources = list(sources)
    paths = [library_path(s) for s in sources]
    todo = [(s, p) for s, p in zip(sources, paths) if not p.exists()]
    for s, p in zip(sources, paths):
        if p.exists():
            build_info[s.name] = dict(path=str(p), seconds=0.0, log="(cached)")
    if not todo:
        return paths
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    running: List[Tuple[Path, Path, subprocess.Popen, float]] = []
    errors = []
    try:
        for src, lib in todo:
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp / lib.name), str(src)]
            running.append((src, lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True), time.perf_counter()))
        for src, lib, proc, t0 in running:
            out, err = proc.communicate()
            log = (out + err).strip()
            if proc.returncode != 0:
                errors.append(f"nvcc failed on {src.name} "
                              f"({proc.returncode}):\n{log}")
                continue
            os.replace(tmp / lib.name, lib)
            build_info[src.name] = dict(path=str(lib),
                                        seconds=time.perf_counter() - t0,
                                        log=log)
    finally:
        for _, _, proc, _ in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


# Exported by every kernel library (csrc/csm_common.cuh).
_LIMITS_FN = "nautilus_csm_device_limits"


def load(source: Path, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The library of ``source`` (built if needed), loaded once per process.

    signatures: {function name: (restype, [argtypes])}, set on first load.
    Pass every pointer and the stream as ctypes.c_void_p: ctypes would
    otherwise cut a Python int to 32 bits."""
    lib = _libs.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([source])[0]))
        signatures = {_LIMITS_FN: (ctypes.c_int,
                                   [ctypes.POINTER(ctypes.c_int)] * 3),
                      **signatures}
        for name, (restype, argtypes) in signatures.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _libs[source] = lib
    return lib


@functools.lru_cache(maxsize=None)
def int_array(values: tuple):
    """``values`` as a ctypes int array, made once per distinct tuple (the
    kernels' launch plans repeat from call to call)."""
    return (ctypes.c_int * len(values))(*values)


_limits: Dict[int, tuple] = {}


def device_limits(lib: ctypes.CDLL, index: int) -> tuple:
    """(shared memory per block (opt-in), shared memory per SM, SM count) of
    CUDA card ``index``, read once per card through a kernel library."""
    if index not in _limits:
        import torch
        vals = [ctypes.c_int() for _ in range(3)]
        with torch.cuda.device(index):
            rc = getattr(lib, _LIMITS_FN)(*map(ctypes.byref, vals))
        if rc != 0:
            raise RuntimeError(f"could not read the limits of CUDA card "
                               f"{index}: CUDA error {rc}")
        _limits[index] = tuple(v.value for v in vals)
    return _limits[index]
