"""ctypes bindings for the port's native C++ bag reader (port of
nautilus_tpu/ingest/native.py).

``native/bagreader.cc`` is compiled with g++ at first use into the
directory the CUDA kernels are built in (``kernels/_build.py``: the
checkout's ``build/nautilus_tpu_torch/``, or a per-user cache directory for
an installed package), keyed by a hash of the source, the flags and the
libraries it links.  Nothing is written next to the source.

The Python parser (``ingest/rosbag.py``) stands in for one case only: the
system libbz2, which the reader links, is absent.  ``reader_name()`` says
which reader runs.  If g++ is missing, or the build or the load fails while
libbz2 is present, the reader raises instead of falling back.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional

import numpy as np

from nautilus_tpu_torch.ingest.rosbag import (BagMessage, CobotOdometryMsg,
                                              HeaderMsg, LaserScanMsg,
                                              OdometryMsg)
from nautilus_tpu_torch.kernels._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[1] / "native" / "bagreader.cc"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]
_LIB_DIRS = ("/usr/lib/x86_64-linux-gnu", "/lib/x86_64-linux-gnu", "/usr/lib",
             "/lib", "/usr/lib64", "/lib64")

_lib: Optional[ctypes.CDLL] = None


def _find_shared(name: str) -> Optional[str]:
    """Path of the system's lib<name>.so.1*, or None."""
    for d in _LIB_DIRS:
        for cand in sorted(Path(d).glob(f"lib{name}.so.1*")):
            if cand.is_file():
                return str(cand)
    found = ctypes.util.find_library(name)
    if found:
        for d in _LIB_DIRS:
            if (Path(d) / found).is_file():
                return str(Path(d) / found)
    return None


def build_command(output: Path) -> Optional[List[str]]:
    """The g++ command that builds the reader into ``output``; None when the
    system libbz2 is absent (then the Python reader runs)."""
    bz2 = _find_shared("bz2")
    if bz2 is None:
        return None
    lz4 = _find_shared("lz4")
    return ["g++", *CXX_FLAGS, str(SOURCE), bz2,
            *([lz4] if lz4 else ["-DNTBAG_NO_LZ4"]), "-o", str(output)]


def library_path() -> Optional[Path]:
    """Where the reader's library is built; None without libbz2."""
    cmd = build_command(Path("out.so"))
    if cmd is None:
        return None
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(cmd).encode())
    return BUILD_DIR / f"libntbag_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    if shutil.which("g++") is None:
        raise RuntimeError(f"g++ not found: the native bag reader is built "
                           f"from {SOURCE} at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        out = subprocess.run(build_command(tmp / path.name),
                             capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE.name} "
                               f"({out.returncode}):\n{out.stderr.strip()}")
        os.replace(tmp / path.name, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def get_lib() -> Optional[ctypes.CDLL]:
    """The reader's library, built and loaded once per process; None only
    when libbz2 is absent.  Raises when the build or the load fails."""
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if path is None:
        return None
    if not path.exists():
        _build(path)
    _lib = _bind(ctypes.CDLL(str(path)))
    return _lib


def reader_name() -> str:
    """Which reader ``read_bag_native`` callers get: "native" or "python"."""
    return "native" if get_lib() is not None else "python"


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C ABI of bagreader.cc."""
    p_double = ctypes.POINTER(ctypes.c_double)
    lib.nt_bag_parse.restype = ctypes.c_void_p
    lib.nt_bag_parse.argtypes = [ctypes.c_char_p] * 3
    lib.nt_bag_error.restype = ctypes.c_char_p
    lib.nt_bag_error.argtypes = [ctypes.c_void_p]
    for name in ("nt_bag_num_scans", "nt_bag_num_odoms", "nt_bag_num_cobots"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_long
        fn.argtypes = [ctypes.c_void_p]
    lib.nt_bag_scan_meta_all.argtypes = [ctypes.c_void_p, p_double]
    lib.nt_bag_scan_ranges_all.argtypes = [ctypes.c_void_p,
                                           ctypes.POINTER(ctypes.c_float)]
    lib.nt_bag_odoms.argtypes = [ctypes.c_void_p, p_double]
    lib.nt_bag_cobots.argtypes = [ctypes.c_void_p, p_double]
    lib.nt_bag_free.argtypes = [ctypes.c_void_p]
    return lib


def _rows(fn, handle, n, width):
    buf = np.empty((n, width), np.float64)
    if n:
        fn(handle, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return buf


def read_bag_native(path, lidar_topic: str,
                    odom_topic: str) -> Optional[List[BagMessage]]:
    """Parse with the native reader; None when libbz2 is absent (the caller
    then runs the Python reader).  Raises ValueError on a parse error.

    Messages come in TIME order: record (receive) time, ties broken by
    stream position, as rosbag::View (reference main.cc:65-71) and the
    Python reader give them, even for bags whose chunks are stored out of
    time order."""
    lib = get_lib()
    if lib is None:
        return None
    handle = lib.nt_bag_parse(str(path).encode(), lidar_topic.encode(),
                              odom_topic.encode())
    try:
        err = lib.nt_bag_error(handle)
        if err:
            raise ValueError(f"native bag parse failed: {err.decode()}")
        entries = []
        # meta rows: [stamp, angle_min, angle_max, angle_increment,
        # range_min, range_max, nranges, order, rtime]
        meta = _rows(lib.nt_bag_scan_meta_all, handle,
                     lib.nt_bag_num_scans(handle), 9)
        counts = meta[:, 6].astype(np.int64)
        flat = np.empty(int(counts.sum()), np.float32)
        if flat.size:
            lib.nt_bag_scan_ranges_all(handle, flat.ctypes.data_as(
                ctypes.POINTER(ctypes.c_float)))
        offsets = np.concatenate(([0], np.cumsum(counts)))
        no_intensities = np.zeros(0, np.float32)
        for i, m in enumerate(meta):
            msg = LaserScanMsg(
                header=HeaderMsg(0, m[0], "laser"),
                angle_min=m[1], angle_max=m[2], angle_increment=m[3],
                time_increment=0.0, scan_time=0.0,
                range_min=m[4], range_max=m[5],
                ranges=flat[offsets[i]:offsets[i + 1]],
                intensities=no_intensities)
            entries.append((m[8], int(m[7]), BagMessage(
                lidar_topic, LaserScanMsg.TYPE, m[0], msg)))
        # [stamp, px, py, pz, qx, qy, qz, qw, order, rtime]
        for row in _rows(lib.nt_bag_odoms, handle,
                         lib.nt_bag_num_odoms(handle), 10):
            msg = OdometryMsg(
                header=HeaderMsg(0, row[0], "odom"), child_frame_id="",
                position=row[1:4].copy(), orientation=row[4:8].copy(),
                twist_linear=np.zeros(3), twist_angular=np.zeros(3))
            entries.append((row[9], int(row[8]), BagMessage(
                odom_topic, OdometryMsg.TYPE, row[0], msg)))
        # [stamp, dr, dx, dy, order, rtime]
        for row in _rows(lib.nt_bag_cobots, handle,
                         lib.nt_bag_num_cobots(handle), 6):
            msg = CobotOdometryMsg(header=HeaderMsg(0, row[0], "odom"),
                                   dr=row[1], dx=row[2], dy=row[3])
            entries.append((row[5], int(row[4]), BagMessage(
                odom_topic, CobotOdometryMsg.TYPE, row[0], msg)))
        entries.sort(key=lambda e: (e[0], e[1]))
        return [m for _, _, m in entries]
    finally:
        lib.nt_bag_free(handle)
