"""LZ4 frame codec over the system liblz4, for rosbag lz4 chunks (port of
nautilus_tpu/ingest/lz4f.py).

rosbag's lz4 chunk compression is roslz4's "lz4s" streaming format, which
is the standard LZ4 Frame Format (magic 0x184D2204): frame header
(FLG/BD/HC), a sequence of 4-byte-length-prefixed blocks (high bit set =
stored uncompressed), a zero end mark, and an optional xxHash32 content
checksum.  The reference gets this via librosbag (main.cc:54-67).

No python lz4 binding ships in this environment, so block (de)compression
calls liblz4.so.1 through ctypes with self-declared prototypes; the frame
layer (header parsing, block framing, xxh32 for the header checksum) is
implemented here.  Content checksums are skipped on read and omitted on
write.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import struct

_MAGIC = 0x184D2204
_UNCOMPRESSED_BIT = 0x80000000
# BD byte block-max-size code -> bytes (LZ4 frame spec); roslz4 uses 4/64KB.
_BLOCK_MAX = {4: 1 << 16, 5: 1 << 18, 6: 1 << 20, 7: 1 << 22}

_LZ4_CANDIDATES = (
    "liblz4.so.1",
    "/lib/x86_64-linux-gnu/liblz4.so.1",
    "/usr/lib/x86_64-linux-gnu/liblz4.so.1",
)


def _load_liblz4():
    found = ctypes.util.find_library("lz4")
    names = ((found,) if found else ()) + _LZ4_CANDIDATES
    for name in names:
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        lib.LZ4_decompress_safe.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
        lib.LZ4_decompress_safe.restype = ctypes.c_int
        lib.LZ4_decompress_safe_usingDict.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int]
        lib.LZ4_decompress_safe_usingDict.restype = ctypes.c_int
        lib.LZ4_compress_default.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
        lib.LZ4_compress_default.restype = ctypes.c_int
        lib.LZ4_compressBound.argtypes = [ctypes.c_int]
        lib.LZ4_compressBound.restype = ctypes.c_int
        return lib
    return None


_LIB = _load_liblz4()


def available() -> bool:
    return _LIB is not None


def _require_lib():
    if _LIB is None:
        raise RuntimeError(
            "liblz4 shared library not found; cannot handle lz4 bag chunks")
    return _LIB


# ---------------------------------------------------------------------------
# xxHash32 (needed only for the 1-byte frame header checksum)
# ---------------------------------------------------------------------------

_P1, _P2, _P3, _P4, _P5 = (2654435761, 2246822519, 3266489917,
                           668265263, 374761393)
_M32 = 0xFFFFFFFF


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def xxh32(data: bytes, seed: int = 0) -> int:
    """Reference xxHash32; only ever run on a few bytes here."""
    n = len(data)
    i = 0
    if n >= 16:
        v1 = (seed + _P1 + _P2) & _M32
        v2 = (seed + _P2) & _M32
        v3 = seed
        v4 = (seed - _P1) & _M32
        while i <= n - 16:
            lanes = struct.unpack_from("<4I", data, i)
            v1 = (_rotl((v1 + lanes[0] * _P2) & _M32, 13) * _P1) & _M32
            v2 = (_rotl((v2 + lanes[1] * _P2) & _M32, 13) * _P1) & _M32
            v3 = (_rotl((v3 + lanes[2] * _P2) & _M32, 13) * _P1) & _M32
            v4 = (_rotl((v4 + lanes[3] * _P2) & _M32, 13) * _P1) & _M32
            i += 16
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) +
             _rotl(v4, 18)) & _M32
    else:
        h = (seed + _P5) & _M32
    h = (h + n) & _M32
    while i <= n - 4:
        h = (h + struct.unpack_from("<I", data, i)[0] * _P3) & _M32
        h = (_rotl(h, 17) * _P4) & _M32
        i += 4
    while i < n:
        h = (h + data[i] * _P5) & _M32
        h = (_rotl(h, 11) * _P1) & _M32
        i += 1
    h ^= h >> 15
    h = (h * _P2) & _M32
    h ^= h >> 13
    h = (h * _P3) & _M32
    h ^= h >> 16
    return h


# ---------------------------------------------------------------------------
# Frame decode / encode
# ---------------------------------------------------------------------------

def decompress(data: bytes) -> bytes:
    """Decode one LZ4 frame (roslz4 bag chunk) to bytes."""
    lib = _require_lib()
    if len(data) < 7 or struct.unpack_from("<I", data)[0] != _MAGIC:
        raise ValueError("not an LZ4 frame (bad magic)")
    flg = data[4]
    bd = data[5]
    if (flg >> 6) != 1:
        raise ValueError(f"unsupported LZ4 frame version {flg >> 6}")
    block_indep = bool(flg & 0x20)
    block_checksum = bool(flg & 0x10)
    content_size_flag = bool(flg & 0x08)
    block_max = _BLOCK_MAX.get((bd >> 4) & 0x7)
    if block_max is None:
        raise ValueError("invalid LZ4 frame BD byte")
    pos = 6 + (8 if content_size_flag else 0) + 1   # + HC byte
    out = bytearray()
    dict_buf = b""
    while True:
        if pos + 4 > len(data):
            raise ValueError("truncated LZ4 frame")
        size = struct.unpack_from("<I", data, pos)[0]
        pos += 4
        if size == 0:
            break
        stored = bool(size & _UNCOMPRESSED_BIT)
        size &= ~_UNCOMPRESSED_BIT
        if pos + size > len(data):
            raise ValueError("truncated LZ4 block")
        block = data[pos:pos + size]
        pos += size
        if block_checksum:
            pos += 4
        if stored:
            decoded = block
        else:
            dst = ctypes.create_string_buffer(block_max)
            if block_indep:
                n = lib.LZ4_decompress_safe(block, dst, size, block_max)
            else:
                n = lib.LZ4_decompress_safe_usingDict(
                    block, dst, size, block_max, dict_buf, len(dict_buf))
            if n < 0:
                raise ValueError(f"LZ4 block decode failed (rc={n})")
            decoded = dst.raw[:n]
        out += decoded
        if not block_indep:
            dict_buf = bytes(out[-65536:])
    return bytes(out)


def compress(data: bytes, block_max_code: int = 4) -> bytes:
    """Encode bytes as one LZ4 frame (independent 64 KB blocks, no
    checksums beyond the mandatory header checksum) — the shape roslz4
    accepts and our reader round-trips."""
    lib = _require_lib()
    block_max = _BLOCK_MAX[block_max_code]
    flg = (1 << 6) | 0x20          # version 01, independent blocks
    bd = block_max_code << 4
    header = struct.pack("<IBB", _MAGIC, flg, bd)
    hc = (xxh32(bytes([flg, bd])) >> 8) & 0xFF
    out = bytearray(header + bytes([hc]))
    for start in range(0, len(data), block_max):
        chunk = data[start:start + block_max]
        bound = lib.LZ4_compressBound(len(chunk))
        dst = ctypes.create_string_buffer(bound)
        n = lib.LZ4_compress_default(chunk, dst, len(chunk), bound)
        if 0 < n < len(chunk):
            out += struct.pack("<I", n) + dst.raw[:n]
        else:   # incompressible: store raw with the uncompressed bit
            out += struct.pack("<I", len(chunk) | _UNCOMPRESSED_BIT) + chunk
    out += struct.pack("<I", 0)
    return bytes(out)
