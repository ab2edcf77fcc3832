"""Minimal clean-room ROS bag (v2.0) reader/writer + message codecs (port of
nautilus_tpu/ingest/rosbag.py; host numpy and bz2, no torch).

Replaces the reference's rosbag::Bag/View dependency (src/main.cc:46-129)
with a pure-Python sequential parser of the public bag v2.0 container
format: length-prefixed records with field headers, chunks holding
connection + message-data records, optional bz2 compression.  No index is
required: all message records are scanned (chunks decompressed), then
sorted by record (receive) time across chunks before decoding — the
rosbag::View iteration order the reference replays in (main.cc:65-71),
correct even for reindexed/appended bags whose chunks are out of order.

Only the three message types nautilus consumes are decoded
(sensor_msgs/LaserScan, nav_msgs/Odometry, nautilus/CobotOdometryMsg —
msg definitions mirrored from the reference's msg/ directory), using ROS'
little-endian wire format.
"""

from __future__ import annotations

import bz2
import dataclasses
import itertools
import struct
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

BAG_MAGIC = b"#ROSBAG V2.0\n"

OP_MSG_DATA = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX_DATA = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07


# ---------------------------------------------------------------------------
# Low-level record framing
# ---------------------------------------------------------------------------

def _parse_header(buf: bytes) -> Dict[bytes, bytes]:
    fields = {}
    off = 0
    while off < len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        field = buf[off:off + flen]
        off += flen
        eq = field.index(b"=")
        fields[field[:eq]] = field[eq + 1:]
    return fields


def _build_header(fields: Dict[bytes, bytes]) -> bytes:
    out = b""
    for k, v in fields.items():
        field = k + b"=" + v
        out += struct.pack("<I", len(field)) + field
    return out


def _iter_records(buf: bytes, off: int = 0) -> Iterator[Tuple[Dict[bytes, bytes], bytes]]:
    n = len(buf)
    while off + 4 <= n:
        (hlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        header = _parse_header(buf[off:off + hlen])
        off += hlen
        (dlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        data = buf[off:off + dlen]
        off += dlen
        yield header, data


# ---------------------------------------------------------------------------
# Message codecs (ROS little-endian wire format)
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def u8(self):
        v = self.buf[self.off]
        self.off += 1
        return v

    def u32(self):
        (v,) = struct.unpack_from("<I", self.buf, self.off)
        self.off += 4
        return v

    def f32(self):
        (v,) = struct.unpack_from("<f", self.buf, self.off)
        self.off += 4
        return v

    def f64(self):
        (v,) = struct.unpack_from("<d", self.buf, self.off)
        self.off += 8
        return v

    def string(self):
        n = self.u32()
        s = self.buf[self.off:self.off + n].decode("utf-8", "replace")
        self.off += n
        return s

    def f32_array(self):
        n = self.u32()
        a = np.frombuffer(self.buf, "<f4", count=n, offset=self.off).copy()
        self.off += 4 * n
        return a

    def f64_fixed(self, n):
        a = np.frombuffer(self.buf, "<f8", count=n, offset=self.off).copy()
        self.off += 8 * n
        return a

    def header(self):
        seq = self.u32()
        sec = self.u32()
        nsec = self.u32()
        frame = self.string()
        return HeaderMsg(seq, sec + nsec * 1e-9, frame)


@dataclasses.dataclass
class HeaderMsg:
    seq: int
    stamp: float
    frame_id: str


@dataclasses.dataclass
class LaserScanMsg:
    """sensor_msgs/LaserScan."""

    header: HeaderMsg
    angle_min: float
    angle_max: float
    angle_increment: float
    time_increment: float
    scan_time: float
    range_min: float
    range_max: float
    ranges: np.ndarray
    intensities: np.ndarray

    TYPE = "sensor_msgs/LaserScan"


@dataclasses.dataclass
class OdometryMsg:
    """nav_msgs/Odometry (pose part; twist parsed but unused downstream)."""

    header: HeaderMsg
    child_frame_id: str
    position: np.ndarray      # [3]
    orientation: np.ndarray   # [4] x y z w
    twist_linear: np.ndarray
    twist_angular: np.ndarray

    TYPE = "nav_msgs/Odometry"


@dataclasses.dataclass
class CobotOdometryMsg:
    """nautilus/CobotOdometryMsg (differential odometry,
    reference msg/CobotOdometryMsg.msg)."""

    header: HeaderMsg
    dr: float
    dx: float
    dy: float

    TYPE = "nautilus/CobotOdometryMsg"


def decode_laser_scan(buf: bytes) -> LaserScanMsg:
    r = _Reader(buf)
    return LaserScanMsg(
        header=r.header(), angle_min=r.f32(), angle_max=r.f32(),
        angle_increment=r.f32(), time_increment=r.f32(), scan_time=r.f32(),
        range_min=r.f32(), range_max=r.f32(), ranges=r.f32_array(),
        intensities=r.f32_array())


def decode_odometry(buf: bytes) -> OdometryMsg:
    r = _Reader(buf)
    h = r.header()
    child = r.string()
    pos = np.array([r.f64(), r.f64(), r.f64()])
    quat = np.array([r.f64(), r.f64(), r.f64(), r.f64()])
    r.f64_fixed(36)  # pose covariance
    lin = np.array([r.f64(), r.f64(), r.f64()])
    ang = np.array([r.f64(), r.f64(), r.f64()])
    r.f64_fixed(36)  # twist covariance
    return OdometryMsg(h, child, pos, quat, lin, ang)


def decode_cobot_odometry(buf: bytes) -> CobotOdometryMsg:
    r = _Reader(buf)
    h = r.header()
    dr, dx, dy = r.f32(), r.f32(), r.f32()
    return CobotOdometryMsg(h, dr, dx, dy)


_DECODERS = {
    "sensor_msgs/LaserScan": decode_laser_scan,
    "nav_msgs/Odometry": decode_odometry,
    "nautilus/CobotOdometryMsg": decode_cobot_odometry,
    "cobot_msgs/CobotOdometryMsg": decode_cobot_odometry,
}


# ---------------------------------------------------------------------------
# Bag reading
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BagMessage:
    topic: str
    msg_type: str
    time: float      # record (receive) time
    msg: object


def read_bag(path, topics: Optional[List[str]] = None) -> Iterator[BagMessage]:
    """Decoded messages in TIME order (record/receive time, ties by stream
    position — rosbag::View semantics); unknown types are skipped.

    Two passes: scan every record (registering all connections and
    decompressing chunks) collecting raw message payloads, sort by
    (time, arrival), then decode lazily in sorted order.

    Peak memory is bounded to the REQUESTED topics: payloads on topics
    filtered out (or with no decoder) are dropped at collect time, as
    soon as their connection is known — a bag's chunks carry connection
    records ahead of their messages, so in practice nothing undecodable
    is ever buffered.  Messages arriving before their connection record
    (malformed but tolerated) are deferred and re-filtered at yield
    time."""
    buf = Path(path).read_bytes()
    if not buf.startswith(BAG_MAGIC):
        raise ValueError(f"{path} is not a ROS bag v2.0 file")
    connections: Dict[int, Tuple[str, str]] = {}
    pending: List[Tuple[float, int, int, bytes]] = []
    arrival = itertools.count()

    def _wanted(conn: int) -> bool:
        topic, mtype = connections[conn]
        return ((topics is None or topic in topics)
                and mtype in _DECODERS)

    def collect(header: Dict[bytes, bytes], data: bytes):
        op = header[b"op"][0]
        if op == OP_CONNECTION:
            conn = struct.unpack("<I", header[b"conn"])[0]
            topic = header[b"topic"].decode()
            inner = _parse_header(data)
            mtype = inner.get(b"type", b"").decode()
            connections[conn] = (topic, mtype)
        elif op == OP_MSG_DATA:
            conn = struct.unpack("<I", header[b"conn"])[0]
            sec, nsec = struct.unpack("<II", header[b"time"])
            order = next(arrival)
            if conn in connections and not _wanted(conn):
                return
            pending.append((sec + nsec * 1e-9, order, conn, data))

    for header, data in _iter_records(buf, len(BAG_MAGIC)):
        op = header[b"op"][0]
        if op == OP_CHUNK:
            compression = header.get(b"compression", b"none")
            if compression == b"bz2":
                data = bz2.decompress(data)
            elif compression == b"lz4":
                from nautilus_tpu_torch.ingest import lz4f
                data = lz4f.decompress(data)
            elif compression != b"none":
                raise ValueError(f"Unsupported chunk compression: {compression}")
            for ih, idata in _iter_records(data):
                collect(ih, idata)
        else:
            collect(header, data)

    pending.sort(key=lambda e: (e[0], e[1]))
    for t, _, conn, data in pending:
        topic, mtype = connections.get(conn, ("?", "?"))
        if topics is not None and topic not in topics:
            continue
        decoder = _DECODERS.get(mtype)
        if decoder is None:
            continue
        yield BagMessage(topic, mtype, t, decoder(data))


# ---------------------------------------------------------------------------
# Bag writing (uncompressed, single chunk) — for tests and converters
# ---------------------------------------------------------------------------

class _Writer:
    def __init__(self):
        self.buf = bytearray()

    def u8(self, v):
        self.buf.append(v)

    def u32(self, v):
        self.buf += struct.pack("<I", v)

    def f32(self, v):
        self.buf += struct.pack("<f", v)

    def f64(self, v):
        self.buf += struct.pack("<d", v)

    def string(self, s):
        b = s.encode()
        self.u32(len(b))
        self.buf += b

    def f32_array(self, a):
        a = np.asarray(a, "<f4")
        self.u32(len(a))
        self.buf += a.tobytes()

    def f64_fixed(self, a):
        self.buf += np.asarray(a, "<f8").tobytes()

    def header(self, h: HeaderMsg):
        self.u32(h.seq)
        sec = int(h.stamp)
        self.u32(sec)
        self.u32(int(round((h.stamp - sec) * 1e9)))
        self.string(h.frame_id)


def encode_laser_scan(m: LaserScanMsg) -> bytes:
    w = _Writer()
    w.header(m.header)
    for v in (m.angle_min, m.angle_max, m.angle_increment, m.time_increment,
              m.scan_time, m.range_min, m.range_max):
        w.f32(v)
    w.f32_array(m.ranges)
    w.f32_array(m.intensities)
    return bytes(w.buf)


def encode_odometry(m: OdometryMsg) -> bytes:
    w = _Writer()
    w.header(m.header)
    w.string(m.child_frame_id)
    for v in m.position:
        w.f64(v)
    for v in m.orientation:
        w.f64(v)
    w.f64_fixed(np.zeros(36))
    for v in m.twist_linear:
        w.f64(v)
    for v in m.twist_angular:
        w.f64(v)
    w.f64_fixed(np.zeros(36))
    return bytes(w.buf)


def encode_cobot_odometry(m: CobotOdometryMsg) -> bytes:
    w = _Writer()
    w.header(m.header)
    w.f32(m.dr)
    w.f32(m.dx)
    w.f32(m.dy)
    # v0-v3, vr, vx, vy, VBatt, status (unused downstream)
    for _ in range(8):
        w.f32(0.0)
    w.u8(0)
    return bytes(w.buf)


_ENCODERS = {
    LaserScanMsg: ("sensor_msgs/LaserScan", encode_laser_scan),
    OdometryMsg: ("nav_msgs/Odometry", encode_odometry),
    CobotOdometryMsg: ("nautilus/CobotOdometryMsg", encode_cobot_odometry),
}


def _record(header: Dict[bytes, bytes], data: bytes) -> bytes:
    h = _build_header(header)
    return (struct.pack("<I", len(h)) + h + struct.pack("<I", len(data))
            + data)


def write_bag(path, messages: List[Tuple[str, float, object]],
              compression: str = "none") -> None:
    """Write (topic, time, msg) tuples as a single-chunk bag.

    compression: "none" (default), "bz2", or "lz4" (rosbag's standard
    codec set; lz4 frames via ingest/lz4f.py)."""
    chunk = bytearray()
    conn_ids: Dict[str, int] = {}
    for topic, t, msg in messages:
        mtype, encoder = _ENCODERS[type(msg)]
        if topic not in conn_ids:
            cid = len(conn_ids)
            conn_ids[topic] = cid
            conn_header = {b"op": bytes([OP_CONNECTION]),
                           b"conn": struct.pack("<I", cid),
                           b"topic": topic.encode()}
            conn_data = _build_header({b"topic": topic.encode(),
                                       b"type": mtype.encode(),
                                       b"md5sum": b"0" * 32,
                                       b"message_definition": b""})
            chunk += _record(conn_header, conn_data)
        sec = int(t)
        nsec = int(round((t - sec) * 1e9))
        msg_header = {b"op": bytes([OP_MSG_DATA]),
                      b"conn": struct.pack("<I", conn_ids[topic]),
                      b"time": struct.pack("<II", sec, nsec)}
        chunk += _record(msg_header, encoder(msg))

    out = bytearray(BAG_MAGIC)
    bag_header = {b"op": bytes([OP_BAG_HEADER]),
                  b"index_pos": struct.pack("<Q", 0),
                  b"conn_count": struct.pack("<I", len(conn_ids)),
                  b"chunk_count": struct.pack("<I", 1)}
    # rosbag pads the bag header record to 4096 bytes with spaces.
    bh = _record(bag_header, b" " * 4096)
    out += bh
    payload = bytes(chunk)
    if compression == "bz2":
        payload = bz2.compress(payload)
    elif compression == "lz4":
        from nautilus_tpu_torch.ingest import lz4f
        payload = lz4f.compress(payload)
    elif compression != "none":
        raise ValueError(f"Unsupported chunk compression: {compression}")
    chunk_header = {b"op": bytes([OP_CHUNK]),
                    b"compression": compression.encode(),
                    b"size": struct.pack("<I", len(chunk))}
    out += _record(chunk_header, payload)
    Path(path).write_bytes(bytes(out))
