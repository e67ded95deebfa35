"""rosbag v2.0 reading (and writing, for fixtures/exports) without ROS.

The port's copy of ``loam_velodyne_tpu/io/rosbag.py``.

Replaces the reference's recording/replay transport (rosbag play/record
in tests/loam.test.in:11-12) for offline processing. The fast path is
the native C++ parser (native/loamio.cc via ctypes); a pure-Python
parser covers environments without a toolchain and serves as the
cross-check oracle in tests.

Format notes (rosbag 2.0): the file is a sequence of records
[hlen u32][header][dlen u32][data]; header is [flen u32]["name=value"]*.
op=0x07 connection, 0x02 message data, 0x05 chunk (possibly bz2/lz4
compressed, containing nested records), 0x04/0x06 index (skipped).
"""

from __future__ import annotations

import bz2
import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

_OP_MSG = 0x02
_OP_BAG_HEADER = 0x03
_OP_INDEX = 0x04
_OP_CHUNK = 0x05
_OP_CHUNK_INFO = 0x06
_OP_CONNECTION = 0x07


# ---------------------------------------------------------------------------
# Low-level record helpers
# ---------------------------------------------------------------------------

def _pack_header(fields: dict[str, bytes]) -> bytes:
    out = b""
    for k, v in fields.items():
        item = k.encode() + b"=" + v
        out += struct.pack("<I", len(item)) + item
    return out


def _parse_header(buf: bytes) -> dict[str, bytes]:
    fields = {}
    off = 0
    while off + 4 <= len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        item = buf[off:off + flen]
        off += flen
        k, _, v = item.partition(b"=")
        fields[k.decode()] = v
    return fields


def _iter_records(buf: bytes, off: int = 0) -> Iterator[Tuple[dict, bytes]]:
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
# Message deserialization (subset of sensor_msgs)
# ---------------------------------------------------------------------------

def _parse_ros_header(data: bytes, off: int) -> Tuple[float, int]:
    sec, nsec = struct.unpack_from("<II", data, off + 4)
    (slen,) = struct.unpack_from("<I", data, off + 12)
    return sec + 1e-9 * nsec, off + 16 + slen


def parse_pointcloud2(data: bytes) -> Tuple[float, np.ndarray]:
    stamp, off = _parse_ros_header(data, 0)
    height, width, nfields = struct.unpack_from("<III", data, off)
    off += 12
    offsets = {}
    for _ in range(nfields):
        (slen,) = struct.unpack_from("<I", data, off)
        off += 4
        name = data[off:off + slen].decode()
        off += slen
        foff, dtype, count = struct.unpack_from("<IBI", data, off)
        off += 9
        offsets[name] = (foff, dtype)
    off += 1  # is_bigendian
    point_step, _row_step = struct.unpack_from("<II", data, off)
    off += 8
    (dlen,) = struct.unpack_from("<I", data, off)
    off += 4
    raw = np.frombuffer(data, np.uint8, count=dlen, offset=off)
    npts = (height * width)
    npts = min(npts, len(raw) // max(point_step, 1))
    raw = raw[:npts * point_step].reshape(npts, point_step)
    cols = []
    for name in ("x", "y", "z"):
        foff, dtype = offsets[name]
        assert dtype == 7, "only FLOAT32 clouds supported"
        cols.append(raw[:, foff:foff + 4].copy().view(np.float32)[:, 0])
    return stamp, np.stack(cols, axis=1)


def parse_imu(data: bytes) -> Tuple[float, np.ndarray]:
    """Returns (stamp, [qx qy qz qw, ax ay az, gx gy gz])."""
    stamp, off = _parse_ros_header(data, 0)
    quat = np.frombuffer(data, np.float64, 4, off)
    off += 4 * 8 + 9 * 8
    gyro = np.frombuffer(data, np.float64, 3, off)
    off += 3 * 8 + 9 * 8
    acc = np.frombuffer(data, np.float64, 3, off)
    return stamp, np.concatenate([quat, acc, gyro])


# ---------------------------------------------------------------------------
# Readers
# ---------------------------------------------------------------------------

class _TopicBinder:
    """Binds each stream (cloud/imu) to exactly ONE connection.

    An exact topic match always wins; the message-type fallback is used
    only when no connection carries the requested topic, and it binds
    to a single connection (lowest conn id of that type). This keeps a
    two-lidar bag, or a bag with both /imu/data and /imu/data_raw, from
    interleaving two sources into one stream (the raw IMU topic has a
    zero orientation quaternion, which would corrupt gravity removal).

    Connections are collected in a cheap prescan pass (top-level records
    + uncompressed chunks — `rosbag record` repeats every connection
    record at top level after the chunk section, so compressed bags are
    covered without decompressing twice); a connection first seen during
    the message pass can still upgrade a fallback to an exact match."""

    def __init__(self, cloud_topic: str, imu_topic: str):
        self._want = {1: cloud_topic, 2: imu_topic}
        self._type = {1: "sensor_msgs/PointCloud2", 2: "sensor_msgs/Imu"}
        self._conn = {1: None, 2: None}
        self._exact = {1: False, 2: False}

    def connection(self, conn: int, topic: str, mtype: str) -> None:
        for kind in (1, 2):
            if topic == self._want[kind]:
                self._conn[kind] = conn
                self._exact[kind] = True
            elif (not self._exact[kind] and self._conn[kind] is None
                  and mtype == self._type[kind]):
                self._conn[kind] = conn

    def kind(self, conn: int) -> int:
        for k in (1, 2):
            if self._conn[k] == conn:
                return k
        return 0


def _handle_connection(binder: _TopicBinder, header: dict, data: bytes):
    (conn,) = struct.unpack("<I", header["conn"])
    topic = header.get("topic", b"").decode()
    ch = _parse_header(data)
    mtype = ch.get("type", b"").decode()
    binder.connection(conn, topic, mtype)


def _prescan_connections(buf: bytes, binder: _TopicBinder) -> None:
    """Register every connection record reachable without decompression:
    top-level records plus the contents of uncompressed chunks."""
    for header, data in _iter_records(buf):
        op = header.get("op", b"\x00")[0]
        if op == _OP_CONNECTION:
            _handle_connection(binder, header, data)
        elif (op == _OP_CHUNK
              and header.get("compression", b"none") == b"none"):
            for h2, d2 in _iter_records(data):
                if h2.get("op", b"\x00")[0] == _OP_CONNECTION:
                    _handle_connection(binder, h2, d2)


def _python_messages(path: str, cloud_topic: str, imu_topic: str):
    with open(path, "rb") as f:
        magic = f.read(13)
        if not magic.startswith(b"#ROSBAG V2.0"):
            raise ValueError(f"{path}: not a rosbag v2.0 file")
        buf = f.read()
    binder = _TopicBinder(cloud_topic, imu_topic)
    _prescan_connections(buf, binder)

    def handle(header, data):
        op = header.get("op", b"\x00")[0]
        if op == _OP_CONNECTION:
            _handle_connection(binder, header, data)
        elif op == _OP_MSG:
            (conn,) = struct.unpack("<I", header["conn"])
            kind = binder.kind(conn)
            if kind == 1:
                yield ("cloud", *parse_pointcloud2(data))
            elif kind == 2:
                yield ("imu", *parse_imu(data))
        elif op == _OP_CHUNK:
            comp = header.get("compression", b"none").decode()
            if comp == "none":
                inner = data
            elif comp == "bz2":
                inner = bz2.decompress(data)
            elif comp == "lz4":
                from loam_velodyne_torch.io import lz4f
                (raw_size,) = struct.unpack("<I", header.get(
                    "size", b"\x00\x00\x00\x00"))
                inner = lz4f.decompress(data, expected_size=raw_size)
            else:
                raise ValueError(f"unsupported chunk compression {comp}")
            for h2, d2 in _iter_records(inner):
                yield from handle(h2, d2)

    for header, data in _iter_records(buf):
        yield from handle(header, data)


def _native_messages(path: str, cloud_topic: str, imu_topic: str):
    import ctypes
    from loam_velodyne_torch.io.native import load
    lib = load()
    if lib is None:
        return None
    h = lib.loam_bag_open(path.encode(), cloud_topic.encode(),
                          imu_topic.encode())
    if not h:
        raise ValueError(f"{path}: not a rosbag v2.0 file")

    def gen():
        cap = 300000
        buf = np.zeros((cap, 3), np.float32)
        imu_buf = (ctypes.c_double * 10)()
        try:
            while True:
                kind = lib.loam_bag_next(h)
                if kind == 0:
                    err = lib.loam_bag_error(h)
                    if err:
                        msg = err.decode()
                        if msg:
                            raise ValueError(f"{path}: {msg}")
                    return
                stamp = lib.loam_bag_stamp(h)
                if kind == 1:
                    n = lib.loam_bag_cloud(
                        h, buf.ctypes.data_as(
                            ctypes.POINTER(ctypes.c_float)), cap)
                    yield ("cloud", stamp, buf[:n].copy())
                else:
                    lib.loam_bag_imu(h, imu_buf)
                    yield ("imu", stamp, np.array(imu_buf[:]))
        finally:
            lib.loam_bag_close(h)

    return gen()


def read_messages(path: str, cloud_topic: str = "/velodyne_points",
                  imu_topic: str = "/imu/data", native: bool = True):
    """Yields ("cloud", stamp, (N,3) f32) and ("imu", stamp, (10,) f64)
    tuples in file order."""
    import os
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if native:
        gen = _native_messages(path, cloud_topic, imu_topic)
        if gen is not None:
            yield from gen
            return
    yield from _python_messages(path, cloud_topic, imu_topic)


def read_bag_sweeps(path: str, topic: str = "/velodyne_points",
                    native: bool = True
                    ) -> Tuple[List[np.ndarray], List[float]]:
    sweeps, times = [], []
    for kind, stamp, payload in read_messages(path, cloud_topic=topic,
                                              native=native):
        if kind == "cloud":
            sweeps.append(payload)
            times.append(stamp)
    return sweeps, times


# ---------------------------------------------------------------------------
# Writer (fixtures + exports)
# ---------------------------------------------------------------------------

class BagWriter:
    """Minimal rosbag v2.0 writer: one chunk per message.

    Produces bags our readers (and rosbag-compatible tools that ignore
    missing index records) can parse. compression: "none" (default),
    "lz4" (LZ4 frames via liblz4, like `rosbag record --lz4`) or "bz2".
    """

    def __init__(self, path: str, compression: str = "none"):
        if compression not in ("none", "lz4", "bz2"):
            raise ValueError(f"unsupported compression {compression}")
        self._compression = compression
        self._f = open(path, "wb")
        self._f.write(b"#ROSBAG V2.0\n")
        # bag header record, padded to 4096 bytes like the real tool
        hdr = _pack_header({"op": b"\x03",
                            "index_pos": struct.pack("<Q", 0),
                            "conn_count": struct.pack("<I", 0),
                            "chunk_count": struct.pack("<I", 0)})
        pad = 4096 - len(hdr)
        self._write_record(hdr, b" " * pad)
        self._conns: dict[str, int] = {}

    def _write_record(self, header: bytes, data: bytes):
        self._f.write(struct.pack("<I", len(header)) + header)
        self._f.write(struct.pack("<I", len(data)) + data)

    def _connection(self, topic: str, mtype: str) -> int:
        if topic in self._conns:
            return self._conns[topic]
        conn = len(self._conns)
        self._conns[topic] = conn
        inner = _pack_header({"topic": topic.encode(),
                              "type": mtype.encode(),
                              "md5sum": b"*",
                              "message_definition": b""})
        rec_h = _pack_header({"op": b"\x07",
                              "conn": struct.pack("<I", conn),
                              "topic": topic.encode()})
        # connections must be visible inside a chunk for chunked readers
        self._write_chunk(rec_h, inner)
        return conn

    def _write_chunk(self, rec_header: bytes, rec_data: bytes):
        inner = (struct.pack("<I", len(rec_header)) + rec_header
                 + struct.pack("<I", len(rec_data)) + rec_data)
        comp = self._compression
        if comp == "lz4":
            from loam_velodyne_torch.io import lz4f
            payload = lz4f.compress(inner)
        elif comp == "bz2":
            payload = bz2.compress(inner)
        else:
            payload = inner
        ch = _pack_header({"op": b"\x05", "compression": comp.encode(),
                           "size": struct.pack("<I", len(inner))})
        self._write_record(ch, payload)

    def _stamp_fields(self, stamp: float) -> bytes:
        sec = int(stamp)
        nsec = int(round((stamp - sec) * 1e9))
        return struct.pack("<II", sec, nsec)

    def _msg(self, topic: str, mtype: str, stamp: float, body: bytes):
        conn = self._connection(topic, mtype)
        rec_h = _pack_header({"op": b"\x02",
                              "conn": struct.pack("<I", conn),
                              "time": self._stamp_fields(stamp)})
        self._write_chunk(rec_h, body)

    def write_cloud(self, topic: str, stamp: float, xyz: np.ndarray,
                    frame_id: str = "velodyne"):
        xyz = np.ascontiguousarray(xyz, np.float32)
        n = len(xyz)
        body = struct.pack("<I", 0) + self._stamp_fields(stamp)
        fid = frame_id.encode()
        body += struct.pack("<I", len(fid)) + fid
        body += struct.pack("<II", 1, n)          # height, width
        body += struct.pack("<I", 3)              # n fields
        for i, name in enumerate((b"x", b"y", b"z")):
            body += struct.pack("<I", len(name)) + name
            body += struct.pack("<IBI", 4 * i, 7, 1)
        body += struct.pack("<B", 0)              # is_bigendian
        body += struct.pack("<II", 12, 12 * n)    # point_step, row_step
        raw = xyz.tobytes()
        body += struct.pack("<I", len(raw)) + raw
        body += struct.pack("<B", 1)              # is_dense
        self._msg(topic, "sensor_msgs/PointCloud2", stamp, body)

    def write_imu(self, topic: str, stamp: float, quat_xyzw, acc_xyz,
                  gyro_xyz=(0.0, 0.0, 0.0), frame_id: str = "imu"):
        body = struct.pack("<I", 0) + self._stamp_fields(stamp)
        fid = frame_id.encode()
        body += struct.pack("<I", len(fid)) + fid
        body += np.asarray(quat_xyzw, np.float64).tobytes()
        body += np.zeros(9, np.float64).tobytes()
        body += np.asarray(gyro_xyz, np.float64).tobytes()
        body += np.zeros(9, np.float64).tobytes()
        body += np.asarray(acc_xyz, np.float64).tobytes()
        body += np.zeros(9, np.float64).tobytes()
        self._msg(topic, "sensor_msgs/Imu", stamp, body)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
