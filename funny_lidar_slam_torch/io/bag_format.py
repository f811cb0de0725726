"""ROS1 bag (v2.0) reader and writer with no dependency beyond NumPy: the
port's copy of the JAX package's io/bag_format.py, byte-compatible with it
(a bag either package writes, the other reads).

The reference consumes live ROS1 topics (System::InitSubscriber,
src/slam/system.cpp:276-293); the port replays bags offline:

  * `BagReader`: a sequential scan of the record stream (bag header, chunk,
    connection and message-data records), decompressing `none`/`bz2`
    chunks (lz4 raises). Index records are skipped: the reader is purely
    stream-ordered, which is the replay order the pipeline wants.
  * `BagWriter`: a single-chunk writer (connection records, chunked
    message data, index data and chunk info records) that writes test
    bags and exports datasets.
  * ROS1 message (de)serializers for the three message types the pipeline
    consumes: sensor_msgs/Imu, sensor_msgs/PointCloud2 and
    livox_ros_driver/CustomMsg (field layout of the reference's vendored
    message definitions, include/3rd/livox_ros_driver/).

Bag format: http://wiki.ros.org/Bags/Format/2.0. Records are
`<u32 header_len><header><u32 data_len><data>`, the header repeated
`<u32 field_len>name=value` fields, the record type in the `op` field.
"""

from __future__ import annotations

import bz2
import struct
from dataclasses import dataclass
from typing import Iterator

import numpy as np

MAGIC = b"#ROSBAG V2.0\n"

_OP_MSG = 0x02
_OP_BAGHDR = 0x03
_OP_INDEX = 0x04
_OP_CHUNK = 0x05
_OP_CONN = 0x07
_OP_CHUNKINFO = 0x06

_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")


# ---------------------------------------------------------------------------
# record-level primitives
# ---------------------------------------------------------------------------


def _pack_header(fields: dict[str, bytes]) -> bytes:
    out = b""
    for name, value in fields.items():
        entry = name.encode() + b"=" + value
        out += _U32.pack(len(entry)) + entry
    return out


def _parse_header(buf: bytes) -> dict[str, bytes]:
    fields = {}
    i = 0
    while i < len(buf):
        (n,) = _U32.unpack_from(buf, i)
        i += 4
        entry = buf[i : i + n]
        i += n
        k, _, v = entry.partition(b"=")
        fields[k.decode()] = v
    return fields


def _read_record(buf: bytes, pos: int) -> tuple[dict[str, bytes], bytes, int]:
    (hlen,) = _U32.unpack_from(buf, pos)
    header = _parse_header(buf[pos + 4 : pos + 4 + hlen])
    pos += 4 + hlen
    (dlen,) = _U32.unpack_from(buf, pos)
    data = buf[pos + 4 : pos + 4 + dlen]
    return header, data, pos + 4 + dlen


def _time_bytes(t: float) -> bytes:
    secs = int(t)
    nsecs = int(round((t - secs) * 1e9))
    if nsecs >= 1_000_000_000:
        secs, nsecs = secs + 1, nsecs - 1_000_000_000
    return struct.pack("<II", secs, nsecs)


def _time_from(b: bytes) -> float:
    secs, nsecs = struct.unpack("<II", b)
    return secs + nsecs * 1e-9


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------


@dataclass
class Connection:
    cid: int
    topic: str
    msgtype: str


@dataclass
class BagMessage:
    topic: str
    msgtype: str
    t: float  # receive time (seconds)
    raw: bytes  # ROS1-serialized message body


class BagReader:
    """Stream-ordered ROS1 bag reader (records in file order; no index)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            buf = f.read()
        if not buf.startswith(MAGIC):
            raise ValueError(f"{path}: not a ROS1 v2.0 bag")
        self._buf = buf
        self.connections: dict[int, Connection] = {}

    def _handle_conn(self, header: dict[str, bytes], data: bytes) -> None:
        cid = _U32.unpack(header["conn"])[0]
        conn_hdr = _parse_header(data)
        self.connections[cid] = Connection(
            cid=cid,
            topic=conn_hdr.get("topic", header.get("topic", b"")).decode(),
            msgtype=conn_hdr.get("type", b"").decode(),
        )

    def messages(self, topics: set[str] | None = None) -> Iterator[BagMessage]:
        buf = self._buf
        pos = len(MAGIC)
        end = len(buf)
        while pos < end:
            header, data, pos = _read_record(buf, pos)
            op = header.get("op", b"\x00")[0]
            if op == _OP_CONN:
                self._handle_conn(header, data)
            elif op == _OP_MSG:
                yield from self._emit(header, data, topics)
            elif op == _OP_CHUNK:
                comp = header.get("compression", b"none").decode()
                if comp == "bz2":
                    data = bz2.decompress(data)
                elif comp != "none":
                    raise NotImplementedError(f"bag chunk compression {comp!r}")
                cpos = 0
                while cpos < len(data):
                    chdr, cdata, cpos = _read_record(data, cpos)
                    cop = chdr.get("op", b"\x00")[0]
                    if cop == _OP_CONN:
                        self._handle_conn(chdr, cdata)
                    elif cop == _OP_MSG:
                        yield from self._emit(chdr, cdata, topics)
            # bag header / index / chunk-info records: skipped

    def _emit(self, header, data, topics) -> Iterator[BagMessage]:
        conn = self.connections.get(_U32.unpack(header["conn"])[0])
        if conn is None:
            return
        if topics is not None and conn.topic not in topics:
            return
        yield BagMessage(conn.topic, conn.msgtype, _time_from(header["time"]), data)


# ---------------------------------------------------------------------------
# writer (single chunk, uncompressed, with index + chunk-info records)
# ---------------------------------------------------------------------------

_MSG_MD5 = {
    "sensor_msgs/Imu": "6a62c6daae103f4ff57a132d6f95cec2",
    "sensor_msgs/PointCloud2": "1158d486dd51d683ce2f1be655c3c181",
    "livox_ros_driver/CustomMsg": "e4d6829bdfe657cb6c21a746c86b21a6",
}


class BagWriter:
    """Minimal spec-conforming ROS1 bag writer (one uncompressed chunk)."""

    def __init__(self, path: str):
        self._path = path
        self._conns: dict[str, tuple[int, str]] = {}  # topic -> (cid, msgtype)
        self._msgs: list[tuple[int, float, bytes]] = []

    def add_connection(self, topic: str, msgtype: str) -> int:
        if topic in self._conns:
            return self._conns[topic][0]
        cid = len(self._conns)
        self._conns[topic] = (cid, msgtype)
        return cid

    def write(self, topic: str, t: float, raw: bytes) -> None:
        cid = self._conns[topic][0]
        self._msgs.append((cid, t, raw))

    def close(self) -> None:
        def record(header: dict[str, bytes], data: bytes) -> bytes:
            h = _pack_header(header)
            return _U32.pack(len(h)) + h + _U32.pack(len(data)) + data

        conn_records = b""
        for topic, (cid, msgtype) in self._conns.items():
            conn_hdr = _pack_header(
                {
                    "topic": topic.encode(),
                    "type": msgtype.encode(),
                    "md5sum": _MSG_MD5.get(msgtype, "*").encode(),
                    "message_definition": b"",
                }
            )
            conn_records += record(
                {"op": bytes([_OP_CONN]), "conn": _U32.pack(cid),
                 "topic": topic.encode()},
                conn_hdr,
            )

        self._msgs.sort(key=lambda m: m[1])
        msg_records = []  # joined once: appending to one bytes object is quadratic
        pos = len(conn_records)
        offsets: dict[int, list[tuple[float, int]]] = {c: [] for c, _ in self._conns.values()}
        for cid, t, raw in self._msgs:
            offsets[cid].append((t, pos))
            msg_records.append(record(
                {"op": bytes([_OP_MSG]), "conn": _U32.pack(cid), "time": _time_bytes(t)},
                raw,
            ))
            pos += len(msg_records[-1])

        chunk_data = b"".join([conn_records, *msg_records])
        times = [t for _, t, _ in self._msgs] or [0.0]

        out = bytearray(MAGIC)
        # bag header record, padded to 4096 bytes of data (per spec)
        baghdr_fields = {
            "op": bytes([_OP_BAGHDR]),
            "index_pos": _U64.pack(0),  # patched below
            "conn_count": _U32.pack(len(self._conns)),
            "chunk_count": _U32.pack(1),
        }
        hdr = _pack_header(baghdr_fields)
        pad = 4096 - len(hdr)
        baghdr_pos = len(out)
        out += _U32.pack(len(hdr)) + hdr + _U32.pack(pad) + b" " * pad

        chunk_pos = len(out)
        out += record(
            {"op": bytes([_OP_CHUNK]), "compression": b"none",
             "size": _U32.pack(len(chunk_data))},
            chunk_data,
        )
        # per-connection index records (ver 1: count * (time, chunk offset))
        for cid, entries in offsets.items():
            data = b"".join(_time_bytes(t) + _U32.pack(off) for t, off in entries)
            out += record(
                {"op": bytes([_OP_INDEX]), "ver": _U32.pack(1),
                 "conn": _U32.pack(cid), "count": _U32.pack(len(entries))},
                data,
            )

        index_pos = len(out)
        # connection records again (post-chunk, per spec) + chunk info
        out += conn_records
        counts = {cid: len(e) for cid, e in offsets.items()}
        info_data = b"".join(
            _U32.pack(cid) + _U32.pack(n) for cid, n in counts.items()
        )
        out += record(
            {"op": bytes([_OP_CHUNKINFO]), "ver": _U32.pack(1),
             "chunk_pos": _U64.pack(chunk_pos),
             "start_time": _time_bytes(min(times)),
             "end_time": _time_bytes(max(times)),
             "count": _U32.pack(len(counts))},
            info_data,
        )
        # patch index_pos in the bag header
        baghdr_fields["index_pos"] = _U64.pack(index_pos)
        hdr2 = _pack_header(baghdr_fields)
        assert len(hdr2) == len(hdr)
        out[baghdr_pos + 4 : baghdr_pos + 4 + len(hdr2)] = hdr2

        with open(self._path, "wb") as f:
            f.write(out)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()


# ---------------------------------------------------------------------------
# ROS1 message (de)serialization — little-endian wire format
# ---------------------------------------------------------------------------


def _ser_string(s: str) -> bytes:
    b = s.encode()
    return _U32.pack(len(b)) + b


def _ser_header(stamp: float, frame_id: str = "", seq: int = 0) -> bytes:
    return _U32.pack(seq) + _time_bytes(stamp) + _ser_string(frame_id)


def _deser_header(buf: bytes, pos: int) -> tuple[float, int]:
    stamp = _time_from(buf[pos + 4 : pos + 12])
    (slen,) = _U32.unpack_from(buf, pos + 12)
    return stamp, pos + 16 + slen


@dataclass
class ImuMsg:
    stamp: float
    quat: np.ndarray | None  # [w, x, y, z] or None when unset (6-axis)
    gyro: np.ndarray
    accel: np.ndarray


def serialize_imu(msg: ImuMsg, frame_id: str = "imu") -> bytes:
    q = msg.quat if msg.quat is not None else np.zeros(4)
    # wire order x, y, z, w (sensor_msgs/Imu)
    parts = [
        _ser_header(msg.stamp, frame_id),
        struct.pack("<4d", q[1], q[2], q[3], q[0]),
        struct.pack("<9d", *np.zeros(9)),
        struct.pack("<3d", *msg.gyro),
        struct.pack("<9d", *np.zeros(9)),
        struct.pack("<3d", *msg.accel),
        struct.pack("<9d", *np.zeros(9)),
    ]
    return b"".join(parts)


def deserialize_imu(raw: bytes) -> ImuMsg:
    stamp, pos = _deser_header(raw, 0)
    x, y, z, w = struct.unpack_from("<4d", raw, pos)
    pos += 32 + 72
    gyro = np.array(struct.unpack_from("<3d", raw, pos))
    pos += 24 + 72
    accel = np.array(struct.unpack_from("<3d", raw, pos))
    quat = None if (w, x, y, z) == (0.0, 0.0, 0.0, 0.0) else np.array([w, x, y, z])
    return ImuMsg(stamp, quat, gyro, accel)


@dataclass
class PointFieldSpec:
    name: str
    offset: int
    datatype: int
    count: int = 1


# PointField datatype codes (sensor_msgs/PointField)
PF_INT8, PF_UINT8, PF_INT16, PF_UINT16 = 1, 2, 3, 4
PF_INT32, PF_UINT32, PF_FLOAT32, PF_FLOAT64 = 5, 6, 7, 8

_NP_TO_PF = {"i1": PF_INT8, "u1": PF_UINT8, "i2": PF_INT16, "u2": PF_UINT16,
             "i4": PF_INT32, "u4": PF_UINT32, "f4": PF_FLOAT32, "f8": PF_FLOAT64}


@dataclass
class PointCloud2Msg:
    stamp: float
    fields: list[PointFieldSpec]
    point_step: int
    data: bytes
    width: int
    height: int = 1
    is_bigendian: bool = False


def pointcloud2_from_structured(arr: np.ndarray, stamp: float) -> PointCloud2Msg:
    """Build a PointCloud2 message from a structured array (one row of
    points), preserving field offsets."""
    fields = []
    for name in arr.dtype.names:
        dt, off = arr.dtype.fields[name][:2]
        code = f"{dt.kind}{dt.itemsize}"
        fields.append(PointFieldSpec(name, off, _NP_TO_PF[code]))
    return PointCloud2Msg(
        stamp=stamp, fields=fields, point_step=arr.dtype.itemsize,
        data=arr.tobytes(), width=len(arr),
    )


def serialize_pointcloud2(msg: PointCloud2Msg, frame_id: str = "lidar") -> bytes:
    parts = [
        _ser_header(msg.stamp, frame_id),
        _U32.pack(msg.height),
        _U32.pack(msg.width),
        _U32.pack(len(msg.fields)),
    ]
    for f in msg.fields:
        parts.append(_ser_string(f.name))
        parts.append(struct.pack("<IBI", f.offset, f.datatype, f.count))
    row_step = msg.point_step * msg.width
    parts.append(struct.pack("<BII", int(msg.is_bigendian), msg.point_step, row_step))
    parts.append(_U32.pack(len(msg.data)) + msg.data)
    parts.append(struct.pack("<B", 1))  # is_dense
    return b"".join(parts)


def deserialize_pointcloud2(raw: bytes) -> PointCloud2Msg:
    stamp, pos = _deser_header(raw, 0)
    height, width, nfields = struct.unpack_from("<III", raw, pos)
    pos += 12
    fields = []
    for _ in range(nfields):
        (slen,) = _U32.unpack_from(raw, pos)
        name = raw[pos + 4 : pos + 4 + slen].decode()
        pos += 4 + slen
        off, dt, cnt = struct.unpack_from("<IBI", raw, pos)
        pos += 9
        fields.append(PointFieldSpec(name, off, dt, cnt))
    is_be, point_step, _row_step = struct.unpack_from("<BII", raw, pos)
    pos += 9
    (dlen,) = _U32.unpack_from(raw, pos)
    data = raw[pos + 4 : pos + 4 + dlen]
    return PointCloud2Msg(stamp, fields, point_step, data, width, height, bool(is_be))


# packed, as CustomPoint lies on the wire (19 bytes a point)
_LIVOX_POINT = np.dtype([
    ("offset_time", "<u4"), ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
    ("reflectivity", "u1"), ("tag", "u1"), ("line", "u1"),
])


@dataclass
class LivoxCustomMsg:
    stamp: float
    timebase: int  # ns
    points: np.ndarray  # structured, _LIVOX_POINT fields


def serialize_livox(msg: LivoxCustomMsg, frame_id: str = "livox") -> bytes:
    n = len(msg.points)
    parts = [
        _ser_header(msg.stamp, frame_id),
        _U64.pack(msg.timebase),
        _U32.pack(n),
        struct.pack("<B3B", 0, 0, 0, 0),  # lidar_id + rsvd
        _U32.pack(n),
    ]
    # CustomPoint serializes without padding: u32 + 3f32 + 3u8 = 19 bytes
    parts.append(np.asarray(msg.points).astype(_LIVOX_POINT).tobytes())
    return b"".join(parts)


def deserialize_livox(raw: bytes) -> LivoxCustomMsg:
    stamp, pos = _deser_header(raw, 0)
    (timebase,) = _U64.unpack_from(raw, pos)
    pos += 8
    (_point_num,) = _U32.unpack_from(raw, pos)
    pos += 4 + 4  # point_num + lidar_id/rsvd
    (n,) = _U32.unpack_from(raw, pos)
    pos += 4
    pts = np.frombuffer(raw, _LIVOX_POINT, count=n, offset=pos).copy()
    return LivoxCustomMsg(stamp, timebase, pts)
