"""Offline ROS2 bag ingest: DB3 (sqlite3) and MCAP -> numpy arrays.

A copy of ``patchwork_tpu/io/bag.py`` (importing the reference package
imports JAX), whose MCAP writer also writes several topics
(:func:`write_mcap_topics`), the input of multi-LiDAR fusion.  Replaces
the reference RosbagLoader (src/rosbag_loader.cpp) with a middleware-free
decode path:

* format sniffing by magic bytes (MCAP "\\x89MCAP", SQLite 16-byte header)
  — same detection the reference uses (rosbag_loader.cpp:171-194);
* DB3: read the standard rosbag2 schema (topics/messages tables) with
  stdlib sqlite3 — the reference's loadDB3PointCloud is a TODO stub
  returning false (rosbag_loader.cpp:296-304);
* PointCloud2 decode: a REAL CDR deserializer (alignment-correct) instead
  of the reference's raw struct cast of the serialized buffer
  (convertPointCloud2ToPoints, rosbag_loader.cpp:226-254, a known-unsound
  shortcut); field offsets honored, arbitrary point_step, optional
  intensity;
* topic heuristics: point-cloud topics found by name substring
  ("point"/"cloud"/"lidar"), mirroring rosbag_loader.cpp:77-90.

The hot byte->array conversion is NumPy strided slicing (vectorized).
``zstandard`` and ``lz4`` are imported only for a compressed chunk.
"""

from __future__ import annotations

import os
import sqlite3
import struct
from typing import Dict, Iterator, List, Tuple

import numpy as np

__all__ = [
    "is_mcap_format",
    "is_db3_format",
    "sniff_format",
    "decode_pointcloud2_cdr",
    "encode_pointcloud2_cdr",
    "write_mcap",
    "write_mcap_topics",
    "BagReader",
]

_MCAP_MAGIC = b"\x89MCAP"
_SQLITE_MAGIC = b"SQLite format 3\x00"

# PointField datatypes (sensor_msgs/PointField)
_PF_DTYPES = {
    1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
    5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64,
}


def is_mcap_format(path: str) -> bool:
    """Magic-byte sniff (reference isMCAPFormat, rosbag_loader.cpp:171-182)."""
    with open(path, "rb") as f:
        return f.read(5) == _MCAP_MAGIC


def is_db3_format(path: str) -> bool:
    """SQLite header sniff (reference isDB3Format, rosbag_loader.cpp:184-194)."""
    with open(path, "rb") as f:
        return f.read(16) == _SQLITE_MAGIC


def sniff_format(path: str) -> str:
    if is_mcap_format(path):
        return "mcap"
    if is_db3_format(path):
        return "db3"
    raise ValueError(f"{path}: neither MCAP nor SQLite/DB3 (unknown bag format)")


# ---------------------------------------------------------------------------
# CDR deserialization of sensor_msgs/msg/PointCloud2
# ---------------------------------------------------------------------------

class _CdrReader:
    """Minimal XCDR1 reader (little-endian), alignment relative to the
    payload start (after the 4-byte encapsulation header)."""

    def __init__(self, buf: bytes):
        if len(buf) < 4:
            raise ValueError("CDR buffer too short")
        # encapsulation: {0x00, 0x01} = CDR_LE; {0x00, 0x00} = CDR_BE
        if buf[1] not in (0, 1):
            raise ValueError(f"unknown CDR encapsulation {buf[:2]!r}")
        self.little = buf[1] == 1
        self.buf = memoryview(buf)[4:]
        self.pos = 0

    def _align(self, size: int) -> None:
        rem = self.pos % size
        if rem:
            self.pos += size - rem

    def _unpack(self, fmt: str, size: int):
        self._align(size)
        end = "<" if self.little else ">"
        (v,) = struct.unpack_from(end + fmt, self.buf, self.pos)
        self.pos += size
        return v

    def u8(self) -> int:
        return self._unpack("B", 1)

    def u16(self) -> int:
        return self._unpack("H", 2)

    def i32(self) -> int:
        return self._unpack("i", 4)

    def u32(self) -> int:
        return self._unpack("I", 4)

    def string(self) -> str:
        n = self.u32()  # length including NUL
        s = bytes(self.buf[self.pos : self.pos + max(n - 1, 0)])
        self.pos += n
        return s.decode("utf-8", errors="replace")

    def bytes_seq(self) -> memoryview:
        n = self.u32()
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out


def decode_pointcloud2_cdr(
    buf: bytes, want_fields: Tuple[str, ...] = ("x", "y", "z")
) -> np.ndarray:
    """Decode a CDR-serialized PointCloud2 into an (n, len(want_fields))
    float32 array.  Missing fields raise KeyError."""
    r = _CdrReader(buf)
    # std_msgs/Header: time (i32 sec, u32 nanosec), string frame_id
    r.i32()
    r.u32()
    r.string()
    height = r.u32()
    width = r.u32()
    nfields = r.u32()
    fields: Dict[str, Tuple[int, int, int]] = {}
    for _ in range(nfields):
        name = r.string()
        offset = r.u32()
        datatype = r.u8()
        count = r.u32()
        fields[name] = (offset, datatype, count)
    r.u8()  # is_bigendian
    point_step = r.u32()
    r.u32()  # row_step
    data = np.frombuffer(r.bytes_seq(), dtype=np.uint8)
    n = height * width
    if point_step == 0 or n == 0:
        return np.zeros((0, len(want_fields)), np.float32)
    n = min(n, len(data) // point_step)
    data = data[: n * point_step].reshape(n, point_step)

    cols = []
    for name in want_fields:
        if name not in fields:
            raise KeyError(f"PointCloud2 missing field {name!r}")
        off, dtype_id, _ = fields[name]
        dt = _PF_DTYPES[dtype_id]
        width_b = np.dtype(dt).itemsize
        col = data[:, off : off + width_b].copy().view(dt)[:, 0]
        cols.append(col.astype(np.float32))
    return np.stack(cols, axis=1)


def encode_pointcloud2_cdr(
    pts: np.ndarray, frame_id: str = "lidar", with_intensity: bool = False
) -> bytes:
    """Encode an (n, 3|4) float32 array as a CDR PointCloud2 (the inverse
    of :func:`decode_pointcloud2_cdr`; used for tests and bag writing)."""
    pts = np.asarray(pts, np.float32)
    nf = 4 if with_intensity else 3
    names = ["x", "y", "z", "intensity"][:nf]
    point_step = 4 * nf
    n = len(pts)

    out = bytearray(b"\x00\x01\x00\x00")  # CDR_LE encapsulation
    pos = [0]

    def align(sz):
        rem = pos[0] % sz
        if rem:
            pad = sz - rem
            out.extend(b"\x00" * pad)
            pos[0] += pad

    def put(fmt, v, sz):
        align(sz)
        out.extend(struct.pack("<" + fmt, v))
        pos[0] += sz

    def put_str(s):
        b = s.encode() + b"\x00"
        put("I", len(b), 4)
        out.extend(b)
        pos[0] += len(b)

    put("i", 0, 4)          # header.stamp.sec
    put("I", 0, 4)          # header.stamp.nanosec
    put_str(frame_id)
    put("I", 1, 4)          # height
    put("I", n, 4)          # width
    put("I", nf, 4)         # fields length
    for i, name in enumerate(names):
        put_str(name)
        put("I", 4 * i, 4)  # offset
        put("B", 7, 1)      # FLOAT32
        put("I", 1, 4)      # count
    put("B", 0, 1)          # is_bigendian
    put("I", point_step, 4)
    put("I", point_step * n, 4)  # row_step
    blob = pts[:, :nf].astype("<f4").tobytes()
    put("I", len(blob), 4)
    out.extend(blob)
    pos[0] += len(blob)
    put("B", 1, 1)          # is_dense
    return bytes(out)


# ---------------------------------------------------------------------------
# DB3 (rosbag2 sqlite3)
# ---------------------------------------------------------------------------

class _Db3Backend:
    def __init__(self, path: str):
        self.conn = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
        cur = self.conn.execute("SELECT id, name, type FROM topics")
        self.topics = {name: (tid, typ) for tid, name, typ in cur.fetchall()}

    def topic_names(self) -> List[str]:
        return list(self.topics)

    def message_count(self, topic: str) -> int:
        tid = self.topics[topic][0]
        (n,) = self.conn.execute(
            "SELECT COUNT(*) FROM messages WHERE topic_id=?", (tid,)
        ).fetchone()
        return n

    def messages(self, topic: str) -> Iterator[Tuple[int, bytes]]:
        tid = self.topics[topic][0]
        cur = self.conn.execute(
            "SELECT timestamp, data FROM messages WHERE topic_id=? "
            "ORDER BY timestamp",
            (tid,),
        )
        yield from cur

    def close(self):
        self.conn.close()


# ---------------------------------------------------------------------------
# MCAP: STREAMING reader (+ chunked writer)
# ---------------------------------------------------------------------------
#
# Spec-correct subset of https://mcap.dev/spec: Header, Schema, Channel,
# Message, Chunk (incl. uncompressed_crc field), DataEnd, Statistics,
# Footer records.  The reader is constant-memory: records are read from
# the file handle one at a time and chunks are decompressed ONE at a time
# during iteration — a multi-GB capture never materializes in RAM (the
# reference's loadMCAPPointCloud is a TODO stub returning false,
# rosbag_loader.cpp:288-295).  When the file has a
# summary section, channels and per-channel message counts come from it
# without touching the data section at all.

_OP_HEADER, _OP_FOOTER, _OP_SCHEMA, _OP_CHANNEL = 0x01, 0x02, 0x03, 0x04
_OP_MESSAGE, _OP_CHUNK, _OP_DATA_END, _OP_STATS = 0x05, 0x06, 0x0F, 0x0B


def _decompress(algo: str, payload: bytes, raw_size: int) -> bytes:
    if algo == "":
        return payload
    if algo == "zstd":
        try:
            import zstandard

            return zstandard.ZstdDecompressor().decompress(
                payload, max_output_size=raw_size
            )
        except ImportError as e:
            raise RuntimeError("zstd-compressed MCAP needs zstandard") from e
    if algo == "lz4":
        try:
            import lz4.frame

            return lz4.frame.decompress(payload)
        except ImportError as e:
            raise RuntimeError("lz4-compressed MCAP needs lz4") from e
    raise RuntimeError(f"unsupported MCAP compression {algo!r}")


def _chunk_records(payload: bytes) -> Iterator[Tuple[int, bytes]]:
    """Decompress ONE chunk record's payload and iterate its records."""
    # message_start_time, message_end_time, uncompressed_size (u64 x3),
    # uncompressed_crc (u32), compression (string), records (u64-prefixed)
    _s, _e, raw_size = struct.unpack_from("<QQQ", payload, 0)
    pos = 24 + 4  # + uncompressed_crc
    (clen,) = struct.unpack_from("<I", payload, pos)
    algo = payload[pos + 4 : pos + 4 + clen].decode()
    pos += 4 + clen
    (rlen,) = struct.unpack_from("<Q", payload, pos)
    pos += 8
    inner = _decompress(algo, payload[pos : pos + rlen], raw_size)
    ipos, iend = 0, len(inner)
    while ipos + 9 <= iend:
        op = inner[ipos]
        (length,) = struct.unpack_from("<Q", inner, ipos + 1)
        ipos += 9
        yield op, inner[ipos : ipos + length]
        ipos += length


def _parse_channel(payload: bytes) -> Tuple[int, str]:
    (cid,) = struct.unpack_from("<H", payload, 0)
    (tlen,) = struct.unpack_from("<I", payload, 4)  # after schema_id
    return cid, payload[8 : 8 + tlen].decode()


class _McapBackend:
    """Streaming MCAP backend: one record in memory at a time."""

    _MAGIC8 = _MCAP_MAGIC + b"0\r\n"

    def __init__(self, path: str):
        self._f = open(path, "rb")
        if self._f.read(5) != _MCAP_MAGIC:
            self._f.close()
            raise ValueError(f"{path}: not an MCAP file")
        self._f.seek(0, os.SEEK_END)
        self._size = self._f.tell()
        self._channels: Dict[int, str] = {}
        self._counts: Dict[str, int] = {}
        self._counts_exact = False
        if not self._load_summary():
            self._scan_channels()

    # -- low-level streaming record iteration -----------------------------
    def _records(self, start: int, end: int) -> Iterator[Tuple[int, bytes]]:
        """Yield (op, payload) reading the file record-by-record."""
        pos = start
        while pos + 9 <= end:
            self._f.seek(pos)
            head = self._f.read(9)
            if len(head) < 9:
                return
            op = head[0]
            (length,) = struct.unpack_from("<Q", head, 1)
            payload = self._f.read(length)
            pos += 9 + length
            yield op, payload
            if op in (_OP_FOOTER, _OP_DATA_END):
                return

    def _data_records(self) -> Iterator[Tuple[int, bytes]]:
        """All records of the data section, chunks expanded lazily."""
        for op, payload in self._records(8, self._size - 8):
            if op == _OP_CHUNK:
                yield from _chunk_records(payload)
            elif op == _OP_DATA_END:
                return
            else:
                yield op, payload

    # -- summary section ---------------------------------------------------
    def _load_summary(self) -> bool:
        """Footer -> summary section -> channels + message counts.

        Returns False when the file carries no summary (then a one-pass
        streaming scan provides the channel map instead)."""
        foot_at = self._size - 8 - 29  # footer record = 1 + 8 + 20 bytes
        if foot_at < 8:
            return False
        self._f.seek(foot_at)
        rec = self._f.read(29)
        if len(rec) < 29 or rec[0] != _OP_FOOTER:
            return False
        summary_start, _soff, _crc = struct.unpack_from("<QQI", rec, 9)
        if summary_start == 0:
            return False
        for op, payload in self._records(summary_start, foot_at):
            if op == _OP_CHANNEL:
                cid, topic = _parse_channel(payload)
                self._channels[cid] = topic
                self._counts.setdefault(topic, 0)
            elif op == _OP_STATS:
                # message_count u64, schema_count u16, channel_count u32,
                # attachment_count u32, metadata_count u32, chunk_count
                # u32, message_start/end_time u64 x2, then the
                # channel_message_counts map (u32 byte-length prefix)
                pos = 8 + 2 + 4 + 4 + 4 + 4 + 8 + 8
                (mlen,) = struct.unpack_from("<I", payload, pos)
                pos += 4
                end = pos + mlen
                per_cid: Dict[int, int] = {}
                while pos + 10 <= end:
                    cid, n = struct.unpack_from("<HQ", payload, pos)
                    per_cid[cid] = n
                    pos += 10
                for cid, n in per_cid.items():
                    t = self._channels.get(cid)
                    if t is not None:
                        self._counts[t] = self._counts.get(t, 0) + n
                self._counts_exact = True
        return bool(self._channels)

    def _scan_channels(self) -> None:
        """No-summary fallback: ONE streaming pass for channels + counts."""
        for op, payload in self._data_records():
            if op == _OP_CHANNEL:
                cid, topic = _parse_channel(payload)
                self._channels[cid] = topic
                self._counts.setdefault(topic, 0)
            elif op == _OP_MESSAGE:
                (cid,) = struct.unpack_from("<H", payload, 0)
                t = self._channels.get(cid)
                if t is not None:
                    self._counts[t] = self._counts.get(t, 0) + 1
        self._counts_exact = True

    # -- backend surface ----------------------------------------------------
    def topic_names(self) -> List[str]:
        return list(self._counts)

    def message_count(self, topic: str) -> int:
        if not self._counts_exact:
            self._scan_channels()
        return self._counts.get(topic, 0)

    def messages(self, topic: str) -> Iterator[Tuple[int, bytes]]:
        """Stream (log_time, payload) in FILE order, constant memory.

        rosbag2 writes messages in log-time order; chunks decompress one
        at a time, so peak memory is one chunk regardless of bag size."""
        channels = dict(self._channels)
        for op, payload in self._data_records():
            if op == _OP_CHANNEL:
                cid, t = _parse_channel(payload)
                channels[cid] = t
            elif op == _OP_MESSAGE:
                cid, _seq, log_time, _pub = struct.unpack_from("<HIQQ", payload, 0)
                if channels.get(cid) == topic:
                    yield log_time, payload[22:]

    def close(self):
        self._f.close()


def write_mcap(
    path: str,
    clouds,
    topic: str = "/lidar/points",
    compression: str = "zstd",
    chunk_size: int = 1 << 20,
    frame_id: str = "lidar",
) -> None:
    """Write PointCloud2 scans of one topic as a chunked, indexed MCAP bag
    (byte for byte the file ``patchwork_tpu/io/bag.py``'s writer makes)."""
    write_mcap_topics(path, {topic: clouds}, compression, chunk_size,
                      frame_id)


def write_mcap_topics(
    path: str,
    clouds_by_topic: Dict[str, List[np.ndarray]],
    compression: str = "zstd",
    chunk_size: int = 1 << 20,
    frame_id: str = "lidar",
) -> None:
    """Write PointCloud2 scans of one or more topics as a chunked, indexed
    MCAP bag; frame i of every topic is logged at time 1000 + i, topics
    interleaved in the mapping's order.

    Spec-compliant subset: Header, Schema, one Channel per topic, chunked
    Messages (zstd/none), DataEnd, summary (Schema + Channels +
    Statistics), Footer.
    """
    import zlib

    def record(op: int, payload: bytes) -> bytes:
        return bytes([op]) + struct.pack("<Q", len(payload)) + payload

    def string(s: str) -> bytes:
        b = s.encode()
        return struct.pack("<I", len(b)) + b

    schema = (struct.pack("<H", 1) + string("sensor_msgs/msg/PointCloud2")
              + string("ros2msg") + struct.pack("<I", 0))
    channels = [struct.pack("<HH", cid, 1) + string(topic) + string("cdr")
                + struct.pack("<I", 0)
                for cid, topic in enumerate(clouds_by_topic, 1)]
    counts = [len(c) for c in clouds_by_topic.values()]

    msgs = []   # (log time, record)
    for i in range(max(counts, default=0)):
        for cid, clouds in enumerate(clouds_by_topic.values(), 1):
            if i < len(clouds):
                body = encode_pointcloud2_cdr(
                    np.asarray(clouds[i], np.float32), frame_id)
                msgs.append((1000 + i, record(
                    _OP_MESSAGE,
                    struct.pack("<HIQQ", cid, i, 1000 + i, 1000 + i) + body)))

    def chunk(recs: List[bytes], start_t: int, end_t: int) -> bytes:
        raw = b"".join(recs)
        if compression == "zstd":
            import zstandard

            blob = zstandard.ZstdCompressor().compress(raw)
            algo = "zstd"
        elif compression in ("", "none", None):
            blob, algo = raw, ""
        else:
            raise ValueError(f"unsupported compression {compression!r}")
        payload = (struct.pack("<QQQ", start_t, end_t, len(raw))
                   + struct.pack("<I", zlib.crc32(raw))
                   + string(algo)
                   + struct.pack("<Q", len(blob)) + blob)
        return record(_OP_CHUNK, payload)

    out = bytearray(_McapBackend._MAGIC8)
    out += record(_OP_HEADER, string("ros2") + string("patchwork_tpu"))

    # chunk up messages; schema + channels lead the first chunk
    pending: List[bytes] = [record(_OP_SCHEMA, schema)] + [
        record(_OP_CHANNEL, ch) for ch in channels]
    pend_bytes = sum(len(r) for r in pending)
    t0 = None
    for t, m in msgs:
        pending.append(m)
        pend_bytes += len(m)
        t0 = t if t0 is None else t0
        if pend_bytes >= chunk_size:
            out += chunk(pending, t0, t)
            pending, pend_bytes, t0 = [], 0, None
    t_end = msgs[-1][0] if msgs else 1000
    if pending:
        out += chunk(pending, t0 or 0, t_end)
    out += record(_OP_DATA_END, struct.pack("<I", 0))

    summary_start = len(out)
    out += record(_OP_SCHEMA, schema)
    for ch in channels:
        out += record(_OP_CHANNEL, ch)
    per_channel = b"".join(struct.pack("<HQ", cid, n)
                           for cid, n in enumerate(counts, 1))
    stats = (struct.pack("<QHIIII", len(msgs), 1, len(channels), 0, 0, 0)
             + struct.pack("<QQ", 1000, t_end)
             + struct.pack("<I", len(per_channel)) + per_channel)
    out += record(_OP_STATS, stats)
    out += record(_OP_FOOTER, struct.pack("<QQI", summary_start, 0, 0))
    out += _McapBackend._MAGIC8
    with open(path, "wb") as f:
        f.write(bytes(out))


# ---------------------------------------------------------------------------
# public reader (reference RosbagLoader surface, rosbag_loader.hpp:25-46)
# ---------------------------------------------------------------------------

class BagReader:
    """Array-native bag reader: DB3 or MCAP behind one interface."""

    def __init__(self, path: str):
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self.path = path
        self.format = sniff_format(path)
        self._b = _Db3Backend(path) if self.format == "db3" else _McapBackend(path)

    # reference getTopicNames / getPointCloudTopics (cpp:55-90)
    def topic_names(self) -> List[str]:
        return self._b.topic_names()

    def point_cloud_topics(self) -> List[str]:
        keys = ("point", "cloud", "lidar")
        return [
            t for t in self.topic_names() if any(k in t.lower() for k in keys)
        ]

    def message_count(self, topic: str) -> int:
        return self._b.message_count(topic)

    # reference loadPointCloud (cpp:112-155) — frame-indexed single load
    def load_point_cloud(
        self, topic: str, frame: int = 0,
        fields: Tuple[str, ...] = ("x", "y", "z"),
    ) -> np.ndarray:
        for i, (_ts, blob) in enumerate(self._b.messages(topic)):
            if i == frame:
                return decode_pointcloud2_cdr(blob, fields)
        return np.zeros((0, len(fields)), np.float32)

    # reference loadMultiplePointClouds (cpp:157-169)
    def load_multiple_point_clouds(
        self, topics: List[str], frame: int = 0
    ) -> List[np.ndarray]:
        return [self.load_point_cloud(t, frame) for t in topics]

    def iter_point_clouds(
        self, topic: str, fields: Tuple[str, ...] = ("x", "y", "z")
    ) -> Iterator[np.ndarray]:
        for _ts, blob in self._b.messages(topic):
            yield decode_pointcloud2_cdr(blob, fields)

    def close(self) -> None:
        self._b.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
