"""From-scratch TensorBoard event-file writer (no tensorboard dependency).

The port's own copy of styletts2_tpu/tb_events.py (JAX-free; copied so the
port imports nothing of the JAX package).

The reference logs train/eval scalars through torch's SummaryWriter
(reference train.py:48, 336-342, 461-463), producing `events.out.tfevents.*`
files that the TensorBoard UI and its ecosystem (tbparse, wandb sync, ...)
consume. This module writes the same format directly:

* TFRecord framing: ``uint64 length | uint32 masked_crc32c(length) |
  payload | uint32 masked_crc32c(payload)``, with the CRC-32C (Castagnoli)
  polynomial and TensorFlow's rotate-and-add masking.
* Payloads are hand-encoded `tensorflow.Event` protobufs — only the three
  fields scalar logging needs (wall_time, step, summary{tag, simple_value}
  / file_version), encoded with the stable proto wire rules, so no protoc
  or protobuf runtime is required.

Scalar-event volume is tiny (a few per log interval), so the pure-Python
CRC table is not a hot path.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

# ---------------------------------------------------------------------------
# CRC-32C (Castagnoli, reflected polynomial 0x82F63B78) + TF masking
# ---------------------------------------------------------------------------


def _make_crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _make_crc32c_table()


def crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TensorFlow's CRC mask (tensorflow/core/lib/hash/crc32c.h)."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf wire encoding (only what tensorflow.Event scalars need)
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_double(num: int, value: float) -> bytes:
    return _varint(num << 3 | 1) + struct.pack("<d", value)


def _field_float(num: int, value: float) -> bytes:
    return _varint(num << 3 | 5) + struct.pack("<f", value)


def _field_varint(num: int, value: int) -> bytes:
    return _varint(num << 3) + _varint(value)


def _field_bytes(num: int, value: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(value)) + value


def encode_scalar_event(tag: str, value: float, step: int,
                        wall_time: Optional[float] = None) -> bytes:
    """tensorflow.Event{wall_time=1, step=2, summary=5{value=1{tag=1,
    simple_value=2}}}."""
    summary_value = (_field_bytes(1, tag.encode("utf-8"))
                     + _field_float(2, float(value)))
    summary = _field_bytes(1, summary_value)
    return (_field_double(1, time.time() if wall_time is None else wall_time)
            + _field_varint(2, int(step))
            + _field_bytes(5, summary))


def encode_file_version_event(wall_time: Optional[float] = None) -> bytes:
    """The header event every tfevents file starts with
    (file_version=3 == "brain.Event:2")."""
    return (_field_double(1, time.time() if wall_time is None else wall_time)
            + _field_bytes(3, b"brain.Event:2"))


def write_record(f, payload: bytes) -> None:
    header = struct.pack("<Q", len(payload))
    f.write(header)
    f.write(struct.pack("<I", masked_crc32c(header)))
    f.write(payload)
    f.write(struct.pack("<I", masked_crc32c(payload)))


def read_records(f):
    """Inverse of write_record (CRC-checked) — for tests/tools."""
    while True:
        header = f.read(8)
        if len(header) < 8:
            return
        (length,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack("<I", f.read(4))
        assert hcrc == masked_crc32c(header), "corrupt tfevents header"
        payload = f.read(length)
        (pcrc,) = struct.unpack("<I", f.read(4))
        assert pcrc == masked_crc32c(payload), "corrupt tfevents payload"
        yield payload


def decode_scalar_event(payload: bytes):
    """Decode the fields encode_scalar_event writes. Returns
    (wall_time, step, tag, value) — tag/value None for the header event."""
    pos = 0
    wall_time = step = tag = value = None

    def _read_varint():
        nonlocal pos
        shift = n = 0
        while True:
            b = payload[pos]
            pos += 1
            n |= (b & 0x7F) << shift
            if not b & 0x80:
                return n
            shift += 7

    def _parse_value(buf):
        # Summary.Value{tag=1 (bytes), simple_value=2 (float)}
        nonlocal tag, value
        p = 0
        while p < len(buf):
            key = buf[p]
            p += 1
            if key == 0x0A:
                ln = buf[p]
                p += 1
                tag = buf[p: p + ln].decode("utf-8")
                p += ln
            elif key == 0x15:
                value = struct.unpack("<f", buf[p: p + 4])[0]
                p += 4
            else:
                raise AssertionError(f"unexpected value key {key:#x}")

    def _parse(buf):
        # Summary{value=1 (repeated submessage)}
        p = 0
        while p < len(buf):
            key = buf[p]
            p += 1
            assert key == 0x0A, f"unexpected summary key {key:#x}"
            ln = buf[p]
            p += 1
            _parse_value(buf[p: p + ln])
            p += ln

    while pos < len(payload):
        key = _read_varint()
        field, wire = key >> 3, key & 7
        if field == 1 and wire == 1:
            wall_time = struct.unpack("<d", payload[pos: pos + 8])[0]
            pos += 8
        elif field == 2 and wire == 0:
            step = _read_varint()
        elif field == 3 and wire == 2:
            ln = _read_varint()
            pos += ln  # file_version header
        elif field == 5 and wire == 2:
            ln = _read_varint()
            _parse(payload[pos: pos + ln])
            pos += ln
        else:
            raise AssertionError(f"unexpected event field {field}/{wire}")
    return wall_time, step, tag, value


class TBEventWriter:
    """Append scalar events to an `events.out.tfevents.*` file the
    TensorBoard UI loads directly (reference train.py:48)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}")
        self.path = os.path.join(log_dir, name)
        self._f = open(self.path, "ab")
        write_record(self._f, encode_file_version_event())
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        write_record(self._f, encode_scalar_event(tag, value, step))
        self._f.flush()

    def close(self) -> None:
        self._f.close()
