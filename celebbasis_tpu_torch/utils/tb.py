"""TensorBoard event writer without a TensorBoard package.

Counterpart of ``celebbasis_tpu/utils/tb.py``, kept as the port's own copy:
it writes the ``events.out.tfevents.*`` stream of the reference's
TensorBoard logger, so TensorBoard reads the port's run dirs unchanged.
For the same tags, values, steps and wall times it writes the same bytes as
the JAX package's writer.  From the public file format:

* TFRecord framing: ``uint64 length | masked-crc32c(length) | payload |
  masked-crc32c(payload)``;
* payload = a ``tensorflow.Event`` protobuf, encoded by hand (the fields the
  scalar and image dashboards read: wall_time, step, file_version,
  summary{tag, simple_value | image}).

The CRC32C is the Castagnoli polynomial, table-driven.
"""
from __future__ import annotations

import io
import os
import socket
import struct
import time
from typing import Optional

import numpy as np


def _make_crc_table():
    poly, table = 0x82F63B78, []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return tuple(table)


_CRC_TABLE = _make_crc_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# -- protobuf encoding --------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if not n:
            out.append(b)
            return bytes(out)
        out.append(b | 0x80)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _pb_bytes(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _pb_string(field: int, s: str) -> bytes:
    return _pb_bytes(field, s.encode("utf-8"))


def _pb_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _pb_int64(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


# -- event records ------------------------------------------------------------

def _event(step: Optional[int] = None, wall_time: Optional[float] = None,
           file_version: Optional[str] = None,
           summary: Optional[bytes] = None) -> bytes:
    # Event: 1 = wall_time (double), 2 = step (int64), 3 = file_version
    # (string), 5 = summary (Summary)
    out = _pb_double(1, time.time() if wall_time is None else wall_time)
    if step is not None:
        out += _pb_int64(2, step)
    if file_version is not None:
        out += _pb_string(3, file_version)
    if summary is not None:
        out += _pb_bytes(5, summary)
    return out


def _scalar_summary(tag: str, value: float) -> bytes:
    # Summary.Value: 1 = tag, 2 = simple_value (float); Summary: 1 = value
    return _pb_bytes(1, _pb_string(1, tag) + _pb_float(2, float(value)))


def _image_summary(tag: str, img_u8: np.ndarray) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img_u8).save(buf, format="PNG")
    h, w = img_u8.shape[:2]
    c = 1 if img_u8.ndim == 2 else img_u8.shape[2]
    # Summary.Image: 1 = height, 2 = width, 3 = colorspace, 4 = encoded
    image = (_pb_int64(1, h) + _pb_int64(2, w) + _pb_int64(3, c)
             + _pb_bytes(4, buf.getvalue()))
    return _pb_bytes(1, _pb_string(1, tag) + _pb_bytes(4, image))


class TBWriter:
    """Append-only ``events.out.tfevents`` writer (scalars and images).
    ``wall_time`` defaults to the time of the call."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}.{os.getpid()}.0")
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        self._write(_event(file_version="brain.Event:2"))

    def _write(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", masked_crc32c(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", masked_crc32c(payload)))

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: Optional[float] = None) -> None:
        self._write(_event(step=step, wall_time=wall_time,
                           summary=_scalar_summary(tag, value)))

    def add_image(self, tag: str, img_u8: np.ndarray, step: int,
                  wall_time: Optional[float] = None) -> None:
        self._write(_event(step=step, wall_time=wall_time,
                           summary=_image_summary(tag, img_u8)))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


# -- reader -------------------------------------------------------------------

def read_tfrecords(path: str):
    """Yield the raw event payloads, checking both CRCs."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (hcrc,) = struct.unpack("<I", f.read(4))
            if hcrc != masked_crc32c(header):
                raise ValueError("corrupt tfrecord length crc")
            (n,) = struct.unpack("<Q", header)
            payload = f.read(n)
            (pcrc,) = struct.unpack("<I", f.read(4))
            if pcrc != masked_crc32c(payload):
                raise ValueError("corrupt tfrecord payload crc")
            yield payload


def _read_varint(data: bytes, i: int):
    v, shift = 0, 0
    while True:
        b = data[i]
        i += 1
        v |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return v, i


def _pb_fields(data: bytes):
    """One protobuf message -> {field: [values]} (wire level)."""
    out: dict = {}
    i = 0
    while i < len(data):
        key, i = _read_varint(data, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(data, i)
        elif wire == 1:
            v, i = data[i:i + 8], i + 8
        elif wire == 2:
            n, i = _read_varint(data, i)
            v, i = data[i:i + n], i + n
        elif wire == 5:
            v, i = data[i:i + 4], i + 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        out.setdefault(field, []).append(v)
    return out


def read_scalars(path: str):
    """-> list of (step, tag, value) from an event file."""
    out = []
    for payload in read_tfrecords(path):
        ev = _pb_fields(payload)
        step = ev.get(2, [0])[0]
        for summ in ev.get(5, []):
            for val in _pb_fields(summ).get(1, []):
                fields = _pb_fields(val)
                if 2 in fields:          # simple_value
                    (v,) = struct.unpack("<f", fields[2][0])
                    out.append((step, fields[1][0].decode("utf-8"), v))
    return out
