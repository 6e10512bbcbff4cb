"""TensorBoard scalar writer on the standard library alone.

Counterpart of ``r3d_tpu/utils/tbwriter.py``: a ``events.out.tfevents.*``
file of TFRecord-framed Event protos (scalars only), which TensorBoard reads
natively, with no tensorflow or tensorboardX needed.

Wire format (tensorflow/core/util/event.proto, record_writer.cc):

- TFRecord frame: uint64 length (LE) | masked crc32c(length) |
  payload | masked crc32c(payload); mask(c) = ((c>>15 | c<<17) +
  0xa282ead8) mod 2^32, crc32c = Castagnoli polynomial 0x82f63b78.
- Event proto: field 1 wall_time (double), field 2 step (int64),
  field 3 file_version (string, first record only), field 5 summary
  (message). Summary: repeated field 1 Value; Value: field 1 tag (string),
  field 2 simple_value (float32).

``read_events`` parses such a file back, checking both CRCs of each frame.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Iterator, List, Tuple

_CRC_TABLE: List[int] = []


def _crc32c(data: bytes) -> int:
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = _crc32c(data)
    return ((c >> 15 | c << 17) + 0xA282EAD8) & 0xFFFFFFFF


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


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int = None, file_version: str = None,
           scalars: List[Tuple[str, float]] = None) -> bytes:
    # field 1 wall_time: key (1<<3)|WIRETYPE_FIXED64 = 0x09
    msg = bytes([0x09]) + struct.pack("<d", wall_time)
    if step is not None:
        msg += bytes([0x10]) + _varint(step)
    if file_version is not None:
        msg += _field_bytes(3, file_version.encode())
    if scalars:
        summary = b""
        for tag, value in scalars:
            val = _field_bytes(1, tag.encode()) + bytes([0x15]) + struct.pack(
                "<f", float(value)
            )
            summary += _field_bytes(1, val)
        msg += _field_bytes(5, summary)
    return msg


def _frame(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (
        header
        + struct.pack("<I", _masked_crc(header))
        + payload
        + struct.pack("<I", _masked_crc(payload))
    )


class SummaryWriter:
    """Minimal scalar-only TensorBoard writer (tb.SummaryWriter shape)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self._f = open(os.path.join(log_dir, name), "ab")
        self._f.write(_frame(_event(time.time(), file_version="brain.Event:2")))

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(
            _frame(_event(time.time(), step=step, scalars=[(tag, value)]))
        )

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def read_events(path: str) -> Iterator[dict]:
    """Parse a tfevents file back (round-trip testing / quick inspection
    without TensorBoard). Yields {'wall_time', 'step', 'scalars': {tag: v},
    'file_version'} dicts and verifies both frame CRCs."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        header = data[pos : pos + 8]
        (hcrc,) = struct.unpack_from("<I", data, pos + 8)
        if hcrc != _masked_crc(header):
            raise ValueError(f"{path}: header crc mismatch at byte {pos}")
        payload = data[pos + 12 : pos + 12 + length]
        (pcrc,) = struct.unpack_from("<I", data, pos + 12 + length)
        if pcrc != _masked_crc(payload):
            raise ValueError(f"{path}: payload crc mismatch at byte {pos}")
        pos += 12 + length + 4
        yield _decode_event(payload)


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    n = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos
        shift += 7


def _decode_event(buf: bytes) -> dict:
    out = {"scalars": {}}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 1:  # double
            (v,) = struct.unpack_from("<d", buf, pos)
            pos += 8
            if field == 1:
                out["wall_time"] = v
        elif wire == 0:
            v, pos = _read_varint(buf, pos)
            if field == 2:
                out["step"] = v
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            sub = buf[pos : pos + ln]
            pos += ln
            if field == 3:
                out["file_version"] = sub.decode()
            elif field == 5:
                spos = 0
                while spos < len(sub):
                    skey, spos = _read_varint(sub, spos)
                    sln, spos = _read_varint(sub, spos)
                    val = sub[spos : spos + sln]
                    spos += sln
                    tag, simple = None, None
                    vpos = 0
                    while vpos < len(val):
                        vkey, vpos = _read_varint(val, vpos)
                        vf, vw = vkey >> 3, vkey & 7
                        if vw == 2:
                            vln, vpos = _read_varint(val, vpos)
                            if vf == 1:
                                tag = val[vpos : vpos + vln].decode()
                            vpos += vln
                        elif vw == 5:
                            (sv,) = struct.unpack_from("<f", val, vpos)
                            vpos += 4
                            if vf == 2:
                                simple = sv
                        else:
                            break
                    if tag is not None and simple is not None:
                        out["scalars"][tag] = simple
        else:
            break
    return out
