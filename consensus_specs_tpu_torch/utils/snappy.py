"""Snappy framing-format codec, dependency-free (replaces the reference's
python-snappy C binding for `.ssz_snappy` parts, ref gen_runner.py:14,229).

Writer emits spec-valid frames using uncompressed chunks (type 0x01) —
any snappy framing reader accepts them. Reader handles both chunk kinds
and the full snappy block format (literals + all copy ops), so vectors
produced by real compressors round-trip. CRC32C per the framing spec.
A native C++ match-finding compressor can swap in behind `compress`.
"""
from __future__ import annotations

import struct

STREAM_IDENTIFIER = b"\xff\x06\x00\x00sNaPpY"
_CHUNK_COMPRESSED = 0x00
_CHUNK_UNCOMPRESSED = 0x01
_MAX_CHUNK = 65536

# -- CRC32C (Castagnoli), table-driven ---------------------------------------

_CRC_TABLE = []


def _build_table():
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_build_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- framing writer ----------------------------------------------------------

def compress(data: bytes) -> bytes:
    """Snappy framing stream of ``data`` (uncompressed chunks)."""
    out = bytearray(STREAM_IDENTIFIER)
    view = memoryview(data)
    for off in range(0, len(data), _MAX_CHUNK):
        chunk = bytes(view[off : off + _MAX_CHUNK])
        body = struct.pack("<I", _masked_crc(chunk)) + chunk
        out += bytes([_CHUNK_UNCOMPRESSED]) + len(body).to_bytes(3, "little") + body
    if len(data) == 0:
        body = struct.pack("<I", _masked_crc(b""))
        out += bytes([_CHUNK_UNCOMPRESSED]) + len(body).to_bytes(3, "little") + body
    return bytes(out)


# -- snappy block-format decompressor ----------------------------------------

def _uvarint(data: bytes, pos: int):
    shift = 0
    result = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _decompress_block(data: bytes) -> bytes:
    length, pos = _uvarint(data, 0)
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 0b11
        if kind == 0:  # literal
            size = tag >> 2
            if size < 60:
                size += 1
            else:
                extra = size - 59
                size = int.from_bytes(data[pos : pos + extra], "little") + 1
                pos += extra
            out += data[pos : pos + size]
            pos += size
        else:
            if kind == 1:  # copy, 1-byte offset
                size = ((tag >> 2) & 0b111) + 4
                offset = ((tag >> 5) << 8) | data[pos]
                pos += 1
            elif kind == 2:  # copy, 2-byte offset
                size = (tag >> 2) + 1
                offset = int.from_bytes(data[pos : pos + 2], "little")
                pos += 2
            else:  # copy, 4-byte offset
                size = (tag >> 2) + 1
                offset = int.from_bytes(data[pos : pos + 4], "little")
                pos += 4
            if offset == 0 or offset > len(out):
                raise ValueError("snappy: invalid copy offset")
            # overlapping copies are byte-at-a-time semantics
            for _ in range(size):
                out.append(out[-offset])
    if len(out) != length:
        raise ValueError(f"snappy: length mismatch ({len(out)} != {length})")
    return bytes(out)


def decompress(data: bytes) -> bytes:
    """Decode a snappy framing stream (both chunk kinds)."""
    if not data.startswith(STREAM_IDENTIFIER[:4]):
        raise ValueError("snappy: missing stream identifier")
    pos = 0
    out = bytearray()
    n = len(data)
    while pos < n:
        chunk_type = data[pos]
        length = int.from_bytes(data[pos + 1 : pos + 4], "little")
        body = data[pos + 4 : pos + 4 + length]
        pos += 4 + length
        if chunk_type == 0xFF:  # stream identifier
            if body != STREAM_IDENTIFIER[4:]:
                raise ValueError("snappy: bad stream identifier")
        elif chunk_type == _CHUNK_UNCOMPRESSED:
            crc = struct.unpack("<I", body[:4])[0]
            chunk = body[4:]
            if _masked_crc(chunk) != crc:
                raise ValueError("snappy: crc mismatch")
            out += chunk
        elif chunk_type == _CHUNK_COMPRESSED:
            crc = struct.unpack("<I", body[:4])[0]
            chunk = _decompress_block(body[4:])
            if _masked_crc(chunk) != crc:
                raise ValueError("snappy: crc mismatch")
            out += chunk
        elif 0x80 <= chunk_type <= 0xFE:
            continue  # reserved skippable chunks (incl. padding 0xFE)
        else:
            raise ValueError(f"snappy: unknown chunk type {chunk_type:#x}")
    return bytes(out)
