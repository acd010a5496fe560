"""gzip container writer byte-identical to zlib's gzopen (used by the
reference via zstr): mtime=0, XFL from level, OS=3 (Unix).

Python's gzip module writes OS=0xff; everything else (the deflate
stream, CRC, ISIZE) already matches, so replicating the 10-byte header
makes the sketch and CSV files byte-identical to the reference's. The
port's copy of supersampler_tpu/io/gzip_exact.py."""

from __future__ import annotations

import struct
import zlib


def gzip_compress_exact(data: bytes, level: int) -> bytes:
    xfl = 2 if level >= 9 else 4 if level == 1 else 0
    header = b"\x1f\x8b\x08\x00\x00\x00\x00\x00" + bytes([xfl, 3])
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    body = co.compress(data) + co.flush()
    tail = struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF,
                       len(data) & 0xFFFFFFFF)
    return header + body + tail


def write_gzip_exact(path: str, data: bytes, level: int) -> None:
    with open(path, "wb") as f:
        f.write(gzip_compress_exact(data, level))
