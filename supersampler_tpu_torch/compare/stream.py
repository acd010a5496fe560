"""Bounded-memory streaming comparison over sketch collections.

The reference comparator holds only the OPEN buckets of its N-way
merge in memory (reference Comparator.cpp:39-74); the batch engine in
compare/merge.py instead decodes every sketch fully and groups the
global pair array — fine at N=8, not at large collections. This module
restores the bounded-memory profile for the vectorized engine:

* BucketStream: raw per-bucket cursor over one sketch, DECOMPRESSING
  INCREMENTALLY (a rolling window of the gzip stream — resident memory
  per file is the window + buffered buckets, not the whole sketch)
  with byte-offset checkpointing (sketches are sorted by minimizer,
  reference SubSampler.h:62, so a global minimizer bound defines a
  clean chunk boundary);
* chunk_rounds: the N-way chunker — each round buffers raw buckets up
  to a payload budget per file, takes the MIN of the files' high-water
  minimizers as the chunk bound, and yields every file's buckets at or
  below it (all pairs of a minimizer land in exactly one chunk, so
  per-chunk grouping/dedup equals global).

Bucket wire parsing and pair decoding are shared with the whole-file
reader (compare/reader.py parse_bucket_at / decode_bucket_pairs) — one
implementation, two consumption patterns.

Chunks also give shard-resumable comparison (SURVEY §5): after each
chunk the comparator can persist {per-file offsets, partial scores}
and a restart seeks straight to the first unfinished chunk
(compare/merge.py TorchComparator.compare_sketches_chunked). The
port's copy of supersampler_tpu/compare/stream.py.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

from supersampler_tpu_torch.compare.reader import (decode_bucket_pairs,
                                                   parse_bucket_at)
from supersampler_tpu_torch.io.fasta import open_maybe_gzip

__all__ = ["BucketStream", "chunk_rounds", "decode_bucket_pairs"]

_READ_CHUNK = 1 << 18
_COMPACT_AT = 1 << 20     # drop consumed window prefix beyond this


class BucketStream:
    """Raw bucket cursor over one sketch with incremental
    decompression.

    `offset` addresses the DECOMPRESSED stream — a durable resume
    token (seeking = re-decompressing up to that offset, cheap next to
    decode+score). Buckets are yielded in file order (ascending
    minimizer).
    """

    def __init__(self, path: str, offset: Optional[int] = None):
        self._f = open_maybe_gzip(path)
        self._win = b""
        self._base = 0            # decompressed offset of _win[0]
        self._eof = False
        while b"\n" not in self._win:
            if not self._more():
                raise ValueError(f"no header line in {path}")
        nl = self._win.index(b"\n")
        parts = self._win[:nl].split(b" ")
        self.skmer_size_hdr = int(parts[0])
        self.m = int(parts[1])
        self.k = (self.skmer_size_hdr + self.m) // 2
        self.offset = (nl + 1) if offset is None else offset
        if offset is not None:
            # seek: decompress forward and drop everything before it
            while self._base + len(self._win) < offset:
                if not self._more():
                    break
            cut = min(max(offset - self._base, 0), len(self._win))
            self._win = self._win[cut:]
            self._base += cut
        self._buf: List[Tuple[int, int, bytes, List[bytes]]] = []
        self._bufi = 0            # consumed-prefix cursor
        self._buf_bytes = 0

    def _more(self) -> bool:
        if self._eof:
            return False
        d = self._f.read(_READ_CHUNK)
        if not d:
            self._eof = True
            self._f.close()
            return False
        self._win += d
        return True

    def _no_more_buckets(self) -> bool:
        """True when the stream cannot yield another bucket."""
        while (self._base + len(self._win) - self.offset < self.m
               and not self._eof):
            self._more()
        return self._base + len(self._win) - self.offset < self.m

    def exhausted(self) -> bool:
        return self._bufi >= len(self._buf) and self._no_more_buckets()

    def _read_one(self) -> None:
        start = self.offset
        while True:
            try:
                bucket, rel_end = parse_bucket_at(
                    self._win, start - self._base, self.m)
                break
            except (ValueError, IndexError, struct.error):
                if not self._more():
                    raise ValueError(
                        "truncated sketch bucket at offset "
                        f"{start}") from None
        self.offset = self._base + rel_end
        mval, blob, lines = bucket
        self._buf.append((start, mval, blob, lines))
        self._buf_bytes += len(blob) + sum(len(x) for x in lines)
        # bound the window: everything before the cursor is consumed
        cut = self.offset - self._base
        if cut > _COMPACT_AT:
            self._win = self._win[cut:]
            self._base = self.offset

    def fill(self, target_bytes: int) -> None:
        """Buffer raw buckets until ~target_bytes of payload (or EOF)."""
        while (self._buf_bytes < target_bytes
               and not self._no_more_buckets()):
            self._read_one()

    def high_minimizer(self) -> int:
        """Largest buffered minimizer; -1 with an empty buffer. When
        the file is exhausted the buffer covers everything, reported
        as +inf so it never constrains the chunk bound."""
        if self._no_more_buckets():
            return 1 << 62
        return self._buf[-1][1] if self._bufi < len(self._buf) else -1

    def has_buffered(self) -> bool:
        return self._bufi < len(self._buf)

    def take_until(self, bound: int):
        """Pop and return buffered (mval, blob, lines) buckets with
        minimizer <= bound (index cursor: O(1) per bucket)."""
        out = []
        while (self._bufi < len(self._buf)
               and self._buf[self._bufi][1] <= bound):
            _off, mval, blob, lines = self._buf[self._bufi]
            self._bufi += 1
            self._buf_bytes -= (len(blob)
                                + sum(len(x) for x in lines))
            out.append((mval, blob, lines))
        if self._bufi > 4096:
            del self._buf[: self._bufi]
            self._bufi = 0
        return out

    def resume_offset(self) -> int:
        """Byte offset of the first UNCONSUMED bucket — the durable
        resume token (buffered-but-untaken buckets must be re-read)."""
        if self._bufi < len(self._buf):
            return self._buf[self._bufi][0]
        return self.offset


def chunk_rounds(streams: List[BucketStream], chunk_bytes: int):
    """Yield chunks of the N-way bucket merge under a payload budget.

    Each yielded item is (chunk_index, per_file_buckets, offsets)
    where per_file_buckets[f] is file f's raw buckets for the chunk's
    minimizer range and offsets[f] is f's resume offset AFTER the
    chunk. Every minimizer's buckets across all files land in exactly
    one chunk (the bound is the min of the files' buffered high-water
    minimizers, so no file can still hold an unread bucket at or below
    it)."""
    per_file = max(chunk_bytes // max(len(streams), 1), 256)
    idx = 0
    while True:
        live = False
        for st in streams:
            st.fill(per_file)
            live = live or st.has_buffered()
        if not live:
            return
        bound = min(st.high_minimizer() for st in streams)
        chunk = [st.take_until(bound) for st in streams]
        offsets = [st.resume_offset() for st in streams]
        yield idx, chunk, offsets
        idx += 1
