"""Bounded-memory streaming comparison over sketch collections.

The reference comparator holds only the OPEN buckets of its N-way
merge in memory (reference Comparator.cpp:39-74); the batch engine in
compare/merge.py instead decodes every sketch fully and groups the
global pair array — fine at N=8, not at large collections. This module
restores the bounded-memory profile for the vectorized engine:

* BucketStream: raw per-bucket cursor over one sketch, DECOMPRESSING
  INCREMENTALLY (a rolling window of the gzip stream — resident memory
  per file is the window, which holds the buffered buckets, not the
  whole sketch) with byte-offset checkpointing (sketches are sorted by
  minimizer, reference SubSampler.h:62, so a global minimizer bound
  defines a clean chunk boundary);
* chunk_rounds: the N-way chunker — each round buffers raw buckets up
  to a payload budget per file, takes the MIN of the files' high-water
  minimizers as the chunk bound, and yields every file's buckets at or
  below it as one byte window (all pairs of a minimizer land in exactly
  one chunk, so per-chunk grouping/dedup equals global).

The header and the bucket bounds come from the whole-file reader
(compare/reader.py parse_header / parse_bucket_at), and a chunk's
windows decode through its native pass (parallel/compare_dist.py
decode_windows), as whole sketches do.

Chunks also give shard-resumable comparison (SURVEY §5): after each
chunk the comparator can persist {per-file offsets, partial scores}
and a restart seeks straight to the first unfinished chunk
(compare/merge.py TorchComparator.compare_sketches_chunked). The
port's copy of supersampler_tpu/compare/stream.py.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

from supersampler_tpu_torch.compare.reader import (parse_bucket_at,
                                                   parse_header)
from supersampler_tpu_torch.io.fasta import open_maybe_gzip

__all__ = ["BucketStream", "chunk_rounds"]

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
        self.k, self.m, pos0 = parse_header(self._win)
        self.offset = pos0 if offset is None else offset
        if offset is not None:
            # seek: decompress forward and drop everything before it
            while self._base + len(self._win) < offset:
                if not self._more():
                    break
            cut = min(max(offset - self._base, 0), len(self._win))
            self._win = self._win[cut:]
            self._base += cut
        # (start, end, minimizer, payload bytes) of each buffered bucket
        self._buf: List[Tuple[int, int, int, int]] = []
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
                mval, rel_end, payload = parse_bucket_at(
                    self._win, start - self._base, self.m)
                break
            except (ValueError, IndexError, struct.error):
                if not self._more():
                    raise ValueError(
                        "truncated sketch bucket at offset "
                        f"{start}") from None
        self.offset = self._base + rel_end
        self._buf.append((start, self.offset, mval, payload))
        self._buf_bytes += payload
        # bound the window: everything before the first untaken bucket
        # is consumed
        cut = self.resume_offset() - self._base
        if cut > _COMPACT_AT:
            self._win = self._win[cut:]
            self._base += cut

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
        return self._buf[-1][2] if self._bufi < len(self._buf) else -1

    def has_buffered(self) -> bool:
        return self._bufi < len(self._buf)

    def take_until(self, bound: int):
        """Pop the buffered buckets with minimizer <= bound and return
        them as one window (data, pos0, end) over the inflated bytes,
        None when there is none (index cursor: O(1) per bucket). The
        buckets lie next to each other, and data is never changed: a
        compaction makes a new window."""
        first = self._bufi
        while (self._bufi < len(self._buf)
               and self._buf[self._bufi][2] <= bound):
            self._buf_bytes -= self._buf[self._bufi][3]
            self._bufi += 1
        if self._bufi == first:
            return None
        out = (self._win, self._buf[first][0] - self._base,
               self._buf[self._bufi - 1][1] - self._base)
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

    Each yielded item is (chunk_index, per_file_windows, offsets)
    where per_file_windows[f] is the window (data, pos0, end) of file
    f's buckets in the chunk's minimizer range (None when it has none)
    and offsets[f] is f's resume offset AFTER the chunk. Every
    minimizer's buckets across all files land in exactly one chunk (the
    bound is the min of the files' buffered high-water minimizers, so
    no file can still hold an unread bucket at or below it)."""
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
