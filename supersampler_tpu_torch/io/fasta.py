"""FASTA input with the reference's exact parsing semantics.

The port's copy of what it needs from supersampler_tpu/io/fasta.py. The
reference reads records with getLineFasta (reference utils.cpp:706-718):
discard the current line, then concatenate lines until the next '>' or
EOF; clean_dna (utils.cpp:675-702) strips every non-ACGT character,
joining the flanks (chimeric k-mers across N runs, replicated), and
uppercases. The sketch pipeline streams spans (stream_fasta_spans) and
cleans them in C (native.py); the scalar oracle reads whole records
through iter_fasta_records and the Python clean_dna below.
"""

from __future__ import annotations

import gzip
import io
from typing import Iterator, List

from supersampler_tpu_torch.utils.profiling import phase


def open_maybe_gzip(path: str) -> io.BufferedReader:
    """Open a file, auto-detecting gzip by magic bytes (zstr behavior,
    reference include/zstr.hpp)."""
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return gzip.open(f, "rb")  # type: ignore[return-value]
    return f


_UPPER_TRANS = bytes.maketrans(b"acgt", b"ACGT")
_DELETE_NON_ACGT = bytes(c for c in range(256) if c not in b"ACGTacgt")


def clean_dna(s: bytes) -> bytes:
    """Strip non-ACGT and uppercase (reference utils.cpp:675-702) in one
    translate call."""
    return s.translate(_UPPER_TRANS, _DELETE_NON_ACGT)


def iter_fasta_raw(path: str) -> Iterator[bytes]:
    """Yield each record's raw body (header line dropped, newlines
    embedded), one per getLineFasta call: a header right after a header
    yields an empty body, never a slice that ends before it starts."""
    with open_maybe_gzip(path) as f:
        data = f.read()
    pos = 0
    n = len(data)
    while pos < n:
        nl = data.find(b"\n", pos)   # discard the current (header) line
        if nl < 0:
            yield b""
            break
        nxt = data.find(b"\n>", nl)
        if nxt < 0:
            body = data[nl + 1:]
            pos = n
        else:
            body = data[nl + 1 : max(nxt, nl + 1)]
            pos = nxt + 1
        yield body


def iter_fasta_records(path: str) -> Iterator[bytes]:
    """Yield cleaned sequences as the reference's read loop does
    (reference SubSampler.cpp:334-347 + utils.cpp:706-718): one item per
    getLineFasta call, possibly empty; the caller applies the length-k
    filter. Newlines are non-ACGT, so cleaning a whole body joins its
    lines as the reference's line loop does (a '>' ends a record only
    at the start of a line)."""
    for body in iter_fasta_raw(path):
        yield clean_dna(body)


def stream_fasta_spans(path: str, window_bytes: int = 4 << 20,
                       max_records: int = 4096):
    """Stream (data, spans) blocks with whole-record raw spans, reading
    the (possibly gzip) input incrementally with O(window + largest
    record) host memory (the reference streams input through zstr with a
    fixed window, include/zstr.hpp:397-399 + utils.cpp:357-364).

    Each span is one getLineFasta record body: header line dropped,
    newlines embedded; a header followed directly by another header
    gives an empty span (start, start). A block closes when its payload
    reaches window_bytes or max_records; the partially-read tail carries
    into the next block's buffer. File reads count under
    ``phase("parse")``."""
    with open_maybe_gzip(path) as f:
        buf = bytearray()
        eof = False

        def refill():
            nonlocal eof
            with phase("parse"):
                chunk = f.read(window_bytes)
            if chunk:
                buf.extend(chunk)
            else:
                eof = True

        pos = 0
        spans = []
        payload = 0
        while True:
            nl = buf.find(b"\n", pos)
            while nl < 0 and not eof:
                refill()
                nl = buf.find(b"\n", pos)
            if nl < 0:
                # EOF inside the header line (or empty input): an empty
                # body span only when any bytes remain
                if pos < len(buf):
                    spans.append((len(buf), len(buf)))
                break
            start = nl + 1
            sfrom = nl
            while True:
                nxt = buf.find(b"\n>", sfrom)
                if nxt >= 0:
                    # the header's own newline starts the search: a
                    # header right after it ends the body before start
                    end, pos = max(nxt, start), nxt + 1
                    break
                if eof:
                    end = pos = len(buf)
                    break
                # a "\n" at the buffer edge may pair with an unread
                # ">": re-scan from one byte back after refilling
                sfrom = max(nl, len(buf) - 1)
                refill()
            spans.append((start, end))
            payload += end - start
            at_eof = eof and pos >= len(buf)
            if (payload >= window_bytes or len(spans) >= max_records
                    or at_eof):
                yield bytes(buf), spans
                if at_eof:
                    return
                tail = bytes(buf[pos:])
                buf = bytearray(tail)
                pos = 0
                spans = []
                payload = 0
            if eof and pos >= len(buf):
                break
        if spans:
            yield bytes(buf), spans


def read_fof(path: str, min_len: int = 3) -> List[str]:
    """File-of-files reader: keeps lines longer than ``min_len`` chars
    (the subsampler keeps size > 3, reference SubSampler.cpp:780)."""
    out = []
    with open_maybe_gzip(path) as f:
        for raw in f.read().split(b"\n"):
            if len(raw) > min_len:
                out.append(raw.decode())
    return out


def get_out_name(path: str, prefix: str) -> str:
    """Output naming: prefix + basename up to the first '.', emitted in
    the CWD (reference SubSampler.cpp:196-221 ignores the directory
    part)."""
    base = path.rsplit("/", 1)[-1]
    stem = base.split(".", 1)[0]
    return prefix + stem
