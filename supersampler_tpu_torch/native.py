"""Loader for the native host library (csrc/spsp_*.c).

The port's copy of what it uses from supersampler_tpu/native.py: the
long-double FHS threshold, the one-pass clean + 2-bit pack of a record
or of a chunk's records, and the C finisher (k-mer store,
reconstruction, serialization); and the port's own sketch read and
decode and pair grouping for the comparator. The threshold and the
finisher come from the repo's shared ``csrc/spsp_native.c`` and
``csrc/spsp_finish.c``; the clean + pack from the port's own
``supersampler_tpu_torch/csrc/spsp_io.c``, whose fast path strips every
non-ACGT byte as the reference does (the shared copy keeps a few, see
that file); the comparator's three native stages from the port's
``supersampler_tpu_torch/csrc/``, each on up to 8 threads, with the
interpreter lock released for the whole call as ctypes does:

* ``read_files_native`` (``spsp_read.c``): every sketch of a comparison
  opened, read whole and inflated (gzip members as Python's gzip module
  reads them; zlib's raw inflate), the end of its header line found, and
  the bytes copied into one pooled buffer in file order;
* ``decode_windows_native`` (``spsp_decode.c``): one pass over every
  byte window of whole buckets, each a file's part of that pool or the
  caller's bytes, into one set of concatenated pair arrays and file ids;
* ``group_pairs_native`` (``spsp_decode.c``): the pairs numbered by
  distinct (minimizer, k-mer).

The read's and the pass's threads follow their input: the fewest of 8,
the CPUs the process may run on, its files or windows, and for the pass
one for every 64 KiB, so a single small sketch stays on the caller's
thread. The sources compile with the system C compiler,
linked with zlib, into the port's own ``build/libspsp_torch_native.so``
at first use, and again when a source is newer than the library. A
failed build raises: there are no Python fallbacks.
"""

from __future__ import annotations

import ctypes
import gzip
import os
import subprocess
import threading
import zlib
from typing import NamedTuple

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_PKG)
_SOURCES = [os.path.join(_ROOT, "csrc", "spsp_native.c"),
            os.path.join(_ROOT, "csrc", "spsp_finish.c"),
            os.path.join(_PKG, "csrc", "spsp_io.c"),
            os.path.join(_PKG, "csrc", "spsp_decode.c"),
            os.path.join(_PKG, "csrc", "spsp_read.c")]
_LIB = os.path.join(_ROOT, "build", "libspsp_torch_native.so")

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64


def _stale() -> bool:
    if not os.path.exists(_LIB):
        return True
    built = os.path.getmtime(_LIB)
    return any(os.path.getmtime(s) > built for s in _SOURCES)


def _build() -> None:
    """Compile into a process-private file, then rename it into place,
    so concurrent processes never load a half-written library."""
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    errors = []
    for cc in ("cc", "gcc", "clang"):
        cmd = [cc, "-O3", "-march=native", "-shared", "-fPIC", "-pthread",
               "-o", tmp, *_SOURCES, "-lm", "-lz"]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError:
            errors.append(f"{cc}: not found")
            continue
        if r.returncode == 0:
            os.replace(tmp, _LIB)
            return
        errors.append(f"{' '.join(cmd)} (rc {r.returncode}):\n{r.stderr}")
    raise RuntimeError("the native host library did not build:\n"
                       + "\n".join(errors))


def get_lib() -> ctypes.CDLL:
    """The loaded native library, built first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _stale():
            _build()
        lib = ctypes.CDLL(_LIB)
        lib.spsp_threshold.restype = ctypes.c_uint64
        lib.spsp_threshold.argtypes = [ctypes.c_uint64, ctypes.c_uint64,
                                       ctypes.c_double]
        lib.spsp_finish_new.restype = _P
        lib.spsp_finish_new.argtypes = [_I, _I, _I]
        lib.spsp_finish_free.argtypes = [_P]
        lib.spsp_finish_spans.argtypes = [_P, _P, _I64, _I64, _P, _P, _P, _P]
        lib.spsp_finish_spans_batch.argtypes = (
            [_P] + [_P] * 3 + [_I64] + [_P] * 8)
        lib.spsp_finish_serialize.restype = _I64
        lib.spsp_finish_serialize.argtypes = [
            _P, ctypes.POINTER(ctypes.c_char_p), _P]
        lib.spsp_finish_release.argtypes = [ctypes.c_char_p]
        lib.spsp_clean_pack.restype = _I64
        lib.spsp_clean_pack.argtypes = [_P, _I64, _P, _P, _I64, _I64]
        lib.spsp_clean_pack_batch.argtypes = (
            [_P] + [_P] * 2 + [_I64] + [_P] * 6)
        lib.spsp_read_files.restype = _I64
        lib.spsp_read_files.argtypes = [_I64, _P, _I64, _P]
        lib.spsp_read_collect.restype = None
        lib.spsp_read_collect.argtypes = [_I64, _P, _P, _P]
        lib.spsp_decode_windows.restype = _I64
        lib.spsp_decode_windows.argtypes = (
            [_I64, _I64, _P, _P, _I64] + [_P] * 7)
        lib.spsp_group_pairs.restype = _I64
        lib.spsp_group_pairs.argtypes = [_P] * 4 + [_I64] + [_P] * 3
        _lib = lib
        return _lib


def threshold_native(k: int, m: int, s: float) -> int:
    """Exact FHS threshold via native long double."""
    return int(get_lib().spsp_threshold(k, m, float(s)))


class NativeFinisher:
    """ctypes wrapper over the C k-mer store + reconstructor +
    serializer (csrc/spsp_finish.c)."""

    def __init__(self, k: int, m: int, abundance: int):
        self._lib = get_lib()
        self._h = self._lib.spsp_finish_new(k, m, abundance)

    def add_spans(self, ref, pos, last, val, rev) -> None:
        """ref: the cleaned sequence as a uint8 numpy array (passed
        zero-copy by pointer)."""
        pos = np.ascontiguousarray(pos, np.int64)
        last = np.ascontiguousarray(last, np.int64)
        val = np.ascontiguousarray(val, np.uint32)
        rev = np.ascontiguousarray(rev, np.uint8)
        ref = np.ascontiguousarray(ref, np.uint8)
        self._lib.spsp_finish_spans(
            self._h, ref.ctypes.data, ref.size, len(pos), pos.ctypes.data,
            last.ctypes.data, val.ctypes.data, rev.ctypes.data)

    def add_spans_batch(self, ref_pool, ref_offs, ref_lens, pos, last,
                        val, rev, span_offs, tail_last, tail_val,
                        tail_rev) -> None:
        """Ingest a contiguous run of records in ONE C call (record
        order preserved: the store's first-insertion order is part of
        the byte-exact serialization contract). Arrays: ref_pool u8 +
        per-record offsets/lengths i64; record-major event arrays with
        span_offs (n_rec+1) boundaries; per-record tails (tail_last
        < 0 = no selected tail)."""
        c = np.ascontiguousarray
        ref_pool = c(ref_pool, np.uint8)
        ref_offs = c(ref_offs, np.int64)
        ref_lens = c(ref_lens, np.int64)
        pos = c(pos, np.int64)
        last = c(last, np.int64)
        val = c(val, np.uint32)
        rev = c(rev, np.uint8)
        span_offs = c(span_offs, np.int64)
        tail_last = c(tail_last, np.int64)
        tail_val = c(tail_val, np.uint32)
        tail_rev = c(tail_rev, np.uint8)
        self._lib.spsp_finish_spans_batch(
            self._h, ref_pool.ctypes.data, ref_offs.ctypes.data,
            ref_lens.ctypes.data, len(ref_lens), pos.ctypes.data,
            last.ctypes.data, val.ctypes.data, rev.ctypes.data,
            span_offs.ctypes.data, tail_last.ctypes.data,
            tail_val.ctypes.data, tail_rev.ctypes.data)

    def serialize(self):
        """Returns (payload_bytes, counters[6]): seen_kmers,
        seen_skmers, seen_max_skmers, seen_unique, total_kmer_recon,
        n_buckets."""
        out = ctypes.c_char_p()
        counters = np.zeros(6, np.int64)
        n = self._lib.spsp_finish_serialize(
            self._h, ctypes.byref(out), counters.ctypes.data)
        data = ctypes.string_at(out, n)
        self._lib.spsp_finish_release(out)
        return data, counters

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.spsp_finish_free(self._h)
            self._h = None


def clean_pack_native(raw_view, padded: int, halo: int = 128):
    """One-pass clean + 2-bit pack (supersampler_tpu_torch/csrc/spsp_io.c
    spsp_clean_pack).

    raw_view: np.uint8 array (a zero-copy view into the file buffer is
    fine). Returns (ref_u8_array_of_cleaned_len, packed_u8_array, o).
    halo and padded must be multiples of 4 with len(raw_view) <= padded
    (cleaning only shrinks)."""
    raw_view = np.ascontiguousarray(raw_view, np.uint8)
    n = raw_view.size
    ref = np.empty(max(n, 1), np.uint8)
    packed = np.empty((halo + padded) >> 2, np.uint8)
    o = get_lib().spsp_clean_pack(raw_view.ctypes.data, n, ref.ctypes.data,
                                  packed.ctypes.data, halo, padded)
    return ref[:o], packed, int(o)


def clean_pack_batch_native(data_view, starts, ends, ref_pool,
                            ref_offs, pack_pool, pack_offs, padded):
    """One C call cleaning + packing every record of a chunk
    (supersampler_tpu_torch/csrc/spsp_io.c spsp_clean_pack_batch).
    Returns out_lens i64[n].
    Pack rows are written at pack_pool + pack_offs[r] with padded[r]
    positions, halo 0."""
    c = np.ascontiguousarray
    data_view = c(data_view, np.uint8)
    starts = c(starts, np.int64)
    ends = c(ends, np.int64)
    ref_offs = c(ref_offs, np.int64)
    pack_offs = c(pack_offs, np.int64)
    padded = c(padded, np.int64)
    out_lens = np.empty(starts.size, np.int64)
    get_lib().spsp_clean_pack_batch(
        data_view.ctypes.data, starts.ctypes.data, ends.ctypes.data,
        starts.size, ref_pool.ctypes.data, ref_offs.ctypes.data,
        pack_pool.ctypes.data, pack_offs.ctypes.data,
        padded.ctypes.data, out_lens.ctypes.data)
    return out_lens


# the columns of spsp_read_files' rows and their codes
# (supersampler_tpu_torch/csrc/spsp_read.c)
_R_BUF, _R_SIZE, _R_STATUS, _R_CODE, _R_MSG, _R_POS0 = range(6)
_READ_OS, _READ_EOF, _READ_BAD_GZIP, _READ_ZLIB = range(1, 5)
_GZ_REASONS = {1: "Not a gzipped file", 2: "Unknown compression method",
               3: "CRC check failed",
               4: "Incorrect length of data produced"}


class Inflated(NamedTuple):
    """Files read by read_files_native, in file order: file i's bytes
    are pool[offs[i]:offs[i + 1]]. status is 0 where the file was read
    whole, else see error(). pos0 is the offset after the header line,
    0 where the bytes hold no whole line."""
    pool: np.ndarray
    offs: np.ndarray
    status: np.ndarray
    code: np.ndarray
    msg: np.ndarray
    pos0: np.ndarray
    threads: int

    def error(self, i: int, path) -> Exception:
        """The exception that reading file i alone with Python's open
        and gzip raises, for a file whose status is not 0."""
        status, code = int(self.status[i]), int(self.code[i])
        if status == _READ_OS:
            return OSError(code, os.strerror(code), path)
        if status == _READ_EOF:
            return EOFError("Compressed file ended before the "
                            f"end-of-stream marker was reached: {path}")
        if status == _READ_BAD_GZIP:
            return gzip.BadGzipFile(f"{_GZ_REASONS[code]}: {path}")
        if status == _READ_ZLIB:
            msg = (": " + ctypes.string_at(int(self.msg[i])).decode()
                   if self.msg[i] else "")
            return zlib.error(f"Error {code} while decompressing data{msg}: "
                              f"{path}")
        return MemoryError(f"reading {path} ran out of memory")


def read_files_native(paths, threads: int = 0) -> Inflated:
    """Read and inflate every file in one C call on up to 8 threads
    (supersampler_tpu_torch/csrc/spsp_read.c spsp_read_files; threads
    above 0 pins their number), then copy their bytes into one pooled
    buffer in file order (spsp_read_collect). A file that starts with
    the gzip magic is inflated as Python's gzip module reads it, member
    after member; other bytes are taken as they are. Raises nothing for
    a file that cannot be read: see Inflated."""
    names = [os.fsencode(p) for p in paths]
    if any(b"\0" in name for name in names):
        raise ValueError("embedded null byte")
    n = len(names)
    rows = np.zeros((n, 6), np.int64)
    lib = get_lib()
    used = lib.spsp_read_files(n, (ctypes.c_char_p * n)(*names), threads,
                               rows.ctypes.data)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(rows[:, _R_SIZE], out=offs[1:])
    pool = None
    try:
        pool = np.empty(int(offs[-1]), np.uint8)
    finally:
        lib.spsp_read_collect(n, rows.ctypes.data,
                              None if pool is None else pool.ctypes.data,
                              offs.ctypes.data)
    return Inflated(pool, offs, *(rows[:, c] for c in (
        _R_STATUS, _R_CODE, _R_MSG, _R_POS0)), int(used))


class Decoded(NamedTuple):
    """What decode_windows_native gives: the distinct pairs of every
    window (mins, his, los uint64, fids int64), concatenated in window
    order; each window's pair count; the bucket minimizers of the query
    windows in order; the k-mer windows before the dedup; the threads
    that ran."""
    mins: np.ndarray
    his: np.ndarray
    los: np.ndarray
    fids: np.ndarray
    pairs: np.ndarray
    bmins: np.ndarray
    windows: int
    threads: int


def decode_windows_native(windows, fids, n_query: int,
                          threads: int = 0) -> Decoded:
    """Every bucket of every window decoded to its distinct canonical
    k-mers in one C pass on up to 8 threads
    (supersampler_tpu_torch/csrc/spsp_decode.c spsp_decode_windows;
    threads above 0 pins their number).

    windows: (data, pos0, end, k, m) each, the buckets of
    data[pos0:end], data being bytes or a uint8 numpy array that the
    caller keeps; fids: each window's file id, written
    beside its pairs; the first n_query windows' bucket minimizers are
    returned.
    Pairs come window by window, buckets in order, then (hi, lo)
    ascending. Raises ValueError for the first window, in order, whose
    k or m the pass cannot hold (k above 64 or m above 32) or whose
    range lies outside its data, then for the first with a bucket cut
    short or malformed."""
    n = len(windows)
    rows = []
    for data, pos0, end, k, m in windows:
        arr = np.frombuffer(data, np.uint8)
        rows.append((arr.ctypes.data, arr.size, pos0, end, k, m))
    cols = np.array(rows, np.int64).reshape(n, 6)
    addr, size, pos0, end, k, m = cols.T
    bad_km = (m < 1) | (m > 32) | (k < 1) | (k > 64)
    bad = bad_km | (pos0 < 0) | (pos0 > end) | (end > size)
    if bad.any():
        i = int(np.argmax(bad))
        if bad_km[i]:
            raise ValueError(f"sketch header gives k={k[i]}, m={m[i]}: the "
                             "decode takes 1 <= k <= 64 and 1 <= m <= 32")
        raise ValueError(f"byte range [{pos0[i]}, {end[i]}) is outside the "
                         f"{size[i]} bytes given")
    addr = np.ascontiguousarray(addr)
    win = np.column_stack([pos0, end, k, m, np.asarray(fids, np.int64)])
    out = np.empty((n, 4), np.int64)
    info = np.zeros(5, np.int64)
    lib = get_lib()
    args = (n, n_query, addr.ctypes.data, win.ctypes.data, threads,
            out.ctypes.data)
    rc = lib.spsp_decode_windows(*args, None, None, None, None, None,
                                 info.ctypes.data)
    if rc == 0:
        total = int(info[0])
        mins, his, los = (np.empty(total, np.uint64) for _ in range(3))
        fids_out = np.empty(total, np.int64)
        bmins = np.empty(int(info[4]), np.uint64)
        rc = lib.spsp_decode_windows(
            *args, mins.ctypes.data, his.ctypes.data, los.ctypes.data,
            fids_out.ctypes.data, bmins.ctypes.data, info.ctypes.data)
    if rc == -1:
        raise ValueError("sketch bucket cut short or malformed at byte "
                         f"{int(out[int(info[3]), 3])} of the inflated "
                         "sketch")
    if rc != 0:
        raise MemoryError("the sketch decode ran out of memory")
    p = int(info[1])
    return Decoded(mins[:p], his[:p], los[:p], fids_out[:p], out[:, 2],
                   bmins, int(info[0]), int(info[2]))


def group_pairs_native(mins, his, los, fids):
    """Number the distinct (minimizer, k-mer) pairs of decoded files in
    one C pass (supersampler_tpu_torch/csrc/spsp_decode.c
    spsp_group_pairs).

    fids must never descend, so that each file's pairs are one stretch.
    The pairs are cut into slices of one file and one minimizer, the
    slices ordered by minimizer (file order kept) and each minimizer's
    k-mers sorted stably, on up to 8 threads; runs counts the stretches
    of one file with non-decreasing minimizers (one per sketch whose
    buckets are in order). Returns (group ids int32[], file ids int32[],
    runs), both arrays in (minimizer, hi, lo, file) order: group ids
    non-decreasing, file ids ascending within a group. Raises ValueError
    naming the first position whose file id is below its
    predecessor's."""
    c = np.ascontiguousarray
    mins, his, los = (c(a, np.uint64) for a in (mins, his, los))
    fids = c(fids, np.int64)
    n = mins.size
    if not his.size == los.size == fids.size == n:
        raise ValueError("group_pairs takes arrays of one length")
    # the pass checks that fids never descend, so these bound them all
    if n >= 1 << 31 or (n and (fids[0] < 0 or fids[-1] >= 1 << 31)):
        raise ValueError("group_pairs takes fewer than 2^31 pairs and "
                         "file ids in [0, 2^31)")
    gids = np.empty(n, np.int32)
    fids_out = np.empty(n, np.int32)
    info = np.zeros(3, np.int64)
    rc = get_lib().spsp_group_pairs(
        mins.ctypes.data, his.ctypes.data, los.ctypes.data,
        fids.ctypes.data, n, gids.ctypes.data, fids_out.ctypes.data,
        info.ctypes.data)
    if rc == -1:
        raise ValueError(f"file ids descend at position {int(info[2])}: "
                         "group_pairs takes each file's pairs as one "
                         "stretch, files in ascending order")
    if rc != 0:
        raise MemoryError("the pair grouping ran out of memory")
    return gids, fids_out, int(info[1])
