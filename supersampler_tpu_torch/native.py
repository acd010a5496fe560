"""Loader for the native host library (csrc/spsp_*.c).

The port's copy of what it uses from supersampler_tpu/native.py: the
long-double FHS threshold, the one-pass clean + 2-bit pack of a record
or of a chunk's records, and the C finisher (k-mer store,
reconstruction, serialization); and the port's own sketch decode and
pair grouping for the comparator. The threshold and the finisher come
from the repo's shared ``csrc/spsp_native.c`` and ``csrc/spsp_finish.c``;
the clean + pack from the port's own
``supersampler_tpu_torch/csrc/spsp_io.c``, whose fast path strips every
non-ACGT byte as the reference does (the shared copy keeps a few, see
that file); the decode and the grouping from
``supersampler_tpu_torch/csrc/spsp_decode.c``. They compile with the
system C compiler into the port's own ``build/libspsp_torch_native.so``
at first use, and again when a source is newer than the library. A
failed build raises: there are no Python fallbacks.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_PKG)
_SOURCES = [os.path.join(_ROOT, "csrc", "spsp_native.c"),
            os.path.join(_ROOT, "csrc", "spsp_finish.c"),
            os.path.join(_PKG, "csrc", "spsp_io.c"),
            os.path.join(_PKG, "csrc", "spsp_decode.c")]
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
               "-o", tmp, *_SOURCES, "-lm"]
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
        lib.spsp_decode_pairs.restype = _I64
        lib.spsp_decode_pairs.argtypes = [_P, _I64, _I64, _I, _I] + [_P] * 5
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


def decode_pairs_native(data: bytes, pos0: int, end: int, k: int, m: int):
    """Every bucket of the sketch bytes ``data[pos0:end]`` decoded to its
    distinct canonical k-mers in one C pass
    (supersampler_tpu_torch/csrc/spsp_decode.c spsp_decode_pairs).

    Returns (mins u64[], hi u64[], lo u64[], bucket minimizers u64[],
    windows): buckets in file order, then (hi, lo) ascending; windows
    counts the k-mers before the per-bucket dedup. Raises ValueError
    for a bucket cut short or malformed, and for k or m the pass cannot
    hold (k above 64 or m above 32), and for a range outside data."""
    if not (1 <= m <= 32 and 1 <= k <= 64):
        raise ValueError(f"sketch header gives k={k}, m={m}: the decode "
                         "takes 1 <= k <= 64 and 1 <= m <= 32")
    if not 0 <= pos0 <= end <= len(data):
        raise ValueError(f"byte range [{pos0}, {end}) is outside the "
                         f"{len(data)} bytes given")
    lib = get_lib()
    info = np.zeros(4, np.int64)
    buf = ctypes.c_char_p(data)
    args = (buf, pos0, end, k, m)
    rc = lib.spsp_decode_pairs(*args, None, None, None, None,
                               info.ctypes.data)
    if rc == 0:
        windows, nb = int(info[0]), int(info[2])
        mins, hi, lo = (np.empty(windows, np.uint64) for _ in range(3))
        bmins = np.empty(nb, np.uint64)
        rc = lib.spsp_decode_pairs(
            *args, mins.ctypes.data, hi.ctypes.data, lo.ctypes.data,
            bmins.ctypes.data, info.ctypes.data)
    if rc == -1:
        raise ValueError("sketch bucket cut short or malformed at byte "
                         f"{int(info[3])} of the inflated sketch")
    if rc != 0:
        raise MemoryError("the sketch decode ran out of memory")
    n = int(info[1])
    return mins[:n], hi[:n], lo[:n], bmins, windows


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
