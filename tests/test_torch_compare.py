"""The port's comparator against the JAX package's, on the CPU.

Decode, bucket streaming, CSV writing, the presence-matmul score and
TorchComparator (both engines, all-vs-all and query mode, in RAM and
chunked with a resume manifest) must equal supersampler_tpu's exactly:
integers, strings and bytes. Inputs are the repo's goldens, or made
from a seed."""

import functools
import glob
import gzip
import io
import json
import os
import random
import struct
import zlib

import numpy as np
import pytest
import torch

import supersampler_tpu.compare.reader as JR
import supersampler_tpu.compare.stream as JST
import supersampler_tpu.compare.writers as JW
import supersampler_tpu.parallel.compare_dist as JCD
import supersampler_tpu_torch.compare.reader as TR
import supersampler_tpu_torch.compare.stream as TST
import supersampler_tpu_torch.compare.writers as TW
import supersampler_tpu_torch.parallel.compare_dist as TCD
from supersampler_tpu.compare.merge import TpuComparator
from supersampler_tpu.io.gzip_exact import write_gzip_exact
from supersampler_tpu.oracle.subsampler import OracleSubsampler
from supersampler_tpu_torch import native
from supersampler_tpu_torch.compare.merge import TorchComparator
from supersampler_tpu_torch.io.fasta import open_maybe_gzip
from supersampler_tpu_torch.io.gzip_exact import gzip_compress_exact
from supersampler_tpu_torch.parallel.mesh import make_mesh
from supersampler_tpu_torch.utils.profiling import timers

_GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
_FILES = [os.path.join(_GOLD, f"gfam_fam{i}.gz") for i in range(4)]
_SKETCHES = sorted(os.path.basename(p) for p in
                   glob.glob(os.path.join(_GOLD, "sketch_*.gz"))
                   + glob.glob(os.path.join(_GOLD, "gfam_fam*.gz")))
_ENGINES = ["numpy", "device"]


def _run(cls, files, query_size, engine="numpy", chunk_bytes=None,
         **kw):
    kw = dict(kw, engine=engine)
    if cls is TorchComparator and engine == "device":
        kw["device"] = "cpu"
    c = cls(**kw)
    c.files_names = list(files)
    if chunk_bytes is None:
        c.compare_sketches(query_size)
    else:
        assert c.compare_sketches_chunked(query_size,
                                          chunk_bytes=chunk_bytes)
    return c


def _same_result(a, b):
    assert a.nb_kmer_seen_infile == b.nb_kmer_seen_infile
    assert a.score_A == b.score_A
    assert (a.k, a.m, a.nb_files, a.query_size) == (b.k, b.m, b.nb_files,
                                                   b.query_size)
    assert a.containment_csv() == b.containment_csv()
    assert a.jaccard_csv() == b.jaccard_csv()


@pytest.mark.parametrize("name", _SKETCHES)
def test_decode_sketch_pairs_matches_jax(name):
    path = os.path.join(_GOLD, name)
    got = TR.decode_sketch_pairs(path)
    want = JR.decode_sketch_pairs(path)
    for a, b in zip(got[:3], want[:3], strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[3:] == want[3:] and got[0].size > 0


def _same_pairs(got, want):
    for a, b in zip(got[:3], want[:3], strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[3:] == want[3:]


def _blob(rng, codes, garbage):
    """str_compressor's layout of a code array; garbage sets the two
    bits below a partial byte's codes, which the decode must ignore."""
    n = codes.size
    if n == 0:
        return b""
    mod, nfull = n % 4, n // 4
    g = codes[: 4 * nfull].reshape(-1, 4).astype(np.uint8)
    out = bytes([mod]) + ((g[:, 0] << 6) | (g[:, 1] << 4) | (g[:, 2] << 2)
                          | g[:, 3]).tobytes()
    if mod:
        c = sum(int(v) << (2 * (mod - j))
                for j, v in enumerate(codes[4 * nfull:]))
        out += bytes([c | (int(rng.integers(0, 4)) if garbage else 0)])
    return out


_LINE_BYTES = np.frombuffer(b"ACGTACGTACGTacgtNnRY.*", np.uint8)


def _made_up_sketch(rng, k, m, n_buckets):
    """Wire bytes of a sketch (reference SubSampler.cpp:456-504) with
    every kind of bucket: blobs of 0 to several super-k-mers plus 0-3
    leftover codes, empty blobs, plaintext pairs shorter than, equal to
    and longer than k with non-ACGT bytes, and super-k-mers and lines
    that repeat within their bucket."""
    half = k - m
    out = [f"{2 * k - m} {m} 0 10.000000\n".encode()]
    mvals = np.sort(rng.choice(4 ** min(m, 12), n_buckets, replace=False))
    for mval in mvals.tolist():
        out.append(bytes(b"ACTG"[(mval >> (2 * (m - 1 - j))) & 3]
                         for j in range(m)))
        kind = int(rng.integers(0, 4))
        n_sk = 0 if kind == 0 else int(rng.integers(1, 5))
        codes = rng.integers(0, 4, n_sk * 2 * half + int(rng.integers(0, 4)))
        if kind == 3 and n_sk > 1:    # a super-k-mer again
            codes[2 * half: 4 * half] = codes[: 2 * half]
        blob = _blob(rng, codes, garbage=bool(rng.integers(0, 2)))
        out += [struct.pack("<I", len(blob)), blob]
        pairs = []
        for _ in range(int(rng.integers(0, 4))):
            total = k - m + int(rng.integers(-3, 4))
            left = int(rng.integers(0, max(total, 0) + 1))
            pairs.append(tuple(
                _LINE_BYTES[rng.integers(0, _LINE_BYTES.size, n)].tobytes()
                for n in (left, max(total - left, 0))))
        if pairs and kind == 3:
            pairs.append(pairs[0])
        for left, right in pairs:
            if left or right:
                out += [left, b"\n", right, b"\n"]
        out.append(b"\n\n")
    return b"".join(out)


@pytest.mark.parametrize("k,m", [(15, 5), (21, 7), (31, 11), (32, 11),
                                 (33, 13), (63, 15), (64, 16)])
@pytest.mark.parametrize("seed", range(3))
def test_decode_made_up_sketches_matches_jax(tmp_path, k, m, seed):
    """The native pass against the JAX reader on seeded made-up sketches,
    plain and gzipped, and the pass over byte windows of the buckets
    parse_bucket_at bounds (the whole payload and buckets 5-8) against
    JAX's decode of its parsed buckets."""
    rng = np.random.default_rng(1000 * k + seed)
    data = _made_up_sketch(rng, k, m, 40)
    path = tmp_path / f"s{k}.gz"
    path.write_bytes(gzip.compress(data))
    plain = tmp_path / f"s{k}.txt"
    plain.write_bytes(data)
    got = TR.decode_sketch_pairs(str(path))
    _same_pairs(got, JR.decode_sketch_pairs(str(path)))
    _same_pairs(TR.decode_sketch_pairs(str(plain)), got)
    assert got[0].size > 0 and got[1].any() == (k > 32)
    bounds, buckets, pos = [], [], data.index(b"\n") + 1
    while pos + m <= len(data):
        mval, end, payload = TR.parse_bucket_at(data, pos, m)
        bucket, jend = JR.parse_bucket_at(data, pos, m)
        assert (mval, end) == (bucket[0], jend)
        assert payload == len(bucket[1]) + sum(map(len, bucket[2]))
        bounds.append((pos, end))
        buckets.append(bucket)
        pos = end
    assert len(buckets) == 40
    assert set(b[0] for b in buckets) == got[5]
    whole = TR.decode_window(data, bounds[0][0], len(data), k, m)
    _same_pairs(whole[:3], got[:3])
    _same_pairs(whole[:3], JR.decode_bucket_pairs(buckets, k, m))
    # a chunk of the buckets, as the chunked comparator decodes them
    part = TR.decode_window(data, bounds[5][0], bounds[8][1], k, m)
    _same_pairs(part[:3], JR.decode_bucket_pairs(buckets[5:9], k, m))
    assert part[3].tolist() == [b[0] for b in buckets[5:9]]


def test_decode_repeats_and_header_only(tmp_path):
    """A bucket of one super-k-mer three times and one line pair twice
    keeps each k-mer once; a header-only sketch decodes to nothing."""
    k, m = 21, 7
    rng = np.random.default_rng(5)
    sk = rng.integers(0, 4, 2 * (k - m))
    blob = _blob(rng, np.concatenate([sk, sk, sk]), garbage=False)
    line = b"ACGTTGCAACGTTGCAAC"
    data = (f"{2 * k - m} {m} 0 10.000000\n".encode() + b"ACGTACG"
            + struct.pack("<I", len(blob)) + blob
            + b"".join([line, b"\n", line, b"\n"] * 2) + b"\n\n")
    path = tmp_path / "rep.txt"
    path.write_bytes(data)
    got = TR.decode_sketch_pairs(str(path))
    _same_pairs(got, JR.decode_sketch_pairs(str(path)))
    assert got[0].size == len(set(zip(got[1].tolist(), got[2].tolist())))
    assert got[0].size <= (k - m + 1) + (2 * len(line) + m - k + 1)
    path.write_bytes(f"{2 * k - m} {m} 0 10.000000\n".encode())
    got = TR.decode_sketch_pairs(str(path))
    _same_pairs(got, JR.decode_sketch_pairs(str(path)))
    assert got[0].size == 0 and got[5] == set()


@pytest.mark.parametrize("k,m", [(21, 7), (63, 15)])
def test_decode_large_low_complexity_bucket(tmp_path, k, m):
    """Thousands of k-mers in one bucket, most of them sharing their
    leading bases and many equal: the per-bucket sort's crowded bins."""
    rng = np.random.default_rng(k)
    n_sk = 400
    codes = np.where(rng.random(n_sk * 2 * (k - m)) < 0.9, 0,
                     rng.integers(0, 4, n_sk * 2 * (k - m)))
    blob = _blob(rng, codes, garbage=False)
    data = (f"{2 * k - m} {m} 0 10.000000\n".encode() + b"A" * m
            + struct.pack("<I", len(blob)) + blob + b"\n\n")
    path = tmp_path / "low.txt"
    path.write_bytes(data)
    got = TR.decode_sketch_pairs(str(path))
    _same_pairs(got, JR.decode_sketch_pairs(str(path)))
    assert 1000 < got[0].size < n_sk * (k - m + 1)


@pytest.mark.parametrize("name", ["sketch_big_k31_m11_s100_a1.gz",
                                  "sketch_repeat_k31_m11_s2_a2.gz",
                                  "sketch_big_k15_m5_s50_a1.gz"])
def test_decode_truncated_sketch_as_jax(tmp_path, name):
    """A golden's inflated bytes cut at every offset: where the JAX
    reader returns, the pass returns the same arrays (a cut inside a
    bucket's first m bytes ends the walk); where it raises, the pass
    raises ValueError naming the offset."""
    with gzip.open(os.path.join(_GOLD, name)) as f:
        data = f.read()
    path = str(tmp_path / "cut.txt")
    returned = raised = 0
    for cut in range(len(data) + 1):
        with open(path, "wb") as f:
            f.write(data[:cut])
        try:
            want = JR.decode_sketch_pairs(path)
        except (ValueError, IndexError, struct.error):
            with pytest.raises(ValueError):
                TR.decode_sketch_pairs(path)
            raised += 1
            continue
        _same_pairs(TR.decode_sketch_pairs(path), want)
        returned += 1
    assert returned > 10 and raised > 10
    with open(path, "wb") as f:
        f.write(data[:-1])
    with pytest.raises(ValueError, match=r"at byte \d+"):
        TR.decode_sketch_pairs(path)


# the native read and the batched pass


def _member(data, flags=0, extra=b"", name=b"", comment=b""):
    """One gzip member of data built by hand: flags 4 (an extra field),
    8 (a name), 16 (a comment) and 2 (a header CRC, which Python's gzip
    reads but does not check) as given, raw deflate data, the trailer."""
    head = bytes([0x1F, 0x8B, 8, flags, 0, 0, 0, 0, 0, 255])
    if flags & 4:
        head += struct.pack("<H", len(extra)) + extra
    if flags & 8:
        head += name + b"\0"
    if flags & 16:
        head += comment + b"\0"
    if flags & 2:
        head += b"\x12\x34"
    co = zlib.compressobj(6, zlib.DEFLATED, -zlib.MAX_WBITS)
    return (head + co.compress(data) + co.flush()
            + struct.pack("<II", zlib.crc32(data), len(data) & 0xFFFFFFFF))


def _sketch_bytes(seed, n_buckets=30, k=31, m=11):
    return _made_up_sketch(np.random.default_rng(seed), k, m, n_buckets)


_HEADER_ONLY = b"51 11 0 10.000000\n"
_READ_KINDS = ["goldens", "level1", "level9", "two_members",
               "zero_padding", "header_fields", "plain", "empty",
               "header_only"]


def _read_case(tmp_path, kind):
    """The files of one kind of input to the native read."""
    if kind == "goldens":
        return [os.path.join(_GOLD, n) for n in _SKETCHES]
    a, b = _sketch_bytes(1), _sketch_bytes(2)
    out = {"level1": [gzip_compress_exact(a, 1)],
           "level9": [gzip_compress_exact(a, 9), gzip_compress_exact(b"", 9)],
           "two_members": [gzip.compress(a[:700]) + gzip.compress(a[700:]),
                           _member(a[:5]) + _member(a[5:], 8, name=b"x.txt")],
           "zero_padding": [gzip.compress(a) + bytes(100),
                            gzip.compress(a[:9]) + bytes(7)
                            + gzip.compress(a[9:]) + bytes(1)],
           "header_fields": [_member(a, 2 | 4 | 8 | 16, b"xyz", b"name",
                                     b"a comment"), _member(b, 4)],
           "plain": [a, b],
           "empty": [b"", gzip.compress(b"")],
           "header_only": [_HEADER_ONLY, gzip.compress(_HEADER_ONLY)]}[kind]
    paths = []
    for i, data in enumerate(out):
        paths.append(str(tmp_path / f"{kind}{i}"))
        with open(paths[-1], "wb") as f:
            f.write(data)
    return paths


@pytest.mark.parametrize("threads", [1, 8])
@pytest.mark.parametrize("kind", _READ_KINDS)
def test_native_read_equals_python_gzip(tmp_path, kind, threads):
    """The native read's bytes are those Python's gzip (or, for a file
    without the gzip magic, open) reads, and the end of its header line
    is parse_header's, each file of a kind read in one call, and every
    kind's files in one call too."""
    paths = _read_case(tmp_path, kind)
    if kind == "goldens":
        paths += [q for other in _READ_KINDS[1:]
                  for q in _read_case(tmp_path, other)]
    got = native.read_files_native(paths, threads)
    assert 1 <= got.threads <= min(threads, len(paths))
    assert got.pool.dtype == np.uint8 and got.offs[-1] == got.pool.size
    for i, path in enumerate(paths):
        with open_maybe_gzip(path) as f:
            want = f.read()
        assert got.status[i] == 0
        assert got.pool[got.offs[i]:got.offs[i + 1]].tobytes() == want
        assert got.pos0[i] == (TR.parse_header(want)[2]
                               if b"\n" in want else 0)


def _python_read(path):
    """The read the comparator made before the native one: open, gzip
    where the magic says so, parse_header."""
    with open_maybe_gzip(path) as f:
        data = f.read()
    return data, TR.parse_header(data)


def _bad_file(tmp_path, kind):
    """A file of one kind that Python's open, gzip or parse_header
    refuses (but odd_header, which parse_header reads); missing is
    never written."""
    good = gzip.compress(_sketch_bytes(3))
    data = {"cut_trailer": good[:-3], "cut_deflate": good[: len(good) // 2],
            "cut_header": good[:7],
            "cut_name": _member(b"ACGT", 8, name=b"a name")[:14],
            "corrupt_deflate": good[:10] + b"\x07" + good[11:],
            "bad_crc": good[:-8] + bytes(4) + good[-4:],
            "bad_length": good[:-4] + bytes(4),
            "bad_method": good[:2] + b"\x07" + good[3:],
            "garbage_after": good + b"xy", "one_byte_after": good + b"\x1f",
            "no_header_line": gzip.compress(b"ACGT"), "empty": b"",
            "bad_header": b"51\n", "odd_header": b"51 +11\r\n"}.get(kind)
    path = str(tmp_path / kind)
    if kind == "directory":
        os.mkdir(path)
    elif data is not None:
        with open(path, "wb") as f:
            f.write(data)
    return path


_BAD_KINDS = ["missing", "directory", "cut_trailer", "cut_deflate",
              "cut_header", "cut_name", "corrupt_deflate", "bad_crc",
              "bad_length", "bad_method", "garbage_after", "one_byte_after",
              "no_header_line", "empty", "bad_header", "odd_header"]


@pytest.mark.parametrize("kind", _BAD_KINDS)
def test_native_read_fails_as_python(tmp_path, kind):
    """A file that cannot be read, or has no header, raises what
    Python's open, gzip and parse_header raise for it, alone and among
    good files; an odd header that parse_header reads (odd_header) gives
    the window Python reads."""
    path = _bad_file(tmp_path, kind)
    good = os.path.join(_GOLD, _SKETCHES[0])
    try:
        want = _python_read(path)
    except Exception as e:     # the class the native read must raise
        want = e
    for paths in ([path], [good, path, good]):
        if not isinstance(want, Exception):
            window = TR.read_sketches(paths)[paths.index(path)]
            assert window[0].tobytes() == want[0]
            assert window[1:] == (want[1][2], len(want[0])) + want[1][:2]
            continue
        with pytest.raises(type(want)) as got:
            TR.read_sketches(paths)
        assert type(got.value) is type(want)
        if isinstance(want, OSError) and not isinstance(
                want, gzip.BadGzipFile):
            assert got.value.filename == path
        with pytest.raises(type(want)):
            TCD.decode_files(paths)
    assert isinstance(want, Exception) == (kind != "odd_header")


@pytest.mark.parametrize("order", [(0, 1, 2), (1, 0, 2), (2, 1, 0)])
def test_native_read_names_the_first_failing_file(tmp_path, order):
    """Of several files that fail, the first in file order is raised."""
    bad = [_bad_file(tmp_path, k)
           for k in ("missing", "cut_trailer", "corrupt_deflate")]
    kinds = (FileNotFoundError, EOFError, zlib.error)
    paths = [os.path.join(_GOLD, _SKETCHES[0])] + [bad[i] for i in order]
    with pytest.raises(kinds[order[0]], match=os.path.basename(
            bad[order[0]])):
        TR.read_sketches(paths)


@pytest.fixture(params=[1, 8])
def pinned(request, monkeypatch):
    """The native read and pass pinned to 1 or 8 threads."""
    for name in ("read_files_native", "decode_windows_native"):
        monkeypatch.setattr(TR, name, functools.partial(
            getattr(native, name), threads=request.param))
    return request.param


def _decode_case(tmp_path, case):
    """The sketch files of one decode_files case."""
    if case == "goldens":
        return [os.path.join(_GOLD, n) for n in _SKETCHES]
    if case == "made_up":
        datas = [_sketch_bytes(100 + i, n_buckets=5 + i % 30)
                 for i in range(100)]
    else:
        # sketches with nothing to decode among sketches with pairs: a
        # header alone, a bucket of no k-mer, plain and gzipped
        nothing = _HEADER_ONLY + b"ACGTACGTACG" + struct.pack("<I", 0) \
            + b"\n\n"
        datas = [_HEADER_ONLY, _sketch_bytes(7), nothing,
                 gzip.compress(_HEADER_ONLY), gzip.compress(nothing),
                 gzip.compress(_sketch_bytes(8)), _HEADER_ONLY]
    paths = []
    for i, data in enumerate(datas):
        paths.append(str(tmp_path / f"{case}{i}"))
        with open(paths[-1], "wb") as f:
            f.write(gzip.compress(data) if case == "made_up" and i % 2
                    else data)
    return paths


@pytest.mark.parametrize("query", [False, True])
@pytest.mark.parametrize("case", ["goldens", "made_up", "nothing"])
def test_decode_files_is_the_per_file_decode(tmp_path, pinned, case, query):
    """decode_files, one native read and one pass on 1 or 8 threads,
    gives exactly the concatenation of each file's decode_sketch_pairs
    in the JAX package, and in the port: arrays, file ids, per-file
    counts, k, m and the query minimizers (dtypes the port's); each
    stage ran on the threads pinned, or one a file."""
    paths = _decode_case(tmp_path, case)
    n = len(paths)
    qs = n // 3 if query else None
    timers.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        got = TCD.decode_files(paths, qs)
    threads = {c.name: c.n for c in timers.counters()
               if c.name.endswith(".threads")}
    timers.reset()
    assert threads == {"decode.read.threads": min(pinned, n),
                       "decode.pass.threads": min(pinned, n)}
    jax = [JR.decode_sketch_pairs(p) for p in paths]
    port = [TR.decode_sketch_pairs(p) for p in paths]
    for per in (jax, port):
        for a in range(3):
            want = np.concatenate([p[a] for p in per]).astype(np.uint64)
            assert got[a].dtype == np.uint64 and np.array_equal(got[a], want)
        fids = np.concatenate([np.full(p[0].size, f, np.int64)
                               for f, p in enumerate(per)])
        assert got[3].dtype == np.int64 and np.array_equal(got[3], fids)
        assert got[4] == [p[0].size for p in per]
        assert got[5:7] == per[-1][3:5] == (31, 11)
        assert got[7] == (set().union(*(p[5] for p in per[:qs]))
                          if query else None)
    assert (0 in got[4]) == (case == "nothing") and sum(got[4]) > 0


@pytest.mark.parametrize("name", ["sketch_big_k31_m11_s100_a1.gz",
                                  "sketch_big_k15_m5_s50_a1.gz"])
def test_truncated_window_among_good_ones(tmp_path, pinned, name):
    """A golden cut inside a bucket, among whole sketches, makes the
    batched pass raise the ValueError of its own decode, naming its
    byte; of two cut windows, the first in file order."""
    with gzip.open(os.path.join(_GOLD, name)) as f:
        data = f.read()
    good = os.path.join(_GOLD, name)
    cuts = []
    for i, cut in enumerate((len(data) - 1, len(data) * 2 // 3,
                             len(data) // 3)):
        cuts.append(str(tmp_path / f"cut{i}"))
        with open(cuts[-1], "wb") as f:
            f.write(data[:cut])
    for i, path in enumerate(cuts):
        with pytest.raises(ValueError, match=r"at byte \d+") as alone:
            TR.decode_sketch_pairs(path)
        with pytest.raises(ValueError) as batched:
            TCD.decode_files([good, path, good] + cuts[:i])
        assert str(batched.value) == str(alone.value)


def _same_chunks(got, want):
    """chunk_rounds' chunks against the JAX package's: the same chunks
    and offsets, and each file's window decodes to the pairs and the
    bucket minimizers of JAX's buckets for that file."""
    k, m = TST.BucketStream(_FILES[0]).k, TST.BucketStream(_FILES[0]).m
    assert len(got) == len(want)
    for (idx, windows, offsets), (jidx, jchunk, joffsets) in zip(got, want):
        assert (idx, offsets) == (jidx, joffsets)
        assert len(windows) == len(jchunk)
        for window, buckets in zip(windows, jchunk):
            assert (window is None) == (not buckets)
            if window is not None:
                pairs = TR.decode_window(*window, k, m)
                _same_pairs(pairs[:3], JR.decode_bucket_pairs(buckets, k, m))
                assert pairs[3].tolist() == [b[0] for b in buckets]


@pytest.mark.parametrize("chunk_bytes", [1 << 10, 1 << 14, 1 << 30])
def test_chunk_rounds_matches_jax(chunk_bytes):
    got = list(TST.chunk_rounds([TST.BucketStream(p) for p in _FILES],
                                chunk_bytes))
    want = list(JST.chunk_rounds([JST.BucketStream(p) for p in _FILES],
                                 chunk_bytes))
    assert got
    _same_chunks(got, want)
    if chunk_bytes == 1 << 10:
        assert len(got) > 4


def test_chunk_windows_survive_compaction(monkeypatch):
    """With the stream's window compacted after nearly every bucket,
    the buckets buffered but not yet taken keep their bytes: every
    window still decodes to JAX's chunk."""
    monkeypatch.setattr(TST, "_COMPACT_AT", 64)
    streams = [TST.BucketStream(p) for p in _FILES]
    got, kept = [], 0
    for item in TST.chunk_rounds(streams, 1 << 10):
        got.append(item)
        # a compaction happened and buckets wait for a later chunk
        kept += sum(st._base > 0 and st.has_buffered() for st in streams)
    want = list(JST.chunk_rounds([JST.BucketStream(p) for p in _FILES],
                                 1 << 10))
    assert len(got) > 1 and kept > 0
    _same_chunks(got, want)


@pytest.mark.parametrize("chunk_bytes", [1 << 10, 1 << 30])
def test_chunk_windows_in_one_pass_match_jax(pinned, chunk_bytes):
    """Each chunk's windows, decoded together in one pass on 1 or 8
    threads, give JAX's pairs of that chunk's buckets, file by file,
    with the file ids and counts."""
    k, m = TST.BucketStream(_FILES[0]).k, TST.BucketStream(_FILES[0]).m
    got = list(TST.chunk_rounds([TST.BucketStream(p) for p in _FILES],
                                chunk_bytes))
    want = list(JST.chunk_rounds([JST.BucketStream(p) for p in _FILES],
                                 chunk_bytes))
    assert len(got) == len(want)
    for (_i, windows, _o), (_j, jchunk, _p) in zip(got, want):
        out = TCD.decode_windows(
            [None if w is None else w + (k, m) for w in windows],
            len(windows), None)
        per = [JR.decode_bucket_pairs(b, k, m) if b else
               (np.zeros(0, np.uint64),) * 3 for b in jchunk]
        for a in range(3):
            assert np.array_equal(out[a], np.concatenate(
                [p[a] for p in per]).astype(np.uint64))
        assert out[4] == [p[0].size for p in per]
        assert np.array_equal(out[3], np.repeat(np.arange(len(per)),
                                                out[4]))


@pytest.mark.parametrize("jaccard", [False, True])
@pytest.mark.parametrize("query_size,precision,threshold",
                         [(7, 6, 0.0), (3, 3, 0.05), (1, 2, 0.5)])
def test_matrix_csv_matches_jax(tmp_path, jaccard, query_size, precision,
                                threshold):
    rng = np.random.default_rng(query_size)
    n = 7
    names = [f"f{i}.gz" for i in range(n)]
    seen = rng.integers(50, 5000, n).tolist()
    score = {i * n + j: int(rng.integers(1, min(seen[i], seen[j])))
             for i in range(n) for j in range(i + 1, n)
             if rng.random() < 0.7}
    args = (names, score, seen, query_size, precision, threshold, jaccard)
    text = TW.matrix_csv(*args)
    assert text == JW.matrix_csv(*args)
    TW.write_matrix_gz(str(tmp_path / "t.csv.gz"), text)
    JW.write_matrix_gz(str(tmp_path / "j.csv.gz"), text)
    assert ((tmp_path / "t.csv.gz").read_bytes()
            == (tmp_path / "j.csv.gz").read_bytes())


@pytest.mark.parametrize("query_size", [None, 2])
@pytest.mark.parametrize("chunk_groups", [512, 1 << 18])
def test_score_matrix_matches_jax(query_size, chunk_groups):
    got = TCD.build_presence_chunks(_FILES, query_size)
    want = JCD.build_presence_chunks(_FILES, query_size)
    for a, b in zip(got[:2], want[:2], strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[2:] == want[2:]
    gids, fids, n_groups, nb_seen, _k, _m = got
    score = TCD.score_matrix_device(gids, fids, n_groups, len(_FILES),
                                    make_mesh(["cpu"]),
                                    chunk_groups=chunk_groups)
    ref = JCD.score_matrix_device(gids, fids, n_groups, len(_FILES),
                                  mesh=None, chunk_groups=chunk_groups)
    assert score.dtype == np.int64 and np.array_equal(score, ref)
    if query_size is None:
        assert [int(score[i, i]) for i in range(4)] == nb_seen
    qs = query_size or 4
    assert (TCD.scores_to_dict(score, qs) == JCD.scores_to_dict(ref, qs)
            == _run(TpuComparator, _FILES, qs).score_A)


@pytest.mark.parametrize("n_files", [1, 9, 30])
def test_score_matrix_seeded_matches_jax(n_files):
    """Random presence coordinates at file counts around the padding
    of the file axis (24, then multiples of 8); 9,000 groups take three
    steps of 4,096 (the least step size) at chunk_groups=512."""
    rng = np.random.default_rng(n_files)
    pres = rng.random((9000, n_files)) < rng.random(n_files)
    pres[:, 0] |= ~pres.any(1)
    gids, fids = (x.astype(np.int32) for x in np.nonzero(pres))
    score = TCD.score_matrix_device(gids, fids, 9000, n_files,
                                    make_mesh(["cpu"]), chunk_groups=512)
    ref = JCD.score_matrix_device(gids, fids, 9000, n_files, mesh=None,
                                  chunk_groups=512)
    assert np.array_equal(score, ref)
    assert np.array_equal(score, pres.T.astype(np.int64)
                          @ pres.astype(np.int64))


@pytest.mark.parametrize("engine", _ENGINES)
@pytest.mark.parametrize("query", [False, True])
def test_comparator_matches_jax(engine, query):
    kw = dict(precision=3, min_threshold=0.05) if query else {}
    qs = 2 if query else len(_FILES)
    _same_result(_run(TorchComparator, _FILES, qs, engine, **kw),
                 _run(TpuComparator, _FILES, qs, **kw))


_K_CONFIGS = [(21, 7, "5"), (15, 5, "2"), (63, 15, "3")]


@pytest.fixture(scope="module")
def other_k_sketches(datadir, tmp_path_factory):
    """Three family genomes sketched at each non-default (k, m) by the
    JAX package's scalar spec."""
    d = tmp_path_factory.mktemp("other_k")
    out = {}
    for k, m, s in _K_CONFIGS:
        out[k] = []
        for i in range(3):
            ss = OracleSubsampler(k=k, m=m, s=float(np.float32(s)))
            out[k].append(str(d / f"k{k}_{i}.gz"))
            write_gzip_exact(out[k][-1],
                             ss.sketch_file(datadir[f"fam{i}"]), 9)
    return out


@pytest.mark.parametrize("engine", _ENGINES)
@pytest.mark.parametrize("k", [c[0] for c in _K_CONFIGS])
def test_compare_other_k_configs(other_k_sketches, engine, k):
    files = other_k_sketches[k]
    for qs in (3, 1):
        _same_result(_run(TorchComparator, files, qs, engine),
                     _run(TpuComparator, files, qs))


def test_comparator_rejects_unknown_engine():
    with pytest.raises(ValueError):
        TorchComparator(engine="auto")


@pytest.mark.parametrize("torch_device", ["cpu", None])
def test_comparator_defaults_to_device_engine(monkeypatch, torch_device):
    """TorchComparator() takes the device engine on default_device():
    the CPU only when $TORCH_DEVICE asks for it; without it, CUDA, which
    raises where there is no card rather than dropping to the CPU or to
    the numpy engine."""
    if torch_device is None:
        monkeypatch.delenv("TORCH_DEVICE", raising=False)
        if torch.cuda.is_available():
            assert TorchComparator().mesh.devices[0].type == "cuda"
        else:
            with pytest.raises(RuntimeError):
                TorchComparator()
        return
    monkeypatch.setenv("TORCH_DEVICE", torch_device)
    c = TorchComparator()
    assert c.engine == "device"
    assert c.mesh.devices == (torch.device(torch_device),)
    c.files_names = list(_FILES)
    c.compare_sketches(len(_FILES))
    _same_result(c, _run(TpuComparator, _FILES, len(_FILES)))


def test_group_pairs_is_the_comparators_grouping():
    """build_presence_chunks and TorchComparator share one grouping:
    the numpy engine's scores from build_presence_chunks' coordinates
    equal the comparator's."""
    from supersampler_tpu_torch.compare.merge import pair_scores_numpy
    gids, fids, n_groups, nb_seen, _k, _m = TCD.build_presence_chunks(
        _FILES)
    c = _run(TorchComparator, _FILES, len(_FILES), "numpy")
    assert pair_scores_numpy(gids.astype(np.int64), fids.astype(np.int64),
                             len(_FILES)) == c.score_A
    assert nb_seen == c.nb_kmer_seen_infile


def _lexsort_grouping(mins, his, los, fids, query_minimizers=None):
    """The grouping that group_pairs' native pass replaced, kept as its
    oracle: the query filter, a lexsort by (minimizer, hi, lo, file),
    group ids from the key boundaries, both as int32."""
    if query_minimizers is not None:
        keep = np.isin(mins, np.array(sorted(query_minimizers), np.uint64))
        mins, his, los, fids = mins[keep], his[keep], los[keep], fids[keep]
    order = np.lexsort((fids, los, his, mins))
    mins, his, los, fids = mins[order], his[order], los[order], fids[order]
    new_group = np.ones(mins.size, dtype=bool)
    if mins.size:
        new_group[1:] = ((mins[1:] != mins[:-1]) | (his[1:] != his[:-1])
                         | (los[1:] != los[:-1]))
    gids = np.cumsum(new_group) - 1
    return gids.astype(np.int32), fids.astype(np.int32)


def _shared_pairs(seed, n_files, n_min=300, wide=False, reverse=()):
    """Decoded pairs of n_files made-up sketches in the decode's order
    (buckets by minimizer, distinct keys ascending), files of four
    species drawing most keys from their species' pool of small numbers,
    a few large ones of their own. Wide keys have a non-zero hi (k > 32),
    with equal lo under unequal hi. The files in ``reverse`` list their
    buckets in descending minimizer order."""
    rng = np.random.default_rng(seed)
    minv = np.sort(rng.choice(1 << 22, n_min, replace=False)).astype(
        np.uint64)
    pool_lo = rng.integers(0, 64, (n_min, 4, 3)).astype(np.uint64)
    pool_hi = (rng.integers(0, 3, (n_min, 4, 3)) if wide
               else np.zeros((n_min, 4, 3), np.int64)).astype(np.uint64)
    cols = []
    for f in range(n_files):
        mi, ki = np.nonzero(rng.random((n_min, 3)) < 0.7)
        own = rng.integers(0, n_min, 8)
        mi = np.concatenate([mi, own])
        lo = np.concatenate([pool_lo[mi[:-8], f % 4, ki],
                             rng.integers(0, 1 << 40, 8).astype(np.uint64)])
        hi = np.concatenate([pool_hi[mi[:-8], f % 4, ki],
                             pool_hi[own, 0, 0]])
        m, h, l = np.unique(np.stack([minv[mi], hi, lo], 1), axis=0).T
        if f in reverse:
            # buckets in descending order, each bucket's keys ascending
            order = np.lexsort((l, h, -np.searchsorted(minv, m)))
            m, h, l = m[order], h[order], l[order]
        cols.append((m, h, l, np.full(m.size, f, np.int64)))
    return tuple(np.concatenate([c[i] for c in cols]) for i in range(4))


def _chunk_pairs():
    """The pairs of one chunk of compare_sketches_chunked, built as it
    builds them: its windows through decode_windows."""
    rounds = list(TST.chunk_rounds([TST.BucketStream(p) for p in _FILES],
                                   1 << 10))
    assert len(rounds) > 4
    _idx, chunk, _offsets = rounds[len(rounds) // 2]
    k, m = TST.BucketStream(_FILES[0]).k, TST.BucketStream(_FILES[0]).m
    return TCD.decode_windows(
        (None if w is None else w + (k, m) for w in chunk), len(chunk),
        None)[:4]


def _grouping_case(case):
    """(mins, his, los, fids, query minimizers) of one case."""
    empty = np.zeros(0, np.uint64)
    if case == "goldens":
        return TCD.decode_files([os.path.join(_GOLD, n)
                                 for n in _SKETCHES])[:4] + (None,)
    if case == "query":
        out = TCD.decode_files(_FILES, 2)
        return out[:4] + (out[7],)
    if case == "chunk":
        return _chunk_pairs() + (None,)
    if case == "empty":
        return (empty, empty, empty, np.zeros(0, np.int64), None)
    kw = {"shared": dict(n_files=60), "one_file": dict(n_files=1),
          "descending": dict(n_files=12, reverse=(0, 5, 11)),
          "wide_k": dict(n_files=20, wide=True)}[case]
    return _shared_pairs(len(case), **kw) + (None,)


@pytest.mark.parametrize("case", ["goldens", "shared", "empty", "one_file",
                                  "descending", "wide_k", "query", "chunk"])
def test_group_pairs_equals_the_lexsort(case):
    """group_pairs' native pass against the lexsort it replaced, element
    for element, values and dtypes; and one run a file, more where a
    file's buckets descend."""
    from supersampler_tpu_torch.native import group_pairs_native

    mins, his, los, fids, qmins = _grouping_case(case)
    want = _lexsort_grouping(mins, his, los, fids, qmins)
    got = TCD.group_pairs(mins, his, los, fids, qmins)
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
    if qmins is not None:
        keep = np.isin(mins, np.array(sorted(qmins), np.uint64))
        assert 0 < keep.sum() < keep.size
        mins, his, los, fids = mins[keep], his[keep], los[keep], fids[keep]
    runs = group_pairs_native(mins, his, los, fids)[2]
    files = np.unique(fids).size
    assert runs > files if case == "descending" else runs == files
    if case == "wide_k":
        assert his.any()
    if case not in ("empty", "one_file"):
        # groups shared by files, and files with more than one pair
        assert files > 1 and np.bincount(got[0]).max() > 1


@pytest.mark.parametrize("fids,at", [([0, 1, 0, 1], 2), ([3, 3, 1, 1], 2),
                                     ([0, 2, 2, 1], 3)])
def test_group_pairs_rejects_file_ids_out_of_order(fids, at):
    mins = np.array([5, 9, 2, 7], np.uint64)
    zero = np.zeros(4, np.uint64)
    with pytest.raises(ValueError, match=f"file ids descend at position {at}"):
        TCD.group_pairs(mins, zero, zero, np.array(fids))


# chunked / streaming comparison (mirrors tests/test_chunked_compare.py)


@pytest.mark.parametrize("engine", _ENGINES)
@pytest.mark.parametrize("chunk_bytes", [1 << 10, 1 << 14, 1 << 30])
def test_chunked_equals_full(engine, chunk_bytes):
    ref = _run(TorchComparator, _FILES, len(_FILES), engine)
    c = _run(TorchComparator, _FILES, len(_FILES), engine, chunk_bytes)
    _same_result(c, ref)
    j = _run(TpuComparator, _FILES, len(_FILES), "numpy", chunk_bytes)
    _same_result(c, j)
    assert c.max_chunk_pairs == j.max_chunk_pairs
    if chunk_bytes == 1 << 10:
        # bounded memory really engaged: many small chunks
        assert c.max_chunk_pairs < sum(ref.nb_kmer_seen_infile)


@pytest.mark.parametrize("engine", _ENGINES)
def test_chunked_query_mode(engine):
    kw = dict(precision=3, min_threshold=0.05)
    c = _run(TorchComparator, _FILES, 2, engine, 1 << 12, **kw)
    _same_result(c, _run(TorchComparator, _FILES, 2, engine, **kw))
    _same_result(c, _run(TpuComparator, _FILES, 2, **kw))


def test_resume_after_kill(tmp_path):
    """Stop after 2 chunks (simulated kill): the manifest equals the
    JAX package's; resume from it to byte-identical CSVs."""
    manifest = str(tmp_path / "resume.json")
    jmanifest = str(tmp_path / "jresume.json")
    c1 = TorchComparator(engine="numpy")
    c1.files_names = list(_FILES)
    assert not c1.compare_sketches_chunked(
        len(_FILES), chunk_bytes=1 << 10, resume_path=manifest,
        max_chunks=2)
    j1 = TpuComparator()
    j1.files_names = list(_FILES)
    j1.compare_sketches_chunked(len(_FILES), chunk_bytes=1 << 10,
                                resume_path=jmanifest, max_chunks=2)
    with open(manifest) as f, open(jmanifest) as g:
        man = json.load(f)
        assert man == json.load(g)
    assert man["chunk_idx"] == 2

    c2 = TorchComparator(engine="device", device="cpu")
    c2.files_names = list(_FILES)
    assert c2.compare_sketches_chunked(len(_FILES), chunk_bytes=1 << 10,
                                       resume_path=manifest)
    assert not os.path.exists(manifest)     # completed => removed
    _same_result(c2, _run(TpuComparator, _FILES, len(_FILES)))


def test_resume_manifest_guards_file_list(tmp_path):
    manifest = str(tmp_path / "resume.json")
    c1 = TorchComparator(engine="numpy")
    c1.files_names = list(_FILES)
    c1.compare_sketches_chunked(len(_FILES), chunk_bytes=1 << 10,
                                resume_path=manifest, max_chunks=1)
    c2 = TorchComparator(engine="numpy")
    c2.files_names = list(reversed(_FILES))
    with pytest.raises(ValueError):
        c2.compare_sketches_chunked(len(_FILES), chunk_bytes=1 << 10,
                                    resume_path=manifest)


def test_large_collection_bounded(tmp_path):
    """200 small sketches compare under a small chunk budget with
    results equal to the JAX package's in-RAM engine."""
    rng = random.Random(4242)
    base = "".join(rng.choice("ACGT") for _ in range(3000))
    paths = []
    for i in range(200):
        seq = "".join(c if rng.random() > 0.05 else rng.choice("ACGT")
                      for c in base)
        ss = OracleSubsampler(k=31, m=11, s=3.0)
        ss.log = io.StringIO()
        ss.scan_sequence(seq)
        paths.append(str(tmp_path / f"s{i}.gz"))
        write_gzip_exact(paths[-1], ss.serialize(), 9)

    ref = _run(TpuComparator, paths, len(paths))
    c = _run(TorchComparator, paths, len(paths), "numpy", 1 << 14)
    assert c.score_A == ref.score_A
    assert c.nb_kmer_seen_infile == ref.nb_kmer_seen_infile
    # memory proxy: the largest chunk held a small fraction of the
    # collection's total pair volume
    assert c.max_chunk_pairs < sum(ref.nb_kmer_seen_infile) // 4
