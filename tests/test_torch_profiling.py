"""The port's phase timers and device trace (supersampler_tpu_torch.
utils.profiling) on the CPU: a sketch fills every phase of the shared
run (mirrors tests/test_aux.py:104-124), ``device_trace`` does nothing
without SPSP_TRACE and writes a Chrome trace with it, and the timers
lose no update under many threads. Under a torch.profiler session the
phases are spans and the counters count: the comparator's span tree and
counters on the family goldens, its ``record_function`` ranges, outputs
equal with and without the profiler, the sketch's threads."""

import collections
import gzip
import json
import os
import struct
import sys
import threading

import numpy as np
import pytest
import torch

from supersampler_tpu_torch.compare.merge import TorchComparator
from supersampler_tpu_torch.compare.stream import BucketStream, chunk_rounds
from supersampler_tpu_torch.sketch import TorchSubsampler
from supersampler_tpu_torch.utils.profiling import (PhaseTimers,
                                                    device_trace, timers)

_PHASES = ("parse", "prep", "dispatch", "device+fetch", "assemble",
           "serialize")


def _fasta(tmp_path):
    rng = np.random.default_rng(2)
    fa = tmp_path / "p.fa"
    fa.write_text(">r\n" + "".join(
        "ACGT"[c] for c in rng.integers(0, 4, 4000)) + "\n>q\n" + "".join(
        "ACGT"[c] for c in rng.integers(0, 4, 70000)) + "\n")
    return str(fa)


def test_phase_timers_fill_during_sketch_file(tmp_path, monkeypatch):
    monkeypatch.delenv("SPSP_TRACE", raising=False)
    path = _fasta(tmp_path)
    timers.reset()
    TorchSubsampler(k=31, m=11, s=10.0, device="cpu").sketch_file(path)
    for name in _PHASES:
        assert name in timers.totals, name
        assert timers.counts[name] >= 1, name
    assert "parse" in timers.report()
    assert list(tmp_path.iterdir()) == [tmp_path / "p.fa"]


def test_device_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    out = tmp_path / "trace"
    monkeypatch.setenv("SPSP_TRACE", str(out))
    TorchSubsampler(k=31, m=11, s=10.0, device="cpu").sketch_file(
        _fasta(tmp_path))
    with open(out / "sketch_fof.json") as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    monkeypatch.delenv("SPSP_TRACE")
    with device_trace("idle"):
        pass
    assert sorted(p.name for p in out.iterdir()) == ["sketch_fof.json"]


def test_phase_timers_lose_no_update_under_threads():
    t = PhaseTimers()
    n_threads, n_each = 32, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for _ in range(n_each):
                with t.phase(f"p{i % 3}"):
                    pass

        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert sum(t.counts.values()) == n_threads * n_each
    assert t.counts == {f"p{j}": n_each * sum(1 for i in range(n_threads)
                                              if i % 3 == j)
                        for j in range(3)}
    t.reset()
    assert t.totals == {} and t.report() == ""


# ---- spans and counters under a profiler session ----

_GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
_FAMILY = [f"gfam_fam{i}.gz" for i in range(4)]
_THREADS = ("decode.read.threads", "decode.pass.threads")
# every span of a comparison but the root, and the span it must sit in
_PARENT = {"compare.open": "compare.call", "compare.decode": "compare.call",
           "decode.read": "compare.decode", "decode.pass": "compare.decode",
           "compare.group": "compare.call",
           "group.sort": "compare.group", "compare.score": "compare.call",
           "score.h2d": "compare.score", "score.product": "compare.score",
           "score.fetch": "compare.score", "compare.tally": "compare.call"}


def _session():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture
def family(tmp_path, monkeypatch):
    """The family goldens symlinked under their own names into a fresh
    CWD (the CSV header holds the names as given)."""
    for f in _FAMILY:
        os.symlink(os.path.join(_GOLD, f), tmp_path / f)
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("SPSP_TRACE", raising=False)
    timers.reset()
    return list(_FAMILY)


def _compare(files, engine="device", chunk_bytes=None):
    c = TorchComparator(engine=engine,
                        device="cpu" if engine == "device" else None)
    c.files_names = list(files)
    if chunk_bytes is None:
        c.compare_sketches(len(files))
    else:
        assert c.compare_sketches_chunked(len(files),
                                          chunk_bytes=chunk_bytes)
    return c


def _totals(counters):
    out = collections.Counter()
    for c in counters:
        out[c.name] += c.n
    return out


def test_comparison_span_tree(family):
    with _session():
        assert torch.autograd.profiler._is_profiler_enabled
        for _ in range(2):
            c = _compare(family)
            c.containment_csv()
            c.jaccard_csv()
    assert not torch.autograd.profiler._is_profiler_enabled
    spans = timers.spans()
    by_id = {s.span: s for s in spans}
    roots = [s for s in spans if s.name == "compare.call"]
    assert len(roots) == 2 and all(r.parent is None for r in roots)
    assert len({r.call for r in roots}) == 2
    for root in roots:
        assert root.call == root.span
        mine = [s for s in spans if s.call == root.call]
        names = collections.Counter(s.name for s in mine)
        # one read and one pass for the whole decode, whatever the files
        assert names == collections.Counter(
            {"compare.call": 1, **{n: 1 for n in _PARENT}})
        for s in mine:
            if s.name == "compare.call":
                continue
            parent = by_id[s.parent]
            assert parent.name == _PARENT[s.name], s
            assert parent.thread == s.thread
            assert parent.t0 <= s.t0 <= s.t1 <= parent.t1
    csvs = [s for s in spans if s.name == "compare.csv"]
    assert len(csvs) == 4
    assert all(s.parent is None and s.call == s.span for s in csvs)
    assert len(spans) == 2 * (1 + len(_PARENT)) + 4
    assert len({s.span for s in spans}) == len(spans)


@pytest.mark.parametrize("engine", ["device", "numpy"])
def test_chunked_comparison_spans(family, engine):
    """The chunked engine: one root, each chunk's decode as a
    ``compare.decode`` with one ``decode.pass`` inside it over the
    windows of every file that has buckets in the chunk, and no
    ``decode.read``."""
    with _session():
        _compare(family, engine, chunk_bytes=1024)
    spans = timers.spans()
    by_id = {s.span: s for s in spans}
    root, = [s for s in spans if s.name == "compare.call"]
    assert {s.call for s in spans} == {root.span}
    names = collections.Counter(s.name for s in spans)
    chunks = list(chunk_rounds([BucketStream(f) for f in family], 1024))
    assert "decode.read" not in names
    assert names["decode.pass"] == names["compare.decode"] == len(chunks) >= 2
    threads = [x.n for x in timers.counters()
               if x.name == "decode.pass.threads"]
    assert len(threads) == len(chunks)
    assert all(1 <= t <= sum(1 for b in per_file if b)
               for t, (_i, per_file, _o) in zip(threads, chunks))
    for s in spans:
        if s.name.startswith("decode."):
            assert by_id[s.parent].name == "compare.decode"
    assert names["compare.score"] == names["compare.tally"] >= 2
    if engine == "numpy":
        assert "score.product" not in names


def test_comparison_counters(family):
    with _session():
        c = _compare(family)
        c.containment_csv()
    n = _totals(timers.counters())
    assert sum(s.name == "decode.read" for s in timers.spans()) == 1
    assert n["decode.pairs"] == sum(c.nb_kmer_seen_infile) > 0
    assert n["decode.windows"] >= n["decode.pairs"]
    # the inflated bytes of every sketch, on 1 to 8 threads a stage
    inflated = 0
    for f in family:
        with gzip.open(f) as g:
            inflated += len(g.read())
    assert n["decode.inflated_bytes"] == inflated
    for name in _THREADS:
        threads = [x.n for x in timers.counters() if x.name == name]
        assert len(threads) == 1 and 1 <= threads[0] <= min(8, len(family))
    # all against all: every decoded pair is grouped and copied, as an
    # int32 group id and an int32 file id
    assert n["score.h2d_bytes"] == 8 * n["decode.pairs"]
    assert set(n) == {"decode.windows", "decode.pairs", "group.runs",
                      "score.h2d_bytes", "decode.inflated_bytes",
                      *_THREADS}
    root, = [s for s in timers.spans() if s.name == "compare.call"]
    assert all(x.call == root.span for x in timers.counters())


@pytest.mark.parametrize("chunk_bytes", [None, 1024])
def test_grouping_counts_one_run_per_sketch(family, chunk_bytes):
    """The grouping finds one run per sketch (each sketch's buckets are
    in order): the number of sketches in a comparison, and in the
    chunked engine the files with buckets in each chunk; ``group.sort``,
    the native pass, stays a child of ``compare.group``."""
    with _session():
        _compare(family, chunk_bytes=chunk_bytes)
    runs = [x for x in timers.counters() if x.name == "group.runs"]
    if chunk_bytes is None:
        assert [x.n for x in runs] == [len(family)]
    else:
        chunks = list(chunk_rounds([BucketStream(f) for f in family],
                                   chunk_bytes))
        assert len(chunks) >= 2
        assert [x.n for x in runs] == [sum(1 for b in per_file if b)
                                       for _i, per_file, _o in chunks]
    spans = timers.spans()
    by_id = {s.span: s for s in spans}
    sorts = [s for s in spans if s.name == "group.sort"]
    assert len(sorts) == len(runs)
    assert all(by_id[s.parent].name == "compare.group" for s in sorts)


def test_windows_count_every_kmer_before_the_dedup():
    """A bucket whose two super-k-mers repeat each other: twice the
    windows, the pairs once."""
    from supersampler_tpu_torch.compare.reader import decode_window

    k, m = 5, 3
    left, right = b"AA", b"CA"
    # minimizer ACG, an empty blob, two equal line pairs, the blank pair
    data = (b"ACG" + struct.pack("<I", 0)
            + b"\n".join([left, right, left, right]) + b"\n\n\n")
    timers.reset()
    with _session():
        mins = decode_window(data, 0, len(data), k, m)[0]
    n = _totals(timers.counters())
    timers.reset()
    assert n["decode.windows"] == 2 * 3
    assert n["decode.pairs"] == mins.size == 3


def test_record_function_ranges_reach_the_profiler(family, tmp_path,
                                                   monkeypatch):
    with _session() as prof:
        c = _compare(family)
        c.containment_csv()
    names = {e.name for e in prof.events()}
    assert {"compare.call", "compare.csv", *_PARENT} <= names
    trace = tmp_path / "trace"
    monkeypatch.setenv("SPSP_TRACE", str(trace))
    _compare(family, chunk_bytes=16384)
    with open(trace / "compare.json") as f:
        events = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"compare.call", "compare.decode", "decode.pass"} <= events


def test_no_spans_or_counters_outside_a_session(family):
    assert not torch.autograd.profiler._is_profiler_enabled
    c = _compare(family)
    c.containment_csv()
    assert timers.spans() == [] and timers.counters() == []
    assert timers.counts["compare.call"] == 1
    assert timers.counts["decode.read"] == timers.counts["decode.pass"] == 1
    assert timers.totals["compare.decode"] > 0


@pytest.mark.parametrize("engine", ["device", "numpy"])
@pytest.mark.parametrize("chunk_bytes", [None, 16384])
@pytest.mark.parametrize("traced", [False, True])
def test_csvs_equal_the_goldens_with_and_without_the_profiler(
        family, engine, chunk_bytes, traced):
    if traced:
        with _session():
            c = _compare(family, engine, chunk_bytes)
            c.write_outputs("t")
        assert timers.spans()
    else:
        c = _compare(family, engine, chunk_bytes)
        c.write_outputs("t")
        assert timers.spans() == []
    for kind in ("containment", "jaccard"):
        with open(os.path.join(_GOLD, f"allvsall_{kind}.csv.gz"), "rb") as f:
            want = f.read()
        with open(f"t_{kind}.csv.gz", "rb") as f:
            assert f.read() == want, kind


def test_sketch_phases_under_a_session_carry_thread_ids(tmp_path,
                                                        monkeypatch):
    monkeypatch.delenv("SPSP_TRACE", raising=False)
    path = _fasta(tmp_path)
    timers.reset()
    with _session():
        TorchSubsampler(k=31, m=11, s=10.0, device="cpu").sketch_file(path)
    spans = timers.spans()
    names = {s.name for s in spans}
    assert set(_PHASES) <= names
    main = threading.get_ident()
    threads = {n: {s.thread for s in spans if s.name == n} for n in _PHASES}
    # the reader, the prep workers and the device thread are not the caller
    for n in ("parse", "prep", "dispatch"):
        assert main not in threads[n], n
    assert threads["assemble"] == {main}
    for n in _PHASES:
        assert len([s for s in spans if s.name == n]) == timers.counts[n]


def test_span_buffer_is_bounded():
    t = PhaseTimers(cap=3)
    with _session():
        for i in range(5):
            with t.phase("p"):
                t.count("c", i)
    assert len(t.spans()) == 3 and len(t.counters()) == 3
    assert t.dropped == 4
    assert t.counts["p"] == 5
    t.reset()
    assert t.spans() == [] and t.counters() == [] and t.dropped == 0


def test_spans_nest_per_thread_under_threads():
    """Many threads, each a root with children: every span is kept,
    ids are unique, and each child names its own thread's root."""
    t = PhaseTimers()
    n_threads, n_each = 16, 50
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_each):
                with t.phase("root"):
                    with t.phase("child"):
                        t.count("n")

        with _session():
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    spans = t.spans()
    assert len(spans) == 2 * n_threads * n_each
    assert len({s.span for s in spans}) == len(spans)
    by_id = {s.span: s for s in spans}
    for s in spans:
        if s.name == "child":
            root = by_id[s.parent]
            assert root.name == "root" and root.thread == s.thread
            assert s.call == root.span == root.call
    calls = {s.call for s in spans}
    assert {c.call for c in t.counters()} == calls
    assert len(t.counters()) == n_threads * n_each
