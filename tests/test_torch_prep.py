"""The port's input prep against the reference, on the CPU.

Three faults of the host-side prep, each with the test that shows it:

* a header followed directly by another header is an empty record:
  ``stream_fasta_spans`` gives it an empty span, and ``_prep_chunk``
  cleans it to nothing on both engines, also from a span that ends
  before it starts (JAX's spans do);
* the short-record batch prep of such a record wrote before its pool;
* the clean + pack fast path (``supersampler_tpu_torch/csrc/spsp_io.c``)
  strips every non-ACGT byte, as JAX ``clean_dna`` does, whatever byte
  comes before it and wherever it sits in an 8-byte unit.

Sketch bytes are held to ``OracleSubsampler`` (the reference's
semantics) on both engines, at the default and at shrunk route
geometry, through ``-f``, and over a seeded fuzz of random-shape
files; and to JAX ``TpuSubsampler`` where JAX is right (its legacy
engine, and its field engine where no empty record shares a short
batch with a longer one). Every comparison is byte-exact."""

import gzip
import io
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from supersampler_tpu.io.fasta import clean_dna, read_fasta_spans
from supersampler_tpu.oracle.subsampler import OracleSubsampler
from supersampler_tpu.sketch.pipeline import TpuSubsampler
from supersampler_tpu_torch.cli import sub_sampler as cli
from supersampler_tpu_torch.io.fasta import stream_fasta_spans
from supersampler_tpu_torch.native import clean_pack_batch_native
from supersampler_tpu_torch.sketch import TorchSubsampler


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain CPU path is many small torch ops: one thread a test
    process keeps the workers of a parallel test run off each other's
    cores (the checks are the same)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seq(rng, n: int) -> str:
    return "".join("ACGT"[c] for c in rng.integers(0, 4, n))


def _oracle(path, k=31, m=11, s=2.0, abundance=1) -> bytes:
    ss = OracleSubsampler(k=k, m=m, s=s, abundance=abundance)
    ss.log = io.StringIO()
    return ss.sketch_file(path)


class _Legacy(TorchSubsampler):
    scan_engine = "legacy"


class _SmallTiles(TorchSubsampler):
    _tile_own = 2048
    _SHORT_MAX = 1024


class _SmallTilesLegacy(_SmallTiles):
    scan_engine = "legacy"


class _JaxLegacy(TpuSubsampler):
    scan_engine = "legacy"


_PORT = {("field", "default"): TorchSubsampler,
         ("legacy", "default"): _Legacy,
         ("field", "small"): _SmallTiles,
         ("legacy", "small"): _SmallTilesLegacy}


def _fault_inputs():
    """name -> FASTA text: empty records next to headers, ahead of
    short, medium (single-tile) and multi-tile records (multi-tile at
    the shrunk geometry: 2,048-position tiles, short up to 1,024)."""
    rng = np.random.default_rng(11)
    return {
        # fault 1: the empty record alone in its short batch
        "empty_then_long": (">r0\n>r1\n" + _seq(rng, 5000) + "\n>r2\n"
                            + _seq(rng, 7000) + "\n"),
        # fault 2: the empty record in one short batch with others
        "empty_in_batch": (">r0\n>r1\n" + _seq(rng, 300) + "\n>r2\n"
                           + _seq(rng, 500) + "\n>r3\n"),
        "empties_between": (">a\n>b\n>c\n" + _seq(rng, 90) + "\n>d\n>e\n"
                            + _seq(rng, 1500) + "\n>f\n>g\n"
                            + _seq(rng, 9000) + "\n>h\n>i\n"
                            + _seq(rng, 200) + "\n>j\n"),
        "headers_only": ">a\n>b\n>c\n",
    }


_FAULTS = _fault_inputs()


def test_stream_fasta_spans_never_end_before_start(tmp_path):
    path = tmp_path / "e.fa"
    path.write_bytes(b">r0\n>r1\nACGTACGTAC\n>r2\nACGT\n")
    (data, spans), = stream_fasta_spans(str(path))
    assert spans == [(4, 4), (8, 18), (23, 28)]
    jdata, jspans = read_fasta_spans(str(path))
    assert [data[s:e] for s, e in spans] == [jdata[s:e] for s, e in jspans]


@pytest.mark.parametrize("engine", ["field", "legacy"])
def test_prep_chunk_cleans_a_span_that_ends_before_it_starts(engine):
    """JAX's spans give an empty record (start, start - 1): every
    record must still clean to clean_dna of its body."""
    rng = np.random.default_rng(3)
    text = (">r0\n>r1\n" + _seq(rng, 300) + "\n>r2\n" + _seq(rng, 500)
            + "\n>r3\n>r4\n" + _seq(rng, 70000) + "\n").encode()
    spans = [(4, 3), (8, 308), (313, 813), (818, 817), (822, len(text) - 1)]
    ss = (_Legacy if engine == "legacy" else TorchSubsampler)(
        k=31, m=11, s=2.0, device="cpu")
    routes, _groups = ss._prep_chunk(text, spans)
    for (s, e), r in zip(spans, routes, strict=True):
        want = clean_dna(text[s:e])
        if r[0] == "skip":
            assert len(want) < ss.k
        elif r[0] == "grp":
            g, slot = r[1], r[2]
            o, n = int(g["ref_offs"][slot]), int(g["ref_lens"][slot])
            assert bytes(g["ref_pool"][o : o + n]) == want
        else:
            assert bytes(r[1]) == want


@pytest.mark.parametrize("geometry", ["default", "small"])
@pytest.mark.parametrize("engine", ["field", "legacy"])
@pytest.mark.parametrize("name", sorted(_FAULTS))
def test_empty_records_equal_the_oracle(tmp_path, name, engine, geometry):
    path = str(tmp_path / f"{name}.fa")
    with open(path, "w") as f:
        f.write(_FAULTS[name])
    got = _PORT[engine, geometry](k=31, m=11, s=2.0,
                                  device="cpu").sketch_file(path)
    assert got == _oracle(path)


@pytest.mark.parametrize("name", sorted(_FAULTS))
def test_empty_records_equal_jax(tmp_path, name):
    """JAX's legacy engine cleans each body on its own and is right on
    every input; its field engine shares the batch prep's fault, so it
    is compared only where no empty record shares a short batch with a
    non-empty one."""
    path = str(tmp_path / f"{name}.fa")
    with open(path, "w") as f:
        f.write(_FAULTS[name])
    got = TorchSubsampler(k=31, m=11, s=2.0, device="cpu").sketch_file(path)
    assert got == _JaxLegacy(k=31, m=11, s=2.0).sketch_file(path)
    if name in ("empty_then_long", "headers_only"):
        assert got == TpuSubsampler(k=31, m=11, s=2.0).sketch_file(path)


def test_empty_records_through_the_fof_cli(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TORCH_DEVICE", "cpu")
    paths = []
    for name, text in sorted(_FAULTS.items()):
        paths.append(str(tmp_path / f"{name}.fa"))
        with open(paths[-1], "w") as f:
            f.write(text)
    (tmp_path / "fof.txt").write_text("\n".join(paths) + "\n")
    with redirect_stdout(io.StringIO()):
        assert cli.main(["-f", str(tmp_path / "fof.txt"), "-s", "2", "-p",
                         "e_"]) == 0
    for path in paths:
        stem = os.path.basename(path).split(".")[0]
        got = gzip.decompress((tmp_path / f"e_{stem}.gz").read_bytes())
        assert got == _oracle(path), stem


def test_clean_pack_strips_every_non_acgt_byte():
    """Every byte value at every position of an 8-byte unit, after each
    of ACGTacgt, with 0-7 bases ahead of the unit (every alignment of
    the unit against the C's 8-byte reads): the cleaned bytes equal JAX
    clean_dna, and the packed codes are theirs."""
    fill = b"GATTACAC"
    recs = []
    for align in range(8):
        for pos in range(8):
            for prev in b"ACGTacgt":
                head = bytearray(b"TGCA" * 2)[:align]
                unit = bytearray(fill)
                if pos:
                    unit[pos - 1] = prev
                elif align:
                    head[-1] = prev
                for v in range(256):
                    unit[pos] = v
                    recs.append(bytes(head + unit) + fill)
    data = b"".join(recs)
    lens = np.array([len(r) for r in recs], np.int64)
    starts = np.zeros(len(recs), np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    P = 64
    pool = np.empty(int(lens.sum()), np.uint8)
    pack = np.zeros((len(recs), P >> 2), np.uint8)
    out = clean_pack_batch_native(
        np.frombuffer(data, np.uint8), starts, starts + lens, pool, starts,
        pack, np.arange(len(recs), dtype=np.int64) * (P >> 2),
        np.full(len(recs), P, np.int64))
    shift = np.arange(4, dtype=np.uint8) * 2
    for r, raw in enumerate(recs):
        want = clean_dna(raw)
        o = int(starts[r])
        assert bytes(pool[o : o + out[r]]) == want, (r, raw)
        codes = np.zeros(P, np.uint8)
        codes[: len(want)] = (np.frombuffer(want, np.uint8) >> 1) & 3
        want_pack = np.bitwise_or.reduce(
            codes.reshape(-1, 4) << shift, axis=1).astype(np.uint8)
        assert np.array_equal(pack[r], want_pack), (r, raw)


def _fuzz_file(rng, path, small: bool):
    """A random-shape FASTA: empty records, N/R/Y runs, IUPAC and
    other non-ACGT bytes after bases, mixed case, odd line widths,
    CRLF, and record lengths at the route boundaries of the shrunk
    geometry (short up to 790 raw bytes, one tile up to 1,814)."""
    edges = ([0, 1, 30, 31, 32, 700, 789, 790, 791, 1813, 1814, 1815,
              4200, 9000] if small else [0, 5, 31, 64, 300, 3000, 12000])
    width = int(rng.choice([7, 13, 60, 61, 80, 121, 1 << 20]))
    nl = b"\r\n" if rng.random() < 0.3 else b"\n"
    out = []
    for i in range(int(rng.integers(1, 9))):
        n = int(rng.choice(edges)) + int(rng.integers(-2, 3))
        body = np.frombuffer(_seq(rng, max(n, 0)).encode(), np.uint8).copy()
        if body.size and rng.random() < 0.5:
            low = rng.random(body.size) < 0.3
            body[low] |= 0x20
        for _ in range(int(rng.integers(0, 4))):
            if body.size < 2:
                break
            a = int(rng.integers(0, body.size - 1))
            b = min(body.size, a + int(rng.integers(1, 40)))
            body[a:b] = ord(rng.choice(list("NRYnBUF@`-*")))
        for j in rng.integers(1, max(body.size, 2), 3):
            if j < body.size:
                body[j] = ord(rng.choice(list("BUF@`buf")))
        raw = body.tobytes()
        out.append(b">rec%d x" % i + nl)
        out.extend(raw[j : j + width] + nl for j in range(0, len(raw), width))
    if rng.random() < 0.2:
        out[-1] = out[-1].rstrip()        # no final newline
    with open(path, "wb") as f:
        f.write(b"".join(out))


_FUZZ_PARAMS = [(31, 11, 2.0, 1), (31, 11, 1.0, 1), (21, 7, 5.0, 2),
                (15, 5, 10.0, 1), (31, 11, 50.0, 3), (25, 9, 1.5, 1)]


@pytest.mark.parametrize("seed", range(6))
def test_fuzzed_files_equal_the_oracle(tmp_path, seed):
    """Five random-shape files a seed, at one (k, m, s, abundance) of
    _FUZZ_PARAMS, on the field engine at both geometries and on the
    legacy engine."""
    rng = np.random.default_rng(1000 + seed)
    k, m, s, a = _FUZZ_PARAMS[seed]
    for f in range(5):
        small = f < 3
        path = str(tmp_path / f"z{f}.fa")
        _fuzz_file(rng, path, small)
        want = _oracle(path, k, m, s, a)
        classes = ((_SmallTiles, _SmallTilesLegacy) if small
                   else (TorchSubsampler, _Legacy))
        for cls in classes:
            got = cls(k=k, m=m, s=s, abundance=a, device="cpu").sketch_file(
                path)
            assert got == want, (f, cls.__name__)
