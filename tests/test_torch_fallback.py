"""Port exact fallback engine inside the sketch pipeline, on the CPU.

Records the field resolve cannot settle (sync deserts: kilobase
homopolymers) re-run through successor tables and the walk on every
record route, and ``scan_engine = "legacy"`` sends every record through
them. Sketch bytes equal the scalar oracle's and JAX TpuSubsampler's,
and for the batch-route mix the print_stat report as well (mirrors of
tests/test_field.py:94-149 and tests/test_short_reads.py:76-89)."""

import gzip
import io
import json
import os
import random

import numpy as np
import pytest

from supersampler_tpu.oracle.subsampler import OracleSubsampler
from supersampler_tpu.sketch import subsample_file as jax_subsample_file
from supersampler_tpu.sketch.pipeline import TpuSubsampler
from supersampler_tpu.sketch.stats import print_stat as jax_print_stat
from supersampler_tpu_torch.native import clean_pack_native
from supersampler_tpu_torch.sketch import (TorchSubsampler, print_stat,
                                           subsample_file)
from supersampler_tpu_torch.sketch import pipeline as TP

_GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
with open(os.path.join(_GOLD, "meta.json")) as _f:
    _SKETCHES = json.load(_f)["sketches"]

_COUNTERS = ("read_kmer", "total_kmer_number", "total_superkmer_number",
             "selected_kmer_number", "selected_superkmer_number",
             "nb_mmer_selected", "count_maximal_skmer")


def _random_seq(rng, n):
    return "".join("ACGT"[c] for c in rng.integers(0, 4, n))


def _desert(seed, base="T"):
    rng = np.random.default_rng(seed)
    return _random_seq(rng, 500) + base * 3000 + _random_seq(rng, 500)


def _write_fasta(path, seqs, width=70):
    with open(path, "w") as f:
        for i, seq in enumerate(seqs):
            f.write(f">rec{i}\n")
            for j in range(0, len(seq), width):
                f.write(seq[j : j + width] + "\n")


def _oracle_scan(ref, s):
    oracle = OracleSubsampler(k=31, m=11, s=s)
    oracle.scan_sequence(ref)
    return oracle.serialize()


def _field_chain(ref, s, own):
    """A port FieldChain over ref at tile size own; returns the chain
    and the serialized sketch."""
    ss = TorchSubsampler(k=31, m=11, s=s, device="cpu")
    n_tiles = max(1, -(-(len(ref) - 31) // own))
    ref_np, slab, L = clean_pack_native(
        np.frombuffer(ref.encode(), np.uint8),
        n_tiles * own + ss._tile_extra, 128)
    chain = TP.FieldChain(slab, n_tiles, 31, 11, L, ss.threshold, own,
                          ss._tile_extra, ss._sel_cap_guess, s <= 1,
                          ss.device)
    ss._assemble_compact(ref_np, *chain.compact())
    return chain, ss.serialize()


def test_field_chain_falls_back_on_sync_desert():
    """The 3 kb poly-T record of tests/test_field.py:94 as one tile:
    the tile re-runs through the walker and the sketch stays exact."""
    ref = _desert(13)
    chain, got = _field_chain(ref, 2.0, 8192)
    assert chain.fallback_tiles == [0]
    assert got == _oracle_scan(ref, 2.0)
    jss = TpuSubsampler(k=31, m=11, s=2.0)
    jss.scan_sequence(ref)
    assert got == jss.serialize()


@pytest.mark.parametrize("s", [2.0, 20.0])
def test_field_chain_fallback_is_tile_granular(s):
    """A desert inside tile 2 of five 2,048-position tiles sends that
    tile alone to the walker; the state converts walker<->field at its
    edges (tests/test_field.py:119)."""
    rng = np.random.default_rng(77)
    ref = (_random_seq(rng, 2 * 2048 + 300) + "A" * 1500
           + _random_seq(rng, 2 * 2048 - 300))
    chain, got = _field_chain(ref, s, 2048)
    assert chain._n_tiles >= 5
    assert 2 in chain.fallback_tiles
    assert len(chain.fallback_tiles) < chain._n_tiles
    assert got == _oracle_scan(ref, s)

    class SmallTiles(TpuSubsampler):
        _tile_own = 2048

    jss = SmallTiles(k=31, m=11, s=s)
    jss.scan_sequence(ref)
    assert got == jss.serialize()


class _Legacy(TorchSubsampler):
    scan_engine = "legacy"


class _LegacySmallTiles(TorchSubsampler):
    scan_engine = "legacy"
    _tile_own = 2048


def test_legacy_engine_on_reads(tmp_path):
    """scan_engine = "legacy" routes short records through the walker
    too (tests/test_short_reads.py:76)."""
    rng = random.Random(3)
    seqs = ["".join(rng.choice("ACGT") for _ in range(rng.randint(100, 400)))
            for _ in range(40)]
    path = str(tmp_path / "r.fa")
    _write_fasta(path, seqs, 61)
    want = OracleSubsampler(k=31, m=11, s=2.0).sketch_file(path)
    port = _Legacy(k=31, m=11, s=2.0, device="cpu")
    port._prep_chunk = _no_short_groups(port._prep_chunk)
    assert port.sketch_file(path) == want

    class JaxLegacy(TpuSubsampler):
        scan_engine = "legacy"

    assert JaxLegacy(k=31, m=11, s=2.0).sketch_file(path) == want


def _no_short_groups(prep):
    def wrapped(data, spans):
        routes, groups = prep(data, spans)
        assert not groups and all(r[0] in ("legacy", "skip")
                                  for r in routes)
        return routes, groups
    return wrapped


@pytest.mark.parametrize("cfg", _SKETCHES, ids=[c["file"] for c in
                                                 _SKETCHES])
def test_legacy_engine_golden_sketch(cfg, datadir, goldendir):
    with gzip.open(os.path.join(goldendir, cfg["file"]), "rb") as f:
        golden = f.read()
    ss = _Legacy(k=cfg["k"], m=cfg["m"], s=float(np.float32(cfg["s"])),
                 abundance=cfg["a"], device="cpu")
    assert ss.sketch_file(datadir[cfg["dataset"]]) == golden


def test_legacy_engine_multi_tile(tmp_path):
    """Legacy tiles of 2,048 positions chained by the device carry
    (TiledDeviceChain), around a desert, equal the JAX legacy engine."""
    rng = np.random.default_rng(31)
    path = str(tmp_path / "long.fa")
    _write_fasta(path, [_random_seq(rng, 9000) + "T" * 2500
                        + _random_seq(rng, 3000), _random_seq(rng, 700)])

    class JaxLegacySmallTiles(TpuSubsampler):
        scan_engine = "legacy"
        _tile_own = 2048

    want = JaxLegacySmallTiles(k=31, m=11, s=3.0).sketch_file(path)
    assert _LegacySmallTiles(k=31, m=11, s=3.0,
                             device="cpu").sketch_file(path) == want


@pytest.mark.parametrize("s", [2.0, 1.0])
def test_single_route_desert(tmp_path, s):
    """A 100 kb record (over _SHORT_MAX, one tile) with a 3 kb poly-A:
    the single route's resolve fails and a one-tile TiledDeviceChain
    takes the record (pipeline.py:1404-1411)."""
    rng = np.random.default_rng(5)
    ref = _random_seq(rng, 60000) + "A" * 3000 + _random_seq(rng, 37000)
    path = str(tmp_path / "single.fa")
    _write_fasta(path, [ref])
    ss = TorchSubsampler(k=31, m=11, s=s, device="cpu")
    got = ss.sketch_file(path)
    assert ss.fallbacks == {"tile": 0, "single": 1, "batch": 0}
    assert got == TpuSubsampler(k=31, m=11, s=s).sketch_file(path)
    assert got == OracleSubsampler(k=31, m=11, s=s).sketch_file(path)


@pytest.mark.parametrize("s", [5.0, 1.0])
def test_batch_route_desert_mix(tmp_path, monkeypatch, s):
    """Short reads interleaved with desert records: each desert record
    goes through the walker on its own, in record order; bytes, the
    counters and the print_stat report equal JAX's."""
    rng = np.random.default_rng(11)
    seqs = [_random_seq(rng, int(n)) for n in rng.integers(300, 1200, 60)]
    for i, pos in enumerate((0, 17, 18, 45)):
        seqs.insert(pos, _desert(40 + i, "TA"[i % 2]))
    seqs.insert(30, "ACGT" * 5)                    # shorter than k
    path = str(tmp_path / "mix.fa")
    _write_fasta(path, seqs)
    reports = {}
    for name, make, sub, stat in (
            ("port", lambda: TorchSubsampler(k=31, m=11, s=s, device="cpu"),
             subsample_file, print_stat),
            ("jax", lambda: TpuSubsampler(k=31, m=11, s=s),
             jax_subsample_file, jax_print_stat)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        ss = make()
        out = sub(ss, path, "o_")
        with open(out, "rb") as f:
            raw = gzip.decompress(f.read())
        reports[name] = (raw, stat(ss), [getattr(ss, a) for a in _COUNTERS])
        if name == "port":
            assert ss.fallbacks == {"tile": 0, "single": 0, "batch": 4}
    assert reports["port"] == reports["jax"]
    oracle = OracleSubsampler(k=31, m=11, s=s)
    oracle.log = io.StringIO()
    assert reports["port"][0] == oracle.sketch_file(path)
    assert reports["port"][2] == [getattr(oracle, a) for a in _COUNTERS]
