"""Port device-dedup path and Python k-mer store on the CPU, tolerance 0.

``ops/dedup.py`` against the JAX module (the same spans and codes, made
with numpy from a seed; the fetch arrays whole, rows past n_unique
included), ``merge_unique_host`` into the port's store
(``sketch/store.py``) against the scalar oracle's intake, and sketches
with ``device_dedup = True`` or ``native_finisher = False`` against the
oracle's bytes and counters on every route of ``_launch_scan`` (field
single and tiled, the walk region of a record of at most 790 bp, the
legacy engine single and tiled, tile fallbacks, the capacity retries,
the uint8 count wrap), against the goldens, and against the default
path through ``sketch_fof`` (mirrors of tests/test_dedup.py)."""

import functools
import gzip
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supersampler_tpu.ops import dedup as JD
from supersampler_tpu.oracle.subsampler import OracleSubsampler
from supersampler_tpu_torch.native import clean_pack_native
from supersampler_tpu_torch.ops import dedup as TD
from supersampler_tpu_torch.ops.field import (field_entry_init, resolve_field,
                                              scan_field_2d_packed)
from supersampler_tpu_torch.ops.minimizer import scan_tables_2d_packed
from supersampler_tpu_torch.ops.walker import DeviceChain
from supersampler_tpu_torch.sketch import TorchSubsampler, sketch_fof
from supersampler_tpu_torch.sketch import pipeline as TP

_GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
with open(os.path.join(_GOLD, "meta.json")) as _f:
    _SKETCHES = json.load(_f)["sketches"]

_COUNTERS = ("read_kmer", "total_kmer_number", "total_superkmer_number",
             "selected_kmer_number", "selected_superkmer_number",
             "count_maximal_skmer", "nb_mmer_selected",
             "seen_kmers_at_reconstruction",
             "seen_superkmers_at_reconstruction",
             "seen_max_superkmers_at_reconstruction",
             "seen_unique_kmers_at_reconstruction",
             "total_kmer_number_at_reconstruction",
             "actual_minimizer_number")
_FLAGS = {"dedup": {"device_dedup": True},
          "store": {"native_finisher": False}}


def _seq(rng, n):
    return "".join("ACGT"[c] for c in rng.integers(0, 4, n))


def _repeat_ref(L, seed, unit_len=100, before=6, after=4):
    """Random sequence between tandem copies of a random unit
    (tests/test_dedup.py:66-70): repeats stress counts and order."""
    rng = np.random.default_rng(seed)
    unit = _seq(rng, unit_len)
    return unit * before + _seq(rng, L) + unit * after


def _subsampler(k=31, m=11, s=2.0, a=1, flags=(), **attrs):
    ss = TorchSubsampler(k=k, m=m, s=s, abundance=a, device="cpu")
    for name, value in dict(flags, **attrs).items():
        setattr(ss, name, value)
    return ss


@functools.lru_cache(maxsize=None)
def _oracle(ref, k, m, s, a=1):
    """(sketch bytes, counters, bucket state) of the scalar oracle."""
    oracle = OracleSubsampler(k=k, m=m, s=s, abundance=a)
    oracle.scan_sequence(ref)
    state = _bucket_state(oracle)
    raw = oracle.serialize()
    return raw, {c: getattr(oracle, c) for c in _COUNTERS}, state


def _bucket_state(ss):
    return {mv: [(km, info.count, info.pos_min)
                 for km, info in bucket.items()]
            for mv, bucket in ss.minimizer_map.items()}


def _codes(ref, P):
    codes = np.zeros(P, np.uint8)
    codes[: len(ref)] = np.frombuffer(ref.encode().translate(
        bytes.maketrans(b"ACTG", bytes([0, 1, 2, 3]))), np.uint8)
    return codes


def _spans(ref, k, m, s):
    """The selected spans of ref, tail flush included, as the port's
    default path compacts them."""
    ss = _subsampler(k, m, s)
    comp, _ = ss._fetch_scan(ss._launch_scan(np.frombuffer(ref.encode(),
                                                           np.uint8)))
    sel_pos, sel_last, sel_val, sel_rev, n_ev, last_ev, tv, tr, ts = comp
    spans = [(int(p), int(q), int(v), bool(r))
             for p, q, v, r in zip(sel_pos, sel_last, sel_val, sel_rev)]
    if ts:
        spans.append((len(ref) - k, last_ev + 1 if n_ev else 0, int(tv),
                      bool(tr)))
    return spans


_INTAKE_CASES = [
    (3000, 2.0, 0, 31, 11),
    (5000, 1.0, 1, 31, 11),       # select-all
    (4000, 1.0, 2, 21, 7),
    (2000, 1.0, 3, 63, 15),
    (2000, 1.0, 4, 15, 5),
]


def _dedup_inputs(L, s, seed, k, m):
    ref = _repeat_ref(L, seed)
    spans = _spans(ref, k, m, s)
    P = 1 << (len(ref) + k + 64).bit_length()
    cap = 1 << max(4, (len(spans) or 1).bit_length())
    cols = []
    for j, (fill, dt) in enumerate(((-1, np.int32), (-1, np.int32),
                                    (0, np.uint32), (False, bool))):
        a = np.full(cap, fill, dt)
        a[: len(spans)] = [sp[j] for sp in spans]
        cols.append(a)
    n_occ = sum(p - q + 1 for p, q, _v, _r in spans)
    return ref, _codes(ref, P), cols, len(spans), n_occ, P


def _port_dedup(codes, cols, n_spans, k, m, P, K):
    t = [torch.from_numpy(c.astype(np.int64) if c.dtype == np.uint32 else c)
         for c in cols]
    return TD.dedup_spans(torch.from_numpy(codes), (*t, torch.tensor(n_spans)),
                          k, m, P, K)


@pytest.mark.parametrize("cut", [False, True], ids=["K-full", "K-cut"])
@pytest.mark.parametrize("L,s,seed,k,m", _INTAKE_CASES)
def test_dedup_spans_equals_jax(L, s, seed, k, m, cut):
    """Every output of the port's dedup_spans equals JAX's, whole
    arrays; K-cut keeps a quarter of the k-mer rows (nonzero's
    truncation and fill; n_kmers stays the full count)."""
    _ref, codes, cols, n_spans, n_occ, P = _dedup_inputs(L, s, seed, k, m)
    K = (1 << max(6, (2 * n_occ).bit_length()) if not cut
         else 1 << (n_occ // 4).bit_length())
    want = JD.dedup_spans(
        jnp.asarray(codes), tuple(jnp.asarray(c) for c in cols)
        + (jnp.int32(n_spans),), k, m, P, K)
    got = _port_dedup(codes, cols, n_spans, k, m, P, K)
    assert int(got[0]) == int(want[0]) == n_occ
    assert int(got[1]) == int(want[1]) > 0
    for g, w in zip(got[2:], want[2:]):
        w = np.asarray(w)
        assert np.array_equal(g.numpy(), w.astype(np.int64)), w.dtype


@pytest.mark.parametrize("L,s,seed,k,m", _INTAKE_CASES)
def test_merged_buckets_equal_oracle_intake(L, s, seed, k, m):
    """merge_unique_host into the port's store == the oracle's intake:
    keys, counts, pos_min and first-insertion (bucket) order."""
    ref, codes, cols, n_spans, n_occ, P = _dedup_inputs(L, s, seed, k, m)
    K = 1 << max(6, (2 * n_occ).bit_length())
    out = _port_dedup(codes, cols, n_spans, k, m, P, K)
    u = [a.numpy() for a in out[2:]]
    fetched = (int(out[1]), u[0].astype(np.uint32), u[1].astype(np.uint32),
               u[2].astype(np.int32), u[3].astype(np.int32),
               u[4].astype(np.int32))
    ss = _subsampler(k, m, s)
    TD.merge_unique_host(ss, fetched)
    want = _oracle(ref, k, m, s)[2]
    got = _bucket_state(ss)
    assert set(got) == set(want)
    for mv in want:
        assert got[mv] == want[mv], f"bucket {mv} differs"


def _field_array(ref, k, m, s, own, cap):
    """A single-tile field resolve of ref: (fetch array, slab)."""
    ss = _subsampler(k, m, s)
    _r, slab, L = clean_pack_native(np.frombuffer(ref.encode(), np.uint8),
                                    own + 512, 128)
    slab_t = torch.from_numpy(slab)
    ft = scan_field_2d_packed(slab_t[32:], k, m, own + 512, L)
    arr = resolve_field(ft, k, m, cap, field_entry_init(ft, *ss._thr),
                        *ss._thr)
    return arr, slab_t


@pytest.mark.parametrize("cap,K,length", [
    (256, 1 << 13, None),         # fits: the tail span included
    (256, 1 << 13, -1),           # a non-final tile: no tail span
    (16, 1 << 13, None),          # cut span list: the tail write dropped
    (256, 64, None),              # cut k-mer rows
])
def test_field_dedup_packed_equals_jax(cap, K, length):
    ref = _repeat_ref(3000, 7)
    arr, slab = _field_array(ref, 31, 11, 2.0, 8192, cap)
    n = len(ref) if length is None else length
    got = TD.field_dedup_packed(arr, cap, slab, n, 31, 11, 8192 + 640, K)
    want = JD.field_dedup_packed(jnp.asarray(arr.numpy()), cap,
                                 jnp.asarray(slab.numpy()), jnp.int32(n),
                                 31, 11, 8192 + 640, K)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    n_sel = int(arr[1])
    assert (n_sel > cap) == (cap == 16)


@pytest.mark.parametrize("cap,K", [(256, 1 << 13), (8, 1 << 13),
                                   (256, 128)])
def test_dedup_chain_packed_equals_jax(cap, K):
    """The walker's fused fetch (compact array + uniques) == JAX's on
    the same compact outputs, cut lists included."""
    ref = _repeat_ref(390, 8, unit_len=50, before=2, after=2)
    ss = _subsampler(31, 11, 2.0)
    _r, slab, L = clean_pack_native(np.frombuffer(ref.encode(), np.uint8),
                                    1024, 128)
    slab_t = torch.from_numpy(slab)
    tables = scan_tables_2d_packed(slab_t[32:], 31, 11, 1024, L, *ss._thr)
    dc = DeviceChain(tables, cap, pack=False)
    outs = dc.compact_outs(cap)
    got = TD.dedup_chain_packed(outs, dc.scal, slab_t, L, 31, 11, 1152, K)
    o = [a.numpy() for a in outs]
    j_outs = (jnp.asarray(o[0]), jnp.asarray(o[1]),
              jnp.asarray(o[2].view(np.uint32)), jnp.asarray(o[3] != 0),
              jnp.int32(o[4]), jnp.int32(o[5]), jnp.int32(o[6]),
              jnp.uint32(np.int32(o[7]).view(np.uint32)), jnp.bool_(o[8]),
              jnp.bool_(o[9]))
    want = JD.dedup_chain_packed(j_outs, jnp.asarray(dc.scal.numpy()),
                                 jnp.asarray(slab), jnp.int32(L), 31, 11,
                                 1152, K)
    assert np.array_equal(got.numpy(), np.asarray(want))


def _tandem(reps, seed=40, unit_len=40):
    """A random unit repeated reps times: at s = 1 each k-mer of the
    repeat occurs reps or reps - 1 times."""
    rng = np.random.default_rng(seed)
    return _seq(rng, unit_len) * reps


def _desert(seed):
    rng = np.random.default_rng(seed)
    return _seq(rng, 500) + "T" * 3000 + _seq(rng, 500)


# (name, ref maker, k, m, s, abundance, class attributes, route, tiles
# that fall back); the first four are tests/test_dedup.py:122's cases
_ROUTES = [
    ("repeat-s2", lambda: _repeat_ref(3000, 10, 80, 5, 3), 31, 11, 2.0, 1,
     {}, "FieldChain", []),
    ("repeat-select-all-a2", lambda: _repeat_ref(2500, 11, 80, 5, 3), 31, 11,
     1.0, 2, {}, "FieldChain", []),
    ("repeat-k21", lambda: _repeat_ref(2000, 12, 80, 5, 3), 21, 7, 1.0, 1, {},
     "FieldChain", []),
    ("repeat-k63", lambda: _repeat_ref(1500, 13, 80, 5, 3), 63, 15, 5.0, 1,
     {}, "FieldChain", []),
    ("field-tiled", lambda: _seq(np.random.default_rng(21), 9000), 31, 11,
     3.0, 1, {"_tile_own": 2048, "_tile_extra": 512}, "FieldChain", []),
    ("field-retry", lambda: _seq(np.random.default_rng(31), 3000), 31, 11,
     2.0, 1, {"_sel_cap_guess": 16, "_kmer_cap_guess": 32}, "FieldChain",
     []),
    ("walk-790bp", lambda: _repeat_ref(390, 32, 50, 4, 4), 31, 11, 2.0, 1,
     {}, "DedupDeviceChain", []),
    ("walk-retry", lambda: _seq(np.random.default_rng(33), 790), 31, 11, 2.0,
     1, {"_sel_cap_guess": 16, "_kmer_cap_guess": 32}, "DedupDeviceChain",
     []),
    ("legacy-single", lambda: _repeat_ref(3000, 34, 80, 5, 3), 31, 11, 2.0,
     1, {"scan_engine": "legacy"}, "DedupDeviceChain", []),
    ("legacy-tiled", lambda: _seq(np.random.default_rng(35), 9000), 31, 11,
     3.0, 1, {"scan_engine": "legacy", "_tile_own": 2048,
              "_tile_extra": 512, "_sel_cap_guess": 16,
              "_kmer_cap_guess": 32}, "TiledDeviceChain", []),
    ("desert-single", lambda: _desert(13), 31, 11, 2.0, 1, {}, "FieldChain",
     [0]),
    ("desert-tiled", lambda: _desert(14), 31, 11, 2.0, 1,
     {"_tile_own": 2048, "_tile_extra": 512}, "FieldChain", [0, 1]),
    # a tandem is a sync desert: its tiles re-run through the walker
    ("wrap-one-dispatch", lambda: _tandem(257), 31, 11, 1.0, 1, {},
     "FieldChain", [0]),
    ("wrap-two-tiles", lambda: _tandem(257), 31, 11, 1.0, 1,
     {"_tile_own": 8192}, "FieldChain", [0, 1]),
]


@pytest.mark.parametrize("flag", list(_FLAGS))
@pytest.mark.parametrize("name,make,k,m,s,a,attrs,route,fallback", _ROUTES,
                         ids=[r[0] for r in _ROUTES])
def test_scan_sequence_equals_oracle(name, make, k, m, s, a, attrs, route,
                                     fallback, flag):
    """scan_sequence through the Python store (device dedup, or the
    finisher off) == the oracle's bytes and counters, on each route."""
    ref = make()
    want, counters, _state = _oracle(ref, k, m, s, a)
    ss = _subsampler(k, m, s, a, _FLAGS[flag], **attrs)
    dc = ss._launch_scan(np.frombuffer(ref.encode(), np.uint8))
    want_route = route if flag == "dedup" else route.replace(
        "DedupDeviceChain", "DeviceChain")
    assert type(dc).__name__ == want_route
    comp, uniques = ss._fetch_scan(dc)
    assert getattr(dc, "fallback_tiles", []) == fallback
    n_tiles = getattr(dc, "_n_tiles", 1)
    assert (uniques is None) == (flag == "store")
    assert flag == "store" or len(uniques) == n_tiles
    ss._assemble_compact(np.frombuffer(ref.encode(), np.uint8), *comp,
                         uniques_list=uniques)
    if name.startswith("wrap"):
        counts = {i.count for b in ss.minimizer_map.values()
                  for i in b.values()}
        assert {0, 1} <= counts and max(counts) < 256
    assert ss.serialize() == want
    got = {c: getattr(ss, c) for c in _COUNTERS}
    assert got == dict(counters, read_kmer=0)


def test_native_finisher_true_with_dedup_raises():
    ss = _subsampler(flags={"device_dedup": True, "native_finisher": True})
    with pytest.raises(ValueError, match="native_finisher"):
        ss.scan_sequence(_seq(np.random.default_rng(1), 500))


def _counters(ss):
    return {c: getattr(ss, c) for c in _COUNTERS}


@pytest.mark.parametrize("flag", list(_FLAGS))
@pytest.mark.parametrize("cfg", _SKETCHES, ids=[c["file"] for c in
                                                 _SKETCHES])
def test_golden_sketch_through_the_store(cfg, flag, datadir, goldendir):
    """The goldens' bytes, and the default path's print_stat counters."""
    with gzip.open(os.path.join(goldendir, cfg["file"]), "rb") as f:
        golden = f.read()
    params = dict(k=cfg["k"], m=cfg["m"], s=float(np.float32(cfg["s"])),
                  a=cfg["a"])
    ss = _subsampler(**params, flags=_FLAGS[flag])
    assert ss.sketch_file(datadir[cfg["dataset"]]) == golden
    default = _subsampler(**params)
    assert default.sketch_file(datadir[cfg["dataset"]]) == golden
    assert _counters(ss) == _counters(default)
    assert ss._nf_obj is None


def _fuzz_fasta(path, seed):
    """Random-shape records: empty ones next to headers, N/R/Y runs,
    lowercase, line widths, and lengths on both sides of 790 bp and of
    the short-batch limit."""
    rng = np.random.default_rng(seed)
    lens = [0, 40, 300, 700, 790, 791, 1200, 5000, 0, 64000, 66000, 80000,
            int(rng.integers(100, 3000))]
    out = []
    for i, n in enumerate(lens):
        b = bytearray(_seq(rng, n).encode())
        for _ in range(n // 700):
            a = int(rng.integers(0, max(n - 40, 1)))
            r = int(rng.integers(1, 40))
            b[a : a + r] = bytes([int(rng.choice(list(b"NRY")))]) * r
        if n > 500:
            a = int(rng.integers(0, n - 300))
            b[a : a + 300] = bytes(b[a : a + 300]).lower()
        w = int(rng.integers(50, 90))
        out.append(b">r%d\n" % i + b"".join(bytes(b[j : j + w]) + b"\n"
                                            for j in range(0, n, w)))
    path.write_bytes(b"".join(out))
    return str(path)


@pytest.mark.parametrize("flag", list(_FLAGS))
def test_random_shape_file_equals_default_path(tmp_path, flag):
    path = _fuzz_fasta(tmp_path / "fuzz.fa", 17)
    got = _subsampler(31, 11, 20.0, flags=_FLAGS[flag])
    want = _subsampler(31, 11, 20.0)
    raw = got.sketch_file(path)
    assert raw == want.sketch_file(path) and raw.count(b"\n") > 10
    assert _counters(got) == _counters(want)


def test_sketch_fof_mixes_store_and_finisher_members(datadir, tmp_path,
                                                     monkeypatch):
    """Dedup, Python-store and default members in one fof split into one
    run per kind; each result == its member's own sketch_file, in fof
    order; a missing entry stays None."""
    paths = [datadir["fam0"], datadir["edge"], str(tmp_path / "nope.fa"),
             datadir["repeat"], datadir["fam1"], datadir["big"]]
    kinds = ["dedup", "store", "default", "dedup", "default", "store"]
    runs = []
    real_run = TP._SharedSketchRun.run

    def counted(self):
        runs.append([p for _ss, p in self.items])
        return real_run(self)

    monkeypatch.setattr(TP._SharedSketchRun, "run", counted)
    monkeypatch.setattr(TP._SharedSketchRun, "_CHUNK_BYTES", 3000)

    def member(kind):
        ss = _subsampler(31, 11, 5.0, flags=_FLAGS.get(kind, {}))
        ss.log = io.StringIO()
        return ss

    calls = []
    got = sketch_fof([(member(kd), p) for kd, p in zip(kinds, paths)],
                     on_result=lambda idx, raw: calls.append(idx))
    assert runs == [[paths[0], paths[3]], [paths[1], paths[5]],
                    [paths[4]]]
    assert sorted(calls) == [0, 1, 3, 4, 5] and got[2] is None
    monkeypatch.setattr(TP._SharedSketchRun, "run", real_run)
    for kind, p, raw in zip(kinds, paths, got):
        if p != paths[2]:
            assert raw == member(kind).sketch_file(p), (kind, p)
            assert raw == member("default").sketch_file(p), (kind, p)
