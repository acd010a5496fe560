"""The benchmark's plain reference against the repo's goldens (sketches
of the reference tool, tests/golden/) and against the program's
sketches of adversarial inputs, on the CPU."""

import gzip
import importlib.util
import json
import os

import numpy as np
import pytest

from benchmark.reference import compare as cref
from benchmark.reference import sketch as ref
from benchmark.reference.sketchfile import decode, pair_gaps
from benchmark.tests.tiny import REPO

GOLDEN = os.path.join(REPO, "tests", "golden")
_ACGT = np.frombuffer(b"ACGT", np.uint8)


def _make_data():
    spec = importlib.util.spec_from_file_location(
        "bench_make_data", os.path.join(REPO, "tests", "make_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return _make_data().make_all(str(tmp_path_factory.mktemp("golden_in")))


def records(path):
    """The records the tool reads: bodies uppercased, non-ACGT bytes
    dropped (utils.cpp:675-702), laid end to end with their starts."""
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        text = f.read()
    keep = np.zeros(256, bool)
    keep[_ACGT] = True
    recs = []
    for chunk in text.split(b"\n>"):
        body = chunk.split(b"\n", 1)[1] if b"\n" in chunk else b""
        b = np.frombuffer(body.upper(), np.uint8)
        recs.append(b[keep[b]])
    starts = np.cumsum([0] + [r.size for r in recs])
    return np.concatenate(recs), starts


def _golden(name):
    with gzip.open(os.path.join(GOLDEN, name), "rb") as f:
        return f.read()


META = json.load(open(os.path.join(GOLDEN, "meta.json")))


@pytest.mark.parametrize("row", [r for r in META["sketches"] if r["k"] <= 32],
                         ids=lambda r: r["file"])
def test_reference_equals_golden_sketch(data, row):
    seq, starts = records(data[row["dataset"]])
    want, kept = ref.sketch_pairs(seq, starts, row["k"], row["m"],
                                  float(row["s"]), row["a"])
    got, got_kept, k, m = decode(_golden(row["file"]))
    assert (k, m) == (row["k"], row["m"])
    assert got_kept == kept
    assert pair_gaps(got, want) == (0, 0)
    assert got.shape[0] > 0


def test_reference_equals_golden_comparison(data):
    cm = META["compare"]
    pairs = []
    for i, name in enumerate(cm["files"]):
        seq, starts = records(data[f"fam{i}"])
        p, _ = ref.sketch_pairs(seq, starts, cm["k"], cm["m"],
                                float(cm["s"]), 1)
        assert pair_gaps(decode(_golden(name))[0], p) == (0, 0)
        pairs.append(p)
    inter = cref.intersections(cref.file_sets(pairs, cm["k"]))
    for jac, name in ((False, "allvsall_containment.csv.gz"),
                      (True, "allvsall_jaccard.csv.gz")):
        want = _golden(name).decode()
        got = cref.csv_text(cm["files"], inter, 6, 0.0, jac)
        assert cref.cells_wrong(got, want) == 0
        assert got == want


def test_threshold_precisions():
    """The tool's threshold at (31, 11, 1000) in long double, and the
    control's lower precisions: float64 moves it by 572 (no hash in
    practice falls between), float32 by 0.04 %."""
    t80 = ref.threshold(31, 11, 1000.0)
    assert t80 == 878834950402620
    assert ref.threshold(31, 11, 1000.0, np.float64) == 878834950402048
    assert ref.threshold(31, 11, 1000.0, np.float32) == 878509790593024
    assert ref.threshold(31, 11, 1.0) == ref.M64


def test_xxh64_vectorized_equals_scalar():
    import torch

    xs = [0, 1, 12345, (1 << 22) - 1, (1 << 63) - 7, (1 << 64) - 1]
    t = torch.tensor([ref._s64(x) for x in xs], dtype=torch.int64)
    got = [(v + (1 << 64)) % (1 << 64) for v in ref.xxh64(t).tolist()]
    assert got == [ref.xxh64_int(x) for x in xs]


def _palindromic_records(rng, n_rec):
    """Tandems of a unit and its reverse complement with 5 % errors:
    windows that hold their least m-mer on both strands, where the
    reference replays the scan."""
    comp = np.zeros(256, np.uint8)
    comp[_ACGT] = np.frombuffer(b"TGCA", np.uint8)
    recs = []
    for _ in range(n_rec):
        u = _ACGT[rng.integers(0, 4, rng.integers(6, 20))]
        pal = np.concatenate([u, comp[u[::-1]]])
        n = int(rng.integers(40, 400))
        r = np.tile(pal, n // pal.size + 1)[:n].copy()
        hit = rng.random(n) < 0.05
        r[hit] = _ACGT[rng.integers(0, 4, hit.sum())]
        recs.append(r)
    return recs


@pytest.mark.parametrize("s", [1.0, 2.0, 20.0])
def test_reference_equals_program_on_repeats(tmp_path, s):
    """The CPU path of the program (whose own tests hold it to the
    goldens and the JAX package) and the reference agree where the
    strand replay is exercised."""
    from supersampler_tpu_torch.sketch import TorchSubsampler

    rng = np.random.default_rng(int(s * 7))
    recs = _palindromic_records(rng, 12)
    path = tmp_path / "pal.fa"
    path.write_bytes(b"".join(b">r%d\n" % i + r.tobytes() + b"\n"
                              for i, r in enumerate(recs)))
    seq = np.concatenate(recs)
    starts = np.cumsum([0] + [r.size for r in recs])
    replayed = []
    orig = ref._replay_strands

    def counting(*a):
        replayed.append(len(a[3]))
        return orig(*a)

    ref._replay_strands = counting
    try:
        want, kept = ref.sketch_pairs(seq, starts, 31, 11, s, 1)
    finally:
        ref._replay_strands = orig
    raw = TorchSubsampler(31, 11, s, 1, device="cpu").sketch_file(str(path))
    got, got_kept, _k, _m = decode(raw)
    assert got_kept == kept
    assert pair_gaps(got, want) == (0, 0)
    if s <= 2.0:
        assert sum(replayed) > 0


@pytest.mark.cuda
def test_reference_on_card_equals_cpu(cuda):
    rng = np.random.default_rng(3)
    seq = _ACGT[rng.integers(0, 4, 300_000)]
    starts = np.array([0, 100_000, 100_150, 300_000])
    a = ref.sketch_pairs(seq, starts, 31, 11, 50.0, 1, device="cpu")
    b = ref.sketch_pairs(seq, starts, 31, 11, 50.0, 1, device=cuda)
    assert a[1] == b[1] and np.array_equal(a[0], b[0])
