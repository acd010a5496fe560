"""The port's shared fof pipeline (sketch_fof, _SharedSketchRun) on the
CPU.

Bytes equal JAX ``sketch_fof``'s and the port's per-file
``sketch_file``'s on a mixed fof (the family goldens' inputs, a missing
entry, an empty file, a file of headers only, records that fall back to
the walker); mixed parameters split into one run each; ``on_result``
fires once per opened file, in fof order, with the item's index; tiny
chunks equal the oracle; an error in the reader, the prep pool or the
device thread fails the call and leaves no thread behind; the device
thread makes the run's device current and issues every device call.
Every comparison is byte-exact."""

import io
import threading
import time

import numpy as np
import pytest
import torch

from supersampler_tpu.oracle.subsampler import OracleSubsampler
from supersampler_tpu.sketch import pipeline as JP
from supersampler_tpu_torch.sketch import TorchSubsampler, sketch_fof
from supersampler_tpu_torch.sketch import pipeline as TP


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


def _write(path, seqs, width=70):
    with open(path, "w") as f:
        for i, seq in enumerate(seqs):
            f.write(f">rec{i}\n")
            for j in range(0, len(seq), width):
                f.write(seq[j : j + width] + "\n")
    return str(path)


def _desert_reads(path, seed=11):
    """Short reads with four records of 500 random + 3,000 T or A + 500
    random among them: each desert record falls back to the walker on
    the batch route."""
    rng = np.random.default_rng(seed)
    seqs = [_seq(rng, int(n)) for n in rng.integers(300, 1200, 40)]
    for i, at in enumerate((0, 9, 10, 30)):
        seqs.insert(at, _seq(rng, 500) + "TA"[i % 2] * 3000 + _seq(rng, 500))
    return _write(path, seqs)


def _no_spsp_threads(timeout=5.0):
    """True once no reader, prep or device thread of a run is alive."""
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if not any(t.name.startswith("spsp-") for t in threading.enumerate()):
            return True
        time.sleep(0.05)
    return False


@pytest.fixture
def mixed_fof(datadir, tmp_path):
    empty = tmp_path / "empty.fa"
    empty.write_bytes(b"")
    headers = tmp_path / "headers.fa"
    headers.write_bytes(b">a\n>b\n>c\n")
    return [datadir["fam0"], datadir["fam1"], str(tmp_path / "missing.fa"),
            str(empty), str(headers), _desert_reads(tmp_path / "desert.fa"),
            datadir["fam2"], datadir["fam3"]]


def test_sketch_fof_equals_jax_and_per_file(mixed_fof):
    s = 5.0
    sss = [TorchSubsampler(k=31, m=11, s=s, device="cpu") for _ in mixed_fof]
    for ss in sss:
        ss.log = io.StringIO()
    got = sketch_fof(list(zip(sss, mixed_fof)))
    jss = [JP.TpuSubsampler(k=31, m=11, s=s) for _ in mixed_fof]
    for ss in jss:
        ss.log = io.StringIO()
    want = JP.sketch_fof(list(zip(jss, mixed_fof)))
    alone = [TorchSubsampler(k=31, m=11, s=s, device="cpu") for _ in mixed_fof]
    for ss in alone:
        ss.log = io.StringIO()
    per_file = [ss.sketch_file(p) for ss, p in zip(alone, mixed_fof)]
    assert got == want == per_file
    assert got[2] is None and all(r is not None for i, r in enumerate(got)
                                  if i != 2)
    assert sss[2].log.getvalue() == (
        f"Problem with file opening\nCan't open file: {mixed_fof[2]}\n")
    assert all(ss.log.getvalue() == "" for i, ss in enumerate(sss) if i != 2)
    assert sss[5].fallbacks == {"tile": 0, "single": 0, "batch": 4}
    assert all(ss.fallbacks == {"tile": 0, "single": 0, "batch": 0}
               for i, ss in enumerate(sss) if i != 5)
    # the capacities are the run's, written back to every member
    opened = [ss for i, ss in enumerate(sss) if i != 2]
    assert len({(ss._sel_cap_guess, ss._batch_sel_rate)
                for ss in opened}) == 1


def test_mixed_parameters_split_into_runs(datadir, monkeypatch):
    params = [(31, 11, 5.0), (21, 7, 5.0), (31, 11, 15.0), (31, 11, 5.0),
              (21, 7, 5.0)]
    paths = [datadir[f"fam{i % 4}"] for i in range(len(params))]
    runs = []
    real_run = TP._SharedSketchRun.run

    def counted(self):
        runs.append([p for _ss, p in self.items])
        return real_run(self)

    monkeypatch.setattr(TP._SharedSketchRun, "run", counted)
    calls = []
    got = sketch_fof(
        [(TorchSubsampler(k=k, m=m, s=s, device="cpu"), p)
         for (k, m, s), p in zip(params, paths)],
        on_result=lambda idx, raw: calls.append((idx, raw)))
    assert runs == [[paths[0], paths[3]], [paths[1], paths[4]], [paths[2]]]
    assert [i for i, _ in calls] == [0, 3, 1, 4, 2]
    assert all(raw == got[i] for i, raw in calls)
    monkeypatch.setattr(TP._SharedSketchRun, "run", real_run)
    for (k, m, s), p, raw in zip(params, paths, got):
        assert raw == TorchSubsampler(k=k, m=m, s=s,
                                      device="cpu").sketch_file(p)


def test_on_result_indices_follow_fof_order(datadir, tmp_path):
    paths = [datadir["fam3"], str(tmp_path / "nope.fa"), datadir["fam0"],
             datadir["fam2"]]
    sss = [TorchSubsampler(k=31, m=11, s=15.0, device="cpu") for _ in paths]
    for ss in sss:
        ss.log = io.StringIO()
    calls = []
    got = sketch_fof(list(zip(sss, paths)),
                     on_result=lambda idx, raw: calls.append((idx, raw)))
    assert calls == [(0, got[0]), (2, got[2]), (3, got[3])]
    assert got[1] is None


def test_an_item_needs_its_own_subsampler(datadir):
    ss = TorchSubsampler(k=31, m=11, s=15.0, device="cpu")
    with pytest.raises(ValueError, match="share a subsampler"):
        sketch_fof([(ss, datadir["fam0"]), (ss, datadir["fam1"])])


class _Legacy(TorchSubsampler):
    scan_engine = "legacy"


@pytest.mark.parametrize("cls", [TorchSubsampler, _Legacy])
def test_tiny_chunks_equal_the_oracle(tmp_path, monkeypatch, cls):
    """600-byte chunks of at most 3 records (tests/test_aux.py:167-200):
    many chunks a file, more than _IN_FLIGHT at once, across a fof of
    two files; each sketch equals the whole-file oracle's."""
    rng = np.random.default_rng(5)
    paths = []
    for f in range(2):
        seqs = [_seq(rng, int(rng.integers(200, 4000))) for _ in range(9)]
        seqs.insert(4, "")
        paths.append(_write(tmp_path / f"g{f}.fa", seqs))
    monkeypatch.setattr(TP._SharedSketchRun, "_CHUNK_BYTES", 600)
    monkeypatch.setattr(TP._SharedSketchRun, "_CHUNK_RECS", 3)
    got = sketch_fof([(cls(k=31, m=11, s=5.0, device="cpu"), p)
                      for p in paths])
    for p, raw in zip(paths, got):
        oracle = OracleSubsampler(k=31, m=11, s=5.0)
        oracle.log = io.StringIO()
        assert raw == oracle.sketch_file(p)


class _Boom(RuntimeError):
    pass


@pytest.mark.parametrize("stage", ["reader", "prep", "device"])
def test_an_error_in_a_stage_fails_the_call(tmp_path, monkeypatch, stage):
    rng = np.random.default_rng(9)
    paths = [_write(tmp_path / f"f{i}.fa",
                    [_seq(rng, 500) for _ in range(12)]) for i in range(3)]
    monkeypatch.setattr(TP._SharedSketchRun, "_CHUNK_BYTES", 600)
    monkeypatch.setattr(TP._SharedSketchRun, "_CHUNK_RECS", 2)
    sss = [TorchSubsampler(k=31, m=11, s=5.0, device="cpu") for _ in paths]
    if stage == "reader":
        real = TP.stream_fasta_spans

        def stream(path, *a):
            for i, block in enumerate(real(path, *a)):
                if path == paths[1] and i == 2:
                    raise _Boom("reader")
                yield block

        monkeypatch.setattr(TP, "stream_fasta_spans", stream)
    elif stage == "prep":
        real = sss[1]._prep_chunk
        n = [0]

        def prep(data, spans):
            n[0] += 1
            if n[0] == 3:
                raise _Boom("prep")
            return real(data, spans)

        sss[1]._prep_chunk = prep
    else:
        real = TP.scan_resolve_batch
        n = [0]

        def resolve(*a, **kw):
            n[0] += 1
            if n[0] == 8:
                raise _Boom("device")
            return real(*a, **kw)

        monkeypatch.setattr(TP, "scan_resolve_batch", resolve)
    done = []

    def call():
        with pytest.raises(_Boom, match=stage):
            sketch_fof(list(zip(sss, paths)))
        done.append(True)

    t = threading.Thread(target=call)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and done == [True]
    assert _no_spsp_threads()


def test_enter_device_makes_the_card_current(monkeypatch):
    """A stand-in for torch.cuda.set_device: a CUDA device is made
    current on the calling thread, a CPU device is left alone."""
    seen = []
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda dev: seen.append((threading.get_ident(), dev)))
    TP._enter_device(torch.device("cpu"))
    TP._enter_device(torch.device("cuda:1"))
    assert seen == [(threading.get_ident(), torch.device("cuda:1"))]


def test_a_run_names_the_callers_current_card(monkeypatch):
    """A member on "cuda" runs on the card current on the calling
    thread; the device thread is told its index."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    ss = TorchSubsampler(k=31, m=11, s=15.0, device="cuda")
    assert TP._SharedSketchRun([(ss, "x.fa")]).device == torch.device(
        "cuda:1")
    ss = TorchSubsampler(k=31, m=11, s=15.0, device="cuda:0")
    assert TP._SharedSketchRun([(ss, "x.fa")]).device == torch.device(
        "cuda:0")


def test_the_device_thread_issues_every_device_call(tmp_path, monkeypatch):
    """The run enters its device on one thread, and every scan and
    resolve of the fof runs on that thread, never on the caller's."""
    rng = np.random.default_rng(4)
    paths = [_write(tmp_path / "a.fa", [_seq(rng, 400) for _ in range(5)]),
             _write(tmp_path / "b.fa", [_seq(rng, 80000)])]
    entered, calls = [], []
    real_enter = TP._enter_device
    monkeypatch.setattr(TP, "_enter_device", lambda dev: (
        entered.append((threading.get_ident(), dev)), real_enter(dev)))
    for name in ("scan_resolve_batch", "scan_resolve_single"):
        real = getattr(TP, name)

        def wrapped(*a, _real=real, _name=name, **kw):
            calls.append((_name, threading.get_ident()))
            return _real(*a, **kw)

        monkeypatch.setattr(TP, name, wrapped)
    sss = [TorchSubsampler(k=31, m=11, s=20.0, device="cpu") for _ in paths]
    sketch_fof(list(zip(sss, paths)))
    assert [dev for _, dev in entered] == [torch.device("cpu")]
    assert {name for name, _ in calls} == {"scan_resolve_batch",
                                           "scan_resolve_single"}
    assert {tid for _, tid in calls} == {entered[0][0]}
    assert entered[0][0] != threading.get_ident()
