"""Port sketch pipeline and CLI (supersampler_tpu_torch.sketch / .cli)
on the CPU: byte-equal to the golden sketches, the CLI goldens and the
JAX TpuSubsampler on each record route and on a mix of them (the
exact fallback engine's cases are in test_torch_fallback.py)."""

import gzip
import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from supersampler_tpu.io.fasta import read_fasta_spans
from supersampler_tpu.sketch.pipeline import TpuSubsampler
from supersampler_tpu_torch.cli import sub_sampler as cli
from supersampler_tpu_torch.sketch import TorchSubsampler

_GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
with open(os.path.join(_GOLD, "meta.json")) as _f:
    _SKETCHES = json.load(_f)["sketches"]


@pytest.mark.parametrize("cfg", _SKETCHES, ids=[c["file"] for c in
                                                 _SKETCHES])
def test_golden_sketch_on_cpu(cfg, datadir, goldendir):
    with gzip.open(os.path.join(goldendir, cfg["file"]), "rb") as f:
        golden = f.read()
    ss = TorchSubsampler(k=cfg["k"], m=cfg["m"],
                         s=float(np.float32(cfg["s"])), abundance=cfg["a"],
                         device="cpu")
    assert ss.sketch_file(datadir[cfg["dataset"]]) == golden


def test_cli_single_file_parity(datadir, goldendir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TORCH_DEVICE", "cpu")
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli.main(["-i", datadir["simple"], "-s", "10", "-p", "cli_"])
    assert rc == 0
    with open(os.path.join(goldendir, "cli_sub_sampler_stdout.txt")) as f:
        assert buf.getvalue() == f.read()
    with open(os.path.join(goldendir, "cli_simple.gz"), "rb") as f:
        assert (tmp_path / "cli_simple.gz").read_bytes() == f.read()


def test_cli_fof_parity(datadir, goldendir, tmp_path, monkeypatch):
    """-f: per-file sketches equal the golden runs, the out-fof and the
    per-file stdout blocks keep fof order, an unreadable entry reports
    the reference's messages in place."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TORCH_DEVICE", "cpu")
    entries = [datadir[f"fam{i}"] for i in range(4)]
    entries.insert(2, str(tmp_path / "missing.fa"))
    (tmp_path / "fof.txt").write_text("\n".join(entries) + "\n")
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli.main(["-f", str(tmp_path / "fof.txt"), "-s", "15", "-t",
                       "4", "-p", "g_"])
    assert rc == 0
    for i in range(4):
        with open(os.path.join(goldendir, f"gfam_fam{i}.gz"), "rb") as f:
            assert (tmp_path / f"g_fam{i}.gz").read_bytes() == f.read(), i
    assert (tmp_path / "g_fof.txt").read_text().splitlines() == [
        "g_fam0.gz", "g_fam1.gz", "g_missing.gz", "g_fam2.gz", "g_fam3.gz"]
    out = buf.getvalue()
    idx = [out.index(p) for p in entries]
    assert idx == sorted(idx)
    assert f"Problem with file opening\nCan't open file: {entries[2]}" in out


def test_cli_raises_when_cuda_is_absent(datadir, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.setenv("TORCH_DEVICE", "cuda")
    with pytest.raises(RuntimeError, match="TORCH_DEVICE"):
        cli.main(["-i", datadir["simple"]])


def _write_fasta(path, seqs, width: int = 80):
    with open(path, "w") as f:
        for i, seq in enumerate(seqs):
            f.write(f">rec{i}\n")
            for j in range(0, len(seq), width):
                f.write(seq[j : j + width] + "\n")


def _random_seq(seed, n):
    rng = np.random.default_rng(seed)
    return "".join("ACGT"[c] for c in rng.integers(0, 4, n))


class _TpuSmallTiles(TpuSubsampler):
    _tile_own = 2048
    _SHORT_MAX = 1024


class _TorchSmallTiles(TorchSubsampler):
    _tile_own = 2048
    _SHORT_MAX = 1024


@pytest.mark.parametrize("routes,lens,s", [
    # 2,048-position tiles: 5 tiles
    ("multi_tile", [9000], 20.0),
    ("multi_tile", [9000], 1.0),
    # over _SHORT_MAX at the default tile
    ("single_tile", [70000], 10.0),
    # all three routes and a record shorter than k, interleaved: the
    # finisher must see them in record order
    ("mixed", [600, 3000, 20, 9000, 800], 5.0),
])
def test_port_bytes_equal_jax_pipeline(routes, lens, s, tmp_path):
    path = str(tmp_path / "recs.fa")
    _write_fasta(path, [_random_seq(n + i, n) for i, n in enumerate(lens)])
    small = routes != "single_tile"
    jax_cls = _TpuSmallTiles if small else TpuSubsampler
    port = (_TorchSmallTiles if small else TorchSubsampler)(
        k=31, m=11, s=s, device="cpu")
    taken = set()
    for a, b in read_fasta_spans(path)[1]:
        if b - a + port._margin <= port._SHORT_MAX:
            taken.add("short")
        else:
            taken.add("multi_tile" if port._plan_geometry(b - a)[1] > 1
                      else "single_tile")
    assert taken == ({"short", "single_tile", "multi_tile"}
                     if routes == "mixed" else {routes})
    want = jax_cls(k=31, m=11, s=s).sketch_file(path)
    assert port.sketch_file(path) == want
