"""The port's phase timers and device trace (supersampler_tpu_torch.
utils.profiling) on the CPU: a sketch fills every phase of the shared
run (mirrors tests/test_aux.py:104-124), ``device_trace`` does nothing
without SPSP_TRACE and writes a Chrome trace with it, and the timers
lose no update under many threads."""

import json
import sys
import threading

import numpy as np

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
