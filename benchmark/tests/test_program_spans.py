"""The readers of the program's own spans and counters
(benchmark/spans.py): the self-time arithmetic on made-up nested spans,
the idle share inside a call that no layer names, a program that records none (an older
one: every reader is silent and none raises), and a tiny traced CPU run
of the comparison cell in which every such metric reads a number, but
the device's idle share, which the CPU trace cannot see."""

import json
import os

import pytest
import torch

from benchmark import run, spans
from benchmark.tests import tiny
from supersampler_tpu_torch.utils import profiling
from supersampler_tpu_torch.utils.profiling import Count, Span

CPU = torch.device("cpu")
SEED = 2 ** 31 + 4242
CELL = "bact_genomes.allvsall100"
NEW = ("decode.read.s_per_compare", "decode.pass.s_per_compare",
       "group.sort.s_per_compare",
       "csv.s_per_compare", "score.h2d_mb_per_compare",
       "decode.pairs_per_window", "device.idle_pct.outside_spans")


class _Trace:
    def __init__(self, events):
        self.events = events

    def busy(self, t0, t1):
        merged = [[max(a, t0), min(b, t1)] for a, b, _n in self.events]
        return sum(b - a for a, b in merged), merged


class _Run:
    def __init__(self, t0, t1, n_calls, events=()):
        self.t0, self.t1 = t0, t1
        self.calls = [(0, 0, 1)] * n_calls
        self.trace = _Trace(list(events))


class _Timers:
    def __init__(self, spans_, counters_, dropped=0):
        self._s, self._c, self.dropped = spans_, counters_, dropped

    def spans(self):
        return list(self._s)

    def counters(self):
        return list(self._c)


# one call on thread 1: a root [0, 10] with children a [1, 4] and b
# [3, 6] (overlapping) and c [8, 9]; a has a child d [2, 3]; a span on
# thread 2 that names the root as parent is not the root's child there;
# a second root [11, 12]; one span and one counter outside the window
_SPANS = [Span("root", 0.0, 10.0, 1, 1, None, 1),
          Span("a", 1.0, 4.0, 1, 2, 1, 1),
          Span("b", 3.0, 6.0, 1, 3, 1, 1),
          Span("c", 8.0, 9.0, 1, 4, 1, 1),
          Span("d", 2.0, 3.0, 1, 5, 2, 1),
          Span("other", 5.0, 7.0, 2, 6, 1, 1),
          Span("root", 11.0, 12.0, 1, 7, None, 7),
          Span("late", 30.0, 31.0, 1, 8, None, 8)]
_COUNTS = [Count("n", 3, 2.0, 1, 1), Count("n", 4, 11.5, 1, 7),
           Count("n", 100, 30.5, 1, 8), Count("m", 1, 5.0, 1, 1)]


@pytest.fixture
def fake(monkeypatch):
    monkeypatch.setattr(profiling, "timers", _Timers(_SPANS, _COUNTS))


def test_covered_is_the_union_clipped():
    assert spans.covered([(1, 4), (3, 6), (8, 9)]) == 6
    assert spans.covered([(1, 4), (2, 3)], 0, 10) == 3
    assert spans.covered([(1, 4), (3, 6), (8, 12)], 2, 10) == 6
    assert spans.covered([(-3, -1), (20, 30)], 0, 10) == 0
    assert spans.covered([]) == 0


def test_self_seconds_of_nested_spans():
    got = spans.self_seconds(_SPANS)
    # root: 11 s of roots less a, b and c's union (1-6, 8-9) on thread 1
    assert got == {"root": 11.0 - 6.0, "a": 3.0 - 1.0, "b": 3.0,
                   "c": 1.0, "d": 1.0, "other": 2.0, "late": 1.0}


def test_readers_cut_to_the_window(fake):
    r = _Run(0.0, 12.0, 2)
    assert spans.self_s_per_call(r, "root") == pytest.approx(2.5)
    assert spans.self_s_per_call(r, "late") is None
    assert spans.self_s_per_call(r, "missing") is None
    assert spans.counter_total(r, "n") == 7
    assert spans.counter_total(r, "m") == 1
    assert spans.counter_total(r, "missing") is None


def test_union_of_intervals():
    assert spans.union([(3, 6), (1, 4), (8, 9)]) == [(1, 6), (8, 9)]
    assert spans.union([(1, 4), (4, 5), (8, 12)], 2, 10) == [(2, 5),
                                                             (8, 10)]
    assert spans.union([(-3, -1)], 0, 10) == []


def test_idle_outside_spans(fake):
    """Only the first root has spans below it: its body 0-10 less its
    layers' 1-7 (a, b and the other thread's span) and 8-9 leaves 3 s;
    the device's 0.5-0.7 falls in it, its 10.2-10.4 between calls and
    the leaf root 11-12 are not counted."""
    r = _Run(0.0, 12.0, 2, [(0.5, 0.7, "k"), (10.2, 10.4, "k")])
    want = 100.0 * (3.0 - 0.2) / 12.0
    assert spans.idle_outside_spans_pct(r) == pytest.approx(want)
    assert spans.idle_outside_spans_pct(_Run(0.0, 12.0, 2)) is None


def test_a_full_or_missing_buffer_reads_nothing(monkeypatch):
    r = _Run(0.0, 12.0, 2, [(10.2, 10.4, "k")])
    monkeypatch.setattr(profiling, "timers",
                        _Timers(_SPANS, _COUNTS, dropped=1))
    assert spans.program(r) is None
    monkeypatch.setattr(profiling, "timers", profiling.PhaseTimers())
    assert spans.program(r) is None


def test_a_program_without_spans_reads_nothing(monkeypatch):
    """The parent's program has timers without spans or counters: each
    new reader returns None and raises nothing."""

    class Old:
        totals, counts = {}, {}

    monkeypatch.setattr(profiling, "timers", Old())
    r = _Run(0.0, 12.0, 2, [(10.2, 10.4, "k")])
    for name in NEW:
        assert run.reader(tiny.REPO, name)(r) is None, name


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(str(tmp_path_factory.mktemp("bench")))


def test_new_metrics_are_in_the_benchmark():
    with open(os.path.join(tiny.REPO, "BENCHMARK.json")) as f:
        per_layer = {m["name"]: m for m in json.load(f)["per_layer"]}
    for name in NEW:
        assert per_layer[name]["workloads"] == [CELL]
        assert per_layer[name]["moves"] == "compare_s"


def test_tiny_traced_comparison_reads_every_new_metric(root):
    r = run.run_cell(root, CELL, SEED, 0.3, 1, CPU)
    assert r["correct"]
    got = {k: v["value"] for k, v in r["metrics"].items()}
    for name in NEW:
        if "idle_pct" in name:
            # the CPU trace holds no device operation
            assert name not in got
        else:
            assert got[name] > 0, name
    assert got["decode.pairs_per_window"] <= 1
    parts = sum(got[f"decode.{p}.s_per_compare"]
                for p in ("read", "pass"))
    # the children sit inside the entry's own span around the decode
    assert parts < got["decode.s_per_compare"]
    assert got["group.sort.s_per_compare"] < got["group.s_per_compare"]
