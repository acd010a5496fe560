"""Traffic that compares sketches all against all: set-up sketches the
generated genomes with the program (``sketch_fof``) and writes them
gzipped as the ``-f`` CLI does; each call is one
``TorchComparator(engine="device")`` over them, ``compare_sketches``
with every file as a query, then both CSV strings. A call's work is one
comparison.

Checked after the window: every distinct CSV the calls returned, cell
by cell, against the plain reference's, which sketches the same
generated genomes again itself."""

from __future__ import annotations

import os
import time

from benchmark.reference import compare as cref
from benchmark.reference import sketch as ref


class Entry:
    def __init__(self, ctx):
        self.ctx = ctx
        self.tool = ctx.cfg["tool"]
        self.opts = ctx.traffic["comparator"]
        self.paths = []

    def setup(self) -> None:
        from supersampler_tpu_torch.compare.merge import TorchComparator
        from supersampler_tpu_torch.io.gzip_exact import write_gzip_exact
        from supersampler_tpu_torch.sketch import TorchSubsampler, sketch_fof

        t = self.tool
        items = [(TorchSubsampler(t["k"], t["m"], t["s"], t["abundance"],
                                  device=self.ctx.device), inp.path)
                 for inp in self.ctx.inputs]
        raws = sketch_fof(items)
        for inp, raw in zip(self.ctx.inputs, raws):
            path = inp.path[: -len(".fa")] + ".sketch.gz"
            write_gzip_exact(path, raw, 9)
            self.paths.append(path)
            # the FASTA is not read again: deleted before its write-back
            os.remove(inp.path)
        self._cmp = TorchComparator

    def warmup_calls(self) -> int:
        return 1

    def call(self, i: int):
        tr = self.ctx.trace
        comp = self._cmp(precision=self.opts["precision"],
                         min_threshold=self.opts["min_threshold"],
                         engine="device", device=self.ctx.device)
        comp.files_names = list(self.paths)
        comp.compare_sketches(len(self.paths))
        t0 = time.perf_counter()
        out = (comp.containment_csv(), comp.jaccard_csv())
        if tr is not None and tr.on:
            tr.span("csv", t0, time.perf_counter())
        return out, 1

    def instrument(self, tr) -> None:
        """Spans around the comparator's decode, grouping and scoring
        (traced runs only, from the window on)."""
        from supersampler_tpu_torch.compare import merge

        for name, attr in (("decode", "decode_files"),
                           ("group", "group_pairs"),
                           ("score", "score_matrix_device")):
            fn = getattr(merge, attr)

            def spanned(*a, _fn=fn, _name=name, **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    tr.span(_name, t0, time.perf_counter())

            tr._patch(merge, attr, spanned)

    def free(self) -> None:
        self._cmp = None

    def _reference_csvs(self, **broken):
        t = self.tool
        sets = cref.file_sets(
            [ref.sketch_pairs(inp.seq, inp.starts, t["k"], t["m"], t["s"],
                              t["abundance"], device=self.ctx.device,
                              **broken)[0]
             for inp in self.ctx.inputs], t["k"])
        inter = cref.intersections(sets)
        p, mt = self.opts["precision"], self.opts["min_threshold"]
        return (cref.csv_text(self.paths, inter, p, mt, False),
                cref.csv_text(self.paths, inter, p, mt, True))

    def check(self, outputs):
        want = self._reference_csvs()
        variants = {}
        for c, out in enumerate(outputs):
            variants.setdefault(out, []).append(c)
        wrong, bad_calls = 0, 0
        for out, calls in variants.items():
            n = sum(cref.cells_wrong(g, w) for g, w in zip(out, want))
            wrong += n * len(calls)
            bad_calls += len(calls) if n else 0
        return {"csv_cells_wrong": wrong}, bad_calls

    def control(self, **broken):
        want = self._reference_csvs()
        got = self._reference_csvs(**broken)
        return {"csv_cells_wrong": sum(cref.cells_wrong(g, w)
                                       for g, w in zip(got, want))}
