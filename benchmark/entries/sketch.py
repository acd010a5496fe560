"""Traffic that sketches FASTA files: each call sketches
``files_per_call`` of the generated files, taken in turn, with fresh
subsamplers at the configuration's parameters, through ``sketch_fof``
or, for one file, ``TorchSubsampler.sketch_file``. A call's work is the
bases of its files.

Checked after the window: every sketch a call returned, each distinct
one decoded into its (minimizer, k-mer) pairs and its kept count and
held to the plain reference's sketch of the same generated records."""

from __future__ import annotations

import numpy as np

from benchmark.reference import sketch as ref
from benchmark.reference.sketchfile import decode, pair_gaps


class Entry:
    def __init__(self, ctx):
        self.ctx = ctx
        self.tool = ctx.cfg["tool"]
        self.per_call = ctx.traffic["files_per_call"]
        self.use_fof = ctx.traffic["call"] == "sketch_fof"

    def setup(self) -> None:
        from supersampler_tpu_torch.sketch import TorchSubsampler, sketch_fof
        self._ss, self._fof = TorchSubsampler, sketch_fof

    def warmup_calls(self) -> int:
        """Calls that sketch every file once: every shape of the window."""
        return -(-len(self.ctx.inputs) // self.per_call)

    def call(self, i: int):
        inputs = self.ctx.inputs
        t = self.tool
        idx = [(i * self.per_call + j) % len(inputs)
               for j in range(self.per_call)]
        sss = [self._ss(t["k"], t["m"], t["s"], t["abundance"],
                        device=self.ctx.device) for _ in idx]
        if self.use_fof:
            outs = self._fof([(ss, inputs[j].path) for ss, j in zip(sss, idx)])
        else:
            outs = [sss[0].sketch_file(inputs[idx[0]].path)]
        return list(zip(idx, outs)), sum(inputs[j].bases for j in idx)

    def free(self) -> None:
        self._ss = self._fof = None

    def reference(self, j: int, **broken):
        t = self.tool
        inp = self.ctx.inputs[j]
        return ref.sketch_pairs(inp.seq, inp.starts, t["k"], t["m"], t["s"],
                                t["abundance"], device=self.ctx.device,
                                **broken)

    def check(self, outputs):
        """({number: value}, failed calls)."""
        variants = {}                 # file -> {sketch bytes: [calls]}
        for c, out in enumerate(outputs):
            for j, raw in out:
                variants.setdefault(j, {}).setdefault(raw, []).append(c)
        nums = {"sketches_missing": 0, "pairs_missing": 0, "pairs_extra": 0,
                "kept_count_gap": 0}
        bad_calls = set()
        for j in sorted(variants):
            want, kept = self.reference(j)
            for raw, calls in variants[j].items():
                if raw is None:
                    nums["sketches_missing"] += len(calls)
                    bad_calls.update(calls)
                    continue
                try:
                    got, got_kept, _k, _m = decode(raw)
                except (ValueError, IndexError) as e:
                    self.ctx.log(f"file {j}: sketch unreadable: {e}")
                    got, got_kept = np.zeros((0, 2), np.int64), -1
                miss, extra = pair_gaps(got, want)
                gap = abs(got_kept - kept)
                nums["pairs_missing"] += miss * len(calls)
                nums["pairs_extra"] += extra * len(calls)
                nums["kept_count_gap"] += gap * len(calls)
                if miss or extra or gap:
                    bad_calls.update(calls)
        return nums, len(bad_calls)

    def control(self, **broken):
        """The check's numbers for the reference, broken as ``broken``
        says (sketch_pairs' thr or canonical), put in the program's
        place, over every file of the cell."""
        nums = {"sketches_missing": 0, "pairs_missing": 0, "pairs_extra": 0,
                "kept_count_gap": 0}
        for j in range(len(self.ctx.inputs)):
            want, kept = self.reference(j)
            got, got_kept = self.reference(j, **broken)
            miss, extra = pair_gaps(got, want)
            nums["pairs_missing"] += miss
            nums["pairs_extra"] += extra
            nums["kept_count_gap"] += abs(got_kept - kept)
        return nums
