"""All-vs-all / N-vs-all sketch comparison over decoded pair sets.

Semantic model (provably equivalent to the reference's streaming N-way
merge, Comparator.cpp:39-74 + 97-287):

* nb_kmer_seen_infile[f] = |distinct (minimizer, canonical k-mer) pairs
  of file f| — the per-bucket skip/color maps dedup within a bucket and
  buckets are unique per file (std::map keys), so summing per-bucket
  distinct counts equals the global pair-set size.
* score_A[i,j] = number of distinct pairs present in both i and j,
  restricted (query mode) to buckets whose minimizer is held by at
  least one query file (Comparator.cpp:340-351: only `queryfound`
  buckets run count_intersection; within such buckets ALL co-occurring
  file pairs are scored, compute_scores Comparator.cpp:269-287).

The array implementation decodes every file's pairs in file order,
groups identical pairs across files (parallel/compare_dist.py
group_pairs: one native pass that orders each file's slices of one
minimizer by minimizer and sorts each minimizer's k-mers stably, which
needs file ids that never descend) and accumulates pairwise counts, either
on the host ("numpy") or as the presence matmul S = P^T P on a torch
device ("device"), on one device or over a mesh (parallel/mesh.py).
Counterpart of supersampler_tpu/compare/merge.py.

Under a torch.profiler session each comparison records its spans on
utils/profiling.py's tracer: the root ``compare.call`` (with
``device_trace("compare")`` around it), ``compare.open``,
``compare.decode`` (parallel/compare_dist.py; for whole sketches one
``decode.read``, the native read of every file, and for whole sketches
and each chunk one ``decode.pass``, the native pass over every window;
counters ``decode.read.threads``, ``decode.inflated_bytes``,
``decode.pass.threads``, ``decode.windows``, ``decode.pairs``),
``compare.group`` (``group.sort``, the native grouping pass; counter
``group.runs``), ``compare.score``
(``score.h2d``, ``score.product``, ``score.fetch``), ``compare.tally``,
and ``compare.csv`` for each CSV.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, List, Optional, Set

import numpy as np

from supersampler_tpu_torch import default_device
from supersampler_tpu_torch.compare.stream import BucketStream, chunk_rounds
from supersampler_tpu_torch.compare.writers import (matrix_csv,
                                                    write_matrix_gz)
from supersampler_tpu_torch.io.fasta import read_fof
from supersampler_tpu_torch.parallel.compare_dist import (
    decode_files, decode_windows, group_pairs, score_matrix_device,
    scores_to_dict)
from supersampler_tpu_torch.parallel.mesh import make_mesh
from supersampler_tpu_torch.utils.profiling import device_trace, phase

ENGINES = ("numpy", "device")


def pair_scores_numpy(gid: np.ndarray, fids: np.ndarray,
                      n: int) -> Dict[int, int]:
    """The numpy engine: {i * n + j: pairs shared by files i < j} from
    grouped pairs (group_pairs' order), enumerated on the host."""
    counts = np.bincount(gid)
    # only groups with >= 2 files contribute scores
    big = counts >= 2
    if not big.any():
        return {}
    sel = big[gid]
    gid_sel = gid[sel]  # non-decreasing (group_pairs' order kept)
    # ascending within each group (group_pairs visits files in order);
    # int64, so that the keys i * n + j cannot overflow
    fid_sel = fids[sel].astype(np.int64)
    _, gstart, gcount = np.unique(gid_sel, return_index=True,
                                  return_counts=True)
    # vectorized pairwise accumulation: within a group every file id
    # is distinct and sorted, so enumerate ordered pairs by local
    # distance d (bounded by nb_files) instead of a per-group loop
    starts = np.repeat(gstart, gcount)
    counts_per_elem = np.repeat(gcount, gcount)
    local = np.arange(fid_sel.size) - starts
    keys_all = []
    max_c = int(gcount.max())
    for d in range(1, max_c):
        a = np.nonzero(local + d < counts_per_elem)[0]
        if a.size == 0:
            break
        keys_all.append(fid_sel[a] * n + fid_sel[a + d])
    if not keys_all:
        return {}
    uniq, cnt = np.unique(np.concatenate(keys_all), return_counts=True)
    return dict(zip(uniq.tolist(), cnt.tolist()))


def _comparison(method):
    """Run a comparison method as the root span ``compare.call``, under
    ``device_trace("compare")``."""
    @functools.wraps(method)
    def traced(*args, **kwargs):
        with device_trace("compare"), phase("compare.call"):
            return method(*args, **kwargs)
    return traced


class TorchComparator:
    """Drop-in equivalent of the reference Comparator (same outputs as
    the JAX package's TpuComparator).

    engine selects the pairwise-scoring backend once the decoded pairs
    are grouped: "device" (the default) runs the presence matmul
    S = P^T P over the entries of ``mesh``, or on the one ``device``
    given in its place (default: ``default_device()``, the card unless
    $TORCH_DEVICE says otherwise; it raises when CUDA is asked for and
    absent); "numpy" enumerates co-occurrence pairs on the host. Both
    produce identical score_A.
    """

    def __init__(self, precision: int = 6, min_threshold: float = 0.0,
                 engine: str = "device", device=None, mesh=None):
        if engine not in ENGINES:
            raise ValueError(f"engine {engine!r} is not one of {ENGINES}")
        if mesh is not None and engine != "device":
            raise ValueError("a mesh needs the device engine")
        if mesh is not None and device is not None:
            raise ValueError("give a device or a mesh, not both")
        self.precision = precision
        self.min_threshold = min_threshold
        self.engine = engine
        if engine == "device" and mesh is None:
            mesh = make_mesh([default_device() if device is None
                              else device])
        self.mesh = mesh
        self.files_names: List[str] = []
        self.score_A: Dict[int, int] = {}
        self.nb_kmer_seen_infile: List[int] = []
        self.query_size = 0
        self.nb_files = 0
        self.k = 0
        self.m = 0

    @staticmethod
    def getfilesname(fof_path: str) -> List[str]:
        """fof lines with size > 2 (reference Comparator.cpp:7-21)."""
        return read_fof(fof_path, min_len=2)

    def _open_files(self) -> List[str]:
        # Unopenable sketches print the reference's message and drop out
        # of the comparison; surviving files take compacted indices
        # (reference Comparator.cpp:45-51 + utils.cpp:357-364).
        with phase("compare.open"):
            opened: List[str] = []
            for path in self.files_names:
                try:
                    with open(path, "rb"):
                        pass
                except OSError:
                    print("Problem with file opening")
                    continue
                opened.append(path)
            return opened

    @_comparison
    def compare_sketches(self, query_size: int) -> None:
        opened = self._open_files()
        mins, his, los, fids, nb_seen, k, m, qmins = decode_files(
            opened, query_size)
        if opened:
            # like get_header_info, the last file's header wins
            self.k, self.m = k, m
        self.score_decoded(mins, his, los, fids, nb_seen, query_size, qmins)

    @_comparison
    def compare_sketches_chunked(self, query_size: int,
                                 chunk_bytes: int = 64 << 20,
                                 resume_path: Optional[str] = None,
                                 max_chunks: Optional[int] = None
                                 ) -> bool:
        """Bounded-memory comparison: stream the N-way bucket merge in
        minimizer-range chunks of ~chunk_bytes payload, scoring each
        chunk as it decodes (reference Comparator.cpp:39-74 holds only
        open buckets; this holds only one chunk). Produces identical
        score_A / nb_kmer_seen_infile to compare_sketches — every
        minimizer's buckets land in exactly one chunk, so per-chunk
        grouping and dedup equal global.

        resume_path: shard-resumable comparison — after every chunk the
        per-file byte offsets + partial scores persist atomically; a
        restart skips completed chunks by seeking. The manifest is
        deleted on completion. max_chunks stops early (testing /
        cooperative preemption), leaving the manifest.

        Returns True when the comparison completed."""
        opened = self._open_files()
        n = self.nb_files = len(opened)
        self.query_size = query_size
        if n == 0:
            return True
        streams = [BucketStream(p) for p in opened]
        self.k, self.m = streams[-1].k, streams[-1].m
        self.nb_kmer_seen_infile = [0] * n
        start_chunk = 0
        if resume_path and os.path.exists(resume_path):
            with open(resume_path) as f:
                man = json.load(f)
            if man.get("files") != opened:
                raise ValueError(
                    "resume manifest does not match the file list")
            start_chunk = man["chunk_idx"]
            for st, off in zip(streams, man["offsets"]):
                st.offset = off
            self.score_A = {int(key): v
                            for key, v in man["score_A"].items()}
            self.nb_kmer_seen_infile = list(man["nb_seen"])
        self.max_chunk_pairs = 0
        done = True
        for idx, chunk, offsets in chunk_rounds(streams, chunk_bytes):
            # every window decodes with the last file's header
            mins, his, los, fids, nb_seen, _k, _m, qmins = decode_windows(
                (None if w is None else w + (self.k, self.m)
                 for w in chunk), n, query_size)
            for f, seen in enumerate(nb_seen):
                self.nb_kmer_seen_infile[f] += seen
            self.max_chunk_pairs = max(self.max_chunk_pairs, int(mins.size))
            self._score_pairs(mins, his, los, fids, query_size, qmins)
            if resume_path:
                tmp = resume_path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump({
                        "files": opened,
                        "chunk_idx": start_chunk + idx + 1,
                        "offsets": offsets,
                        "score_A": {str(key): v for key, v
                                    in self.score_A.items()},
                        "nb_seen": self.nb_kmer_seen_infile,
                    }, f)
                os.replace(tmp, resume_path)
            if max_chunks is not None and idx + 1 >= max_chunks:
                done = all(st.exhausted() for st in streams)
                break
        if done and resume_path and os.path.exists(resume_path):
            os.remove(resume_path)
        return done

    def score_decoded(self, mins, his, los, fids, nb_seen: List[int],
                      query_size: int,
                      query_minimizers: Optional[Set[int]]) -> None:
        """Score the decoded pairs of every compared file, as
        decode_files gives them: (minimizer, k-mer, file) pair arrays in
        file order, the pair count for each file, the query size and
        the query minimizers (None: no filter). The post-decode half of
        compare_sketches and of the multi-process comparison
        (parallel/dist.py)."""
        self.nb_files = len(nb_seen)
        self.query_size = query_size
        self.nb_kmer_seen_infile = list(nb_seen)
        self._score_pairs(mins, his, los, fids, query_size,
                          query_minimizers)

    def _score_pairs(self, mins, his, los, fids, query_size: int,
                     query_minimizers: Optional[Set[int]]) -> None:
        """Score decoded (minimizer, k-mer, file) pair arrays of the
        self.nb_files files: the whole comparison or one chunk of it.
        query_minimizers (query mode) filters the buckets scored."""
        n = self.nb_files
        if mins.size == 0:
            return
        gid, fids = group_pairs(mins, his, los, fids, query_minimizers)
        if gid.size == 0:
            return
        if self.engine == "device":
            score = score_matrix_device(gid, fids, int(gid[-1]) + 1, n,
                                        self.mesh)
        else:
            with phase("compare.score"):
                add = pair_scores_numpy(gid, fids, n)
        with phase("compare.tally"):
            if self.engine == "device":
                add = scores_to_dict(score, query_size)
            for key, v in add.items():
                self.score_A[key] = self.score_A.get(key, 0) + v

    # ------------------------------------------------------------------
    def _header_names(self) -> List[str]:
        """The reference prints files_names[0..nb_files) even when a
        failed open compacted the data indices (Comparator.cpp:365-372
        never re-syncs names) — replicated verbatim."""
        n = self.nb_files or len(self.files_names)
        return self.files_names[:n]

    def _csv(self, jaccard: bool) -> str:
        with phase("compare.csv"):
            return matrix_csv(self._header_names(), self.score_A,
                              self.nb_kmer_seen_infile, self.query_size,
                              self.precision, self.min_threshold,
                              jaccard=jaccard)

    def containment_csv(self) -> str:
        return self._csv(jaccard=False)

    def jaccard_csv(self) -> str:
        return self._csv(jaccard=True)

    def write_outputs(self, output_name: str = "results") -> None:
        write_matrix_gz(f"{output_name}_containment.csv.gz",
                        self.containment_csv())
        write_matrix_gz(f"{output_name}_jaccard.csv.gz", self.jaccard_csv())
