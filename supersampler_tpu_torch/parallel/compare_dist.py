"""All-vs-all comparison as a presence matmul on a device or a mesh.

Scoring model: let G be the number of distinct (minimizer, k-mer) pairs
observed across all N sketches and Pm the (G, N) 0/1 presence matrix.
Then S = Pm^T Pm has S[i,j] = |pairs shared by files i and j| (the
reference's score_A, Comparator.cpp:269-287) and S[i,i] =
nb_kmer_seen_infile[i]. Pair-rows are tiled into steps; each step's
int8 presence block is built on the device from its (group, file)
coordinates and multiplied into an integer total. With a mesh
(parallel/mesh.py) a step's groups are cut into one slice per entry,
each entry keeps its own block and total, and one sum of the totals at
the end merges them.

Counterpart of supersampler_tpu/parallel/compare_dist.py: the product,
an XLA ``jnp.dot`` there, is ``torch._int_mm`` here (cuBLASLt's int8 x
int8 -> int32 path on CUDA), exact in integers; the final sum stands in
for the JAX mesh's all-reduce.

Decoding (decode_windows) is the comparator's one way from sketch bytes
to pairs: whole sketches (decode_files: one native read of every file,
then the pass), a chunk's byte windows or the gloo process's own files
go through one native pass, compare/reader.py's ``decode_pass``, which
shares the windows out over up to 8 threads and writes every pair into
one set of concatenated arrays.

Grouping (group_pairs) is one native pass over the decoded pairs: it
cuts them into slices of one file and one minimizer, orders the slices
by minimizer (file order kept) and sorts each minimizer's few hundred
k-mers stably, minimizers shared out over up to 8 threads; it needs the
files' pairs in file order, which the decode gives.

Spans and counters (utils/profiling.py, in a profiler session): in each
``compare.decode``, one ``decode.read`` (whole sketches only) and one
``decode.pass``, with the counters compare/reader.py gives them
(``decode.read.threads``, ``decode.inflated_bytes``,
``decode.pass.threads``, ``decode.windows``, ``decode.pairs``);
``group.runs`` (the runs the grouping found: one per sketch whose
buckets are in order) and ``score.h2d_bytes``.
"""

from __future__ import annotations

from bisect import bisect_left
from typing import Dict, List, Optional, Set

import numpy as np
import torch

from supersampler_tpu_torch.compare.reader import decode_pass, read_sketches
from supersampler_tpu_torch.native import group_pairs_native
from supersampler_tpu_torch.parallel.mesh import Mesh
from supersampler_tpu_torch.utils.profiling import count, phase


def decode_windows(windows, n: int, query_size: Optional[int]):
    """Decode the windows of n sketches into one set of pair arrays, in
    file order, in one native pass: the comparator's one way from sketch
    bytes to pairs.

    windows gives, for each file in turn, None when the file has no
    bucket to decode or its window (data, pos0, end, k, m) (see
    compare/reader.py); it is drawn from inside ``compare.decode``, and
    the data of each window is kept until the pass has run.
    Returns (mins, his, los, file ids int64, per-file pair counts, k, m,
    query minimizers). The last window gives k and m. The query
    minimizers are the bucket minimizers of files [0, query_size), or
    None when query_size is None or covers every file (all-vs-all: no
    filter).
    """
    with phase("compare.decode"):
        query = query_size is not None and query_size < n
        kept = [(f, w) for f, w in enumerate(windows) if w is not None]
        files = [f for f, _w in kept]
        got = decode_pass([w for _f, w in kept], files,
                          bisect_left(files, query_size) if query else 0)
        nb_seen = [0] * n
        for f, pairs in zip(files, got.pairs.tolist()):
            nb_seen[f] = pairs
        k, m = kept[-1][1][3:] if kept else (0, 0)
        return (got.mins, got.his, got.los, got.fids, nb_seen, k, m,
                set(got.bmins.tolist()) if query else None)


def decode_files(files: List[str], query_size: int = None):
    """Decode whole sketches, all read in one native call when
    decode_windows draws the first window: decode_windows' result."""
    def windows():
        yield from read_sketches(files)
    return decode_windows(windows(), len(files), query_size)


def group_pairs(mins, his, los, fids,
                query_minimizers: Optional[Set[int]] = None):
    """Group decoded (minimizer, k-mer, file) pairs by (minimizer, k-mer).

    Drops the pairs of buckets no query file holds when query_minimizers
    is given (query mode), then numbers the groups in one native pass
    (native.py ``group_pairs_native``) that uses the decode's order in
    place of a sort: file ids must never descend, so each file's pairs
    are one stretch, as decode_files and every chunk of
    compare_sketches_chunked give them (the query filter keeps order);
    a stretch of one file with non-decreasing minimizers is a run, one
    per sketch whose buckets are in order. Raises ValueError naming the
    position where file ids descend. Returns (group ids int32, file ids
    int32) in (minimizer, k-mer, file) order: group ids are
    non-decreasing and file ids ascend within a group."""
    with phase("compare.group"):
        if query_minimizers is not None:
            qm = np.array(sorted(query_minimizers), dtype=np.uint64)
            keep = np.isin(mins, qm)
            mins, his, los, fids = (mins[keep], his[keep], los[keep],
                                    fids[keep])
        with phase("group.sort"):
            gids, fids, runs = group_pairs_native(mins, his, los, fids)
        count("group.runs", runs)
    return gids, fids


def build_presence_chunks(files: List[str], query_size: int = None):
    """Decode sketches and build group/file presence coordinates.

    Returns (group_ids int32[], file_ids int32[], n_groups, per-file
    pair counts, k, m). Groups = distinct (minimizer, kmer) pairs
    (query-mode bucket filtering applied to scoring groups only).
    """
    mins, his, los, fids, nb_seen, k, m, qmins = decode_files(files,
                                                             query_size)
    gids, fids = group_pairs(mins, his, los, fids, qmins)
    n_groups = int(gids[-1]) + 1 if gids.size else 0
    return gids, fids, n_groups, nb_seen, k, m


def padded_files(n_files: int) -> int:
    """File-axis width of a presence block: ``torch._int_mm`` on CUDA
    needs more than 16 rows in its first operand and inner and column
    sizes that are multiples of 8. Zero columns score zero."""
    return max(24, -(-n_files // 8) * 8)


def step_groups(n_groups: int, n_files: int, chunk_groups: int = 1 << 18,
                n_dev: int = 1) -> int:
    """Groups a mesh entry takes per step of score_matrix_device, chosen
    as the JAX package chooses them (compare_dist.py:121-123):
    everything in one step when a step's blocks fit ~128 MB, else
    chunk_groups; a power of two of at least 4,096."""
    chunk_groups = min(chunk_groups, -(-n_groups // n_dev),
                       max(4096, (128 << 20) // (n_files * n_dev)))
    return 1 << max(12, (chunk_groups - 1).bit_length())


def presence_product(block: torch.Tensor) -> torch.Tensor:
    """block @ block.T of one (n_pad, rows) int8 presence block, int32.

    Both operands keep the group (inner) axis contiguous. On CUDA this
    is one cuBLASLt launch, counted in ``presence_product.launches``;
    on the CPU the same call, which has no shape rules there."""
    if block.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no int8 product for device {block.device}")
    out = torch._int_mm(block, block.T)
    if block.device.type == "cuda":
        presence_product.launches += 1
    return out


presence_product.launches = 0


def score_matrix_device(gids: np.ndarray, fids: np.ndarray, n_groups: int,
                        n_files: int, mesh: Mesh,
                        chunk_groups: int = 1 << 18) -> np.ndarray:
    """Accumulate S = Pm^T Pm over group-steps on the entries of ``mesh``
    (one device is a mesh of one).

    A step covers step_groups(...) groups per mesh entry; the d-th slice
    of each step goes to entry d. Each slice's (group, file) coordinates
    are copied to the entry's device (two int32 a pair; gids must be
    sorted, which the grouping construction guarantees) and scattered as
    ones into that entry's own zeroed (n_pad, rows) int8 block, so the
    host link carries 8 bytes a pair rather than the dense block. Each entry keeps its own block and
    int64 total (two entries may name the same device); the totals are
    summed once, on the first entry's device, at the end. The result
    depends neither on the mesh nor on the step size. Returns the N x N
    int64 score matrix on the host."""
    with phase("compare.score"):
        devices = mesh.devices
        if n_groups == 0 or fids.size == 0:
            return np.zeros((n_files, n_files), dtype=np.int64)
        n_dev = len(devices)
        chunk_groups = step_groups(n_groups, n_files, chunk_groups, n_dev)
        n_slices = -(-n_groups // chunk_groups)
        n_pad = padded_files(n_files)
        # gids are sorted: one searchsorted gives every slice's pairs
        edges = np.searchsorted(gids, np.arange(n_slices + 1) * chunk_groups)
        blocks = [torch.empty((n_pad, chunk_groups), dtype=torch.int8,
                              device=dev) for dev in devices]
        ones = [torch.ones((), dtype=torch.int8, device=dev)
                for dev in devices]
        totals = [torch.zeros((n_pad, n_pad), dtype=torch.int64, device=dev)
                  for dev in devices]
        # slice i is entry i % n_dev's part of step i // n_dev; the last
        # step's entries past the groups multiply zero blocks, as JAX's do
        for i in range(-(-n_slices // n_dev) * n_dev):
            d = i % n_dev
            s, e = (int(edges[min(i, n_slices)]),
                    int(edges[min(i + 1, n_slices)]))
            dev = devices[d]
            with phase("score.h2d"):
                rows = torch.from_numpy(gids[s:e] - i * chunk_groups).to(dev)
                cols = torch.from_numpy(fids[s:e]).to(dev)
            count("score.h2d_bytes", rows.nbytes + cols.nbytes)
            with phase("score.product"):
                blocks[d].zero_()
                blocks[d].index_put_((cols, rows), ones[d])
                totals[d] += presence_product(blocks[d])
        with phase("score.fetch"):
            total = sum(t.to(devices[0]) for t in totals[1:]) + totals[0]
            return total[:n_files, :n_files].cpu().numpy()


def scores_to_dict(score: np.ndarray, query_size: int) -> Dict[int, int]:
    """Upper-triangular score matrix -> the reference's score_A map
    (vectorized; the N^2 Python loop dominated at large file counts)."""
    n = score.shape[0]
    iu, ju = np.triu_indices(n, k=1)
    vals = score[iu, ju]
    nz = vals > 0
    keys = iu[nz].astype(np.int64) * n + ju[nz]
    return dict(zip(keys.tolist(), vals[nz].tolist()))
