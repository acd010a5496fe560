"""Multi-process orchestration: torch.distributed set-up and per-process
work ownership for sketching and comparison.

Counterpart of supersampler_tpu/parallel/dist.py. The reference's only
parallelism is an OpenMP fan-out over files (SubSampler.cpp:771-798);
here each process sketches the fof entries it owns, and for the
all-vs-all comparison each process decodes only its strided shard of
the sketches, the decoded pair arrays are all-gathered, and every
process then scores the whole set itself.

The collectives carry host data only (the pair arrays, as JAX's
``process_allgather`` does), so the process group uses gloo: it needs no
card, and several processes may share one card, which NCCL refuses.
A single process (no group set up) runs the same code with world size
1; ``initialize()`` is a no-op there.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from supersampler_tpu_torch.compare.merge import TorchComparator
from supersampler_tpu_torch.parallel.compare_dist import decode_files
from supersampler_tpu_torch.sketch import subsample_file


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None) -> None:
    """Join the gloo process group, env-driven and idempotent.

    A no-op when neither ``init_method`` nor $MASTER_ADDR is given (one
    process), and when a group already exists. Otherwise WORLD_SIZE,
    RANK and LOCAL_RANK come from the environment where not passed (as
    torchrun sets them; ``env://`` then also reads MASTER_PORT), and a
    process that sees CUDA takes card LOCAL_RANK % device_count."""
    if init_method is None:
        if not os.environ.get("MASTER_ADDR"):
            return
        init_method = "env://"
    if dist.is_initialized():
        return
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=120))


def process_info():
    """(rank, world size); (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def owned_shard(items: Sequence, index: Optional[int] = None,
                count: Optional[int] = None) -> List:
    """This process's strided shard of a work list (fof entries, sketch
    files): item i belongs to process i % count. Strided (not blocked)
    so genome-size skew spreads evenly."""
    if index is None or count is None:
        index, count = process_info()
    return [x for i, x in enumerate(items) if i % count == index]


def sketch_fof_distributed(entries: Sequence[str], make_subsampler,
                           prefix: str) -> List[str]:
    """Sketch this process's shard of a fof (each process writes only
    its own outputs); returns the local output paths. The global
    out-fof is the union in fof order (ownership is a pure function of
    the index)."""
    return [subsample_file(make_subsampler(), path, prefix)
            for path in owned_shard(list(entries))]


def _all_gather_pairs(local: np.ndarray, world: int) -> np.ndarray:
    """All-gather each process's (4, n) uint64 pair columns, n differing
    between processes: the sizes first, then the columns padded to the
    largest and trimmed. The uint64 columns travel as int64 views of
    the same bits."""
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(sizes, torch.tensor([local.shape[1]]))
    sizes = [int(x) for x in sizes]
    padded = np.zeros((4, max(max(sizes), 1)), np.int64)
    padded[:, : local.shape[1]] = local.view(np.int64)
    parts = [torch.empty(padded.shape, dtype=torch.int64)
             for _ in range(world)]
    dist.all_gather(parts, torch.from_numpy(padded))
    return np.concatenate([p.numpy()[:, :n].view(np.uint64)
                           for p, n in zip(parts, sizes)], axis=1)


def compare_all_vs_all_distributed(files: Sequence[str], mesh=None,
                                   query_size: Optional[int] = None):
    """All-vs-all (or query-mode) comparison with per-process decode.

    A (minimizer, k-mer) pair held by files of two processes must land
    in one group row of S = P^T P, so grouping needs every pair: each
    process decodes its strided shard of the sketch files (the costly
    part), the pair arrays are all-gathered, and every process scores
    them with the device engine (on ``mesh`` if given, else on
    ``default_device()``). A single process takes the plain
    compare_sketches path. Every process returns the same comparator."""
    idx, cnt = process_info()
    comp = TorchComparator(engine="device", mesh=mesh)
    comp.files_names = list(files)
    if query_size is None:
        query_size = len(files)
    if cnt == 1:
        comp.compare_sketches(query_size)
        return comp
    owned = owned_shard(list(enumerate(files)), idx, cnt)
    mins, his, los, fids, _seen, k, m, _q = decode_files(
        [path for _f, path in owned])
    if owned:
        comp.k, comp.m = k, m
    # local file ids -> global ones
    fids = np.array([f for f, _path in owned], np.uint64)[fids]
    local = np.stack([mins, his, los, fids])
    score_gathered_pairs(comp, _all_gather_pairs(local, cnt), query_size)
    return comp


def score_gathered_pairs(comp: TorchComparator, allp: np.ndarray,
                         query_size: int) -> None:
    """Score all-gathered (4, n) pair columns (minimizer, hi, lo, file
    id) on comp, whose files_names are the compared files. The shards
    are strided, so the files' pairs are put in file order first, as
    group_pairs takes them."""
    allp = allp[:, np.argsort(allp[3], kind="stable")]
    fids = allp[3].astype(np.int64)
    n = len(comp.files_names)
    qmins = (set(np.unique(allp[0][fids < query_size]).tolist())
             if query_size < n else None)
    comp.score_decoded(allp[0], allp[1], allp[2], fids,
                       np.bincount(fids, minlength=n).tolist(), query_size,
                       qmins)
