"""Plain reference of the all-vs-all comparison (Comparator.cpp).

A file's content is its set of distinct (minimizer, canonical k-mer)
pairs. For files i and j, inter = |pairs of i and j in common|;
containment[i][j] = inter / |i| and jaccard[i][j] = inter / (|i| + |j|
- inter), printed as C++ ostream with setprecision(p) prints them
(%.{p}g), "1" on the diagonal, "0" where nothing is shared or the score
is below the minimum. The containment CSV has an empty line after its
header row of file names (Comparator.cpp:362-460).
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.sketch import canonical_kmer


def file_sets(pair_lists, k: int):
    """Each file's sorted distinct (minimizer, canonical k-mer) keys."""
    out = []
    for pairs in pair_lists:
        can = canonical_kmer(pairs[:, 1], k)
        rows = np.ascontiguousarray(np.stack([pairs[:, 0], can], 1))
        out.append(np.unique(rows.view([("a", np.int64), ("b", np.int64)])
                             .reshape(-1)))
    return out


def intersections(sets) -> np.ndarray:
    """(n, n) counts of shared pairs; the diagonal holds each size."""
    n = len(sets)
    allk = np.concatenate(sets)
    fid = np.repeat(np.arange(n), [s.size for s in sets])
    uniq, gid = np.unique(allk, return_inverse=True)
    # presence matrix of pairs held by two files or more, as floats:
    # the counts stay far below 2^53, so the product is exact
    held = np.bincount(gid, minlength=uniq.size)
    shared = held[gid] >= 2
    rows = np.unique(gid[shared], return_inverse=True)[1]
    pres = np.zeros((int(rows.max()) + 1 if rows.size else 0, n))
    pres[rows, fid[shared]] = 1.0
    inter = np.rint(pres.T @ pres).astype(np.int64)
    np.fill_diagonal(inter, [s.size for s in sets])
    return inter


def matrix_cells(inter: np.ndarray, precision: int, min_threshold: float,
                 jaccard: bool):
    """The CSV's rows of cells below its header, as strings."""
    n = inter.shape[0]
    size = np.diag(inter)
    rows = []
    for i in range(n):
        cells = []
        for j in range(n):
            if i == j:
                cells.append("1")
                continue
            x = int(inter[i, j])
            if x == 0:
                cells.append("0")
                continue
            denom = int(size[i]) + int(size[j]) - x if jaccard else int(size[i])
            score = x / denom
            cells.append("0" if score < min_threshold
                         else "%.*g" % (precision, score))
        rows.append(cells)
    return rows


def csv_text(names, inter, precision, min_threshold, jaccard) -> str:
    lines = [",".join(names)]
    if not jaccard:
        lines.append("")
    lines += [",".join(r) for r in matrix_cells(inter, precision,
                                                min_threshold, jaccard)]
    return "\n".join(lines) + "\n"


def cells_wrong(got: str, want: str) -> int:
    """Cells of want that got does not hold in the same place; a missing
    or extra row or cell counts as wrong, and so does the header."""
    g, w = got.split("\n"), want.split("\n")
    bad = abs(len(g) - len(w))
    for a, b in zip(g, w):
        ca, cb = a.split(","), b.split(",")
        bad += abs(len(ca) - len(cb)) + sum(x != y for x, y in zip(ca, cb))
    return bad
