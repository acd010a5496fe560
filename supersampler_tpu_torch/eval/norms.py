"""Matrix-difference analysis of similarity matrices — the port of the
reference's offline evaluation notebook (reference Stats_SPSP.ipynb
cells 1-14): lower-triangle extraction, basic statistics, L1/L2 norms
of pairwise matrix differences, and the notebook's harmonic-mean
variants.

Usage: python -m supersampler_tpu_torch.eval.norms A.csv[.gz] B.csv[.gz]
[C.csv[.gz]] — with three matrices the first is treated as ground
truth (the notebook's SimKa) and both pairwise comparisons are printed.
The port's copy of supersampler_tpu/eval/norms.py (numpy only).
"""

from __future__ import annotations

import sys
from typing import Dict

import numpy as np

from supersampler_tpu_torch.io.fasta import open_maybe_gzip


def load_matrix(path: str) -> np.ndarray:
    """Read a (possibly gzipped) similarity-matrix CSV with a header row
    of file names (the comparator's output format)."""
    with open_maybe_gzip(path) as f:
        text = f.read().decode()
    rows = [ln for ln in text.split("\n") if ln.strip()]
    data = [[float(x) for x in ln.split(",")] for ln in rows[1:]]
    return np.asarray(data, dtype=np.float64)


def lower_triangle(mat: np.ndarray) -> np.ndarray:
    """Strict lower triangle, as the notebook's tril_indices_from(k=-1)."""
    return mat[np.tril_indices_from(mat, k=-1)]


def basic_metrics(data: np.ndarray) -> Dict[str, float]:
    """Notebook cell 1."""
    return {
        "mean": float(np.mean(data)),
        "std": float(np.std(data)),
        "median": float(np.median(data)),
        "max": float(np.max(data)),
        "min": float(np.min(data)),
    }


def harmonic_mean(exp: int, diff: np.ndarray) -> float:
    """Notebook cells 2-3 (including its (size/|sum|)**1/exp
    precedence, which divides by exp rather than taking a root)."""
    s = float(np.sum(1.0 / (diff ** exp)))
    return (diff.size / abs(s)) ** 1 / exp


def compare_matrices(a: np.ndarray, b: np.ndarray) -> Dict[str, float]:
    """Cells 10-14 for one matrix pair: stats + L1/L2 norms of the
    lower-triangle absolute differences."""
    diff = np.abs(lower_triangle(a) - lower_triangle(b))
    out = {"norm1": float(np.linalg.norm(diff, 1)),
           "norm2": float(np.linalg.norm(diff, 2))}
    out.update({f"diff_{k}": v for k, v in basic_metrics(diff).items()})
    for e in (1, 2, 3):
        with np.errstate(divide="ignore"):
            out[f"harmonic_{e}"] = harmonic_mean(e, diff)
    return out


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) < 2:
        print(__doc__)
        return 1
    mats = [load_matrix(p) for p in args]
    for m, p in zip(mats, args):
        print(f"== {p} ==")
        for k, v in basic_metrics(lower_triangle(m)).items():
            print(f"  {k} = {v}")
    pairs = ([(0, 1)] if len(mats) == 2
             else [(0, 1), (0, 2), (1, 2)])
    for i, j in pairs:
        print(f"== |{args[i]} - {args[j]}| ==")
        for k, v in compare_matrices(mats[i], mats[j]).items():
            print(f"  {k} = {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
