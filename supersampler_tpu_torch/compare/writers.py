"""Containment/Jaccard matrix CSV writers.

Byte-exact replication of the reference's output format
(reference Comparator.cpp:362-460): header row of file names; the
containment CSV has a blank line after the header (Comparator.cpp:373),
jaccard does not; rows only for i < query_size; diagonal "1"; absent
pairs "0"; scores below min_threshold "0"; values formatted like
C++ ostream with setprecision(p) (%.{p}g). The port's copy of
supersampler_tpu/compare/writers.py.
"""

from __future__ import annotations

from typing import Dict, List

from supersampler_tpu_torch.core.scalar import format_g6
from supersampler_tpu_torch.io.gzip_exact import write_gzip_exact


def matrix_csv(files_names: List[str], score_a: Dict[int, int],
               nb_kmer_seen_infile: List[int], query_size: int,
               precision: int, min_threshold: float,
               jaccard: bool) -> str:
    n = len(files_names)
    rows = [",".join(files_names)]
    if not jaccard:
        rows.append("")
    for i in range(min(n, query_size)):
        cells = []
        for j in range(n):
            if i == j:
                cells.append("1")
                continue
            key = i * n + j if i < j else j * n + i
            inter = score_a.get(key)
            if inter is None:
                cells.append("0")
                continue
            if jaccard:
                denom = (nb_kmer_seen_infile[i] + nb_kmer_seen_infile[j]
                         - inter)
            else:
                denom = nb_kmer_seen_infile[i]
            score = inter / denom
            if score < min_threshold:
                cells.append("0")
            else:
                cells.append(format_g6(score, precision))
        rows.append(",".join(cells))
    return "\n".join(rows) + "\n"


def write_matrix_gz(path: str, csv_text: str) -> None:
    """The reference writes CSVs gzip level 1 (Comparator.cpp:363);
    byte-identical container via io.gzip_exact."""
    write_gzip_exact(path, csv_text.encode(), level=1)
