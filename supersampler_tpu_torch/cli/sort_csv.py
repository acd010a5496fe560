"""sortCSV CLI — reorders a (symmetric) matrix CSV to match an original
file-of-files ordering (reference sort_csv.cpp:26-122). Positional args:
input.csv[.gz] output.csv original_fof.txt. The port's copy of
supersampler_tpu/cli/sort_csv.py.
"""

from __future__ import annotations

import sys

from supersampler_tpu_torch.io.fasta import open_maybe_gzip


def sort_csv(in_path: str, out_path: str, fof_path: str) -> None:
    with open_maybe_gzip(in_path) as f:
        lines = f.read().decode().split("\n")
    with open(fof_path) as f:
        names_ordered = f.read().split("\n")
    header = lines[0]
    files_names = header.split(",")
    n = len(files_names)
    # position of each header name in the fof order (sort_csv.cpp:50-57)
    sorted_names = {}
    names = {}
    for initial_id, fname in enumerate(files_names):
        try:
            pos = names_ordered.index(fname)
        except ValueError:
            pos = len(names_ordered)
        sorted_names[pos] = initial_id
        names[pos] = fname
    old2new = {}
    for new_id, pos in enumerate(sorted(sorted_names)):
        old2new[sorted_names[pos]] = new_id
    out_lines = [",".join(names[p] for p in sorted(names))]
    matrix = [[0.0] * n for _ in range(n)]
    line_id = 0
    for line in lines[1:]:
        if len(line) < n:
            break
        values = line.split(",")
        for i in range(n):
            matrix[old2new[i]][old2new[line_id]] = float(values[i])
        line_id += 1
    for i in range(n):
        row = []
        for j in range(n):
            v = matrix[i][j]
            row.append(f"{v:g}")
            if v != matrix[j][i]:
                print("bug1 OR you are sorting a containment file")
            if i == j and v != 1:
                print(v)
                print("bug2")
        out_lines.append(",".join(row))
    with open(out_path, "w") as f:
        f.write("\n".join(out_lines) + "\n")
    print("The end")


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) < 3:
        print("Need input, output filename and original fof")
        return 0
    sort_csv(args[0], args[1], args[2])
    return 0


if __name__ == "__main__":
    sys.exit(main())
