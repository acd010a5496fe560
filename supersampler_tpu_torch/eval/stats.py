"""Offline evaluation harness (reference Stats.py:1-285), without pandas.

Compares SuperSampler result matrices against sourmash and SimKa ground
truth, and tabulates sketch sizes / RAM / time from benchmark logs into
the same long-format CSVs (`value,type,threshold,<metric>,tool`) the
reference produces for its figures.

CLI (python -m supersampler_tpu_torch.eval.stats):
  spsp sourmash simka [--subspsp F] [--subsm F] [-b F] -t TYPE -o OUT
with TYPE in {size, ram, time, error} (reference Stats.py:263-284).

The port's copy of supersampler_tpu/eval/stats.py, which reads its
matrices with pandas; this one reads them with the csv module and numpy
(read_table), so that it runs where pandas is not installed, and writes
byte-equal files on the inputs the reference tools write. read_table
rebuilds what ``pd.read_csv(path, sep=sep, header=0).to_numpy()``
gives: the first non-blank line is the header, blank lines are
skipped, a short row is padded with NaN, the compression comes from the
file name's extension (.gz, .bz2, .xz); a cell in pandas' default NA
set (the empty cell among them) is NaN; a column of int64 integers
with no NaN is int64, any other numeric column float64, and a table of
int64 columns only is int64; the array is laid out column by column,
as pandas' is, so that np.mean sums in the same order.

Floats are parsed as pandas' default C parser parses them (its
precise_xstrtod, pandas 1.2 and later; ``pandas_float``): the first 17
significant digits are accumulated in a double, the digits after them
dropped, and the power of ten applied by one multiplication or
division. Python's float() rounds correctly and so differs from it in
the last bit on some numbers of 17 significant digits (the repr of a
double, as sourmash's CSVs hold) and more; the comparator writes at
most -p digits. Integers beyond int64, and any other cell that is not
a number, raise ValueError, where pandas would make an object or
uint64 column.
"""

from __future__ import annotations

import argparse
import bz2
import csv
import gzip
import lzma
import os
import re
import sys

import numpy as np

# pandas' default NA strings (its STR_NA_VALUES)
_NA = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN",
                 "-NaN", "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA",
                 "NULL", "NaN", "None", "n/a", "nan", "null"})
_INT = re.compile(r"[+-]?[0-9]+\Z")
_FLOAT = re.compile(r"[+-]?([0-9]+\.?[0-9]*(e[+-]?[0-9]+)?"
                    r"|\.[0-9]+(e[+-]?[0-9]+)?|inf|infinity)\Z",
                    re.IGNORECASE)
_OPEN = {".gz": gzip.open, ".bz2": bz2.open, ".xz": lzma.open}
_POW10 = [float(f"1e{i}") for i in range(309)]
_INT64 = (-(1 << 63), (1 << 63) - 1)


def read_table(path, sep: str, skip_cols: int = 0) -> np.ndarray:
    """The numeric table under a header row, as pandas'
    read_csv(path, sep=sep, header=0) gives it with its first skip_cols
    columns dropped, through to_numpy()."""
    opener = _OPEN.get(os.path.splitext(str(path))[1], open)
    with opener(path, "rt", newline="", encoding="utf-8") as f:
        rows = [r for r in csv.reader(f, delimiter=sep) if r]
    n_col = len(rows[0])
    cols = [[] for _ in range(n_col)]
    for r in rows[1:]:
        if len(r) > n_col:
            raise ValueError(f"{path}: expected {n_col} fields, saw "
                             f"{len(r)}")
        for j in range(n_col):
            cols[j].append(r[j].strip() if j < len(r) else "")
    arrays = [_column(c, path) for c in cols[skip_cols:]]
    dtype = (np.int64 if all(a.dtype == np.int64 for a in arrays)
             else np.float64)
    table = np.empty((len(arrays), len(rows) - 1), dtype)
    for j, a in enumerate(arrays):
        table[j] = a
    return table.T


def _column(cells, path) -> np.ndarray:
    """One column: int64 when every cell is an integer, else float64."""
    if cells and all(_INT.match(c) for c in cells):
        ints = [int(c) for c in cells]
        if not all(_INT64[0] <= v <= _INT64[1] for v in ints):
            raise ValueError(f"{path}: an integer beyond int64")
        return np.array(ints, np.int64)
    out = np.empty(len(cells), np.float64)
    for i, c in enumerate(cells):
        if c in _NA:
            out[i] = np.nan
        elif _FLOAT.match(c):
            out[i] = pandas_float(c)
        else:
            raise ValueError(f"{path}: not a number: {c!r}")
    return out


def pandas_float(c: str) -> float:
    """A decimal number (a cell that _FLOAT matches) parsed as pandas'
    precise_xstrtod parses it."""
    neg = c[0] == "-"
    body = c[1:] if c[0] in "+-" else c
    if body.lower() in ("inf", "infinity"):
        return -np.inf if neg else np.inf
    p, n = 0, len(body)
    number, exponent, n_dig = 0.0, 0, 0
    while p < n and "0" <= body[p] <= "9":
        if n_dig < 17:
            number = number * 10.0 + (ord(body[p]) - 48)
            n_dig += 1
        else:
            exponent += 1
        p += 1
    if p < n and body[p] == ".":
        p += 1
        n_dec = 0
        while n_dig < 17 and p < n and "0" <= body[p] <= "9":
            number = number * 10.0 + (ord(body[p]) - 48)
            n_dig += 1
            n_dec += 1
            p += 1
        while p < n and "0" <= body[p] <= "9":
            p += 1
        exponent -= n_dec
    if neg:
        number = -number
    if p < n:                                   # the exponent
        p += 1
        e_neg = body[p] == "-"
        p += body[p] in "+-"
        e, e_dig = 0, 0
        while e_dig < 17 and p < n:
            e = e * 10 + ord(body[p]) - 48
            e_dig += 1
            p += 1
        exponent += -e if e_neg else e
    if exponent > 308:
        return number * np.inf if number else number
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -616:
        return 0.0
    if exponent < -308:
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _read_fof(path):
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(line)
    return out


def _nums(name):
    return re.findall(r"\d+", name)


def read_simka(path) -> np.ndarray:
    """SimKa distances; similarity = 1 - distance
    (reference Stats.py:48-51)."""
    return 1 - read_table(path, ";", skip_cols=1)


def read_matrix_csv(path) -> np.ndarray:
    return read_table(path, ",")


def read_index_size(sub_sourmash, sub_spsp):
    """Sketch sizes in MiB keyed by subsampling rate and tool
    (reference Stats.py:139-172)."""
    data = {}
    for line in _read_fof(sub_sourmash):
        tmp = line.split("/")[-1]
        key = _nums(tmp)[0]
        data.setdefault(key, {})["sourmash_zipped"] = {
            "type": os.stat(line).st_size / (1024 * 1024)}
    for line in _read_fof(sub_spsp):
        tmp = line.split("/")[-1]
        name = "SuperSampler_m" + _nums(tmp)[1]
        key = _nums(tmp)[0]
        data.setdefault(key, {})[name] = {
            "type": os.stat(line).st_size / (1024 * 1024)}
    return data


def read_bench(fof, kind):
    """RAM/time tables from /usr/bin/time-style benchmark logs
    (reference Stats.py:100-135: line 2, tab-separated; RAM = column 3,
    time = last column)."""
    data = {}
    for name in _read_fof(fof):
        tmp = name.split("/")[-1]
        key = _nums(tmp)[0]
        parts = name.split("_")
        with open(name) as bench:
            bench.readline()
            values = bench.readline().strip().split("\t")
        tool = ("SuperSampler_m" + parts[3]) if len(parts) > 5 else "sourmash"
        val = values[2] if kind == "ram" else values[-1]
        data.setdefault(key, {}).setdefault(tool, {})["type"] = val
    return data


def write_csv(data, out, kind):
    with open(out, "w") as f:
        f.write("value,type,threshold," + kind + ",tool\n")
        for key in data:
            for name in data[key]:
                if "diff" in data[key][name]:
                    f.write(f"{data[key][name]['diff']},error,{key},"
                            f"{data[key][name]['type']},{name}\n")
                else:
                    print(f"Missing differences for subsampling rate {key},"
                          f" tool is {name}. Maybe comparisons did not go"
                          " through ?")


def get_error(res_spsp, res_simka, out):
    """|mean(SimKa) - mean(SPSP)| per subsampling rate
    (reference Stats.py:45-98)."""
    simka = read_simka(res_simka)
    data = {}
    for path in _read_fof(res_spsp):
        spsp = read_matrix_csv(path)
        name = path.split("/")[-1]
        key = _nums(name)[0]
        data.setdefault(key, {})["SuperSampler_decycling"] = {
            "type": abs(np.mean(simka) - np.mean(spsp))}
    with open(out, "w") as f:
        f.write("value,type,threshold,error,tool\n")
        for key in data:
            for name in data[key]:
                f.write(f"{data[key][name]['type']},error,{key},0,{name}\n")


def compare_results(res_spsp, res_sourmash, res_simka, data, out, kind):
    """Attach |mean(SimKa) - mean(tool)| differences to the size/ram/time
    table (reference Stats.py:174-251)."""
    simka = read_simka(res_simka)
    files_spsp = _read_fof(res_spsp)
    files_sourmash = []
    for line in _read_fof(res_sourmash):
        files_sourmash.append(line)
        if kind == "size":
            files_sourmash.append(line)
    for path in files_spsp:
        spsp = read_matrix_csv(path)
        name = path.split("/")[-1]
        key = _nums(name)[0]
        tool = "SuperSampler_m" + _nums(name)[1]
        if key in data and tool in data[key]:
            data[key][tool]["diff"] = abs(np.mean(simka) - np.mean(spsp))
        else:
            print(f"should not happen, {tool} not in dict[{key}]"
                  if key in data else f"should not happen, {key} not in dict.")
    for path in files_sourmash:
        sm = read_matrix_csv(path)
        name = path.split("/")[-1]
        key = _nums(name)[0]
        tool = "sourmash_zipped" if kind == "size" else "sourmash"
        if key in data and tool in data[key]:
            data[key][tool]["diff"] = abs(np.mean(simka) - np.mean(sm))
        else:
            print(f"should not happen, {tool} not in dict[{key}]"
                  if key in data else f"should not happen, {key} not in dict.")
    write_csv(data, out, kind)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Stats comparing sourmash and SPSP")
    p.add_argument("spsp")
    p.add_argument("sourmash")
    p.add_argument("simka")
    p.add_argument("--subspsp", required=False)
    p.add_argument("--subsm", required=False)
    p.add_argument("-b", required=False)
    p.add_argument("-t")
    p.add_argument("-o")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    if args.t == "size":
        data = read_index_size(args.subsm, args.subspsp)
    elif args.t in ("ram", "time"):
        data = read_bench(args.b, args.t)
    elif args.t == "error":
        get_error(args.spsp, args.simka, args.o)
        return 0
    else:
        sys.exit("INVALID VALUE FOR TYPE.")
    compare_results(args.spsp, args.sourmash, args.simka, data, args.o,
                    args.t)
    return 0


if __name__ == "__main__":
    sys.exit(main())
