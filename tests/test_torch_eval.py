"""The port's eval CLIs against the JAX package's, on the CPU.

eval/norms.py must return the same dicts and print the same lines as
JAX's. eval/stats.py reads its matrices without pandas: its table
reader is held to pandas' read_csv(...).to_numpy() (values, dtype,
layout, and the np.mean of each, bit for bit), and its output files to
JAX's for each -t (error, size, ram, time) over a small tree of fake
SimKa, sourmash, sketch and /usr/bin/time files. The port's side runs
in a subprocess in which pandas cannot be imported."""

import bz2
import gzip
import io
import lzma
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

import supersampler_tpu.eval.norms as JN
import supersampler_tpu_torch.eval.norms as TN
from supersampler_tpu_torch.compare.merge import TorchComparator
from supersampler_tpu_torch.compare.writers import write_matrix_gz
from supersampler_tpu_torch.eval.stats import pandas_float, read_table

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_GOLD = os.path.join(_REPO, "tests", "golden")


def _sym(rng, n, digits=None):
    a = rng.random((n, n))
    a = (a + a.T) / 2
    np.fill_diagonal(a, 1.0)
    return a if digits is None else np.round(a, digits)


@pytest.mark.parametrize("n,digits", [(2, None), (7, 3), (40, None),
                                      (64, 6)])
def test_compare_matrices_equals_jax(n, digits):
    rng = np.random.default_rng(n)
    a, b = _sym(rng, n, digits), _sym(rng, n, digits)
    b[0, -1] = b[-1, 0] = a[-1, 0]          # one zero difference
    for x, y in ((a, b), (a, a), (b, a)):
        assert repr(TN.compare_matrices(x, y)) == repr(
            JN.compare_matrices(x, y))
        low = TN.lower_triangle(x)
        assert repr(TN.basic_metrics(low)) == repr(JN.basic_metrics(low))


@pytest.fixture
def comparator_csvs(tmp_path, monkeypatch):
    """The port's comparator (numpy engine) over the family goldens:
    all-vs-all and query CSVs written as the CLI writes them."""
    monkeypatch.chdir(tmp_path)
    names = [f"gfam_fam{i}.gz" for i in range(4)]
    for f in names:
        os.symlink(os.path.join(_GOLD, f), tmp_path / f)
    paths = []
    for q in (4, 2):
        comp = TorchComparator(precision=6, engine="numpy")
        comp.files_names = list(names)
        comp.compare_sketches(q)
        for kind, text in (("containment", comp.containment_csv()),
                           ("jaccard", comp.jaccard_csv())):
            paths.append(str(tmp_path / f"q{q}_{kind}.csv.gz"))
            write_matrix_gz(paths[-1], text)
    return paths


def test_norms_on_comparator_csvs_equal_jax(comparator_csvs):
    jac, con = comparator_csvs[1], comparator_csvs[0]
    for p in comparator_csvs[:2]:
        assert np.array_equal(TN.load_matrix(p), JN.load_matrix(p))
    mats = [TN.load_matrix(p) for p in (con, jac)]
    assert repr(TN.compare_matrices(*mats)) == repr(
        JN.compare_matrices(*mats))
    for args in ([con, jac], [con, jac, jac]):
        got, want = io.StringIO(), io.StringIO()
        with redirect_stdout(got):
            assert TN.main(args) == 0
        with redirect_stdout(want):
            assert JN.main(args) == 0
        assert got.getvalue() == want.getvalue()
    with redirect_stdout(io.StringIO()):
        assert TN.main([con]) == 1


# ---- stats: the table reader against pandas ----

_TABLES = {
    "ints": "a,b,c\n1,0,3\n-4,5,+6\n",
    "mixed": "a,b,c\n1,0.5,3\n4,1e-3,6\n",
    "empty_cell": "a,b\n1,\n,0.25\n",
    "na_strings": "a,b,c\nNA,nan,1\nnull,2.5,N/A\n",
    "blank_and_crlf": "a,b\r\n\r\n1,0.5\r\n\r\n0.5,1\r\n",
    "containment": "x,y,z\n\n1,0.315826,0\n0.31539,1,0.5\n",
    "short_row": "a,b,c\n1,2\n3,4,5\n",
    "digits": "a,b\n0.12345678901234567,1.0000000000000002\n"
              "3.3333333333333335,-2.5e-300\n",
    "spaces": "a,b\n 1.5 ,2\n3, 4\n",
    "inf": "a,b\ninf,1.5\n1,Infinity\n",
}


def _pd_table(pd, path, sep, skip_cols=0):
    df = pd.read_csv(path, sep=sep, header=0)
    if skip_cols:
        df = df.drop(df.columns[list(range(skip_cols))], axis=1)
    return df.to_numpy()


def _same_table(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.flags["F_CONTIGUOUS"] == want.flags["F_CONTIGUOUS"]
    assert np.array_equal(got, want, equal_nan=True)
    assert repr(np.mean(got)) == repr(np.mean(want))


@pytest.mark.parametrize("name", sorted(_TABLES))
def test_read_table_equals_pandas(tmp_path, name):
    pd = pytest.importorskip("pandas")
    path = tmp_path / f"{name}.csv"
    path.write_bytes(_TABLES[name].encode())
    _same_table(read_table(str(path), ","), _pd_table(pd, str(path), ","))


@pytest.mark.parametrize("ext,opener", [(".gz", gzip.open),
                                        (".bz2", bz2.open),
                                        (".xz", lzma.open)])
def test_read_table_infers_compression_from_the_extension(tmp_path, ext,
                                                          opener):
    pd = pytest.importorskip("pandas")
    path = str(tmp_path / f"m.csv{ext}")
    with opener(path, "wb") as f:
        f.write(_TABLES["mixed"].encode())
    _same_table(read_table(path, ","), _pd_table(pd, path, ","))


def test_read_table_mean_sums_as_pandas_does(tmp_path):
    """A 300 x 300 table of 17-digit floats and a SimKa table with a
    name column and int and float columns: np.mean depends on the
    layout, which must be pandas'."""
    pd = pytest.importorskip("pandas")
    rng = np.random.default_rng(8)
    a = rng.random((300, 300)) * 10.0 ** rng.integers(-3, 3, (300, 300))
    path = tmp_path / "big.csv"
    path.write_text(",".join(f"c{j}" for j in range(300)) + "\n" + "".join(
        ",".join(repr(float(x)) for x in row) + "\n" for row in a))
    _same_table(read_table(str(path), ","), _pd_table(pd, str(path), ","))
    simka = tmp_path / "simka.csv"
    rows = [";" + ";".join(f"s{j}" for j in range(50))]
    for i in range(50):
        cells = [repr(float(x)) for x in rng.random(50)]
        cells[i] = "0"
        rows.append(f"s{i};" + ";".join(cells))
    simka.write_text("\n".join(rows) + "\n")
    _same_table(read_table(str(simka), ";", skip_cols=1),
                _pd_table(pd, str(simka), ";", skip_cols=1))


def test_pandas_float_equals_pandas():
    """20,000 decimal strings of every form (reprs, %g, %f and %e at
    0-30 digits, long digit strings, edge exponents): the port's parser
    gives pandas' double bit for bit, where float() differs on many."""
    pd = pytest.importorskip("pandas")
    rng = np.random.default_rng(17)
    cells = ["1e400", "-1e400", "0e400", "1e-700", "-1e-700", "1.5e-310",
             "00000000000000000001.5", "-0.0", ".5", "5.", "1.e5", "1E+5",
             "inf", "-Infinity", "+inf"]
    for _ in range(20_000):
        x = rng.random() * 10.0 ** int(rng.integers(-30, 30))
        form = int(rng.integers(0, 5))
        if form == 0:
            cells.append(repr(float(x)))
        elif form == 1:
            cells.append(f"{x:.{rng.integers(1, 25)}g}")
        elif form == 2:
            cells.append(f"{x:.{rng.integers(0, 30)}f}")
        elif form == 3:
            cells.append(f"{x:.{rng.integers(0, 25)}e}")
        else:
            cells.append("-" * int(rng.integers(0, 2)) + "".join(
                rng.choice(list("0123456789"), int(rng.integers(1, 30))))
                + "." + "".join(rng.choice(list("0123456789"),
                                           int(rng.integers(0, 30)))))
    want = pd.read_csv(io.StringIO("a\n" + "\n".join(cells) + "\n"))
    want = want["a"].to_numpy()
    got = np.array([pandas_float(c) for c in cells])
    assert got.tobytes() == want.tobytes()
    assert sum(float(c) != w for c, w in zip(cells, want)) > 1000


def test_read_table_rejects_text_and_long_rows(tmp_path):
    path = tmp_path / "t.csv"
    path.write_text("a,b\n1,x\n")
    with pytest.raises(ValueError):
        read_table(str(path), ",")
    path.write_text("a,b\n1,2,3\n4,5\n")
    with pytest.raises(ValueError):
        read_table(str(path), ",")


# ---- stats: the CLI against JAX's ----

def _stats_tree(root, rng, empty_cell):
    """Fake outputs of the reference tools under root (paths relative to
    it): a SimKa distance matrix (with an empty cell if asked, which
    makes every mean NaN), SuperSampler CSVs
    (plain, .gz, containment with its blank line) at two rates and two
    m, sourmash CSVs, sketch files and /usr/bin/time logs. Returns the
    argument lists for each -t."""
    n = 5
    names = [f"g{i}" for i in range(n)]
    sim = _sym(rng, n, 6)
    rows = [";" + ";".join(names)]
    for i in range(n):
        cells = [repr(float(1 - x)) for x in sim[i]]
        cells[i] = "0"
        rows.append(names[i] + ";" + ";".join(cells))
    if empty_cell:
        rows[2] = rows[2].rsplit(";", 1)[0] + ";"
    (root / "simka.csv").write_text("\n".join(rows) + "\n")

    def matrix(path, digits, blank=False, gz=False):
        mat = _sym(rng, n, digits)
        text = (",".join(names) + "\n" + ("\n" if blank else "") + "".join(
            ",".join(f"{x:.{digits}g}" for x in row) + "\n" for row in mat))
        if gz:
            with open(root / path, "wb") as f:
                f.write(gzip.compress(text.encode()))
        else:
            (root / path).write_text(text)
        return path

    spsp = [matrix("spsp_1000_m11.csv.gz", 6, blank=True, gz=True),
            matrix("spsp_100_m11.csv", 3),
            matrix("spsp_1000_m9.csv", 6, blank=True)]
    sm = [matrix("sourmash_1000.csv", 17), matrix("sourmash_100.csv", 12)]
    sub_spsp, sub_sm, bench = [], [], []
    for rate in ("1000", "100"):
        for m in ("11", "9"):
            p = f"sketch_{rate}_m{m}.gz"
            (root / p).write_bytes(rng.bytes(int(rng.integers(10, 5000))))
            sub_spsp.append(p)
            p = f"bench_spsp_{rate}_{m}_k31_run.txt"
            (root / p).write_text(
                "s\th:m:s\tmax_rss\tmax_vms\tcpu_time\n"
                f"{rng.random():.4f}\t0:00:01\t{rng.integers(1, 9999)}\t"
                f"{rng.integers(1, 9999)}\t{rng.random() * 9:.2f}\n")
            bench.append(p)
        p = f"sourmash_sig_{rate}.zip"
        (root / p).write_bytes(rng.bytes(int(rng.integers(10, 5000))))
        sub_sm.append(p)
        p = f"bench_sm_{rate}.txt"
        (root / p).write_text(
            "s\th:m:s\tmax_rss\n"
            f"{rng.random():.4f}\t0:00:02\t{rng.integers(1, 9999)}\n")
        bench.append(p)
    for name, lines in (("spsp.txt", spsp), ("sm.txt", sm),
                        ("subspsp.txt", sub_spsp), ("subsm.txt", sub_sm),
                        ("bench.txt", bench)):
        (root / name).write_text("\n".join(lines) + "\n")
    base = ["spsp.txt", "sm.txt", "simka.csv"]
    return {"error": base + ["-t", "error"],
            "size": base + ["--subspsp", "subspsp.txt", "--subsm",
                            "subsm.txt", "-t", "size"],
            "ram": base + ["-b", "bench.txt", "-t", "ram"],
            "time": base + ["-b", "bench.txt", "-t", "time"]}


_NO_PANDAS = """
import sys
sys.modules["pandas"] = None
sys.path.insert(0, sys.argv[1])
from supersampler_tpu_torch.eval import stats
sys.exit(stats.main(sys.argv[2:]))
"""


@pytest.mark.parametrize("empty_cell", [False, True])
@pytest.mark.parametrize("kind", ["error", "size", "ram", "time"])
def test_stats_writes_jaxs_files_without_pandas(tmp_path, monkeypatch,
                                                kind, empty_cell):
    pytest.importorskip("pandas")
    from supersampler_tpu.eval import stats as jax_stats

    args = _stats_tree(tmp_path, np.random.default_rng(31),
                       empty_cell)[kind]
    monkeypatch.chdir(tmp_path)
    want = io.StringIO()
    with redirect_stdout(want):
        assert jax_stats.main(args + ["-o", "jax.csv"]) == 0
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", _NO_PANDAS, _REPO, *args,
                        "-o", "port.csv"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout == want.getvalue()
    got = (tmp_path / "port.csv").read_bytes()
    assert got == (tmp_path / "jax.csv").read_bytes()
    assert got.count(b"\n") >= 3, got
    assert (b"nan," in got) == empty_cell, got


def test_stats_module_needs_no_pandas():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    probe = ("import sys; sys.modules['pandas'] = None; "
             f"sys.path.insert(0, {_REPO!r}); "
             "import supersampler_tpu_torch.eval.stats as s, "
             "supersampler_tpu_torch.eval.norms as n; "
             "print(sorted(m for m in sys.modules "
             "if m.split('.')[0] in ('jax', 'supersampler_tpu')))")
    r = subprocess.run([sys.executable, "-c", probe], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
