"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips where torch sees no CUDA card (the
check runs inside the fixture, never at import). The file needs nothing
from tests/conftest.py, so on a GPU machine where an installed package
named ``tests`` shadows this directory it still runs with

    python -m pytest tests/test_torch_cuda.py -q --noconftest

chip_smoke.py runs the same comparisons at full size."""

import gzip
import importlib.util
import os

import numpy as np
import pytest
import torch

import supersampler_tpu_torch.ops.field as TF
from supersampler_tpu_torch.core.scalar import compute_threshold
from supersampler_tpu_torch.ops import fused as FU
from supersampler_tpu_torch.ops.minimizer import pack_2bit
from supersampler_tpu_torch.ops.scan_kernel import scan_kernel, scan_plain
from supersampler_tpu_torch.parallel import compare_dist as CD
from supersampler_tpu_torch.parallel import mesh as ME
from supersampler_tpu_torch.sketch import TorchSubsampler

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _packed(seed, P, L, device):
    c = np.zeros(P, np.uint8)
    c[:L] = np.random.default_rng(seed).integers(0, 4, L, dtype=np.uint8)
    return pack_2bit(torch.from_numpy(c)).to(device)


@pytest.mark.parametrize("k,m", [(31, 11), (63, 15), (15, 5)])
def test_scan_kernel_equals_plain(cuda, k, m):
    P, L = 1 << 16, 60000
    packed = _packed(k, P, L, cuda)
    last_i = torch.tensor([L - k - 1], dtype=torch.int32, device=cuda)
    for a, b in zip(scan_kernel(packed, k, m, P, last_i),
                    scan_plain(packed, k, m, P, last_i), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("s", [1.0, 10.0, 1000.0])
def test_sweep_kernel_equals_plain_in_resolve(cuda, s):
    k, m, P, L = 31, 11, 1 << 16, 60000
    thr = compute_threshold(k, m, s)
    thr = (thr >> 32, thr & 0xFFFFFFFF)
    t = TF.scan_field_2d_packed(_packed(7, P, L, cuda), k, m, P, L)
    entry = TF.field_entry_init(t, *thr)
    got = TF.resolve_field(t, k, m, 1 << 14, entry, *thr)
    want = TF.resolve_field(t, k, m, 1 << 14, entry, *thr,
                            sweep=TF.sweep_plain)
    assert torch.equal(got, want)


def _load(name):
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(here, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_SWEEP_CASES = _load("sweep_cases")
_SCAN_CASES = _load("scan_cases")
_WALK_CASES = _load("walk_cases")


@pytest.mark.parametrize("k,m", _SCAN_CASES.KM)
@pytest.mark.parametrize("kind", _SCAN_CASES.KINDS)
def test_scan_kernel_equals_plain_on_cases(cuda, kind, k, m):
    """The scan kernel == scan_plain on tests/scan_cases.py's repeats,
    single record and batch (ties in the window minimum)."""
    d = _SCAN_CASES.scan_case(kind, k, m)
    for codes, P_rec, lengths in _SCAN_CASES.flat_inputs(d):
        packed = pack_2bit(torch.from_numpy(codes)).to(cuda)
        last_i = torch.from_numpy(lengths - (k + 1)).to(cuda)
        for a, b in zip(scan_kernel(packed, k, m, P_rec, last_i),
                        scan_plain(packed, k, m, P_rec, last_i), strict=True):
            assert torch.equal(a, b)


@pytest.mark.parametrize("k,m", _SCAN_CASES.KM)
@pytest.mark.parametrize("kind", _SCAN_CASES.KINDS)
def test_scan2_kernel_equals_plain_on_cases(cuda, kind, k, m):
    """The v2 scan kernel == scan2_plain on tests/scan_cases.py's
    repeats, single record and batch (ties in the window minimum and in
    the sync lookback)."""
    d = _SCAN_CASES.scan_case(kind, k, m)
    for codes, P_rec, _lengths in _SCAN_CASES.flat_inputs(d):
        packed = pack_2bit(torch.from_numpy(codes)).to(cuda)
        for a, b in zip(FU.scan2_kernel(packed, k, m, P_rec),
                        FU.scan2_plain(packed, k, m, P_rec), strict=True):
            assert torch.equal(a, b)


@pytest.mark.parametrize("layout", ["lane", "col"])
@pytest.mark.parametrize("case_id", [c[0] for c in _SWEEP_CASES.CASES])
def test_sweep_kernel_equals_plain_on_edge_cases(cuda, case_id, layout):
    """The sweep kernel == sweep_plain on tests/sweep_cases.py's inputs
    (the col layout's tables are the lane tables transposed)."""
    d = _SWEEP_CASES.case(case_id)
    n = d["se"].shape[1]
    tabs = [torch.from_numpy(a).to(cuda) for a in d["tabs"]]
    if layout == "col":
        tabs = [a.view(n, 256).t().contiguous() for a in tabs]
    args = (tabs, torch.from_numpy(d["se"]).to(cuda),
            torch.from_numpy(d["st0"]).to(cuda), *d["thr"], d["W"],
            d["capl"], d["force_entry"], layout)
    for a, b in zip(TF.sweep_kernel(*args), TF.sweep_plain(*args),
                    strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("s", [1.0, 1000.0])
def test_walk_kernel_equals_plain(cuda, s):
    """The walk kernel == walk_plain on every output, for a sequence's
    first walk and for the next tile entered from its carry."""
    from supersampler_tpu_torch.ops import walker as TW
    from supersampler_tpu_torch.ops.minimizer import scan_tables_2d_packed

    k, m, own, P, L = 31, 11, 1 << 15, (1 << 15) + 512, 100000
    thr = compute_threshold(k, m, s)
    thr = (thr >> 32, thr & 0xFFFFFFFF)
    codes = np.random.default_rng(3).integers(0, 4, 2 * own + 512,
                                             dtype=np.uint8)
    codes[5000:8000] = 2
    init5 = fb = None
    for t in range(2):
        c = torch.from_numpy(codes[t * own : t * own + P].copy())
        tab = scan_tables_2d_packed(pack_2bit(c).to(cuda), k, m, P,
                                    L - t * own, *thr)
        packed = TW.pack_succ(tab, own)
        if init5 is None:
            init5, fb = TW._init5_from_tables(tab), TW._fb_from_tables(tab)
        got = TW.walk_kernel(packed, init5)
        want = TW.walk_plain(packed, init5)
        for a, b in zip(got, want, strict=True):
            assert torch.equal(a, b)
        assert int(got[4][0]) > 1000      # events walked
        init5, fb = TW._carry_next(got[4], tab, fb, own)


@pytest.mark.parametrize("n_blocks", _WALK_CASES.N_BLOCKS)
@pytest.mark.parametrize("kind", _WALK_CASES.KINDS)
def test_walk_kernel_equals_plain_on_cases(cuda, kind, n_blocks):
    """The walk kernel == walk_plain on tests/walk_cases.py's words:
    chains that never merge, entries at the last candidate offset, ends
    mid-walk, late or absent entries, exits past n_pad, all or no events
    selected, alternating types, and real scan tables."""
    from supersampler_tpu_torch.ops import walker as TW
    from supersampler_tpu_torch.ops.minimizer import scan_tables_2d_packed

    def scan_words(codes, s, n_pad):
        thr = compute_threshold(31, 11, s)
        t = scan_tables_2d_packed(pack_2bit(torch.from_numpy(codes)).to(cuda),
                                  31, 11, codes.size, codes.size + 1000,
                                  thr >> 32, thr & 0xFFFFFFFF)
        return (TW.pack_succ(t, n_pad).cpu().numpy(),
                TW._init5_from_tables(t).cpu().numpy())

    words, init5 = _WALK_CASES.walk_case(kind, n_blocks,
                                         scan_words=scan_words)
    words = torch.from_numpy(words).to(cuda)
    init5 = torch.from_numpy(init5).to(cuda)
    for a, b in zip(TW.walk_kernel(words, init5),
                    TW.walk_plain(words, init5), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k,m", [(31, 11), (63, 15), (15, 5)])
def test_scan2_kernel_equals_plain(cuda, k, m):
    """Single record (P = 60,160 positions: 235 lanes, a ragged last
    block) and a batch of 24 records of 2,048 positions."""
    for P, P_rec in ((60160, 60160), (24 * 2048, 2048)):
        packed = _packed(k + P, P, P, cuda)
        got = FU.scan2_kernel(packed, k, m, P_rec)
        want = FU.scan2_plain(packed, k, m, P_rec)
        for a, b in zip(got, want, strict=True):
            assert torch.equal(a, b)


@pytest.mark.parametrize("s", [1.0, 1000.0])
def test_col_sweep_and_fused_equal_plain_and_v1(cuda, s):
    """fused_single / fused_batch with the "col" sweep kernel equal the
    same with sweep_plain and the v1 fetch arrays, homopolymer runs
    included (passes 2..4)."""
    k, m, P, L = 31, 11, 1 << 16, 60000
    thr = compute_threshold(k, m, s)
    thr = (thr >> 32, thr & 0xFFFFFFFF)
    c = np.zeros(128 + P, np.uint8)
    c[128 : 128 + L] = np.random.default_rng(9).integers(0, 4, L)
    c[20000:23000] = 1
    slab = pack_2bit(torch.from_numpy(c)).to(cuda)
    got = FU.fused_single(slab, k, m, P, 1 << 14, L, *thr)
    assert torch.equal(got, FU.fused_single(slab, k, m, P, 1 << 14, L, *thr,
                                            sweep=TF.sweep_plain))
    t = TF.scan_field_2d_packed(slab[32:], k, m, P, L)
    assert torch.equal(got, TF.resolve_field(
        t, k, m, 1 << 14, TF.field_entry_init(t, *thr), *thr))
    B_n, P_rec = 32, 2048
    rc = np.random.default_rng(10).integers(0, 4, (B_n, P_rec)).astype(
        np.uint8)
    lens = np.random.default_rng(11).integers(0, 2001, B_n).astype(np.int32)
    lens[::5] = 0
    rc[1, :1500] = 2
    packed = pack_2bit(torch.from_numpy(rc.reshape(-1))).to(cuda).view(
        B_n, -1)
    lengths = torch.from_numpy(np.where(lens >= k, lens, 0)).to(cuda)
    got = FU.fused_batch(packed, k, m, P_rec, 1 << 14, lengths, *thr)
    assert torch.equal(got, FU.fused_batch(packed, k, m, P_rec, 1 << 14,
                                           lengths, *thr,
                                           sweep=TF.sweep_plain))
    bt = TF.scan_field_batched(packed, k, m, P_rec, lengths)
    assert torch.equal(got, TF.resolve_field_batched(bt, k, m, 1 << 14,
                                                     P_rec, *thr))


def _golden_big(tmp_path, device, engine):
    here = os.path.dirname(os.path.abspath(__file__))
    data = _load("make_data").make_all(str(tmp_path))
    with gzip.open(os.path.join(here, "golden",
                                "sketch_big_k31_m11_s100_a1.gz")) as f:
        golden = f.read()
    ss = TorchSubsampler(k=31, m=11, s=100.0, device=device)
    ss.scan_engine = engine
    assert ss.sketch_file(data["big"]) == golden


def test_golden_sketch_on_cuda(cuda, tmp_path):
    _golden_big(tmp_path, cuda, "field")


def test_golden_sketch_on_cuda_legacy_engine(cuda, tmp_path):
    _golden_big(tmp_path, cuda, "legacy")


def test_golden_sketch_on_cuda_v2(cuda, tmp_path, monkeypatch):
    monkeypatch.setenv("SPSP_FUSED", "1")
    FU.scan2_kernel.launches = 0
    _golden_big(tmp_path, cuda, "field")
    assert FU.scan2_kernel.launches > 0


def test_sketch_fof_on_cuda_equals_cpu(cuda, tmp_path):
    """sketch_fof on the card over the family inputs, the gzipped
    genome, a missing entry and a file of headers only: the CPU path's
    bytes, and the card's per-file sketch_file bytes."""
    from supersampler_tpu_torch.sketch import sketch_fof

    data = _load("make_data").make_all(str(tmp_path))
    headers = tmp_path / "headers.fa"
    headers.write_bytes(b">a\n>b\n")
    paths = [data["fam0"], data["big"], str(tmp_path / "missing.fa"),
             str(headers), data["fam1"], data["fam2"], data["fam3"]]
    out = {}
    for dev in (cuda, "cpu"):
        sss = [TorchSubsampler(k=31, m=11, s=15.0, device=dev)
               for _ in paths]
        for ss in sss:
            ss.log = open(os.devnull, "w")
        out[str(dev)] = sketch_fof(list(zip(sss, paths)))
        for ss in sss:
            ss.log.close()
    alone = []
    for p in paths:
        ss = TorchSubsampler(k=31, m=11, s=15.0, device=cuda)
        ss.log = open(os.devnull, "w")
        alone.append(ss.sketch_file(p))
        ss.log.close()
    assert out[str(cuda)] == out["cpu"] == alone
    assert out["cpu"][2] is None


@pytest.mark.parametrize("engine", ["field", "legacy"])
@pytest.mark.parametrize("flags", [{"device_dedup": True},
                                   {"native_finisher": False}])
def test_golden_sketch_on_cuda_through_the_store(cuda, tmp_path, flags,
                                                 engine):
    """The device-dedup path and the Python store on the card: the
    golden's bytes on both engines."""
    here = os.path.dirname(os.path.abspath(__file__))
    data = _load("make_data").make_all(str(tmp_path))
    with gzip.open(os.path.join(here, "golden",
                                "sketch_big_k31_m11_s100_a1.gz")) as f:
        golden = f.read()
    ss = TorchSubsampler(k=31, m=11, s=100.0, device=cuda)
    ss.scan_engine = engine
    for name, value in flags.items():
        setattr(ss, name, value)
    assert ss.sketch_file(data["big"]) == golden


@pytest.mark.parametrize("s", [1.0, 64.0])
def test_dedup_spans_on_cuda_equals_cpu(cuda, s):
    from supersampler_tpu_torch.ops.dedup import dedup_spans

    k, m, P, L = 31, 11, 1 << 16, 60000
    codes = np.zeros(P, np.uint8)
    codes[128 : 128 + L] = np.random.default_rng(3).integers(0, 4, L)
    ss = TorchSubsampler(k=k, m=m, s=s, device="cpu")
    comp, _ = ss._fetch_scan(ss._launch_scan(
        np.frombuffer(b"ACTG", np.uint8)[codes[128 : 128 + L]]))
    n = comp[0].size
    spans = [np.full(n + 1, -1, np.int64) for _ in range(2)]
    spans[0][:n], spans[1][:n] = comp[0] + 128, comp[1] + 128
    val = np.zeros(n + 1, np.int64)
    val[:n] = comp[2]
    rev = np.zeros(n + 1, bool)
    rev[:n] = comp[3]
    K = 1 << 16
    out = [dedup_spans(torch.from_numpy(codes).to(dev),
                       tuple(torch.from_numpy(a).to(dev)
                             for a in (*spans, val, rev))
                       + (torch.tensor(n, device=dev),), k, m, P, K)
           for dev in (cuda, "cpu")]
    n_unique = int(out[1][1])
    assert int(out[0][0]) == int(out[1][0]) <= K and n_unique > 0
    assert int(out[0][1]) == n_unique
    for a, b in zip(out[0][2:], out[1][2:]):
        assert torch.equal(a[:n_unique].cpu(), b[:n_unique])


@pytest.mark.parametrize("chunk_groups", [512, 1 << 18])
@pytest.mark.parametrize("n_files", [1, 4, 17, 64, 130])
def test_score_matrix_on_cuda_equals_cpu(cuda, n_files, chunk_groups):
    """The presence product through torch._int_mm on the card equals
    the CPU's at file counts on each side of its shape rules (more than
    16 rows, sizes multiples of 8); 10,000 groups take three steps at
    chunk_groups=512."""
    rng = np.random.default_rng(n_files)
    pres = rng.random((10000, n_files)) < rng.random(n_files)
    pres[:, 0] |= ~pres.any(1)
    gids, fids = (x.astype(np.int32) for x in np.nonzero(pres))
    CD.presence_product.launches = 0
    got = CD.score_matrix_device(gids, fids, 10000, n_files,
                                 ME.make_mesh([cuda]),
                                 chunk_groups=chunk_groups)
    assert CD.presence_product.launches == (3 if chunk_groups == 512 else 1)
    want = CD.score_matrix_device(gids, fids, 10000, n_files,
                                  ME.make_mesh(["cpu"]),
                                  chunk_groups=chunk_groups)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    assert np.array_equal(got, pres.T.astype(np.int64)
                          @ pres.astype(np.int64))


@pytest.mark.parametrize("s", [1.0, 1000.0])
def test_kernels_on_a_card_that_is_not_current(cuda, s):
    """Each wrapper makes its tensors' card current for the launch: the
    scan, scan2, lane and col sweeps and walk on the last card, with
    cuda:0 current, equal their plain versions."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    other = torch.device("cuda", torch.cuda.device_count() - 1)
    with torch.cuda.device(0):
        test_scan_kernel_equals_plain(other, 31, 11)
        test_scan2_kernel_equals_plain(other, 31, 11)
        test_col_sweep_and_fused_equal_plain_and_v1(other, s)
        test_walk_kernel_equals_plain(other, s)
        assert torch.cuda.current_device() == 0


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("n_entries", [1, 2, 4, "every card"])
def test_sharded_resolve_on_cuda_equals_one_device(cuda, monkeypatch,
                                                   n_entries, fused):
    """The sharded field resolve over a mesh naming cuda:0 n_entries
    times, or over make_mesh() (every card), equals one
    scan_resolve_batch of the whole batch on the current card, record
    for record, on v1 and v2; every shard launches the scan (v2: scan2)
    and sweep kernels."""
    if fused:
        monkeypatch.setenv("SPSP_FUSED", "1")
    k, m, P_rec, cap, B = 31, 11, 2048, 1 << 14, 64
    thr = compute_threshold(k, m, 100.0)
    thr = (thr >> 32, thr & 0xFFFFFFFF)
    mesh = ME.make_mesh(None if n_entries == "every card"
                        else ["cuda:0"] * n_entries)
    rng = np.random.default_rng(mesh.size)
    lengths = rng.integers(1000, 1900, B).astype(np.int32)
    codes = rng.integers(0, 4, (B, P_rec), dtype=np.uint8)
    codes[np.arange(P_rec) >= lengths[:, None]] = 0
    packed = pack_2bit(torch.from_numpy(codes)).reshape(B, -1)
    lengths = torch.from_numpy(lengths)
    scan = FU.scan2_kernel if fused else scan_kernel
    counts = []

    def counted(*args):
        before = (scan.launches, TF.sweep_kernel.launches)
        out = TF.scan_resolve_batch(*args)
        counts.append((scan.launches - before[0],
                       TF.sweep_kernel.launches - before[1]))
        return out

    monkeypatch.setattr(ME, "scan_resolve_batch", counted)
    rows = ME.sharded_field_resolve_fn(mesh, k, m, P_rec, cap)(
        packed, lengths, *thr)
    assert len(counts) == mesh.size and all(a > 0 and b > 0
                                            for a, b in counts)
    whole = TF.scan_resolve_batch(packed.to(cuda), k, m, P_rec, cap,
                                  lengths.to(cuda), *thr).cpu().numpy()
    g, _n, want, st = TF.parse_batched_array(whole, cap, B)
    assert g == 0 and want is not None
    got = []
    for row in rows:
        g, _n, comps, _st = TF.parse_batched_array(row, cap, B // mesh.size)
        assert g == 0
        got.extend(comps)
    for b in range(B):
        for x, y in zip(got[b], want[b], strict=True):
            assert np.array_equal(np.asarray(x), np.asarray(y)), b


@pytest.mark.parametrize("n_files", [1, 17, 130])
def test_mesh_score_matrix_on_cuda_equals_cpu(cuda, n_files):
    """score_matrix_device over a 4-entry mesh on the card (one block
    and one total per entry, all on cuda:0) equals one CPU device."""
    rng = np.random.default_rng(n_files)
    pres = rng.random((20000, n_files)) < rng.random(n_files)
    pres[:, 0] |= ~pres.any(1)
    gids, fids = (x.astype(np.int32) for x in np.nonzero(pres))
    CD.presence_product.launches = 0
    got = CD.score_matrix_device(gids, fids, 20000, n_files,
                                 ME.make_mesh(["cuda:0"] * 4),
                                 chunk_groups=512)
    # 20,000 groups in slices of 4,096: 5 slices, 2 steps of 4 entries
    assert CD.presence_product.launches == 8
    want = CD.score_matrix_device(gids, fids, 20000, n_files,
                                  ME.make_mesh(["cpu"]))
    assert got.dtype == np.int64 and np.array_equal(got, want)


def test_dryrun_multichip_on_every_card(cuda):
    """dryrun_multichip over make_mesh(): one shard on each visible
    card."""
    from supersampler_tpu_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(torch.cuda.device_count())
