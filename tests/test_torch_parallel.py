"""The port's multi-device paths against the JAX package's, on the CPU.

A mesh of CPU entries (``make_mesh(["cpu"] * 8)``) stands for eight
devices; JAX runs on the 8-device virtual CPU mesh of tests/conftest.py.
The sharded field resolve, the sharded scan and the mesh score matrix
must equal JAX's on the inputs of tests/test_parallel.py, array for
array and bit for bit; the mesh comparator's CSVs must equal JAX's
byte for byte."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import supersampler_tpu.parallel.compare_dist as JCD
import supersampler_tpu.parallel.mesh as JM
import supersampler_tpu_torch.parallel.compare_dist as TCD
import supersampler_tpu_torch.parallel.mesh as TM
from supersampler_tpu.compare.merge import TpuComparator
from supersampler_tpu.core.scalar import compute_threshold
from supersampler_tpu.ops.field import (parse_batched_array as
                                        j_parse_batched_array)
from supersampler_tpu.ops.minimizer import pack_2bit_np
from supersampler_tpu_torch.compare.merge import TorchComparator
from supersampler_tpu_torch.ops.field import (parse_batched_array,
                                              scan_resolve_batch)
from supersampler_tpu_torch.parallel.dryrun import dryrun_multichip

_GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
_FILES = [os.path.join(_GOLD, f"gfam_fam{i}.gz") for i in range(4)]


def _cpu_mesh(n):
    return TM.make_mesh(["cpu"] * n)


def _jax_mesh():
    return JM.make_mesh(jax.devices()[:8])


def _thr(k, m, s):
    thr = compute_threshold(k, m, s)
    return thr >> 32, thr & 0xFFFFFFFF


def _resolve_inputs():
    """tests/test_parallel.py:208-220: 16 records of P_rec 1,024."""
    P_rec, B = 1024, 16
    rng = np.random.default_rng(23)
    packed = np.zeros((B, P_rec // 4), np.uint8)
    lengths = rng.integers(100, 900, size=B).astype(np.int32)
    for b in range(B):
        codes = rng.integers(0, 4, size=P_rec, dtype=np.uint8)
        codes[lengths[b]:] = 0
        packed[b] = pack_2bit_np(codes)
    return packed, lengths


@pytest.fixture(scope="module")
def jax_resolve_rows():
    k, m, P_rec, cap = 31, 11, 1024, 2048
    thr = _thr(k, m, 4.0)
    packed, lengths = _resolve_inputs()
    fn = JM.sharded_field_resolve_fn(_jax_mesh(), k, m, P_rec, cap)
    return np.asarray(fn(jnp.asarray(packed), jnp.asarray(lengths),
                         jnp.uint32(thr[0]), jnp.uint32(thr[1])))


def test_sharded_field_resolve_matches_jax(jax_resolve_rows):
    k, m, P_rec, cap, n_dev = 31, 11, 1024, 2048, 8
    thr = _thr(k, m, 4.0)
    packed, lengths = _resolve_inputs()
    fn = TM.sharded_field_resolve_fn(_cpu_mesh(n_dev), k, m, P_rec, cap)
    rows = fn(torch.from_numpy(packed), torch.from_numpy(lengths), *thr)
    assert rows.dtype == np.int32
    np.testing.assert_array_equal(rows, jax_resolve_rows)
    got, want = [], []
    for d in range(n_dev):
        g, n_total, comps, st = parse_batched_array(rows[d], cap, 2)
        jg, jn, jcomps, jst = j_parse_batched_array(jax_resolve_rows[d],
                                                    cap, 2)
        assert (g, n_total) == (jg, jn) and g == 0 and n_total <= cap
        np.testing.assert_array_equal(st, jst)
        got.extend(comps)
        want.extend(jcomps)
    for b, (x, y) in enumerate(zip(got, want, strict=True)):
        for i, (a, c) in enumerate(zip(x, y, strict=True)):
            assert np.array_equal(np.asarray(a), np.asarray(c)), (b, i)
            assert np.asarray(a).dtype == np.asarray(c).dtype, (b, i)


@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_sharded_field_resolve_matches_one_device(n_dev):
    """Every shard's records equal one scan_resolve_batch of the whole
    batch, parsed record by record, whatever the mesh size."""
    k, m, P_rec, cap = 31, 11, 1024, 2048
    thr = _thr(k, m, 4.0)
    packed, lengths = (torch.from_numpy(a) for a in _resolve_inputs())
    rows = TM.sharded_field_resolve_fn(_cpu_mesh(n_dev), k, m, P_rec,
                                       cap)(packed, lengths, *thr)
    assert rows.shape[0] == n_dev
    whole = scan_resolve_batch(packed, k, m, P_rec, cap, lengths,
                               *thr).numpy()
    g, _n, want, st = parse_batched_array(whole, cap, 16)
    assert g == 0
    got, got_st = [], []
    for row in rows:
        g, _n, comps, st_d = parse_batched_array(row, cap, 16 // n_dev)
        assert g == 0
        got.extend(comps)
        got_st.extend(st_d)
    np.testing.assert_array_equal(got_st, st)
    for b in range(16):
        for a, c in zip(got[b], want[b], strict=True):
            assert np.array_equal(np.asarray(a), np.asarray(c)), b


def test_parse_batched_array_matches_jax_when_truncated():
    """A cap below the batch's selections: both parsers report the
    total and no bodies."""
    k, m, P_rec, cap = 31, 11, 1024, 16
    thr = _thr(k, m, 4.0)
    packed, lengths = (torch.from_numpy(a) for a in _resolve_inputs())
    arr = scan_resolve_batch(packed, k, m, P_rec, cap, lengths,
                             *thr).numpy()
    got = parse_batched_array(arr, cap, 16)
    assert got[1] > cap and got[2:] == (None, None)
    assert got == j_parse_batched_array(arr, cap, 16)


def test_sharded_scan_matches_jax():
    """tests/test_parallel.py:179-200: 8 records of 4,096 positions;
    uint32 fields compared as bit patterns (the port keeps int32)."""
    k, m, P = 31, 11, 4096
    thr = _thr(k, m, 10.0)
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, size=(8, P), dtype=np.uint8)
    lengths = np.full(8, P - 7, np.int32)
    want = JM.sharded_scan_fn(_jax_mesh(), k, m, P)(
        jnp.asarray(codes), jnp.asarray(lengths), jnp.uint32(thr[0]),
        jnp.uint32(thr[1]))
    got = TM.sharded_scan_fn(_cpu_mesh(8), k, m, P)(
        torch.from_numpy(codes), torch.from_numpy(lengths), *thr)
    one = TM.batched_scan_fn(k, m, P)(torch.from_numpy(codes),
                                      torch.from_numpy(lengths), *thr)
    for f in want._fields:
        w = np.asarray(getattr(want, f))
        if w.dtype == np.uint32:
            w = w.view(np.int32)
        g = getattr(got, f).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)
        assert torch.equal(getattr(one, f), getattr(got, f)), f


@pytest.mark.parametrize("n_dev", [3, 5])
def test_batch_not_a_multiple_of_the_mesh_raises(n_dev):
    packed, lengths = (torch.from_numpy(a) for a in _resolve_inputs())
    mesh = _cpu_mesh(n_dev)
    with pytest.raises(ValueError, match="not a multiple"):
        TM.sharded_field_resolve_fn(mesh, 31, 11, 1024, 2048)(
            packed, lengths, 0, 0)
    codes = torch.zeros((16, 1024), dtype=torch.uint8)
    with pytest.raises(ValueError, match="not a multiple"):
        TM.sharded_scan_fn(mesh, 31, 11, 1024)(codes, lengths, 0, 0)


def test_make_mesh_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="TORCH_DEVICE"):
        TM.make_mesh()
    mesh = TM.make_mesh(["cpu"] * 3)
    assert mesh.size == 3
    assert mesh.devices == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError):
        TM.make_mesh([])


def _presence(source):
    """(gids, fids, n_groups, n_files) of the golden family or of random
    presence at N files (tests/test_torch_compare.py's inputs)."""
    if source == "golden":
        gids, fids, n_groups, _seen, _k, _m = TCD.build_presence_chunks(
            _FILES)
        return gids, fids, n_groups, len(_FILES)
    n = int(source)
    rng = np.random.default_rng(n)
    pres = rng.random((9000, n)) < rng.random(n)
    pres[:, 0] |= ~pres.any(1)
    gids, fids = (x.astype(np.int32) for x in np.nonzero(pres))
    return gids, fids, 9000, n


@pytest.mark.parametrize("chunk_groups", [512, 1 << 18])
@pytest.mark.parametrize("source", ["golden", "1", "9", "30"])
def test_mesh_score_matrix_matches_jax(source, chunk_groups):
    gids, fids, n_groups, n = _presence(source)
    got = TCD.score_matrix_device(gids, fids, n_groups, n, _cpu_mesh(8),
                                  chunk_groups=chunk_groups)
    want = JCD.score_matrix_device(gids, fids, n_groups, n,
                                   mesh=_jax_mesh(),
                                   chunk_groups=chunk_groups)
    one = JCD.score_matrix_device(gids, fids, n_groups, n, mesh=None,
                                  chunk_groups=chunk_groups)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, one)
    np.testing.assert_array_equal(
        got, TCD.score_matrix_device(gids, fids, n_groups, n, _cpu_mesh(1),
                                     chunk_groups=chunk_groups))


def test_mesh_score_matrix_steps_and_launches(monkeypatch):
    """A step covers chunk_groups groups per entry; every entry
    multiplies one block a step (as every JAX device does), on its own
    block: entries naming one device do not share a buffer."""
    gids, fids, n_groups, n = _presence("9")
    blocks = []

    def product(block):
        blocks.append(block)
        return torch._int_mm(block, block.T)

    monkeypatch.setattr(TCD, "presence_product", product)
    got = TCD.score_matrix_device(gids, fids, n_groups, n, _cpu_mesh(2),
                                  chunk_groups=512)
    # 9,000 groups: steps of 2 x 4,096 groups, so 2 steps, 4 products
    assert TCD.step_groups(n_groups, n, 512, 2) == 4096
    assert len(blocks) == 4
    assert len({b.data_ptr() for b in blocks}) == 2
    np.testing.assert_array_equal(
        got, TCD.score_matrix_device(gids, fids, n_groups, n, _cpu_mesh(1)))


def _jax_step_groups(n_groups, n_files, chunk_groups, n_dev):
    """supersampler_tpu/parallel/compare_dist.py:121-123, verbatim."""
    chunk_groups = min(chunk_groups, -(-n_groups // n_dev),
                       max(4096, (128 << 20) // (n_files * n_dev)))
    return 1 << max(12, (chunk_groups - 1).bit_length())


@pytest.mark.parametrize("n_dev", [1, 3, 8])
def test_step_groups_matches_jax(n_dev):
    for n_groups in (1, 4095, 4097, 9000, 910_438, 50_000_000):
        for n_files in (1, 4, 64, 130, 5000):
            for chunk_groups in (512, 4096, 1 << 18, 1 << 22):
                assert (TCD.step_groups(n_groups, n_files, chunk_groups,
                                        n_dev)
                        == _jax_step_groups(n_groups, n_files, chunk_groups,
                                            n_dev))


@pytest.mark.parametrize("query", [False, True])
def test_mesh_comparator_matches_jax(query):
    kw = dict(precision=3, min_threshold=0.05) if query else {}
    qs = 2 if query else len(_FILES)
    t = TorchComparator(engine="device", mesh=_cpu_mesh(8), **kw)
    j = TpuComparator(engine="device", mesh=_jax_mesh(), **kw)
    for c in (t, j):
        c.files_names = list(_FILES)
        c.compare_sketches(qs)
    assert t.score_A == j.score_A and t.score_A
    assert t.nb_kmer_seen_infile == j.nb_kmer_seen_infile
    assert t.containment_csv() == j.containment_csv()
    assert t.jaccard_csv() == j.jaccard_csv()


def test_mesh_comparator_rejects_numpy_engine_and_device():
    with pytest.raises(ValueError, match="device engine"):
        TorchComparator(engine="numpy", mesh=_cpu_mesh(2))
    with pytest.raises(ValueError, match="not both"):
        TorchComparator(engine="device", device="cpu", mesh=_cpu_mesh(2))


def test_comparator_device_is_a_mesh_of_one(monkeypatch):
    """A device (given, or $TORCH_DEVICE's) becomes a one-entry mesh;
    the numpy engine holds none."""
    assert TorchComparator(device="cpu").mesh == _cpu_mesh(1)
    monkeypatch.setenv("TORCH_DEVICE", "cpu")
    assert TorchComparator().mesh == _cpu_mesh(1)
    assert TorchComparator(engine="numpy").mesh is None


def test_kernel_launch_makes_the_tensors_device_current(monkeypatch):
    """ops/_build.launch calls a C entry with the given card made
    current and on that card's stream, then restores the current card:
    a shard on cuda:1 launches there while cuda:0 is current."""
    from supersampler_tpu_torch.ops import _build

    current = ["cuda:0"]
    calls = []

    class Device:              # stands in for torch.cuda.device
        def __init__(self, dev):
            self.dev = str(dev)

        def __enter__(self):
            self.prev, current[0] = current[0], self.dev

        def __exit__(self, *exc):
            current[0] = self.prev

    class Stream:
        def __init__(self, dev):
            self.cuda_stream = f"stream of {dev}"

    class Lib:
        def spsp_scan(self, *args):
            calls.append((current[0], args))
            return 0

    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    monkeypatch.setattr(_build, "lib", Lib)
    _build.launch("spsp_scan", torch.device("cuda:1"), 3, 4)
    assert calls == [("cuda:1", (3, 4, "stream of cuda:1"))]
    assert current == ["cuda:0"]


def test_dryrun_multichip_on_cpu_entries(capsys):
    dryrun_multichip(8, devices=["cpu"] * 8)
    assert "dryrun_multichip(8)" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="need 4 devices"):
        dryrun_multichip(4, devices=["cpu"] * 3)
