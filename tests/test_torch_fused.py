"""The port's v2 path (ops/fused.py) on the CPU, bit-exact.

* scan2_plain == JAX ``_scan2`` (Pallas interpret mode) on live rows:
  the seven tables mapped from the TPU's (tiles, 256, 128) half-major
  blocks to the port's (256, n_lanes) column layout, the first-sync
  column of every lane (aux lanes 0/1) and each record's window-0
  election (aux lanes 4..7); single (rpr = 0) and batch (rpr > 0), with
  one and with several live row tiles (the sync carry across tiles).
* port fused_single / fused_batch == the JAX v1 fetch arrays on every
  case of tests/test_fused.py (JAX ``fused_*`` in interpret mode costs
  minutes per case, so v1 is the reference here).
* the 10 goldens, byte-identical with the v2 path forced on.
* sweep_plain reads the "col" layout as it reads the "lane" layout.
Tolerance: 0 (integer outputs)."""

import gzip
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import supersampler_tpu_torch.ops.field as TF
from supersampler_tpu.core.scalar import compute_threshold
from supersampler_tpu.ops.field import (_scan_resolve_batch_v1,
                                        field_entry_init, resolve_field,
                                        scan_field_2d_packed)
from supersampler_tpu.ops.fused import _scan2
from supersampler_tpu.ops.minimizer import pack_2bit_np
from supersampler_tpu_torch.ops import fused as FU
from supersampler_tpu_torch.ops.scan_kernel import scan_plain
from supersampler_tpu_torch.sketch import TorchSubsampler
from tests import scan_cases as SC

K, M = 31, 11
_C = 512                       # JAX row width (two 256-position blocks)
_scan_split = jax.jit(scan_field_2d_packed, static_argnums=(1, 2, 3, 5))

_GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
with open(os.path.join(_GOLD, "meta.json")) as _f:
    _SKETCHES = json.load(_f)["sketches"]


def _thr(k, m, s):
    t = compute_threshold(k, m, s)
    return t >> 32, t & 0xFFFFFFFF


# ----------------------------------------------------------------------
# scan2_plain == JAX _scan2 (interpret)
# ----------------------------------------------------------------------

def _jax_scan2(codes: np.ndarray, k: int, m: int, rpr: int):
    """JAX _scan2 over flat codes laid out as fused_single/fused_batch do
    (fused.py:493-504, :585-596; rows padded to a multiple of 64 only)."""
    W = k - m + 1
    halo = k + W
    CP = -(-(_C + halo) // 128) * 128
    R = codes.size // _C
    R8 = -(-R // 64) * 64
    base = codes.reshape(R, _C)
    c2 = np.zeros((R8, CP), np.uint32)
    c2[:R, :_C] = base
    c2[:R, _C : _C + halo] = np.roll(base, -1, axis=0)[:, :halo]
    tT, aux = _scan2(jnp.asarray(c2), k, m, CP, rpr, -(-R // 64), True)
    return [np.asarray(a) for a in tT], np.asarray(aux)


def _to_cols(a: np.ndarray, n: int) -> np.ndarray:
    """(tiles, 256, 128) half-major blocks (lane 128*tile + 64h + r holds
    block 2*(64*tile + r) + h) -> (256, n) in block order, as int32."""
    n_t = a.shape[0]
    blk = (a.transpose(1, 0, 2).reshape(256, n_t, 2, 64)
           .swapaxes(-1, -2).reshape(256, n_t * 128))
    return blk[:, :n].view(np.int32)


def _check_scan2(codes, k, m, P_rec, n_rec):
    """scan2_plain == JAX _scan2 on flat codes of n_rec records."""
    tT, aux = _jax_scan2(codes, k, m, 0 if n_rec == 1 else P_rec // _C)
    got = FU.scan2_plain(torch.from_numpy(pack_2bit_np(codes)), k, m, P_rec)
    n = codes.size // 256
    for g, w in zip(got[:7], tT, strict=True):
        assert g.shape == (256, n)
        np.testing.assert_array_equal(g.numpy(), _to_cols(w, n))
    np.testing.assert_array_equal(got[7].numpy(),
                                  aux[:, :2].reshape(-1)[:n])
    heads = np.arange(n_rec) * (P_rec // _C)
    np.testing.assert_array_equal(got[8].numpy(),
                                  aux[heads, 4:8].T.view(np.int32))


@pytest.mark.parametrize("k,m", [(31, 11), (21, 7)])
@pytest.mark.parametrize("n_rec,P_rec", [
    (1, 5 * _C),       # single, one live row tile
    (1, 70 * _C),      # single, two live row tiles
    (8, 2 * _C),       # batch, one row tile
    (2, 96 * _C),      # batch, three row tiles; records span tiles
])
def test_scan2_plain_matches_jax_scan2(k, m, n_rec, P_rec):
    rng = np.random.default_rng(1000 * k + n_rec)
    codes = rng.integers(0, 4, n_rec * P_rec, dtype=np.uint8)
    codes[100:700] = 2                     # a syncless run in record 0
    _check_scan2(codes, k, m, P_rec, n_rec)


@pytest.mark.parametrize("k,m", [(31, 11), (63, 15)])
@pytest.mark.parametrize("kind", SC.KINDS)
def test_scan2_plain_matches_jax_scan2_on_cases(kind, k, m):
    """tests/scan_cases.py's repeats (ties in every window's minimum,
    sync candidates that tie), single record and batch."""
    d = SC.scan_case(kind, k, m)
    for codes, P_rec, lengths in SC.flat_inputs(d):
        _check_scan2(codes, k, m, P_rec, len(lengths))


def test_scan2_plain_is_scan_plain_in_columns():
    """The same tables as v1's scan, transposed; fs is v1's first sync
    before the last_i mask."""
    k, m, P = 31, 11, 4096
    codes = np.random.default_rng(3).integers(0, 4, P, dtype=np.uint8)
    packed = torch.from_numpy(pack_2bit_np(codes))
    *tabs, sync, init = scan_plain(packed, k, m, P,
                                   torch.tensor([P - 1], dtype=torch.int32))
    got = FU.scan2_plain(packed, k, m, P)
    for g, w in zip(got[:7], tabs, strict=True):
        assert torch.equal(g, w.view(-1, 256).t())
    assert torch.equal(got[7], TF._first_sync(sync, P // 256))
    assert torch.equal(got[8], init)


# ----------------------------------------------------------------------
# port fused_* == JAX v1 fetch arrays (the cases of tests/test_fused.py)
# ----------------------------------------------------------------------

def _slab(codes: np.ndarray, P: int) -> np.ndarray:
    c = np.zeros(128 + P, np.uint8)
    c[128 : 128 + len(codes)] = codes
    return pack_2bit_np(c)


def _cmp_single(codes, P, cap=256, s=1000.0, k=K, m=M,
                sweep=TF.sweep_kernel):
    thr = _thr(k, m, s)
    jthr = (jnp.uint32(thr[0]), jnp.uint32(thr[1]))
    slab = _slab(codes, P)
    L = len(codes)
    ft = _scan_split(jnp.asarray(slab)[32:], k, m, P, jnp.int32(L), True)
    want = np.asarray(resolve_field(ft, k, m, cap,
                                    field_entry_init(ft, *jthr), *jthr))
    got = FU.fused_single(torch.from_numpy(slab), k, m, P, cap, L, *thr,
                          sweep=sweep)
    np.testing.assert_array_equal(got.numpy(), want)
    return want


_SINGLE = [
    ("random_small", 0, 450, 512, {}),
    ("random_2473", 1, 2473, 2560, {}),
    ("random_512", 2, 512, 2560, {}),
    ("random_37", 3, 37, 2560, {}),
    ("k_minus_1", 9, K - 1, 512, {}),
    ("k_plus_1", 9, K + 1, 512, {}),
    ("select_all", 4, 450, 512, {"cap": 512, "s": 1.0}),
    ("odd_params", 8, 460, 512, {"s": 500.0, "k": 21, "m": 7}),
]


@pytest.mark.parametrize("name,seed,L,P,kw", _SINGLE,
                         ids=[c[0] for c in _SINGLE])
def test_fused_single_matches_jax_v1(name, seed, L, P, kw):
    codes = np.random.default_rng(seed).integers(0, 4, L, dtype=np.uint8)
    _cmp_single(codes, P, **kw)


@pytest.mark.parametrize("codes,n_sweeps", [
    (np.zeros(2400, np.uint8), 5),
    (np.random.default_rng(7).integers(0, 4, 2400, dtype=np.uint8), 2),
], ids=["homopolymer", "random"])
def test_fused_single_prefix_pass_gate(codes, n_sweeps):
    """A homopolymer has no strict hash minima, hence no syncs: passes
    2..4 must run (and leave lanes open, status != 0 in both). Where
    every lane has a sync, pass 1 settles every prefix and the sweep
    runs twice."""
    calls = []

    def counted(*a):
        calls.append(a[7])                   # force_entry
        return TF.sweep_plain(*a)

    want = _cmp_single(codes, 2560, sweep=counted)
    assert len(calls) == n_sweeps
    assert (want[0] != 0) == (n_sweeps == 5)


def _batch(seed, P_rec, lens, homopolymer_even=False):
    rng = np.random.default_rng(seed)
    pack = np.zeros((len(lens), P_rec >> 2), np.uint8)
    lengths = np.zeros(len(lens), np.int32)
    for b, L in enumerate(lens):
        codes = np.zeros(P_rec, np.uint8)
        if homopolymer_even and b % 2 == 0:
            codes[:L] = 1
        else:
            codes[:L] = rng.integers(0, 4, size=L, dtype=np.uint8)
        pack[b] = pack_2bit_np(codes)
        lengths[b] = L if L >= K else 0
    return pack, lengths


@pytest.mark.parametrize("case", ["lengths", "homopolymer_mix"])
def test_fused_batch_matches_jax_v1(case):
    if case == "lengths":
        P_rec, cap = 512, 512
        pack, lengths = _batch(5, P_rec, [400, 0, K - 1, K + 2, 350, 71,
                                          1, 440])
    else:
        P_rec, cap = 1024, 2048
        pack, lengths = _batch(6, P_rec, [600 + 17 * b for b in range(8)],
                               homopolymer_even=True)
    thr = _thr(K, M, 1000.0)
    want = np.asarray(_scan_resolve_batch_v1(
        jnp.asarray(pack), K, M, P_rec, cap, jnp.asarray(lengths),
        jnp.uint32(thr[0]), jnp.uint32(thr[1])))
    got = FU.fused_batch(torch.from_numpy(pack), K, M, P_rec, cap,
                         torch.from_numpy(lengths), *thr)
    np.testing.assert_array_equal(got.numpy(), want)


# ----------------------------------------------------------------------
# the goldens through the v2 path; the sweep's two layouts
# ----------------------------------------------------------------------

@pytest.mark.parametrize("cfg", _SKETCHES, ids=[c["file"] for c in
                                                 _SKETCHES])
def test_golden_sketch_on_cpu_v2(cfg, datadir, goldendir, monkeypatch):
    calls = []
    plain = FU.scan2_plain

    def counted(*a):
        calls.append(a[3])
        return plain(*a)

    monkeypatch.setattr(TF, "_use_fused", lambda device: True)
    monkeypatch.setattr(FU, "scan2_plain", counted)
    with gzip.open(os.path.join(goldendir, cfg["file"]), "rb") as f:
        golden = f.read()
    ss = TorchSubsampler(k=cfg["k"], m=cfg["m"],
                         s=float(np.float32(cfg["s"])), abundance=cfg["a"],
                         device="cpu")
    assert ss.sketch_file(datadir[cfg["dataset"]]) == golden
    assert calls                             # the v2 scan ran


@pytest.mark.parametrize("force_entry", [False, True])
def test_sweep_plain_col_layout_equals_lane_layout(force_entry):
    k, m, P, L = 31, 11, 4096, 3900
    W = k - m + 1
    thr = _thr(k, m, 4.0)
    codes = np.random.default_rng(11).integers(0, 4, P, dtype=np.uint8)
    *tabs, _sync, _init = scan_plain(
        torch.from_numpy(pack_2bit_np(codes)), k, m, P,
        torch.tensor([L - k - 1], dtype=torch.int32))
    n = P // 256
    rng = np.random.default_rng(12)
    se = torch.from_numpy(np.stack([
        rng.integers(0, 64, n), rng.integers(128, 257, n),
        rng.integers(0, 2, n), np.arange(n) * 256,
        np.full(n, L - k - 1)]).astype(np.int32))
    st0 = torch.from_numpy(np.stack([
        rng.integers(0, 1 << 31, n), rng.integers(0, 1 << 31, n),
        rng.integers(0, 1 << 31, n), np.arange(n) * 256 + 5,
        np.arange(n) * 256 - 1, np.zeros(n)]).astype(np.int32))
    cols = [a.view(n, 256).t().contiguous() for a in tabs]
    lane = TF.sweep_plain(tabs, se, st0, *thr, W, 16, force_entry)
    col = TF.sweep_plain(cols, se, st0, *thr, W, 16, force_entry, "col")
    for a, b in zip(lane, col, strict=True):
        assert torch.equal(a, b)
    assert int(lane[0][5].sum()) > 0         # events happened
