"""Port exact fallback engine == JAX exact engine on the CPU.

Successor tables (supersampler_tpu_torch.ops.minimizer.scan_tables_2d_
packed vs supersampler_tpu.ops.minimizer.scan_tables_2d), pack_succ,
the walk (walk_plain vs walk_xla, the JAX walk's CPU form: one block of
n_pad), compaction (DeviceChain), the tile carry and the field<->walker
state converters, on numpy-seeded inputs; the walk also on every kind of
tests/walk_cases.py, where the numpy model of the CUDA walk's block
design (walk_cases.block_model) must equal walk_plain. Tolerance:
bit-exact on every field and array."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import supersampler_tpu.ops.field as JF
import supersampler_tpu.ops.walker as JW
import supersampler_tpu_torch.ops.field as TF
import supersampler_tpu_torch.ops.walker as TW
from supersampler_tpu.core.scalar import compute_threshold
from supersampler_tpu.ops import u64 as JU
from supersampler_tpu.ops.minimizer import pack_2bit_np, scan_tables_2d
from supersampler_tpu_torch.ops.minimizer import scan_tables_2d_packed
from tests import walk_cases as WC

_jscan = jax.jit(scan_tables_2d, static_argnums=(1, 2, 3))
_jscan_field = jax.jit(JF.scan_field_2d, static_argnums=(1, 2, 3, 5))


def _thr(k, m, s):
    thr = compute_threshold(k, m, s)
    return thr >> 32, thr & 0xFFFFFFFF


def _codes(kind, seed, P, L):
    rng = np.random.default_rng(seed)
    c = np.zeros(P, np.uint8)
    c[:L] = rng.integers(0, 4, L, dtype=np.uint8)
    if kind == "repeat":
        unit = rng.integers(0, 4, 37, dtype=np.uint8)
        c[200 : L - 100] = np.resize(unit, L - 300)
    elif kind == "homopolymer":
        c[300 : L - 300] = 2
    return c


def _both(codes, k, m, P, L, s):
    """(JAX ScanTables, port ScanTables) of one sequence."""
    thr = _thr(k, m, s)
    jt = _jscan(jnp.asarray(codes), k, m, P, jnp.int32(L),
                JU.U64(jnp.uint32(thr[0]), jnp.uint32(thr[1])))
    tt = scan_tables_2d_packed(torch.from_numpy(pack_2bit_np(codes)), k, m,
                               P, L, *thr)
    return jt, tt


def _np(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


@pytest.mark.parametrize("k,m", [(31, 11), (63, 15), (15, 5)])
@pytest.mark.parametrize("kind", ["random", "repeat", "homopolymer"])
def test_scan_tables_match_jax(kind, k, m):
    P, L = 2048, 1850
    jt, tt = _both(_codes(kind, k * 7 + m, P, L), k, m, P, L, 8.0)
    for f in jt._fields:
        want, got = _np(getattr(jt, f)), getattr(tt, f).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("n_pad", [4096, 2048])   # padded, truncated
def test_pack_succ_matches_jax(n_pad):
    jt, tt = _both(_codes("random", 1, 4096, 3000), 31, 11, 4096, 3000,
                   5.0)
    np.testing.assert_array_equal(TW.pack_succ(tt, n_pad).numpy(),
                                  np.asarray(JW.pack_succ(jt, n_pad)))


def _emitted(ei, el, es, cnt):
    """Emitted rows in walk order: each block's first cnt[b] rows."""
    cnt = np.asarray(cnt).reshape(-1)
    return [np.concatenate([np.asarray(a)[b, : cnt[b]]
                            for b in range(cnt.size)]) for a in (ei, el, es)]


def _check_walk(jpacked, jinit5, tpacked, tinit5):
    xe = JW.walk_xla(jpacked, jinit5)
    te = TW.walk_plain(tpacked, tinit5)
    np.testing.assert_array_equal(te[4].numpy(), np.asarray(xe[4]))
    assert int(te[3].sum()) == int(xe[3][0])
    for got, want in zip(_emitted(*te[:4]), _emitted(*xe[:4])):
        np.testing.assert_array_equal(got, want)
    # rows past each block's count stay -1
    for a in te[:3]:
        rows = np.arange(TW._BP)[None, :] >= te[3].numpy()[:, None]
        assert np.all(a.numpy()[rows] == -1)
    return xe, te


@pytest.mark.parametrize("s", [10.0, 1.0])
def test_walk_plain_matches_walk_xla(s):
    jt, tt = _both(_codes("homopolymer", 2, 8192, 7000), 31, 11, 8192, 7000,
                   s)
    xe, te = _check_walk(JW.pack_succ(jt, 8192), JW._init5_from_tables(jt),
                         TW.pack_succ(tt, 8192), TW._init5_from_tables(tt))
    # events walked, some emitted, and the chain ended inside the walk
    assert int(xe[4][0]) > 100 and int(xe[3][0]) > 0
    assert int(xe[4][4]) == -1


def test_walk_plain_matches_walk_xla_carried():
    """Tile 1 walks from tile 0's carry (_carry_next): the entering
    state and payload, and tile 1's walk, agree."""
    k, m, s, own, L = 31, 11, 4.0, 2048, 3500
    P = own + 512
    full = _codes("random", 17, 2 * P, L)
    carry = None
    for t in range(2):
        c = np.zeros(P, np.uint8)
        c[: P] = full[t * own : t * own + P]
        jt, tt = _both(c, k, m, P, L - t * own, s)
        if carry is None:
            jc = (JW._init5_from_tables(jt), JW._fb_from_tables(jt))
            tc = (TW._init5_from_tables(tt), TW._fb_from_tables(tt))
        else:
            jc, tc = carry
        for a, b in zip(tc, jc):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        xe, te = _check_walk(JW.pack_succ(jt, own), jc[0],
                             TW.pack_succ(tt, own), tc[0])
        carry = (JW._carry_next(xe[4], jt, jc[1], own),
                 TW._carry_next(te[4], tt, tc[1], own))
    assert int(xe[4][1]) >= 0 and int(jc[0][3]) < 0


def _compact_equal(got, want):
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, i
        np.testing.assert_array_equal(a, b, err_msg=str(i))


@pytest.mark.parametrize("kind,s", [("random", 10.0), ("repeat", 2.0),
                                    ("homopolymer", 1000.0)])
def test_device_chain_compact_matches_jax(kind, s):
    jt, tt = _both(_codes(kind, 5, 4096, 3600), 31, 11, 4096, 3600, s)
    _compact_equal(TW.DeviceChain(tt).compact(),
                   JW.DeviceChain(jt).compact())


def test_device_chain_capacity_retry():
    """s = 1 selects every boundary: a 16-slot guess must re-compact
    (mirror of tests/test_walker.py::test_walker_overflow_retry)."""
    jt, tt = _both(_codes("random", 7, 4096, 2000), 31, 11, 4096, 2000, 1.0)
    dc = TW.DeviceChain(tt, sel_cap_guess=16)
    _compact_equal(dc.compact(), JW.DeviceChain(jt, sel_cap_guess=16)
                   .compact())
    assert dc.n_sel > 16


def _field_tables(codes, k, m, P, L):
    jt = _jscan_field(jnp.asarray(codes), k, m, P, jnp.int32(L), True)
    return jt, TF.tables_from_numpy({f: np.asarray(getattr(jt, f))
                                     for f in jt._fields})


@pytest.mark.parametrize("carried", [False, True])
def test_converters_match_jax(carried):
    """field_entry_to_walker_init and walker_exit_to_field_entry on the
    same field tables and entry states; the walk between them is JAX's
    walk_xla over JAX's successor tables."""
    k, m, s, own = 31, 11, 2.0, 2048
    P = own + 512
    codes = _codes("homopolymer", 9, P, P - 100)
    thr = _thr(k, m, s)
    jthr = (jnp.uint32(thr[0]), jnp.uint32(thr[1]))
    jft, tft = _field_tables(codes, k, m, P, own + k)
    jentry = JF.field_entry_init(jft, *jthr)
    if carried:
        # a mid-sequence entry: the exit of a resolve over the same
        # tables, re-based into this region
        arr = JF.resolve_field(jft, k, m, 4096, jentry, *jthr)
        jentry = JF.field_carry(arr, 700)
    tentry = torch.from_numpy(np.asarray(jentry).copy())
    ji5, jfb = JF.field_entry_to_walker_init(jft, jentry)
    ti5, tfb = TF.field_entry_to_walker_init(tft, tentry)
    np.testing.assert_array_equal(ti5.numpy(), np.asarray(ji5))
    np.testing.assert_array_equal(tfb.numpy(), np.asarray(jfb))
    jst, _ = _both(codes, k, m, P, P - 100, s)
    scal = JW.walk_xla(JW.pack_succ(jst, own), ji5)[4]
    for sc in (scal, jnp.asarray([0, -5, 1, 0, 3, 0], jnp.int32)):
        want = JF.walker_exit_to_field_entry(jft, sc, jentry, k, m, own,
                                             *jthr)
        got = TF.walker_exit_to_field_entry(
            tft, torch.from_numpy(np.asarray(sc).copy()), tentry, k, m,
            own, *thr)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _scan_words(codes, s, n_pad):
    """walk_cases' scan kinds: the port's successor words and window-0
    entry of a record longer than the codes (k = 31, m = 11)."""
    L = codes.size + 1000
    tt = scan_tables_2d_packed(torch.from_numpy(pack_2bit_np(codes)), 31, 11,
                               codes.size, L, *_thr(31, 11, s))
    return TW.pack_succ(tt, n_pad).numpy(), TW._init5_from_tables(tt).numpy()


def _walk_case(kind, n_blocks):
    words, init5 = WC.walk_case(kind, n_blocks, scan_words=_scan_words)
    return torch.from_numpy(words), torch.from_numpy(init5)


@pytest.mark.parametrize("n_blocks", WC.N_BLOCKS)
@pytest.mark.parametrize("kind", WC.KINDS)
def test_walk_cases_plain_matches_walk_xla(kind, n_blocks):
    words, init5 = _walk_case(kind, n_blocks)
    _check_walk(jnp.asarray(words.numpy()), jnp.asarray(init5.numpy()),
                words, init5)


def _check_block_model(kind, n_blocks, G=None):
    words, init5 = _walk_case(kind, n_blocks)
    want = TW.walk_plain(words, init5)
    for got, w in zip(WC.block_model(words.numpy(), init5.numpy(), G), want,
                      strict=True):
        np.testing.assert_array_equal(got, w.numpy())


@pytest.mark.parametrize("n_blocks", WC.N_BLOCKS)
@pytest.mark.parametrize("kind", WC.KINDS)
def test_block_model_matches_walk_plain(kind, n_blocks):
    """The three passes of csrc/walk.cu (maps, composition, emit) in
    numpy == walk_plain, every output, -1 past cnt included."""
    _check_block_model(kind, n_blocks)


@pytest.mark.parametrize("kind", WC.KINDS)
def test_block_model_many_groups(kind):
    """64 blocks in 16 groups of 4: the chase across groups and the
    state on entry to every block of a group."""
    _check_block_model(kind, 64, G=4)
