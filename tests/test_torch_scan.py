"""Port field scan (supersampler_tpu_torch.ops.field) == JAX field scan
(supersampler_tpu.ops.field, its XLA branch on the CPU) on all 14
FieldTables fields, from the same numpy-seeded codes. The port runs its
plain version here (CPU tensors). Tolerance: bit-exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import supersampler_tpu.ops.field as JF
import supersampler_tpu_torch.ops.field as TF
from supersampler_tpu.ops.minimizer import pack_2bit_np
from supersampler_tpu_torch.ops.minimizer import mmer_build, mmer_elect
from tests import scan_cases as SC

_jscan = jax.jit(JF.scan_field_2d, static_argnums=(1, 2, 3, 5))
_jscan_b = jax.jit(JF.scan_field_batched, static_argnums=(1, 2, 3))


def _codes(rng, L, P, kind):
    """As tests/test_field.py: random, a 61-periodic repeat, or random
    with two homopolymer runs."""
    c = np.zeros(P, np.uint8)
    if kind == "repeat":
        unit = rng.integers(0, 4, 61, dtype=np.uint8)
        c[:L] = np.tile(unit, L // 61 + 1)[:L]
        return c
    c[:L] = rng.integers(0, 4, L, dtype=np.uint8)
    if kind == "homopolymer":
        c[L // 3 : L // 3 + 150] = 2
        c[2 * L // 3 : 2 * L // 3 + 80] = 0
    return c


def _assert_tables_equal(jt, tt, fields):
    for f in fields:
        want = np.asarray(getattr(jt, f))
        got = getattr(tt, f).numpy()
        if want.dtype == np.uint32:
            got = got.view(np.uint32)
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("kind", ["random", "repeat", "homopolymer"])
@pytest.mark.parametrize("k,m", [(31, 11), (63, 15), (15, 5), (21, 7)])
def test_scan_field_2d_matches_jax(k, m, kind):
    P, L = 4096, 3900
    codes = _codes(np.random.default_rng(k * 7 + m), L, P, kind)
    jt = _jscan(jnp.asarray(codes), k, m, P, jnp.int32(L), True)
    tt = TF.scan_field_2d(torch.from_numpy(codes), k, m, P, L)
    _assert_tables_equal(jt, tt, JF.FieldTables._fields)
    # the packed entry gives the same tables
    tp = TF.scan_field_2d_packed(torch.from_numpy(pack_2bit_np(codes)),
                                 k, m, P, L)
    for a, b in zip(tt, tp):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k,m,P_rec,lengths", [
    (31, 11, 1024, [900, 31, 32, 200, 700, 64, 850, 500, 33, 120, 0,
                    901]),
    (21, 7, 2048, [2000, 1500, 513, 22, 1999, 0, 0, 700]),
])
def test_scan_field_batched_matches_jax(k, m, P_rec, lengths):
    """Mixed lengths, inert records (length < k) and dead pads."""
    rng = np.random.default_rng(P_rec + k)
    B = len(lengths)
    packed = np.zeros((B, P_rec // 4), np.uint8)
    for b, L in enumerate(lengths):
        c = rng.integers(0, 4, P_rec, dtype=np.uint8)
        c[L:] = 0
        packed[b] = pack_2bit_np(c)
    lens = np.asarray(lengths, np.int32)
    jt = _jscan_b(jnp.asarray(packed), k, m, P_rec, jnp.asarray(lens))
    tt = TF.scan_field_batched(torch.from_numpy(packed), k, m, P_rec,
                               torch.from_numpy(lens))
    _assert_tables_equal(jt, tt, JF.BatchedFieldTables._fields)


@pytest.mark.parametrize("k,m", SC.KM)
@pytest.mark.parametrize("kind", SC.KINDS)
def test_scan_cases_match_jax(kind, k, m):
    """tests/scan_cases.py's repeats, single record and batch: the
    election's tie rules and the sync's strict minimum on windows whose
    minimal m-mer occurs more than once."""
    d = SC.scan_case(kind, k, m)
    jt = _jscan(jnp.asarray(d["codes"]), k, m, SC.P,
                jnp.int32(d["length"]), True)
    tt = TF.scan_field_2d(torch.from_numpy(d["codes"]), k, m, SC.P,
                          d["length"])
    _assert_tables_equal(jt, tt, JF.FieldTables._fields)
    packed = np.stack([pack_2bit_np(r) for r in d["batch"]])
    jt = _jscan_b(jnp.asarray(packed), k, m, SC.P_REC,
                  jnp.asarray(d["lengths"]))
    tt = TF.scan_field_batched(torch.from_numpy(packed), k, m, SC.P_REC,
                               torch.from_numpy(d["lengths"]))
    _assert_tables_equal(jt, tt, JF.BatchedFieldTables._fields)


@pytest.mark.parametrize("k,m", SC.KM)
@pytest.mark.parametrize("kind", SC.KINDS)
def test_closed_form_election_matches_fold(kind, k, m):
    """The election in closed form (what csrc/scan.cu computes from the
    window minimum) == the port's fold (mmer_elect) on every window of
    the case, and the generator's hash == the port's."""
    d = SC.scan_case(kind, k, m)
    for codes in (d["codes"], d["batch"].reshape(-1)):
        n = len(codes) - k
        canon, rev, hh = mmer_build(torch.from_numpy(codes.astype(np.int64)),
                                    m, n + k - m)
        hh_u = hh.numpy().view(np.uint64)
        np.testing.assert_array_equal(SC.xxh64(canon.numpy()), hh_u)
        want = mmer_elect(canon, rev, hh, k, m, n)
        got = SC.elect_closed_form(canon.numpy(), rev.numpy(), hh_u, k, m, n)
        for name, a, b in zip(("value", "pos", "rev", "hash"), got, want):
            b = b.numpy()
            np.testing.assert_array_equal(
                a, b.view(np.uint64) if name == "hash" else b, err_msg=name)


def _mosaic_case(codes, k, m, L):
    """The port's scan_field_2d against the Pallas scan kernel itself
    (field_core_mosaic in interpret mode, as tests/test_field.py runs
    it): entering hashes and values, shifted elections, masked sync and
    window-0 election."""
    from supersampler_tpu.ops.scan_kernel import field_core_mosaic

    C = 512
    P = len(codes)
    W = k - m + 1
    R = P // C
    (h0, cv, em_r, ep_r, eh_r, sync, em, ep, er, eh, _fl) = \
        field_core_mosaic(jnp.asarray(codes), k, m, P, C,
                          jnp.arange(R) == 0, interpret=True)
    tt = TF.scan_field_2d(torch.from_numpy(codes), k, m, P, L)

    def u32(t):
        return t.numpy().view(np.uint32)

    flat = lambda a: np.asarray(a).reshape(-1)
    for got, want in ((u32(tt.h_hi), h0.hi), (u32(tt.h_lo), h0.lo),
                      (u32(tt.cv), cv), (u32(tt.em), em_r),
                      (tt.ep.numpy(), ep_r), (u32(tt.eh_hi), eh_r.hi),
                      (u32(tt.eh_lo), eh_r.lo)):
        np.testing.assert_array_equal(got, flat(want))
    j = np.arange(P)
    want_sync = flat(sync) & (j >= 2 * W) & (j <= L - k - 1)
    np.testing.assert_array_equal(tt.sync.numpy(), want_sync)
    init = int(np.asarray(em)[0, 0]) | (int(np.asarray(er)[0, 0]) << 30)
    assert int(u32(tt.init_val)) == init
    assert int(tt.init_p) == int(np.asarray(ep)[0, 0])
    assert int(u32(tt.init_h_hi)) == int(np.asarray(eh.hi)[0, 0])
    assert int(u32(tt.init_h_lo)) == int(np.asarray(eh.lo)[0, 0])


def test_scan_matches_mosaic_kernel_interpret():
    k, m, P, L = 31, 11, 4096, 4000
    codes = np.random.default_rng(5).integers(0, 4, P, dtype=np.uint8)
    codes[L:] = 0
    _mosaic_case(codes, k, m, L)


def test_scan_case_matches_mosaic_kernel_interpret():
    """The tandem case (every window ties) through the Pallas kernel."""
    d = SC.scan_case("tandem", 31, 11)
    _mosaic_case(d["codes"], 31, 11, d["length"])
