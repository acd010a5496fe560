"""The port's plain sweep against the JAX sweep, directly, on the CPU.

``sweep_plain`` (supersampler_tpu_torch.ops.field), in both table
layouts, against ``supersampler_tpu.ops.field._run_sweep`` (its XLA
form on the CPU: ``_sweep`` + ``_lists_from_dense``, the tables through
``_transpose_tables``) on the adversarial inputs of tests/sweep_cases.py:
forced and unforced entries, partial and empty column ranges, ``lastiv``
inside a lane, inactive lanes, n = 1, 37 and 64, list overflow at
capl = 1, hash alphabets of three or four values (frequent ties), and a
held ``p`` below the lane's first position. Tolerance: 0 (bit-exact on
the exit state, the count and the three lists)."""

import functools
import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import supersampler_tpu.ops.field as F
import supersampler_tpu_torch.ops.field as TF

_spec = importlib.util.spec_from_file_location(
    "sweep_cases", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "sweep_cases.py"))
SC = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(SC)

_IDS = [c[0] for c in SC.CASES]
_jax_sweep = jax.jit(F._run_sweep, static_argnums=(3, 4, 9, 12))


@functools.lru_cache(maxsize=None)
def _jax(case_id):
    """JAX _run_sweep on the case: (xs (7, n), lp, lv, ll) as int32."""
    d = SC.case(case_id)
    n = d["se"].shape[1]
    u = lambda a: jnp.asarray(np.asarray(a).view(np.uint32))
    names = ("h_hi", "h_lo", "cv", "em", "ep", "eh_hi", "eh_lo")
    t = types.SimpleNamespace(**{
        f: (jnp.asarray(a) if f == "ep" else u(a))
        for f, a in zip(names, d["tabs"])})
    start, end, active, j0, lastiv = (jnp.asarray(a) for a in d["se"])
    s = d["st0"]
    st0 = F.FieldState(val=u(s[0]), h_hi=u(s[1]), h_lo=u(s[2]),
                       p=jnp.asarray(s[3]), last_ev=jnp.asarray(s[4]),
                       n_ev=jnp.asarray(s[5]))
    st, cnt, lp, lv, ll = _jax_sweep(
        F._transpose_tables(t, n), j0, lastiv, d["W"], n, st0, start, end,
        active != 0, d["force_entry"], jnp.uint32(d["thr"][0]),
        jnp.uint32(d["thr"][1]), d["capl"])
    i32 = lambda a: np.asarray(a).view(np.int32)
    return (np.stack([i32(a) for a in (*st, cnt)]), i32(lp), i32(lv),
            i32(ll))


def _port(d, layout):
    n = d["se"].shape[1]
    tabs = [torch.from_numpy(a) for a in d["tabs"]]
    if layout == "col":
        tabs = [a.view(n, 256).t().contiguous() for a in tabs]
    return TF.sweep_plain(tabs, torch.from_numpy(d["se"]),
                          torch.from_numpy(d["st0"]), *d["thr"], d["W"],
                          d["capl"], d["force_entry"], layout)


@pytest.mark.parametrize("layout", ["lane", "col"])
@pytest.mark.parametrize("case_id", _IDS)
def test_sweep_plain_equals_jax_sweep(case_id, layout):
    d = SC.case(case_id)
    got = _port(d, layout)
    want = _jax(case_id)
    for name, a, b in zip(("xs", "pos", "pval", "plast"), got, want,
                          strict=True):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    # the case reaches what it is for
    xs = want[0]
    start, end, active, j0, lastiv = d["se"].astype(np.int64)
    lo = np.maximum(start, 0)
    hi = np.minimum(np.minimum(end, 256), lastiv - j0 + 1)
    live = (active != 0) & (lo < hi)
    assert (xs[5] > d["st0"][5]).any()                  # events
    if d["capl"] == 1:
        assert (xs[6] > 1).any()                        # overflow
    if d["se"].shape[1] > 1:
        assert (~live).any() and live.any()
        assert (live & (d["st0"][3] < j0)).any()        # expiry at lo
        assert (live & (hi < 256)).any()                # ends early
