"""Adversarial inputs for the field sweep, from a seeded numpy generator.

One function, ``sweep_case``, makes the arguments of a sweep
(``sweep_plain`` / ``sweep_kernel`` in supersampler_tpu_torch.ops.field,
``_run_sweep`` in supersampler_tpu.ops.field) with the edges a resolve
rarely shows all at once: forced and unforced entries, lanes that start
past column 0 or end before 256, a ``lastiv`` inside a lane or before
it, inactive and empty lanes, a held ``p`` already below the lane's
first position (expiry at the first column), hash alphabets of three or
four values (ties ``nh == h`` and a hash equal to the threshold are
frequent, and one value has its top bit set), and list overflow at
``capl = 1``. ``CASES`` names the combinations the tests run.

The module imports numpy only, so tests/test_torch_cuda.py and
chip_smoke.py load it by file path (an installed package named
``tests`` can shadow this directory on a GPU machine)."""

import numpy as np

W = 21                    # k - m + 1 at (k, m) = (31, 11)
_B = 256

# 64-bit hashes as (hi, lo): equal his with different los, a top bit
_ALPHABET = ((5, 7), (5, 9), (0x9000_0000, 0), (0xFFFF_FFF0, 3))

# (id, n lanes, capl, force_entry, alphabet size or None for full range)
CASES = (
    ("n1_entry", 1, 16, True, None),
    ("n1_ties3", 1, 16, False, 3),
    ("n37_ties3_entry", 37, 16, True, 3),
    ("n37_ties4", 37, 16, False, 4),
    ("n64_capl1_entry", 64, 1, True, 4),
    ("n64_capl1_ties3", 64, 1, False, 3),
    ("n64_entry", 64, 8, True, None),
    ("n64", 64, 8, False, None),
)


def _hashes(rng, size, alphabet):
    """(hi, lo) uint32 arrays: the first ``alphabet`` values of
    _ALPHABET, or the full 64-bit range."""
    if alphabet is None:
        return (rng.integers(0, 1 << 32, size, dtype=np.uint64)
                .astype(np.uint32) for _ in range(2))
    pick = rng.integers(0, alphabet, size)
    table = np.array(_ALPHABET[:alphabet], dtype=np.uint32)
    return table[pick, 0], table[pick, 1]


def _i32(a) -> np.ndarray:
    """int32 bit pattern of integer or bool values (uint32 included)."""
    a = np.asarray(a).astype(np.int64) & 0xFFFFFFFF
    return a.astype(np.uint32).view(np.int32)


def _pick(rng, n, choices):
    """Per lane, one of ``choices`` (arrays of n values), uniformly."""
    which = rng.integers(0, len(choices), n)
    return np.choose(which, choices)


def sweep_case(seed: int, n: int, capl: int, force_entry: bool,
               alphabet=None) -> dict:
    """The arguments of one sweep over n lanes (lane l at positions
    l*256 .. l*256 + 255), as numpy arrays: ``tabs`` the seven tables
    (h_hi, h_lo, cv, em, ep, eh_hi, eh_lo) in the flat "lane" layout,
    int32 bit patterns; ``se`` (5, n) = start, end, active, j0, lastiv;
    ``st0`` (6, n) = val, h_hi, h_lo, p, last_ev, n_ev; ``thr`` (hi,
    lo); ``W``, ``capl``, ``force_entry``."""
    rng = np.random.default_rng(seed)
    P = n * _B
    u32 = lambda size: rng.integers(0, 1 << 32, size, dtype=np.uint64
                                    ).astype(np.uint32)
    hh, hl = _hashes(rng, P, alphabet)
    ehh, ehl = _hashes(rng, P, alphabet)
    tabs = [hh, hl, u32(P), u32(P), rng.integers(0, W, P), ehh, ehl]

    j0 = np.arange(n, dtype=np.int64) * _B
    ri = lambda lo, hi: rng.integers(lo, hi, n)
    start = _pick(rng, n, (np.zeros(n, np.int64), ri(1, 64), ri(1, 64),
                           ri(200, 300)))
    end = _pick(rng, n, (np.full(n, _B), ri(64, _B), np.full(n, 300)))
    active = rng.random(n) < 0.8
    lastiv = _pick(rng, n, (np.full(n, P + 100), np.full(n, P + 100),
                            j0 + ri(0, _B), j0 - ri(1, 40)))
    start[0] %= 64                      # lane 0 is live in every case
    active[0] = True
    lastiv[0] = P + 100
    if alphabet is None:
        thr = (int(u32(1)[0]), int(u32(1)[0]))
        h_hi, h_lo = u32(n), u32(n)
    else:
        thr = _ALPHABET[(alphabet - 1) // 2]
        h_hi, h_lo = _hashes(rng, n, alphabet)
    p = _pick(rng, n, (j0 - ri(1, 50), j0 + ri(0, W), j0 + ri(W, 300)))
    st0 = [u32(n), h_hi, h_lo, p, j0 - ri(1, 30), ri(0, 100)]

    return {
        "tabs": [_i32(a) for a in tabs],
        "se": np.stack([_i32(a) for a in (start, end, active, j0, lastiv)]),
        "st0": np.stack([_i32(a) for a in st0]),
        "thr": thr, "W": W, "capl": capl, "force_entry": force_entry,
    }


def case(case_id: str, seed: int = 0) -> dict:
    """sweep_case for the CASES entry ``case_id``."""
    i = [c[0] for c in CASES].index(case_id)
    _id, n, capl, force_entry, alphabet = CASES[i]
    return sweep_case(100 * seed + i, n, capl, force_entry, alphabet)
