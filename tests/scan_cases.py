"""Adversarial inputs for the field scan, from a seeded numpy generator.

The scan's election keeps the rightmost minimal m-mer, then moves to a
tie by the reference fold's rules (leftmost forward occurrence,
mirrored reverse position), and its sync flag is a strict minimum over
the 2W hashes before a position. Random sequence almost never repeats
an m-mer inside a window, so neither rule is exercised there. One
function, ``scan_case``, makes the 2-bit codes of a single record and of
a batch of records for each kind in ``KINDS``:

- ``homopolymer``: runs of each base (code 0 gives forward ties, code 2
  reverse ones: the complement of code c is c ^ 2);
- ``tandem``: tandem repeats with periods 2-12, one unit in three a
  palindrome (a half and its reverse complement), whose m-mers occur on
  both strands;
- ``mixed_strand``: copies of one m-mer and of its reverse complement a
  few bases apart, the m-mer picked for its small hash so that it is
  the window's minimum wherever it occurs;
- ``straddle``: a homopolymer or tandem run across every block boundary
  of the CUDA scan (multiples of ``BLOCK`` positions) and, in the batch,
  across every record boundary (those records are full length);
- ``short``: records shorter than k (the single record, and lengths 0,
  1, k - 1 and k in the batch).

``flat_inputs`` lays a case out as the CUDA scan takes it.
``tile_codes`` makes a long sequence of tandems and homopolymers only,
for the scan's adversarial tile. ``elect_closed_form`` is the election
in the closed form that the CUDA scan computes (csrc/scan.cu
``elect_min``), for a test against the fold.

The module imports numpy only, so tests/test_torch_cuda.py and
chip_smoke.py load it by file path (an installed package named
``tests`` can shadow this directory on a GPU machine)."""

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

BLOCK = 1024              # positions per block of the CUDA scan
P = 4096                  # the single record's padded length
P_REC, N_REC = 1536, 6    # the batch: records of 3 x 512 positions
KINDS = ("homopolymer", "tandem", "mixed_strand", "straddle", "short")
KM = ((31, 11), (63, 15), (15, 5), (21, 7))

_XXH = (11400714785074694791, 14029467366897019727, 1609587929392839161,
        9650029242287828579, 2870177450012600261)


def _rc(u: np.ndarray) -> np.ndarray:
    """Reverse complement of a code array (complement c ^ 2)."""
    return (u[::-1] ^ 2).astype(np.uint8)


def _concat(rng, n: int, piece) -> np.ndarray:
    """piece(rng) arrays back to back, cut to n codes."""
    out, total = [], 0
    while total < n:
        out.append(piece(rng))
        total += len(out[-1])
    return np.concatenate(out)[:n].astype(np.uint8)


def _homopolymers(rng, n: int) -> np.ndarray:
    """Runs of 20-300 of one base, with 0-8 random bases between."""
    return _concat(rng, n, lambda r: np.concatenate([
        np.full(r.integers(20, 301), r.integers(0, 4), np.uint8),
        r.integers(0, 4, r.integers(0, 9), dtype=np.uint8)]))


def _tandem_unit(rng) -> np.ndarray:
    """A unit of period 2-12; one in three a palindrome."""
    p = int(rng.integers(2, 13))
    if rng.random() < 1 / 3:
        half = rng.integers(0, 4, max(1, p // 2), dtype=np.uint8)
        return np.concatenate([half, _rc(half)])
    return rng.integers(0, 4, p, dtype=np.uint8)


def _repeat(unit: np.ndarray, n: int) -> np.ndarray:
    return np.tile(unit, n // len(unit) + 1)[:n]


def _tandems(rng, n: int) -> np.ndarray:
    """Tandem repeats 40-400 long of units of period 2-12."""
    return _concat(rng, n, lambda r: _repeat(_tandem_unit(r),
                                             int(r.integers(40, 401))))


def tile_codes(seed: int, n: int) -> np.ndarray:
    """n codes of alternating tandem and homopolymer stretches of 1-4 kb:
    every window of the scan holds a repeated m-mer."""
    rng = np.random.default_rng(seed)
    make = (_tandems, _homopolymers)
    return _concat(rng, n, lambda r: make[int(r.integers(0, 2))](
        r, int(r.integers(1000, 4001))))


def xxh64(x: np.ndarray) -> np.ndarray:
    """XXHash64 (seed 1312) of values below 2^32 as uint64 (the scan's
    m-mer hash)."""
    p1, p2, p3, p4, p5 = (np.uint64(v) for v in _XXH)
    rotl = lambda v, r: (v << np.uint64(r)) | (v >> np.uint64(64 - r))
    x = np.asarray(x, np.uint64)
    with np.errstate(over="ignore"):
        h = np.uint64(1312) + p5 + np.uint64(8)
        h = rotl(h ^ (rotl(x * p2, 31) * p1), 27) * p1 + p4
        h ^= h >> np.uint64(33)
        h *= p2
        h ^= h >> np.uint64(29)
        h *= p3
        h ^= h >> np.uint64(32)
    return h


def canonical(mmers: np.ndarray):
    """(canonical value, reverse strand) of (n, m) code rows."""
    m = mmers.shape[1]
    c = mmers.astype(np.uint64)
    w = np.uint64(4) ** np.arange(m, dtype=np.uint64)
    fwd = (c * w[::-1]).sum(1)
    rc = ((c ^ np.uint64(2)) * w).sum(1)
    return np.minimum(fwd, rc), rc < fwd


def _mixed_strand(rng, n: int, m: int) -> np.ndarray:
    """Copies of one m-mer x and of its reverse complement, 0-3 random
    bases apart; x has the smallest hash of 4,096 random m-mers."""
    cand = rng.integers(0, 4, (4096, m), dtype=np.uint8)
    x = cand[np.argmin(xxh64(canonical(cand)[0]))]
    pieces = (x, _rc(x))
    return _concat(rng, n, lambda r: np.concatenate([
        pieces[int(r.integers(0, 2))],
        r.integers(0, 4, r.integers(0, 4), dtype=np.uint8)]))


def _runs_at(rng, c: np.ndarray, cuts) -> None:
    """A 200-position run centred on each cut, a tandem and a
    homopolymer in turn."""
    for i, cut in enumerate(cuts):
        unit = (rng.integers(0, 4, 1, dtype=np.uint8) if i % 2
                else _tandem_unit(rng))
        a, b = max(cut - 100, 0), min(cut + 100, len(c))
        c[a:b] = _repeat(unit, b - a)


def scan_case(kind: str, k: int, m: int, seed: int = 0) -> dict:
    """One case: ``codes`` (P,) uint8 and ``length`` of a single record,
    ``batch`` (N_REC, P_REC) uint8 and ``lengths`` (N_REC,) int32 of a
    batch. Codes past a record's length are 0, as the packer pads."""
    rng = np.random.default_rng([KINDS.index(kind), k, m, seed])
    n_b = N_REC * P_REC
    if kind == "homopolymer":
        single, flat = _homopolymers(rng, P), _homopolymers(rng, n_b)
    elif kind == "tandem":
        single, flat = _tandems(rng, P), _tandems(rng, n_b)
    elif kind == "mixed_strand":
        single, flat = _mixed_strand(rng, P, m), _mixed_strand(rng, n_b, m)
    elif kind in ("straddle", "short"):
        single = rng.integers(0, 4, P, dtype=np.uint8)
        flat = rng.integers(0, 4, n_b, dtype=np.uint8)
    else:
        raise ValueError(f"unknown kind {kind!r}")
    length = P - 100
    lengths = np.array([P_REC, P_REC - 100, 700, P_REC, 2 * k, P_REC],
                       np.int32)
    if kind == "straddle":
        _runs_at(rng, single, range(BLOCK, P, BLOCK))
        _runs_at(rng, flat, sorted({*range(BLOCK, n_b, BLOCK),
                                    *range(P_REC, n_b, P_REC)}))
        lengths[:] = P_REC
    elif kind == "short":
        length = k - 1
        lengths = np.array([0, 1, k - 1, k, P_REC, k + 1], np.int32)
    single[length:] = 0
    batch = flat.reshape(N_REC, P_REC)
    batch[np.arange(P_REC)[None, :] >= lengths[:, None]] = 0
    return {"codes": single, "length": length, "batch": batch,
            "lengths": lengths}


def flat_inputs(case: dict):
    """(codes, P_rec, lengths) of a case's single record and of its
    batch, each as one flat code array (the scan kernel's layout)."""
    return ((case["codes"], P, np.array([case["length"]], np.int32)),
            (case["batch"].reshape(-1), P_REC, case["lengths"]))


def elect_closed_form(canon, rev, hh, k: int, m: int, n: int):
    """The elections of windows [0, n) in closed form: canon (uint64 or
    int64), rev (bool) and hh (uint64 hash bits) hold n + k - m m-mers.
    With r1 the rightmost occurrence of the window's minimal hash, the
    position is the leftmost forward occurrence if r1 is forward; 0 if
    r1 is reverse at offset km = k - m; else min(r1, km - r2) with r2
    the rightmost reverse occurrence left of r1, or r1 if there is none.
    Returns (value, position, reverse, hash) as
    supersampler_tpu_torch.ops.minimizer.mmer_elect does, as numpy."""
    W = k - m + 1
    km = W - 1
    win = sliding_window_view(np.asarray(hh, np.uint64), W)[:n]
    rv = sliding_window_view(np.asarray(rev, bool), W)[:n]
    hmin = win.min(1)
    occ = win == hmin[:, None]
    rows = np.arange(n)
    r1 = km - np.argmax(occ[:, ::-1], 1)
    rev1 = rv[rows, r1]
    left_fwd = np.argmax(occ & ~rv, 1)
    rev_left = occ & rv & (np.arange(W)[None, :] < r1[:, None])
    r2 = km - np.argmax(rev_left[:, ::-1], 1)
    pos_rev = np.where(r1 == km, 0,
                       np.where(rev_left.any(1), np.minimum(r1, km - r2),
                                r1))
    pos = np.where(rev1, pos_rev, left_fwd)
    return np.asarray(canon)[rows + r1], pos, rev1, hmin
