"""Successor words and entering states for the walk, from a seeded numpy
generator, and a numpy model of the CUDA walk's block design.

The walk (supersampler_tpu_torch/ops/walker.py ``walk_plain``, the CUDA
kernel csrc/walk.cu) chases events through packed successor words: per
position, for each node type, a delta 1..63 to the next event (0: the
chain ends), the next event's type and the node's FHS-selected bit
(layout in ops/walker.py). ``walk_case`` makes the words and init5 =
[nxt_pos, nxt_typ, cur_sel, cur_pos, cur_typ] of one case for each kind
in ``KINDS``, at n_blocks 2,048-position blocks:

- ``scan_s1000``, ``scan_s1``: words from real scan tables of random
  sequence at s = 1000 and s = 1 (every event selected), made by the
  caller's ``scan_words(codes, s, n_pad)`` from P = n_pad + 512 codes
  of a longer record, so that the chain runs past n_pad (the carry);
- ``random``: deltas 1..63, random types and select bits;
- ``never_merge``: every delta 2, so the chains through even and odd
  positions stay apart in every block;
- ``all63``: every delta 63, entered so that block 1's entry sits at its
  last candidate offset, 62;
- ``ends_mid``: a run of 63 words with both deltas 0 in the middle: the
  chain ends there;
- ``late_init``: init5 in the last block;
- ``init_past``: init5 at n_pad (no event at all);
- ``exit_past``: delta 63 on the last 63 positions, so the exit lands up
  to 62 positions past n_pad;
- ``all_sel``, ``no_sel``: every node selected, none selected;
- ``alternating``: A nodes lead to R nodes and R nodes to A nodes.

``block_model`` computes the walk the way csrc/walk.cu does (per-block
maps from the 126 entries through a pivot zone, composition over groups
of G blocks, emit pass from each block's true entry), for a test against
``walk_plain``. The module imports numpy only, so tests/test_torch_cuda.py
and chip_smoke.py load it by file path (an installed package named
``tests`` can shadow this directory on a GPU machine)."""

import numpy as np

BP = 2048                  # positions per block
KINDS = ("scan_s1000", "scan_s1", "random", "never_merge", "all63",
         "ends_mid", "late_init", "init_past", "exit_past", "all_sel",
         "no_sel", "alternating")
SCAN_S = {"scan_s1000": 1000.0, "scan_s1": 1.0}
N_BLOCKS = (1, 3, 64)

N_CAND, INIT, NONE = 126, 126, 127   # the CUDA walk's states
ZONE, ZONE_LEN = 64, 63              # the pivot zone [64, 127) of a block


def _pack_words(da, ta, sa, dr, tr, sr) -> np.ndarray:
    """int32 words from per-position fields (ops/walker.py layout)."""
    f = [np.asarray(a, np.int64) for a in (da, ta, sa, dr, tr, sr)]
    w = (f[0] | (f[1] << 6) | (f[2] << 7) | (f[3] << 16) | (f[4] << 22)
         | (f[5] << 23))
    return w.astype(np.int32)


def walk_case(kind: str, n_blocks: int, seed: int = 0, scan_words=None):
    """(words int32 (n_blocks * 2048,), init5 int32 (5,)) of one case.
    The scan kinds need scan_words(codes uint8 (P,), s, n_pad) ->
    (words, init5)."""
    n_pad = n_blocks * BP
    rng = np.random.default_rng([KINDS.index(kind), n_blocks, seed])
    if kind in SCAN_S:
        if scan_words is None:
            raise ValueError(f"{kind} needs scan_words")
        codes = rng.integers(0, 4, n_pad + 512, dtype=np.uint8)
        words, init5 = scan_words(codes, SCAN_S[kind], n_pad)
        return (np.asarray(words, np.int32),
                np.asarray(init5, np.int32))
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    d = {nt: rng.integers(1, 64, n_pad) for nt in "ar"}
    t = {nt: rng.integers(0, 2, n_pad) for nt in "ar"}
    s = {nt: (rng.random(n_pad) < 0.3).astype(np.int64) for nt in "ar"}
    npos = int(rng.integers(0, 63))
    init5 = [npos, int(rng.integers(0, 2)), 1, -1 - int(rng.integers(0, 40)),
             int(rng.integers(0, 2))]
    if kind == "never_merge":
        d = {nt: np.full(n_pad, 2) for nt in "ar"}
    elif kind == "all63":
        d = {nt: np.full(n_pad, 63) for nt in "ar"}
        init5[0] = (BP - 1) % 63
    elif kind == "ends_mid":
        mid = n_pad // 2
        for nt in "ar":
            d[nt][mid - 31 : mid + 32] = 0
    elif kind == "late_init":
        init5[0] = n_pad - BP + int(rng.integers(0, BP - 48))
    elif kind == "init_past":
        init5[0] = n_pad
    elif kind == "exit_past":
        for nt in "ar":
            d[nt][n_pad - 63 :] = 63
    elif kind == "all_sel":
        s = {nt: np.ones(n_pad, np.int64) for nt in "ar"}
    elif kind == "no_sel":
        s = {nt: np.zeros(n_pad, np.int64) for nt in "ar"}
        init5[2] = 0
    elif kind == "alternating":
        t = {"a": np.ones(n_pad, np.int64), "r": np.zeros(n_pad, np.int64)}
    return (_pack_words(d["a"], t["a"], s["a"], d["r"], t["r"], s["r"]),
            np.asarray(init5, np.int32))


def group_size(n_blocks: int) -> int:
    """Blocks per group of the composition (csrc/walk.cu group_size)."""
    g = 32
    while g * g < n_blocks:
        g += 1
    return g


def _walk(w, npos, ntyp, start, zlo, zlen):
    """walk_seg of csrc/walk.cu on arrays of walks: steps each walk while
    its event lies in [start, start + BP) and outside [zlo, zlo + zlen).
    Returns (last pos, last typ, last sel, npos, ntyp)."""
    npos, ntyp = npos.copy(), ntyp.copy()
    z = np.zeros_like(npos)
    pos, typ, sel = z - 1, z.copy(), z.copy()
    while True:
        on = ((npos >= start) & (npos < start + BP)
              & ~((npos >= zlo) & (npos < zlo + zlen)))
        if not on.any():
            return pos, typ, sel, npos, ntyp
        h = w[np.where(on, npos, 0)] >> (ntyp << 4)
        d = h & 63
        pos = np.where(on, npos, pos)
        typ = np.where(on, ntyp, typ)
        sel = np.where(on, (h >> 7) & 1, sel)
        npos = np.where(on, np.where(d > 0, npos + d, -1), npos)
        ntyp = np.where(on, (h >> 6) & 1, ntyp)


def block_model(words, init5, G: int | None = None):
    """The walk as csrc/walk.cu computes it: (ei, el, es (n_blocks,
    2048), cnt (n_blocks,), scal (6,)), int32 numpy arrays."""
    w = np.asarray(words, np.int64)
    n_pad = w.size
    nb = n_pad // BP
    i0 = [int(v) for v in init5]
    b0 = i0[0] // BP if 0 <= i0[0] < n_pad else nb
    G = group_size(nb) if G is None else G

    # pass 1: maps, for every block and state (records of dead states
    # are never read)
    bb = np.repeat(np.arange(nb), 128)
    e = np.tile(np.arange(128), nb)
    start = bb * BP
    npos = np.where(e < N_CAND, start + (e >> 1), i0[0])
    ntyp = np.where(e < N_CAND, e & 1, i0[1])
    live = (bb >= b0) & ((e < N_CAND) | ((e == INIT) & (bb == b0)))
    npos = np.where(live, npos, -1)
    ap, at, asel, npos, ntyp = _walk(w, npos, ntyp, start, start + ZONE,
                                     ZONE_LEN)
    in_zone = (npos >= start) & (npos < start + BP)
    slot = np.where(in_zone, ((npos - start - ZONE) << 1) | ntyp, 0)
    # phase B from every slot of every block
    sb = np.repeat(np.arange(nb), N_CAND)
    ss = np.tile(np.arange(N_CAND), nb)
    zp, zt, zs, zx, zy = _walk(w, sb * BP + ZONE + (ss >> 1), ss & 1,
                               sb * BP, 0, 0)
    k = bb * N_CAND + slot
    lpos = np.where(in_zone, zp[k], ap)
    ltyp = np.where(in_zone, zt[k], at)
    lsel = np.where(in_zone, zs[k], asel)
    xpos = np.where(in_zone, zx[k], npos)
    xtyp = np.where(in_zone, zy[k], ntyp)
    end = start + BP
    code = np.where(live & (xpos >= end) & (xpos < n_pad),
                    ((xpos - end) << 1) | xtyp, NONE).reshape(nb, 128)
    code[:b0] = NONE

    # pass 2: compose within groups, then chase the groups
    ng = -(-nb // G)
    path = np.zeros((nb, 128), np.int64)
    fg = np.zeros((ng, 128), np.int64)
    for g in range(ng):
        x = np.arange(128)
        x[INIT] = NONE
        for b in range(g * G, min(nb, g * G + G)):
            if b == b0:
                x[INIT] = INIT
            path[b] = x
            x = np.where(x != NONE, code[b][np.minimum(x, 127)], NONE)
        fg[g] = x
    gent, y = np.zeros(ng, np.int64), NONE
    for g in range(ng):
        if b0 < nb and g == b0 // G:
            y = INIT
        gent[g] = y
        if y != NONE:
            y = fg[g][y]
    ent = path[np.arange(nb), gent[np.arange(nb) // G]]
    has = ent != NONE

    # pass 3: every block from its true entry, the incoming event from
    # block b - 1's record (or init5); scal sums the blocks' events and
    # takes the rest from the block the walk leaves
    blk = np.arange(nb)
    prev = np.maximum(blk - 1, 0) * 128 + np.minimum(ent[np.maximum(blk - 1,
                                                                     0)], 127)
    cand = ent < N_CAND
    npos = np.where(cand, blk * BP + (ent >> 1), np.where(has, i0[0], -1))
    ntyp = np.where(cand, ent & 1, i0[1])
    cpos = np.where(cand, lpos[prev], i0[3])
    ctyp = np.where(cand, ltyp[prev], i0[4])
    csel = np.where(cand, lsel[prev], i0[2])
    out = np.full((3, nb, BP), -1, np.int64)
    cnt = np.zeros(nb, np.int64)
    n_ev = np.zeros(nb, np.int64)
    while True:
        on = (npos >= blk * BP) & (npos < blk * BP + BP)
        if not on.any():
            break
        em = on & (csel != 0)
        rows = (blk[em], cnt[em])
        out[0][rows] = npos[em]
        out[1][rows] = cpos[em] + 1
        out[2][rows] = np.where(cpos[em] < 0, -1, 2 * cpos[em] + ctyp[em])
        cnt += em
        h = w[np.where(on, npos, 0)] >> (ntyp << 4)
        d = h & 63
        cpos = np.where(on, npos, cpos)
        ctyp = np.where(on, ntyp, ctyp)
        csel = np.where(on, (h >> 7) & 1, csel)
        npos = np.where(on, np.where(d > 0, npos + d, -1), npos)
        ntyp = np.where(on, (h >> 6) & 1, ntyp)
        n_ev += on
    scal = [0, i0[3], i0[4], i0[2], i0[0], i0[1]]
    leaves = np.flatnonzero((n_ev > 0) & ((npos < 0) | (blk == nb - 1)))
    for b in leaves:
        scal[1:] = cpos[b], ctyp[b], csel[b], npos[b], ntyp[b]
    scal[0] = int(n_ev.sum())
    return (*out.astype(np.int32), cnt.astype(np.int32),
            np.asarray(scal, np.int32))
