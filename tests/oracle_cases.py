"""Seeded FASTA inputs on which a sketcher is held to the scalar oracle.

The shapes are those that found the port's input-prep faults, plus the
scan's hard cases, in multi-record files:

- empty records: a header right after a header, at the start, in the
  middle and at the end of a file, and a blank first line;
- records shorter than k (lengths 0-40 and k - 1, k, k + 1 for the
  k of ``CONFIGS``);
- N, R and Y runs (stripped, joining their flanks), lowercase stretches,
  and the byte pairs CB, TU, GF and A@ (a base, then a byte that is not
  one);
- records at the 1,024-position route boundary: raw lengths around
  1,024 - margin(k, m) for each (k, m) of ``CONFIGS`` (the short batch's
  1,024- and 2,048-position groups, and the device-dedup path's walk
  and field routes) and around 1,024 and 2,048;
- 3 kb homopolymers and 3 kb tandem repeats (periods 2-12), with random
  flanks: every election there goes through the oracle's rescan;
- CRLF line ends, blank lines, odd line widths and no final newline.

``fuzz_fasta`` writes one such file; ``repeat_rich`` makes a long
record of dispersed repeats (copies of earlier segments, either strand),
tandem arrays and short homopolymers. ``CONFIGS`` are the 10 golden
configurations (tests/gen_golden.py) and (31, 11) at s = 64; s = 1 at
(31, 11) is among the goldens.

The module imports numpy only, so chip_smoke.py loads it by file path
(an installed package named ``tests`` can shadow this directory on a GPU
machine)."""

import numpy as np

# (k, m, s as the CLI takes it, abundance)
CONFIGS = [(31, 11, "10", 1), (31, 11, "1000", 1), (31, 11, "1", 1),
           (21, 7, "5", 1), (31, 11, "2", 2), (31, 11, "1", 3),
           (31, 11, "100", 1), (63, 15, "10", 1), (15, 5, "50", 1),
           (31, 11, "64", 1)]
# (31, 11, "10", 1) is the golden configuration of two datasets
GOLDEN_CONFIGS = CONFIGS[:9]

_ACGT = np.frombuffer(b"ACGT", np.uint8)
_WIDTHS = (7, 13, 60, 61, 80, 121, 1 << 20)
_HEAVY = 3000


def margin(k: int, m: int) -> int:
    """The sketcher's lookahead halo (sketch/pipeline.py _margin)."""
    return 2 * (2 * k - m + 2) + 128


def _bases(rng, n: int) -> np.ndarray:
    return _ACGT[rng.integers(0, 4, n)]


def _dirty(rng, n: int) -> bytes:
    """n raw bytes: bases with N/R/Y runs, lowercase stretches and
    CB/TU/GF/A@ pairs."""
    b = _bases(rng, n)
    for _ in range(int(rng.integers(0, 3)) if n > 2 else 0):
        a = int(rng.integers(0, n - 1))
        b[a : a + int(rng.integers(1, 50))] = ord(rng.choice(list("NRY")))
    if n and rng.random() < 0.5:
        a = int(rng.integers(0, n))
        b[a : a + int(rng.integers(1, 400))] |= 0x20
    for _ in range(int(rng.integers(0, 3)) if n > 2 else 0):
        a = int(rng.integers(0, n - 1))
        b[a : a + 2] = np.frombuffer(
            [b"CB", b"TU", b"GF", b"A@"][int(rng.integers(0, 4))], np.uint8)
    return b.tobytes()


def _edge_lengths():
    out = {1024 - 1, 1024, 1024 + 1, 2048 - 1, 2048, 2048 + 1}
    for k, m, _s, _a in CONFIGS:
        for d in (-1, 0, 1):
            out.add(1024 - margin(k, m) + d)
            out.add(2048 - margin(k, m) + d)
    return sorted(out)


_EDGES = _edge_lengths()
_SHORT = sorted({n for k, _m, _s, _a in CONFIGS for n in (k - 1, k, k + 1)}
                | {0, 1, 2, 5, 11, 40})


def _record(rng, kind: str) -> bytes:
    if kind == "empty":
        return b""
    if kind == "short":
        return _bases(rng, int(rng.choice(_SHORT))).tobytes()
    if kind == "edge":           # clean bases: raw length == cleaned length
        b = _bases(rng, int(rng.choice(_EDGES)))
        if rng.random() < 0.5:
            b |= 0x20
        return b.tobytes()
    if kind == "dirty":
        return _dirty(rng, int(rng.integers(40, 2500)))
    flank = [_dirty(rng, int(rng.integers(0, 300))) for _ in range(2)]
    if kind == "homopolymer":
        core = bytes([int(rng.choice(_ACGT))]) * _HEAVY
    else:                        # tandem
        unit = _bases(rng, int(rng.integers(2, 13))).tobytes()
        core = (unit * (_HEAVY // len(unit) + 1))[:_HEAVY]
    return flank[0] + core + flank[1]


def fuzz_fasta(rng, path: str, heavy=None, n_records=None) -> int:
    """Write one multi-record FASTA of the module's shapes; ``heavy``
    ("homopolymer" or "tandem") adds one 3 kb record of that kind.
    Returns the record bytes written (headers and line ends left out)."""
    n = int(rng.integers(3, 8)) if n_records is None else n_records
    kinds = list(rng.choice(["empty", "short", "edge", "dirty", "dirty"],
                            n))
    if heavy:
        kinds.insert(int(rng.integers(0, len(kinds) + 1)), heavy)
    if rng.random() < 0.5:
        kinds.insert(0, "empty")
    width = int(rng.choice(_WIDTHS))
    nl = b"\r\n" if rng.random() < 0.3 else b"\n"
    out = [nl] if rng.random() < 0.1 else []
    total = 0
    for i, kind in enumerate(kinds):
        raw = _record(rng, kind)
        total += len(raw)
        out.append(b">r%d %s" % (i, kind.encode()) + nl)
        for j in range(0, len(raw), width):
            out.append(raw[j : j + width] + nl)
            if rng.random() < 0.03:
                out.append(nl)          # a blank line inside a record
    if rng.random() < 0.3:
        out.append(b">tail" + nl)       # an empty last record
    if rng.random() < 0.2:
        out[-1] = out[-1].rstrip(b"\r\n")   # no final newline
    with open(path, "wb") as f:
        f.write(b"".join(out))
    return total


def fuzz_heavy(i: int):
    """The heavy record of fuzz file i: a homopolymer in files 0, 20,
    40, ..., a tandem repeat in files 10, 30, ...; none elsewhere (the
    scalar oracle takes about 10 us a base, and 100-200 us a base of a
    homopolymer, where every position rescans)."""
    if i % 10:
        return None
    return ("homopolymer", "tandem")[i // 10 % 2]


def repeat_rich(rng, n: int) -> bytes:
    """n clean bases: segments of 100-2,000 bp, half of them copies of
    an earlier stretch (one in two reverse-complemented, 1 % of bases
    substituted), one in ten a tandem array (period 2-60) and one in
    fifty a 20-100 bp homopolymer; the rest random."""
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    out = bytearray(_bases(rng, 2000).tobytes())
    while len(out) < n:
        r = rng.random()
        size = int(rng.integers(100, 2000))
        if r < 0.5:
            a = int(rng.integers(0, len(out) - size)) if len(out) > size else 0
            seg = np.frombuffer(bytes(out[a : a + size]), np.uint8).copy()
            sub = rng.random(seg.size) < 0.01
            seg[sub] = _ACGT[rng.integers(0, 4, int(sub.sum()))]
            seg = seg.tobytes()
            if rng.random() < 0.5:
                seg = seg.translate(comp)[::-1]
        elif r < 0.6:
            unit = _bases(rng, int(rng.integers(2, 61))).tobytes()
            seg = (unit * (size // len(unit) + 1))[:size]
        elif r < 0.62:
            seg = bytes([int(rng.choice(_ACGT))]) * int(rng.integers(20, 101))
        else:
            seg = _bases(rng, size).tobytes()
        out += seg
    return bytes(out[:n])
