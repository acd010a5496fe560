"""Scalar constants and formatting of the SuperSampler data model.

The port's copy of what it needs from supersampler_tpu/core/scalar.py:
the XXHash64 primes and seed, the 2-bit nucleotide code, the FHS
threshold (80-bit long double, computed by the native library), the
reference's number formats and its 2-bit blob packer, plus the two
byte translate tables of the Python k-mer store's super-k-mer intake
(supersampler_tpu/oracle/subsampler.py:48-52).
"""

from __future__ import annotations

import numpy as np

MASK64 = (1 << 64) - 1

# XXHash64 primes (reference include/xxhash64.h:167-171).
PRIME1 = 11400714785074694791
PRIME2 = 14029467366897019727
PRIME3 = 1609587929392839161
PRIME4 = 9650029242287828579
PRIME5 = 2870177450012600261

#: The one hash seed used everywhere (reference utils.cpp:248).
SEED = 1312

# 2-bit nucleotide code: A=0, C=1, T=2, G=3 (reference utils.cpp:13-16).
INT2NUC = "ACTG"

# char -> code lookup over all 256 byte values, matching (c/2)%4
# (reference utils.cpp:13-16 applies to arbitrary chars; only ACGT occur
# after clean_dna).
NUC2INT_LUT = np.array([(c // 2) % 4 for c in range(256)], dtype=np.uint8)

# bytes -> base-4 digits of the 2-bit code, and bytes -> complement (any
# other byte complements to A), for intake on bytes
_B4_BYTES = bytes.maketrans(b"ACTG", b"0123")
_COMP_BYTES = bytes.maketrans(
    bytes(range(256)),
    bytes({65: 84, 67: 71, 71: 67, 84: 65}.get(c, 65) for c in range(256)))


def nuc2int(c: str) -> int:
    """(c/2)%4 on the ASCII value (reference utils.cpp:13-16)."""
    return (ord(c) // 2) % 4


def num2str(num: int, k: int) -> str:
    """Unpack ``k`` nucleotides (reference utils.cpp:168-183)."""
    out = []
    for _ in range(k):
        out.append(INT2NUC[num & 3])
        num >>= 2
    return "".join(reversed(out))


def str_compressor(s: str) -> bytes:
    """2-bit packer for sketch blobs (reference utils.cpp:48-68).

    Layout: one mod byte (len % 4), then big-endian-within-byte packed
    nucleotides; a trailing partial byte is left-shifted one extra time
    (the reference shifts after every append, including the last).
    The reference's accumulator is uninitialized; observed behavior of
    the compiled binaries is 0, which is pinned here.
    """
    if not s:
        return b""
    mod = len(s) % 4
    out = bytearray([mod])
    codes = NUC2INT_LUT[np.frombuffer(s.encode(), dtype=np.uint8)]
    nfull = len(s) // 4
    if nfull:
        g = codes[: 4 * nfull].reshape(-1, 4)
        out += ((g[:, 0] << 6) | (g[:, 1] << 4) | (g[:, 2] << 2)
                | g[:, 3]).tobytes()
    if mod != 0:
        c = 0
        for v in codes[4 * nfull:]:
            c = ((c | int(v)) << 2) & 0xFF
        out.append(c)
    return bytes(out)


def compute_threshold(k: int, m: int, sampling_rate: float) -> int:
    """FHS selection threshold (reference SubSampler.cpp:622-631).

    t = uint64((1 - (1 - 1/s)^(1/(k-m+1))) * 2^63) * 2 in 80-bit long
    double, exactly as the C++ (csrc/spsp_native.c). s <= 1 selects
    everything (selection_threshold = (uint64_t)-1, reference
    SubSampler.h:79-83). Raises if the native library does not build."""
    if sampling_rate <= 1:
        return MASK64
    from supersampler_tpu_torch.native import threshold_native

    return threshold_native(k, m, sampling_rate)


def format_double(x: float) -> str:
    """std::to_string(double): printf %f with 6 decimals."""
    return f"{x:.6f}"


def format_g6(x: float, precision: int = 6) -> str:
    """C++ ostream default float format with setprecision(p) == %.{p}g."""
    return f"{x:.{precision}g}"


def int_to_string(n: int) -> str:
    """Thousands-separated formatting (reference utils.cpp:115-127)."""
    if n < 1000:
        return str(n)
    end = str(n % 1000)
    if len(end) == 3:
        return int_to_string(n // 1000) + "," + end
    if len(end) == 2:
        return int_to_string(n // 1000) + ",0" + end
    return int_to_string(n // 1000) + ",00" + end
