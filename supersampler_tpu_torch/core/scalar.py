"""Scalar constants and formatting of the SuperSampler data model.

The port's copy of what it needs from supersampler_tpu/core/scalar.py:
the XXHash64 primes and seed, the 2-bit nucleotide code, the FHS
threshold (80-bit long double, computed by the native library) and the
reference's number formats.
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


def num2str(num: int, k: int) -> str:
    """Unpack ``k`` nucleotides (reference utils.cpp:168-183)."""
    out = []
    for _ in range(k):
        out.append(INT2NUC[num & 3])
        num >>= 2
    return "".join(reversed(out))


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
