"""XXHash64 (seed 1312) of the canonical m-mer, on int64 tensors.

Counterpart of supersampler_tpu/ops/hashing.py: the reference's
minimizer hash (reference utils.cpp:244-249 -> include/xxhash64.h with
an 8-byte input: h = seed + Prime5 + 8, one 8-byte round, the final
avalanche). The result is the u64 bit pattern in an int64 tensor
(ops/u64.py).
"""

from __future__ import annotations

import torch

from supersampler_tpu_torch.core.scalar import (PRIME1, PRIME2, PRIME3,
                                                PRIME4, PRIME5, SEED)
from supersampler_tpu_torch.ops import u64 as U

_H0 = U.signed(SEED + PRIME5 + 8)
_P4 = U.signed(PRIME4)


def xxh64_u32(x: torch.Tensor) -> torch.Tensor:
    """Hash of values known to fit 32 bits (m-mers, m <= 15), given as
    an int64 tensor."""
    single = U.mul(U.rotl(U.mul(x, PRIME2), 31), PRIME1)
    h = U.mul(U.rotl(single ^ _H0, 27), PRIME1) + _P4
    h = h ^ U.shr(h, 33)
    h = U.mul(h, PRIME2)
    h = h ^ U.shr(h, 29)
    h = U.mul(h, PRIME3)
    return h ^ U.shr(h, 32)
