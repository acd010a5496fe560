"""The least time the card could take for a kernel launch: the larger
of its bytes (each input byte read once, each output byte written once)
over the HBM rate and its 32-bit operations over the ALU rate. The
arithmetic is the program's own count of its scan kernels
(chip_smoke.py ``scan_bound``), copied here so that the yardstick stays
fixed; the peaks are NVIDIA's data sheet for the H100 SXM at 700 W."""

from __future__ import annotations

import json
import os

_PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "peaks.json")

# 32-bit operations per unit of work, counted low from the kernels
OPS_HASH = 40        # one XXHash64 of an m-mer (five 64-bit multiplies)
OPS_FOLD = 8         # one step of a window minimum


def peaks(kind: str) -> dict:
    """The published peaks of the card named ``kind``."""
    with open(_PEAKS) as f:
        table = json.load(f)
    for name, row in table.items():
        if name in kind:
            return row
    raise KeyError(f"no published peaks for {kind!r} in peaks.json")


def least_seconds(nbytes: float, ops: float, pk: dict) -> float:
    return max(nbytes / pk["hbm_bytes_per_s"], ops / pk["int32_ops_per_s"])


def scan_cost(P: int, P_rec: int, v2: bool):
    """(bytes, operations) of one scan launch over P positions in
    records of P_rec: read the packed codes (and v1's record bounds),
    write seven int32 tables, v1's sync bytes or v2's first-sync words,
    and the records' init; per position one hash, five window-minimum
    steps and one sync compare."""
    n_rec = P // P_rec
    out = 28 * P + (4 * (P // 256) if v2 else P) + 16 * n_rec
    nbytes = P // 4 + (0 if v2 else 4 * n_rec) + out
    return nbytes, P * (OPS_HASH + OPS_FOLD * 5 + 3)
