"""The benchmark's input generator: genomes, strains and read sets made
from the seed, on the device, written as FASTA. Any other input kind is
a file of its own, benchmark/inputs/<kind>.py, with
``make(cfg, traffic, seed, device, out_dir)`` returning ``Input``s; it
may build on the helpers here.

Every seed makes the same work: sizes come from fixed grids in a fixed
order (genome lengths evenly spaced over the configuration's range,
strain divergences evenly spaced over the traffic's range); the seed
draws only the bases, the read positions, the strands and the errors.
"""

from __future__ import annotations

import os

import numpy as np
import torch

_ACGT = torch.tensor(list(b"ACGT"), dtype=torch.uint8)


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & ((1 << 63) - 1))
    return g


def grid(n: int, lo: float, hi: float) -> np.ndarray:
    """n values evenly spaced over [lo, hi], each the middle of its
    share of the range."""
    return lo + (hi - lo) * (np.arange(n) + 0.5) / n


def random_bases(n: int, g, device) -> torch.Tensor:
    """n random ASCII bases (uint8) on the device."""
    idx = torch.randint(0, 4, (n,), generator=g, device=device,
                        dtype=torch.uint8)
    return _ACGT.to(device)[idx.long()]


def substitute(seq: torch.Tensor, rate: float, g, device) -> torch.Tensor:
    """A copy of seq with each base replaced, with probability rate, by
    one of the three others."""
    hit = torch.rand(seq.shape, generator=g, device=device) < rate
    code = _code(seq)
    shift = torch.randint(1, 4, seq.shape, generator=g, device=device)
    new = _ACGT.to(device)[(code + shift) % 4]
    return torch.where(hit, new, seq)


def _code(seq: torch.Tensor) -> torch.Tensor:
    """A=0, C=1, G=2, T=3 of ASCII bases."""
    lut = torch.zeros(256, dtype=torch.long, device=seq.device)
    lut[torch.tensor(list(b"ACGT"), device=seq.device)] = torch.arange(
        4, device=seq.device)
    return lut[seq.long()]


def revcomp(rows: torch.Tensor) -> torch.Tensor:
    """Reverse complement of each row of ASCII bases."""
    comp = torch.arange(256, device=rows.device).to(torch.uint8)
    comp[torch.tensor(list(b"ACGT"), device=rows.device)] = torch.tensor(
        list(b"TGCA"), dtype=torch.uint8, device=rows.device)
    return comp[rows.long()].flip(-1)


def fasta_record(name: str, seq: torch.Tensor, width: int) -> bytes:
    """One FASTA record, its sequence in lines of ``width`` bases."""
    n = seq.numel()
    full = n // width
    body = seq[: full * width].view(full, width)
    nl = torch.full((full, 1), 10, dtype=torch.uint8, device=seq.device)
    lines = torch.cat([body, nl], 1).reshape(-1).cpu().numpy().tobytes()
    tail = seq[full * width :].cpu().numpy().tobytes()
    return (b">" + name.encode() + b"\n" + lines
            + (tail + b"\n" if tail else b""))


def fasta_reads(reads: torch.Tensor) -> bytes:
    """Single-line records ">r0000000" ... of the rows of reads."""
    n, L = reads.shape
    digits = 7
    idx = torch.arange(n, device=reads.device)
    head = torch.empty((n, digits + 3), dtype=torch.uint8,
                       device=reads.device)
    head[:, 0] = ord(">")
    head[:, 1] = ord("r")
    for d in range(digits):
        head[:, 2 + d] = (idx // 10 ** (digits - 1 - d)) % 10 + 48
    head[:, -1] = 10
    nl = torch.full((n, 1), 10, dtype=torch.uint8, device=reads.device)
    return torch.cat([head, reads, nl], 1).reshape(-1).cpu().numpy() \
        .tobytes()


def reads_from(genome: torch.Tensor, n: int, length: int, error: float,
               g, device) -> torch.Tensor:
    """n reads of ``length`` drawn uniformly from genome, exactly half of
    them reverse-complemented, with substitutions at rate error."""
    start = torch.randint(0, genome.numel() - length + 1, (n,), generator=g,
                          device=device)
    reads = genome[start[:, None] + torch.arange(length, device=device)]
    flip = torch.randperm(n, generator=g, device=device)[: n // 2]
    reads[flip] = revcomp(reads[flip])
    return substitute(reads, error, g, device)


class Input:
    """One generated FASTA file: its path, its bases, and the records'
    bases end to end with each record's start (for the reference)."""

    def __init__(self, path: str, seq: np.ndarray, starts: np.ndarray):
        self.path = path
        self.seq = seq
        self.starts = starts
        self.bases = int(seq.size)


def write(path: str, data: bytes) -> None:
    """One buffered write."""
    with open(path, "wb") as f:
        f.write(data)


def genomes(cfg: dict, traffic: dict, seed: int, device,
            out_dir: str) -> list:
    """The traffic's genomes: ``genomes`` unrelated ones, or ``species``
    base genomes with ``strains`` strains each at divergences evenly
    spaced over ``divergence``. One record per file."""
    g = generator(seed, device)
    inp = cfg["inputs"]
    width = inp["line_width"]
    n_base = traffic.get("species", traffic.get("genomes"))
    lengths = [int(x) for x in np.rint(grid(n_base, inp["length_min"],
                                            inp["length_max"]))]
    out = []
    for b, L in enumerate(lengths):
        base = random_bases(L, g, device)
        if "strains" not in traffic:
            seqs = [(f"g{b:03d}", base)]
        else:
            lo, hi = traffic["divergence"]
            rates = grid(traffic["strains"], lo, hi)
            seqs = [(f"sp{b:02d}_st{t:02d}", substitute(base, r, g, device))
                    for t, r in enumerate(rates)]
        for name, seq in seqs:
            path = os.path.join(out_dir, name + ".fa")
            write(path, fasta_record(name, seq, width))
            out.append(Input(path, seq.cpu().numpy(),
                             np.array([0, seq.numel()], np.int64)))
    return out


def read_set(cfg: dict, traffic: dict, seed: int, device,
             out_dir: str) -> list:
    """One file of reads drawn from a genome made from the seed."""
    g = generator(seed, device)
    inp = cfg["inputs"]
    genome = random_bases(inp["genome_length"], g, device)
    reads = reads_from(genome, inp["reads"], inp["read_length"],
                       inp["error_rate"], g, device)
    path = os.path.join(out_dir, "reads.fa")
    write(path, fasta_reads(reads))
    n, L = reads.shape
    return [Input(path, reads.reshape(-1).cpu().numpy(),
                  np.arange(n + 1, dtype=np.int64) * L)]


KINDS = {"genomes": genomes, "reads": read_set}


def make(cfg: dict, traffic: dict, seed: int, device, out_dir: str,
         root: str) -> list:
    """Every input file of a cell, by the configuration's input kind:
    one of KINDS, or else ``make`` of benchmark/inputs/<kind>.py in the
    tree at root."""
    kind = cfg["inputs"]["kind"]
    if kind in KINDS:
        return KINDS[kind](cfg, traffic, seed, device, out_dir)
    path = os.path.join(root, "benchmark", "inputs", kind + ".py")
    if not os.path.isfile(path):
        raise ValueError(f"input kind {kind!r} is neither built in "
                         f"({', '.join(KINDS)}) nor a file: no {path}")
    from benchmark.run import _load

    return _load(root, "inputs", kind).make(cfg, traffic, seed, device,
                                            out_dir)
