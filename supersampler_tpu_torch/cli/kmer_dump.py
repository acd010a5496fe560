"""kmer_dump CLI on the PyTorch port — plain-text k-mers from a sketch
file.

The reference carries (commented-out) dump hooks writing selected /
reconstructed k-mers as text (SubSampler.h:41-42, SubSampler.cpp:
271-273 + 591-593) backing the README claim that sketches' k-mers can
be output in plain text (README.md:17). This tool is the live
equivalent as a pure function of the sketch: it decodes a sketch file
and emits one reconstructed k-mer per line (num2str alphabet ACTG,
exactly the reference's reconstruction strings) in bucket order. The
port's copy of supersampler_tpu/cli/kmer_dump.py.

Usage: python -m supersampler_tpu_torch.cli.kmer_dump <sketch.gz> [out.txt]
"""

from __future__ import annotations

import sys

from supersampler_tpu_torch.compare.reader import decode_sketch_pairs
from supersampler_tpu_torch.core.scalar import num2str


def dump(path: str, out) -> int:
    mins, his, los, k, m, _bm = decode_sketch_pairs(path)
    n = 0
    lines = []
    for h, l in zip(his.tolist(), los.tolist()):
        lines.append(num2str((int(h) << 64) | int(l), k))
        n += 1
        if len(lines) >= 65536:
            out.write("\n".join(lines) + "\n")
            lines = []
    if lines:
        out.write("\n".join(lines) + "\n")
    return n


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if not args:
        print("Usage: kmer_dump <sketch.gz> [out.txt]")
        return 0
    if len(args) > 1:
        with open(args[1], "w") as f:
            dump(args[0], f)
    else:
        dump(args[0], sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
