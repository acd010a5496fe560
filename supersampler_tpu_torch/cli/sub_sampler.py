"""sub_sampler CLI on the PyTorch port — flag-compatible with the
reference binary (reference SubSampler.cpp:667-803): -i input, -f
file-of-files, -k kmer, -m minimizer, -t threads, -s rate, -p prefix,
-v verbose, -x type, -a abundance.

The device comes from $TORCH_DEVICE (default ``cuda``; ``cpu`` runs the
plain path). Asking for CUDA where there is none raises.

    python -m supersampler_tpu_torch.cli.sub_sampler -i genome.fa \\
        -k 31 -m 11 -s 1000

With -f, the files of the file of files share one pipeline
(``sketch_fof``); the sketches, the out-fof and each file's messages
come out in fof order.
"""

from __future__ import annotations

import io
import sys
from concurrent.futures import ThreadPoolExecutor

from supersampler_tpu_torch import default_device
from supersampler_tpu_torch.core.scalar import format_g6, parse_rate_arg
from supersampler_tpu_torch.io.fasta import get_out_name, read_fof
from supersampler_tpu_torch.io.gzip_exact import write_gzip_exact
from supersampler_tpu_torch.sketch import (TorchSubsampler, print_stat,
                                           sketch_fof, subsample_file)

USAGE = """Core arguments:
	-i Input file
	-f Input file of file
	-p Output prefix (subsampled)
	-k Kmer size used  (31)
	-s Subsampling used  (1000)
	-t Threads used  (8)
	-m Minimizer size used  (11, max value is 15)
	-v Verbose level (1)
	-a Abundance min (2)
	-3/2/1 respectively Max skmers + any sized skmers + cursed skmers OR Max skmers and any sized skmers OR max skmers only. (default 3)
"""


def parse_args(argv):
    opts = {"i": "", "f": "", "k": 31, "m": 11, "t": 8, "s": "1000",
            "p": "subsampled_", "v": 1, "x": 3, "a": 1}
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("-") and len(a) == 2 and a[1] in "ifkmtspvxa":
            opts[a[1]] = argv[i + 1]
            i += 2
        else:
            i += 1
    for key in "kmtvxa":
        opts[key] = int(opts[key])
    return opts


def main(argv=None) -> int:
    o = parse_args(sys.argv[1:] if argv is None else argv)
    if not o["i"] and not o["f"]:
        print(USAGE, end="")
        return 0
    device = default_device()
    k, m = o["k"], o["m"]
    if m % 2 == 0:
        print("Minimizer size must be odd")
        m += 1
    if k % 2 == 0:
        print("Kmer size must be odd")
        k += 1
    if m > 15:
        print("Minimizer size can't be greater than 15.")
        m = 15
    s = parse_rate_arg(o["s"])
    print(f" I use k={k} m={m} s={format_g6(s)}")
    print(f"Maximal super kmer are of length {2 * k - m} or {k - m + 1} kmers")
    if o["i"]:
        ss = TorchSubsampler(k=k, m=m, s=s, abundance=o["a"], device=device)
        subsample_file(ss, o["i"], o["p"])
        if o["v"]:
            print_stat(ss, sys.stdout)
        return 0
    # fof mode: one shared pipeline across the files (sketch_fof); the
    # gzip writes overlap the remaining device work on two writer
    # threads. Each file's messages and stats are buffered and printed
    # in fof order. -t is accepted for flag parity; the pipeline sizes
    # its own worker pools.
    entries = read_fof(o["f"], min_len=3)
    bufs = [io.StringIO() for _ in entries]
    sss = []
    for path, buf in zip(entries, bufs):
        print(path, file=buf)
        ss = TorchSubsampler(k=k, m=m, s=s, abundance=o["a"], device=device)
        ss.log = buf
        sss.append(ss)
    out_paths = [get_out_name(p, o["p"]) + ".gz" for p in entries]
    for ss, out_path in zip(sss, out_paths):
        ss.subsampled_file = out_path
    with ThreadPoolExecutor(2) as writers:
        wfuts = []

        def write_result(idx, raw):
            wfuts.append(writers.submit(write_gzip_exact, out_paths[idx],
                                        raw, 9))

        sketch_fof(list(zip(sss, entries)), on_result=write_result)
        for fut in wfuts:
            fut.result()
    with open(get_out_name(o["f"], o["p"]) + ".txt", "w") as out_fof:
        for out_path, ss, buf in zip(out_paths, sss, bufs):
            out_fof.write(out_path + "\n")
            if o["v"]:
                print_stat(ss, buf)
            sys.stdout.write(buf.getvalue())
    return 0


if __name__ == "__main__":
    sys.exit(main())
