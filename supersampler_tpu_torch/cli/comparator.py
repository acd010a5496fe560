"""comparator CLI on the PyTorch port — flag-compatible with the
reference binary (reference Comparator.cpp:464-521): -f index fof, -q
query fof, -p precision, -m min threshold, -o output prefix; plus
--chunk-bytes (bounded-memory streaming) and --resume (a resumable
manifest), as in the JAX package's CLI.

The scoring engine comes from $SPSP_COMPARE_ENGINE (``numpy`` or
``device``, default ``device``); the device engine runs on
$TORCH_DEVICE (default ``cuda``; ``cpu`` runs it on the CPU). Asking
for CUDA where there is none raises.

    python -m supersampler_tpu_torch.cli.comparator -f fof.txt
"""

from __future__ import annotations

import os
import sys
import time

from supersampler_tpu_torch.compare.merge import TorchComparator

USAGE = """Core arguments:
-f Index file of files (mandatory)
-q Query file of files ("" for all versus all comparison of the index)
Ouput arguments:
-m Minimum value to be output (0.0)
-p Required precision to be output in the CSV (6)
-o output prefix (results)
"""

def pick_engine() -> str:
    """Scoring backend: $SPSP_COMPARE_ENGINE when set, else ``device``.
    There is no drop to the numpy engine when the device is missing:
    the device engine then raises."""
    return os.environ.get("SPSP_COMPARE_ENGINE") or "device"


def parse_args(argv):
    opts = {"f": "", "q": "", "p": 6, "m": 0.0, "o": "results",
            "chunk_bytes": None, "resume": None}
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("-") and len(a) == 2 and a[1] in "fqpmo":
            opts[a[1]] = argv[i + 1]
            i += 2
        elif a == "--chunk-bytes":
            opts["chunk_bytes"] = int(argv[i + 1])
            i += 2
        elif a == "--resume":
            opts["resume"] = argv[i + 1]
            i += 2
        else:
            i += 1
    opts["p"] = int(opts["p"])
    opts["m"] = float(opts["m"])
    return opts


def main(argv=None) -> int:
    o = parse_args(sys.argv[1:] if argv is None else argv)
    if not o["f"]:
        print(USAGE, end="")
        return 0
    engine = pick_engine()

    def run_compare(comp, query_size):
        """The in-RAM or the chunked/resumable engine; outputs are
        identical either way."""
        if o["chunk_bytes"] is not None or o["resume"] is not None:
            comp.compare_sketches_chunked(
                query_size,
                chunk_bytes=o["chunk_bytes"] or (64 << 20),
                resume_path=o["resume"])
        else:
            comp.compare_sketches(query_size)

    comp = TorchComparator(precision=o["p"], min_threshold=o["m"],
                           engine=engine)
    if not o["q"]:
        print("No query file, I will perform a all versus all comparison")
        comp.files_names = TorchComparator.getfilesname(o["f"])
        print(f"I found {len(comp.files_names)} documents")
        start = time.time()
        run_compare(comp, len(comp.files_names))
        print(f"kmers evaluated are of length: {comp.k} "
              f"minimizer size is {comp.m}")
        print("Comparisons done")
        mid = time.time()
        print(f"Comparisons lasted {mid - start} sec")
        print("Containement index dump ")
        print("Jackard index dump")
        comp.write_outputs(o["o"])
        print(f"Jaccard output lasted {time.time() - mid} sec")
    else:
        comp.files_names = TorchComparator.getfilesname(o["q"])
        query_size = len(comp.files_names)
        print(f"I query {query_size} file(s) against the bank")
        comp.files_names += TorchComparator.getfilesname(o["f"])
        run_compare(comp, query_size)
        print("Containement index dump ")
        print("Jackard index dump")
        comp.write_outputs(o["o"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
