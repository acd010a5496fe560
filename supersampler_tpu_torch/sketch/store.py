"""A sketcher's host state: its parameters and counters
(SubsamplerState) and the Python k-mer store (KmerStore): bucket
intake, greedy reconstruction and serialization.

The port's copy of the scalar spec's store (supersampler_tpu/oracle/
subsampler.py:54-351), with the reference semantics it replicates:

* buckets iterate in ascending 2-bit minimizer order (std::map,
  reference SubSampler.h:62); k-mers within a bucket iterate in
  first-insertion order (ankerl::unordered_dense keeps a dense
  append-only vector; Python dicts preserve insertion order);
* the stored key is the oriented k-mer, and pos_min is the first offset
  of the minimizer string inside it (SubSampler.cpp:243-302);
* k-mer counts are uint8 and wrap (SubSampler.h:24);
* reconstruction probes A, T, C, G in that order (SubSampler.cpp:568).

Both sketchers build on these two classes: the scalar oracle
(oracle/subsampler.py), whose every super-k-mer goes through
``handle_superkmer``, and TorchSubsampler (sketch/pipeline.py), where
the store takes intake when the native C finisher does not: on the
device-dedup path (``ops/dedup.py`` ``merge_unique_host`` fills
``minimizer_map``) and with ``native_finisher = False``
(``handle_superkmer`` per selected super-k-mer). Not thread-safe: one
thread fills and serializes a store.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional

from supersampler_tpu_torch.core.scalar import (_B4_BYTES, _COMP_BYTES,
                                                compute_threshold,
                                                format_double, nuc2int,
                                                num2str, str_compressor)


class SubsamplerState:
    """The parameters, FHS threshold and print_stat counters of a
    sketcher (supersampler_tpu/oracle/subsampler.py OracleSubsampler's
    __init__ and _reset_stats)."""

    def __init__(self, k: int = 31, m: int = 11, s: float = 1000.0,
                 abundance: int = 1):
        self.k = k
        self.m = m
        self.s = s
        self.abundance = abundance
        self.max_superkmer_size = k - m + 1
        self.threshold = compute_threshold(k, m, s)
        # diagnostics stream; the CLI's fof mode points it at a buffer
        self.log = None
        self._reset_stats()

    def _reset_stats(self):
        self.total_kmer_number = 0
        self.total_superkmer_number = 0
        self.selected_kmer_number = 0
        self.selected_superkmer_number = 0
        self.count_maximal_skmer = 0
        self.nb_mmer_selected = 0
        self.seen_kmers_at_reconstruction = 0
        self.seen_superkmers_at_reconstruction = 0
        self.seen_max_superkmers_at_reconstruction = 0
        self.seen_unique_kmers_at_reconstruction = 0
        self.total_kmer_number_at_reconstruction = 0
        self.actual_minimizer_number = 0
        self.read_kmer = 0


class KmerInfo:
    __slots__ = ("count", "pos_min", "seen")

    def __init__(self, count: int, pos_min: int):
        self.count = count
        self.pos_min = pos_min
        self.seen = False


class KmerStore:
    """Mixin: the k-mer store of a sketcher. The host class gives the
    parameters (k, m, s, abundance, max_superkmer_size), the print_stat
    counters (SubsamplerState) and
    ``minimizer_map``, an empty dict: minimizer -> {oriented k-mer ->
    KmerInfo}."""

    minimizer_map: Dict[int, Dict[int, KmerInfo]]

    # ---- intake (reference SubSampler.cpp:243-302) ----
    def handle_superkmer(self, superkmer, input_minimizer: int,
                         inputrev: bool) -> None:
        """Insert or count every k-mer of one selected super-k-mer
        (bytes or str of ACGT), oriented by its minimizer's strand."""
        k, m = self.k, self.m
        if isinstance(superkmer, str):
            superkmer = superkmer.encode()
        self.selected_superkmer_number += 1
        if inputrev:
            superkmer = superkmer.translate(_COMP_BYTES)[::-1]
        n = len(superkmer) - k + 1
        self.selected_kmer_number += n
        if len(superkmer) == 2 * k - m:
            self.count_maximal_skmer += 1
        minstr = num2str(input_minimizer, m).encode()
        # one pass over the minimizer's occurrences and big-int k-mer
        # slicing in place of a find and str2num per k-mer; pos_min is
        # the first occurrence inside the k-mer, as kmerstr.find(minstr)
        occ = []
        p = superkmer.find(minstr)
        while p != -1:
            occ.append(p)
            p = superkmer.find(minstr, p + 1)
        big = int(superkmer.translate(_B4_BYTES), 4) if superkmer else 0
        mask_k = (1 << (2 * k)) - 1
        top = 2 * (len(superkmer) - k)
        bucket = self.minimizer_map.get(input_minimizer)
        if bucket is None:
            bucket = {}
            self.minimizer_map[input_minimizer] = bucket
        j = 0
        n_occ = len(occ)
        for i in range(n):
            while j < n_occ and occ[j] < i:
                j += 1
            if j >= n_occ or occ[j] > i + k - m:
                raise AssertionError(
                    "minimizer not found in k-mer (reference 'PB' trap)")
            seq = (big >> (top - 2 * i)) & mask_k
            info = bucket.get(seq)
            if info is None:
                bucket[seq] = KmerInfo(1, occ[j] - i)
            else:
                info.count = (info.count + 1) & 0xFF  # uint8 wrap

    # ---- greedy reconstruction (SubSampler.cpp:512-620) ----
    def find_first_kmer(self, bucket: Dict[int, KmerInfo]) -> Optional[int]:
        for km, info in bucket.items():
            if not info.seen and info.count >= self.abundance:
                self.total_kmer_number_at_reconstruction += info.count
                self.seen_unique_kmers_at_reconstruction += 1
                info.seen = True
                return km
        return None

    def find_next(self, start: int, bucket: Dict[int, KmerInfo],
                  left: bool) -> int:
        k = self.k
        for nuc in "ATCG":
            if left:
                nxt = (start >> 2) + (nuc2int(nuc) << (2 * k - 2))
            else:
                nxt = ((start << 2) + nuc2int(nuc)) % (1 << (2 * k))
            info = bucket.get(nxt)
            if (info is not None and not info.seen
                    and info.count >= self.abundance):
                info.seen = True
                self.seen_unique_kmers_at_reconstruction += 1
                self.total_kmer_number_at_reconstruction += info.count
                return nxt
        return start

    def reconstruct_superkmer(self, bucket: Dict[int, KmerInfo],
                              start: int) -> str:
        k, m = self.k, self.m
        superkmer = num2str(start, k)
        n_left = (k - m) - bucket[start].pos_min
        n_right = bucket[start].pos_min
        n_start = start
        while len(superkmer) != 2 * k - m:
            if n_left != 0:
                nxt = self.find_next(n_start, bucket, True)
                n_left -= 1
                if nxt != n_start:
                    superkmer = num2str(nxt, k)[0] + superkmer
                else:
                    n_left = 0
                n_start = start if n_left == 0 else nxt
            elif n_right != 0:
                nxt = self.find_next(n_start, bucket, False)
                n_right -= 1
                if nxt != n_start:
                    superkmer = superkmer + "ACTG"[nxt & 3]
                else:
                    break
                n_start = nxt
            else:
                break
        return superkmer

    # ---- serialization (SubSampler.cpp:456-504) ----
    def serialize(self) -> bytes:
        """The uncompressed sketch; adds to the seen_* counters and sets
        actual_minimizer_number, as the native finisher's serialize
        does."""
        k, m = self.k, self.m
        out = bytearray()
        out += "{} {} {} {}\n".format(
            k - 1 + self.max_superkmer_size, m, self.selected_kmer_number,
            format_double(self.s)).encode()
        for minimizer in sorted(self.minimizer_map):
            bucket = self.minimizer_map[minimizer]
            minstr = num2str(minimizer, m)
            out += minstr.encode()
            self.seen_kmers_at_reconstruction += len(bucket)
            max_skmers: List[str] = []
            skmers: List[str] = []
            i = 0
            while i <= len(bucket):
                start = self.find_first_kmer(bucket)
                if start is None:
                    break
                skmer_str = self.reconstruct_superkmer(bucket, start)
                if len(skmer_str) == 2 * k - m:
                    i += k - m + 1
                    self.seen_max_superkmers_at_reconstruction += 1
                    max_skmers.append(skmer_str[: k - m])
                    max_skmers.append(skmer_str[k : 2 * k - m])
                else:
                    i += len(skmer_str) - k + 1
                    p = skmer_str.find(minstr)
                    skmers.append(skmer_str[:p])
                    skmers.append("\n")
                    skmers.append(skmer_str[p + m :])
                    skmers.append("\n")
                self.seen_superkmers_at_reconstruction += 1
            compressed = str_compressor("".join(max_skmers))
            out += struct.pack("<I", len(compressed))
            out += compressed
            out += "".join(skmers).encode()
            out += b"\n\n"
        self.actual_minimizer_number = len(self.minimizer_map)
        return bytes(out)
