"""Bit-exact scalar comparator: the port's spec of the comparison.

The port's copy of supersampler_tpu/oracle/comparator.py. It follows the
reference N-way sorted-bucket merge (reference Comparator.cpp:39-74),
bucket decoding (Comparator.cpp:78-264), pairwise scoring
(Comparator.cpp:269-287) and CSV output (Comparator.cpp:362-460, through
compare/writers.py). Pure Python: it shares neither the numpy decode
(compare/reader.py) nor the grouping and scoring
(parallel/compare_dist.py) with TorchComparator.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

from supersampler_tpu_torch.compare.writers import matrix_csv
from supersampler_tpu_torch.core.scalar import (canonize, num2str, str2num,
                                                str_decompressor)
from supersampler_tpu_torch.io.fasta import open_maybe_gzip

EOFMIN = (1 << 64) - 1  # (uint64_t)-1 sentinel (Comparator.cpp:304)


class SketchCursor:
    """Streaming cursor over one decompressed sketch file
    (reference Comparator.cpp:23-37, 78-92, 291-323)."""

    def __init__(self, path: str):
        with open_maybe_gzip(path) as f:
            self.data = f.read()
        self.pos = 0
        self.minimizer = EOFMIN
        self.eof = False

    def readline(self) -> str:
        nl = self.data.find(b"\n", self.pos)
        if nl < 0:
            line = self.data[self.pos :]
            self.pos = len(self.data)
            if not line:
                self.eof = True
            return line.decode()
        line = self.data[self.pos : nl]
        self.pos = nl + 1
        return line.decode()

    def read_header(self) -> Tuple[int, int, int, int]:
        parts = self.readline().split(" ")
        skmer_size = int(parts[0])
        m = int(parts[1])
        nb_kmer_tot = int(parts[2])
        sub_rate = int(float(parts[3]))  # stoi on "1000.000000" -> 1000
        return skmer_size, m, nb_kmer_tot, sub_rate

    def read_minimizer(self, m: int) -> None:
        """Advance to the next bucket's minimizer; EOFMIN at end
        (Comparator.cpp:297-310)."""
        if self.eof or self.pos + m > len(self.data):
            self.minimizer = EOFMIN
            self.eof = True
            return
        buf = self.data[self.pos : self.pos + m]
        self.pos += m
        self.minimizer = str2num(buf.decode())

    def read_bucket_blob(self) -> bytes:
        (size,) = struct.unpack_from("<I", self.data, self.pos)
        self.pos += 4
        blob = self.data[self.pos : self.pos + size]
        self.pos += size
        return blob

    def read_plain_pairs(self) -> List[Tuple[str, str]]:
        """Read non-maximal super-k-mer line pairs until the empty-pair
        terminator (Comparator.cpp:132-148)."""
        pairs = []
        while True:
            a = self.readline()
            b = self.readline()
            if a == "" and b == "":
                return pairs
            pairs.append((a, b))


def inject_minimizer(s: str, minstr: str, skmer_size: int) -> str:
    """Re-insert the minimizer into packed maximal-super-k-mer halves
    (reference Comparator.cpp:78-92). skmer_size here is 2*(k-m)."""
    if not s:
        return minstr
    half = skmer_size // 2
    out = []
    i = 0
    while i < len(s):
        out.append(s[i : i + half])
        i += half
        out.append(minstr)
        out.append(s[i : i + half])
        i += half
    return "".join(out)


class OracleComparator:
    def __init__(self, precision: int = 6, min_threshold: float = 0.0):
        self.precision = precision
        self.min_threshold = min_threshold
        self.files_names: List[str] = []
        self.score_A: Dict[int, int] = {}
        self.nb_kmer_seen_infile: List[int] = []
        self.k = 0
        self.m = 0
        self.skmer_size = 0
        self.query_size = 0
        self.nb_files = 0

    @staticmethod
    def getfilesname(fof_path: str) -> List[str]:
        """Lines with size > 2 (reference Comparator.cpp:7-21)."""
        out = []
        with open_maybe_gzip(fof_path) as f:
            for raw in f.read().split(b"\n"):
                if len(raw) > 2:
                    out.append(raw.decode())
        return out

    # ------------------------------------------------------------------
    def _decode_bucket_kmers(self, cur: SketchCursor, minstr: str):
        """Yield every canonical k-mer of the current bucket (maximal blob
        then plaintext super-k-mers), exactly as Comparator.cpp:97-264."""
        k, m = self.k, self.m
        blob = cur.read_bucket_blob()
        s = str_decompressor(blob)
        s = inject_minimizer(s, minstr, self.skmer_size)
        if len(s) < k:
            s = ""
        if s:
            i = 0
            while i + k <= len(s):
                curr = str2num(s[i : i + k - 1])
                for _ in range(k - m + 1):
                    curr = ((curr << 2) + ((ord(s[i + k - 1]) // 2) % 4)) % (
                        1 << (2 * k))
                    yield canonize(curr, k)
                    i += 1
                i += k - 1
        for left, right in cur.read_plain_pairs():
            sk = left + minstr + right
            curr = str2num(sk[: k - 1])
            i = 0
            while i + k <= len(sk):
                curr = ((curr << 2) + ((ord(sk[i + k - 1]) // 2) % 4)) % (
                    1 << (2 * k))
                yield canonize(curr, k)
                i += 1

    def skip_bucket(self, cursors, indices, minstr):
        """Count distinct k-mers per file without intersection
        (reference Comparator.cpp:97-154)."""
        for ind in indices:
            seen = set()
            for canon in self._decode_bucket_kmers(cursors[ind], minstr):
                seen.add(canon)
            self.nb_kmer_seen_infile[ind] += len(seen)

    def count_intersection(self, cursors, indices, minstr):
        """Presence-bitvector intersection counting
        (reference Comparator.cpp:177-264)."""
        n = self.nb_files
        color_map: Dict[int, List[bool]] = {}
        interesting: List[int] = []
        for ind in indices:
            for canon in self._decode_bucket_kmers(cursors[ind], minstr):
                bits = color_map.get(canon)
                if bits is None:
                    bits = [False] * (n + 1)
                    color_map[canon] = bits
                    bits[ind] = True
                    self.nb_kmer_seen_infile[ind] += 1
                elif not bits[ind]:
                    self.nb_kmer_seen_infile[ind] += 1
                    bits[ind] = True
                    if not bits[n]:
                        interesting.append(canon)
                        bits[n] = True
        self.compute_scores(color_map, interesting)

    def compute_scores(self, color_map, interesting):
        n = self.nb_files
        for canon in interesting:
            bits = color_map[canon]
            ones = [i for i in range(n) if bits[i]]
            for a in range(len(ones)):
                for b in range(a + 1, len(ones)):
                    key = ones[a] * n + ones[b]
                    self.score_A[key] = self.score_A.get(key, 0) + 1

    def find_min(self, cursors) -> Tuple[List[int], bool]:
        """Indices of files at the global minimum minimizer
        (reference Comparator.cpp:328-359)."""
        mn = EOFMIN
        out: List[int] = []
        queryfound = False
        for i, cur in enumerate(cursors):
            if cur.minimizer < mn:
                mn = cur.minimizer
                out = [i]
                queryfound = i < self.query_size
            elif cur.minimizer == mn:
                out.append(i)
                if i < self.query_size:
                    queryfound = True
        if mn == EOFMIN:
            return [], False
        return out, queryfound

    # ------------------------------------------------------------------
    def compare_sketches(self, query_size: int) -> None:
        # Unopenable sketches are skipped with the reference's message
        # (Comparator.cpp:45-51, utils.cpp:357-364); survivors take
        # compacted indices.
        cursors = []
        for p in self.files_names:
            try:
                cursors.append(SketchCursor(p))
            except OSError:
                print("Problem with file opening")
        self.query_size = query_size
        self.nb_files = len(cursors)
        self.nb_kmer_seen_infile = [0] * self.nb_files
        for cur in cursors:
            self.skmer_size, self.m, _, _ = cur.read_header()
        self.k = (self.skmer_size + self.m) // 2
        self.skmer_size -= self.m
        for cur in cursors:
            cur.read_minimizer(self.m)
        while True:
            indices, queryfound = self.find_min(cursors)
            if not indices:
                break
            minstr = num2str(cursors[indices[0]].minimizer, self.m)
            if len(indices) == 1 or not queryfound:
                self.skip_bucket(cursors, indices, minstr)
            else:
                self.count_intersection(cursors, indices, minstr)
            for ind in indices:
                cursors[ind].read_minimizer(self.m)

    # ------------------------------------------------------------------
    def containment_csv(self) -> str:
        return matrix_csv(self.files_names, self.score_A,
                          self.nb_kmer_seen_infile, self.query_size,
                          self.precision, self.min_threshold, jaccard=False)

    def jaccard_csv(self) -> str:
        return matrix_csv(self.files_names, self.score_A,
                          self.nb_kmer_seen_infile, self.query_size,
                          self.precision, self.min_threshold, jaccard=True)
