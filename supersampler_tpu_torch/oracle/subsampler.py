"""Bit-exact scalar sketcher: the port's spec of the sketch builder.

The port's copy of supersampler_tpu/oracle/subsampler.py, on the port's
own host state: the parameters, threshold and counters come from
``SubsamplerState`` and the k-mer store (intake, greedy reconstruction,
serialization) from ``KmerStore`` (sketch/store.py); this module adds
the streaming scan (reference SubSampler.cpp:306-510) and the minimizer
election (SubSampler.cpp:81-169). It has no device and no torch code,
and reads its input through the Python record reader
(io/fasta.py ``iter_fasta_records``), so it shares neither the C
clean + pack nor the device pipeline with TorchSubsampler. Replayed
quirks of the reference:

* every rescan forces a super-k-mer boundary via ``dump`` even when the
  re-elected minimizer value is unchanged (SubSampler.cpp:391-401);
* after a rescan, ``position_min += (i + 1)`` converts the in-window
  position to an absolute one, also for reverse-strand elections, whose
  in-window position follows different arithmetic (SubSampler.cpp:397);
* ``dump``/``is_rev`` are uninitialized in the reference; the compiled
  binaries behave as if false, which is pinned;
* the density counter ``nb_mmer_selected`` is an unsigned 64-bit value
  (its final ``- (m - 1)`` wraps mod 2^64);
* a record shorter than k adds nothing but the read loop's call.
"""

from __future__ import annotations

import os
import sys
from typing import Optional, Tuple

from supersampler_tpu_torch.core.scalar import (MASK64, canonize, nuc2int,
                                                nuc2intrc, revcomp_code,
                                                str2num, unrevhash)
from supersampler_tpu_torch.io.fasta import iter_fasta_records
from supersampler_tpu_torch.sketch.store import KmerStore, SubsamplerState


class OracleSubsampler(SubsamplerState, KmerStore):
    """Scalar sketcher with the exact reference semantics."""

    def __init__(self, k: int = 31, m: int = 11, s: float = 1000.0,
                 abundance: int = 1):
        super().__init__(k=k, m=m, s=s, abundance=abundance)
        self.mask_k = (1 << (2 * k)) - 1
        self.mask_m = (1 << (2 * m)) - 1
        self.minimizer_map = {}

    # ---- minimizer election over one k-mer (SubSampler.cpp:81-169) ----
    def regular_minimizer_pos(self, seq: int) -> Tuple[int, int, bool]:
        k, m = self.k, self.m
        is_rev = False
        mmer = seq & self.mask_m
        mini = canonize(mmer, m)
        position = k - m
        if mini != mmer:
            is_rev = True
            position = 0
        hash_mini = unrevhash(mini)
        for i in range(1, k - m + 1):
            seq >>= 2
            mmer = seq & self.mask_m
            canon_mmer = canonize(mmer, m)
            local_rev = canon_mmer != mmer
            mmer = canon_mmer
            h = unrevhash(mmer)
            if hash_mini > h:
                position = k - m - i
                mini = mmer
                is_rev = local_rev
                hash_mini = h
            elif mmer == mini and local_rev == is_rev:
                # on opposite strands the 3'-5' minimizer stays
                # (SubSampler.cpp:136-148)
                if is_rev and position > i:
                    position = i
                    mini = mmer
                    is_rev = local_rev
                    hash_mini = h
                if (not is_rev) and position > k - m - i:
                    position = k - m - i
                    mini = mmer
                    is_rev = local_rev
                    hash_mini = h
        return mini, position, is_rev

    # ---- streaming scan of one cleaned record (SubSampler.cpp:350-454) ----
    def scan_sequence(self, ref: str) -> None:
        k, m = self.k, self.m
        is_rev = False   # uninitialized in the reference; pinned false
        dump = False     # uninitialized in the reference; pinned false
        last_position = 0
        pos_end = 0
        seq = str2num(ref[:k])
        min_seq = str2num(ref[k - m : k])
        min_rcseq = revcomp_code(min_seq, m)
        minimizer, position_min, old_rev = self.regular_minimizer_pos(seq)
        old_minimizer = minimizer
        hash_min = unrevhash(minimizer)
        for i in range(len(ref) - k):
            c = ref[i + k]
            seq = ((seq << 2) + nuc2int(c)) & self.mask_k
            min_seq = ((min_seq << 2) + nuc2int(c)) & self.mask_m
            min_rcseq = (min_rcseq >> 2) + (nuc2intrc(c) << (2 * m - 2))
            min_canon = min(min_seq, min_rcseq)
            new_h = unrevhash(min_canon)
            if new_h < hash_min:
                minimizer = min_canon
                hash_min = new_h
                position_min = i + k - m + 1
                is_rev = min_canon != min_seq
            elif i >= position_min:
                minimizer, position_min, is_rev = self.regular_minimizer_pos(
                    seq)
                dump = True
                hash_min = unrevhash(minimizer)
                position_min += i + 1
            if old_minimizer != minimizer or dump:
                dump = False
                if unrevhash(old_minimizer) <= self.threshold:
                    # density accounting (SubSampler.cpp:407-424)
                    if last_position + m - 2 > pos_end:
                        if pos_end > 0:
                            self.nb_mmer_selected -= m - 1
                        self.nb_mmer_selected += i + k - last_position
                        self.nb_mmer_selected -= k - m
                    else:
                        self.nb_mmer_selected += i + k - (pos_end + 1)
                    self.handle_superkmer(
                        ref[last_position : i + k], old_minimizer, old_rev)
                    pos_end = i + k - 1
                self.total_kmer_number += i - last_position + 1
                self.total_superkmer_number += 1
                last_position = i + 1
                old_minimizer = minimizer
                old_rev = is_rev
        i = len(ref) - k  # the C++ loop variable after the loop
        if len(ref) - last_position > k - 1:
            if unrevhash(old_minimizer) <= self.threshold:
                self.nb_mmer_selected -= m - 1
                self.handle_superkmer(
                    ref[last_position : i + k], old_minimizer, old_rev)
            self.total_kmer_number += i - last_position + 1
            self.total_superkmer_number += 1

    # ---- one FASTA file (SubSampler.cpp:306-347) ----
    def sketch_file(self, input_path: str) -> Optional[bytes]:
        """Full pipeline for one FASTA: the uncompressed sketch bytes.
        Unreadable input prints the reference's messages and returns
        None (reference utils.cpp:357-364, SubSampler.cpp:311-321)."""
        k = self.k
        if not os.path.exists(input_path):
            log = self.log or sys.stdout
            print("Problem with file opening", file=log)
            print(f"Can't open file: {input_path}", file=log)
            return None
        for ref_bytes in iter_fasta_records(input_path):
            if len(ref_bytes) >= k:
                self.read_kmer += len(ref_bytes) - k + 1
                self.scan_sequence(ref_bytes.decode())
        self.nb_mmer_selected = (self.nb_mmer_selected - (self.m - 1)) & MASK64
        return self.serialize()
