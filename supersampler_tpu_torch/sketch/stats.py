"""print_stat replication (reference SubSampler.cpp:633-665).

A copy of supersampler_tpu/sketch/stats.py.

Every line, spacing and number format matches the reference; doubles are
printed as C++ ostream default (%.6g), integer ratios use integer
division where the reference does.
"""

from __future__ import annotations

import os

from supersampler_tpu_torch.core.scalar import MASK64, format_g6, int_to_string


def print_stat(ss, out=None) -> str:
    """Render the 20-line report for a finished subsampler run."""
    lines = []
    if ss.selected_kmer_number != 0:
        g = format_g6
        i = int_to_string
        tk, sk = ss.total_kmer_number, ss.selected_kmer_number
        seen_k = ss.seen_kmers_at_reconstruction
        tsk, ssk = ss.total_superkmer_number, ss.selected_superkmer_number
        seen_sk = ss.seen_superkmers_at_reconstruction
        lines.append(f"I have seen {i(tk)} kmers and I selected {i(sk)} kmers")
        lines.append(
            f"After removing duplicate kmers, I selected {i(seen_k)} kmers")
        lines.append("This means a practical subsampling rate of "
                     f"{g(tk / sk)} with duplicates")
        lines.append("This means a practical subsampling rate of "
                     f"{g(tk / seen_k)} without duplicates")
        lines.append(f"I have seen {i(tsk)} superkmers and I selected "
                     f"{i(ssk)} superkmers")
        lines.append("After reconstruction and filtering with abundance, "
                     f"I have selected {i(seen_sk)} superkmers")
        lines.append("This means a practical subsampling rate of "
                     f"{g(tsk / ssk)} with duplicates")
        lines.append("This means a practical subsampling rate of "
                     f"{g(tsk / seen_sk)} without duplicates")
        lines.append(f"This means a mean superkmer size of {g(tk / tsk)} "
                     "kmer per superkmer in the input")
        lines.append(f"This means a mean superkmer size of {g(sk / ssk)} "
                     "kmer per superkmer with duplicates")
        lines.append(f"This means a mean superkmer size of "
                     f"{g(seen_k / seen_sk)} kmer per superkmer in the output")
        fsize = os.path.getsize(ss.subsampled_file)
        lines.append(f"Actual output file size is {i(fsize // 1000)}KB")
        lines.append(f"This mean {g(fsize * 8 / seen_k)} bits per kmer")
        amn = ss.actual_minimizer_number
        lines.append(f"Minimizer number: {i(amn)} Skmer/minimizer:"
                     f"                    {ssk // amn}")
        lines.append(f"Minimizer number: {i(amn)} Skmer/minimizer without "
                     f"duplicates: {seen_sk // amn}")
        density = (ssk / float(ss.nb_mmer_selected & MASK64)) * (
            ss.k - ss.m + 2)
        lines.append(f"Density is: {g(density)}")
        lines.append(f"Number of maximal skmer was:       "
                     f"{i(ss.count_maximal_skmer)}")
        lines.append(f"Actual number of maximal skmer is: "
                     f"{i(ss.seen_max_superkmers_at_reconstruction)}")
        lines.append(f"Proportion of max skmers:        "
                     f"{g(ss.count_maximal_skmer / ssk * 100)}"
                     "% with duplicate kmers")
        lines.append(f"Actual proportion of max skmers: "
                     f"{g(ss.seen_max_superkmers_at_reconstruction / seen_sk * 100)}%")
        lines.append("")
        lines.append("")
    else:
        lines.append("No kmer selected ***Crickets noise***")
    text = "\n".join(lines) + "\n"
    if out is not None:
        out.write(text)
    return text
