/* Native host-side input prep for the port's sketch pipeline.
 *
 * The port's own copy of the clean + 2-bit pack of csrc/spsp_io.c.
 * It departs from that file in one place: the SWAR fast path flags a
 * byte as one of ACGT with an exact per-byte zero test.  The shared
 * file's borrow-based test, (h - 0x01..) & ~h & 0x80.., also flags the
 * byte after a match when that byte's XOR with the same base is 0x01,
 * so 'B'/'b' after C, 'U'/'u' after T, 'F'/'f' after G and '@'/'`'
 * after A were kept as bases.  The reference's clean_dna strips every
 * non-ACGT byte (reference utils.cpp:675-702).
 *
 * Replicates the reference's parse semantics (clean_dna strips every
 * non-ACGT byte and uppercases, JOINING flanks) and packs the cleaned
 * bases 4 to a byte for the device, in one pass.
 *
 * Code mapping: nuc2int(c) = (c/2)%4 -> A=0, C=1, T=2, G=3
 * (reference utils.cpp:13-16).
 */

#include <stdint.h>
#include <string.h>

/* 0x80 in each byte of h that is zero, 0 elsewhere; no carry or borrow
 * crosses a byte: (b & 0x7F) + 0x7F <= 0xFE sets bit 7 exactly when
 * the low seven bits are not all zero, and | h adds bit 7 itself. */
static inline uint64_t zero_bytes(uint64_t h)
{
    const uint64_t L7 = 0x7F7F7F7F7F7F7F7FULL;
    return ~(((h & L7) + L7) | h) & 0x8080808080808080ULL;
}

/* One-pass clean + pack: raw record bytes (headers stripped, newlines
 * still embedded) -> uppercased ACGT ref bytes AND the 2-bit packed
 * slab the device consumes, in a single traversal.
 *
 * The 2-bit code is (c>>1)&3 for any of ACGTacgt (reference
 * utils.cpp:13-16: nuc2int(c) = (c/2)%4, case-insensitive since
 * 'a'-'A' = 32 keeps bit 1 fixed); uppercasing is c & 0xDF.
 *
 * packed_out must hold (halo+padded)/4 bytes (halo, padded multiples
 * of 4) and is fully zeroed first, so tail fill and the slow path's
 * |= both work.  ref_out must hold n bytes.  Returns the cleaned
 * length o (always <= n; caller guarantees n + margin <= padded).
 * n <= 0 cleans nothing. */
int64_t spsp_clean_pack(const uint8_t *raw, int64_t n,
                        uint8_t *ref_out, uint8_t *packed_out,
                        int64_t halo, int64_t padded)
{
    static uint8_t ok[256];
    static int ok_ready = 0;
    if (!ok_ready) {
        memset(ok, 0, sizeof ok);
        ok['A'] = ok['C'] = ok['G'] = ok['T'] = 1;
        ok['a'] = ok['c'] = ok['g'] = ok['t'] = 1;
        ok_ready = 1;
    }
    memset(packed_out, 0, (halo + padded) >> 2);
    uint8_t *pk = packed_out + (halo >> 2);
    int64_t o = 0, i = 0;
    /* SWAR fast path at 8-byte granularity: validity first (per-byte
     * 'equals one of ACGT' masks), then upper+pack — 8 input bytes ->
     * 2 packed bytes per uint64. 8-byte units keep line-wrapped FASTA
     * (60-80 col lines; a newline every ~70 bytes) mostly on the fast
     * path: only the unit containing the newline (plus <=3 realign
     * bytes) drops to the byte loop. */
    const uint64_t DF = 0xDFDFDFDFDFDFDFDFULL;
    const uint64_t HI = 0x8080808080808080ULL;
    const uint64_t eA = 0x4141414141414141ULL;   /* 'A' x8 */
    const uint64_t eC = 0x4343434343434343ULL;
    const uint64_t eG = 0x4747474747474747ULL;
    const uint64_t eT = 0x5454545454545454ULL;
    while (i < n) {
        if (n - i >= 8 && (o & 3) == 0) {
            uint64_t x;
            memcpy(&x, raw + i, 8);
            uint64_t u = x & DF;
            uint64_t hit = zero_bytes(u ^ eA) | zero_bytes(u ^ eC)
                         | zero_bytes(u ^ eG) | zero_bytes(u ^ eT);
            if (hit == HI) {
                memcpy(ref_out + o, &u, 8);
                /* 2-bit codes: (c>>1)&3 per byte; fold each 32-bit
                 * half's four codes into one output byte */
                uint64_t c8 = (x >> 1) & 0x0303030303030303ULL;
                uint64_t f = c8 | (c8 >> 6) | (c8 >> 12) | (c8 >> 18);
                pk[o >> 2] = (uint8_t)(f & 0xFF);
                pk[(o >> 2) + 1] = (uint8_t)((f >> 32) & 0xFF);
                o += 8;
                i += 8;
                continue;
            }
        }
        /* byte loop: a unit containing a non-ACGT byte, an unaligned
         * o, or the tail; hands back to the fast path as soon as o
         * re-aligns with a valid byte ahead (progress guaranteed: at
         * least one byte is consumed or skipped before the break) */
        int64_t stop = i + 8 < n ? i + 8 : n;
        int64_t i0 = i;
        for (; i < stop; i++) {
            uint8_t c = raw[i];
            if (ok[c]) {
                if ((o & 3) == 0 && i > i0)
                    break;
                ref_out[o] = (uint8_t)(c & 0xDF);
                pk[o >> 2] |= (uint8_t)(((c >> 1) & 3) << ((o & 3) << 1));
                o++;
            }
        }
    }
    return o;
}

/* Batch variant: clean+pack every record of a chunk in ONE ctypes
 * call (the per-call Python/ctypes overhead dominates reads-style
 * corpora with tens of thousands of tiny records).  Each record r
 * cleans data[starts[r]:ends[r]] into ref_pool+ref_offs[r] and packs
 * (halo 0) into pack_pool+pack_offs[r] with padded[r] positions;
 * cleaned lengths land in out_lens.  The caller sizes ref_pool and
 * ref_offs from max(ends[r] - starts[r], 0). */
void spsp_clean_pack_batch(const uint8_t *data, const int64_t *starts,
                           const int64_t *ends, int64_t n_rec,
                           uint8_t *ref_pool, const int64_t *ref_offs,
                           uint8_t *pack_pool, const int64_t *pack_offs,
                           const int64_t *padded, int64_t *out_lens)
{
    for (int64_t r = 0; r < n_rec; r++)
        out_lens[r] = spsp_clean_pack(data + starts[r],
                                      ends[r] - starts[r],
                                      ref_pool + ref_offs[r],
                                      pack_pool + pack_offs[r],
                                      0, padded[r]);
}
