/* Native sketch decode for the port's comparator.
 *
 * One pass over a sketch's inflated wire bytes turns every bucket into
 * its distinct canonical k-mers, in the order the comparator groups
 * them: buckets in file order, then (hi, lo) ascending.  It does what
 * the reference's inject_minimizer, rolling k-mer extraction and
 * per-bucket colour maps do (reference Comparator.cpp:78-264).
 *
 * Wire format of a bucket (reference SubSampler.cpp:456-504): m ASCII
 * minimizer characters, a u32 little-endian blob size, the blob (a
 * strCompressor string of maximal super-k-mers with the minimizer cut
 * out, reference utils.cpp:48-68), then newline-terminated line pairs
 * (left and right of the minimizer) closed by a pair of empty lines.
 *
 * Code mapping: nuc2int(c) = (c/2)%4 for any byte -> A=0, C=1, T=2,
 * G=3, so the complement of a code is code ^ 2 (reference
 * utils.cpp:13-16).
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef unsigned __int128 u128;

/* A growable scratch array. */
typedef struct {
    void *p;
    int64_t cap;
} buf_t;

static int grow(buf_t *b, int64_t n, size_t elem)
{
    if (n <= b->cap)
        return 0;
    int64_t cap = b->cap ? b->cap : 64;
    while (cap < n)
        cap *= 2;
    void *p = realloc(b->p, (size_t)cap * elem);
    if (!p)
        return -1;
    b->p = p;
    b->cap = cap;
    return 0;
}

static void insertion_sort(u128 *a, int64_t n)
{
    for (int64_t i = 1; i < n; i++) {
        u128 v = a[i];
        int64_t j = i;
        while (j > 0 && a[j - 1] > v) {
            a[j] = a[j - 1];
            j--;
        }
        a[j] = v;
    }
}

/* Sort the n keys of a, equal above their key_bits low bits, ascending
 * and return where they are, a or tmp (room for n).  A bucket holds
 * tens of k-mers, so one counting pass on the keys' top bits into about
 * n bins comes first (a most-significant-digit radix sort); that
 * leaves the few keys of each bin to an insertion sort over the whole
 * array, which then mispredicts little and alone makes the result
 * sorted.  A bin of more than 16 keys is sorted the same way on the
 * bits below first, and a pass that puts every key in one bin moves on
 * to the next bits. */
static u128 *sort_keys(u128 *a, int64_t n, int key_bits, u128 *tmp)
{
    uint32_t end[4097];
    for (;;) {
        if (n <= 16 || key_bits == 0) {
            insertion_sort(a, n);
            return a;
        }
        int bits = 4;
        while ((1 << bits) < n && bits < 12)
            bits++;
        if (bits > key_bits)
            bits = key_bits;
        const int sh = key_bits - bits;
        const uint32_t nb = 1u << bits, d = nb - 1;
        key_bits = sh;
        memset(end, 0, (nb + 1) * sizeof(uint32_t));
        for (int64_t i = 0; i < n; i++)
            end[((uint32_t)(a[i] >> sh) & d) + 1]++;
        if (end[((uint32_t)(a[0] >> sh) & d) + 1] == n)
            continue;
        for (uint32_t b = 0; b < nb; b++)
            end[b + 1] += end[b];
        for (int64_t i = 0; i < n; i++)
            tmp[end[(uint32_t)(a[i] >> sh) & d]++] = a[i];
        /* end[b] is now the end of bin b; a is free to be scratch */
        for (uint32_t b = 0, s = 0; b < nb; s = end[b++]) {
            const int64_t len = end[b] - s;
            if (len > 16 && sort_keys(tmp + s, len, sh, a + s) != tmp + s)
                memcpy(tmp + s, a + s, len * sizeof(u128));
        }
        insertion_sort(tmp, n);
        return tmp;
    }
}

/* Append the canonical k-mer of every window of seq[0, len) (codes
 * 0-3, len >= k) to keys: forward and reverse complement rolled
 * together, the smaller kept (updateK, reference utils.cpp:752-757).
 * rc_in[c] is the complement of c at the reverse strand's first
 * position. */
static void roll(const uint8_t *seq, int64_t len, int k, u128 mask,
                 const u128 rc_in[4], u128 *keys)
{
    u128 f = 0, r = 0;
    for (int t = 0; t < k - 1; t++) {
        f = (f << 2) | seq[t];
        r = (r >> 2) | rc_in[seq[t]];
    }
    for (int64_t t = k - 1; t < len; t++) {
        f = ((f << 2) | seq[t]) & mask;
        r = (r >> 2) | rc_in[seq[t]];
        *keys++ = f < r ? f : r;
    }
}

/* Decode the buckets of data[pos0, end).
 *
 * With mins == NULL only walks and counts: info[0] the k-mer windows,
 * info[2] the buckets.  Otherwise also writes each bucket's distinct
 * canonical k-mers (mins/hi/lo, room for info[0] from a counting call)
 * and its minimizer (bmins, room for info[2]); info[1] the pairs.
 * Returns 0, -1 for a bucket that is cut short or malformed (info[3]
 * its offset in data), -2 when out of memory.  Never reads outside
 * [pos0, end) nor writes past the counts of the counting call. */
int64_t spsp_decode_pairs(const uint8_t *data, int64_t pos0, int64_t end,
                          int k, int m, uint64_t *mins, uint64_t *hi,
                          uint64_t *lo, uint64_t *bmins, int64_t *info)
{
    const int half = k - m;
    const int64_t row_len = 2 * (int64_t)half + m;
    const u128 mask = k == 64 ? ~(u128)0 : (((u128)1 << (2 * k)) - 1);
    u128 rc_in[4];
    for (unsigned c = 0; c < 4; c++)
        rc_in[c] = (u128)(c ^ 2) << (2 * (k - 1));
    uint8_t mc[32];
    buf_t codes = {0}, row = {0}, keys = {0}, tmp = {0};
    int64_t windows = 0, pairs = 0, nb = 0, rc = 0;
    int64_t pos = pos0;
    info[3] = -1;
    while (pos + m <= end) {
        const int64_t start = pos;
        uint64_t mval = 0;
        for (int j = 0; j < m; j++) {
            mc[j] = (data[pos + j] >> 1) & 3;
            mval = (mval << 2) | mc[j];
        }
        pos += m;
        if (end - pos < 4)
            goto bad;
        const int64_t size = (int64_t)data[pos] | (int64_t)data[pos + 1] << 8
                             | (int64_t)data[pos + 2] << 16
                             | (int64_t)data[pos + 3] << 24;
        pos += 4;
        if (size > end - pos)
            goto bad;
        const uint8_t *blob = data + pos;
        pos += size;

        /* blob_to_codes: a mod byte, the full bytes, then mod codes
         * from the top bits of one more byte */
        int64_t n_codes = 0, n_sk = 0;
        if (size > 0) {
            const int mod = blob[0];
            const int64_t last = mod == 0 ? size : size - 1;
            const int64_t nfull = last > 1 ? last - 1 : 0;
            n_codes = 4 * nfull + mod;
            n_sk = half > 0 ? n_codes / (2 * half) : 0;
            if (mins && n_sk > 0) {
                if (grow(&codes, n_codes, 1))
                    goto oom;
                uint8_t *c = codes.p;
                for (int64_t i = 0; i < nfull; i++) {
                    const uint8_t b = blob[1 + i];
                    c[4 * i] = b >> 6;
                    c[4 * i + 1] = (b >> 4) & 3;
                    c[4 * i + 2] = (b >> 2) & 3;
                    c[4 * i + 3] = b & 3;
                }
                for (int j = 0; j < mod; j++) {
                    const int sh = 2 * (mod - j);
                    c[4 * nfull + j] = sh < 8 ? (blob[last] >> sh) & 3 : 0;
                }
            }
        }
        int64_t nw = n_sk * (half + 1);
        if (mins && n_sk > 0) {
            if (grow(&keys, nw, sizeof(u128)) || grow(&row, row_len, 1))
                goto oom;
            uint8_t *r = row.p;
            const uint8_t *c = codes.p;
            memcpy(r + half, mc, m);
            for (int64_t s = 0; s < n_sk; s++) {
                memcpy(r, c + s * 2 * half, half);
                memcpy(r + half + m, c + s * 2 * half + half, half);
                roll(r, row_len, k, mask, rc_in,
                     (u128 *)keys.p + s * (half + 1));
            }
        }

        /* plaintext line pairs: left, minimizer, right */
        for (;;) {
            const uint8_t *nl1 = memchr(data + pos, '\n', end - pos);
            if (!nl1)
                goto bad;
            const int64_t p1 = pos, l1 = nl1 - (data + pos);
            pos += l1 + 1;
            const uint8_t *nl2 = memchr(data + pos, '\n', end - pos);
            if (!nl2)
                goto bad;
            const int64_t p2 = pos, l2 = nl2 - (data + pos);
            pos += l2 + 1;
            if (l1 == 0 && l2 == 0)
                break;
            const int64_t len = l1 + m + l2;
            if (len < k)
                continue;
            if (mins) {
                if (grow(&keys, nw + len - k + 1, sizeof(u128))
                    || grow(&row, len, 1))
                    goto oom;
                uint8_t *r = row.p;
                for (int64_t i = 0; i < l1; i++)
                    r[i] = (data[p1 + i] >> 1) & 3;
                memcpy(r + l1, mc, m);
                for (int64_t i = 0; i < l2; i++)
                    r[l1 + m + i] = (data[p2 + i] >> 1) & 3;
                roll(r, len, k, mask, rc_in, (u128 *)keys.p + nw);
            }
            nw += len - k + 1;
        }
        windows += nw;

        if (mins) {
            /* the bucket's distinct k-mers, ascending */
            if (grow(&tmp, nw, sizeof(u128)))
                goto oom;
            const u128 *a = sort_keys(keys.p, nw, 2 * k, tmp.p);
            for (int64_t i = 0; i < nw; i++) {
                if (i && a[i] == a[i - 1])
                    continue;
                mins[pairs] = mval;
                hi[pairs] = (uint64_t)(a[i] >> 64);
                lo[pairs] = (uint64_t)a[i];
                pairs++;
            }
            bmins[nb] = mval;
        }
        nb++;
        continue;
bad:
        info[3] = start;
        rc = -1;
        goto done;
    }
    goto done;
oom:
    rc = -2;
done:
    free(codes.p);
    free(row.p);
    free(keys.p);
    free(tmp.p);
    info[0] = windows;
    info[1] = pairs;
    info[2] = nb;
    return rc;
}
