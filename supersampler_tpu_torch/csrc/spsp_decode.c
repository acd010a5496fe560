/* Native sketch decode and pair grouping for the port's comparator.
 *
 * Decode (spsp_decode_windows): one pass over the windows of a
 * comparison's inflated wire bytes, a window being whole buckets of one
 * sketch, turns every bucket into its distinct canonical k-mers, in the
 * order the comparator groups them: windows in file order, buckets in
 * window order, then (hi, lo) ascending, all in one set of concatenated
 * arrays.  It does what the reference's inject_minimizer, rolling k-mer
 * extraction and per-bucket colour maps do (reference
 * Comparator.cpp:78-264).  The windows go to up to 8 threads.
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
 *
 * Grouping (spsp_group_pairs, at the end): the decoded pairs of every
 * file, concatenated in file order, numbered by distinct (minimizer,
 * k-mer) without a global sort, from the order the decode gives.
 */

#define _GNU_SOURCE
#include <pthread.h>
#include <sched.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

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

/* Sort the n elements of a, whose keys KEY(x) are equal above their
 * key_bits low bits, ascending and stably, and return where they are,
 * a or tmp (room for n).  A bucket holds tens of k-mers, so one
 * counting pass on the keys' top bits into about n bins comes first (a
 * most-significant-digit radix sort); that leaves the few elements of
 * each bin to an insertion sort over the whole array, which then
 * mispredicts little and alone makes the result sorted.  A bin of more
 * than 16 elements is sorted the same way on the bits below first, and
 * a pass that puts every element in one bin moves on to the next bits.
 * Every step keeps equal keys in their order.  SORT_BY_KEY(name, T,
 * KEY) defines name for elements of type T. */
#define SORT_BY_KEY(NAME, T, KEY)                                          \
    static void NAME##_insertion(T *a, int64_t n)                          \
    {                                                                      \
        for (int64_t i = 1; i < n; i++) {                                  \
            T v = a[i];                                                    \
            int64_t j = i;                                                 \
            while (j > 0 && KEY(a[j - 1]) > KEY(v)) {                      \
                a[j] = a[j - 1];                                           \
                j--;                                                       \
            }                                                              \
            a[j] = v;                                                      \
        }                                                                  \
    }                                                                      \
                                                                           \
    static T *NAME(T *a, int64_t n, int key_bits, T *tmp)                  \
    {                                                                      \
        uint32_t end[4097];                                                \
        for (;;) {                                                         \
            if (n <= 16 || key_bits == 0) {                                \
                NAME##_insertion(a, n);                                    \
                return a;                                                  \
            }                                                              \
            int bits = 4;                                                  \
            while ((1 << bits) < n && bits < 12)                           \
                bits++;                                                    \
            if (bits > key_bits)                                           \
                bits = key_bits;                                           \
            const int sh = key_bits - bits;                                \
            const uint32_t nb = 1u << bits, d = nb - 1;                    \
            key_bits = sh;                                                 \
            memset(end, 0, (nb + 1) * sizeof(uint32_t));                   \
            for (int64_t i = 0; i < n; i++)                                \
                end[((uint32_t)(KEY(a[i]) >> sh) & d) + 1]++;              \
            if (end[((uint32_t)(KEY(a[0]) >> sh) & d) + 1] == n)           \
                continue;                                                  \
            for (uint32_t b = 0; b < nb; b++)                              \
                end[b + 1] += end[b];                                      \
            for (int64_t i = 0; i < n; i++)                                \
                tmp[end[(uint32_t)(KEY(a[i]) >> sh) & d]++] = a[i];        \
            /* end[b] is now the end of bin b; a is free to be scratch */  \
            for (uint32_t b = 0, s = 0; b < nb; s = end[b++]) {            \
                const int64_t len = end[b] - s;                            \
                if (len > 16 && NAME(tmp + s, len, sh, a + s) != tmp + s)  \
                    memcpy(tmp + s, a + s, len * sizeof(T));               \
            }                                                              \
            NAME##_insertion(tmp, n);                                      \
            return tmp;                                                    \
        }                                                                  \
    }

#define SELF(x) (x)
SORT_BY_KEY(sort_keys, u128, SELF)

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

/* The scratch arrays of one thread's windows, kept from one window to
 * the next. */
typedef struct {
    buf_t codes, row, keys, tmp;
} scratch_t;

/* Decode the buckets of data[pos0, end).
 *
 * With mins == NULL only walks and counts: info[0] the k-mer windows,
 * info[2] the buckets.  Otherwise also writes each bucket's distinct
 * canonical k-mers (mins/hi/lo, room for info[0] from a counting call)
 * and, where bmins is not NULL, its minimizer (room for info[2]);
 * info[1] the pairs.  Returns 0, -1 for a bucket that is cut short or
 * malformed (info[3] its offset in data), -2 when out of memory.
 * Never reads outside [pos0, end) nor writes past the counts of the
 * counting call. */
static int64_t decode_window(const uint8_t *data, int64_t pos0, int64_t end,
                             int k, int m, uint64_t *mins, uint64_t *hi,
                             uint64_t *lo, uint64_t *bmins, int64_t *info,
                             scratch_t *s)
{
    const int half = k - m;
    const int64_t row_len = 2 * (int64_t)half + m;
    const u128 mask = k == 64 ? ~(u128)0 : (((u128)1 << (2 * k)) - 1);
    u128 rc_in[4];
    for (unsigned c = 0; c < 4; c++)
        rc_in[c] = (u128)(c ^ 2) << (2 * (k - 1));
    uint8_t mc[32];
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
                if (grow(&s->codes, n_codes, 1))
                    goto oom;
                uint8_t *c = s->codes.p;
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
            if (grow(&s->keys, nw, sizeof(u128)) || grow(&s->row, row_len, 1))
                goto oom;
            uint8_t *r = s->row.p;
            const uint8_t *c = s->codes.p;
            memcpy(r + half, mc, m);
            for (int64_t j = 0; j < n_sk; j++) {
                memcpy(r, c + j * 2 * half, half);
                memcpy(r + half + m, c + j * 2 * half + half, half);
                roll(r, row_len, k, mask, rc_in,
                     (u128 *)s->keys.p + j * (half + 1));
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
                if (grow(&s->keys, nw + len - k + 1, sizeof(u128))
                    || grow(&s->row, len, 1))
                    goto oom;
                uint8_t *r = s->row.p;
                for (int64_t i = 0; i < l1; i++)
                    r[i] = (data[p1 + i] >> 1) & 3;
                memcpy(r + l1, mc, m);
                for (int64_t i = 0; i < l2; i++)
                    r[l1 + m + i] = (data[p2 + i] >> 1) & 3;
                roll(r, len, k, mask, rc_in, (u128 *)s->keys.p + nw);
            }
            nw += len - k + 1;
        }
        windows += nw;

        if (mins) {
            /* the bucket's distinct k-mers, ascending */
            if (grow(&s->tmp, nw, sizeof(u128)))
                goto oom;
            const u128 *a = sort_keys(s->keys.p, nw, 2 * k, s->tmp.p);
            for (int64_t i = 0; i < nw; i++) {
                if (i && a[i] == a[i - 1])
                    continue;
                mins[pairs] = mval;
                hi[pairs] = (uint64_t)(a[i] >> 64);
                lo[pairs] = (uint64_t)a[i];
                pairs++;
            }
            if (bmins)
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
    info[0] = windows;
    info[1] = pairs;
    info[2] = nb;
    return rc;
}

/* Threads.  A native stage runs on the caller's thread and up to
 * MAX_THREADS - 1 more, which take its items one at a time from a
 * shared counter, so results land by item index whichever thread made
 * them. */
enum { MAX_THREADS = 8, PART_BYTES = 1 << 16 };

/* The threads for n_items items that come to about parts parts of
 * PART_BYTES: the smallest of MAX_THREADS, the CPUs this process may
 * run on, n_items and parts, and at least 1.  Where pinned is above 0
 * (the tests), the smaller of pinned, MAX_THREADS and n_items. */
int spsp_stage_threads(int64_t n_items, int64_t parts, int64_t pinned)
{
    int64_t t = MAX_THREADS;
    if (pinned > 0) {
        t = pinned < t ? pinned : t;
    } else {
        cpu_set_t set;
        const int64_t cpus = sched_getaffinity(0, sizeof set, &set) == 0
                             ? CPU_COUNT(&set) : 1;
        t = cpus < t ? cpus : t;
        t = parts < t ? parts : t;
    }
    t = n_items < t ? n_items : t;
    return t > 1 ? (int)t : 1;
}

/* Run worker(ctx) on the caller's thread and on threads - 1 new ones;
 * the work is shared through ctx, so a thread that fails to start only
 * leaves more to the others.  Returns the threads that ran. */
int spsp_run_threads(int threads, void *(*worker)(void *), void *ctx)
{
    pthread_t th[MAX_THREADS];
    int started = 0;
    for (int t = 1; t < threads && t < MAX_THREADS; t++)
        started += !pthread_create(&th[started], NULL, worker, ctx);
    worker(ctx);
    for (int t = 0; t < started; t++)
        pthread_join(th[t], NULL);
    return started + 1;
}

/* The windows of one decode, shared by its threads. */
typedef struct {
    const uint8_t *const *data;
    const int64_t *win;
    int64_t *out;
    const int64_t *off, *boff;
    uint64_t *mins, *hi, *lo, *bmins;
    int64_t *fids;
    int64_t n, n_query, next;
    int oom;
} pass_t;

static void *pass_worker(void *arg)
{
    pass_t *p = arg;
    scratch_t s = {0};
    int64_t i, info[4];
    while ((i = __atomic_fetch_add(&p->next, 1, __ATOMIC_RELAXED)) < p->n) {
        const int64_t *w = p->win + 5 * i;
        int64_t *o = p->out + 4 * i;
        const int64_t at = p->mins ? p->off[i] : 0;
        const int64_t rc =
            p->mins ? decode_window(p->data[i], w[0], w[1], (int)w[2],
                                    (int)w[3], p->mins + at, p->hi + at,
                                    p->lo + at, i < p->n_query
                                    ? p->bmins + p->boff[i] : NULL, info, &s)
                    : decode_window(p->data[i], w[0], w[1], (int)w[2],
                                    (int)w[3], NULL, NULL, NULL, NULL, info,
                                    &s);
        if (rc == -2)
            __atomic_store_n(&p->oom, 1, __ATOMIC_RELAXED);
        o[0] = info[0];
        o[1] = info[2];
        o[2] = info[1];
        o[3] = info[3];
        for (int64_t j = 0; p->mins && j < info[1]; j++)
            p->fids[at + j] = w[4];
    }
    free(s.codes.p);
    free(s.row.p);
    free(s.keys.p);
    free(s.tmp.p);
    return NULL;
}

/* Decode the n windows of one comparison or chunk in one pass, on up to
 * MAX_THREADS threads (threads > 0 pins their number).  Window i is
 * data[i][pos0, end) with win[5 i ..] = pos0, end, k, m, file id; the
 * first n_query windows are the query files'.
 *
 * Called twice.  With mins == NULL it counts: out[4 i ..] = window i's
 * k-mer windows and buckets; info[0] the k-mer windows of all, info[4]
 * the buckets of the query windows.  Then, with out as the counting
 * call left it, it fills mins/hi/lo and fids (room for info[0]) with
 * every window's distinct pairs in window order, and bmins (room for
 * info[4]) with the query windows' bucket minimizers; out[4 i + 2] =
 * window i's pairs, info[1] the pairs of all.  info[2] the threads
 * that ran.  Returns 0, -1 for a window with a bucket cut short or
 * malformed (info[3] the first such window, out[4 i + 3] its offset),
 * -2 when out of memory. */
int64_t spsp_decode_windows(int64_t n, int64_t n_query,
                            const uint8_t *const *data, const int64_t *win,
                            int64_t threads, int64_t *out, uint64_t *mins,
                            uint64_t *hi, uint64_t *lo, int64_t *fids,
                            uint64_t *bmins, int64_t *info)
{
    pass_t p = {data, win, out, NULL, NULL, mins, hi, lo, bmins, fids,
                n, n_query, 0, 0};
    int64_t *off = NULL, rc = 0, bytes = 0;
    for (int64_t i = 0; i < n; i++)
        bytes += win[5 * i + 1] - win[5 * i];
    if (mins) {
        /* each window's pairs, and query buckets, from where the ones
         * before it end at most */
        off = malloc(2 * (n + 1) * sizeof(int64_t));
        if (!off)
            return -2;
        off[0] = off[n + 1] = 0;
        for (int64_t i = 0; i < n; i++) {
            off[i + 1] = off[i] + out[4 * i];
            off[n + 2 + i] = off[n + 1 + i] + (i < n_query ? out[4 * i + 1]
                                                            : 0);
        }
        p.off = off;
        p.boff = off + n + 1;
    }
    info[2] = spsp_run_threads(
        spsp_stage_threads(n, bytes / PART_BYTES, threads), pass_worker, &p);
    info[0] = info[1] = info[4] = 0;
    info[3] = -1;
    for (int64_t i = 0; i < n; i++) {
        if (out[4 * i + 3] >= 0 && info[3] < 0)
            info[3] = i;
        info[0] += out[4 * i];
        info[4] += i < n_query ? out[4 * i + 1] : 0;
    }
    if (p.oom)
        rc = -2;
    else if (info[3] >= 0)
        rc = -1;
    else if (mins) {
        /* close the gaps the dedup left: each window's pairs move down
         * to where the ones before it end, in window order */
        for (int64_t i = 0; i < n; i++) {
            const int64_t at = off[i], c = out[4 * i + 2];
            if (info[1] != at) {
                memmove(mins + info[1], mins + at, c * sizeof *mins);
                memmove(hi + info[1], hi + at, c * sizeof *hi);
                memmove(lo + info[1], lo + at, c * sizeof *lo);
                memmove(fids + info[1], fids + at, c * sizeof *fids);
            }
            info[1] += c;
        }
    }
    free(off);
    return rc;
}

/* Grouping of the decoded pairs.
 *
 * spsp_group_pairs numbers the distinct (minimizer, k-mer) pairs of the
 * files and lists each pair's group and file in (minimizer, hi, lo,
 * file) order: group ids non-decreasing, file ids ascending within a
 * group.  It uses the order the decode gives instead of sorting every
 * pair.
 *
 * Precondition: file ids never descend over the array, so each file's
 * pairs form one stretch (every caller concatenates files in order).
 * Within a file the decode gives the buckets in the sketch's order,
 * which the writer sorts by minimizer, so each minimizer's pairs are
 * one slice of each file.  One walk cuts the array into slices of one
 * file and one minimizer and numbers the distinct minimizers through
 * an open-addressing hash; the few distinct minimizers are sorted, and
 * a counting pass lists each minimizer's slices in array order, which
 * is file order.  Then each minimizer's items, a few hundred, are
 * sorted stably by k-mer (the radix pass and insertion sort of the
 * decode) with their file ids, so the items of one k-mer keep file
 * order, and a pass numbers the groups.  Minimizers are independent
 * there: runs of them of about equal items go to up to 8 threads, one
 * per core, each numbering its groups from 0 until one pass adds the
 * groups before it.  Buckets out of order only cut more slices.  The
 * walk also counts the runs, stretches of one file with non-decreasing
 * minimizers: one per sketch whose buckets are in order. */

typedef struct {
    u128 key;
    int64_t fid;
} item_t;

#define ITEM_KEY(x) ((x).key)
SORT_BY_KEY(sort_items, item_t, ITEM_KEY)

/* An open-addressing table of minimizers and their ids + 1 (id 0:
 * empty), mask + 1 entries, a power of two, at most half of them
 * used. */
typedef struct {
    uint64_t key;
    uint64_t id;
} entry_t;

typedef struct {
    entry_t *e;
    uint64_t mask;
} table_t;

/* The entry that holds key, or the empty one where it would go. */
static inline uint64_t probe(const table_t *t, uint64_t key)
{
    uint64_t i = key * 0x9E3779B97F4A7C15ull;
    i = (i ^ i >> 32) & t->mask;
    while (t->e[i].id && t->e[i].key != key)
        i = (i + 1) & t->mask;
    return i;
}

/* Double t's entries (16 at first) and insert its entries again. */
static int table_grow(table_t *t)
{
    const table_t old = *t;
    const uint64_t size = old.e ? 2 * (old.mask + 1) : 16;
    t->e = calloc(size, sizeof(entry_t));
    t->mask = size - 1;
    if (!t->e) {
        free(old.e);
        return -1;
    }
    for (uint64_t i = 0; old.e && i <= old.mask; i++)
        if (old.e[i].id)
            t->e[probe(t, old.e[i].key)] = old.e[i];
    free(old.e);
    return 0;
}

/* A run of whole minimizers: the slices od[p0, p1), whose items go to
 * gids and fids_out from base on; groups counts its k-mers, numbered
 * from 0; rc -2 when out of memory. */
typedef struct {
    const uint64_t *hi, *lo;
    const int64_t *fids, *st;
    const uint32_t *od, *sm;
    int32_t *gids, *fids_out;
    int key_bits;
    int64_t p0, p1, base, groups, rc;
} part_t;

static void *group_part(void *arg)
{
    part_t *w = arg;
    const int64_t *st = w->st;
    const uint32_t *od = w->od, *sm = w->sm;
    buf_t items = {0}, items_tmp = {0};
    int64_t g = -1, base = w->base;
    w->rc = 0;
    for (int64_t p = w->p0, e; p < w->p1; p = e) {
        /* the slices od[p, e) of one minimizer, c items */
        int64_t c = 0;
        for (e = p; e < w->p1 && sm[od[e]] == sm[od[p]]; e++)
            c += st[od[e] + 1] - st[od[e]];
        if (grow(&items, c, sizeof(item_t))
            || grow(&items_tmp, c, sizeof(item_t))) {
            w->rc = -2;
            break;
        }

        /* the items in file order, sorted stably by k-mer */
        item_t *it = items.p;
        for (int64_t q = p, j = 0; q < e; q++) {
            const int64_t s0 = st[od[q]], s1 = st[od[q] + 1];
            const int64_t f = w->fids[s0];
            for (int64_t i = s0; i < s1; i++, j++) {
                it[j].key = (u128)w->hi[i] << 64 | w->lo[i];
                it[j].fid = f;
            }
        }
        const item_t *sorted = sort_items(it, c, w->key_bits, items_tmp.p);

        /* one group per distinct k-mer */
        for (int64_t j = 0; j < c; j++) {
            g += j == 0 || sorted[j].key != sorted[j - 1].key;
            w->gids[base + j] = (int32_t)g;
            w->fids_out[base + j] = (int32_t)sorted[j].fid;
        }
        base += c;
    }
    free(items.p);
    free(items_tmp.p);
    w->groups = g + 1;
    return NULL;
}

/* Group the n pairs (mins, hi, lo, fids) as above: gids and fids_out
 * (room for n each) in (minimizer, hi, lo, file) order.  info[0] the
 * groups, info[1] the runs.  Returns 0, -1 when file ids descend
 * (info[2] the first position whose id is below its predecessor's),
 * -2 when out of memory.  n must be below 2^31 and the file ids within
 * int32. */
int64_t spsp_group_pairs(const uint64_t *mins, const uint64_t *hi,
                         const uint64_t *lo, const int64_t *fids, int64_t n,
                         int32_t *gids, int32_t *fids_out, int64_t *info)
{
    enum { MAX_PARTS = 8, PART_ITEMS = 16384 };
    buf_t sl_start = {0}, sl_min = {0}, ord = {0}, mv = {0}, mcount = {0},
          keys = {0}, tmp = {0};
    table_t mt = {0};
    part_t parts[MAX_PARTS];
    pthread_t threads[MAX_PARTS];
    int started[MAX_PARTS] = {0};
    int64_t rc = 0, runs = 0, n_min = 0, groups = 0, descents = 0;
    uint64_t min_or = 0, hi_or = 0, lo_or = 0;
    info[2] = -1;
    if (n == 0)
        goto done;

    /* slices of one file and one minimizer (their starts, branch-free,
     * then n), file ids that descend, and the bits the keys use */
    if (grow(&sl_start, n + 1, sizeof(int64_t))
        || grow(&sl_min, n, sizeof(uint32_t)) || table_grow(&mt))
        goto oom;
    int64_t *st = sl_start.p, n_sl = 1;
    uint32_t *sm = sl_min.p;
    st[0] = 0;
    hi_or = hi[0];
    lo_or = lo[0];
    for (int64_t i = 1; i < n; i++) {
        st[n_sl] = i;
        n_sl += (mins[i] != mins[i - 1]) | (fids[i] != fids[i - 1]);
        descents += fids[i] < fids[i - 1];
        hi_or |= hi[i];
        lo_or |= lo[i];
    }
    st[n_sl] = n;
    if (descents) {
        int64_t i = 1;
        while (fids[i] >= fids[i - 1])
            i++;
        info[2] = i;
        rc = -1;
        goto done;
    }

    /* each slice's minimizer id, each minimizer's slices and items, and
     * the runs */
    for (int64_t s = 0; s < n_sl; s++) {
        const int64_t i = st[s];
        runs += i == 0 || fids[i] != fids[i - 1] || mins[i] < mins[i - 1];
        uint64_t t = probe(&mt, mins[i]);
        if (!mt.e[t].id) {
            if (grow(&mv, n_min + 1, sizeof(uint64_t))
                || grow(&mcount, 2 * (n_min + 1), sizeof(int64_t)))
                goto oom;
            ((uint64_t *)mv.p)[n_min] = mins[i];
            ((int64_t *)mcount.p)[2 * n_min] = 0;
            ((int64_t *)mcount.p)[2 * n_min + 1] = 0;
            min_or |= mins[i];
            mt.e[t].key = mins[i];
            mt.e[t].id = (uint64_t)++n_min;
            if (2 * (uint64_t)n_min > mt.mask) {
                if (table_grow(&mt))
                    goto oom;
                t = probe(&mt, mins[i]);
            }
        }
        sm[s] = (uint32_t)(mt.e[t].id - 1);
        ((int64_t *)mcount.p)[2 * sm[s]]++;
        ((int64_t *)mcount.p)[2 * sm[s] + 1] += st[s + 1] - i;
    }

    /* the minimizers ascending, each id packed below its value; the
     * parts, cut between minimizers at about equal items; each
     * minimizer's slices in array order */
    if (grow(&keys, n_min, sizeof(u128)) || grow(&tmp, n_min, sizeof(u128))
        || grow(&ord, n_sl, sizeof(uint32_t)))
        goto oom;
    u128 *pk = keys.p;
    for (int64_t id = 0; id < n_min; id++)
        pk[id] = (u128)((uint64_t *)mv.p)[id] << 32 | (uint64_t)id;
    const u128 *mins_sorted = sort_keys(
        pk, n_min, 32 + (min_or ? 64 - __builtin_clzll(min_or) : 0),
        tmp.p);
    const long cores = sysconf(_SC_NPROCESSORS_ONLN);
    int64_t n_parts = n / PART_ITEMS;
    n_parts = n_parts < MAX_PARTS ? n_parts : MAX_PARTS;
    n_parts = n_parts < cores ? n_parts : cores;
    n_parts = n_parts > 1 ? n_parts : 1;
    int64_t *mc = mcount.p, k = 0;
    parts[0].p0 = parts[0].base = 0;
    for (int64_t q = 0, pos = 0, at = 0; q < n_min; q++) {
        const uint32_t id = (uint32_t)mins_sorted[q];
        const int64_t len = mc[2 * id];
        at += mc[2 * id + 1];
        mc[2 * id] = pos;
        pos += len;
        if (k + 1 < n_parts && at * n_parts >= (k + 1) * n && pos < n_sl) {
            parts[k++].p1 = pos;
            parts[k].p0 = pos;
            parts[k].base = at;
        }
    }
    parts[k].p1 = n_sl;
    n_parts = k + 1;
    uint32_t *od = ord.p;
    for (int64_t s = 0; s < n_sl; s++)
        od[mc[2 * sm[s]]++] = (uint32_t)s;

    /* the parts, on threads where they start; then the groups before
     * each part added to its ids */
    const int key_bits = hi_or ? 128 - __builtin_clzll(hi_or)
                         : lo_or ? 64 - __builtin_clzll(lo_or) : 0;
    for (k = 0; k < n_parts; k++) {
        part_t *w = &parts[k];
        w->hi = hi;
        w->lo = lo;
        w->fids = fids;
        w->st = st;
        w->od = od;
        w->sm = sm;
        w->gids = gids;
        w->fids_out = fids_out;
        w->key_bits = key_bits;
        if (k > 0)
            started[k] = !pthread_create(&threads[k], NULL, group_part, w);
    }
    group_part(&parts[0]);
    for (k = 1; k < n_parts; k++) {
        if (started[k])
            pthread_join(threads[k], NULL);
        else
            group_part(&parts[k]);
    }
    for (k = 0; k < n_parts; k++) {
        if (parts[k].rc)
            goto oom;
        const int64_t end = k + 1 < n_parts ? parts[k + 1].base : n;
        for (int64_t j = parts[k].base; groups && j < end; j++)
            gids[j] += (int32_t)groups;
        groups += parts[k].groups;
    }
    goto done;
oom:
    rc = -2;
done:
    free(sl_start.p);
    free(sl_min.p);
    free(ord.p);
    free(mv.p);
    free(mcount.p);
    free(keys.p);
    free(tmp.p);
    free(mt.e);
    info[0] = groups;
    info[1] = runs;
    return rc;
}
