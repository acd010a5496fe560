/* Reading and inflating the sketches of a comparison for the port's
 * comparator, on up to 8 threads (the thread helpers of spsp_decode.c).
 *
 * spsp_read_files opens each file, sizes it with fstat, reads it whole
 * and closes it; a file that starts with the gzip magic 1f 8b is
 * inflated member after member as Python's gzip module reads it (a
 * member's header, its raw deflate data, a CRC-32 and length trailer,
 * then any zero bytes of padding before the next member), other bytes
 * are taken as they are.  The header is parsed and the trailer checked
 * here, around zlib's raw inflate, so that each way a file can fail is
 * told apart as Python tells it apart: no such file, a file cut short,
 * a bad gzip header or trailer, bad deflate data.  It also finds the end
 * of the sketch's header line, which the caller parses.
 * spsp_read_collect then copies every file's bytes into one buffer of
 * the caller's and frees them.
 */

#include <errno.h>
#include <fcntl.h>
#include <limits.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <sys/stat.h>
#include <unistd.h>
#include <zlib.h>

int spsp_stage_threads(int64_t n_items, int64_t parts, int64_t pinned);
int spsp_run_threads(int threads, void *(*worker)(void *), void *ctx);

/* A file's row of results, READ_COLS int64 values. */
enum {
    R_BUF,      /* the address of its bytes, 0 once collected or freed */
    R_SIZE,     /* their length */
    R_STATUS,   /* READ_* */
    R_CODE,     /* errno, zlib's return code or GZ_* */
    R_MSG,      /* the address of zlib's message, or 0 */
    R_POS0,     /* the offset after the header line, 0 without one */
    READ_COLS
};
enum { READ_OK, READ_OS, READ_EOF, READ_BAD_GZIP, READ_ZLIB, READ_NO_MEMORY };
enum { GZ_MAGIC = 1, GZ_METHOD, GZ_CRC, GZ_LENGTH };

static uint32_t le32(const uint8_t *p)
{
    return p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16
           | (uint32_t)p[3] << 24;
}

/* Read the file whole into *buf (malloc'd, *len bytes).  Returns 0 or
 * an errno. */
static int read_whole(const char *path, uint8_t **buf, int64_t *len)
{
    const int fd = open(path, O_RDONLY | O_CLOEXEC);
    if (fd < 0)
        return errno;
    struct stat st;
    int err = 0;
    if (fstat(fd, &st)) {
        err = errno;
        goto out;
    }
    if (S_ISDIR(st.st_mode)) {
        err = EISDIR;
        goto out;
    }
    /* one byte more than the size, so that a regular file that has not
     * grown is read whole by one call; anything else, a file that gives
     * no size among them, is read until EOF */
    const int64_t size = S_ISREG(st.st_mode) ? st.st_size : 0;
    int64_t cap = size + 1, n = 0;
    uint8_t *b = malloc(cap);
    for (;;) {
        if (!b) {
            err = ENOMEM;
            goto out;
        }
        const ssize_t r = read(fd, b + n, cap - n);
        if (r < 0 && errno == EINTR)
            continue;
        if (r < 0) {
            err = errno;
            free(b);
            goto out;
        }
        n += r;
        if (r == 0 || (size && n >= size && n < cap))
            break;
        if (n == cap) {
            uint8_t *g = realloc(b, 2 * cap);
            if (!g)
                free(b);
            b = g;
            cap *= 2;
        }
    }
    *buf = b;
    *len = n;
out:
    close(fd);
    return err;
}

/* Inflate the gzip members of in[0, n) into *outp (*out_len bytes); on
 * a failure, row gets its status, code and message. */
static void inflate_members(const uint8_t *in, int64_t n, uint8_t **outp,
                            int64_t *out_len, int64_t *row)
{
    z_stream z;
    memset(&z, 0, sizeof z);
    /* the last member's length, a good first guess for one member; a
     * byte more, so that the stream can end before the room does */
    const int64_t guess = n >= 4 ? le32(in + n - 4) : 0;
    int64_t cap = (guess < 64 * n ? guess : 4 * n) + 1;
    int64_t len = 0, pos = 0;
    uint8_t *out = malloc(cap);
    if (!out || inflateInit2(&z, -MAX_WBITS) != Z_OK) {
        row[R_STATUS] = READ_NO_MEMORY;
        free(out);
        return;
    }
    while (pos < n) {
        /* a member's header: magic, method, flags, 6 bytes, and the
         * fields the flags name; a name or comment cut short is no
         * error here, as in Python, but leaves no data */
        if (n - pos < 2 || in[pos] != 0x1f || in[pos + 1] != 0x8b) {
            row[R_STATUS] = READ_BAD_GZIP;
            row[R_CODE] = GZ_MAGIC;
            break;
        }
        if (n - pos < 10)
            goto eof;
        if (in[pos + 2] != Z_DEFLATED) {
            row[R_STATUS] = READ_BAD_GZIP;
            row[R_CODE] = GZ_METHOD;
            break;
        }
        const int flags = in[pos + 3];
        int64_t p = pos + 10;
        if (flags & 4) {
            if (n - p < 2 || n - p - 2 < (in[p] | in[p + 1] << 8))
                goto eof;
            p += 2 + (in[p] | in[p + 1] << 8);
        }
        for (int f = 8; f <= 16; f += 8)
            if (flags & f)
                while (p < n && in[p++])
                    ;
        if (flags & 2) {
            if (n - p < 2)
                goto eof;
            p += 2;
        }

        /* the deflate data */
        const int64_t start = len;
        inflateReset(&z);
        z.next_in = (uint8_t *)in + p;
        int r;
        do {
            if (len == cap) {
                uint8_t *g = realloc(out, 2 * cap);
                if (!g) {
                    row[R_STATUS] = READ_NO_MEMORY;
                    goto done;
                }
                out = g;
                cap *= 2;
            }
            const int64_t left = n - (int64_t)(z.next_in - in);
            z.avail_in = left < UINT_MAX ? (uInt)left : UINT_MAX;
            z.next_out = out + len;
            z.avail_out = cap - len < UINT_MAX ? (uInt)(cap - len) : UINT_MAX;
            r = inflate(&z, Z_NO_FLUSH);
            len = z.next_out - out;
            if (r == Z_MEM_ERROR) {
                row[R_STATUS] = READ_NO_MEMORY;
                goto done;
            }
            if (r != Z_OK && r != Z_BUF_ERROR && r != Z_STREAM_END) {
                row[R_STATUS] = READ_ZLIB;
                row[R_CODE] = r;
                row[R_MSG] = (int64_t)(uintptr_t)z.msg;
                goto done;
            }
            if (r != Z_STREAM_END && z.avail_out && z.next_in == in + n)
                goto eof;
        } while (r != Z_STREAM_END);

        /* the trailer, then the padding */
        p = z.next_in - in;
        if (n - p < 8)
            goto eof;
        if (le32(in + p) != crc32_z(0, out + start, len - start)) {
            row[R_STATUS] = READ_BAD_GZIP;
            row[R_CODE] = GZ_CRC;
            break;
        }
        if (le32(in + p + 4) != (uint32_t)(len - start)) {
            row[R_STATUS] = READ_BAD_GZIP;
            row[R_CODE] = GZ_LENGTH;
            break;
        }
        for (p += 8; p < n && !in[p]; p++)
            ;
        pos = p;
    }
    goto done;
eof:
    row[R_STATUS] = READ_EOF;
done:
    inflateEnd(&z);
    *outp = out;
    *out_len = len;
}

typedef struct {
    const char *const *paths;
    int64_t *rows;
    int64_t n, next;
} files_t;

static void *read_worker(void *arg)
{
    files_t *w = arg;
    int64_t i;
    while ((i = __atomic_fetch_add(&w->next, 1, __ATOMIC_RELAXED)) < w->n) {
        int64_t *row = w->rows + READ_COLS * i;
        uint8_t *buf = NULL;
        int64_t len = 0;
        memset(row, 0, READ_COLS * sizeof *row);
        const int err = read_whole(w->paths[i], &buf, &len);
        if (err) {
            row[R_STATUS] = err == ENOMEM ? READ_NO_MEMORY : READ_OS;
            row[R_CODE] = err;
            continue;
        }
        if (len >= 2 && buf[0] == 0x1f && buf[1] == 0x8b) {
            uint8_t *raw = buf;
            inflate_members(raw, len, &buf, &len, row);
            free(raw);
        }
        row[R_BUF] = (int64_t)(uintptr_t)buf;
        row[R_SIZE] = len;
        const uint8_t *nl = len ? memchr(buf, '\n', len) : NULL;
        if (row[R_STATUS] == READ_OK && nl)
            row[R_POS0] = nl - buf + 1;
    }
    return NULL;
}

/* Read the n files at paths, on up to 8 threads (threads > 0 pins
 * their number), into rows (READ_COLS values a file, the R_* above).
 * Every row's buffer, set whatever its status, is the caller's to pass
 * to spsp_read_collect.  Returns the threads that ran. */
int64_t spsp_read_files(int64_t n, const char *const *paths, int64_t threads,
                        int64_t *rows)
{
    files_t w = {paths, rows, n, 0};
    return spsp_run_threads(spsp_stage_threads(n, n, threads), read_worker,
                            &w);
}

/* Copy each file's bytes to pool + offs[i] where pool is not NULL, and
 * free every buffer that spsp_read_files left in rows. */
void spsp_read_collect(int64_t n, int64_t *rows, uint8_t *pool,
                       const int64_t *offs)
{
    for (int64_t i = 0; i < n; i++) {
        int64_t *row = rows + READ_COLS * i;
        uint8_t *buf = (uint8_t *)(uintptr_t)row[R_BUF];
        if (pool && row[R_SIZE])
            memcpy(pool + offs[i], buf, row[R_SIZE]);
        free(buf);
        row[R_BUF] = 0;
    }
}
