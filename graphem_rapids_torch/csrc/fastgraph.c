/* fastgraph: threaded host helpers of the port's set-up path.
 *
 * The port's own copy of graphem_rapids_tpu/native/fastgraph.c: the same
 * six functions with the same results, behind a plain C interface (pointers
 * and lengths; the caller allocates every output but parse_edges'), so that
 * _build.py compiles it with the host compiler and loads it with ctypes, and
 * the library does not depend on the Python ABI. These are host code, not
 * CUDA kernels: they take the single-threaded numpy lines of the neighbor
 * table builders (ops/forces.py), the CSR edge extraction
 * (models/embedder.py) and the edge-list parser (datasets.py), each bound by
 * streaming its arrays through memory once or a few times.
 *
 * Every index read from a caller's array is checked against the length of
 * the array it indexes; the helpers return the number of indices out of
 * range (0 when all are in range), and the Python wrappers raise on any.
 * Threads: T - 1 pthreads plus the calling thread, each over a contiguous
 * range; a thread that cannot be created runs its range in the caller.
 */

#include <limits.h>
#include <pthread.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define FG_MAX_THREADS 16

typedef void *(*fg_worker)(void *);

/* fn over T argument blocks of `size` bytes each, in parallel */
static void run_all(fg_worker fn, void *args, size_t size, int T)
{
    pthread_t tids[FG_MAX_THREADS];
    int started[FG_MAX_THREADS] = {0};
    for (int t = 1; t < T; t++)
        started[t] = pthread_create(&tids[t], NULL, fn,
                                    (char *)args + (size_t)t * size) == 0;
    fn(args);
    for (int t = 1; t < T; t++) {
        if (started[t])
            pthread_join(tids[t], NULL);
        else
            fn((char *)args + (size_t)t * size);
    }
}

static int clamp_threads(int64_t nthreads)
{
    if (nthreads < 1)
        return 1;
    return nthreads > FG_MAX_THREADS ? FG_MAX_THREADS : (int)nthreads;
}

/* the element-wise helpers run on one thread below 4 elements a thread */
static int elem_threads(int64_t nthreads, int64_t E)
{
    int T = clamp_threads(nthreads);
    return (E > 0 && E < 4 * (int64_t)T) ? 1 : T;
}

void fg_free(void *p)
{
    free(p);
}

/* ------------------------------------------------------------------ *
 * parse_edges: one pass over the raw bytes of a whitespace edge list.
 *
 * Comment lines ('#', '%' after leading blanks) and unparsable lines are
 * skipped, the second field must be on the same line, trailing columns are
 * ignored, and the first data row is dropped with skip_header (the Matrix
 * Market size line). Fields are read as strtoll(p, &q, 10) reads them
 * (leading isspace skipped before the first, a sign, saturation at the
 * int64 limits), without reading past `len`.
 * ------------------------------------------------------------------ */

static const char *scan_ll(const char *p, const char *end, long long *val)
{
    const char *s = p;
    while (s < end && (*s == ' ' || (*s >= '\t' && *s <= '\r')))
        s++;
    int neg = 0;
    if (s < end && (*s == '+' || *s == '-')) {
        neg = *s == '-';
        s++;
    }
    if (s >= end || *s < '0' || *s > '9')
        return p; /* no conversion */
    const unsigned long long lim =
        neg ? (unsigned long long)LLONG_MAX + 1ULL : (unsigned long long)LLONG_MAX;
    unsigned long long acc = 0;
    int over = 0;
    for (; s < end && *s >= '0' && *s <= '9'; s++) {
        unsigned d = (unsigned)(*s - '0');
        if (over || acc > (lim - d) / 10)
            over = 1;
        else
            acc = acc * 10 + d;
    }
    if (over)
        *val = neg ? LLONG_MIN : LLONG_MAX;
    else if (neg)
        *val = acc == lim ? LLONG_MIN : -(long long)acc;
    else
        *val = (long long)acc;
    return s;
}

/* Returns the number of edges and sets *out to a malloc'd (E, 2) int64
 * array that the caller releases with fg_free; -1 when memory runs out. */
int64_t fg_parse_edges(const char *data, int64_t len, int one_based,
                       int skip_header, int64_t **out)
{
    const char *p = data;
    const char *end = data + len;
    int64_t cap = 4096, n = 0;
    int64_t *buf = (int64_t *)malloc((size_t)cap * 2 * sizeof(int64_t));
    *out = NULL;
    if (buf == NULL)
        return -1;

    int header_pending = skip_header;
    while (p < end) {
        while (p < end && (*p == '\n' || *p == '\r' || *p == ' '
                           || *p == '\t'))
            p++;
        if (p >= end)
            break;
        if (*p == '#' || *p == '%') { /* comment line */
            while (p < end && *p != '\n')
                p++;
            continue;
        }
        long long a, b;
        const char *q = scan_ll(p, end, &a);
        if (q == p) { /* unparsable line */
            while (p < end && *p != '\n')
                p++;
            continue;
        }
        p = q;
        /* the second field must be on the same line */
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\r'))
            p++;
        if (p >= end || *p == '\n'
            || !(*p == '-' || *p == '+' || (*p >= '0' && *p <= '9'))) {
            while (p < end && *p != '\n')
                p++;
            continue;
        }
        q = scan_ll(p, end, &b);
        if (q == p) {
            while (p < end && *p != '\n')
                p++;
            continue;
        }
        p = q;
        while (p < end && *p != '\n') /* extra columns */
            p++;

        if (header_pending) {
            header_pending = 0;
            continue;
        }
        if (n >= cap) {
            cap *= 2;
            int64_t *grown =
                (int64_t *)realloc(buf, (size_t)cap * 2 * sizeof(int64_t));
            if (grown == NULL) {
                free(buf);
                return -1;
            }
            buf = grown;
        }
        buf[2 * n] = (int64_t)a - one_based;
        buf[2 * n + 1] = (int64_t)b - one_based;
        n++;
    }
    *out = buf;
    return n;
}

/* ------------------------------------------------------------------ *
 * csr_lt: upper-triangle (i < j) edges of a CSR structure, as (E, 2)
 * int32 pairs in row-major order.
 *
 * Rows are split so that each thread owns ~nnz/T entries. The count pass
 * records each range's pair count; the caller sums them, allocates the
 * output, and the fill pass (the same split) writes each range at its
 * offset. Explicit zeros are the caller's to exclude.
 * ------------------------------------------------------------------ */

typedef struct {
    const void *indptr;
    const void *indices;
    int ip64, ix64;
    int64_t n, nnz;
    int64_t row_lo, row_hi;
    int64_t count; /* count pass: pairs in the range */
    int64_t bad;   /* count pass: indices out of range */
    int32_t *out;  /* fill pass: destination of the range */
} lt_range;

static inline int64_t at(const void *p, int is64, int64_t i)
{
    return is64 ? ((const int64_t *)p)[i] : (int64_t)((const int32_t *)p)[i];
}

static void *lt_count_worker(void *arg)
{
    lt_range *r = (lt_range *)arg;
    int64_t c = 0, bad = 0;
    for (int64_t row = r->row_lo; row < r->row_hi; row++) {
        int64_t s = at(r->indptr, r->ip64, row);
        int64_t e = at(r->indptr, r->ip64, row + 1);
        if (s < 0 || e > r->nnz) {
            bad++;
            continue;
        }
        for (int64_t k = s; k < e; k++) {
            int64_t col = at(r->indices, r->ix64, k);
            if (col >= r->n)
                bad++;
            else if (col > row)
                c++;
        }
    }
    r->count = c;
    r->bad = bad;
    return NULL;
}

static void *lt_fill_worker(void *arg)
{
    lt_range *r = (lt_range *)arg;
    int32_t *o = r->out;
    for (int64_t row = r->row_lo; row < r->row_hi; row++) {
        int64_t s = at(r->indptr, r->ip64, row);
        int64_t e = at(r->indptr, r->ip64, row + 1);
        for (int64_t k = s; k < e; k++) {
            int64_t col = at(r->indices, r->ix64, k);
            if (col > row) {
                *o++ = (int32_t)row;
                *o++ = (int32_t)col;
            }
        }
    }
    return NULL;
}

static int lt_split(lt_range *ranges, const void *indptr, const void *indices,
                    int ip64, int ix64, int64_t n, int64_t nnz,
                    int64_t nthreads)
{
    int T = clamp_threads(nthreads);
    int64_t total = at(indptr, ip64, n);
    int64_t row = 0;
    for (int t = 0; t < T; t++) {
        int64_t target = total * (t + 1) / T;
        int64_t hi = row;
        while (hi < n && at(indptr, ip64, hi) < target)
            hi++;
        if (t == T - 1)
            hi = n;
        lt_range *r = &ranges[t];
        r->indptr = indptr;
        r->indices = indices;
        r->ip64 = ip64;
        r->ix64 = ix64;
        r->n = n;
        r->nnz = nnz;
        r->row_lo = row;
        r->row_hi = hi;
        r->count = 0;
        r->bad = 0;
        r->out = NULL;
        row = hi;
    }
    return T;
}

/* indptr has n + 1 entries and indices nnz; counts[t] receives range t's
 * pair count. Returns the number of ranges T, or -1 when an indptr entry
 * lies outside [0, nnz] or a column outside [0, n) is not below its row
 * (no pair was then counted for it). */
int fg_csr_lt_count(const void *indptr, const void *indices, int ip64,
                    int ix64, int64_t n, int64_t nnz, int64_t nthreads,
                    int64_t *counts)
{
    lt_range ranges[FG_MAX_THREADS];
    int T = lt_split(ranges, indptr, indices, ip64, ix64, n, nnz, nthreads);
    run_all(lt_count_worker, ranges, sizeof(lt_range), T);
    int64_t bad = 0;
    for (int t = 0; t < T; t++) {
        counts[t] = ranges[t].count;
        bad += ranges[t].bad;
    }
    return bad ? -1 : T;
}

/* The fill pass over the same split: counts are fg_csr_lt_count's, out
 * holds 2 * sum(counts) int32. */
void fg_csr_lt_fill(const void *indptr, const void *indices, int ip64,
                    int ix64, int64_t n, int64_t nnz, int64_t nthreads,
                    const int64_t *counts, int32_t *out)
{
    lt_range ranges[FG_MAX_THREADS];
    int T = lt_split(ranges, indptr, indices, ip64, ix64, n, nnz, nthreads);
    int64_t off = 0;
    for (int t = 0; t < T; t++) {
        ranges[t].out = out + 2 * off;
        off += counts[t];
    }
    run_all(lt_fill_worker, ranges, sizeof(lt_range), T);
}

/* ------------------------------------------------------------------ *
 * radix_argsort_u64: stable ascending argsort of 64-bit keys, threaded
 * LSD radix over 16-bit digits.
 *
 * Per pass each thread histograms its contiguous chunk, a serial
 * digit-major, thread-minor exclusive scan gives stable scatter bases, and
 * each thread scatters its (key, index) pairs; the pass count follows the
 * largest key (1 for degree keys, 2 for 32-bit ids, 3 for the binned
 * build's pack keys).
 * ------------------------------------------------------------------ */

#define RS_BITS 16
#define RS_RADIX (1 << RS_BITS)
#define RS_MASK (RS_RADIX - 1)

typedef struct {
    const uint64_t *keys_in;
    uint64_t *keys_out;
    const int32_t *idx_in;
    int32_t *idx_out;
    int64_t lo, hi;
    int shift;
    int64_t *hist; /* RS_RADIX entries of this thread */
    uint64_t maxk;
} rs_range;

static void *rs_max_worker(void *arg)
{
    rs_range *r = (rs_range *)arg;
    uint64_t m = 0;
    for (int64_t i = r->lo; i < r->hi; i++)
        if (r->keys_in[i] > m)
            m = r->keys_in[i];
    r->maxk = m;
    return NULL;
}

static void *rs_hist_worker(void *arg)
{
    rs_range *r = (rs_range *)arg;
    memset(r->hist, 0, RS_RADIX * sizeof(int64_t));
    for (int64_t i = r->lo; i < r->hi; i++)
        r->hist[(r->keys_in[i] >> r->shift) & RS_MASK]++;
    return NULL;
}

static void *rs_scatter_worker(void *arg)
{
    rs_range *r = (rs_range *)arg;
    for (int64_t i = r->lo; i < r->hi; i++) {
        uint64_t k = r->keys_in[i];
        int64_t pos = r->hist[(k >> r->shift) & RS_MASK]++;
        r->keys_out[pos] = k;
        r->idx_out[pos] = r->idx_in ? r->idx_in[i] : (int32_t)i;
    }
    return NULL;
}

/* out: E int32 positions. Returns 0, or -1 when memory runs out. */
int fg_radix_argsort_u64(const uint64_t *keys, int64_t E, int64_t nthreads,
                         int32_t *out)
{
    if (E == 0)
        return 0;
    int T = elem_threads(nthreads, E);
    uint64_t *k0 = (uint64_t *)malloc((size_t)E * sizeof(uint64_t));
    uint64_t *k1 = (uint64_t *)malloc((size_t)E * sizeof(uint64_t));
    int32_t *i0 = (int32_t *)malloc((size_t)E * sizeof(int32_t));
    int32_t *i1 = (int32_t *)malloc((size_t)E * sizeof(int32_t));
    int64_t *hists = (int64_t *)malloc((size_t)T * RS_RADIX * sizeof(int64_t));
    if (!k0 || !k1 || !i0 || !i1 || !hists) {
        free(k0);
        free(k1);
        free(i0);
        free(i1);
        free(hists);
        return -1;
    }
    rs_range ranges[FG_MAX_THREADS];
    for (int t = 0; t < T; t++) {
        ranges[t].keys_in = keys;
        ranges[t].lo = E * t / T;
        ranges[t].hi = E * (t + 1) / T;
        ranges[t].hist = hists + (int64_t)t * RS_RADIX;
    }
    run_all(rs_max_worker, ranges, sizeof(rs_range), T);
    uint64_t maxk = 0;
    for (int t = 0; t < T; t++)
        if (ranges[t].maxk > maxk)
            maxk = ranges[t].maxk;
    int passes = 1;
    while (passes < 4 && (maxk >> ((uint64_t)passes * RS_BITS)))
        passes++;

    /* the first pass reads the caller's keys and the identity indices */
    const uint64_t *kc = keys;
    const int32_t *ic = NULL;
    uint64_t *kn = k0;
    int32_t *in_ = i0;
    for (int p = 0; p < passes; p++) {
        for (int t = 0; t < T; t++) {
            ranges[t].keys_in = kc;
            ranges[t].keys_out = kn;
            ranges[t].idx_in = ic;
            ranges[t].idx_out = in_;
            ranges[t].shift = p * RS_BITS;
        }
        run_all(rs_hist_worker, ranges, sizeof(rs_range), T);
        int64_t run = 0;
        for (int d = 0; d < RS_RADIX; d++) {
            for (int t = 0; t < T; t++) {
                int64_t c = hists[(int64_t)t * RS_RADIX + d];
                hists[(int64_t)t * RS_RADIX + d] = run;
                run += c;
            }
        }
        run_all(rs_scatter_worker, ranges, sizeof(rs_range), T);
        kc = kn;
        ic = in_;
        kn = kn == k0 ? k1 : k0;
        in_ = in_ == i0 ? i1 : i0;
    }
    memcpy(out, ic, (size_t)E * sizeof(int32_t));
    free(k0);
    free(k1);
    free(i0);
    free(i1);
    free(hists);
    return 0;
}

/* ------------------------------------------------------------------ *
 * The binned table build's element-wise passes. Each write index is
 * unique, so contiguous chunks run in parallel.
 * ------------------------------------------------------------------ */

typedef struct {
    const int32_t *a;   /* apply_perm_minmax: edges (E, 2); else perm/order */
    const int32_t *b;   /* inv (n,); e_lo; keys */
    const int32_t *c;   /* e_hi; starts */
    int32_t *o1, *o2;
    int64_t nb, nc;     /* lengths of the indexed arrays */
    int64_t lo, hi;
    int64_t bad;
} el_range;

/* e_lo, e_hi = min, max of inv[edges[:, 0]], inv[edges[:, 1]] */
static void *pm_worker(void *arg)
{
    el_range *r = (el_range *)arg;
    int64_t bad = 0;
    for (int64_t i = r->lo; i < r->hi; i++) {
        int32_t u = r->a[2 * i], v = r->a[2 * i + 1];
        if (u < 0 || u >= r->nb || v < 0 || v >= r->nb) {
            bad++;
            continue;
        }
        int32_t x = r->b[u], y = r->b[v];
        r->o1[i] = x < y ? x : y;
        r->o2[i] = x < y ? y : x;
    }
    r->bad = bad;
    return NULL;
}

/* pairs[i] = (e_lo[order[i]], e_hi[order[i]]); invp[order[i]] = i */
static void *pp_worker(void *arg)
{
    el_range *r = (el_range *)arg;
    int64_t bad = 0;
    for (int64_t i = r->lo; i < r->hi; i++) {
        int32_t p = r->a[i];
        if (p < 0 || p >= r->nb) {
            bad++;
            continue;
        }
        r->o1[2 * i] = r->b[p];
        r->o1[2 * i + 1] = r->c[p];
        r->o2[p] = (int32_t)i;
    }
    r->bad = bad;
    return NULL;
}

/* out[perm[i]] = i - starts[keys[perm[i]]] */
static void *sr_worker(void *arg)
{
    el_range *r = (el_range *)arg;
    int64_t bad = 0;
    for (int64_t i = r->lo; i < r->hi; i++) {
        int32_t p = r->a[i];
        if (p < 0 || p >= r->nb) {
            bad++;
            continue;
        }
        int32_t k = r->b[p];
        if (k < 0 || k >= r->nc) {
            bad++;
            continue;
        }
        r->o1[p] = (int32_t)i - r->c[k];
    }
    r->bad = bad;
    return NULL;
}

static int64_t run_elementwise(fg_worker fn, el_range proto, int64_t E,
                               int64_t nthreads)
{
    el_range ranges[FG_MAX_THREADS];
    int T = elem_threads(nthreads, E);
    for (int t = 0; t < T; t++) {
        ranges[t] = proto;
        ranges[t].lo = E * t / T;
        ranges[t].hi = E * (t + 1) / T;
        ranges[t].bad = 0;
    }
    run_all(fn, ranges, sizeof(el_range), T);
    int64_t bad = 0;
    for (int t = 0; t < T; t++)
        bad += ranges[t].bad;
    return bad;
}

/* edges (E, 2), inv (n,) -> e_lo, e_hi (E,); returns the ids out of
 * [0, n) */
int64_t fg_apply_perm_minmax(const int32_t *edges, int64_t E,
                             const int32_t *inv, int64_t n, int64_t nthreads,
                             int32_t *e_lo, int32_t *e_hi)
{
    el_range proto = {edges, inv, NULL, e_lo, e_hi, n, 0, 0, 0, 0};
    return run_elementwise(pm_worker, proto, E, nthreads);
}

/* e_lo, e_hi, order (E,) -> pairs (E, 2), invp (E,); returns the order
 * entries out of [0, E) */
int64_t fg_permute_pairs(const int32_t *e_lo, const int32_t *e_hi,
                         const int32_t *order, int64_t E, int64_t nthreads,
                         int32_t *pairs, int32_t *invp)
{
    el_range proto = {order, e_lo, e_hi, pairs, invp, E, 0, 0, 0, 0};
    return run_elementwise(pp_worker, proto, E, nthreads);
}

/* perm, keys (E,), starts (n_starts,) -> out (E,); returns the perm
 * entries out of [0, E) plus the keys out of [0, n_starts) */
int64_t fg_scatter_ranks(const int32_t *perm, const int32_t *keys,
                         int64_t E, const int32_t *starts, int64_t n_starts,
                         int64_t nthreads, int32_t *out)
{
    el_range proto = {perm, keys, starts, out, NULL, E, n_starts, 0, 0, 0};
    return run_elementwise(sr_worker, proto, E, nthreads);
}
