// Fast rating/feedback file parser.
//
// Native counterpart of the hot path in the reference's IO layer
// (IO/RatingData.cs, IO/ItemData.cs: per-line Split + float.Parse).
// The Python reader is line-by-line; for 100M-rating production files
// this mmap single-pass parser is ~50x faster. Exposed through ctypes
// (no pybind11 in this environment).
//
// Format: one interaction per line, columns split on tab/space/comma
// (reference IO/Constants.SPLIT_CHARS), numeric user id, numeric item
// id, optional float rating, optional integer unix timestamp.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 fast_parser.cpp -o libfastparser.so

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct ParseResult {
    int32_t* users = nullptr;
    int32_t* items = nullptr;
    float* values = nullptr;
    int64_t* times = nullptr;
    int64_t count = 0;
    int64_t capacity = 0;
};

inline bool is_sep(char c) { return c == '\t' || c == ' ' || c == ','; }

inline const char* skip_seps(const char* p, const char* end) {
    while (p < end && is_sep(*p)) ++p;
    return p;
}

inline const char* parse_i64(const char* p, const char* end, int64_t* out) {
    bool neg = false;
    if (p < end && (*p == '-' || *p == '+')) { neg = (*p == '-'); ++p; }
    int64_t v = 0;
    const char* start = p;
    while (p < end && *p >= '0' && *p <= '9') { v = v * 10 + (*p - '0'); ++p; }
    if (p == start) return nullptr;
    *out = neg ? -v : v;
    return p;
}

inline const char* parse_f32(const char* p, const char* end, float* out) {
    // fast path for the common d[.d*] ratings; falls back to strtod
    bool neg = false;
    if (p < end && (*p == '-' || *p == '+')) { neg = (*p == '-'); ++p; }
    double v = 0;
    const char* start = p;
    while (p < end && *p >= '0' && *p <= '9') { v = v * 10 + (*p - '0'); ++p; }
    if (p < end && *p == '.') {
        ++p;
        double scale = 0.1;
        while (p < end && *p >= '0' && *p <= '9') {
            v += (*p - '0') * scale;
            scale *= 0.1;
            ++p;
        }
    }
    if (p < end && (*p == 'e' || *p == 'E')) {  // rare: scientific notation
        char* e2;
        v = strtod(start - (neg ? 1 : 0), &e2);
        *out = (float)v;
        return e2;
    }
    if (p == start) return nullptr;
    *out = (float)(neg ? -v : v);
    return p;
}

bool grow(ParseResult* r, bool with_values, bool with_times) {
    int64_t cap = r->capacity ? r->capacity * 2 : (int64_t)1 << 20;
    auto* u = (int32_t*)realloc(r->users, cap * sizeof(int32_t));
    auto* i = (int32_t*)realloc(r->items, cap * sizeof(int32_t));
    if (!u || !i) return false;
    r->users = u;
    r->items = i;
    if (with_values) {
        auto* v = (float*)realloc(r->values, cap * sizeof(float));
        if (!v) return false;
        r->values = v;
    }
    if (with_times) {
        auto* t = (int64_t*)realloc(r->times, cap * sizeof(int64_t));
        if (!t) return false;
        r->times = t;
    }
    r->capacity = cap;
    return true;
}

}  // namespace

extern "C" {

// Returns the number of parsed rows, or -1 on error.
// min_columns: 2 = (user, item); 3 = + rating; 4 = + timestamp.
// skip_first_line: ignore a header line.
// Output pointers must be released with mml_free.
int64_t mml_parse(const char* path, int min_columns, int skip_first_line,
                  int32_t** out_users, int32_t** out_items,
                  float** out_values, int64_t** out_times) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return -1;
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size == 0) {
        close(fd);
        if (st.st_size == 0) {
            *out_users = nullptr; *out_items = nullptr;
            if (out_values) *out_values = nullptr;
            if (out_times) *out_times = nullptr;
            return 0;
        }
        return -1;
    }
    const char* data = (const char*)mmap(nullptr, st.st_size, PROT_READ,
                                         MAP_PRIVATE, fd, 0);
    close(fd);
    if (data == MAP_FAILED) return -1;
    const char* p = data;
    const char* end = data + st.st_size;

    const bool with_values = min_columns >= 3;
    const bool with_times = min_columns >= 4;
    ParseResult r;

    if (skip_first_line) {
        while (p < end && *p != '\n') ++p;
        if (p < end) ++p;
    }

    bool ok = true;
    while (p < end) {
        // skip empty lines / leading whitespace
        while (p < end && (*p == '\n' || *p == '\r')) ++p;
        if (p >= end) break;
        const char* line_start = p;

        int64_t u, i;
        p = skip_seps(p, end);
        p = parse_i64(p, end, &u);
        if (!p) { ok = false; break; }
        p = skip_seps(p, end);
        p = parse_i64(p, end, &i);
        if (!p) { ok = false; break; }
        float v = 0.0f;
        int64_t t = 0;
        if (with_values) {
            p = skip_seps(p, end);
            p = parse_f32(p, end, &v);
            if (!p) { ok = false; break; }
        }
        if (with_times) {
            p = skip_seps(p, end);
            p = parse_i64(p, end, &t);
            if (!p) { ok = false; break; }
        }
        // advance to next line
        while (p < end && *p != '\n') ++p;
        if (p < end) ++p;
        (void)line_start;

        if (r.count == r.capacity && !grow(&r, with_values, with_times)) {
            ok = false;
            break;
        }
        r.users[r.count] = (int32_t)u;
        r.items[r.count] = (int32_t)i;
        if (with_values) r.values[r.count] = v;
        if (with_times) r.times[r.count] = t;
        ++r.count;
    }
    munmap((void*)data, st.st_size);

    if (!ok) {
        free(r.users);
        free(r.items);
        free(r.values);
        free(r.times);
        return -1;
    }
    *out_users = r.users;
    *out_items = r.items;
    if (out_values) *out_values = r.values;
    if (out_times) *out_times = r.times;
    return r.count;
}

void mml_free(void* ptr) { free(ptr); }

// ---------------------------------------------------------------------------
// MXU-plan bucketizer (native counterpart of the numpy middle of
// ops/pallas_sgd.py prepare_mxu_data — the measured ~35s host share of
// "mxu prep" at the Netflix shape, dominated by a 20M-element stable
// argsort + int64 bucket math + fancy-indexed gathers; these two
// single-pass counting-sort passes replace all of it).
//
// Pass 1 (mml_bucket_count): per-(user_block x item_block) bucket event
// counts, threaded with per-thread local histograms.
// Pass 2 (mml_bucket_fill_packed): scatter each event directly into the
// kernel's packed [nc, 4, chunk] int32 layout (u_loc, i_loc,
// bitcast(value), bitcast(weight=1)) at its bucket's running cursor —
// the padded offsets come from numpy (tiny [nbkt] prefix sums).
// ``perm`` optionally applies the epoch-0 shuffle during the pass
// (NULL = identity), so no shuffled copies of the event arrays exist.
// ---------------------------------------------------------------------------

}  // extern "C"

#include <thread>
#include <vector>

extern "C" {

void mml_count_items(const int32_t* items, int64_t n, int64_t size,
                     int64_t* out) {
    unsigned hw = std::thread::hardware_concurrency();
    int T = (int)(hw ? (hw < 8 ? hw : 8) : 1);
    if (n < (int64_t)1 << 20) T = 1;
    std::vector<std::vector<int64_t>> local(T);
    std::vector<std::thread> threads;
    for (int t = 0; t < T; ++t) {
        threads.emplace_back([&, t]() {
            auto& cnt = local[t];
            cnt.assign(size, 0);
            int64_t lo = n * t / T, hi = n * (t + 1) / T;
            for (int64_t k = lo; k < hi; ++k) ++cnt[items[k]];
        });
    }
    for (auto& th : threads) th.join();
    for (int64_t i = 0; i < size; ++i) {
        int64_t s = 0;
        for (int t = 0; t < T; ++t) s += local[t][i];
        out[i] = s;
    }
}

void mml_bucket_count(const int32_t* users, const int32_t* items,
                      const int64_t* perm, int64_t n,
                      const int32_t* new_of_old,
                      int32_t UB, int32_t IB, int32_t n_ib,
                      int64_t nbkt, int64_t* bcount) {
    unsigned hw = std::thread::hardware_concurrency();
    int T = (int)(hw ? (hw < 8 ? hw : 8) : 1);
    if (n < (int64_t)1 << 20) T = 1;
    std::vector<std::vector<int64_t>> local(T);
    std::vector<std::thread> threads;
    for (int t = 0; t < T; ++t) {
        threads.emplace_back([&, t]() {
            auto& cnt = local[t];
            cnt.assign(nbkt, 0);
            int64_t lo = n * t / T, hi = n * (t + 1) / T;
            for (int64_t k = lo; k < hi; ++k) {
                int64_t e = perm ? perm[k] : k;
                int64_t b = (int64_t)(users[e] / UB) * n_ib
                            + new_of_old[items[e]] / IB;
                ++cnt[b];
            }
        });
    }
    for (auto& th : threads) th.join();
    for (int64_t b = 0; b < nbkt; ++b) {
        int64_t s = 0;
        for (int t = 0; t < T; ++t) s += local[t][b];
        bcount[b] = s;
    }
}

void mml_bucket_fill_packed(const int32_t* users, const int32_t* items,
                            const float* values, const int64_t* perm,
                            int64_t n, const int32_t* new_of_old,
                            int32_t UB, int32_t IB, int32_t n_ib,
                            int64_t* cursor /* [nbkt], poff copy, mutated */,
                            int32_t chunk, int32_t* packed) {
    const float one = 1.0f;
    int32_t one_bits;
    memcpy(&one_bits, &one, 4);
    int64_t C = chunk;
    for (int64_t k = 0; k < n; ++k) {
        int64_t e = perm ? perm[k] : k;
        int32_t i_new = new_of_old[items[e]];
        int64_t b = (int64_t)(users[e] / UB) * n_ib + i_new / IB;
        int64_t g = cursor[b]++;
        int64_t base = (g / C) * 4 * C + (g % C);
        packed[base] = users[e] % UB;
        packed[base + C] = i_new % IB;
        memcpy(&packed[base + 2 * C], &values[e], 4);
        packed[base + 3 * C] = one_bits;
    }
}

// CSR order (data/arrays.py build_csr): the event indices sorted by
// (primary, secondary), ties in index order, as np.lexsort((secondary,
// primary)) gives them, by a stable two-pass counting sort: pass 1
// orders the events by the secondary key into ``tmp``, pass 2 stably by
// the primary key into ``order``. ``indptr`` [num_primary + 1] comes in
// zeroed and goes out as the primary keys' offsets. Every key lies in
// [0, num_primary) and [0, num_secondary) (the caller checks).
void mml_csr_order(const int32_t* primary, const int32_t* secondary,
                   int64_t n, int64_t num_primary, int64_t num_secondary,
                   int32_t* tmp, int64_t* indptr, int32_t* order) {
    std::vector<int64_t> pos(num_secondary + 1, 0);
    for (int64_t k = 0; k < n; ++k) ++pos[secondary[k] + 1];
    for (int64_t s = 0; s < num_secondary; ++s) pos[s + 1] += pos[s];
    for (int64_t k = 0; k < n; ++k) tmp[pos[secondary[k]]++] = (int32_t)k;
    for (int64_t k = 0; k < n; ++k) ++indptr[primary[k] + 1];
    for (int64_t p = 0; p < num_primary; ++p) indptr[p + 1] += indptr[p];
    std::vector<int64_t> cursor(indptr, indptr + num_primary);
    for (int64_t k = 0; k < n; ++k) {
        int32_t e = tmp[k];
        order[cursor[primary[e]]++] = e;
    }
}

}  // extern "C"
