// Text sections of the model files, formatted and parsed natively.
//
// The writer lays out each float32 value, widened to double, as Python's
// repr() does: the shortest digits that read back as the same double
// (std::to_chars), in fixed notation for decimal exponents in [-4, 16)
// (with ".0" after an integral value) and as d.ddde+XX otherwise; "inf",
// "-inf", "nan". A section is a vector (one value a line), a dense matrix
// ("i j value" lines in row-major order) or a sparse one ("i j value" for
// given ids), formatted in ranges of values on threads and joined in
// order. The parser reads n such lines back (ids as int64, values as
// double, which the caller rounds to float32, as float() and numpy do).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread model_text.cpp

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// Python's repr of the double d into out; returns the length.
int repr_double(double d, char* out) {
    if (std::isnan(d)) {
        std::memcpy(out, "nan", 3);
        return 3;
    }
    if (std::isinf(d)) {
        if (d < 0) {
            std::memcpy(out, "-inf", 4);
            return 4;
        }
        std::memcpy(out, "inf", 3);
        return 3;
    }
    char sci[64];
    auto res = std::to_chars(sci, sci + sizeof(sci), d,
                             std::chars_format::scientific);
    const char* p = sci;
    const char* end = res.ptr;
    int n = 0;
    if (*p == '-') {
        out[n++] = '-';
        ++p;
    }
    char digits[32];
    int nd = 0;
    while (p < end && *p != 'e') {
        if (*p != '.') digits[nd++] = *p;
        ++p;
    }
    int e = 0;
    if (p < end) std::from_chars(p + 1 + (p[1] == '+'), end, e);
    int decpt = e + 1;
    if (decpt <= -4 || decpt > 16) {
        out[n++] = digits[0];
        if (nd > 1) {
            out[n++] = '.';
            std::memcpy(out + n, digits + 1, nd - 1);
            n += nd - 1;
        }
        out[n++] = 'e';
        out[n++] = e < 0 ? '-' : '+';
        int a = e < 0 ? -e : e;
        if (a < 10) out[n++] = '0';
        auto r = std::to_chars(out + n, out + n + 8, a);
        n = static_cast<int>(r.ptr - out);
    } else if (decpt <= 0) {
        out[n++] = '0';
        out[n++] = '.';
        for (int k = 0; k < -decpt; ++k) out[n++] = '0';
        std::memcpy(out + n, digits, nd);
        n += nd;
    } else if (decpt >= nd) {
        std::memcpy(out + n, digits, nd);
        n += nd;
        for (int k = nd; k < decpt; ++k) out[n++] = '0';
        out[n++] = '.';
        out[n++] = '0';
    } else {
        std::memcpy(out + n, digits, decpt);
        n += decpt;
        out[n++] = '.';
        std::memcpy(out + n, digits + decpt, nd - decpt);
        n += nd - decpt;
    }
    return n;
}

void format_range(const float* vals, int64_t lo, int64_t hi, int64_t cols,
                  const int64_t* ii, const int64_t* jj, std::string* out) {
    char line[96];
    out->reserve(static_cast<size_t>(hi - lo) * (cols || ii ? 32 : 24));
    for (int64_t k = lo; k < hi; ++k) {
        int n = 0;
        if (ii != nullptr || cols > 0) {
            int64_t i = ii ? ii[k] : k / cols;
            int64_t j = ii ? jj[k] : k % cols;
            n = static_cast<int>(std::to_chars(line, line + 24, i).ptr - line);
            line[n++] = ' ';
            n = static_cast<int>(
                std::to_chars(line + n, line + n + 24, j).ptr - line);
            line[n++] = ' ';
        }
        n += repr_double(static_cast<double>(vals[k]), line + n);
        line[n++] = '\n';
        out->append(line, n);
    }
}

const char* skip_blanks(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    return p;
}

}  // namespace

extern "C" {

// n values formatted into a malloc'd buffer (*out; free with
// mml_text_free): vector lines when cols == 0 and ii is null, dense
// matrix lines (i = k / cols, j = k % cols) when cols > 0, sparse lines
// (ii[k], jj[k]) when ii is given. Returns the length.
int64_t mml_format_values(const float* vals, int64_t n, int64_t cols,
                          const int64_t* ii, const int64_t* jj, int threads,
                          char** out) {
    if (threads < 1) threads = 1;
    if (n < (int64_t(1) << 16)) threads = 1;
    std::vector<std::string> parts(threads);
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t) {
        int64_t lo = n * t / threads, hi = n * (t + 1) / threads;
        if (threads == 1) {
            format_range(vals, lo, hi, cols, ii, jj, &parts[t]);
        } else {
            pool.emplace_back(format_range, vals, lo, hi, cols, ii, jj,
                              &parts[t]);
        }
    }
    for (auto& th : pool) th.join();
    size_t total = 0;
    for (auto& s : parts) total += s.size();
    char* buf = static_cast<char*>(std::malloc(total ? total : 1));
    if (buf == nullptr) return -1;
    size_t at = 0;
    for (auto& s : parts) {
        std::memcpy(buf + at, s.data(), s.size());
        at += s.size();
    }
    *out = buf;
    return static_cast<int64_t>(total);
}

void mml_text_free(void* p) { std::free(p); }

// Parse n lines of buf[0, len): each "value" (fields == 1) or "i j value"
// (fields == 3) between optional blanks. Returns the bytes consumed
// through the n-th line's newline (or the buffer's end), or -1 when a
// line does not parse or the buffer ends first.
int64_t mml_parse_values(const char* buf, int64_t len, int64_t n, int fields,
                         int64_t* ii, int64_t* jj, double* vals) {
    const char* p = buf;
    const char* end = buf + len;
    for (int64_t k = 0; k < n; ++k) {
        if (fields == 3) {
            p = skip_blanks(p, end);
            auto r = std::from_chars(p, end, ii[k]);
            if (r.ec != std::errc()) return -1;
            p = skip_blanks(r.ptr, end);
            r = std::from_chars(p, end, jj[k]);
            if (r.ec != std::errc()) return -1;
            p = r.ptr;
        }
        p = skip_blanks(p, end);
        const char* q = p + (p < end && *p == '+');
        auto r = std::from_chars(q, end, vals[k]);
        if (r.ec != std::errc()) {
            // from_chars rejects what float() reads as out of range:
            // overflow reads as inf, underflow as signed zero
            if (r.ec != std::errc::result_out_of_range) return -1;
            char* stop = nullptr;
            std::string tok(q, r.ptr);
            vals[k] = std::strtod(tok.c_str(), &stop);
        }
        p = skip_blanks(r.ptr, end);
        if (p < end && *p != '\n') return -1;
        if (p < end) ++p;        // the file's last line may lack one
    }
    return static_cast<int64_t>(p - buf);
}

}  // extern "C"
