// The support-vector section of a LIBSVM model file, parsed natively.
//
// The model file's header is a dozen lines and stays in Python
// (io/model.py); its support-vector lines, one per support vector with an
// alpha and up to num_features "index:value" tokens, are the bulk of the
// file (8.4 M tokens at 32768 x 256).  This entry point takes the file's
// bytes, the offset just after the "SV" line and the number of support
// vectors, and returns the CSR arrays and the alphas that
// io/libsvm.parse_libsvm_content would build from the same lines, bit for
// bit:
//
//   - lines are split on '\n'; leading whitespace is stripped and blank
//     lines and lines whose first character is '#' are skipped, as
//     io/file_reader.read_lines keeps them;
//   - tokens are split on whitespace; a first token without ':' is the
//     alpha; a later token without ':' ends the line's data;
//   - numbers take a strict decimal grammar, parsed by std::from_chars,
//     which rounds correctly, as Python's float() does.
//
// Anything outside that ground -- a byte outside ASCII at the start of a
// kept line or in a token before its data ends, a number that Python reads
// and the grammar does not ("1_0", "inf", a value
// that overflows or is subnormal), an index that is not plain digits
// ("+1", "0_1"), too few lines, a section without a single pair -- returns
// 1, and the caller parses the section in Python, which gives the same
// result or raises the same error.  So this file decides no error message.
//
// Lines are parsed on std::thread workers, each over a contiguous range,
// and their outputs concatenated in line order.

#include <algorithm>
#include <charconv>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Python's str.isspace() on ASCII (what str.split() and str.lstrip() use)
inline bool is_space(unsigned char c) {
    return c == ' ' || (c >= '\t' && c <= '\r') || (c >= 0x1c && c <= 0x1f);
}

inline bool is_digit(char c) { return c >= '0' && c <= '9'; }

// A decimal number: [+-]? then only digits, '.', 'e', 'E', '+', '-', read
// whole by std::from_chars.  On that alphabet from_chars and Python's
// float() accept the same strings ("inf", "nan", "1_0" and hex fall
// outside it) and both round correctly; a leading '+' (which from_chars
// does not take) is skipped unless a sign follows it.
bool strict_real(const char* p, const char* end, double* out) {
    if (p < end && *p == '+') {
        ++p;
        if (p < end && (*p == '+' || *p == '-')) return false;
    }
    for (const char* q = p; q < end; ++q) {
        char c = *q;
        if (!is_digit(c) && c != '.' && c != 'e' && c != 'E' && c != '+' && c != '-') return false;
    }
    double v = 0.0;
    auto [ptr, ec] = std::from_chars(p, end, v, std::chars_format::general);
    if (ec != std::errc() || ptr != end) return false;  // malformed, overflow, underflow
    *out = v;
    return true;
}

bool strict_index(const char* p, const char* end, int64_t* out) {
    if (p == end || end - p > 18) return false;
    int64_t v = 0;
    for (const char* q = p; q < end; ++q) {
        if (!is_digit(*q)) return false;
        v = v * 10 + (*q - '0');
    }
    *out = v;
    return true;
}

struct Line {
    const char* begin;
    const char* end;
};

struct Part {
    std::vector<int64_t> row_nnz;
    std::vector<int64_t> cols;
    std::vector<double> vals;
    std::vector<double> alphas;
    int64_t max_index = -1;
    bool ok = true;
};

void parse_range(const std::vector<Line>& lines, size_t lo, size_t hi, Part* out) {
    out->row_nnz.reserve(hi - lo);
    out->alphas.reserve(hi - lo);
    if (lo < hi) {  // at most one pair per ':' of the range: no regrowth
        size_t colons = static_cast<size_t>(std::count(lines[lo].begin, lines[hi - 1].end, ':'));
        out->cols.reserve(colons);
        out->vals.reserve(colons);
    }
    for (size_t li = lo; li < hi && out->ok; ++li) {
        const char* p = lines[li].begin;
        const char* end = lines[li].end;
        int64_t nnz = 0;
        double alpha = 0.0;
        bool first = true;
        while (true) {
            while (p < end && is_space(static_cast<unsigned char>(*p))) ++p;
            if (p == end) break;
            const char* tok = p;
            const char* colon = nullptr;
            unsigned char high = 0;  // any byte outside ASCII
            while (p < end && !is_space(static_cast<unsigned char>(*p))) {
                high |= static_cast<unsigned char>(*p) & 0x80;
                if (*p == ':' && colon == nullptr) colon = p;
                ++p;
            }
            if (high) { out->ok = false; return; }  // Python may split it at a Unicode space
            if (colon == nullptr) {
                if (!first) break;  // the first token without ':' ends the data
                if (!strict_real(tok, p, &alpha)) { out->ok = false; return; }
                first = false;
                continue;
            }
            first = false;
            int64_t idx = 0;
            double val = 0.0;
            if (!strict_index(tok, colon, &idx) || !strict_real(colon + 1, p, &val)) {
                out->ok = false;
                return;
            }
            out->cols.push_back(idx);
            out->vals.push_back(val);
            out->max_index = std::max(out->max_index, idx);
            ++nnz;
        }
        out->row_nnz.push_back(nnz);
        out->alphas.push_back(alpha);
    }
}

template <typename T>
T* copy_out(const std::vector<Part>& parts, std::vector<T> Part::*field, int64_t total) {
    size_t count = static_cast<size_t>(std::max<int64_t>(total, 1));
    T* out = static_cast<T*>(std::malloc(sizeof(T) * count));
    if (out == nullptr) return nullptr;
    int64_t at = 0;
    for (const Part& part : parts) {
        const std::vector<T>& v = part.*field;
        if (!v.empty()) std::memcpy(out + at, v.data(), sizeof(T) * v.size());
        at += static_cast<int64_t>(v.size());
    }
    return out;
}

}  // namespace

extern "C" {

// Parse the `count` support-vector lines of `buf[offset:len]`.  On 0 the
// caller owns (and frees with plssvm_torch_sv_free) `indptr` (count + 1),
// `indices` and `values` (`nnz` each) and `alphas` (count); `max_index` is
// the largest feature index.  1: parse this section in Python instead.
// -1: out of memory.
int plssvm_torch_parse_sv(const char* buf, int64_t len, int64_t offset, int64_t count,
                          int64_t** indptr, int64_t** indices, double** values, double** alphas,
                          int64_t* nnz, int64_t* max_index) {
    if (offset < 0 || offset > len || count <= 0) return 1;
    std::vector<Line> lines;
    lines.reserve(static_cast<size_t>(count));
    const char* p = buf + offset;
    const char* end = buf + len;
    while (p < end && static_cast<int64_t>(lines.size()) < count) {
        const char* nl = static_cast<const char*>(std::memchr(p, '\n', end - p));
        const char* lend = nl ? nl : end;
        const char* q = p;
        while (q < lend && is_space(static_cast<unsigned char>(*q))) ++q;
        if (q < lend) {
            if (static_cast<unsigned char>(*q) >= 0x80) return 1;  // Unicode space, or not
            if (*q != '#') lines.push_back({q, lend});
        }
        p = nl ? nl + 1 : end;
    }
    if (static_cast<int64_t>(lines.size()) < count) return 1;

    unsigned hw = std::thread::hardware_concurrency();
    size_t n = lines.size();
    size_t workers = std::max<size_t>(1, std::min<size_t>(hw ? hw : 1, n / 256 + 1));
    std::vector<Part> parts(workers);
    {
        std::vector<std::thread> threads;
        for (size_t w = 0; w < workers; ++w) {
            size_t lo = n * w / workers, hi = n * (w + 1) / workers;
            threads.emplace_back(parse_range, std::cref(lines), lo, hi, &parts[w]);
        }
        for (auto& t : threads) t.join();
    }
    int64_t total = 0, top = -1;
    for (const Part& part : parts) {
        if (!part.ok) return 1;
        total += static_cast<int64_t>(part.cols.size());
        top = std::max(top, part.max_index);
    }
    if (top < 0) return 1;

    int64_t* ip = static_cast<int64_t*>(std::malloc(sizeof(int64_t) * (n + 1)));
    int64_t* cols = copy_out(parts, &Part::cols, total);
    double* vals = copy_out(parts, &Part::vals, total);
    double* al = copy_out(parts, &Part::alphas, static_cast<int64_t>(n));
    if (ip == nullptr || cols == nullptr || vals == nullptr || al == nullptr) {
        std::free(ip);
        std::free(cols);
        std::free(vals);
        std::free(al);
        return -1;
    }
    ip[0] = 0;
    size_t row = 0;
    for (const Part& part : parts) {
        for (int64_t k : part.row_nnz) {
            ip[row + 1] = ip[row] + k;
            ++row;
        }
    }
    *indptr = ip;
    *indices = cols;
    *values = vals;
    *alphas = al;
    *nnz = total;
    *max_index = top;
    return 0;
}

void plssvm_torch_sv_free(void* p) { std::free(p); }

}  // extern "C"
