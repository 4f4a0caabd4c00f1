// mccodec: native codec for the Monte-Carlo cache tensor format.
//
// The framework's disk interchange format (inherited from the reference,
// mcsim.py:457-459) stores fidelity-distribution tensors as JSON nested
// lists: a .mc file for the paper workload holds 1.1e7 floats (~200 MB of
// text).  This codec replaces CPython's json for those tensor bodies:
// from_chars/to_chars (locale-free, shortest round-trip) instead of
// PyFloat boxing — measured at paper scale ~6x stdlib decode and ~2x
// stdlib encode (tests/test_native_io.py pins that the native path
// actually engages; the binary .mcb sidecar remains the fastest reload
// and this parser is the fast path for sidecar-less files, e.g. the
// reference's shipped caches).  It is the framework's native data-loader:
// the compute path is JAX/XLA, the cache IO path is C++.
//
// Exposed C ABI (consumed via ctypes from
// code_robchar_tpu/utils/native_io.py):
//
//   int rc_decode_array(const char* text, long long* shape /*cap 8*/,
//                       int* ndim, double** data, long long* count);
//       Parse one rectangular JSON nested array of numbers.  Allocates
//       *data with malloc (caller frees via rc_free).  Accepts NaN /
//       Infinity tokens (Python's json emits them).  Returns 0 on
//       success, negative error codes otherwise.
//
//   int rc_encode_array(const double* data, const long long* shape,
//                       int ndim, char** out, long long* len);
//       Render the flat buffer as JSON nested lists using shortest
//       round-trip formatting (std::to_chars), bit-exact on re-parse.
//
//   void rc_free(void* p);
//
// Build: g++ -O3 -shared -fPIC -o libmccodec.so mccodec.cpp
// (auto-built on first use by native_io.py).

#include <charconv>
#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <cmath>
#include <vector>

namespace {

struct Parser {
    const char* p;
    const char* end;

    void skip_ws() {
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' ||
                           *p == '\r' || *p == ','))
            ++p;
    }
};

// Recursively parse a nested array.  shape[d] records the length of the
// first list seen at depth d (slots are depth-indexed; children complete
// before their parent, so a parent's slot is pre-created with a -1
// sentinel by the first grandchild's resize and filled on the parent's
// own completion).  Every later list at the same depth must match —
// rectangularity — and scalars may appear at exactly one depth
// (leaf_depth), so mixed-rank nests are rejected rather than silently
// flattened.
int parse_array(Parser& ps, std::vector<double>& out,
                std::vector<long long>& shape, int depth,
                int& leaf_depth) {
    // ndim is capped at 8 by the ABI; guard at entry so a hostile /
    // corrupted deep nest returns an error instead of exhausting the
    // C stack (the post-parse shape.size() check never runs if the
    // recursion itself crashes)
    if (depth >= 8) return -5;
    ps.skip_ws();
    if (ps.p >= ps.end || *ps.p != '[') return -1;
    ++ps.p;
    long long count = 0;
    bool first_child_is_array = false;
    ps.skip_ws();
    if (ps.p < ps.end && *ps.p == '[') first_child_is_array = true;

    while (true) {
        ps.skip_ws();
        if (ps.p >= ps.end) return -2;          // unterminated
        if (*ps.p == ']') { ++ps.p; break; }
        if (first_child_is_array) {
            int rc = parse_array(ps, out, shape, depth + 1, leaf_depth);
            if (rc) return rc;
        } else {
            double v;
            // std::from_chars is locale-free and ~5x faster than strtod;
            // Python json's NaN/Infinity/-Infinity tokens (not valid
            // from_chars input) are special-cased first.
            if ((ps.end - ps.p) >= 3 &&
                (ps.p[0] == 'N' || ps.p[0] == 'n')) {
                v = NAN; ps.p += 3;
            } else if ((ps.end - ps.p) >= 8 && ps.p[0] == 'I') {
                v = INFINITY; ps.p += 8;
            } else if ((ps.end - ps.p) >= 9 && ps.p[0] == '-' &&
                       ps.p[1] == 'I') {
                v = -INFINITY; ps.p += 9;
            } else {
                auto res = std::from_chars(ps.p, ps.end, v);
                if (res.ec == std::errc::result_out_of_range) {
                    // |x| > DBL_MAX parses to +-inf (strtod semantics);
                    // GCC's pre-C++23 from_chars leaves v unset here
                    v = (*ps.p == '-') ? -INFINITY : INFINITY;
                } else if (res.ec != std::errc() || res.ptr == ps.p) {
                    return -3;                  // not a number
                }
                ps.p = res.ptr;
            }
            out.push_back(v);
        }
        ++count;
    }

    if (!first_child_is_array && count > 0) {
        if (leaf_depth == -1) leaf_depth = depth;
        else if (leaf_depth != depth) return -4; // mixed-rank nest
    }
    if ((int)shape.size() <= depth)
        shape.resize((size_t)depth + 1, -1);
    if (shape[(size_t)depth] == -1) {
        shape[(size_t)depth] = count;
    } else if (shape[(size_t)depth] != count) {
        return -4;                               // ragged array
    }
    return 0;
}

}  // namespace

extern "C" {

int rc_decode_array(const char* text, long long* shape_out, int* ndim_out,
                    double** data_out, long long* count_out) {
    Parser ps{text, text + strlen(text)};
    std::vector<double> vals;
    vals.reserve((size_t)(ps.end - ps.p) / 8 + 16);
    std::vector<long long> shape;
    int leaf_depth = -1;
    int rc = parse_array(ps, vals, shape, 0, leaf_depth);
    if (rc) return rc;
    if (shape.size() > 8) return -5;
    *ndim_out = (int)shape.size();
    long long expect = 1;
    for (size_t i = 0; i < shape.size(); ++i) {
        shape_out[i] = shape[i];
        expect *= shape[i];
    }
    if (expect != (long long)vals.size()) return -6;
    double* buf = (double*)malloc(vals.size() * sizeof(double));
    if (!buf && !vals.empty()) return -7;
    memcpy(buf, vals.data(), vals.size() * sizeof(double));
    *data_out = buf;
    *count_out = (long long)vals.size();
    return 0;
}

int rc_encode_array(const double* data, const long long* shape, int ndim,
                    char** out, long long* len_out) {
    if (ndim < 1 || ndim > 8) return -1;
    long long total = 1;
    for (int i = 0; i < ndim; ++i) total *= shape[i];

    // worst case: 25 chars per %.17g double + 1 comma, plus up to ndim
    // opening AND ndim closing brackets adjoining EVERY scalar (reached
    // when trailing dims are 1, e.g. shape (N,1,1): idx % S[d] == 0 for
    // every d>0 at every element — the earlier total*2 bracket budget
    // heap-overflowed there)
    size_t cap = (size_t)total * (27 + 2 * (size_t)ndim) + 1024;
    char* buf = (char*)malloc(cap);
    if (!buf) return -7;
    char* w = buf;

    // S[d] = number of scalars inside one depth-d list = prod(shape[d:])
    std::vector<long long> S(ndim, 1);
    S[(size_t)ndim - 1] = shape[ndim - 1];
    for (int i = ndim - 2; i >= 0; --i)
        S[(size_t)i] = S[(size_t)i + 1] * shape[i];

    for (long long idx = 0; idx < total; ++idx) {
        for (int d = 0; d < ndim; ++d)               // list openings
            if (idx % S[(size_t)d] == 0) *w++ = '[';
        double v = data[idx];
        if (std::isnan(v)) {
            memcpy(w, "NaN", 3); w += 3;
        } else if (std::isinf(v)) {
            if (v > 0) { memcpy(w, "Infinity", 8); w += 8; }
            else { memcpy(w, "-Infinity", 9); w += 9; }
        } else {
            // shortest round-trip rendering (same contract as Python
            // repr); ~10x faster than snprintf %.17g
            w = std::to_chars(w, w + 32, v).ptr;
        }
        for (int d = ndim - 1; d >= 0; --d)          // list closings
            if ((idx + 1) % S[(size_t)d] == 0) *w++ = ']';
        if (idx + 1 < total) *w++ = ',';
    }
    *w = '\0';
    *out = buf;
    *len_out = (long long)(w - buf);
    return 0;
}

void rc_free(void* p) { free(p); }

}  // extern "C"
