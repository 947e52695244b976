// Native bulk text/binary codec — the C-speed path for loading and dumping
// vector data (the hot loop of the reference's vector_in/vector_out,
// src/vector.c:176-326, exercised heavily by COPY).
//
// The scalar Python value layer keeps exact per-literal error parity; this
// library handles the bulk path: millions of literals per second into a
// flat float32 matrix, and shortest-roundtrip formatting via
// std::to_chars (the same Ryu algorithm Postgres uses for
// float_to_shortest_decimal_bufn).
//
// C ABI only — bound from Python with ctypes.

#include <cctype>
#include <cerrno>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// Error codes (mirrors the errcode classes used by vector_in)
enum {
    PGV_OK = 0,
    PGV_ERR_SYNTAX = 1,        // invalid input syntax
    PGV_ERR_NAN = 2,           // NaN not allowed
    PGV_ERR_INF = 3,           // infinite value not allowed
    PGV_ERR_RANGE = 4,         // out of range
    PGV_ERR_DIM_MISMATCH = 5,  // row dim != expected
    PGV_ERR_TOO_MANY_DIMS = 6, // > max_dim
    PGV_ERR_EMPTY = 7,         // zero dimensions
    PGV_ERR_TRUNCATED = 8,     // binary buffer shorter than its rows claim
};

static inline const char *skip_space(const char *p) {
    while (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r' || *p == '\v' ||
           *p == '\f')
        p++;
    return p;
}

// Parse one "[x,y,...]" literal into out[0..max_dim).  Returns the dim on
// success or -errcode.  Mirrors the scanner rules of vector_in
// (src/vector.c:176-282): leading/trailing space ok, strtof element parse,
// finite check, junk detection.
static int parse_one(const char *lit, float *out, int max_dim) {
    const char *p = skip_space(lit);
    if (*p != '[') return -PGV_ERR_SYNTAX;
    p = skip_space(p + 1);
    if (*p == ']') return -PGV_ERR_EMPTY;
    int dim = 0;
    for (;;) {
        if (dim == max_dim) return -PGV_ERR_TOO_MANY_DIMS;
        p = skip_space(p);
        if (*p == '\0') return -PGV_ERR_SYNTAX;
        errno = 0;
        char *end;
        float v = strtof(p, &end);
        if (end == p) return -PGV_ERR_SYNTAX;
        if (errno == ERANGE && std::isinf(v)) return -PGV_ERR_RANGE;
        if (std::isnan(v)) return -PGV_ERR_NAN;
        if (std::isinf(v)) return -PGV_ERR_INF;
        out[dim++] = v;
        p = skip_space(end);
        if (*p == ',') {
            p++;
        } else if (*p == ']') {
            p++;
            break;
        } else {
            return -PGV_ERR_SYNTAX;
        }
    }
    p = skip_space(p);
    if (*p != '\0') return -PGV_ERR_SYNTAX;
    return dim;
}

// Bulk parse: `count` NUL-terminated literals (given as an offset table into
// one buffer) into a row-major float32 matrix with `expected_dim` columns
// (-1 = infer from the first row).  Returns the dim, or -errcode; on error
// *bad_row holds the offending row.
int pgv_parse_vectors(const char *buf, const int64_t *offsets, int64_t count,
                      int expected_dim, int max_dim, float *out,
                      int64_t *bad_row) {
    int dim = expected_dim;
    for (int64_t i = 0; i < count; i++) {
        float tmp[16000];
        int d = parse_one(buf + offsets[i], tmp, max_dim);
        if (d < 0) {
            *bad_row = i;
            return d;
        }
        if (dim < 0) dim = d;
        if (d != dim) {
            *bad_row = i;
            return -PGV_ERR_DIM_MISMATCH;
        }
        memcpy(out + i * dim, tmp, sizeof(float) * dim);
    }
    return dim;
}

// Bulk format: row-major float32 matrix -> "[a,b,...]" literals written
// consecutively into `out` (cap `outcap`), offsets into `offsets`
// (count+1 entries).  Shortest-roundtrip decimals via std::to_chars —
// identical digits to the reference's Ryu printer.  Returns total bytes
// written or -1 if the buffer is too small.
int64_t pgv_format_vectors(const float *data, int64_t count, int dim,
                           char *out, int64_t outcap, int64_t *offsets) {
    char *p = out;
    char *cap = out + outcap;
    for (int64_t i = 0; i < count; i++) {
        offsets[i] = p - out;
        if (p + 2 + dim * 18 > cap) return -1;
        *p++ = '[';
        for (int j = 0; j < dim; j++) {
            if (j) *p++ = ',';
            float v = data[i * dim + j];
            if (v == 0.0f) {
                if (std::signbit(v)) *p++ = '-';
                *p++ = '0';
            } else {
                auto r = std::to_chars(p, cap, v);
                p = r.ptr;
            }
        }
        *p++ = ']';
        *p++ = '\0';
    }
    offsets[count] = p - out;
    return p - out;
}

// Binary wire codec (vector_recv/send layout, src/vector.c:374-423):
// big-endian {int16 dim, int16 zero, float4[dim]} per row.
static inline uint16_t bswap16(uint16_t x) { return __builtin_bswap16(x); }
static inline uint32_t bswap32(uint32_t x) { return __builtin_bswap32(x); }

int64_t pgv_encode_binary(const float *data, int64_t count, int dim,
                          uint8_t *out) {
    uint8_t *p = out;
    for (int64_t i = 0; i < count; i++) {
        uint16_t d = bswap16((uint16_t)dim), z = 0;
        memcpy(p, &d, 2); p += 2;
        memcpy(p, &z, 2); p += 2;
        for (int j = 0; j < dim; j++) {
            uint32_t bits;
            memcpy(&bits, &data[i * dim + j], 4);
            bits = bswap32(bits);
            memcpy(p, &bits, 4); p += 4;
        }
    }
    return p - out;
}

// Decode `count` rows of the binary wire format; returns dim or -errcode.
// Every read is bounded by `buf_len` — wire data is untrusted, and an
// unbounded walk past a truncated/corrupt buffer is an out-of-bounds read.
int pgv_decode_binary(const uint8_t *buf, int64_t buf_len, int64_t count,
                      float *out, int64_t *bad_row) {
    const uint8_t *p = buf;
    const uint8_t *end = buf + buf_len;
    int dim = -1;
    for (int64_t i = 0; i < count; i++) {
        if (p + 4 > end) { *bad_row = i; return -PGV_ERR_TRUNCATED; }
        uint16_t d_be, z_be;
        memcpy(&d_be, p, 2); p += 2;
        memcpy(&z_be, p, 2); p += 2;
        int d = bswap16(d_be);
        if (bswap16(z_be) != 0 || d < 1) { *bad_row = i; return -PGV_ERR_SYNTAX; }
        if (dim < 0) dim = d;
        if (d != dim) { *bad_row = i; return -PGV_ERR_DIM_MISMATCH; }
        if (p + (int64_t)4 * dim > end) {
            *bad_row = i;
            return -PGV_ERR_TRUNCATED;
        }
        for (int j = 0; j < dim; j++) {
            uint32_t bits;
            memcpy(&bits, p, 4); p += 4;
            bits = bswap32(bits);
            float v;
            memcpy(&v, &bits, 4);
            if (std::isnan(v)) { *bad_row = i; return -PGV_ERR_NAN; }
            if (std::isinf(v)) { *bad_row = i; return -PGV_ERR_INF; }
            out[i * dim + j] = v;
        }
    }
    return dim;
}

}  // extern "C"
