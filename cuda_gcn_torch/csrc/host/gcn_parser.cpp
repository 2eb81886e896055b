// Native dataset parser for the .graph/.split/.svmlight text format.
//
// TPU-framework counterpart of the reference's C++ parser
// (reference: src/common/parser.cpp) — same file-format semantics, different
// design: instead of ifstream/getline + istringstream token loops, this reads
// each file in one shot and scans it with branch-light integer/float lexers,
// emitting flat CSR arrays ready to wrap as numpy buffers over a C ABI
// (consumed via ctypes from cuda_gcn_tpu/data/native.py).
//
// Format semantics preserved exactly (see data/parser.py docstring):
//   .graph    line i = neighbor ids of node i; a self-loop is prepended per row
//   .svmlight "label k:v k:v ..." per node; label parse failure -> -1, no feats
//   .split    one int per node (1=train, 2=val, 3=test)
//
// Memory contract: all out-arrays are malloc'd here and released by the caller
// through gcn_free (Python wraps them with a free-on-gc capsule).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

// Read an entire file into a NUL-terminated heap buffer. Returns nullptr on error.
char* read_file(const char* path, size_t* out_len) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return nullptr;
    std::fseek(f, 0, SEEK_END);
    long len = std::ftell(f);
    if (len < 0) { std::fclose(f); return nullptr; }
    std::fseek(f, 0, SEEK_SET);
    char* buf = static_cast<char*>(std::malloc(static_cast<size_t>(len) + 1));
    if (!buf) { std::fclose(f); return nullptr; }
    size_t got = std::fread(buf, 1, static_cast<size_t>(len), f);
    std::fclose(f);
    buf[got] = '\0';
    *out_len = got;
    return buf;
}

inline bool is_space(char c) { return c == ' ' || c == '\t' || c == '\r'; }

// Scan an integer at *p (optional sign); advances *p. Returns false if no digits.
inline bool scan_int(const char** p, long* out) {
    const char* s = *p;
    while (is_space(*s)) s++;
    bool neg = false;
    if (*s == '-') { neg = true; s++; }
    else if (*s == '+') s++;
    if (*s < '0' || *s > '9') return false;
    long v = 0;
    while (*s >= '0' && *s <= '9') v = v * 10 + (*s++ - '0');
    *p = s;
    *out = neg ? -v : v;
    return true;
}

// Scan a float (decimal with optional exponent); advances *p. Refuses to cross
// a line boundary (strtof itself would skip '\n').
inline bool scan_float(const char** p, float* out) {
    const char* s = *p;
    while (is_space(*s)) s++;
    if (*s == '\n' || *s == '\0') return false;
    char* end = nullptr;
    float v = std::strtof(s, &end);
    if (end == s) return false;
    *p = end;
    *out = v;
    return true;
}

template <typename T>
T* to_heap(const std::vector<T>& v) {
    T* out = static_cast<T*>(std::malloc(v.size() * sizeof(T) + 1));
    if (out && !v.empty()) std::memcpy(out, v.data(), v.size() * sizeof(T));
    return out;
}

}  // namespace

extern "C" {

void gcn_free(void* p) { std::free(p); }

// Parse <path>.graph: CSR with a self-loop prepended per row.
// On success fills indptr (n+1), indices (nnz), n_nodes, nnz; returns 0.
int gcn_parse_graph(const char* path, int32_t** indptr_out, int32_t** indices_out,
                    int64_t* n_nodes, int64_t* nnz) {
    size_t len = 0;
    char* buf = read_file(path, &len);
    if (!buf) return 1;

    std::vector<int32_t> indptr;
    std::vector<int32_t> indices;
    indptr.reserve(1 << 12);
    indices.reserve(1 << 16);
    indptr.push_back(0);

    const char* p = buf;
    const char* end = buf + len;
    int32_t node = 0;
    while (p < end) {
        const char* line_end = static_cast<const char*>(std::memchr(p, '\n', end - p));
        if (!line_end) line_end = end;
        indices.push_back(node);  // implicit self connection first
        long v;
        const char* q = p;
        while (q < line_end && scan_int(&q, &v) && q <= line_end)
            indices.push_back(static_cast<int32_t>(v));
        indptr.push_back(static_cast<int32_t>(indices.size()));
        node++;
        p = line_end + 1;
    }
    std::free(buf);

    *indptr_out = to_heap(indptr);
    *indices_out = to_heap(indices);
    *n_nodes = node;
    *nnz = static_cast<int64_t>(indices.size());
    return (*indptr_out && *indices_out) ? 0 : 2;
}

// Parse <path>.svmlight: feature CSR + values + labels + inferred dims.
int gcn_parse_svmlight(const char* path, int32_t** indptr_out, int32_t** indices_out,
                       float** values_out, int32_t** labels_out,
                       int64_t* n_rows, int64_t* nnz,
                       int32_t* input_dim, int32_t* output_dim) {
    size_t len = 0;
    char* buf = read_file(path, &len);
    if (!buf) return 1;

    std::vector<int32_t> indptr;
    std::vector<int32_t> indices;
    std::vector<float> values;
    std::vector<int32_t> labels;
    indptr.push_back(0);
    // maxima start at 0, matching the reference's dim inference
    // (an all-empty file still reports dims of 1)
    long max_idx = 0, max_label = 0;

    const char* p = buf;
    const char* end = buf + len;
    while (p < end) {
        const char* line_end = static_cast<const char*>(std::memchr(p, '\n', end - p));
        if (!line_end) line_end = end;
        const char* q = p;
        long label;
        if (q < line_end && scan_int(&q, &label) && q <= line_end) {
            labels.push_back(static_cast<int32_t>(label));
            if (label > max_label) max_label = label;
            while (q < line_end) {
                long k;
                if (!scan_int(&q, &k) || q > line_end || *q != ':') break;
                q++;  // ':'
                float v;
                if (!scan_float(&q, &v) || q > line_end + 0) break;
                indices.push_back(static_cast<int32_t>(k));
                values.push_back(v);
                if (k > max_idx) max_idx = k;
            }
        } else {
            labels.push_back(-1);  // unparseable label -> -1, no features
        }
        indptr.push_back(static_cast<int32_t>(indices.size()));
        p = line_end + 1;
    }
    std::free(buf);

    *indptr_out = to_heap(indptr);
    *indices_out = to_heap(indices);
    *values_out = to_heap(values);
    *labels_out = to_heap(labels);
    *n_rows = static_cast<int64_t>(labels.size());
    *nnz = static_cast<int64_t>(indices.size());
    *input_dim = static_cast<int32_t>(max_idx + 1);
    *output_dim = static_cast<int32_t>(max_label + 1);
    return (*indptr_out && *indices_out && *values_out && *labels_out) ? 0 : 2;
}

// Parse <path>.split: one int per line.
int gcn_parse_split(const char* path, int32_t** split_out, int64_t* n) {
    size_t len = 0;
    char* buf = read_file(path, &len);
    if (!buf) return 1;
    std::vector<int32_t> split;
    const char* p = buf;
    const char* end = buf + len;
    long v;
    while (p < end && scan_int(&p, &v)) {
        split.push_back(static_cast<int32_t>(v));
        while (p < end && (*p == '\n' || is_space(*p))) p++;
    }
    std::free(buf);
    *split_out = to_heap(split);
    *n = static_cast<int64_t>(split.size());
    return *split_out ? 0 : 2;
}

}  // extern "C"
