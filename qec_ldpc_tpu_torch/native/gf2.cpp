// Native GF(2) linear-algebra + code-file parsing kernels.
//
// TPU-native counterpart of the reference's native (C++/CUDA) construction
// path: the dense-matrix work that stays on the host — GF(2) row reduction
// for the logical-operator algebra (the `iMinusP` matrix the reference ships
// pre-computed in its code files, Quantum_LDPC_Code.h:67-74) and the
// whitespace-integer code-file parser (Quantum_LDPC_Code.h:26-80, ~1.8M
// fields for code610.txt).  Rows are bit-packed into 64-bit words; row
// elimination is word-wide XOR, ~64x the NumPy byte-per-bit fallback in
// qec_ldpc_tpu/codes/construction.py.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this toolchain).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// In-place reduced row echelon form over GF(2).
//
//   m      : rows x words bit-matrix, row-major, little-endian bit order
//            (bit c of row r = (m[r*words + c/64] >> (c%64)) & 1)
//   rows   : number of rows
//   words  : 64-bit words per row
//   cols   : number of valid columns (cols <= words*64)
//   pivots : out, capacity >= min(rows, cols); pivot column per rank row
//
// Returns the rank; rows [0, rank) hold the RREF basis, the rest are zero.
int qec_gf2_rref(uint64_t* m, int rows, int words, int cols, int* pivots) {
    int r = 0;
    for (int c = 0; c < cols && r < rows; ++c) {
        const int w = c >> 6;
        const uint64_t bit = 1ull << (c & 63);
        int pivot = -1;
        for (int i = r; i < rows; ++i) {
            if (m[(size_t)i * words + w] & bit) { pivot = i; break; }
        }
        if (pivot < 0) continue;
        if (pivot != r) {
            for (int k = 0; k < words; ++k) {
                uint64_t t = m[(size_t)r * words + k];
                m[(size_t)r * words + k] = m[(size_t)pivot * words + k];
                m[(size_t)pivot * words + k] = t;
            }
        }
        const uint64_t* prow = m + (size_t)r * words;
        for (int i = 0; i < rows; ++i) {
            if (i == r) continue;
            uint64_t* row = m + (size_t)i * words;
            if (row[w] & bit) {
                for (int k = 0; k < words; ++k) row[k] ^= prow[k];
            }
        }
        pivots[r] = c;
        ++r;
    }
    return r;
}

// Batched mod-2 matvec on packed rows: out[i, b] = parity(m[i] & v[b]).
//
//   m     : rows x words packed matrix
//   v     : batch x words packed vectors
//   out   : rows x batch bytes (0/1)
void qec_gf2_matvec(const uint64_t* m, int rows, int words,
                    const uint64_t* v, int batch, uint8_t* out) {
    for (int i = 0; i < rows; ++i) {
        const uint64_t* row = m + (size_t)i * words;
        for (int b = 0; b < batch; ++b) {
            const uint64_t* vec = v + (size_t)b * words;
            uint64_t acc = 0;
            for (int k = 0; k < words; ++k) acc ^= row[k] & vec[k];
            out[(size_t)i * batch + b] = (uint8_t)(__builtin_parityll(acc));
        }
    }
}

// Parse up to max_count whitespace-separated non-negative integers from a
// file.  Returns the number parsed, or -1 on open failure.  The reference
// loader streams the same format via ifstream >> int (Quantum_LDPC_Code.h:
// 43-74); this is a single-read byte scanner, ~100x faster on code610.txt.
long qec_parse_ints(const char* path, long* out, long max_count) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    char* buf = (char*)malloc((size_t)size + 1);
    if (!buf) { fclose(f); return -1; }
    size_t got = fread(buf, 1, (size_t)size, f);
    fclose(f);
    buf[got] = '\0';
    long count = 0;
    const char* p = buf;
    const char* end = buf + got;
    while (p < end && count < max_count) {
        while (p < end && (*p < '0' || *p > '9') && *p != '-') ++p;
        if (p >= end) break;
        int neg = (*p == '-');
        if (neg) ++p;
        long val = 0;
        while (p < end && *p >= '0' && *p <= '9') {
            val = val * 10 + (*p - '0');
            ++p;
        }
        out[count++] = neg ? -val : val;
    }
    free(buf);
    return count;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Ordered-statistics decoding (OSD) post-processing for BP failures.
//
// Given a parity-check matrix H (m x n over GF(2), supplied as bit-packed
// COLUMNS), a syndrome s, and a per-lane column order (most-likely-in-error
// first, from the BP soft output), OSD-0 selects the first linearly
// independent columns in that order (the "most reliable information set" of
// the ordered-statistics literature, applied syndrome-side as in BP+OSD for
// quantum LDPC codes) and solves H_S e_S = s exactly, guaranteeing a
// syndrome-satisfying correction whenever s lies in the column space (always
// true for syndromes generated by real errors).  The combination sweep
// (lam > 0) additionally tries flipping every single and pair of the first
// lam non-pivot columns, keeping the minimum-Hamming-weight solution.
//
// Internals: an incrementally maintained RREF basis of reduced columns, each
// with a unique pivot bit eliminated from all other basis vectors, plus a
// coefficient vector per basis element tracking its expansion over the
// accepted original columns; a column that reduces to zero yields, for free,
// the pivot-set coefficient delta its flip would induce — which makes each
// combination-sweep candidate a couple of word-XORs and a popcount.

static inline int qec__lowest_bit(const uint64_t* v, int w) {
    for (int k = 0; k < w; ++k)
        if (v[k]) return k * 64 + __builtin_ctzll(v[k]);
    return -1;
}

static inline int qec__popcount(const uint64_t* v, int w) {
    int c = 0;
    for (int k = 0; k < w; ++k) c += __builtin_popcountll(v[k]);
    return c;
}

typedef struct {
    uint64_t* basis;    // m x w reduced columns (unique pivots, RREF)
    uint64_t* coef;     // m x wc expansion over accepted columns
    int* pivot_of;      // m
    int* accepted;      // m: original column index per basis row
    uint64_t* np_coef;  // lam x wc: coefficient deltas of non-pivot columns
    int* np_col;        // lam
    uint64_t* tmpv;     // w
    uint64_t* tmpc;     // wc
} qec__osd_scratch;

// Returns 0 on success, 1 when the syndrome is outside the column space.
static int qec__osd_one(const uint64_t* cols, int m, int n, int w,
                        const int32_t* order, const uint64_t* syn, int lam,
                        uint8_t* e_out, qec__osd_scratch* S) {
    const int wc = (m + 63) / 64;
    int r = 0, nnp = 0;
    for (int ii = 0; ii < n; ++ii) {
        if (r >= m && nnp >= lam) break;  // basis full, sweep set full
        const int c = order[ii];
        memcpy(S->tmpv, cols + (size_t)c * w, (size_t)w * 8);
        memset(S->tmpc, 0, (size_t)wc * 8);
        for (int j = 0; j < r; ++j) {
            const int p = S->pivot_of[j];
            if ((S->tmpv[p >> 6] >> (p & 63)) & 1) {
                const uint64_t* bj = S->basis + (size_t)j * w;
                for (int k = 0; k < w; ++k) S->tmpv[k] ^= bj[k];
                const uint64_t* cj = S->coef + (size_t)j * wc;
                for (int k = 0; k < wc; ++k) S->tmpc[k] ^= cj[k];
            }
        }
        const int p = qec__lowest_bit(S->tmpv, w);
        if (p < 0) {
            if (nnp < lam) {  // store the flip delta for the sweep
                memcpy(S->np_coef + (size_t)nnp * wc, S->tmpc, (size_t)wc * 8);
                S->np_col[nnp++] = c;
            }
            continue;
        }
        // record the new column's own coefficient BEFORE back-substitution
        S->tmpc[r >> 6] |= 1ull << (r & 63);
        // eliminate pivot p from every existing basis vector (keeps RREF)
        for (int j = 0; j < r; ++j) {
            uint64_t* bj = S->basis + (size_t)j * w;
            if ((bj[p >> 6] >> (p & 63)) & 1) {
                for (int k = 0; k < w; ++k) bj[k] ^= S->tmpv[k];
                uint64_t* cj = S->coef + (size_t)j * wc;
                for (int k = 0; k < wc; ++k) cj[k] ^= S->tmpc[k];
            }
        }
        memcpy(S->basis + (size_t)r * w, S->tmpv, (size_t)w * 8);
        memcpy(S->coef + (size_t)r * wc, S->tmpc, (size_t)wc * 8);
        S->pivot_of[r] = p;
        S->accepted[r] = c;
        ++r;
    }
    // reduce the syndrome against the basis
    memcpy(S->tmpv, syn, (size_t)w * 8);
    memset(S->tmpc, 0, (size_t)wc * 8);
    for (int j = 0; j < r; ++j) {
        const int p = S->pivot_of[j];
        if ((S->tmpv[p >> 6] >> (p & 63)) & 1) {
            const uint64_t* bj = S->basis + (size_t)j * w;
            for (int k = 0; k < w; ++k) S->tmpv[k] ^= bj[k];
            const uint64_t* cj = S->coef + (size_t)j * wc;
            for (int k = 0; k < wc; ++k) S->tmpc[k] ^= cj[k];
        }
    }
    memset(e_out, 0, (size_t)n);
    if (qec__lowest_bit(S->tmpv, w) >= 0) return 1;  // unsolvable
    // combination sweep over the stored non-pivot columns (|t| <= 2);
    // OSD-0 is the empty flip set
    int best_w = qec__popcount(S->tmpc, wc);
    int best_i = -1, best_j = -1;
    for (int i = 0; i < nnp; ++i) {
        const uint64_t* ci = S->np_coef + (size_t)i * wc;
        int wt = 1;
        for (int k = 0; k < wc; ++k)
            wt += __builtin_popcountll(S->tmpc[k] ^ ci[k]);
        if (wt < best_w) { best_w = wt; best_i = i; best_j = -1; }
        for (int j = i + 1; j < nnp; ++j) {
            const uint64_t* cj = S->np_coef + (size_t)j * wc;
            int wt2 = 2;
            for (int k = 0; k < wc; ++k)
                wt2 += __builtin_popcountll(S->tmpc[k] ^ ci[k] ^ cj[k]);
            if (wt2 < best_w) { best_w = wt2; best_i = i; best_j = j; }
        }
    }
    if (best_i >= 0) {
        const uint64_t* ci = S->np_coef + (size_t)best_i * wc;
        for (int k = 0; k < wc; ++k) S->tmpc[k] ^= ci[k];
        e_out[S->np_col[best_i]] = 1;
    }
    if (best_j >= 0) {
        const uint64_t* cj = S->np_coef + (size_t)best_j * wc;
        for (int k = 0; k < wc; ++k) S->tmpc[k] ^= cj[k];
        e_out[S->np_col[best_j]] = 1;
    }
    for (int j = 0; j < r; ++j)
        if ((S->tmpc[j >> 6] >> (j & 63)) & 1) e_out[S->accepted[j]] = 1;
    return 0;
}

extern "C" {

// Batched OSD.  cols: n x w packed columns of H (m rows).  order: batch x n
// column indices, most-likely-in-error first.  syn: batch x w packed
// syndromes.  e_out: batch x n bytes.  status: batch bytes (0 = solved,
// 1 = syndrome outside the column space).  Returns the number of failures.
int qec_osd_batch(const uint64_t* cols, int m, int n, int w,
                  const int32_t* order, const uint64_t* syn,
                  int batch, int lam, uint8_t* e_out, uint8_t* status) {
    const int wc = (m + 63) / 64;
    int fails = 0;
#ifdef _OPENMP
#pragma omp parallel reduction(+ : fails)
#endif
    {
        qec__osd_scratch S;
        S.basis = (uint64_t*)malloc((size_t)m * w * 8);
        S.coef = (uint64_t*)malloc((size_t)m * wc * 8);
        S.pivot_of = (int*)malloc((size_t)m * sizeof(int));
        S.accepted = (int*)malloc((size_t)m * sizeof(int));
        S.np_coef = (uint64_t*)malloc((size_t)(lam > 0 ? lam : 1) * wc * 8);
        S.np_col = (int*)malloc((size_t)(lam > 0 ? lam : 1) * sizeof(int));
        S.tmpv = (uint64_t*)malloc((size_t)w * 8);
        S.tmpc = (uint64_t*)malloc((size_t)wc * 8);
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 8)
#endif
        for (int b = 0; b < batch; ++b) {
            int rc = qec__osd_one(cols, m, n, w, order + (size_t)b * n,
                                  syn + (size_t)b * w, lam,
                                  e_out + (size_t)b * n, &S);
            status[b] = (uint8_t)rc;
            fails += rc;
        }
        free(S.basis); free(S.coef); free(S.pivot_of); free(S.accepted);
        free(S.np_coef); free(S.np_col); free(S.tmpv); free(S.tmpc);
    }
    return fails;
}

}  // extern "C"
