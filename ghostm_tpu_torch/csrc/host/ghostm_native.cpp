// Host-side native code of ghostm_tpu_torch: the port's own copy of the
// JAX package's native/ghostm_native.cpp, with the same plain C entry points
// (bound with ctypes by ghostm_tpu_torch/native.py). Host code, not a kernel:
// built by the host C++ compiler at first use into build/native/.
//
// Everything here is bit-deterministic and mirrors the numpy / Python paths
// of the port exactly (tests/test_torch_native.py asserts equality):
//   - encode_aa_buf:   byte string -> int8 residue codes (ops/encode.py LUT)
//   - kmer_csr:        k-mer keys + counting-sort CSR seed index
//                      (index/seeds.py build_seed_index)
//   - fasta_scan/read: two-pass FASTA parser into a packed arena
//                      (io/fasta.py iter_fasta for protein DBs)
//   - m8_format_rows:  BLAST-m8 TSV row formatter (report.write_hits's
//                      per-row f-string loop; std::to_chars, or printf on a
//                      library without floating-point to_chars, rounds
//                      %.2f/%.2e/%.1f correctly like CPython's float
//                      formatting, so the text is byte-identical)
//
// Build: $CXX -O3 -march=native -fPIC -shared -std=c++17 (native.py)

#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <vector>

// Floating-point std::to_chars with a precision came with libstdc++ 11.
// Older libraries build the snprintf loop, which writes the same bytes;
// GHOSTM_M8_SNPRINTF builds it on any compiler (the tests pin its bytes).
#if defined(__cpp_lib_to_chars) && __cpp_lib_to_chars >= 201611L && \
    !defined(GHOSTM_M8_SNPRINTF)
#define GHOSTM_M8_TO_CHARS 1
#endif

extern "C" {

// ---- alphabet encoding (must match ops/encode.py) -------------
static int8_t AA_LUT[256];
static bool aa_lut_init_done = false;

static void aa_lut_init() {
    if (aa_lut_init_done) return;
    const char* alpha = "ARNDCQEGHILKMFPSTWYVBZX*";
    for (int i = 0; i < 256; i++) AA_LUT[i] = 22;  // X
    for (int i = 0; i < 24; i++) {
        AA_LUT[(unsigned char)alpha[i]] = (int8_t)i;
        AA_LUT[(unsigned char)(alpha[i] | 0x20)] = (int8_t)i;
    }
    AA_LUT[(unsigned char)'U'] = AA_LUT[(unsigned char)'u'] = 4;   // C
    AA_LUT[(unsigned char)'O'] = AA_LUT[(unsigned char)'o'] = 11;  // K
    AA_LUT[(unsigned char)'J'] = AA_LUT[(unsigned char)'j'] = 10;  // L
    aa_lut_init_done = true;
}

void encode_aa_buf(const uint8_t* in, int64_t n, int8_t* out) {
    aa_lut_init();
    for (int64_t i = 0; i < n; i++) out[i] = AA_LUT[in[i]];
}

// ---- seed index build (counting sort; matches index/seeds.py) ------------
// buf: int8 residue codes (sentinel-separated shard buffer)
// keep: optional bool mask over buffer positions (global truncation), or null
// positions_out: caller-allocated, capacity >= n
// bucket_starts_out: caller-allocated, size 20^k + 2
// returns number of positions written
int64_t kmer_csr(const int8_t* buf, int64_t n, int32_t k,
                 const uint8_t* keep,
                 int32_t* positions_out, int32_t* bucket_starts_out) {
    const int64_t nb = [&] {
        int64_t v = 1;
        for (int i = 0; i < k; i++) v *= 20;
        return v;
    }();
    const int64_t nkeys = n - k + 1;
    if (nkeys <= 0) {
        for (int64_t i = 0; i < nb + 2; i++) bucket_starts_out[i] = 0;
        return 0;
    }
    // pass 1: per-window keys + counts (k <= 5, memory-bound either way)
    std::vector<int32_t> keys(nkeys);
    std::vector<int64_t> counts(nb, 0);
    for (int64_t p = 0; p < nkeys; p++) {
        int64_t key = 0;
        bool ok = !(keep && !keep[p]);
        for (int32_t t = 0; ok && t < k; t++) {
            int8_t c = buf[p + t];
            if (c < 0 || c >= 20) ok = false;
            else key = key * 20 + c;
        }
        keys[p] = ok ? (int32_t)key : (int32_t)nb;
        if (ok) counts[key]++;
    }
    // prefix sums
    bucket_starts_out[0] = 0;
    for (int64_t b = 0; b < nb; b++)
        bucket_starts_out[b + 1] = bucket_starts_out[b] + (int32_t)counts[b];
    bucket_starts_out[nb + 1] = bucket_starts_out[nb];
    // pass 2: stable scatter (positions ascending within bucket)
    std::vector<int32_t> cursor(nb);
    for (int64_t b = 0; b < nb; b++) cursor[b] = bucket_starts_out[b];
    int64_t total = bucket_starts_out[nb];
    for (int64_t p = 0; p < nkeys; p++) {
        int32_t kk2 = keys[p];
        if (kk2 < (int32_t)nb) positions_out[cursor[kk2]++] = (int32_t)p;
    }
    return total;
}

// ---- FASTA parsing (two-pass; matches io/fasta.py for protein DBs) -------
// Pass 1: scan for record count and total residue bytes.
// Pass 2: fill caller-allocated arrays:
//   seq_arena  (int8, total residues, ENCODED)
//   seq_starts (int64, n_records)  seq_lens (int64, n_records)
//   name_arena (char, total name bytes incl. NUL per record)
//   name_offs  (int64, n_records)
// Returns 0 on success, negative errno-style on failure.

int fasta_scan(const char* path, int64_t* n_records, int64_t* total_residues,
               int64_t* total_name_bytes) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    *n_records = 0; *total_residues = 0; *total_name_bytes = 0;
    char* line = nullptr;
    size_t cap = 0;
    ssize_t len;
    while ((len = getline(&line, &cap, f)) != -1) {
        if (len && line[0] == '>') {
            (*n_records)++;
            int64_t nl = 1;  // NUL
            for (ssize_t i = 1; i < len && line[i] != ' ' && line[i] != '\t' &&
                                line[i] != '\n' && line[i] != '\r'; i++)
                nl++;
            *total_name_bytes += nl;
        } else {
            for (ssize_t i = 0; i < len; i++) {
                char ch = line[i];
                if (ch != '\n' && ch != '\r' && ch != ' ') (*total_residues)++;
            }
        }
    }
    free(line);
    fclose(f);
    return 0;
}

int fasta_read(const char* path, int8_t* seq_arena, int64_t* seq_starts,
               int64_t* seq_lens, char* name_arena, int64_t* name_offs) {
    aa_lut_init();
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    char* line = nullptr;
    size_t cap = 0;
    ssize_t len;
    int64_t rec = -1, spos = 0, npos = 0;
    while ((len = getline(&line, &cap, f)) != -1) {
        if (len && line[0] == '>') {
            if (rec >= 0) seq_lens[rec] = spos - seq_starts[rec];
            rec++;
            seq_starts[rec] = spos;
            name_offs[rec] = npos;
            for (ssize_t i = 1; i < len && line[i] != ' ' && line[i] != '\t' &&
                                line[i] != '\n' && line[i] != '\r'; i++)
                name_arena[npos++] = line[i];
            name_arena[npos++] = '\0';
        } else if (rec >= 0) {
            for (ssize_t i = 0; i < len; i++) {
                unsigned char ch = (unsigned char)line[i];
                if (ch != '\n' && ch != '\r' && ch != ' ')
                    seq_arena[spos++] = AA_LUT[ch];
            }
        }
    }
    if (rec >= 0) seq_lens[rec] = spos - seq_starts[rec];
    free(line);
    fclose(f);
    return 0;
}

// ---- BLAST-m8 TSV row formatting (report.write_hits hot loop) ------------
// One call formats n pre-filtered rows. Name strings come as packed arenas
// with (len+1)-style offset tables: record i's bytes are
// arena[off[i] .. off[i+1]-1] (no NULs required). The numeric columns are
// the exact float64/int values the Python path feeds its f-string, and
// to_chars, printf and CPython produce the same text (all correctly
// rounded, half-to-even on the exact binary value; "%.2e", to_chars'
// scientific and Python ":.2e" all emit >= 2 exponent digits).
// A row's numeric tail (its ten columns, their tabs and the newline) must
// take fewer than M8_TAIL bytes: 134 with every integer at its extreme,
// which leaves 25 for pident and bits. The caller reserves M8_TAIL a row
// past the names. Writes stay inside `cap`. Returns bytes written, or -1
// if `cap` is too small or a row's tail does not fit its reserve (a value
// too wide in fixed notation).

static const int64_t M8_TAIL = 160;

#ifdef GHOSTM_M8_TO_CHARS
// Write v and then sep at p, short of end; nullptr when they do not fit
// (or when p is already nullptr, so a row's columns chain).
static inline char* put_int(char* p, char* end, int64_t v, char sep) {
    if (!p) return nullptr;
    std::to_chars_result r = std::to_chars(p, end, v);
    if (r.ec != std::errc() || r.ptr == end) return nullptr;
    *r.ptr = sep;
    return r.ptr + 1;
}

static inline char* put_float(char* p, char* end, double v,
                              std::chars_format fmt, int prec, char sep) {
    if (!p) return nullptr;
    std::to_chars_result r = std::to_chars(p, end, v, fmt, prec);
    if (r.ec != std::errc() || r.ptr == end) return nullptr;
    *r.ptr = sep;
    return r.ptr + 1;
}
#endif

int64_t m8_format_rows(
    int64_t n,
    const int32_t* qrow, const char* qarena, const int64_t* qoff,
    const int32_t* srow, const char* sarena, const int64_t* soff,
    const double* pident, const int32_t* length, const int32_t* mismatch,
    const int32_t* gapopen, const int64_t* qs, const int64_t* qe,
    const int64_t* ss, const int64_t* se, const double* evalue,
    const double* bits, char* out, int64_t cap) {
    int64_t pos = 0;
    for (int64_t i = 0; i < n; i++) {
        int64_t q0 = qoff[qrow[i]], qn = qoff[qrow[i] + 1] - q0;
        int64_t s0 = soff[srow[i]], sn = soff[srow[i] + 1] - s0;
        if (pos + qn + sn + M8_TAIL > cap) return -1;
        memcpy(out + pos, qarena + q0, qn); pos += qn;
        out[pos++] = '\t';
        memcpy(out + pos, sarena + s0, sn); pos += sn;
#ifdef GHOSTM_M8_TO_CHARS
        using std::chars_format;
        char* p = out + pos;
        char* const end = p + M8_TAIL - 1;
        *p++ = '\t';
        p = put_float(p, end, pident[i], chars_format::fixed, 2, '\t');
        p = put_int(p, end, length[i], '\t');
        p = put_int(p, end, mismatch[i], '\t');
        p = put_int(p, end, gapopen[i], '\t');
        p = put_int(p, end, qs[i], '\t');
        p = put_int(p, end, qe[i], '\t');
        p = put_int(p, end, ss[i], '\t');
        p = put_int(p, end, se[i], '\t');
        p = put_float(p, end, evalue[i], chars_format::scientific, 2, '\t');
        p = put_float(p, end, bits[i], chars_format::fixed, 1, '\n');
        if (!p) return -1;
        pos = p - out;
#else
        int w = snprintf(
            out + pos, M8_TAIL,
            "\t%.2f\t%d\t%d\t%d\t%lld\t%lld\t%lld\t%lld\t%.2e\t%.1f\n",
            pident[i], length[i], mismatch[i], gapopen[i],
            (long long)qs[i], (long long)qe[i], (long long)ss[i],
            (long long)se[i], evalue[i], bits[i]);
        if (w < 0 || w >= M8_TAIL) return -1;
        pos += w;
#endif
    }
    return pos;
}

}  // extern "C"
