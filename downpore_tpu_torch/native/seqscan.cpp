// Native host-side sequence kernels for downpore_tpu.
//
// The reference implements its host hot loops in hand-written amd64
// assembly (ref: sequence/asm_amd64.s, util/asm_amd64.s).  On the TPU
// build, device work goes through XLA/Pallas; the host-side preprocessing
// that feeds it — ASCII -> 2-bit encoding, rolling k-mer extraction,
// seed-table scans and fastq record indexing — lives here as portable
// C++ that the compiler auto-vectorizes.  Exposed with C linkage for
// ctypes.
//
// Build: g++ -O3 -march=native -shared -fPIC seqscan.cpp -o libseqscan.so
#include <cstdint>
#include <cstddef>

extern "C" {

// ASCII base -> 2-bit code, the reference's ((b>>1)^((b&4)>>2))&3 trick
// (ref: sequence/sequence.go:59)
void encode_bases(const uint8_t* in, int64_t n, uint8_t* out) {
    for (int64_t i = 0; i < n; i++) {
        uint8_t b = in[i];
        out[i] = ((b >> 1) ^ ((b & 4) >> 2)) & 3;
    }
}

// rolling k-mers over 2-bit codes; out has n-k+1 entries
// (ref: sequence/sequence.go:444-453, asm packedKmerAt)
void rolling_kmers(const uint8_t* codes, int64_t n, int32_t k,
                   int32_t* out) {
    if (n < k) return;
    int32_t mask = (int32_t)((1u << (2 * k)) - 1);
    int32_t v = 0;
    for (int32_t i = 0; i < k; i++) v = (v << 2) | codes[i];
    out[0] = v;
    for (int64_t i = k; i < n; i++) {
        v = ((v << 2) | codes[i]) & mask;
        out[i - k + 1] = v;
    }
}

// count positions whose rolling k-mer is flagged in table[4^k]
// (ref: sequence/asm_amd64.s packedCountKmers)
int64_t count_seed_kmers(const uint8_t* codes, int64_t n, int32_t k,
                         const uint8_t* table, int64_t up_to) {
    if (n < k) return 0;
    int32_t mask = (int32_t)((1u << (2 * k)) - 1);
    int32_t v = 0;
    for (int32_t i = 0; i < k; i++) v = (v << 2) | codes[i];
    int64_t count = table[v] ? 1 : 0;
    for (int64_t i = k; i < n && count < up_to; i++) {
        v = ((v << 2) | codes[i]) & mask;
        count += table[v] ? 1 : 0;
    }
    return count;
}

// gapped-seed extraction: writes (gap, kmer) pairs plus a trailing gap
// Returns the number of seeds found.  gaps has capacity n+1, kmers n.
// (ref: sequence/asm_amd64.s packedWriteSegments, scalar at
//  sequence/sequence.go:308-324)
int64_t write_segments(const uint8_t* codes, int64_t n, int32_t k,
                       const uint8_t* table, int32_t* gaps,
                       int32_t* kmers) {
    if (n < k) { gaps[0] = (int32_t)n; return 0; }
    int32_t mask = (int32_t)((1u << (2 * k)) - 1);
    int32_t v = 0;
    for (int32_t i = 0; i < k; i++) v = (v << 2) | codes[i];
    int64_t count = 0;
    int64_t prev = 0;
    int64_t idx = 0;  // kmer start index
    if (table[v]) {
        gaps[count] = 0;
        kmers[count] = v;
        prev = k;
        count++;
    }
    for (int64_t i = k; i < n; i++) {
        v = ((v << 2) | codes[i]) & mask;
        idx = i - k + 1;
        if (table[v]) {
            gaps[count] = (int32_t)(idx - prev);
            kmers[count] = v;
            prev = idx + k;
            count++;
        }
    }
    gaps[count] = (int32_t)(n - prev);
    return count;
}

// Batched write_segments over B sequences stored back-to-back in one
// codes buffer: sequence i occupies codes[off[i] .. off[i]+lens[i]) and
// writes its (gaps, kmers) into gaps/kmers at gout_off[i] (gaps need
// capacity lens[i]+1 there; the caller sizes gout_off accordingly).
// counts[i] receives the seed count.  One ctypes call + thread fan-out
// instead of a Python call per read — the per-call overhead dominated
// overlap round prep (declaration below, definition after <thread>).
int64_t write_segments_batch(const uint8_t* codes, const int64_t* off,
                             const int64_t* lens, int64_t B, int32_t k,
                             const uint8_t* table, int32_t* gaps,
                             int32_t* kmers, const int64_t* gout_off,
                             int64_t* counts, int32_t n_threads);

// index single-line fastq records in a memory buffer: for each record,
// emit (seq_offset, seq_len, name_offset, name_len, qual_offset).
// Returns the number of records found, or -1 on malformed input.
// (the native analogue of the reference's two-pass reader,
//  ref: sequence/seqio.go:106-276)
int64_t index_fastq(const uint8_t* buf, int64_t n, int64_t max_records,
                    int64_t* seq_off, int64_t* seq_len,
                    int64_t* name_off, int64_t* name_len,
                    int64_t* qual_off) {
    int64_t i = 0, rec = 0;
    while (i < n && rec < max_records) {
        if (buf[i] != '@') return -1;
        int64_t name_start = i + 1;
        while (i < n && buf[i] != '\n') i++;
        int64_t name_end = i;
        while (name_end > name_start && (buf[name_end - 1] == '\r')) name_end--;
        i++;  // past newline
        int64_t s_start = i;
        while (i < n && buf[i] != '\n') i++;
        int64_t s_end = i;
        while (s_end > s_start && buf[s_end - 1] == '\r') s_end--;
        i++;
        if (i >= n || buf[i] != '+') return -1;
        while (i < n && buf[i] != '\n') i++;
        i++;
        int64_t q_start = i;
        i += (s_end - s_start);
        if (i > n) return -1;
        // skip to end of quality line
        while (i < n && buf[i] != '\n') i++;
        i++;
        seq_off[rec] = s_start;
        seq_len[rec] = s_end - s_start;
        name_off[rec] = name_start;
        name_len[rec] = name_end - name_start;
        qual_off[rec] = q_start;
        rec++;
    }
    return rec;
}

// Batched query-window packing for the map/overlap engines — the exact
// semantics of MapEngine.pack_query_windows' numpy pipeline (flag seeds
// via the kmer table, keep the first `nqs` in order, run-collapse usable
// seeds per SeedIndex.matches, hash to buckets, emit sorted distinct
// buckets), fused into one pass per row so no [2M, W] intermediates are
// materialised (the numpy version's ~65 MB cumsum/nonzero arrays were the
// map pipeline's dominant host cost).  Row 2i = forward window i, row
// 2i+1 = its reverse complement (complement of a 2-bit code is ^3).
static void pack_rows(const uint8_t* codes, const int64_t* off,
                      const int64_t* lens, int32_t k, int32_t nq,
                      int32_t nqs, const uint8_t* kmer_table,
                      const int32_t* kmer_map, const uint8_t* usable,
                      int64_t num_seed_ids, int64_t H,
                      int32_t* q_seeds, int32_t* q_pos, int32_t* q_rb,
                      int32_t* q_db, int32_t* num_sets,
                      int64_t* num_seeds_out,
                      int64_t row_lo, int64_t row_hi,
                      int32_t* seed_buf, int32_t* pos_buf,
                      int64_t* hash_buf) {
    const uint32_t mask = (k >= 16) ? 0xFFFFFFFFu
                                    : ((1u << (2 * k)) - 1u);
    for (int64_t r = row_lo; r < row_hi; r++) {
        const int64_t w = r >> 1;
        const bool rc = (r & 1) != 0;
        const uint8_t* c = codes + off[w];
        const int64_t n = lens[w];
        int32_t* qs = q_seeds + r * nq;
        int32_t* qp = q_pos + r * nq;
        int32_t* qrb = q_rb + r * nq;
        int32_t* qdb = q_db + r * nq;
        for (int32_t j = 0; j < nq; j++) {
            qs[j] = -1; qp[j] = 0; qrb[j] = -1; qdb[j] = -1;
        }
        num_sets[r] = 0;
        num_seeds_out[r] = 0;
        if (n < k) continue;
        // rolling k-mers; collect first nqs table hits in order
        uint32_t v = 0;
        int32_t kept = 0;
        int64_t total = 0;
        for (int64_t j = 0; j < n; j++) {
            const uint8_t b = rc ? (uint8_t)(c[n - 1 - j] ^ 3) : c[j];
            v = ((v << 2) | b) & mask;
            if (j < k - 1) continue;
            if (kmer_table[v]) {
                total++;
                if (kept < nqs) {
                    seed_buf[kept] = kmer_map[v];
                    pos_buf[kept] = (int32_t)(j - (k - 1));
                    kept++;
                }
            }
        }
        num_seeds_out[r] = total;
        const int32_t m0 = kept < nq ? kept : nq;
        for (int32_t j = 0; j < m0; j++) { qs[j] = seed_buf[j];
                                           qp[j] = pos_buf[j]; }
        // run-collapse over usable seeds (within the first nqs, matching
        // the vectorized twin; ref: seeds/seeds.go:335-353)
        int32_t runs = 0;
        int32_t prev = -2;
        int32_t stored = 0;
        for (int32_t j = 0; j < kept; j++) {
            const int32_t s = seed_buf[j];
            if (!usable[s]) continue;
            if (s != prev) {
                runs++;
                if (stored < nq) {
                    int64_t hv = s;
                    if (num_seed_ids > H)
                        hv = (int64_t)(((uint64_t)(uint32_t)s
                                        * 2654435761ull) % (uint64_t)H);
                    hash_buf[stored] = hv;
                    qrb[stored] = (int32_t)hv;
                    stored++;
                }
            }
            prev = s;
        }
        num_sets[r] = runs;
        // sorted distinct buckets, replicated layout of the numpy twin:
        // values sit at their sorted rank; duplicate/dead slots are -1
        for (int32_t a = 1; a < stored; a++) {  // insertion sort (nq<=256)
            const int64_t key = hash_buf[a];
            int32_t b2 = a - 1;
            while (b2 >= 0 && hash_buf[b2] > key) {
                hash_buf[b2 + 1] = hash_buf[b2]; b2--;
            }
            hash_buf[b2 + 1] = key;
        }
        for (int32_t a = 0; a < stored; a++)
            if (a == 0 || hash_buf[a] != hash_buf[a - 1])
                qdb[a] = (int32_t)hash_buf[a];
    }
}

void pack_windows(const uint8_t* codes, const int64_t* off,
                  const int64_t* lens, int64_t m, int32_t k, int32_t nq,
                  int32_t nqs, const uint8_t* kmer_table,
                  const int32_t* kmer_map, const uint8_t* usable,
                  int64_t num_seed_ids, int64_t H,
                  int32_t* q_seeds, int32_t* q_pos, int32_t* q_rb,
                  int32_t* q_db, int32_t* num_sets,
                  int64_t* num_seeds_out, int32_t n_threads);

}  // extern "C"

#include <thread>
#include <vector>
#include <atomic>
#include <algorithm>

extern "C" void pack_windows(const uint8_t* codes, const int64_t* off,
                             const int64_t* lens, int64_t m, int32_t k,
                             int32_t nq, int32_t nqs,
                             const uint8_t* kmer_table,
                             const int32_t* kmer_map,
                             const uint8_t* usable,
                             int64_t num_seed_ids, int64_t H,
                             int32_t* q_seeds, int32_t* q_pos,
                             int32_t* q_rb, int32_t* q_db,
                             int32_t* num_sets, int64_t* num_seeds_out,
                             int32_t n_threads) {
    const int64_t rows = 2 * m;
    if (n_threads < 1) n_threads = 1;
    if (n_threads > rows) n_threads = rows > 0 ? (int32_t)rows : 1;
    std::vector<std::thread> ts;
    const int64_t step = (rows + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; t++) {
        const int64_t lo = t * step;
        const int64_t hi = lo + step < rows ? lo + step : rows;
        if (lo >= hi) break;
        ts.emplace_back([=]() {
            std::vector<int32_t> seed_buf(nqs), pos_buf(nqs);
            std::vector<int64_t> hash_buf(nq);
            pack_rows(codes, off, lens, k, nq, nqs, kmer_table, kmer_map,
                      usable, num_seed_ids, H, q_seeds, q_pos, q_rb, q_db,
                      num_sets, num_seeds_out, lo, hi,
                      seed_buf.data(), pos_buf.data(), hash_buf.data());
        });
    }
    for (auto& th : ts) th.join();
}

extern "C" int64_t write_segments_batch(
    const uint8_t* codes, const int64_t* off, const int64_t* lens,
    int64_t B, int32_t k, const uint8_t* table, int32_t* gaps,
    int32_t* kmers, const int64_t* gout_off, int64_t* counts,
    int32_t n_threads) {
    if (n_threads < 1) n_threads = 1;
    if (n_threads > B) n_threads = B > 0 ? (int32_t)B : 1;
    std::vector<std::thread> ts;
    const int64_t step = (B + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; t++) {
        const int64_t lo = t * step;
        const int64_t hi = lo + step < B ? lo + step : B;
        if (lo >= hi) break;
        ts.emplace_back([=]() {
            for (int64_t i = lo; i < hi; i++) {
                counts[i] = write_segments(codes + off[i], lens[i], k,
                                           table, gaps + gout_off[i],
                                           kmers + gout_off[i]);
            }
        });
    }
    for (auto& th : ts) th.join();
    return 0;
}

// Windowed top-N seed selection walk (AddSeeds, ref: seeds/seeds.go:62-156,
// mirroring seeds.seed_index.add_seeds): walk k-length blocks, a block
// containing an existing seed resets, otherwise push the block's best-value
// k-mer into a bounded ascending insertion list (earliest wins on ties).
// Returns the number of selected k-mers, written to out_kmers in the exact
// order the Python list iteration adds them (ascending value).
extern "C" int64_t add_seeds_walk(const int32_t* kmers, const double* values,
                                  const uint8_t* in_index, int64_t nk,
                                  int64_t n, int32_t k, int64_t cap,
                                  int32_t* out_kmers) {
    if (cap <= 0) return 0;
    std::vector<int32_t> top_n;
    std::vector<double> top_vals;
    top_n.reserve(cap);
    top_vals.reserve(cap);
    int64_t next_index = k;
    while (next_index < n - k) {
        bool reset = false;
        double best_value = 0.0;
        int64_t best_seed = -1;
        int32_t steps = 0;
        while (next_index < n && steps < k) {
            const int64_t ki = next_index - k + 1;
            const int32_t kmer = ki < nk ? kmers[ki] : 0;
            next_index++;
            steps++;
            if (ki < nk && in_index[ki]) { reset = true; break; }
            const double value = ki < nk ? values[ki] : 0.0;
            if (value > best_value) { best_value = value; best_seed = kmer; }
        }
        if (!reset && best_seed >= 0) {
            if ((int64_t)top_n.size() < cap) {
                top_n.push_back((int32_t)best_seed);
                top_vals.push_back(best_value);
                size_t i = top_n.size() - 1;
                while (i > 0 && top_vals[i - 1] > top_vals[i]) {
                    std::swap(top_vals[i - 1], top_vals[i]);
                    std::swap(top_n[i - 1], top_n[i]);
                    i--;
                }
            } else if (best_value > top_vals[0]) {
                top_vals[0] = best_value;
                top_n[0] = (int32_t)best_seed;
                size_t i = 0;
                while (i + 1 < top_vals.size()
                       && top_vals[i] > top_vals[i + 1]) {
                    std::swap(top_vals[i], top_vals[i + 1]);
                    std::swap(top_n[i], top_n[i + 1]);
                    i++;
                }
            }
        }
        next_index += 2 * k;
    }
    for (size_t i = 0; i < top_n.size(); i++) out_kmers[i] = top_n[i];
    return (int64_t)top_n.size();
}

// One best-ranked seed per seed_rate-base window with no existing seed
// (AddSingleSeeds, ref: seeds/seeds.go:160-200; twin of the Python loop in
// seeds.seed_index.add_single_seeds).  The table lookup is LIVE: seeds
// added by earlier windows suppress later windows.  `table` (bool/uint8,
// 4^k entries) is updated in place; selected k-mers are written to
// out_kmers in selection order.  Returns the selection count.
extern "C" int64_t add_single_seeds_walk(const int32_t* kmers,
                                         const double* vals, int64_t nk,
                                         int64_t n, int32_t k,
                                         int64_t seed_rate, uint8_t* table,
                                         int32_t* out_kmers) {
    int64_t count = 0;
    for (int64_t i = 0; i + seed_rate < n; i += seed_rate) {
        const int64_t lo = i;
        int64_t hi = i + seed_rate - k + 1;
        if (hi > nk) hi = nk;
        if (hi <= lo) continue;
        bool has = false;
        for (int64_t j = lo; j < hi; j++) {
            if (table[kmers[j]]) { has = true; break; }
        }
        if (has) continue;
        int64_t best = lo;
        double bv = vals[lo];
        for (int64_t j = lo + 1; j < hi; j++) {
            if (vals[j] > bv) { bv = vals[j]; best = j; }
        }
        const int32_t km = kmers[best];
        table[km] = 1;
        out_kmers[count++] = km;
    }
    return count;
}

// Sequential adaptive-threshold candidate walk for the mapper
// (performMapping's accept loop, ref: mapping/mapping.go:494-589; exact
// twin of the Python loop in mapping.mapper._walk_candidates_py), read in
// place from the collected rows: row b's head (query row, chunk, distinct
// count) at head[3b..3b+2], its packed summary at packed[W*b..W*b+W-1],
// each field's first column in `cols` (best, top_valid, top_sqp, top_stp,
// top_eqp, top_etp, top_cov_t, top_len; a top field's K chains follow its
// first).  Row ranges per query come from `bounds` ([2*nq+1], rows sorted
// query-major with the forward row first); `qlen` holds the windows'
// lengths.  Thresholds ratchet up as chains are accepted, affecting LATER
// candidates of the same query — hence a walk, not a filter.  The
// 2/3-coverage rule is applied to the chains about to be accepted alone.
// Emits accepted (query, row, chain, rc) tuples in the reference's walk
// order; returns the count (caller truncates at cap).
extern "C" int64_t walk_candidates(
    const int64_t* bounds, const int64_t* num_seeds, int64_t nq,
    const int32_t* head, const int32_t* packed, int64_t W,
    const int32_t* cols, const int64_t* qlen, int32_t k, int32_t K,
    int32_t* out_qi, int32_t* out_b, int32_t* out_j, uint8_t* out_rc,
    int64_t cap) {
    int64_t cnt = 0;
    // starts "dict": insertion-ordered, <= K entries (K is small)
    int32_t key_sq[16], key_st[16], val_j[16];
    int32_t s0[16], s1[16], s2[16], s3[16];
    if (K > 16) return -1;
    const int32_t c_best = cols[0], c_tv = cols[1], c_sq = cols[2],
                  c_st = cols[3], c_eq = cols[4], c_et = cols[5],
                  c_ct = cols[6], c_tl = cols[7];
    for (int64_t qi = 0; qi < nq; qi++) {
        const int64_t lo_f = bounds[2 * qi], hi_f = bounds[2 * qi + 1];
        const int64_t hi_r = bounds[2 * qi + 2];
        if (lo_f == hi_f && hi_f == hi_r) continue;
        int64_t min_matches = num_seeds[2 * qi] / 5;
        if (min_matches < 5) min_matches = 5;
        int64_t min_rc = num_seeds[2 * qi + 1] / 5;
        if (min_rc < 5) min_rc = 5;
        // the 2/3 rule, sq + (ql - eq - k) <= ql * 2 / 3, in int64: the
        // values are window coordinates, far inside int32, so this is
        // numpy's int32 result (and ql >= 0, so / is //)
        const int64_t ql = (int32_t)qlen[qi];
        const int64_t ql23 = (ql * 2) / 3;
        for (int pass = 0; pass < 2; pass++) {
            const int64_t lo = pass ? hi_f : lo_f;
            const int64_t hi = pass ? hi_r : hi_f;
            const bool rc = pass != 0;
            for (int64_t b = lo; b < hi; b++) {
                const int64_t cur_min = rc ? min_rc : min_matches;
                const int32_t* r = packed + b * W;
                if (head[3 * b + 2] < cur_min || r[c_best] < cur_min)
                    continue;
                int n_keys = 0;
                for (int j = 0; j < K; j++) {
                    const int32_t a0 = r[c_tl + j];
                    if (!r[c_tv + j] || a0 < cur_min) continue;
                    const int32_t ksq = r[c_sq + j], kst = r[c_st + j];
                    const int32_t a1 = r[c_ct + j];
                    const int32_t a2 = r[c_eq + j], a3 = r[c_et + j];
                    int found = -1;
                    for (int m = 0; m < n_keys; m++) {
                        if (key_sq[m] == ksq && key_st[m] == kst) {
                            found = m;
                            break;
                        }
                    }
                    if (found < 0) {
                        key_sq[n_keys] = ksq; key_st[n_keys] = kst;
                        s0[n_keys] = a0; s1[n_keys] = a1;
                        s2[n_keys] = a2; s3[n_keys] = a3;
                        val_j[n_keys] = j;
                        n_keys++;
                    } else {
                        const bool gt =
                            (a0 != s0[found]) ? (a0 > s0[found])
                            : (a1 != s1[found]) ? (a1 > s1[found])
                            : (a2 != s2[found]) ? (a2 > s2[found])
                            : (a3 > s3[found]);
                        if (gt) {
                            s0[found] = a0; s1[found] = a1;
                            s2[found] = a2; s3[found] = a3;
                            val_j[found] = j;
                        }
                    }
                }
                for (int m = 0; m < n_keys; m++) {
                    const int j = val_j[m];
                    if ((int64_t)key_sq[m] + (ql - s2[m] - k) > ql23)
                        continue;
                    if (cnt < cap) {
                        out_qi[cnt] = (int32_t)qi;
                        out_b[cnt] = (int32_t)b;
                        out_j[cnt] = j;
                        out_rc[cnt] = rc ? 1 : 0;
                    }
                    cnt++;
                    const int64_t limit = ((int64_t)s0[m] * 4) / 5;
                    if (!rc && limit > min_matches) min_matches = limit;
                    if (limit > min_rc) min_rc = limit;
                }
            }
        }
    }
    return cnt;
}

// --------------------------------------------------------------------
// The mapper's ends phase after the walk, for every long read (exact
// twin of mapping.mapper.Mapper._ends_py): per end window the walk's
// accepted mappings deduplicated by position (ref: mapping.go:590-608),
// each end's dominated mappings dropped (mapping.go:387-428), then the
// ends paired (mapping.go:131-203).  The Python lists become index
// vectors into the rows; list order, stable sorts, identity (the same
// row) and match_pairs' swap-removes are kept step for step.
namespace ends {

struct Row {
    int64_t start, end, qo, qi, ids;
    bool rc;
};

static inline int64_t floor_div(int64_t a, int64_t b) {
    const int64_t q = a / b;
    return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// Mapper.is_consistent (ref: mapping.go:131-160); Python's // is floor
// division and int() truncates toward zero
static bool consistent(const Row& left, const Row& right, int64_t qlen,
                       bool circular, int64_t ref_len) {
    if (left.rc != right.rc) return false;
    const int64_t expected = right.qo - qlen + left.qi;
    int64_t distance = left.rc ? left.start - right.end
                               : right.start - left.end;
    if (circular && distance < -50) distance += ref_len;
    if (distance < 50 && expected < 50 && distance > -50) return true;
    if (distance < 500)
        return expected < floor_div(distance * 3, 2)
            && expected > floor_div(distance * 2, 3);
    if (distance > 5000)
        return expected < floor_div(distance * 10, 9)
            && expected > floor_div(distance * 9, 10);
    // the product is rounded before the sum, as in Python: a volatile
    // keeps -march=native from contracting the two into one FMA
    volatile double scaled =
        ((double)(distance - 500) / 4500.0) * (10.0 / 9.0 - 3.0 / 2.0);
    const double ratio = 3.0 / 2.0 + scaled;
    return distance < (int64_t)((double)expected * ratio)
        && distance > (int64_t)((double)expected / ratio);
}

// _dedup_by_position over rows [lo, hi) of one window
static void dedup(const Row* rows, int64_t lo, int64_t hi,
                  std::vector<int64_t>& out) {
    out.clear();
    for (int64_t i = lo; i < hi; i++) out.push_back(i);
    if (out.size() <= 1) return;
    std::stable_sort(out.begin(), out.end(), [rows](int64_t a, int64_t b) {
        return rows[a].start < rows[b].start;
    });
    size_t n = 0;
    for (size_t p = 0; p < out.size(); p++) {
        const int64_t m = out[p];
        if (n > 0) {
            const Row& last = rows[out[n - 1]];
            if (last.rc == rows[m].rc && rows[m].start < last.end) {
                if (last.end - last.start < rows[m].end - rows[m].start)
                    out[n - 1] = m;
                continue;
            }
        }
        out[n++] = m;
    }
    out.resize(n);
}

// _remove_dominated(x, x, qlen): both of its sorted copies are one order,
// so "e is not nxt" is a different position
static void remove_dominated(const Row* rows, std::vector<int64_t>& x,
                             int64_t qlen, std::vector<int64_t>& keep) {
    if (x.empty()) return;
    std::stable_sort(x.begin(), x.end(), [rows](int64_t a, int64_t b) {
        return rows[a].qo < rows[b].qo;
    });
    keep.clear();
    const size_t n = x.size();
    size_t j = 0;
    for (size_t p = 0; p < n; p++) {
        const Row& nxt = rows[x[p]];
        while (j < n && qlen - rows[x[j]].qi < nxt.qo) j++;
        if (j == n) {
            keep.push_back(x[p]);
            continue;
        }
        bool dominated = false;
        for (size_t kk = j;
             !dominated && kk < n && rows[x[kk]].qo < qlen - nxt.qi; kk++) {
            const Row& e = rows[x[kk]];
            if (kk != p && e.ids * 4 > nxt.ids * 5) {
                const int64_t start = std::max(nxt.qo, e.qo);
                const int64_t end = qlen - std::max(nxt.qi, e.qi);
                dominated = (end - start) * 10
                    > (qlen - nxt.qo - nxt.qi) * 9;
            }
        }
        if (!dominated) keep.push_back(x[p]);
    }
    x.swap(keep);
}

}  // namespace ends

// Inputs: n_reads long reads, read t's end windows 2t and 2t+1 with the
// walk's accepted rows of window w at [win_bounds[w], win_bounds[w+1])
// in walk order.  Per read, status 0: matched (the pairs' rows); 1: the
// read is under 3 * es, so its open ends are the result (open_a then
// open_b); 2: still open, open_a's n_a rows then open_b's n_b rows for
// the next phase.  Rows are written read-major, at most one a row in.
// Returns the rows written.
extern "C" int64_t pair_ends(
    int64_t n_reads, const int64_t* read_len, int64_t es,
    const int64_t* win_bounds, const int64_t* start, const int64_t* end,
    const int64_t* qo, const int64_t* qi, const uint8_t* rc,
    const int64_t* ids, int32_t circular, int64_t ref_len,
    uint8_t* status, int64_t* n_a, int64_t* n_b,
    int64_t* o_start, int64_t* o_end, int64_t* o_qo, int64_t* o_qi,
    uint8_t* o_rc, int64_t* o_ids) {
    using ends::Row;
    const int64_t n_rows = win_bounds[2 * n_reads];
    std::vector<Row> rows((size_t)n_rows);
    for (int64_t i = 0; i < n_rows; i++)
        rows[i] = Row{start[i], end[i], qo[i], qi[i], ids[i], rc[i] != 0};
    const Row* R = rows.data();
    std::vector<int64_t> a, b, keep;
    std::vector<Row> matched;
    int64_t w = 0;
    auto put = [&](const Row& r) {
        o_start[w] = r.start; o_end[w] = r.end; o_qo[w] = r.qo;
        o_qi[w] = r.qi; o_rc[w] = r.rc ? 1 : 0; o_ids[w] = r.ids;
        w++;
    };
    for (int64_t t = 0; t < n_reads; t++) {
        const int64_t qlen = read_len[t];
        ends::dedup(R, win_bounds[2 * t], win_bounds[2 * t + 1], a);
        ends::dedup(R, win_bounds[2 * t + 1], win_bounds[2 * t + 2], b);
        ends::remove_dominated(R, a, qlen, keep);
        ends::remove_dominated(R, b, qlen, keep);
        // match_pairs: i steps down past the element moved into slot i
        matched.clear();
        for (int64_t i = (int64_t)a.size() - 1; i >= 0; i--) {
            const Row& ra = R[a[i]];
            for (int64_t j = (int64_t)b.size() - 1; j >= 0; j--) {
                const Row& rb = R[b[j]];
                if (!ends::consistent(ra, rb, qlen, circular != 0, ref_len))
                    continue;
                matched.push_back(Row{ra.rc ? rb.start : ra.start,
                                      ra.rc ? ra.end : rb.end, ra.qo, rb.qi,
                                      ra.ids + rb.ids, ra.rc});
                a[i] = a.back();
                a.pop_back();
                b[j] = b.back();
                b.pop_back();
                break;
            }
        }
        if (!matched.empty()) {
            status[t] = 0;
            n_a[t] = (int64_t)matched.size();
            n_b[t] = 0;
            for (const Row& r : matched) put(r);
            continue;
        }
        status[t] = qlen < 3 * es ? 1 : 2;
        n_a[t] = (int64_t)a.size();
        n_b[t] = (int64_t)b.size();
        for (int64_t i : a) put(R[i]);
        for (int64_t i : b) put(R[i]);
    }
    return w;
}

// --------------------------------------------------------------------
// Host speed-of-light microbenchmark for the DTW band update — the
// reference's hottest consensus loop (ref:
// sequence/alignment/asm_amd64.s:17-149: per 32xuint16 band,
// new[i] = min(stay, step, skip1+d, skip2+2d) + d[i], horizontal min,
// subtract min, clamp to threshold).  Runs `reps` full passes over
// `n_bands` bands, each pass feeding its output back as the next
// input, exactly the data flow of the consensus beam.  The measured
// updates/second anchor the bench suite's consensus baseline (an
// optimized-host model of what the reference's SIMD kernel can do).
extern "C" int64_t band_update_rounds(const uint16_t* ds, uint16_t* bands,
                                      int64_t n_bands, int32_t W,
                                      int32_t threshold, int32_t reps) {
    std::vector<uint16_t> raw((size_t)W);
    int64_t sink = 0;
    for (int32_t r = 0; r < reps; r++) {
        for (int64_t b = 0; b < n_bands; b++) {
            const uint16_t* d = ds + b * W;
            uint16_t* p = bands + b * W;
            uint32_t m = 0xFFFF;
            for (int32_t i = 0; i < W; i++) {
                uint32_t best = p[i];                       // step
                uint32_t stay = (i + 1 < W) ? p[i + 1] : 0xFFFFu;
                if (stay < best) best = stay;
                if (i >= 1) {
                    uint32_t s1 = (uint32_t)p[i - 1] + d[i - 1];
                    if (s1 > 0xFFFFu) s1 = 0xFFFFu;
                    if (s1 < best) best = s1;
                }
                if (i >= 2) {
                    uint32_t s2 = (uint32_t)p[i - 2] + d[i - 2];
                    if (s2 > 0xFFFFu) s2 = 0xFFFFu;
                    s2 += d[i - 1];
                    if (s2 > 0xFFFFu) s2 = 0xFFFFu;
                    if (s2 < best) best = s2;
                }
                uint32_t v = best + d[i];
                if (v > 0xFFFFu) v = 0xFFFFu;
                raw[i] = (uint16_t)v;
                if (v < m) m = v;
            }
            for (int32_t i = 0; i < W; i++) {
                uint32_t v = (uint32_t)raw[i] - m;
                p[i] = (v >= (uint32_t)threshold) ? 0xFFFF : (uint16_t)v;
            }
            sink += (int64_t)m;
        }
    }
    return sink;
}

// ---------------------------------------------------------------------
// Seed-space MSA sweep (the reference multiAligner.Consensus,
// seeds/alignment.go:9-268) — exact transcription of the Python oracle
// downpore_tpu/seeds/msa.py::consensus's while loop, operating on the
// already-reduced member segments.  One call replaces the overlap
// command's hottest host loop (~75 ms of pure Python per final check).
//
// Inputs: n members; seg = concat of interleaved (gap, seed)*m+gap
// int32 segment arrays, seg_off[n+1] offsets (an empty member —
// reduced() returned None — has seg_off[i+1]==seg_off[i]).
// Outputs: cons (caller-sized to total seeds*2+2), match_a/match_b flat
// per-member matched pairs with match_cnt[i] entries for member i,
// capped at each member's reduced length (positions advance strictly).
// Returns the number of int32s written to cons (gaps+seeds,
// WITHOUT the trailing 0 gap the Python appends after the loop).
namespace {
static inline int32_t trunc_div(int64_t a, int64_t b) {
    // C++ integer division already truncates toward zero
    return (int32_t)(a / b);
}
static inline void gap_range(int32_t gap, int32_t k, int32_t* lo,
                             int32_t* hi) {
    int32_t min_gap = trunc_div((int64_t)gap * 2, 3) - k;
    int32_t max_gap = trunc_div((int64_t)gap * 3, 2) + k + 1;
    if (min_gap < 0) {
        min_gap = -k;
        if (max_gap < 0) max_gap = 0;
    } else if (max_gap < 20) {
        max_gap = 20;
        min_gap = 0;
    }
    *lo = min_gap;
    *hi = max_gap;
}
static inline int32_t floor_div_i32(int32_t a, int32_t b) {
    int32_t q = a / b;
    if ((a % b != 0) && ((a < 0) != (b < 0))) q--;
    return q;
}
}  // namespace

extern "C" int64_t msa_consensus(
    const int32_t* seg, const int64_t* seg_off, int64_t n, int32_t k,
    int32_t* cons, int32_t* match_a, int32_t* match_b,
    const int64_t* match_off, int64_t* match_cnt) {
    std::vector<int64_t> seg_len(n);       // element count per member
    std::vector<int64_t> pos(n, -1), offset(n, 0), gaps(n, 50);
    std::vector<int64_t> supported(n, 0), dist(n, 0);
    for (int64_t i = 0; i < n; i++) {
        seg_len[i] = seg_off[i + 1] - seg_off[i];
        match_cnt[i] = 0;
    }
    auto SEG = [&](int64_t i, int64_t j) -> int32_t {
        return seg[seg_off[i] + j];
    };
    int64_t cons_len = 0;
    bool finished = false;
    while (!finished) {
        int64_t f_count = 0;
        int64_t near = 100000;
        for (int64_t i = 0; i < n; i++) {
            int64_t p = pos[i];
            supported[i] = 0;
            // (len-1)//2 - 1 with Python floor semantics (len>=0)
            if (seg_len[i] == 0 || p >= (seg_len[i] - 1) / 2 - 1) {
                f_count++;
                continue;
            }
            int64_t d = SEG(i, p * 2 + 2) - offset[i];
            dist[i] = d;
            if (d < near && d > -k) {
                int32_t next_seed = SEG(i, p * 2 + 3);
                int32_t min_d, max_d;
                gap_range((int32_t)(d + gaps[i]), k, &min_d, &max_d);
                min_d -= (int32_t)gaps[i];
                max_d -= (int32_t)gaps[i];
                if (near > max_d) near = max_d;
                supported[i] = 1;
                for (int64_t j = 0; j < n; j++) {
                    if (seg_len[j] == 0 || j == i) continue;
                    int64_t p2 = pos[j] + 1;
                    if (p2 < seg_len[j] / 2) {
                        int32_t min2, max2;
                        gap_range((int32_t)(d + gaps[j]), k, &min2, &max2);
                        if (min_d < min2) min2 = min_d;
                        if (max_d > max2) max2 = max_d;
                        int64_t other_d = SEG(j, p2 * 2) - offset[j];
                        while (other_d < min2 && p2 < seg_len[j] / 2) {
                            p2++;
                            if (p2 >= seg_len[j] / 2) break;
                            other_d += SEG(j, p2 * 2) + k;
                        }
                        while (other_d < max2 && p2 < seg_len[j] / 2) {
                            if (SEG(j, p2 * 2 + 1) == next_seed) {
                                supported[i]++;
                                dist[i] += other_d;
                                break;
                            }
                            p2++;
                            if (p2 >= seg_len[j] / 2) break;
                            other_d += SEG(j, p2 * 2) + k;
                        }
                    }
                }
            }
        }
        if (f_count >= n) break;
        // select the minimum-distance supported option
        int64_t minseed = -1, mindist = 0, minsup = 0;
        int32_t min_d = 0, max_d = 0;
        for (int64_t i = 0; i < n; i++) {
            int64_t d = dist[i];
            if (supported[i] > 1) {
                // Python: d // s if d >= 0 else -((-d) // s)  (trunc)
                d = (d >= 0) ? d / supported[i]
                             : -((-d) / supported[i]);
                int64_t seedv = SEG(i, pos[i] * 2 + 3);
                if (minseed == -1
                        || (minseed == seedv && supported[i] > minsup)
                        || (minseed != seedv && mindist > d)) {
                    minsup = supported[i];
                    mindist = d;
                    minseed = seedv;
                    gap_range((int32_t)(d + gaps[i]), k, &min_d, &max_d);
                    min_d -= (int32_t)gaps[i];
                    max_d -= (int32_t)gaps[i];
                }
            }
        }
        if (minseed == -1) {
            // no supports: step the shortest gap.  NOTE: the Python
            // oracle (faithful to the reference) bounds pos[i] by
            // len(segments)//2 == n//2 here — the MEMBER COUNT, not the
            // member's own length — and uses floor division on d.
            int64_t min_index = -1, min_dist = 100000;
            for (int64_t i = 0; i < n; i++) {
                int64_t d = dist[i];
                if (supported[i] > 1)
                    d = floor_div_i32((int32_t)d, (int32_t)supported[i]);
                if (seg_len[i] != 0 && pos[i] < n / 2 && d < min_dist) {
                    min_dist = d;
                    min_index = i;
                }
            }
            if (min_index == -1) break;
            for (int64_t i = 0; i < n; i++) {
                if (seg_len[i] != 0) {
                    gaps[i] += min_dist;
                    offset[i] += min_dist;
                }
            }
            gaps[min_index] = 0;
            offset[min_index] = 0;
            pos[min_index]++;
            continue;
        }
        cons[cons_len++] = (int32_t)mindist;
        cons[cons_len++] = (int32_t)minseed;
        // build matchings and step past
        f_count = 0;
        for (int64_t i = 0; i < n; i++) {
            if (seg_len[i] == 0) {
                f_count++;
                continue;
            }
            int64_t match_dex = pos[i] + 1;
            if (match_dex < seg_len[i] / 2) {
                int32_t min2, max2;
                gap_range((int32_t)(mindist + gaps[i]), k, &min2, &max2);
                if (min_d < min2) min2 = min_d;
                if (max_d > max2) max2 = max_d;
                int64_t other_d = SEG(i, match_dex * 2) - offset[i];
                while (other_d < min2 && match_dex < seg_len[i] / 2) {
                    match_dex++;
                    if (match_dex >= seg_len[i] / 2) break;
                    other_d += SEG(i, match_dex * 2) + k;
                }
                bool found = false;
                while (other_d < max2 && match_dex < seg_len[i] / 2) {
                    if (SEG(i, match_dex * 2 + 1) == minseed) {
                        pos[i] = match_dex;
                        offset[i] = 0;
                        gaps[i] = 0;
                        int64_t c = match_cnt[i]++;
                        match_a[match_off[i] + c] =
                            (int32_t)(cons_len / 2 - 1);
                        match_b[match_off[i] + c] = (int32_t)match_dex;
                        found = true;
                        break;
                    }
                    match_dex++;
                    if (match_dex >= seg_len[i] / 2) break;
                    other_d += SEG(i, match_dex * 2) + k;
                }
                if (!found) {
                    gaps[i] += mindist;
                    offset[i] += mindist;
                    int64_t p = pos[i];
                    while (p < seg_len[i] / 2
                           && offset[i] > SEG(i, p * 2 + 2) + 50) {
                        offset[i] -= SEG(i, p * 2 + 2) + k;
                        p++;
                        pos[i]++;
                    }
                    if (p >= seg_len[i] / 2) f_count++;
                }
            } else {
                f_count++;
            }
        }
        finished = f_count >= n;
    }
    return cons_len;
}

// ---------------------------------------------------------------------
// Round-level overlap final check (the reference finalCheckWorker +
// BuildConsensus + trimToBestSeed pipeline, commands/overlap.go:197-233,
// overlap/combine.go:8-193) — full C++ port of the Python
// overlap/combine.py build_consensus flow, which the parity tests pin
// bit-for-bit.  The Python path remains the oracle and the no-toolchain
// fallback.  One call per round replaces ~4000 Python final checks of
// ~6 ms each (the dominant host cost of the GB-scale overlap CLI).
namespace fc {

struct CSeq {
    std::vector<int32_t> gaps, seeds;
    int64_t offset = 0, inset = 0, length = 0, id = -1, root_len = 0;
    bool rc = false;
};

static int64_t seed_offset(const CSeq& s, int64_t index, int32_t k) {
    int64_t o = s.gaps[0];
    for (int64_t i = 1; i <= index; i++) o += (int64_t)s.gaps[i] + k;
    return o;
}

static int64_t seed_offset_from_end(const CSeq& s, int64_t index,
                                    int32_t k) {
    int64_t n = (int64_t)s.seeds.size();
    int64_t o = s.gaps[n];
    for (int64_t i = index + 1; i < n; i++) o += (int64_t)s.gaps[i] + k;
    return o;
}

static void seed_positions(const CSeq& s, int32_t k,
                           std::vector<int64_t>* pos) {
    int64_t n = (int64_t)s.seeds.size();
    pos->resize(n);
    int64_t acc = 0;
    for (int64_t i = 0; i < n; i++) {
        acc += s.gaps[i] + (i > 0 ? k : 0);
        (*pos)[i] = acc;
    }
}

static CSeq seq_rc(const CSeq& s, const int32_t* rc_lut) {
    CSeq r;
    r.gaps.assign(s.gaps.rbegin(), s.gaps.rend());
    size_t n = s.seeds.size();
    r.seeds.resize(n);
    for (size_t i = 0; i < n; i++)
        r.seeds[i] = rc_lut[s.seeds[n - 1 - i]];
    r.offset = s.offset; r.inset = s.inset; r.length = s.length;
    r.id = s.id; r.root_len = s.root_len; r.rc = !s.rc;
    return r;
}

// seeds/sequence.go:54-82 (seed_sequence.py trimmed)
static CSeq trimmed(const CSeq& s, int64_t start_offset, int64_t start_seed,
                    int64_t end_offset, int64_t end_seed, int32_t k) {
    while (start_seed > 0
           && start_offset >= (int64_t)s.gaps[start_seed] + k) {
        start_offset -= (int64_t)s.gaps[start_seed] + k;
        start_seed--;
    }
    int64_t n = (int64_t)s.seeds.size();
    while (end_seed < n - 1
           && end_offset >= (int64_t)s.gaps[end_seed + 1] + k) {
        end_offset -= (int64_t)s.gaps[end_seed + 1] + k;
        end_seed++;
    }
    int64_t off = seed_offset(s, start_seed, k) - start_offset;
    int64_t ins = seed_offset_from_end(s, end_seed, k) - end_offset;
    CSeq t;
    t.gaps.assign(s.gaps.begin() + start_seed,
                  s.gaps.begin() + end_seed + 2);
    t.seeds.assign(s.seeds.begin() + start_seed,
                   s.seeds.begin() + end_seed + 1);
    t.length = s.length - off - ins;
    if (s.rc) { t.offset = s.offset + ins; t.inset = s.inset + off; }
    else      { t.offset = s.offset + off; t.inset = s.inset + ins; }
    t.rc = s.rc; t.id = s.id; t.root_len = s.root_len;
    t.gaps.front() = (int32_t)start_offset;
    t.gaps.back() = (int32_t)end_offset;
    return t;
}

// seed_sequence.py reduced (seeds/sequence.go:85-123)
static bool reduced(const CSeq& s, const std::vector<uint8_t>& use,
                    int32_t k, int64_t min_seeds, CSeq* out,
                    std::vector<int32_t>* idx_map) {
    int64_t n = (int64_t)s.seeds.size();
    if (n == 0) return false;
    std::vector<int64_t> idx;
    int64_t prev = -1;
    for (int64_t i = 0; i < n; i++) {
        int32_t sd = s.seeds[i];
        if (sd >= 0 && sd < (int64_t)use.size() && use[sd]) {
            if (sd != prev) { idx.push_back(i); prev = sd; }
        }
    }
    if ((int64_t)idx.size() < min_seeds) return false;
    std::vector<int64_t> pos;
    seed_positions(s, k, &pos);
    int64_t m = (int64_t)idx.size();
    out->gaps.resize(m + 1);
    out->seeds.resize(m);
    out->gaps[0] = (int32_t)(s.gaps[0] + (pos[idx[0]] - pos[0]));
    for (int64_t j = 1; j < m; j++)
        out->gaps[j] = (int32_t)((pos[idx[j]] - pos[idx[j - 1]]) - k);
    out->gaps[m] = (int32_t)(s.gaps[n] + (pos[n - 1] - pos[idx[m - 1]]));
    for (int64_t j = 0; j < m; j++) out->seeds[j] = s.seeds[idx[j]];
    out->offset = s.offset; out->inset = s.inset; out->length = s.length;
    out->id = s.id; out->root_len = s.root_len; out->rc = s.rc;
    idx_map->resize(m);
    for (int64_t j = 0; j < m; j++) (*idx_map)[j] = (int32_t)idx[j];
    return true;
}

struct CMatch {
    std::vector<int32_t> ma, mb;
    const CSeq* a = nullptr;        // shared consensus
    CSeq b;
};

// seed_sequence.py bases_covered (seeds/sequence.go:830-858)
static void bases_covered(const std::vector<int32_t>& ma,
                          const std::vector<int32_t>& mb,
                          const CSeq& a, const CSeq& b, int32_t k,
                          int64_t* ca, int64_t* cb) {
    std::vector<int64_t> pa, pb;
    seed_positions(a, k, &pa);
    seed_positions(b, k, &pb);
    int64_t count_a = (int64_t)ma.size() * k, count_b = count_a;
    for (size_t i = 1; i < ma.size(); i++) {
        int64_t d1 = pa[ma[i]] - pa[ma[i - 1]] - k;
        int64_t d2 = pb[mb[i]] - pb[mb[i - 1]] - k;
        if (d1 < 0) count_a += d1;
        if (d2 < 0) count_b += d2;
    }
    *ca = count_a;
    *cb = count_b;
}

// seed_sequence.py get_base_index_scalar (seeds/sequence.go:1190)
static void get_base_index(const std::vector<int32_t>& ma,
                           const std::vector<int32_t>& mb,
                           const CSeq& sa, const CSeq& sb,
                           int64_t a_index, int32_t k,
                           int64_t* out_idx, int64_t* out_bases,
                           int64_t* out_dist) {
    int64_t before = 0;
    while (before < (int64_t)ma.size() && ma[before] <= a_index) before++;
    if (before == 0) {
        int64_t offset = 0;
        for (int64_t i = ma[0]; i > a_index; i--)
            offset += (int64_t)sa.gaps[i] + k;
        int64_t b_index = mb[0], distance = 0, i = b_index;
        while (i > 0 && offset > 0) {
            offset -= (int64_t)sb.gaps[i] + k;
            distance += (int64_t)sb.gaps[i] + k;
            b_index--; i--;
        }
        if (b_index == 0) {
            *out_idx = 0; *out_bases = -offset;
            *out_dist = distance + offset;
            return;
        }
        *out_idx = b_index; *out_bases = -offset; *out_dist = distance;
        return;
    }
    before--;
    int64_t b_index = mb[before];
    if (a_index == ma[before]) {
        *out_idx = b_index; *out_bases = 0; *out_dist = 0;
        return;
    }
    int64_t offset = 0;
    for (int64_t i = ma[before] + 1; i <= a_index; i++)
        offset += (int64_t)sa.gaps[i] + k;
    int64_t distance = 0;
    int64_t n = (int64_t)sb.seeds.size();
    int64_t i = b_index + 1;
    while (i < n + 1 && offset >= (int64_t)sb.gaps[i]) {
        offset -= (int64_t)sb.gaps[i] + k;
        distance += (int64_t)sb.gaps[i] + k;
        b_index++; i++;
    }
    if (b_index >= n) {
        *out_idx = b_index - 1; *out_bases = offset;
        *out_dist = distance + offset;
        return;
    }
    *out_idx = b_index; *out_bases = offset; *out_dist = distance + offset;
}

}  // namespace fc

namespace fc {

// seeds/msa.py consensus front half + the shared sweep: members reduced
// to seeds appearing in >= 2 members, swept by msa_consensus, matches
// with >= 3 pairs kept (seed indices mapped back through idx_map).
// Returns false when no consensus (< 2 usable matches).
static bool msa(const std::vector<CSeq>& seqs, int32_t k,
                CSeq* cons, std::vector<CMatch>* out) {
    int64_t n = (int64_t)seqs.size();
    int32_t max_seed = 0;
    for (const auto& s : seqs)
        for (int32_t sd : s.seeds)
            if (sd > max_seed) max_seed = sd;
    std::vector<uint8_t> seen(max_seed + 2, 0), use(max_seed + 2, 0);
    {
        std::vector<int32_t> mark(max_seed + 2, -1);
        for (int64_t i = 0; i < n; i++)
            for (int32_t sd : seqs[i].seeds)
                if (sd >= 0) {
                    if (mark[sd] == (int32_t)i) continue;
                    mark[sd] = (int32_t)i;
                    if (seen[sd]) use[sd] = 1; else seen[sd] = 1;
                }
    }
    std::vector<CSeq> reds(n);
    std::vector<std::vector<int32_t>> maps(n);
    std::vector<uint8_t> have(n, 0);
    std::vector<int32_t> seg;
    std::vector<int64_t> seg_off(n + 1, 0);
    int64_t total_seeds = 0;
    for (int64_t i = 0; i < n; i++) {
        if (reduced(seqs[i], use, k, 1, &reds[i], &maps[i])) {
            have[i] = 1;
            total_seeds += (int64_t)reds[i].seeds.size();
        }
    }
    for (int64_t i = 0; i < n; i++) {
        if (have[i]) {
            const CSeq& r = reds[i];
            for (size_t j = 0; j < r.seeds.size(); j++) {
                seg.push_back(r.gaps[j]);
                seg.push_back(r.seeds[j]);
            }
            seg.push_back(r.gaps.back());
        }
        seg_off[i + 1] = (int64_t)seg.size();
    }
    std::vector<int32_t> cons_buf(2 * total_seeds + 2);
    std::vector<int64_t> match_off(n + 1, 0);
    for (int64_t i = 0; i < n; i++)
        match_off[i + 1] = match_off[i]
            + (have[i] ? (int64_t)reds[i].seeds.size() : 0);
    std::vector<int32_t> ma_buf(match_off[n]), mb_buf(match_off[n]);
    std::vector<int64_t> cnt(n, 0);
    int64_t cons_len = msa_consensus(
        seg.data(), seg_off.data(), n, k, cons_buf.data(),
        ma_buf.data(), mb_buf.data(), match_off.data(), cnt.data());
    // cons SeedSequence.from_segments (+ trailing 0 gap)
    cons->gaps.clear(); cons->seeds.clear();
    for (int64_t j = 0; j + 1 < cons_len; j += 2) {
        cons->gaps.push_back(cons_buf[j]);
        cons->seeds.push_back(cons_buf[j + 1]);
    }
    cons->gaps.push_back(0);
    cons->offset = cons->inset = 0;
    cons->id = -1; cons->rc = false; cons->root_len = 0;
    int64_t L = 0;
    for (int32_t g : cons->gaps) L += g;
    cons->length = L + (int64_t)cons->seeds.size() * k;
    out->clear();
    for (int64_t i = 0; i < n; i++) {
        if (!have[i] || cnt[i] < 3) continue;
        CMatch m;
        m.ma.assign(ma_buf.begin() + match_off[i],
                    ma_buf.begin() + match_off[i] + cnt[i]);
        m.mb.resize(cnt[i]);
        for (int64_t j = 0; j < cnt[i]; j++)
            m.mb[j] = maps[i][mb_buf[match_off[i] + j]];
        m.b = seqs[i];
        out->push_back(std::move(m));
    }
    return out->size() > 1;
}

// overlap/combine.py trim_to_best_seed (overlap/combine.go:21-111)
static void trim_to_best_seed(int64_t upto, std::vector<CMatch>* ms,
                              int64_t min_match, int32_t k,
                              CSeq* consensus, std::vector<CSeq>* parts) {
    int64_t nm = (int64_t)ms->size();
    parts->resize(nm);
    int64_t best_count = 0, best_score = 0, best_index = upto;
    int64_t back_count = 0, back_score = 0;
    const CSeq& a0 = *(*ms)[0].a;
    int64_t length = (int64_t)a0.seeds.size();
    int64_t back_index = length - upto - 1;
    for (int64_t i = 0; i < upto; i++) {
        int64_t count = 0, b_count = 0;
        for (const auto& match : *ms) {
            for (int32_t index : match.ma) {
                if (index == i) count++;
                if (index >= i) break;
            }
            for (int64_t j = (int64_t)match.ma.size() - 1; j > 0; j--) {
                int64_t index = match.ma[j];
                if (index == length - 1 - i) b_count++;
                if (index <= length - 1 - i) break;
            }
        }
        if (count - i >= best_score
                || (best_count < min_match && count >= min_match)) {
            best_count = count; best_score = count - i; best_index = i;
        }
        if (b_count - i >= back_score
                || (back_count < min_match && b_count >= min_match)) {
            back_count = b_count; back_score = b_count - i;
            back_index = length - 1 - i;
        }
    }
    *consensus = trimmed(a0, 0, best_index, 0, back_index, k);
    for (int64_t j = 0; j < nm; j++) {
        CMatch& match = (*ms)[j];
        int64_t index, bases, front_distance;
        get_base_index(match.ma, match.mb, a0, match.b, best_index, k,
                       &index, &bases, &front_distance);
        int64_t b_index, back_bases, back_distance;
        get_base_index(match.ma, match.mb, a0, match.b, back_index, k,
                       &b_index, &back_bases, &back_distance);
        if (bases > -k && index < (int64_t)match.b.seeds.size() - 1) {
            bases = (int64_t)match.b.gaps[index + 1] + k - bases;
            index++;
        } else if (bases < 0) {
            bases = -bases + k;
        }
        (*parts)[j] = trimmed(match.b, bases, index, back_bases, b_index,
                              k);
        match.b = (*parts)[j];
        int64_t front = 0;
        while (front < (int64_t)match.mb.size() && match.mb[front] < index)
            front++;
        int64_t back = (int64_t)match.mb.size() - 1;
        while (back >= 0 && match.mb[back] > b_index) back--;
        while (front <= back && match.ma[front] < best_index) front++;
        while (back >= front && match.ma[back] > back_index) back--;
        std::vector<int32_t> na, nb;
        if (front <= back) {
            na.assign(match.ma.begin() + front,
                      match.ma.begin() + back + 1);
            nb.assign(match.mb.begin() + front,
                      match.mb.begin() + back + 1);
            for (auto& v : na) v -= (int32_t)best_index;
            for (auto& v : nb) v -= (int32_t)index;
        }
        match.ma = std::move(na);
        match.mb = std::move(nb);
    }
}

}  // namespace fc

// One round's final checks.  Sequence table: sseg/sseg_off interleaved
// segments; smeta [ns, 6] int64 (id, offset, inset, length, rc,
// root_len).  Matches flattened per check via chk_off; each match
// carries (ia, ib) table indices, rc_query, and ma/mb pair lists via
// m_off.  Output per kept part: 6 int64 (id, rc, offset, length,
// seq_len, ident) at out_rec; out_cnt[c] parts for check c (0 = no
// contig).  Returns total parts written, or -1 on capacity overflow.
extern "C" int64_t final_check_round(
    const int32_t* sseg, const int64_t* sseg_off, const int64_t* smeta,
    const int64_t* chk_off, const int32_t* m_ia, const int32_t* m_ib,
    const uint8_t* m_rcq, const int32_t* ma_flat, const int32_t* mb_flat,
    const int64_t* m_off, const int32_t* rc_lut, int64_t n_checks,
    int32_t k, int64_t* out_cnt, int64_t* out_rec, int64_t cap_parts) {
    using namespace fc;
    auto load_seq = [&](int64_t si) {
        CSeq s;
        const int32_t* p = sseg + sseg_off[si];
        int64_t len = sseg_off[si + 1] - sseg_off[si];
        int64_t nseeds = (len - 1) / 2;
        s.gaps.resize(nseeds + 1);
        s.seeds.resize(nseeds);
        for (int64_t j = 0; j < nseeds; j++) {
            s.gaps[j] = p[2 * j];
            s.seeds[j] = p[2 * j + 1];
        }
        s.gaps[nseeds] = p[2 * nseeds];
        const int64_t* m = smeta + si * 6;
        s.id = m[0]; s.offset = m[1]; s.inset = m[2]; s.length = m[3];
        s.rc = m[4] != 0; s.root_len = m[5];
        return s;
    };
    // independent per-check work, fanned out over a thread pool (no
    // GIL here): each check writes its parts at fixed slot base
    // chk_off[c] (parts <= match count), the caller compacts.
    auto run_check = [&](int64_t c) {
        out_cnt[c] = 0;
        int64_t m0 = chk_off[c], m1 = chk_off[c + 1];
        if (m1 - m0 < 2) return;
        // RC-normalize (combine.py build_consensus head)
        std::vector<std::vector<int32_t>> mas, mbs;
        std::vector<CSeq> sas, sbs;
        for (int64_t mi = m0; mi < m1; mi++) {
            CSeq a = load_seq(m_ia[mi]);
            CSeq b = load_seq(m_ib[mi]);
            std::vector<int32_t> ma(ma_flat + m_off[mi],
                                    ma_flat + m_off[mi + 1]);
            std::vector<int32_t> mb(mb_flat + m_off[mi],
                                    mb_flat + m_off[mi + 1]);
            if (m_rcq[mi]) {
                a = seq_rc(a, rc_lut);
                b = seq_rc(b, rc_lut);
                int64_t la = (int64_t)a.seeds.size() - 1;
                int64_t lb = (int64_t)b.seeds.size() - 1;
                std::vector<int32_t> ra(ma.rbegin(), ma.rend());
                std::vector<int32_t> rb(mb.rbegin(), mb.rend());
                for (auto& v : ra) v = (int32_t)(la - v);
                for (auto& v : rb) v = (int32_t)(lb - v);
                ma = std::move(ra); mb = std::move(rb);
            }
            mas.push_back(std::move(ma));
            mbs.push_back(std::move(mb));
            sas.push_back(std::move(a));
            sbs.push_back(std::move(b));
        }
        const CSeq& a0 = sas[0];
        std::vector<CSeq> seqs;
        for (size_t i = 0; i < sas.size(); i++) {
            int64_t ca, cb;
            bases_covered(mas[i], mbs[i], sas[i], sbs[i], k, &ca, &cb);
            if (ca < 25 || cb < 25) continue;
            seqs.push_back(trimmed(
                sbs[i], seed_offset(a0, mas[i][0], k), mbs[i][0],
                seed_offset_from_end(a0, mas[i].back(), k),
                mbs[i].back(), k));
        }
        if (seqs.size() <= 1) return;
        CSeq cons;
        std::vector<CMatch> ms;
        if (!msa(seqs, k, &cons, &ms)) return;
        for (auto& m : ms) m.a = &cons;
        int64_t min_match = std::min<int64_t>(5, (int64_t)ms.size());
        CSeq trimmed_cons;
        std::vector<CSeq> parts;
        trim_to_best_seed((int64_t)cons.seeds.size() / 4, &ms, min_match,
                          k, &trimmed_cons, &parts);
        for (auto& m : ms) m.a = &trimmed_cons;
        int64_t np = (int64_t)parts.size();
        out_cnt[c] = np;
        for (int64_t j = 0; j < np; j++) {
            const CSeq& part = parts[j];
            int64_t* r = out_rec + (m0 + j) * 6;
            r[0] = part.id;
            r[1] = part.rc ? 1 : 0;
            r[2] = part.offset;
            r[3] = part.root_len - part.offset - part.inset;
            r[4] = part.root_len;
            // _final_check's ident for part pid uses matches[pid-1]
            // (the reference's own off-by-one; parity kept)
            if (j >= 1) {
                int64_t ca, cb;
                bases_covered(ms[j - 1].ma, ms[j - 1].mb, trimmed_cons,
                              ms[j - 1].b, k, &ca, &cb);
                r[5] = ca;
            } else {
                r[5] = 0;
            }
        }
    };
    int64_t nthreads = (int64_t)std::thread::hardware_concurrency();
    if (nthreads > 16) nthreads = 16;
    if (nthreads < 1) nthreads = 1;
    if (nthreads == 1 || n_checks < 8) {
        for (int64_t c = 0; c < n_checks; c++) run_check(c);
    } else {
        std::atomic<int64_t> next(0);
        std::vector<std::thread> pool;
        for (int64_t t = 0; t < nthreads; t++)
            pool.emplace_back([&]() {
                for (;;) {
                    int64_t c = next.fetch_add(1);
                    if (c >= n_checks) break;
                    run_check(c);
                }
            });
        for (auto& th : pool) th.join();
    }
    int64_t total = 0;
    for (int64_t c = 0; c < n_checks; c++) total += out_cnt[c];
    (void)cap_parts;
    return total;
}
