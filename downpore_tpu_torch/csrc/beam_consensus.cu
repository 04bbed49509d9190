// Fixed-beam DTW consensus for Hopper (sm_90a): one thread block per job.
//
// Replaces downpore_tpu/ops/pallas_beam.py:_kernel (pallas_consensus_records
// with _records_to_chains), which computes exactly what the XLA engine
// downpore_tpu/ops/dtw.py:device_consensus computes, step for step: the
// static-window k-mer fetch (_win_base, WINW = 512), the simple-k or table
// distance, the REG_SLACK = 64 regularizer, the 32-wide band update of
// every (beam state, branch, member), votes with the `ahead` mask, quality
// decay 0.95, duplicate suppression, top-B by (cost, candidate index), the
// parent gather, drift recentring and the finish test, with one
// (kmer, parent, fin, cost) record per step; then _device_traceback.
//
// What bounds it: latency, not bandwidth or arithmetic.  A job is a chain
// of ~1.3 L dependent steps over a few KB of state, and each step is small
// (4 B candidates x N members x 32 lanes of integer work).  The Pallas
// kernel packed 32 jobs into one grid cell and moved data with roll
// cascades and barrel selects to fit Mosaic's layouts.  Here a job's whole
// state stays on one SM for the scan:
//
//  * each warp owns one (beam state, branch) candidate at a time and loops
//    over the members; lane i owns band lane i, so the band's neighbour
//    terms are shuffles and its minimum and _argmin_last warp reductions
//    (band.cuh).  Member k-mers are read straight from device memory at
//    o + lane (L2-resident, coalesced): no window matrix;
//  * only the candidates' costs are kept; after selection the B chosen
//    (parent, branch) bands and votes are computed again, which keeps
//    shared memory at 2 x B x N x 32 int16 plus positions and quality for
//    any N (and puts that state in a device scratch where even it does not
//    fit);
//  * one warp does duplicate suppression and top-B over the 4 B <= 32
//    candidates, one candidate per lane;
//  * a block stops after the first step at which one of its beams is
//    finished and walks the traceback itself: _device_traceback reads
//    nothing past that step.  In records mode it runs all T steps instead,
//    as the XLA engine does, so every record row is defined.
//
// Exactness hazards handled here:
//  * top-B ties go to the lower candidate index (jax.lax.top_k);
//  * _argmin_last ties go to the highest lane (band.cuh);
//  * votes and quality are float32 with no contraction: __fmul_rn/__fadd_rn;
//  * costs add in wrapping int32 arithmetic, as the reference's int32 do;
//  * dead lanes take distance FULL: every add saturates at FULL, so this
//    equals the XLA engine's BIG // 64.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "band.cuh"

namespace {

constexpr int W = 32;
constexpr int CENTRE = W / 2;
constexpr int PAD = W;
constexpr int INIT = 8;          // initialOffset (ref: alignment.go:15)
constexpr int REG_SLACK = 64;    // ops/dtw.py:REG_SLACK
constexpr int FULL = 0x7FFF;     // ops/dtw.py:FULL
constexpr int BIG = 1 << 28;     // ops/dtw.py:BIG
constexpr int kMaxWarps = 16;

struct Params {
  const int* seqs;               // [J, N, L] int32, -1 fill
  const int* lens;               // [J, N]
  const int* firsts;             // [J]
  const uint16_t* table;         // [4^k, 4^k] or null (simple_k > 0)
  int* chains;                   // [J, T]
  int* n_valid;                  // [J]
  int* rec;                      // [J, T, 4, B]: kmer, parent, fin, cost
  unsigned char* scratch;        // [J, member_bytes] or null (shared)
  long long member_bytes;
  int N, L, T, k, B, threshold, gap_cost, simple_k, sw, hi, early_exit;
};

// ops/dtw.py:_simple_distance: position-weighted XOR mismatch cost, the
// (shift, weight) schedule of align.measures.build_simple_table.
__device__ __forceinline__ int simple_distance(int a, int b, int k) {
  const int d = a ^ b;
  auto bit = [d](int sh) { return ((d >> sh) | (d >> (sh + 1))) & 1; };
  switch (k) {
    case 5: return bit(4) * 8 + bit(6) * 2 + bit(2) * 2 + bit(0) + bit(8);
    case 4: return bit(4) * 4 + bit(2) * 4 + bit(6) * 2 + bit(0) * 2;
    case 3: return bit(2) * 8 + bit(4) * 2 + bit(0) * 2;
    case 6:
      return bit(4) * 4 + bit(6) * 4 + bit(2) * 2 + bit(8) * 2 + bit(0) +
             bit(10);
    default: return bit(0) * 8;  // k == 1 (the wrapper checks k)
  }
}

// Per-member state of one job, double-buffered: bands, positions and
// quality.
struct Members {
  short* bands;      // [2][B][N][W]; values lie in [0, FULL]
  int* pos;          // [2][B][N]
  float* qual;       // [2][B][N]
};

__host__ __device__ inline long long members_bytes(int N, int B) {
  const long long bn = (long long)B * N;
  const long long bytes = 2 * bn * 4 + 2 * bn * 4 + 2 * bn * W * 2;
  return (bytes + 15) / 16 * 16;
}

__device__ inline Members carve_members(unsigned char* base, int N, int B) {
  const long long bn = (long long)B * N;
  Members m;
  m.pos = reinterpret_cast<int*>(base);
  m.qual = reinterpret_cast<float*>(base + 2 * bn * 4);
  m.bands = reinterpret_cast<short*>(base + 4 * bn * 4);
  return m;
}

// Small per-job state, always in shared memory (ints).
__host__ __device__ inline int small_ints(int B) {
  // kmer, cost, fin (x2 buffers), cand_cost (4B), parent, branch,
  // new_cost, new_kmer, fin_flag (B each), control (4)
  return 6 * B + 4 * B + 5 * B + 4;
}

// Window base of ops/dtw.py:_win_base: 128-aligned, clipped before the
// division so the operand is non-negative.
__device__ __forceinline__ int win_base(int t, int sw, int hi) {
  int x = t + 25 + 64 - sw / 2;
  x = x < 0 ? 0 : (x > hi ? hi : x);
  return (x / 128) * 128;
}

// Band step of candidate (beam b, next k-mer nk) for member n at step t.
// Returns the new band lane; *m the band minimum, *ex the exact vote.
__device__ __forceinline__ int candidate_band(
    const Params& p, const int* seq_n, int pos2, int poff, int nk, int t,
    int wb, int lane, int* m, bool* ex) {
  const int o = pos2 - CENTRE + PAD;
  const bool ov = o >= 0 && o < p.L + PAD && o - wb >= 0 && o - wb <= p.sw - W;
  const int idx = pos2 - CENTRE + lane;  // member k-mer under this lane
  int km = -1;
  if (ov && idx >= 0 && idx < p.L) km = seq_n[idx];
  int d = FULL;
  if (km >= 0) {
    const int dist = p.simple_k
        ? simple_distance(nk, km, p.simple_k)
        : (int)p.table[(size_t)nk * ((size_t)1 << (2 * p.k)) + km];
    int extra = abs(idx - (INIT + 1 + t)) - REG_SLACK;
    extra = extra > 0 ? extra : 0;
    d = band::wrap_add(dist, extra);
  }
  const int out = band::step<FULL>(poff, d, lane, p.threshold, true, m);
  const int bl = band::argmin_last(poff, lane);
  *ex = __any_sync(band::kFullMask, d == 0 && out < FULL && lane >= bl);
  return out;
}

__global__ void beam_consensus_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int job = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int N = p.N, B = p.B, L = p.L, T = p.T;
  const int NC = 4 * B;
  const int mask_k = (1 << (2 * p.k)) - 1;

  int* s_kmer = reinterpret_cast<int*>(smem);  // [2][B]
  int* s_cost = s_kmer + 2 * B;                // [2][B]
  int* s_fin = s_cost + 2 * B;                 // [2][B]
  int* s_cand = s_fin + 2 * B;                 // [4B]
  int* s_parent = s_cand + NC;                 // [B]
  int* s_branch = s_parent + B;
  int* s_ncost = s_branch + B;
  int* s_nkmer = s_ncost + B;
  int* s_flag = s_nkmer + B;
  int* s_ctl = s_flag + B;                     // [0] = done, [1] = t_end
  unsigned char* mem_base =
      p.scratch ? p.scratch + (size_t)job * p.member_bytes
                : smem + ((small_ints(B) * 4 + 15) / 16) * 16;
  Members M = carve_members(mem_base, N, B);

  const int* seqs = p.seqs + (size_t)job * N * L;
  const int* lens = p.lens + (size_t)job * N;
  int* rec = p.rec + (size_t)job * T * 4 * B;
  const int first = p.firsts[job];

  // ---- initial state (ops/dtw.py:device_consensus) ----------------------
  for (int i = warp; i < B * N; i += nwarps) {
    const int n = i % N;
    int v = p.gap_cost;
    if (lane < INIT) v = FULL;
    if (lane == INIT && seqs[(size_t)n * L] == first) v = 0;
    M.bands[(size_t)i * W + lane] = (short)v;
    if (lane == 0) {
      M.pos[i] = INIT;
      M.qual[i] = 1.0f;
    }
  }
  if (threadIdx.x < B) {
    s_kmer[threadIdx.x] = first;
    s_cost[threadIdx.x] = threadIdx.x == 0 ? 0 : BIG;
    s_fin[threadIdx.x] = 0;
  }
  if (threadIdx.x == 0) {
    s_ctl[0] = 0;
    s_ctl[1] = T - 1;
  }
  __syncthreads();

  int cur = 0;
  for (int t = 0; t < T; ++t) {
    const int nxt = cur ^ 1;
    const int wb = win_base(t, p.sw, p.hi);
    const int* kmer = s_kmer + cur * B;
    const int* cost = s_cost + cur * B;
    const int* fin = s_fin + cur * B;
    const short* bands = M.bands + (size_t)cur * B * N * W;
    const int* pos = M.pos + cur * B * N;
    const float* qual = M.qual + cur * B * N;

    // ---- phase A: every candidate's cost and exact votes ----------------
    for (int c = warp; c < NC; c += nwarps) {
      const int b = c >> 2;
      int cc;
      if (fin[b]) {
        cc = (c & 3) == 0 ? cost[b] : BIG;  // frozen: only branch 0 lives
      } else {
        const int nk = ((kmer[b] << 2) & mask_k) | (c & 3);
        int seq_cost = 0;
        bool vote = false;
        for (int n = 0; n < N; ++n) {
          const int bn = b * N + n;
          int m;
          bool ex;
          candidate_band(p, seqs + (size_t)n * L, pos[bn] + 1,
                         bands[(size_t)bn * W + lane], nk, t, wb, lane, &m,
                         &ex);
          if (lens[n] > 0) seq_cost = band::wrap_add(seq_cost, m);
          const float vw =
              floorf(__fadd_rn(__fmul_rn(8.0f, qual[bn]), 0.5f));
          vote = vote || (ex && vw > 0.0f);
        }
        cc = vote ? band::wrap_add(cost[b], seq_cost) : BIG;
      }
      if (lane == 0) s_cand[c] = cc;
    }
    __syncthreads();

    // ---- phase B: duplicate suppression and top-B (one warp) ------------
    if (warp == 0) {
      const bool live = lane < NC;
      const int cb = live ? lane >> 2 : 0;
      const bool pf = live && fin[cb] != 0;
      const int ck = pf ? kmer[cb] : (((kmer[cb] << 2) & mask_k) | (lane & 3));
      const int cc = live ? s_cand[lane] : 0;
      bool dup = false;
      for (int b2 = 0; b2 < B; ++b2) {  // against live parent-generation
        dup = dup || (ck == kmer[b2] && cost[b2] <= cc && !fin[b2] &&
                      b2 != cb);
      }
      for (int j = 0; j < NC; ++j) {    // against better candidates
        const int ckj = __shfl_sync(band::kFullMask, ck, j);
        const int ccj = __shfl_sync(band::kFullMask, cc, j);
        const bool pfj = __shfl_sync(band::kFullMask, (int)pf, j) != 0;
        dup = dup || (ck == ckj && (ccj < cc || (ccj == cc && j < lane)) &&
                      !pfj);
      }
      const int fc = (dup && !pf) ? BIG : cc;
      bool taken = !live;
      for (int i = 0; i < B; ++i) {
        const int mn = __reduce_min_sync(band::kFullMask,
                                         taken ? INT_MAX : fc);
        const int sel = __reduce_min_sync(
            band::kFullMask, (!taken && fc == mn) ? lane : 64);
        if (lane == sel) {
          taken = true;
          const int par = sel >> 2, br = sel & 3;
          s_parent[i] = par;
          s_branch[i] = br;
          s_ncost[i] = fc;
          s_nkmer[i] = fin[par] ? kmer[par]
                                : (((kmer[par] << 2) & mask_k) | br);
          s_flag[i] = 0;
        }
      }
    }
    __syncthreads();

    // ---- phase C: the selected bands, recentred; the finish test --------
    short* nbands = M.bands + (size_t)nxt * B * N * W;
    int* npos = M.pos + nxt * B * N;
    float* nqual = M.qual + nxt * B * N;
    for (int i = warp; i < B * N; i += nwarps) {
      const int b = i / N, n = i % N;
      const int par = s_parent[b];
      const int pn = par * N + n;
      int off, np;
      float q;
      if (fin[par]) {  // frozen states carry through unchanged
        off = bands[(size_t)pn * W + lane];
        np = pos[pn];
        q = qual[pn];
      } else {
        int m;
        bool ex;
        const int nk = ((kmer[par] << 2) & mask_k) | s_branch[b];
        np = pos[pn] + 1;
        off = candidate_band(p, seqs + (size_t)n * L, np,
                             bands[(size_t)pn * W + lane], nk, t, wb, lane,
                             &m, &ex);
        q = ex ? 1.0f : __fmul_rn(qual[pn], 0.95f);
        // drift recentring (ref: alignment.go:245-273)
        const int bp = band::argmin_last(off, lane);
        const int drift = CENTRE - bp;
        const bool recentre = abs(drift) > 4;
        const int shift = recentre ? drift : 0;
        const int src = lane - shift;
        const int moved = __shfl_sync(band::kFullMask, off, src & 31);
        off = (src >= 0 && src < W) ? moved : FULL;
        np -= shift;
        const int best_lane = recentre ? CENTRE : bp;
        const int seq_pos = np + best_lane - CENTRE;
        if (lane == 0 && lens[n] > 0 && seq_pos >= lens[n] - 1) s_flag[b] = 1;
      }
      nbands[(size_t)i * W + lane] = (short)off;
      if (lane == 0) {
        npos[i] = np;
        nqual[i] = q;
      }
    }
    __syncthreads();

    // ---- phase D: commit the small state and the record row -------------
    if (warp == 0) {
      bool any = false;
      if (lane < B) {
        const int nf = (fin[s_parent[lane]] || s_flag[lane]) ? 1 : 0;
        s_kmer[nxt * B + lane] = s_nkmer[lane];
        s_cost[nxt * B + lane] = s_ncost[lane];
        s_fin[nxt * B + lane] = nf;
        int* r = rec + (size_t)t * 4 * B;
        r[lane] = s_nkmer[lane];
        r[B + lane] = s_parent[lane];
        r[2 * B + lane] = nf;
        r[3 * B + lane] = s_ncost[lane];
        any = nf != 0;
      }
      any = __any_sync(band::kFullMask, any);
      if (lane == 0 && any && s_ctl[0] == 0) {
        s_ctl[1] = t;                    // first step with a finished beam
        if (p.early_exit) s_ctl[0] = 1;
        else s_ctl[0] = 2;               // keep stepping, t_end is fixed
      }
    }
    __syncthreads();
    cur = nxt;
    if (s_ctl[0] == 1) break;
  }

  // ---- traceback (ops/dtw.py:_device_traceback) -------------------------
  const int t_end = s_ctl[1];
  const bool has = s_ctl[0] != 0;
  int* chain = p.chains + (size_t)job * T;
  for (int t = t_end + 1 + threadIdx.x; t < T; t += blockDim.x) chain[t] = -1;
  if (threadIdx.x == 0) {
    const int* row = rec + (size_t)t_end * 4 * B;
    int b = 0, best = 0;
    for (int i = 0; i < B; ++i) {  // argmin, first on ties
      const int v = (has && !row[2 * B + i]) ? BIG : row[3 * B + i];
      if (i == 0 || v < best) {
        best = v;
        b = i;
      }
    }
    for (int t = t_end; t >= 0; --t) {
      const int* r = rec + (size_t)t * 4 * B;
      chain[t] = r[b];
      b = r[B + b];
    }
    p.n_valid[job] = t_end + 1;
  }
}

}  // namespace

extern "C" {

// Bytes of per-member state one job needs (placed in shared memory when it
// fits, else in a device scratch of J times this size).
long long beam_consensus_member_bytes(int N, int B) {
  return members_bytes(N, B);
}

// Largest dynamic shared memory a block may use on the current device.
int beam_consensus_max_smem() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return v;
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).  seqs is
// [J, N, L], lens [J, N], firsts [J], chains [J, T], n_valid [J], rec
// [J, T, 4, B], all int32 and contiguous on the current device; table is
// the uint16 [4^k, 4^k] distance table when simple_k == 0; scratch is null
// or J * beam_consensus_member_bytes(N, B) bytes.  sw / hi are
// ops/dtw.py:_win_params(L).  early_exit = 0 runs all T steps.
int beam_consensus_launch(const int* seqs, const int* lens, const int* firsts,
                          const void* table, int* chains, int* n_valid,
                          int* rec, void* scratch, int J, int N, int L, int T,
                          int k, int B, int threshold, int gap_cost,
                          int simple_k, int sw, int hi, int early_exit,
                          void* stream) {
  if (J <= 0) return (int)cudaSuccess;
  if (B < 1 || 4 * B > 32 || N < 1 || L < 1 || T < 1 || k < 1 || k > 7)
    return (int)cudaErrorInvalidValue;
  if (simple_k == 0 && table == nullptr) return (int)cudaErrorInvalidValue;
  Params p;
  p.seqs = seqs;
  p.lens = lens;
  p.firsts = firsts;
  p.table = static_cast<const uint16_t*>(table);
  p.chains = chains;
  p.n_valid = n_valid;
  p.rec = rec;
  p.scratch = static_cast<unsigned char*>(scratch);
  p.member_bytes = members_bytes(N, B);
  p.N = N;
  p.L = L;
  p.T = T;
  p.k = k;
  p.B = B;
  p.threshold = threshold;
  p.gap_cost = gap_cost;
  p.simple_k = simple_k;
  p.sw = sw;
  p.hi = hi;
  p.early_exit = early_exit;
  size_t smem = (size_t)((small_ints(B) * 4 + 15) / 16) * 16;
  if (!scratch) smem += (size_t)p.member_bytes;
  const int max_smem = beam_consensus_max_smem();
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      beam_consensus_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int warps = 4 * B < kMaxWarps ? 4 * B : kMaxWarps;
  beam_consensus_kernel<<<(unsigned)J, warps * 32, smem,
                          (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

const char* beam_consensus_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
