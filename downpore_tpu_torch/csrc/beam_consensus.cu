// Fixed-beam DTW consensus for Hopper (sm_90a): one thread block per job,
// the work of every step spread over the block's warps.
//
// Replaces downpore_tpu/ops/pallas_beam.py:_kernel (pallas_consensus_records
// with _records_to_chains, pallas_consensus), which computes exactly what
// the XLA engine downpore_tpu/ops/dtw.py:device_consensus computes, step for
// step: the static-window k-mer fetch (_win_base, WINW = 512), the simple-k
// or table distance, the REG_SLACK = 64 regularizer, the 32-wide band
// update of every (beam state, branch, member), votes with the `ahead`
// mask, quality decay 0.95, drift recentring, duplicate suppression, top-B
// by (cost, candidate index) and the finish test, with one (kmer, parent,
// fin, cost) record per step; then _device_traceback.
//
// What bounds it: latency, not bytes or operations.  A job is a chain of
// up to 1.3 L + 32 dependent steps over a few KB of state, and `correct`
// gives the kernel 1-2 jobs a launch, so one SM per job does all the work
// and a step's time is its critical path: the (beam state, member) tasks
// of phase A, bound by the instruction rate of the SM's 4 schedulers (a
// few hundred warp instructions a task, B x N tasks), then the selection,
// a chain of ~20 dependent shared-memory loads, shuffles and votes, then a
// barrier.
// The design shortens both, and keeps the SMs busy where there are many
// jobs:
//
//  * a warp task is one (beam state b, member n) pair and does its 4
//    branches together: the member's k-mers under the band, the previous
//    band, its _argmin_last and the `stay` neighbour depend on (b, n) only,
//    and for the simple-k measure so does every term of the distance but
//    the lowest base's (summed as popcounts under per-weight masks), so
//    each is computed once; the 4 band updates are independent chains the
//    warp interleaves.  The B x N tasks of a step spread over up to 32
//    warps (ops/cuda_beam.py:beam_warps picks the count from the number of
//    jobs: many jobs get fewer warps each and still fill the card).  Lane
//    i owns band lane i: neighbour terms are shuffles; one reduction of
//    raw * 64 + (31 - lane) gives the row minimum and _argmin_last of the
//    new band (bands lie in [0, FULL]: the wrapper checks gap_cost >= 0
//    and threshold >= 1);
//  * every candidate's band, position and quality is kept in a double-
//    buffered candidate store in shared memory, with the recentring shift
//    its own band asks for; the next step's beam state reads the candidate
//    it selected (an index) and applies the shift as it loads it, so
//    nothing is recomputed after selection and only kept bands are
//    shifted.  A candidate's member costs and votes meet in shared memory:
//    the cost is a wrapping int32 sum (atomicAdd) and the vote and finish
//    flags ORs, exact in any order, so the result does not depend on how
//    the tasks are spread;
//  * the static window (the N x sw k-mers that _win_base selects; its base
//    moves at most every 128 steps) is staged in shared memory as int16
//    (k <= 7: codes < 2^14; -1 stays -1) and restaged only when the base
//    moves;
//  * the selection is spread over the warps: warp w takes candidates
//    c = w, w + nwarps, ..., its lane j holds candidate j (and lane b < B
//    beam slot b), so c's duplicate flags are one vote and its rank (the
//    candidates j with c_j < c_c, or c_j = c_c and j < c: the stable sort
//    of beam_consensus_plain) one ballot; the warp of a candidate of rank
//    r < B commits slot r and its record row.  The selection's statements
//    are branch-free (short-circuit forms compiled to a branch a term).
//    Three block barriers a step: after phase A, after the duplicate
//    flags, after the commit;
//  * members with no k-mers (lens 0, bucket padding) are dropped at the
//    start: they add nothing to costs, votes or the finish test;
//  * where the candidate store, window and parent rows do not fit in
//    shared memory (hundreds of members), the store lives in a device
//    scratch and k-mers are read from device memory: a size route inside
//    the kernel (a template instance), same arithmetic;
//  * one launch takes a ragged set of jobs: each job has its own member
//    count N, length L, step count T and window (sw, hi), so a call with
//    several (N, L) buckets is one launch whose jobs run side by side;
//  * a block stops after the first step at which one of its beams is
//    finished and walks the traceback over the parent rows it kept in
//    shared memory: _device_traceback reads nothing past that step.  In
//    records mode it runs all T steps instead, as the XLA engine does.
//
// Exactness hazards handled here:
//  * top-B ties go to the lower candidate index (jax.lax.top_k);
//  * _argmin_last ties go to the highest lane (band.cuh);
//  * votes and quality are float32 with no contraction: __fmul_rn/__fadd_rn;
//  * costs add in wrapping int32 arithmetic, as the reference's int32 do;
//  * dead lanes take distance FULL: every add saturates at FULL, so this
//    equals the XLA engine's BIG // 64;
//  * a kept band's recentring applied at the next load equals the
//    reference's recentring after selection: the finish test's position,
//    pos + 1 + bp - CENTRE, is the same with or without the shift.

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
constexpr int kMaxWarps = 32;
constexpr int MAX_B = 8;         // 4 B candidates fit one warp
constexpr int META = 8;          // seq_off, lens_off, N, L, T, sw, hi, -
constexpr unsigned FM = band::kFullMask;

// The simple-k measure's weights as masks of even bits (simple_masks).
struct SimpleMasks {
  int m8, m4, m2, m1, w0;
};

// s_ctl slots
constexpr int C_NLIVE = 0, C_ANY = 1;  // C_ANY: a kept state finished

struct Params {
  const int* seqs;               // job j's [N, L] block at meta[j][0]
  const int* lens;               // job j's [N] at meta[j][1]
  const int* firsts;             // [J]
  const long long* meta;         // [J, META]
  const uint16_t* table;         // [4^k, 4^k] or null (simple_k > 0)
  int* chains;                   // [J, T_max]
  int* n_valid;                  // [J]
  int* rec;                      // [J, T_max, 4, B]: kmer, parent, fin, cost
  unsigned char* scratch;        // [J, cand_bytes] or null (shared route)
  long long cand_bytes;
  int N_max, T_max, sw_max, k, B, threshold, gap_cost, simple_k, early_exit;
  SimpleMasks sm;
};

// ops/dtw.py:_simple_distance, the (shift, weight) schedule of
// align.measures.build_simple_table: the sum over its shifts s of weight
// x bit(s), bit(s) = ((d >> s) | (d >> (s + 1))) & 1 of the XOR d = a ^ b.
// For a = pk | br (pk's low bits 0) every term but shift 0's depends on
// (pk, b) only: the distance is simple_high(pk ^ b) + (br != (b & 3) ? w0 :
// 0).  simple_high sums the other terms as popcounts of the even bits under
// one mask per weight (SimpleMasks, made on the host from k).
__host__ inline SimpleMasks simple_masks(int k) {
  switch (k) {
    case 5: return {1 << 4, 0, (1 << 6) | (1 << 2), 1 << 8, 1};
    case 4: return {0, (1 << 4) | (1 << 2), 1 << 6, 0, 2};
    case 3: return {1 << 2, 0, 1 << 4, 0, 2};
    case 6: return {0, (1 << 4) | (1 << 6), (1 << 2) | (1 << 8), 1 << 10, 1};
    default: return {0, 0, 0, 0, 8};  // k == 1 (the wrapper checks k)
  }
}

__device__ __forceinline__ int simple_high(int d, const SimpleMasks& m) {
  const int x = d | (d >> 1);
  return (__popc(x & m.m8) << 3) + (__popc(x & m.m4) << 2) +
         (__popc(x & m.m2) << 1) + __popc(x & m.m1);
}

__host__ __device__ inline long long align16(long long x) {
  return (x + 15) / 16 * 16;
}

// Shared-memory ints before the candidate store: the beam (kmer, cost,
// fin, src: MAX_B each), the candidate accumulators (cost, vote, fin) and
// the costs after suppression (4 MAX_B each), control (4) and the live
// members' indices and lengths (N_max each).
__host__ __device__ inline long long small_bytes(int N_max) {
  return align16((20LL * MAX_B + 4 + 2LL * N_max) * 4);
}

// The candidate store: two buffers of 4B x N_max entries (position, shift,
// quality, band of 32 int16).
__host__ __device__ inline long long cand_bytes(int N_max, int B) {
  const long long n = 2LL * 4 * B * N_max;
  return align16(n * 12 + n * W * 2);
}

__host__ __device__ inline long long window_bytes(int N_max, int sw_max) {
  return align16(2LL * N_max * sw_max);
}

__host__ __device__ inline long long parent_bytes(int T_max, int B) {
  return align16((long long)T_max * B);
}

// Shared memory of the shared route (everything on chip).
__host__ inline long long shared_route_bytes(int N_max, int B, int sw_max,
                                             int T_max) {
  return small_bytes(N_max) + cand_bytes(N_max, B) +
         window_bytes(N_max, sw_max) + parent_bytes(T_max, B);
}

struct Cand {
  int* pos;          // [2][4B][N_max]: position after the shift
  int* shift;        // [2][4B][N_max]: recentring shift of the band
  float* qual;       // [2][4B][N_max]
  short* bands;      // [2][4B][N_max][W], before the shift; in [0, FULL]
};

__device__ inline Cand carve_cand(unsigned char* base, int N_max, int B) {
  const long long n = 2LL * 4 * B * N_max;
  Cand c;
  c.pos = reinterpret_cast<int*>(base);
  c.shift = reinterpret_cast<int*>(base + n * 4);
  c.qual = reinterpret_cast<float*>(base + n * 8);
  c.bands = reinterpret_cast<short*>(base + n * 12);
  return c;
}

// Window base of ops/dtw.py:_win_base: 128-aligned, clipped before the
// division so the operand is non-negative.
__device__ __forceinline__ int win_base(int t, int sw, int hi) {
  int x = t + 25 + 64 - sw / 2;
  x = x < 0 ? 0 : (x > hi ? hi : x);
  return (x / 128) * 128;
}

// win[i][j] = member live[i]'s k-mer at index wb - PAD + j, -1 outside
// [0, L), for j < sw: every k-mer a band lane can read while the base is wb.
__device__ inline void stage_window(short* win, const int* seqs,
                                    const int* live, int n_live, int L,
                                    int sw, int sw_max, int wb, int tid,
                                    int nthreads) {
  for (int e = tid; e < n_live * sw; e += nthreads) {
    const int i = e / sw, j = e - i * sw;
    const int idx = wb - PAD + j;
    int v = -1;
    if (idx >= 0 && idx < L) v = seqs[(size_t)live[i] * L + idx];
    win[(size_t)i * sw_max + j] = (short)v;
  }
}

#ifdef BEAM_CLOCKS
// Block 0, warp 0, lane 0: cycles in phase A, at the first barrier, in the
// selection (both stages and the barrier between them) and at the last
// barrier, summed over the steps, and the steps (instrumented builds only).
__device__ long long g_clocks[5];
#endif

// SHARED: the shared route (the candidate store in shared memory, so its
// accesses compile to shared-memory instructions); else the scratch route.
template <bool SHARED>
__global__ void __launch_bounds__(kMaxWarps * 32)
beam_consensus_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int job = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int B = p.B, N_max = p.N_max;
  const int NC = 4 * B;
  const int mask_k = (1 << (2 * p.k)) - 1;
  const int row_len = 1 << (2 * p.k);          // table row
  const int simple_k = p.simple_k;

  const long long* mj = p.meta + (size_t)job * META;
  const int* seqs = p.seqs + mj[0];
  const int* lens = p.lens + mj[1];
  const int N = (int)mj[2], L = (int)mj[3], T = (int)mj[4];
  const int sw = (int)mj[5], hi = (int)mj[6];
  const int first = p.firsts[job];

  int* s_kmer = reinterpret_cast<int*>(smem);  // [MAX_B] the beam
  int* s_cost = s_kmer + MAX_B;
  int* s_fin = s_cost + MAX_B;
  int* s_src = s_fin + MAX_B;                  // candidate each slot took
  int* acc_cost = s_src + MAX_B;               // [4 MAX_B]
  int* acc_vote = acc_cost + 4 * MAX_B;
  int* acc_fin = acc_vote + 4 * MAX_B;
  int* s_fc = acc_fin + 4 * MAX_B;             // [4 MAX_B] selection costs
  int* s_ctl = s_fc + 4 * MAX_B;               // [4]
  int* s_live = s_ctl + 4;                     // [N_max]
  int* s_len = s_live + N_max;                 // [N_max]
  unsigned char* after = smem + small_bytes(N_max);
  constexpr bool shared_route = SHARED;
  Cand C = carve_cand(shared_route ? after
                                   : p.scratch + (size_t)job * p.cand_bytes,
                      N_max, B);
  short* win = nullptr;
  unsigned char* par = nullptr;
  if (shared_route) {
    win = reinterpret_cast<short*>(after + cand_bytes(N_max, B));
    par = after + cand_bytes(N_max, B) + window_bytes(N_max, p.sw_max);
  }
  int* rec = p.rec + (size_t)job * p.T_max * NC;
  const int buf = NC * N_max;                  // entries in one buffer

  // ---- live members, in order (warp 0, by ballots); the beam -------------
  if (warp == 0) {
    int base = 0;
    for (int n0 = 0; n0 < N; n0 += 32) {
      const int n = n0 + lane;
      const int ln = n < N ? lens[n] : 0;
      const unsigned ok = __ballot_sync(FM, ln > 0);
      if (ln > 0) {
        const int at = base + __popc(ok & ((1u << lane) - 1));
        s_live[at] = n;
        s_len[at] = ln;
      }
      base += __popc(ok);
    }
    if (lane == 0) {
      s_ctl[C_NLIVE] = base;
      s_ctl[C_ANY] = 0;
    }
    if (lane < 4 * MAX_B) {
      acc_cost[lane] = 0;
      acc_vote[lane] = 0;
      acc_fin[lane] = 0;
    }
    if (lane < MAX_B) {  // all beams start alike; one is live
      s_kmer[lane] = first;
      s_cost[lane] = lane == 0 ? 0 : BIG;
      s_fin[lane] = 0;
      s_src[lane] = 0;
    }
  }
  __syncthreads();
  const int n_live = s_ctl[C_NLIVE];

  // ---- initial bands (ops/dtw.py:device_consensus), candidate 0 of the
  // buffer step 0 reads; the first window -----------------------------------
  for (int i = warp; i < n_live; i += nwarps) {
    int v = p.gap_cost;
    if (lane < INIT) v = FULL;
    if (lane == INIT && seqs[(size_t)s_live[i] * L] == first) v = 0;
    const int e = buf + i;
    C.bands[e * W + lane] = (short)v;
    if (lane == 0) {
      C.pos[e] = INIT;
      C.shift[e] = 0;
      C.qual[e] = 1.0f;
    }
  }
  int wb = win_base(0, sw, hi);
  if (shared_route)
    stage_window(win, seqs, s_live, n_live, L, sw, p.sw_max, wb, tid,
                 blockDim.x);
  __syncthreads();

  const int tasks = B * n_live;
  bool has = false;                            // a beam finished at t_end
  int t_end = T - 1;
  // task = b * n_live + i; this warp's first and its stride, as (b, i)
  const int b0 = n_live ? warp / n_live : 0, i0 = warp - b0 * n_live;
  const int b_step = n_live ? nwarps / n_live : 0;
  const int i_step = nwarps - b_step * n_live;
#ifdef BEAM_CLOCKS
  long long c_a = 0, c_w1 = 0, c_s = 0, c_w2 = 0, steps = 0;
#endif
  for (int t = 0; t < T; ++t) {
#ifdef BEAM_CLOCKS
    const long long k0 = clock64();
#endif
    const int wr = t & 1;                      // candidate buffer written
    const int rd_base = (wr ^ 1) * buf, wr_base = wr * buf;

    // ---- phase A: (beam state, member) tasks, 4 branches each ------------
    int b = b0, i = i0;
    for (int task = warp; task < tasks;
         task += nwarps, b += b_step, i += i_step) {
      if (i >= n_live) {
        i -= n_live;
        ++b;
      }
      const int si = rd_base + s_src[b] * N_max + i;
      const int raw_in = C.bands[si * W + lane];
      const int sh_in = C.shift[si];
      const int p0 = C.pos[si];
      const float q = C.qual[si];
      // the recentring the kept band asked for (ref: alignment.go:245-273)
      const int from_in = lane - sh_in;
      const int moved_in = __shfl_sync(FM, raw_in, from_in & 31);
      const int poff = (from_in >= 0 && from_in < W) ? moved_in : FULL;
      if (s_fin[b]) {  // frozen: its state carries through as candidate (b, 0)
        const int di = wr_base + (4 * b) * N_max + i;
        C.bands[di * W + lane] = (short)poff;
        if (lane == 0) {
          C.pos[di] = p0;
          C.shift[di] = 0;
          C.qual[di] = q;
        }
        continue;
      }
      const int pos2 = p0 + 1;
      const int o = pos2 - CENTRE + PAD;
      const bool ov =
          o >= 0 && o < L + PAD && o - wb >= 0 && o - wb <= sw - W;
      const int idx = pos2 - CENTRE + lane;  // member k-mer under this lane
      int km = -1;
      if (ov && idx >= 0 && idx < L)
        km = shared_route ? (int)win[i * p.sw_max + (o - wb + lane)]
                          : seqs[(size_t)s_live[i] * L + idx];
      int extra = abs(idx - (INIT + 1 + t)) - REG_SLACK;
      extra = extra > 0 ? extra : 0;
      const int pk = (s_kmer[b] << 2) & mask_k;
      int d[4];
      if (simple_k) {
        const int base =
            km >= 0 ? band::wrap_add(simple_high(pk ^ km, p.sm), extra)
                    : FULL;
        const int w = km >= 0 ? p.sm.w0 : 0;
        const int lo = km & 3;
#pragma unroll
        for (int br = 0; br < 4; ++br)
          d[br] = band::wrap_add(base, lo != br ? w : 0);
      } else {
        const uint16_t* row = p.table + (size_t)pk * row_len + km;
#pragma unroll
        for (int br = 0; br < 4; ++br)
          d[br] = km >= 0
              ? band::wrap_add((int)__ldg(row + (size_t)br * row_len), extra)
              : FULL;
      }
      const bool ahead = lane >= band::argmin_last(poff, lane);
      int stay = __shfl_down_sync(FM, poff, 1);
      if (lane == 31) stay = FULL;
      const int near = min(poff, stay);
      const int out_base = (wr_base + 4 * b * N_max + i) * W + lane;
      int key[4];
      bool ex[4];
#pragma unroll
      for (int br = 0; br < 4; ++br) {
        // band.cuh:step with the (b, n)-only terms hoisted.  Every term
        // lies in [0, FULL] (the wrapper checks gap_cost >= 0 and
        // threshold >= 1), so one reduction over raw * 64 + (31 - lane)
        // gives the row minimum and its highest lane, which is also
        // _argmin_last of the thresholded band (0 there, > 0 elsewhere).
        const int db = d[br];
        const int pd = band::sat_add<FULL>(poff, db);
        int skip1 = __shfl_up_sync(FM, pd, 1);
        if (lane == 0) skip1 = FULL;
        const int d_next = __shfl_down_sync(FM, db, 1);
        const int two = band::sat_add<FULL>(pd, d_next);
        int skip2 = __shfl_up_sync(FM, two, 2);
        if (lane < 2) skip2 = FULL;
        const int raw = band::sat_add<FULL>(min(near, min(skip1, skip2)), db);
        key[br] = __reduce_min_sync(FM, raw * 64 + (31 - lane));
        int out = raw - (key[br] >> 6);
        if (out >= p.threshold) out = FULL;
        ex[br] = __any_sync(FM, db == 0 && out < FULL && ahead);
        C.bands[out_base + br * N_max * W] = (short)out;
      }
      if (lane < 4) {  // lane br: candidate (b, br)'s scalars
        const int kb = lane == 0 ? key[0] : lane == 1 ? key[1]
                     : lane == 2 ? key[2] : key[3];
        const bool eb = lane == 0 ? ex[0] : lane == 1 ? ex[1]
                      : lane == 2 ? ex[2] : ex[3];
        const int bp = 31 - (kb & 63);
        const int drift = CENTRE - bp;
        const int shift = abs(drift) > 4 ? drift : 0;
        const int c = 4 * b + lane;
        const int di = wr_base + c * N_max + i;
        C.pos[di] = pos2 - shift;
        C.shift[di] = shift;
        C.qual[di] = eb ? 1.0f : __fmul_rn(q, 0.95f);
        atomicAdd(acc_cost + c, kb >> 6);
        if (eb && floorf(__fadd_rn(__fmul_rn(8.0f, q), 0.5f)) > 0.0f)
          atomicOr(acc_vote + c, 1);
        if (pos2 + bp - CENTRE >= s_len[i] - 1) atomicOr(acc_fin + c, 1);
      }
    }
#ifdef BEAM_CLOCKS
    const long long k1 = clock64();
#endif
    __syncthreads();
#ifdef BEAM_CLOCKS
    const long long k2 = clock64();
#endif

    // ---- phase B (every warp): costs, duplicate suppression, rank -------
    // Warp w takes candidates c = w, w + nwarps, ...  Lane j holds
    // candidate j's (k-mer, cost, frozen) and lane b < B beam slot b's, so
    // candidate c's duplicate flags and its rank (the candidates j with
    // c_j < c_c, or c_j = c_c and j < c: the stable sort of
    // beam_consensus_plain) are ballots.  Stage 1 writes each candidate's
    // cost after suppression; a barrier; stage 2 ranks, and the warp of a
    // candidate of rank r < B commits slot r and its record row.
    const int wb_next = win_base(t + 1, sw, hi);
    const bool restage = shared_route && wb_next != wb && t + 1 < T;
    // lane j: candidate j's k-mer, cost and frozen flag (frozen: branch 0
    // lives)
    const int jc = lane < NC ? lane : 0;
    const int bj = jc >> 2;
    const int kbj = s_kmer[bj], cbj = s_cost[bj];
    const int pfj = (lane < NC) & (s_fin[bj] != 0);
    const int ckj = pfj ? kbj : (((kbj << 2) & mask_k) | (jc & 3));
    const int ccj = pfj ? ((jc & 3) == 0 ? cbj : BIG)
                        : (acc_vote[jc] ? band::wrap_add(cbj, acc_cost[jc])
                                        : BIG);
    const int finj = acc_fin[jc];
    const int ps = lane < MAX_B ? lane : 0;
    const int kps = s_kmer[ps], cps = s_cost[ps], fps = s_fin[ps];
    for (int c = warp; c < NC; c += nwarps) {
      const int ck = __shfl_sync(FM, ckj, c), cc = __shfl_sync(FM, ccj, c);
      const int pf = __shfl_sync(FM, pfj, c);
      // against the live parents, and against better candidates of the
      // same k-mer that are not frozen; a frozen candidate is never
      // suppressed
      const int vs_parent = (lane < B) & (kps == ck) & (cps <= cc) &
                            (fps == 0) & (lane != (c >> 2));
      const int vs_cand = (lane < NC) & (pfj == 0) & (ckj == ck) &
                          ((ccj < cc) | ((ccj == cc) & (lane < c)));
      const bool dup = __any_sync(FM, vs_parent | vs_cand) && !pf;
      if (lane == 0) s_fc[c] = dup ? BIG : cc;
    }
    // every thread read the last step's flag before this step's barrier 1
    if (tid == 0) s_ctl[C_ANY] = 0;
    __syncthreads();
    const int fj = s_fc[jc];
    for (int c = warp; c < NC; c += nwarps) {
      const int fc = s_fc[c];
      const int rank = __popc(__ballot_sync(
          FM, (lane < NC) & ((fj < fc) | ((fj == fc) & (lane < c)))));
      const int ck = __shfl_sync(FM, ckj, c), pf = __shfl_sync(FM, pfj, c);
      const int fin_c = __shfl_sync(FM, finj, c);
      if (lane == 0) {
        acc_cost[c] = 0;
        acc_vote[c] = 0;
        acc_fin[c] = 0;
        if (rank < B) {
          const int b = c >> 2;
          const int nf = pf | (fin_c != 0);
          s_kmer[rank] = ck;
          s_cost[rank] = fc;
          s_fin[rank] = nf;
          s_src[rank] = pf ? 4 * b : c;
          int* r = rec + (size_t)t * NC;
          r[rank] = ck;
          r[B + rank] = b;
          r[2 * B + rank] = nf;
          r[3 * B + rank] = fc;
          if (par) par[(size_t)t * B + rank] = (unsigned char)b;
          if (nf) s_ctl[C_ANY] = 1;
        }
      }
    }
    if (restage)  // the window of the next step's base
      stage_window(win, seqs, s_live, n_live, L, sw, p.sw_max, wb_next, tid,
                   blockDim.x);
    wb = wb_next;
#ifdef BEAM_CLOCKS
    const long long k3 = clock64();
#endif
    __syncthreads();
#ifdef BEAM_CLOCKS
    const long long k4 = clock64();
    c_a += k1 - k0;
    c_w1 += k2 - k1;
    c_s += k3 - k2;
    c_w2 += k4 - k3;
    ++steps;
#endif
    if (s_ctl[C_ANY] && !has) {
      has = true;
      t_end = t;                         // first step with a finished beam
      if (p.early_exit) break;
    }
  }
#ifdef BEAM_CLOCKS
  if (job == 0 && tid == 0) {
    g_clocks[0] = c_a;
    g_clocks[1] = c_w1;
    g_clocks[2] = c_s;
    g_clocks[3] = c_w2;
    g_clocks[4] = steps;
  }
#endif

  // ---- traceback (ops/dtw.py:_device_traceback) -------------------------
  int* chain = p.chains + (size_t)job * p.T_max;
  for (int t = t_end + 1 + tid; t < p.T_max; t += blockDim.x) chain[t] = -1;
  if (tid == 0) {
    const int* row = rec + (size_t)t_end * NC;
    int b = 0, best = 0;
    for (int i = 0; i < B; ++i) {  // argmin, first on ties
      const int v = (has && !row[2 * B + i]) ? BIG : row[3 * B + i];
      if (i == 0 || v < best) {
        best = v;
        b = i;
      }
    }
    for (int t = t_end; t >= 0; --t) {
      if (par) {  // the walk in shared memory; row t's slot 0 keeps b
        const int up = par[(size_t)t * B + b];
        par[(size_t)t * B] = (unsigned char)b;
        b = up;
      } else {
        const int* r = rec + (size_t)t * NC;
        chain[t] = r[b];
        b = r[B + b];
      }
    }
    p.n_valid[job] = t_end + 1;
  }
  if (par) {
    __syncthreads();
    for (int t = tid; t <= t_end; t += blockDim.x)
      chain[t] = rec[(size_t)t * NC + par[(size_t)t * B]];
  }
}

}  // namespace

extern "C" {

// Bytes of device scratch one job needs (its candidate store) when a
// launch of this size takes the scratch route; 0 when everything fits in
// shared memory (the shared route).
long long beam_consensus_scratch_bytes(int N_max, int B, int sw_max,
                                       int T_max) {
  int dev = 0, max_smem = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&max_smem,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  if (shared_route_bytes(N_max, B, sw_max, T_max) <= max_smem) return 0;
  return cand_bytes(N_max, B);
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).  Job j's
// member k-mers are seqs[meta[j][0] ...] as [N, L] int32 (-1 fill) and its
// lengths lens[meta[j][1] ...] as [N]; meta is [J, 8] int64 (seq offset,
// lens offset, N, L, T, sw, hi, unused), with sw / hi ops/dtw.py:
// _win_params(L), N <= N_max, T <= T_max, sw <= sw_max.  firsts [J],
// chains [J, T_max], n_valid [J] and rec [J, T_max, 4, B] are int32; all
// contiguous on the current device.  table is the uint16 [4^k, 4^k]
// distance table when simple_k == 0.  scratch is null or J x
// beam_consensus_scratch_bytes(...) bytes, as that function says.
// early_exit = 0 runs all T steps.  warps: warps per job, 1 to 32.
int beam_consensus_launch(const int* seqs, const int* lens, const int* firsts,
                          const long long* meta, const void* table,
                          int* chains, int* n_valid, int* rec, void* scratch,
                          int J, int N_max, int T_max, int sw_max, int k,
                          int B, int threshold, int gap_cost, int simple_k,
                          int early_exit, int warps, void* stream) {
  if (J <= 0) return (int)cudaSuccess;
  if (B < 1 || B > MAX_B || N_max < 1 || T_max < 1 || sw_max < W ||
      k < 1 || k > 7 || warps < 1 || warps > kMaxWarps)
    return (int)cudaErrorInvalidValue;
  if (simple_k == 0 && table == nullptr) return (int)cudaErrorInvalidValue;
  const long long need = beam_consensus_scratch_bytes(N_max, B, sw_max,
                                                      T_max);
  if (need < 0 || (need > 0) != (scratch != nullptr))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.seqs = seqs;
  p.lens = lens;
  p.firsts = firsts;
  p.meta = meta;
  p.table = static_cast<const uint16_t*>(table);
  p.chains = chains;
  p.n_valid = n_valid;
  p.rec = rec;
  p.scratch = static_cast<unsigned char*>(scratch);
  p.cand_bytes = cand_bytes(N_max, B);
  p.N_max = N_max;
  p.T_max = T_max;
  p.sw_max = sw_max;
  p.k = k;
  p.B = B;
  p.threshold = threshold;
  p.gap_cost = gap_cost;
  p.simple_k = simple_k;
  p.sm = simple_masks(simple_k);
  p.early_exit = early_exit;
  const size_t smem = (size_t)(scratch
      ? small_bytes(N_max)
      : shared_route_bytes(N_max, B, sw_max, T_max));
  void (*kern)(Params) = scratch ? beam_consensus_kernel<false>
                                 : beam_consensus_kernel<true>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)J, warps * 32, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

#ifdef BEAM_CLOCKS
// Copies g_clocks (block 0's phase cycles of the last launch) to host.
int beam_consensus_clocks(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_clocks, sizeof(g_clocks));
}
#endif

const char* beam_consensus_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
