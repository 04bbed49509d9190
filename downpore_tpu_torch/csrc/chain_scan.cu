// Anchor chain DP for Hopper (sm_90a): one warp per (query, chunk) pair and
// direction.
//
// Replaces downpore_tpu/ops/pallas_chain.py:_kernel (and so the XLA scan
// ops/chain.py:_chain_scan, which it computes exactly).  For every anchor t
// of a pair, in order, the best predecessor p < t is the one with the
// highest chain score among those with qi[p] < qi[t], tj[p] < tj[t], the
// gap window of the variant and score[p] > 0; ties go to the lowest p.  The
// per-anchor outputs are score, cov_q, cov_t, start_qp, start_tp and bp.
//
// Three modes, one launch each:
//  * forward: the six outputs above (no path of the port calls it since
//    fb took its place; it is kept for the P = 4096, A = 128 forward
//    measurement that every PR since the first has repeated);
//  * fb: forward and backward in one launch (2 P warps).  A backward warp
//    reads its row reversed and negated (the JAX module's backward pass,
//    ops/chain.py:dp_from_anchors) and writes score, cov_q, cov_t and the
//    negated start positions straight back into the row's own order, so the
//    caller needs no flip or negation;
//  * lean: score and bp only (the overlap path's dp_forward_lean).
//
// What bounds it.  Pair by pair the scan is serial: each valid anchor t
// checks every valid p < t, so a pair of n valid anchors needs n (n - 1) / 2
// candidate checks of 8 int32 operations (2 index compares, 3 window
// compares, the window branch's select, the key's select and the max).
// At P = 4096, A = 128 with 85% valid that is 24.0 M checks, ~0.19 G
// operations, ~11.5 us at the card's int32 rate (64 INT32 lanes per SM);
// the 11 [P, A] int32 arrays are 23 MB, ~7 us at 3.35 TB/s.  So the bound
// is the integer issue rate.  The first form of this kernel
// (anchors in shared memory) reached ~11% of it: 6 shared-memory loads per
// check, a 10-shuffle argmax and a lane-0 state update fenced by a
// __syncwarp at every step.  This design takes work out of each of the A
// serial steps:
//  * register form (A <= 32 S, S <= 12): anchor p lives in lane p % 32,
//    slot p / 32, in registers (qi, tj, window forms, score key, bp).
//    Slots are unrolled outside, lanes looped inside, so every register
//    index is static.  Step t's anchor and thresholds come from a record
//    written at load, two broadcast shared-memory reads (extend), or by
//    __shfl_sync from its owner lane (aligner).  A check reads no shared
//    memory at all;
//  * the argmax is one __reduce_max_sync (redux.sync) over the key
//    (score << 16) | (0xFFFF - p), masked candidates at key 0: the highest
//    score, then the lowest p, exact while A < 2^15 (the wrapper checks);
//  * no valid[p] test: an invalid or not yet scanned anchor has score 0,
//    and score > 0 excludes it;
//  * the gap windows are division-free, and each side of each inequality
//    is precomputed (per anchor at load, per step once), so a check is ~8
//    compares and a max (window_linear);
//  * the scan visits only valid anchors (a ballot bit mask per slot), and
//    the owner lane of t writes t's state, two registers (score key, bp):
//    a step has no other synchronisation than the redux and writes no
//    shared memory;
//  * the full modes derive the payload (cov_q, cov_t, start_qp, start_tp)
//    after the scan from the bp chains, by pointer jumping in shared
//    memory: ~log2(chain length) rounds in which every lane works, in
//    place of a serial payload update at each of the A steps;
//  * shared-memory form for A above 32 * 12: the same step with the anchor
//    arrays in shared memory (the first form), any A that fits.
// What still bounds it: at step t every lane checks its slots up to t's,
// 32 (t / 32 + 1) checks where the function needs the valid p < t (~1.5x
// at A = 128, 85% valid); a checked slot issues ~10 instructions against
// the 8 operations counted; per step the warp issues ~15 more (the step's
// reads, the mask walk, the redux, the owner's update); below ~2,000
// warps the serial steps' latency shows too.  It reaches about a quarter
// of the bound at the paths' shapes (PERF.md).
//
// Exactness: JAX's `//` floors.  The window bounds floor(2g/3) and
// floor(3g/2) are rewritten in integers (proof at window_linear); gaps are
// negative when seeds overlap, which the rewrite covers for every sign.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;  // warps (pair-directions) per block
enum { kForward = 0, kBoth = 1, kLean = 2 };

struct Args {
  const int* in[5];  // qi, tj, qp, tp, valid: [P, A] int32
  int* out[11];      // forward: score cov_q cov_t s_qp s_tp bp;
                     // backward: score cov_q cov_t e_qp e_tp
  int P, A, k;
};

__device__ __forceinline__ unsigned cand_key(int score, int p) {
  return ((unsigned)score << 16) | (unsigned)(0xFFFF - p);
}

// Which pair and direction warp `w` scans: with both directions the two
// warps of a pair are neighbours (they read the same row).
__device__ __forceinline__ void pair_dir(long long w, int dirs,
                                         long long* pair, int* dir) {
  *pair = dirs == 2 ? (w >> 1) : w;
  *dir = dirs == 2 ? (int)(w & 1) : 0;
}

// Owner-lane update of anchor t's payload in the full modes: from the
// chosen predecessor's record, or a chain start.
__device__ __forceinline__ void update_record(int4* rec_a, int2* rec_b,
                                              unsigned key, int t, int qp_t,
                                              int tp_t, int k) {
  if (key) {
    const int best = 0xFFFF - (int)(key & 0xFFFFu);
    const int4 a = rec_a[best];
    const int gq = qp_t - a.x - k;
    const int gt = tp_t - a.y - k;
    rec_a[t] = make_int4(qp_t, tp_t, a.z + k + min(0, gq),
                         a.w + k + min(0, gt));
    rec_b[t] = rec_b[best];
  } else {
    rec_a[t] = make_int4(qp_t, tp_t, k, k);
    rec_b[t] = make_int2(qp_t, tp_t);
  }
}

// Write anchor i's state to row position j (already un-reversed).
__device__ __forceinline__ void store(const Args& args, int mode, int dir,
                                      size_t j, int score, int bp,
                                      const int4* rec_a, const int2* rec_b,
                                      int i) {
  if (mode == kLean) {
    args.out[0][j] = score;
    args.out[5][j] = bp;
    return;
  }
  const int4 a = rec_a[i];
  const int2 b = rec_b[i];
  if (dir == 0) {
    args.out[0][j] = score;
    args.out[1][j] = a.z;
    args.out[2][j] = a.w;
    args.out[3][j] = b.x;
    args.out[4][j] = b.y;
    args.out[5][j] = bp;
  } else {
    args.out[6][j] = score;
    args.out[7][j] = a.z;
    args.out[8][j] = a.w;
    args.out[9][j] = -b.x;
    args.out[10][j] = -b.y;
  }
}

// The gap windows of ops/chain.py:_window_ok, without division and with
// each side of each inequality precomputed.  For integers x, y:
//   x >= floor(y / 3)  <=>  x > y / 3 - 1  <=>  3 x >= y - 2,
//   x <= floor(y / 2)  <=>  x <= y / 2     <=>  2 x <= y,
//   floor(y / 3) < c   <=>  y < 3 c,  floor(y / 2) < c  <=>  y < 2 c,
// for every sign of x and y (floor(y/n) is the largest integer <= y/n;
// gap_t is negative when seeds overlap in the aligner variant).  With
// gap_q = qp_t - qp_p - k and gap_t = tp_t - tp_p - k substituted, every
// inequality separates into a form of anchor p (x, computed once per
// anchor) compared with a threshold of step t (c, computed once per
// step), so a check is a handful of compares and no arithmetic.  Extend
// (gap_q >= 0: gap_t in [floor(2 gap_q / 3) - k, floor(3 gap_q / 2) + k];
// gap_q < 0: gap_t in [-k, 0]):
//   gap_q < 0            <=>  qp_p > qp_t - k
//   gap_t >= -k, <= 0    <=>  tp_t - k <= tp_p <= tp_t
//   3(gap_t + k) >= 2 gap_q - 2  <=>  3tp_p - 2qp_p <= 3tp_t - 2qp_t + 2k + 2
//   2(gap_t - k) <= 3 gap_q      <=>  2tp_p - 3qp_p >= 2tp_t - 3qp_t - k
// Aligner (g = gap_t; min_gap = floor(2g/3) - k, max_gap = floor(3g/2) +
// k + 1; min_gap < 0 gives [-k, max(max_gap, 0)], else max_gap < 20 gives
// [0, 20], else [min_gap, max_gap]):
//   min_gap < 0 <=> 2g < 3k  <=>  2tp_p > 2tp_t - 5k
//   gap_q >= -k          <=>  qp_p <= qp_t;   gap_q <= 0 <=> qp_p >= qp_t - k
//   gap_q <= max_gap <=> 2(gap_q - k - 1) <= 3g
//                        <=>  2qp_p - 3tp_p >= 2qp_t - 3tp_t - k - 2
//   max_gap < 20 <=> 3g < 2(19 - k)  <=>  3tp_p > 3tp_t - k - 38
//   0 <= gap_q <= 20     <=>  qp_t - k - 20 <= qp_p <= qp_t - k
//   gap_q >= min_gap <=> 3(gap_q + k) >= 2g - 2
//                        <=>  3qp_p - 2tp_p <= 3qp_t - 2tp_t + 2k + 2
// cuda_chain.window_ok_linear is the Python twin; tests/test_torch_chain.py
// holds it against window_ok over every (gap_q, gap_t) in [-3000, 3000]^2.
template <int V>
__device__ __forceinline__ void anchor_forms(int qp, int tp, int* x) {
  x[0] = qp;
  if (V == 0) {
    x[1] = tp;
    x[2] = 3 * tp - 2 * qp;
    x[3] = 2 * tp - 3 * qp;
    x[4] = 0;
  } else {
    x[1] = 2 * tp;
    x[2] = 3 * tp;
    x[3] = 2 * qp - 3 * tp;
    x[4] = 3 * qp - 2 * tp;
  }
}

template <int V>
__device__ __forceinline__ void step_thresholds(int qp, int tp, int k,
                                                int* c) {
  if (V == 0) {
    c[0] = qp - k;
    c[1] = tp;
    c[2] = tp - k;
    c[3] = 3 * tp - 2 * qp + 2 * k + 2;
    c[4] = 2 * tp - 3 * qp - k;
    c[5] = c[6] = 0;
  } else {
    c[0] = 2 * tp - 5 * k;
    c[1] = qp;
    c[2] = qp - k;
    c[3] = 2 * qp - 3 * tp - k - 2;
    c[4] = 3 * tp - k - 38;
    c[5] = qp - k - 20;
    c[6] = 3 * qp - 2 * tp + 2 * k + 2;
  }
}

template <int V>
__device__ __forceinline__ bool window_linear(const int* x, const int* c) {
  if (V == 0)
    return x[0] > c[0] ? (x[1] <= c[1] && x[1] >= c[2])
                       : (x[2] <= c[3] && x[3] >= c[4]);
  if (x[1] > c[0]) return x[0] <= c[1] && (x[0] >= c[2] || x[3] >= c[3]);
  if (x[2] > c[4]) return x[0] <= c[2] && x[0] >= c[5];
  return x[4] <= c[6] && x[3] >= c[3];
}

// Shared memory of the register form, per warp and anchor: in the extend
// variant the step record (qi, tj and the five thresholds c of
// window_linear) during the scan; then the pointer jumping state (jmp,
// pos) of the full modes.  The aligner's step takes its anchor by
// shuffles and computes its seven thresholds instead: measured faster
// there than a third shared-memory word and the lower occupancy.
template <int V>
__host__ __device__ constexpr int step_bytes() {
  return V == 0 ? 2 * 16 : 0;
}
constexpr int kJumpBytes = 16 + 8;

// Bytes of one warp's slice: `per` bytes an anchor, rounded up to 16 so
// that every slice starts aligned for int4.
__host__ __device__ inline size_t warp_slice(int A, int per) {
  return ((size_t)A * per + 15) & ~(size_t)15;
}

// Register form: A <= 32 S.  Per slot: qi, tj, the window forms x, the
// packed key of the anchor's score (0 until scanned, so unscanned and
// invalid anchors drop out of the max by themselves) and the packed key of
// its predecessor (bp decoded at the store); per warp, a bit mask of the
// valid anchors of each slot, so the scan visits only those.  In the
// extend variant step t's record is two broadcast shared-memory reads,
// written at load, so a step computes no threshold and needs no shuffle
// (the aligner variant: four shuffles and its thresholds).  The scan is
// the same in every mode: score and bp.  The full modes then derive each
// anchor's payload from the bp chains by pointer jumping, in ~log2(chain
// length) rounds in which every lane works, instead of a serial owner-lane
// update at every step.
template <int S, int V, bool kLeanT>
__global__ void __launch_bounds__(kWarps * 32)
    chain_scan_regs(Args args, int dirs, int mode) {
  extern __shared__ int4 smem4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const long long w = (long long)blockIdx.x * nw + warp;
  const int A = args.A, k = args.k;
  if (w >= (long long)args.P * dirs) return;  // whole warp; no block barrier
  long long pair;
  int dir;
  pair_dir(w, dirs, &pair, &dir);
  const size_t off = (size_t)pair * A;
  // this warp's slice of shared memory, reused by the two phases
  constexpr int kPer = step_bytes<V>() > kJumpBytes ? step_bytes<V>()
                                                     : kJumpBytes;
  unsigned char* mine =
      reinterpret_cast<unsigned char*>(smem4) +
      (size_t)warp * warp_slice(A, kLeanT ? step_bytes<V>() : kPer);
  int4* rec_a = reinterpret_cast<int4*>(mine);
  int4* rec_b = rec_a + A;

  int r_qi[S], r_tj[S], r_x[S][5];
  unsigned r_key[S], r_pk[S], vmask[S];
  const int sg = dir ? -1 : 1;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int i = s * 32 + lane;
    int qp = 0, tp = 0, v = 0;
    r_key[s] = r_pk[s] = 0;
    r_qi[s] = r_tj[s] = 0;
    if (i < A) {
      const size_t j = off + (dir ? A - 1 - i : i);
      r_qi[s] = sg * __ldg(args.in[0] + j);
      r_tj[s] = sg * __ldg(args.in[1] + j);
      qp = sg * __ldg(args.in[2] + j);
      tp = sg * __ldg(args.in[3] + j);
      v = __ldg(args.in[4] + j);
      if constexpr (V == 0) {
        int c[7];
        step_thresholds<V>(qp, tp, k, c);
        rec_a[i] = make_int4(r_qi[s], r_tj[s], c[0], c[1]);
        rec_b[i] = make_int4(c[2], c[3], c[4], 0);
      }
    }
    vmask[s] = __ballot_sync(kFull, v != 0);
    anchor_forms<V>(qp, tp, r_x[s]);
  }
  if (V == 0) __syncwarp();

#pragma unroll
  for (int st = 0; st < S; ++st) {
    for (unsigned m = vmask[st]; m; m &= m - 1) {  // valid anchors only
      const int lt = __ffs(m) - 1;                  // warp-uniform
      const int t = st * 32 + lt;
      int qi_t, tj_t, c[7];
      if constexpr (V == 0) {
        const int4 ra = rec_a[t], rb = rec_b[t];  // broadcast reads
        qi_t = ra.x;
        tj_t = ra.y;
        c[0] = ra.z;
        c[1] = ra.w;
        c[2] = rb.x;
        c[3] = rb.y;
        c[4] = rb.z;
      } else {
        qi_t = __shfl_sync(kFull, r_qi[st], lt);
        tj_t = __shfl_sync(kFull, r_tj[st], lt);
        const int qp_t = __shfl_sync(kFull, r_x[st][0], lt);
        const int tp_t = __shfl_sync(kFull, r_x[st][1], lt) >> 1;  // 2 tp
        step_thresholds<V>(qp_t, tp_t, k, c);
      }
      unsigned key = 0;
#pragma unroll
      for (int s = 0; s <= st; ++s) {
        // p >= t has key 0 (not scanned yet), so no p < t test
        const bool ok = r_qi[s] < qi_t && r_tj[s] < tj_t &&
                        window_linear<V>(r_x[s], c);
        key = max(key, ok ? r_key[s] : 0u);
      }
      key = __reduce_max_sync(kFull, key);
      if (lane == lt) {
        // score = predecessor's + 1 (or 1), in the key's high half
        r_key[st] = (key & 0xFFFF0000u) + (0x10000u | (0xFFFFu - t));
        r_pk[st] = key;
      }
    }
  }

  int r_bp[S];
#pragma unroll
  for (int s = 0; s < S; ++s)
    r_bp[s] = r_pk[s] ? 0xFFFF - (int)(r_pk[s] & 0xFFFFu) : -1;
  if (kLeanT) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int i = s * 32 + lane;
      if (i < A) {
        const size_t j = off + i;
        args.out[0][j] = (int)(r_key[s] >> 16);
        args.out[5][j] = r_bp[s];
      }
    }
    return;
  }

  // Payload by pointer jumping over the bp chains.  jmp[i] = (acc_q,
  // acc_t, ptr, last): the covered-base sums of the nodes from i down to,
  // not including, ptr, and the last node summed; a chain start adds k,
  // a chained anchor k + min(0, its gap to bp).  When ptr is -1, acc is
  // cov and last the chain's first anchor, whose positions are start_qp,
  // start_tp.
  __syncwarp();  // every step record read before the region is reused
  int4* jmp = reinterpret_cast<int4*>(mine);
  int2* pos = reinterpret_cast<int2*>(jmp + A);
  int4 r_j[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int i = s * 32 + lane;
    if (i < A) pos[i] = make_int2(r_x[s][0], V == 0 ? r_x[s][1]
                                                     : r_x[s][1] >> 1);
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int i = s * 32 + lane;
    const int b = r_bp[s];
    if (i >= A || !((vmask[s] >> lane) & 1)) {
      r_j[s] = make_int4(0, 0, -1, -1);
    } else if (b < 0) {
      r_j[s] = make_int4(k, k, -1, i);
    } else {
      const int2 me = pos[i], pb = pos[b];
      r_j[s] = make_int4(k + min(0, me.x - pb.x - k),
                         k + min(0, me.y - pb.y - k), b, i);
    }
    if (i < A) jmp[i] = r_j[s];
  }
  __syncwarp();
  bool open = true;
  while (__any_sync(kFull, open)) {
    open = false;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (r_j[s].z >= 0) {
        const int4 n = jmp[r_j[s].z];
        r_j[s] = make_int4(r_j[s].x + n.x, r_j[s].y + n.y, n.z, n.w);
        open |= n.z >= 0;
      }
    }
    __syncwarp();  // every read of this round before any write
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int i = s * 32 + lane;
      if (i < A) jmp[i] = r_j[s];
    }
    __syncwarp();
  }
  int* const* o = args.out + (dir ? 6 : 0);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int i = s * 32 + lane;
    if (i < A) {
      const size_t j = off + (dir ? A - 1 - i : i);
      const int2 st = r_j[s].w >= 0 ? pos[r_j[s].w] : make_int2(0, 0);
      o[0][j] = (int)(r_key[s] >> 16);
      o[1][j] = r_j[s].x;
      o[2][j] = r_j[s].y;
      o[3][j] = sg * st.x;
      o[4][j] = sg * st.y;
      if (!dir) o[5][j] = r_bp[s];
    }
  }
}

// Shared-memory form: any A whose arrays fit.  Per warp: qi, tj, v, score,
// bp (5 A ints), and the records (qp, tp, cov_q, cov_t; start qp, tp).
template <int V, bool kLeanT>
__global__ void __launch_bounds__(kWarps * 32)
    chain_scan_smem(Args args, int dirs, int mode) {
  extern __shared__ int4 smem4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const long long w = (long long)blockIdx.x * nw + warp;
  const int A = args.A, k = args.k;
  if (w >= (long long)args.P * dirs) return;
  long long pair;
  int dir;
  pair_dir(w, dirs, &pair, &dir);
  const size_t off = (size_t)pair * A;
  int4* rec_a = smem4 + (size_t)warp * A;  // qp, tp, cov_q, cov_t
  int2* rec_b = reinterpret_cast<int2*>(smem4 + (size_t)nw * A) +
                (size_t)warp * A;
  int* base = reinterpret_cast<int*>(reinterpret_cast<int2*>(
                  smem4 + (size_t)nw * A) + (size_t)nw * A) +
              (size_t)warp * 5 * A;
  int* s_qi = base;
  int* s_tj = s_qi + A;
  int* s_v = s_tj + A;
  int* s_sc = s_v + A;
  int* s_bp = s_sc + A;

  const int sg = dir ? -1 : 1;
  for (int i = lane; i < A; i += 32) {
    const size_t j = off + (dir ? A - 1 - i : i);
    s_qi[i] = sg * __ldg(args.in[0] + j);
    s_tj[i] = sg * __ldg(args.in[1] + j);
    rec_a[i] = make_int4(sg * __ldg(args.in[2] + j),
                         sg * __ldg(args.in[3] + j), 0, 0);
    rec_b[i] = make_int2(0, 0);
    s_v[i] = __ldg(args.in[4] + j);
    s_sc[i] = 0;
    s_bp[i] = -1;
  }
  __syncwarp();

  for (int t = 0; t < A; ++t) {
    if (!s_v[t]) continue;  // warp-uniform
    const int4 at = rec_a[t];
    const int qi_t = s_qi[t], tj_t = s_tj[t];
    int c[7];
    step_thresholds<V>(at.x, at.y, k, c);
    unsigned key = 0;
    for (int p = lane; p < t; p += 32) {
      const int sc = s_sc[p];
      if (sc > 0 && s_qi[p] < qi_t && s_tj[p] < tj_t) {
        const int4 ap = rec_a[p];
        int x[5];
        anchor_forms<V>(ap.x, ap.y, x);
        if (window_linear<V>(x, c)) key = max(key, cand_key(sc, p));
      }
    }
    key = __reduce_max_sync(kFull, key);
    if (lane == (t & 31)) {
      s_sc[t] = key ? (int)(key >> 16) + 1 : 1;
      s_bp[t] = key ? 0xFFFF - (int)(key & 0xFFFFu) : -1;
      if (!kLeanT) update_record(rec_a, rec_b, key, t, at.x, at.y, k);
    }
    __syncwarp();  // t's score is read by every lane at step t + 1
  }

  for (int i = lane; i < A; i += 32)
    store(args, mode, dir, off + (dir ? A - 1 - i : i), s_sc[i], s_bp[i],
          rec_a, rec_b, i);
}

constexpr int kMaxSlots = 12;  // register forms: A <= 32 S, S <= 12

// Shared memory per warp of each form.
size_t smem_regs(int A, bool lean, int variant) {
  const int step = variant == 0 ? step_bytes<0>() : step_bytes<1>();
  return warp_slice(A, lean || step > kJumpBytes ? step : kJumpBytes);
}

size_t smem_shared(int A) {
  return (size_t)A * (sizeof(int4) + sizeof(int2) + 5 * sizeof(int));
}

int max_smem_optin() {
  int dev = 0, max_smem = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&max_smem,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return max_smem;
}

// Up to kWarps warps a block, fewer where their shared memory would not
// fit (the shared-memory form at large A).
template <typename K>
cudaError_t launch(K kernel, const Args& args, int dirs, int mode,
                   size_t per_warp, cudaStream_t stream) {
  int nw = kWarps;
  if (per_warp * nw > 48 * 1024) {
    const int max_smem = max_smem_optin();
    if (max_smem < 0) return cudaErrorInvalidValue;
    while (nw > 1 && per_warp * nw > (size_t)max_smem) --nw;
    if (per_warp * nw > (size_t)max_smem) return cudaErrorInvalidValue;
  }
  const size_t smem = per_warp * nw;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long warps = (long long)args.P * dirs;
  const unsigned blocks = (unsigned)((warps + nw - 1) / nw);
  kernel<<<blocks, nw * 32, smem, stream>>>(args, dirs, mode);
  return cudaGetLastError();
}

template <int S, int V>
cudaError_t launch_regs(const Args& args, int dirs, int mode,
                        cudaStream_t stream) {
  const bool lean = mode == kLean;
  const size_t per_warp = smem_regs(args.A, lean, V);
  return lean ? launch(chain_scan_regs<S, V, true>, args, dirs, mode,
                       per_warp, stream)
              : launch(chain_scan_regs<S, V, false>, args, dirs, mode,
                       per_warp, stream);
}

template <int V>
cudaError_t dispatch(const Args& args, int dirs, int mode,
                     cudaStream_t stream) {
  const int A = args.A;
  if (A <= 32 * 2) return launch_regs<2, V>(args, dirs, mode, stream);
  if (A <= 32 * 3) return launch_regs<3, V>(args, dirs, mode, stream);
  if (A <= 32 * 4) return launch_regs<4, V>(args, dirs, mode, stream);
  if (A <= 32 * 8) return launch_regs<8, V>(args, dirs, mode, stream);
  if (A <= 32 * kMaxSlots)
    return launch_regs<kMaxSlots, V>(args, dirs, mode, stream);
  const size_t per_warp = smem_shared(A);
  return mode == kLean ? launch(chain_scan_smem<V, true>, args, dirs, mode,
                                per_warp, stream)
                       : launch(chain_scan_smem<V, false>, args, dirs, mode,
                                per_warp, stream);
}

}  // namespace

extern "C" {

// Largest A of the register forms; above it the shared-memory form runs.
int chain_scan_max_register_a() { return 32 * kMaxSlots; }

// Launch on `stream`; returns cudaGetLastError() (0 on success).  `in`
// holds the 5 input pointers, `out` the 11 output pointers (mode 0 uses
// out[0..5], mode 1 all 11, mode 2 out[0] and out[5]); all arrays are
// [P, A] int32, row-major and contiguous, on the current device.
// variant: 0 extend, 1 aligner.  mode: 0 forward, 1 forward + backward,
// 2 lean.  Requires 0 < A < 2^15.
int chain_scan_launch(const void* const* in, void* const* out, int P, int A,
                      int k, int variant, int mode, void* stream) {
  if (P <= 0 || A <= 0) return (int)cudaSuccess;
  if (A >= (1 << 15) || mode < 0 || mode > 2 || variant < 0 || variant > 1)
    return (int)cudaErrorInvalidValue;
  Args args;
  for (int i = 0; i < 5; ++i) args.in[i] = static_cast<const int*>(in[i]);
  for (int i = 0; i < 11; ++i) args.out[i] = static_cast<int*>(out[i]);
  args.P = P;
  args.A = A;
  args.k = k;
  const int dirs = mode == kBoth ? 2 : 1;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = variant == 0 ? dispatch<0>(args, dirs, mode, s)
                                       : dispatch<1>(args, dirs, mode, s);
  return (int)err;
}

const char* chain_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
