// Forward anchor chain DP for Hopper (sm_90a): one warp per (query, chunk)
// pair.
//
// Replaces downpore_tpu/ops/pallas_chain.py:_kernel (and so the XLA scan
// ops/chain.py:_chain_scan, which it computes exactly).  For every anchor t
// of a pair, in order, the best predecessor p < t is the one with the
// highest chain score among those with qi[p] < qi[t], tj[p] < tj[t], the
// gap window of `variant` and score[p] > 0; ties go to the lowest p.  The
// six per-anchor outputs are score, cov_q, cov_t, start_qp, start_tp, bp.
//
// What bounds it: the scan is latency-bound, not bandwidth- or FLOP-bound.
// Step t depends on every step before it (A serial steps per pair, A <= 384
// on the map path), and the state is tiny (11 int32 arrays of A = at most
// 17 KB).  The Pallas version kept the state in VMEM and paid a full
// [BLOCK, A] tile of one-hot selects per step to read and write column t.
// Here the pair's 5 input and 6 state arrays sit in shared memory for the
// whole scan, column t is a plain shared-memory index, and the predecessor
// search of step t is spread across the warp's 32 lanes (each lane scans
// p = lane, lane + 32, ... < t) and merged with a 5-level shuffle reduction.
// Each step therefore costs ~t/32 candidate checks per lane plus one
// reduction, with no device-memory traffic between the first load and the
// final store.  Several warps (pairs) share a block, and many pairs are in
// flight per SM, which is what hides the per-step latency.
//
// Exactness hazards handled here:
//  * JAX `//` floors, C `/` truncates: the (g*2)//3 and (g*3)//2 window
//    bounds go through floordiv() (gap_t is negative when seeds overlap in
//    the aligner variant).
//  * argmax tie-break: lanes scan p ascending and keep the first maximum;
//    the reduction keeps the smaller p on equal scores.

#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -1000000000;  // masked candidate score (ops.chain.NEG)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kArrays = 11;        // 5 inputs + 6 state arrays per pair
constexpr int kMaxWarps = 4;

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}

// ops/chain.py:_window_ok; variant 0 = extend, 1 = aligner.
__device__ __forceinline__ bool window_ok(int gap_q, int gap_t, int k,
                                          int variant) {
  if (variant == 0) {
    if (gap_q < 0) return gap_t >= -k && gap_t <= 0;
    return gap_t >= floordiv(gap_q * 2, 3) - k &&
           gap_t <= floordiv(gap_q * 3, 2) + k;
  }
  int min_gap = floordiv(gap_t * 2, 3) - k;
  int max_gap = floordiv(gap_t * 3, 2) + k + 1;
  if (min_gap < 0) {
    min_gap = -k;
    max_gap = max_gap > 0 ? max_gap : 0;
  } else if (max_gap < 20) {
    min_gap = 0;
    max_gap = 20;
  }
  return gap_q >= min_gap && gap_q <= max_gap;
}

__global__ void chain_scan_kernel(
    const int* __restrict__ qi, const int* __restrict__ tj,
    const int* __restrict__ qp, const int* __restrict__ tp,
    const int* __restrict__ valid, int* __restrict__ o_score,
    int* __restrict__ o_cov_q, int* __restrict__ o_cov_t,
    int* __restrict__ o_s_qp, int* __restrict__ o_s_tp,
    int* __restrict__ o_bp, int P, int A, int k, int variant) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long pair =
      (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (pair >= P) return;  // whole warp leaves; no block-wide barrier below

  int* s_qi = smem + (size_t)warp * kArrays * A;
  int* s_tj = s_qi + A;
  int* s_qp = s_tj + A;
  int* s_tp = s_qp + A;
  int* s_valid = s_tp + A;
  int* st_score = s_valid + A;
  int* st_cov_q = st_score + A;
  int* st_cov_t = st_cov_q + A;
  int* st_s_qp = st_cov_t + A;
  int* st_s_tp = st_s_qp + A;
  int* st_bp = st_s_tp + A;

  const size_t off = (size_t)pair * A;
  for (int i = lane; i < A; i += 32) {
    s_qi[i] = qi[off + i];
    s_tj[i] = tj[off + i];
    s_qp[i] = qp[off + i];
    s_tp[i] = tp[off + i];
    s_valid[i] = valid[off + i];
  }
  __syncwarp();

  for (int t = 0; t < A; ++t) {
    const int v_t = s_valid[t];  // warp-uniform
    const int qi_t = s_qi[t], tj_t = s_tj[t];
    const int qp_t = s_qp[t], tp_t = s_tp[t];
    int best_s = kNeg, best_p = A;
    if (v_t) {
      for (int p = lane; p < t; p += 32) {
        const int sc = st_score[p];
        if (sc > best_s && sc > 0 && s_valid[p] && s_qi[p] < qi_t &&
            s_tj[p] < tj_t &&
            window_ok(qp_t - s_qp[p] - k, tp_t - s_tp[p] - k, k, variant)) {
          best_s = sc;  // p ascends per lane: strict > keeps the first
          best_p = p;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const int os = __shfl_xor_sync(kFull, best_s, o);
        const int op = __shfl_xor_sync(kFull, best_p, o);
        if (os > best_s || (os == best_s && op < best_p)) {
          best_s = os;
          best_p = op;
        }
      }
    }
    if (lane == 0) {
      int score = 0, cov_q = 0, cov_t = 0, sqp = 0, stp = 0, bp = -1;
      if (v_t) {
        if (best_s > 0) {
          const int gq = qp_t - s_qp[best_p] - k;
          const int gt = tp_t - s_tp[best_p] - k;
          score = best_s + 1;
          cov_q = st_cov_q[best_p] + k + (gq < 0 ? gq : 0);
          cov_t = st_cov_t[best_p] + k + (gt < 0 ? gt : 0);
          sqp = st_s_qp[best_p];
          stp = st_s_tp[best_p];
          bp = best_p;
        } else {
          score = 1;
          cov_q = k;
          cov_t = k;
          sqp = qp_t;
          stp = tp_t;
        }
      }
      st_score[t] = score;
      st_cov_q[t] = cov_q;
      st_cov_t[t] = cov_t;
      st_s_qp[t] = sqp;
      st_s_tp[t] = stp;
      st_bp[t] = bp;
    }
    __syncwarp();  // step t's state is visible to every lane at step t+1
  }

  for (int i = lane; i < A; i += 32) {
    o_score[off + i] = st_score[i];
    o_cov_q[off + i] = st_cov_q[i];
    o_cov_t[off + i] = st_cov_t[i];
    o_s_qp[off + i] = st_s_qp[i];
    o_s_tp[off + i] = st_s_tp[i];
    o_bp[off + i] = st_bp[i];
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success).  All
// arrays are [P, A] int32, row-major and contiguous, on the current device.
int chain_scan_launch(const int* qi, const int* tj, const int* qp,
                      const int* tp, const int* valid, int* score,
                      int* cov_q, int* cov_t, int* s_qp, int* s_tp, int* bp,
                      int P, int A, int k, int variant, void* stream) {
  if (P <= 0 || A <= 0) return (int)cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t per_warp = (size_t)kArrays * A * sizeof(int);
  int warps = kMaxWarps;
  while (warps > 1 && per_warp * warps > (size_t)max_smem) --warps;
  const size_t smem = per_warp * warps;
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(chain_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((P + warps - 1) / warps);
  chain_scan_kernel<<<blocks, warps * 32, smem, (cudaStream_t)stream>>>(
      qi, tj, qp, tp, valid, score, cov_q, cov_t, s_qp, s_tp, bp, P, A, k,
      variant);
  return (int)cudaGetLastError();
}

const char* chain_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
