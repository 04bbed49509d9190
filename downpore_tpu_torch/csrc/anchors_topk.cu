// Anchor build, two target hits per query seed: a hand-written Hopper
// kernel (sm_90a) for the function the JAX package leaves to XLA inside its
// jit, downpore_tpu/ops/chain.py:57 make_anchors_topk (per_seed = 2), which
// the map and overlap engines call on the pair budget's (query row, chunk)
// slots (downpore_tpu/ops/map_engine.py _build_anchors) and the trimmer on
// its (window, adapter) pairs (downpore_tpu/ops/window_engine.py
// _anchors_chunked).
//
// What it computes, for pair p and query seed i with qs[p, i] >= 0: the
// first two target indices j, ascending, with ts[p, j] == qs[p, i] (so
// ts[p, j] >= 0).  Outputs are [P, 2 NQ] in (i, slot) row-major order: a hit
// has qi = i, tj = j, qp = qpos[p, i], tp = tpos[p, j], valid = 1; a miss has
// qi = -1, tj = qp = tp = 0, valid = 0; overflow[p] is the pair's matches
// minus its valid anchors.  Two entries share the kernel: plain rows (row p
// of each input array, any row stride, contiguous within a row) and indexed
// rows, where the query row is q[mi[p]] and the target row t[ci[p]] of
// resident tables, and a slot with live[p] == 0 has every query seed -1.
//
// What bounds it: the P NQ NT compares, about 3 int32 operations each
// (compare, count, select; the update on a hit is rare), over 132 SMs x 64
// INT32 lanes x 1.98 GHz = 16.73 T/s, against the bytes (each pair's rows
// read once, 17 bytes an output slot written once) over 3.35 TB/s: at every
// path shape the operations dominate (overlap: NQ = 128, NT up to 4096).
//
// Design: one warp per pair, four pairs a block.  Lane l owns the query seeds
// i = g + l + 32 s (s < S, groups g of 32 S) in registers, with a dead seed
// made -1; the warp stages the target row's seeds in shared memory in tiles
// of TJ (a dead target seed made -2, so that one compare tests equality and
// both signs), and every lane scans the tile in ascending j with broadcast
// 16-byte reads, comparing each value with its S seeds: the first two hits
// are kept, the rest only counted.  A group whose seeds are all dead (an
// engine's dead budget slot) is not scanned.  Writes are coalesced: for a
// fixed s the warp's lanes write 64 consecutive slots.  Nothing of the
// [P, NQ, NT] equality is ever written.
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;      // pairs a block
constexpr int TJ = 1024;      // target seeds staged a tile, per warp

struct AnchorParams {
  const int* qs;
  const int* qpos;
  const int* ts;
  const int* tpos;
  long long qs_stride, qpos_stride, ts_stride, tpos_stride;
  const long long* mi;        // indexed entry: query row of each pair
  const long long* ci;        // indexed entry: target row of each pair
  const unsigned char* live;  // indexed entry: 0 = dead slot
  int* qi;
  int* tj;
  int* qp;
  int* tp;
  unsigned char* valid;
  int* overflow;
  long long P;
  int NQ, NT;
};

template <int S>
__global__ void __launch_bounds__(WARPS * 32)
anchors_topk_kernel(AnchorParams a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int* tile = reinterpret_cast<int*>(smem) + warp * TJ;
  const long long p = (long long)blockIdx.x * WARPS + warp;
  if (p >= a.P) return;  // warp-uniform
  long long qrow = p, trow = p;
  bool on = true;
  if (a.mi != nullptr) {
    qrow = a.mi[p];
    trow = a.ci[p];
    on = a.live[p] != 0;
  }
  const int* qs = a.qs + qrow * a.qs_stride;
  const int* qpos = a.qpos + qrow * a.qpos_stride;
  const int* ts = a.ts + trow * a.ts_stride;
  const int* tpos = a.tpos + trow * a.tpos_stride;
  const int A = 2 * a.NQ;
  int* qi = a.qi + p * A;
  int* tj = a.tj + p * A;
  int* qp = a.qp + p * A;
  int* tp = a.tp + p * A;
  unsigned char* valid = a.valid + p * A;
  int extra = 0;  // matches beyond the first two, this lane's seeds
  for (int g = 0; g < a.NQ; g += 32 * S) {
    int q[S], n[S], j0[S], j1[S];
    bool any = false;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int i = g + lane + 32 * s;
      const int v = (on && i < a.NQ) ? qs[i] : -1;
      q[s] = v >= 0 ? v : -1;
      any |= v >= 0;
      n[s] = 0;
      j0[s] = 0;
      j1[s] = 0;
    }
    if (__any_sync(0xffffffffu, any)) {
      for (int jt = 0; jt < a.NT; jt += TJ) {
        const int len = min(TJ, a.NT - jt);
        const int len4 = (len + 3) & ~3;
        __syncwarp();
        for (int x = lane; x < len4; x += 32) {
          const int v = x < len ? ts[jt + x] : -2;
          tile[x] = v >= 0 ? v : -2;
        }
        __syncwarp();
        const int4* t4 = reinterpret_cast<const int4*>(tile);
        for (int x = 0; x < len4; x += 4) {
          const int4 v4 = t4[x >> 2];
          const int vs[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = jt + x + u;
#pragma unroll
            for (int s = 0; s < S; ++s) {
              if (vs[u] == q[s]) {
                if (n[s] == 0)
                  j0[s] = j;
                else if (n[s] == 1)
                  j1[s] = j;
                ++n[s];
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int i = g + lane + 32 * s;
      if (i < a.NQ) {
        const bool v0 = n[s] >= 1, v1 = n[s] >= 2;
        const int qpi = (v0 ? qpos[i] : 0);
        reinterpret_cast<int2*>(qi)[i] = make_int2(v0 ? i : -1, v1 ? i : -1);
        reinterpret_cast<int2*>(tj)[i] = make_int2(j0[s], j1[s]);
        reinterpret_cast<int2*>(qp)[i] = make_int2(qpi, v1 ? qpi : 0);
        reinterpret_cast<int2*>(tp)[i] =
            make_int2(v0 ? tpos[j0[s]] : 0, v1 ? tpos[j1[s]] : 0);
        reinterpret_cast<uchar2*>(valid)[i] =
            make_uchar2(v0 ? 1 : 0, v1 ? 1 : 0);
        extra += n[s] - (n[s] < 2 ? n[s] : 2);
      }
    }
  }
  const int total = __reduce_add_sync(0xffffffffu, extra);
  if (lane == 0) a.overflow[p] = total;
}

}  // namespace

extern "C" {

// Launches the kernel on ``stream`` (PyTorch's current stream) and returns
// cudaGetLastError() after the launch (0: launched).  mi, ci and live are
// null for the plain-rows entry.  Row strides are in elements; rows must be
// contiguous.  Outputs are [P, 2 NQ] (int32, valid one byte) and [P].
int anchors_topk_launch(const int* qs, const int* qpos, const int* ts,
                        const int* tpos, long long qs_stride,
                        long long qpos_stride, long long ts_stride,
                        long long tpos_stride, const long long* mi,
                        const long long* ci, const unsigned char* live,
                        int* qi, int* tj, int* qp, int* tp,
                        unsigned char* valid, int* overflow, long long P,
                        int NQ, int NT, void* stream) {
  AnchorParams p;
  p.qs = qs;
  p.qpos = qpos;
  p.ts = ts;
  p.tpos = tpos;
  p.qs_stride = qs_stride;
  p.qpos_stride = qpos_stride;
  p.ts_stride = ts_stride;
  p.tpos_stride = tpos_stride;
  p.mi = mi;
  p.ci = ci;
  p.live = live;
  p.qi = qi;
  p.tj = tj;
  p.qp = qp;
  p.tp = tp;
  p.valid = valid;
  p.overflow = overflow;
  p.P = P;
  p.NQ = NQ;
  p.NT = NT;
  if (P <= 0 || NQ <= 0) return cudaErrorInvalidValue;
  // seeds a lane holds: the fewest groups of 32 S that cover NQ, S <= 8
  const int need = (NQ + 31) / 32;
  void (*kern)(AnchorParams) = nullptr;
  switch (need < 8 ? need : 8) {
    case 1: kern = anchors_topk_kernel<1>; break;
    case 2: kern = anchors_topk_kernel<2>; break;
    case 3: kern = anchors_topk_kernel<3>; break;
    case 4: kern = anchors_topk_kernel<4>; break;
    case 5: kern = anchors_topk_kernel<5>; break;
    case 6: kern = anchors_topk_kernel<6>; break;
    case 7: kern = anchors_topk_kernel<7>; break;
    default: kern = anchors_topk_kernel<8>; break;
  }
  const unsigned grid = (unsigned)((P + WARPS - 1) / WARPS);
  const unsigned threads = WARPS * 32;
  const size_t smem = (size_t)WARPS * TJ * sizeof(int);
  kern<<<grid, threads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

const char* anchors_topk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
