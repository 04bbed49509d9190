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
// minus its valid anchors (a query value that occurs twice counts its
// matches twice).  Two entries share the kernel: plain rows (row p of each
// input array, any row stride, contiguous within a row) and indexed rows,
// where the query row is q[mi[p]] and the target row t[ci[p]] of resident
// tables, and a slot with live[p] == 0 has every query seed -1.
//
// What bounds it: the function needs one lookup per live target seed in a
// table of the pair's live query seeds and one insert per live query seed
// (a few int32 operations each, over 132 SMs x 64 INT32 lanes x 1.98 GHz =
// 16.73 T/s), against the bytes (each pair's rows read once, 17 bytes an
// output slot written once) over 3.35 TB/s: the bytes lead at every path
// shape.
//
// Design: one warp per pair, up to eight pairs a block.  The warp builds an
// open-addressed hash table of the pair's live query seed values in shared
// memory (TS = the power of two >= 2 NQ, at least 32 entries; a
// multiplicative hash, linear probing, keys inserted with atomicCAS so that
// equal values share one entry): each entry keeps its value's match count
// n and first two hits j0, j1.  The warp then scans the target row once in
// ascending j, 32 consecutive seeds a step (four steps' seeds loaded at
// once): a lane looks its seed up, lanes that hit one entry in a step form a
// group (__match_any_sync on the entry), and the group's lowest lane, which
// has its smallest j, alone updates the entry: the first hits go to j0 and
// j1 in lane order, and n grows by the group's size.  Steps run in order and
// one lane writes an entry a step, so the order is exact without atomics.
// Last, each query seed reads its value's entry and writes its two slots
// (coalesced 8-byte stores).  A pair without a live query seed (an engine's
// dead budget slot) writes misses without a scan.  Nothing of the
// [P, NQ, NT] equality is ever formed.
#include <cuda_runtime.h>

namespace {

constexpr int MAX_WARPS = 8;           // pairs a block
constexpr int SMEM_BLOCK = 48 * 1024;  // shared bytes a block, no opt-in
constexpr int MAX_NQ = 1024;           // a warp's table fits SMEM_BLOCK
constexpr int STEPS = 4;               // target steps loaded at once
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned HASH_MUL = 0x9E3779B1u;  // 2^32 / the golden ratio

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
  int bits;                   // log2 of the table's entries
  int warps;                  // pairs a block
};

// log2 of a table for NQ query seeds: the power of two >= 2 NQ, >= 32
__host__ __device__ inline int table_bits(int NQ) {
  int b = 5;
  while ((1 << b) < 2 * NQ) ++b;
  return b;
}

// the entry a value v >= 0 probes first
__host__ __device__ inline unsigned first_slot(int v, int bits) {
  return ((unsigned)v * HASH_MUL) >> (32 - bits);
}

// the entry holding v, or -1 when v is not a key
__device__ inline int find(const int* keys, int v, int bits) {
  const unsigned mask = (1u << bits) - 1u;
  unsigned h = first_slot(v, bits);
  while (true) {
    const int k = keys[h];
    if (k == v) return (int)h;
    if (k < 0) return -1;
    h = (h + 1u) & mask;
  }
}

__global__ void __launch_bounds__(MAX_WARPS * 32)
anchors_topk_kernel(AnchorParams a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int TS = 1 << a.bits;
  int* keys = reinterpret_cast<int*>(smem) + warp * 4 * TS;
  int* cnt = keys + TS;    // matches of each entry's value
  int* hit0 = cnt + TS;    // its first hit (valid when cnt >= 1)
  int* hit1 = hit0 + TS;   // its second hit (valid when cnt >= 2)
  const long long p = (long long)blockIdx.x * a.warps + warp;
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

  // the table of the pair's live query seeds
  bool any = false;
  if (on) {  // warp-uniform
    for (int x = lane; x < TS; x += 32) {
      keys[x] = -1;
      cnt[x] = 0;
    }
    __syncwarp();
    for (int i = lane; i < a.NQ; i += 32) {
      const int v = qs[i];
      if (v < 0) continue;
      any = true;
      unsigned h = first_slot(v, a.bits);
      while (true) {
        const int k = atomicCAS(&keys[h], -1, v);
        if (k < 0 || k == v) break;
        h = (h + 1u) & (unsigned)(TS - 1);
      }
    }
    any = __any_sync(FULL, any);
    __syncwarp();
  }

  // one scan of the target row, ascending j
  if (any) {  // warp-uniform
    for (int jb = 0; jb < a.NT; jb += 32 * STEPS) {
      int v[STEPS];
#pragma unroll
      for (int u = 0; u < STEPS; ++u) {
        const int j = jb + 32 * u + lane;
        v[u] = j < a.NT ? ts[j] : -1;
      }
#pragma unroll
      for (int u = 0; u < STEPS; ++u) {
        const int e = v[u] >= 0 ? find(keys, v[u], a.bits) : -1;
        if (__ballot_sync(FULL, e >= 0) == 0) continue;  // warp-uniform
        const unsigned grp = __match_any_sync(FULL, e);
        if (e >= 0 && (grp & ((1u << lane) - 1u)) == 0) {
          // the group's lowest lane: its smallest j
          const int j = jb + 32 * u + lane;
          const int n = cnt[e];
          if (n == 0) {
            hit0[e] = j;
            const unsigned rest = grp & (grp - 1u);
            if (rest != 0) hit1[e] = jb + 32 * u + __ffs(rest) - 1;
          } else if (n == 1) {
            hit1[e] = j;
          }
          cnt[e] = n + __popc(grp);
        }
        __syncwarp();
      }
    }
  }

  // each query seed's two slots
  const int A = 2 * a.NQ;
  int* qi = a.qi + p * A;
  int* tj = a.tj + p * A;
  int* qp = a.qp + p * A;
  int* tp = a.tp + p * A;
  unsigned char* valid = a.valid + p * A;
  int extra = 0;  // matches beyond the first two, this lane's seeds
  for (int i = lane; i < a.NQ; i += 32) {
    int n = 0, j0 = 0, j1 = 0;
    if (any) {
      const int v = qs[i];
      if (v >= 0) {
        const int e = find(keys, v, a.bits);
        n = cnt[e];
        j0 = n >= 1 ? hit0[e] : 0;
        j1 = n >= 2 ? hit1[e] : 0;
      }
    }
    const bool v0 = n >= 1, v1 = n >= 2;
    const int qpi = v0 ? qpos[i] : 0;
    reinterpret_cast<int2*>(qi)[i] = make_int2(v0 ? i : -1, v1 ? i : -1);
    reinterpret_cast<int2*>(tj)[i] = make_int2(j0, j1);
    reinterpret_cast<int2*>(qp)[i] = make_int2(qpi, v1 ? qpi : 0);
    reinterpret_cast<int2*>(tp)[i] =
        make_int2(v0 ? tpos[j0] : 0, v1 ? tpos[j1] : 0);
    reinterpret_cast<uchar2*>(valid)[i] = make_uchar2(v0 ? 1 : 0, v1 ? 1 : 0);
    extra += n - (n < 2 ? n : 2);
  }
  const int total = __reduce_add_sync(FULL, extra);
  if (lane == 0) a.overflow[p] = total;
}

}  // namespace

extern "C" {

// Launches the kernel on ``stream`` (PyTorch's current stream) and returns
// cudaGetLastError() after the launch (0: launched).  mi, ci and live are
// null for the plain-rows entry.  Row strides are in elements; rows must be
// contiguous.  Outputs are [P, 2 NQ] (int32, valid one byte) and [P].
// Takes 1 <= NQ <= 1024.
int anchors_topk_launch(const int* qs, const int* qpos, const int* ts,
                        const int* tpos, long long qs_stride,
                        long long qpos_stride, long long ts_stride,
                        long long tpos_stride, const long long* mi,
                        const long long* ci, const unsigned char* live,
                        int* qi, int* tj, int* qp, int* tp,
                        unsigned char* valid, int* overflow, long long P,
                        int NQ, int NT, void* stream) {
  if (P <= 0 || NQ <= 0 || NQ > MAX_NQ || NT < 0)
    return cudaErrorInvalidValue;
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
  p.bits = table_bits(NQ);
  // a warp's table: key, count and two hits an entry
  const size_t per_warp = (size_t)4 * sizeof(int) << p.bits;
  const int fit = (int)(SMEM_BLOCK / per_warp);
  p.warps = fit < MAX_WARPS ? fit : MAX_WARPS;
  const unsigned grid = (unsigned)((P + p.warps - 1) / p.warps);
  const unsigned threads = (unsigned)p.warps * 32;
  const size_t smem = per_warp * p.warps;
  anchors_topk_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// The table entry a query value v >= 0 probes first at width NQ (the hash
// the kernel uses; tests pick colliding values with it).
int anchors_topk_first_slot(int v, int NQ) {
  return (int)first_slot(v, table_bits(NQ));
}

const char* anchors_topk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
