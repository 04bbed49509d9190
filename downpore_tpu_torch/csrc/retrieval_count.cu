// Retrieval counts as a gather-reduce: a hand-written Hopper kernel (sm_90a)
// for the functions the JAX package leaves to XLA inside its jit,
// downpore_tpu/ops/map_engine.py:107 _count_rows, :142 _count_rows_pair and
// :518 _binned_counts_pair (the flat gate, the binned gate's two levels, the
// seed shards' partial counts and overlap's counts).
//
// What it computes: out[m, c] = sum over r of [b[m, r] >= 0] mem[row, c] in
// int32, row = min(b[m, r], H - 1), over an int8 [H, W] matrix; with a
// ``first`` mask a second sum d[m, c] takes only the slots with first[m, r]
// set (the distinct count, from the same read of each row); in the binned
// form row = clip(b[m, r] NB + topbin[m, bb], 0, H - 1) over the membership
// viewed as [H, W] = [H0 NB, CB], and the outputs are [M, BB, W].
//
// What bounds it: the gathered bytes, M R_live W int8 read from the
// membership (each row read once a query row that names it), plus the int32
// outputs written once, over 3.35 TB/s, against the M R W adds (and as many
// again for d) over 16.73 T int32 operations a second; the bytes lead at
// the engines' shapes.
//
// Design: a team of T threads (a power of two, T 16 >= W up to 256 threads)
// owns one output row (m, bb) and a tile of T 16 columns; a block holds 256 /
// T teams.  Each team stages its row's R slots in shared memory, RT at a
// time (at most 256, and 32 KB a block): the membership row each live slot
// reads (and its ``first`` bit), -1 for a dead one.  Each thread owns 16 consecutive columns, reads them from
// every live gathered row with 16-byte loads (4-byte or 1-byte loads when W
// is not a multiple of 16 or 4), masks the ragged tail, and keeps 16 (32 with
// d) int32 sums in registers.  No [M, R, W] block is ever written and there
// are no row chunks.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int COLS = 16;      // columns a thread owns

struct CountParams {
  const signed char* mem;       // [H, W] int8
  const int* b;                 // [M, R] buckets, -1 padded
  const unsigned char* first;   // [M, R] or null
  const long long* topbin;      // [M, BB] or null (flat form, BB = 1)
  int* c;                       // [M, BB, W]
  int* d;                       // [M, BB, W] or null
  long long M;
  long long H;                  // rows of mem
  int R, BB, NB, W;
  int T;                        // threads a team
  int RT;                       // slots staged at a time, per team
  int tiles;                    // column tiles of T COLS
};

template <int VEC>
__device__ __forceinline__ void load16(const signed char* src, int ok,
                                       signed char* v) {
  // ``ok`` of the 16 bytes lie inside the row (a multiple of VEC)
  if (VEC == 1) {
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = k < ok ? src[k] : 0;
  } else if (VEC == 16 && ok == 16) {
    const int4 w = *reinterpret_cast<const int4*>(src);
    const int ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < 16; ++k)
      v[k] = (signed char)(ws[k >> 2] >> (8 * (k & 3)));
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int w =
          4 * q < ok ? *reinterpret_cast<const int*>(src + 4 * q) : 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) v[4 * q + k] = (signed char)(w >> (8 * k));
    }
  }
}

template <int VEC, bool DIST>
__global__ void __launch_bounds__(THREADS) retrieval_count_kernel(CountParams a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = a.T;
  const int teams = THREADS / T;
  const int team = threadIdx.x / T;
  const int t = threadIdx.x % T;
  const int RT = a.RT;
  int* slots = reinterpret_cast<int*>(smem) + team * RT;
  const long long n_out = a.M * a.BB;
  const long long row_blocks = (n_out + teams - 1) / teams;
  const int tile = (int)(blockIdx.x / row_blocks);
  const long long o = (blockIdx.x % row_blocks) * teams + team;
  const bool live_row = o < n_out;
  const long long m = live_row ? o / a.BB : 0;
  const long long bb = live_row ? o % a.BB : 0;
  const long long base = a.topbin != nullptr
                             ? a.topbin[m * a.BB + bb] : 0;
  const int col0 = (tile * T + t) * COLS;
  const int ok = live_row ? max(0, min(COLS, a.W - col0)) : 0;
  int cs[COLS], ds[COLS];
#pragma unroll
  for (int k = 0; k < COLS; ++k) {
    cs[k] = 0;
    ds[k] = 0;
  }
  for (int r0 = 0; r0 < a.R; r0 += RT) {
    const int len = min(RT, a.R - r0);
    __syncthreads();
    for (int x = t; x < len; x += T) {
      int s = -1;
      if (live_row) {
        const long long i = m * a.R + r0 + x;
        const int bv = a.b[i];
        if (bv >= 0) {
          long long row = a.topbin != nullptr
                              ? (long long)bv * a.NB + base
                              : (long long)bv;
          row = row < 0 ? 0 : (row >= a.H ? a.H - 1 : row);
          const int f = DIST ? (a.first[i] != 0) : 0;
          s = (int)(row << 1) | f;
        }
      }
      slots[x] = s;
    }
    __syncthreads();
    if (ok > 0) {
      for (int x = 0; x < len; ++x) {
        const int s = slots[x];
        if (s < 0) continue;
        const signed char* src = a.mem + (long long)(s >> 1) * a.W + col0;
        signed char v[COLS];
        load16<VEC>(src, ok, v);
        const int fm = -(s & 1);
#pragma unroll
        for (int k = 0; k < COLS; ++k) {
          cs[k] += v[k];
          if (DIST) ds[k] += v[k] & fm;
        }
      }
    }
  }
  if (ok > 0) {
    int* cdst = a.c + o * a.W + col0;
    int* ddst = DIST ? a.d + o * a.W + col0 : nullptr;
    if (ok == COLS && (a.W & 3) == 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        reinterpret_cast<int4*>(cdst)[q] =
            make_int4(cs[4 * q], cs[4 * q + 1], cs[4 * q + 2], cs[4 * q + 3]);
        if (DIST)
          reinterpret_cast<int4*>(ddst)[q] = make_int4(
              ds[4 * q], ds[4 * q + 1], ds[4 * q + 2], ds[4 * q + 3]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < COLS; ++k) {
        if (k < ok) {
          cdst[k] = cs[k];
          if (DIST) ddst[k] = ds[k];
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches the kernel on ``stream`` (PyTorch's current stream) and returns
// cudaGetLastError() after the launch (0: launched).  ``first``, ``d`` and
// ``topbin`` may be null (no distinct count; the flat form, BB = 1).  All
// arrays are contiguous; mem is [H, W], b and first [M, R], topbin [M, BB],
// c and d [M, BB, W].
int retrieval_count_launch(const signed char* mem, const int* b,
                           const unsigned char* first,
                           const long long* topbin, int* c, int* d,
                           long long M, long long H, int R, int BB, int NB,
                           int W, void* stream) {
  CountParams p;
  p.mem = mem;
  p.b = b;
  p.first = first;
  p.topbin = topbin;
  p.c = c;
  p.d = d;
  p.M = M;
  p.H = H;
  p.R = R;
  p.BB = BB;
  p.NB = NB;
  p.W = W;
  // a staged slot packs (row << 1) | first into an int
  if (M <= 0 || W <= 0 || BB <= 0 || H <= 0 || H >= (1LL << 30) ||
      (first == nullptr) != (d == nullptr))
    return cudaErrorInvalidValue;
  // threads a team: the power of two whose COLS columns each cover W, at
  // most a block; wider rows take several column tiles
  int T = 1;
  while (T < THREADS && T * COLS < W) T *= 2;
  p.T = T;
  p.tiles = (W + T * COLS - 1) / (T * COLS);
  const int teams = THREADS / T;
  // 32 KB of staged slots a block, at most 256 a team
  p.RT = 8192 / teams < 256 ? 8192 / teams : 256;
  const long long row_blocks = (M * BB + teams - 1) / teams;
  const unsigned grid = (unsigned)(row_blocks * p.tiles);
  const unsigned threads = THREADS;
  const size_t smem = (size_t)teams * p.RT * sizeof(int);
  const bool dist = first != nullptr;
  // the widest load every row start allows (mem rows are W bytes apart)
  const int vec = (W % 16 == 0 && ((unsigned long long)mem & 15) == 0) ? 16
                  : (W % 4 == 0 && ((unsigned long long)mem & 3) == 0) ? 4
                                                                       : 1;
  void (*kern)(CountParams) = nullptr;
  if (vec == 16)
    kern = dist ? retrieval_count_kernel<16, true>
                : retrieval_count_kernel<16, false>;
  else if (vec == 4)
    kern = dist ? retrieval_count_kernel<4, true>
                : retrieval_count_kernel<4, false>;
  else
    kern = dist ? retrieval_count_kernel<1, true>
                : retrieval_count_kernel<1, false>;
  kern<<<grid, threads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

const char* retrieval_count_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
