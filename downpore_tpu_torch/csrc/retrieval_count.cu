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
// What bounds it: the bytes of the distinct membership rows the live slots
// name (each read once), plus the buckets and the int32 outputs, over 3.35
// TB/s, against an add per gathered byte (and one more for d) over 16.73 T
// int32 operations a second; the bytes lead at the engines' shapes.  The
// gathered bytes are several times the distinct ones where query rows share
// membership rows (overlap: ~3.4 reads a row), so the repeats have to come
// from L2.
//
// Design: a block of 256 threads owns a column tile of G output rows (m, bb):
// a team of T threads a row, each thread COLS columns (16; 8 on narrow
// rows, W <= 64), and S teams a row in one warp, each summing every S-th of
// the row's live slots (the R split).  The tile width T COLS is derived from
// the launch's shape: the widest power of two from 256 to 512 bytes whose
// tiles of the rows the launch may touch (min(H, M R BB)) fit in 40 MB of
// the 50 MB L2 (overlap: 256 bytes; map's 33.5 MB table: 512).  Blocks are
// ordered tile-major, and S is the smallest power of two (T S <= 32) for
// which about 132 x 512 threads in flight span one tile of all M BB rows:
// the blocks in flight then touch about one tile of the membership, so a
// row tile comes from device memory about once and its repeats from L2,
// and the card stays full.  Per round the block stages its rows' slots in
// shared memory, at most 256 a row: a ballot and a prefix compact each
// row's live slots (its membership row, with the ``first`` bit), so the
// gather loop has no branch, and a thread issues four independent row loads
// (16 bytes; 8 on narrow rows; 4 or 1 when W or the base allow no wider)
// before it adds any.  The sums are packed: each byte is biased to unsigned
// (x ^ 0x80), a 32-bit word split into its even and odd bytes
// (__byte_perm) and added as two 16-bit lanes, two adds for four bytes; at
// the end of each round the S teams of a row add their lanes (warp
// shuffles; the row's at most 256 slots: 255 x 256 < 65536), the lanes go
// into int32 sums, and 128 a slot comes off at the end (the ``first`` sum
// likewise, its slots' words masked whole).  The tile sizes, the split and
// the four loads in flight are the fastest of the variants measured on an
// H100 at the engines' shapes (PERF.md).  No [M, R, W] block is ever
// written.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MIN_TILE = 256;             // bytes of a column tile
constexpr int MAX_TILE = 512;
constexpr long long L2_FIT = 40LL << 20;   // 4/5 of an H100's 50 MB L2
constexpr long long RESIDENT = 132LL * 512;  // threads in flight, H100
constexpr int MAX_SPLIT = 8;              // teams a row at most
constexpr int UNROLL = 4;                 // row loads in flight a thread
constexpr int MAX_RT = 256;               // slots a row a round: a 16-bit
                                          // lane holds 256 bytes of 255
constexpr int STAGE_SLOTS = 8192;         // slots staged a block a round
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned BIAS = 0x80808080u;

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
  int T;                        // threads a team (one row's tile)
  int S;                        // teams a row (the R split), T S <= 32
  int G;                        // rows a block: THREADS / (T S)
  int RT;                       // slots a row staged a round: 2^rt_shift
  int rt_shift;
  long long row_blocks;         // blocks over the M BB rows, a tile
};

// the thread's NW words of row bytes [0, ok) (zero past ok); VEC bytes a
// load, ok a multiple of VEC
template <int VEC, int NW>
__device__ __forceinline__ void load_words(const signed char* src, int ok,
                                           unsigned* w) {
  if (VEC == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else if (VEC == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(src);
    w[0] = v.x;
    w[1] = v.y;
  } else if (VEC == 4) {
#pragma unroll
    for (int q = 0; q < NW; ++q)
      w[q] = 4 * q < ok ? *reinterpret_cast<const unsigned*>(src + 4 * q)
                        : 0u;
  } else {
#pragma unroll
    for (int q = 0; q < NW; ++q) {
      unsigned x = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * q + k < ok)
          x |= (unsigned)(unsigned char)src[4 * q + k] << (8 * k);
      w[q] = x;
    }
  }
}

// adds a row's words, biased, into the packed 16-bit lanes: even bytes to
// ce, odd bytes to co (and to de, dd where fm is all ones)
template <int NW, bool DIST>
__device__ __forceinline__ void add_words(const unsigned* w, unsigned fm,
                                          unsigned* ce, unsigned* co,
                                          unsigned* de, unsigned* dd) {
#pragma unroll
  for (int q = 0; q < NW; ++q) {
    const unsigned u = w[q] ^ BIAS;
    const unsigned ev = __byte_perm(u, 0u, 0x4240);  // bytes 0, 2
    const unsigned od = __byte_perm(u, 0u, 0x4341);  // bytes 1, 3
    ce[q] += ev;
    co[q] += od;
    if (DIST) {
      de[q] += ev & fm;
      dd[q] += od & fm;
    }
  }
}

// the packed lanes into the int32 sums of columns 4q .. 4q + 3; lanes reset
template <int NW>
__device__ __forceinline__ void flush(unsigned* ce, unsigned* co, int* s) {
#pragma unroll
  for (int q = 0; q < NW; ++q) {
    s[4 * q] += (int)(ce[q] & 0xffffu);
    s[4 * q + 1] += (int)(co[q] & 0xffffu);
    s[4 * q + 2] += (int)(ce[q] >> 16);
    s[4 * q + 3] += (int)(co[q] >> 16);
    ce[q] = 0u;
    co[q] = 0u;
  }
}

template <int VEC, int COLS, bool DIST>
__global__ void __launch_bounds__(THREADS) retrieval_count_kernel(CountParams a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NW = COLS / 4;
  const int T = a.T, S = a.S, G = a.G, RT = a.RT;
  const int TW = T * COLS;                      // the tile's bytes
  const int t = threadIdx.x % T;
  const int sp = (threadIdx.x / T) % S;         // this team's share of R
  const int g = threadIdx.x / (T * S);          // this team's row
  const int lane = threadIdx.x & 31;
  long long* rowoff = reinterpret_cast<long long*>(smem);  // [G] m R, or -1
  long long* rowbin = rowoff + THREADS;         // [G] topbin[m, bb]
  int* counts = reinterpret_cast<int*>(rowbin + THREADS);  // [G] live slots
  int* slots = counts + THREADS;                // [G, RT]
  const long long n_out = a.M * a.BB;
  const int tile = (int)(blockIdx.x / a.row_blocks);
  const long long o0 = (blockIdx.x % a.row_blocks) * G;
  if (threadIdx.x < G) {
    const long long ot = o0 + threadIdx.x;
    rowoff[threadIdx.x] = ot < n_out ? (ot / a.BB) * a.R : -1;
    rowbin[threadIdx.x] =
        ot < n_out && a.topbin != nullptr ? a.topbin[ot] : 0;
  }
  const long long o = o0 + g;
  const int col0 = tile * TW + t * COLS;
  const int ok = o < n_out ? max(0, min(COLS, a.W - col0)) : 0;
  const signed char* src = a.mem + col0;
  const int* mine = slots + g * RT;
  int cs[COLS], ds[COLS];
  unsigned ce[NW], co[NW], de[NW], dd[NW];
#pragma unroll
  for (int k = 0; k < COLS; ++k) {
    cs[k] = 0;
    ds[k] = 0;
  }
#pragma unroll
  for (int q = 0; q < NW; ++q) ce[q] = co[q] = de[q] = dd[q] = 0u;
  int n_live = 0, n_first = 0;
  for (int r0 = 0; r0 < a.R; r0 += RT) {
    // stage the live slots of the block's rows, compacted per row (a
    // warp's 32 slots lie in one row: 32 | RT); four rounds of the block's
    // loads go out before their ballots
    __syncthreads();
    if (threadIdx.x < G) counts[threadIdx.x] = 0;
    __syncthreads();
    for (int x0 = 0; x0 < G * RT; x0 += 4 * THREADS) {
      int sv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = x0 + u * THREADS + threadIdx.x;
        const int tl = idx >> a.rt_shift;
        const int x = idx & (RT - 1);
        int sl = -1;
        if (idx < G * RT && r0 + x < a.R && rowoff[tl] >= 0) {
          const long long i = rowoff[tl] + r0 + x;
          const int bv = a.b[i];
          if (bv >= 0) {
            long long row = a.topbin != nullptr
                                ? (long long)bv * a.NB + rowbin[tl]
                                : (long long)bv;
            row = row < 0 ? 0 : (row >= a.H ? a.H - 1 : row);
            const int f = DIST ? (a.first[i] != 0) : 0;
            sl = (int)(row << 1) | f;
          }
        }
        sv[u] = sl;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = x0 + u * THREADS + threadIdx.x;
        if (idx - lane >= G * RT) break;  // warp-uniform: 32 | G RT
        const unsigned live = __ballot_sync(FULL, sv[u] >= 0);
        const int tl = idx >> a.rt_shift;
        int at = 0;
        if (lane == 0 && live != 0) at = atomicAdd(&counts[tl], __popc(live));
        at = __shfl_sync(FULL, at, 0);
        if (sv[u] >= 0)
          slots[tl * RT + at + __popc(live & ((1u << lane) - 1u))] = sv[u];
      }
    }
    __syncthreads();
    const int n = counts[g];
    n_live += n;
    if (ok > 0) {
      // this team's share of the row's live slots: sp, sp + S, ...
      int x = sp;
      for (; x + (UNROLL - 1) * S < n; x += UNROLL * S) {
        unsigned w[UNROLL][NW];
        int sl[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          sl[u] = mine[x + u * S];
          load_words<VEC, NW>(src + (long long)(sl[u] >> 1) * a.W, ok, w[u]);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          add_words<NW, DIST>(w[u], 0u - (unsigned)(sl[u] & 1), ce, co, de,
                              dd);
          if (DIST) n_first += sl[u] & 1;
        }
      }
      for (; x < n; x += S) {
        unsigned w[NW];
        const int sl = mine[x];
        load_words<VEC, NW>(src + (long long)(sl >> 1) * a.W, ok, w);
        add_words<NW, DIST>(w, 0u - (unsigned)(sl & 1), ce, co, de, dd);
        if (DIST) n_first += sl & 1;
      }
    }
    // the S teams of a row (lanes T, 2T, ... apart in one warp) add their
    // packed lanes (the row's at most 256 slots of the round), then every
    // thread moves them into its int32 sums
    for (int m = T; m < T * S; m <<= 1) {  // warp-uniform
#pragma unroll
      for (int q = 0; q < NW; ++q) {
        ce[q] += __shfl_xor_sync(FULL, ce[q], m);
        co[q] += __shfl_xor_sync(FULL, co[q], m);
        if (DIST) {
          de[q] += __shfl_xor_sync(FULL, de[q], m);
          dd[q] += __shfl_xor_sync(FULL, dd[q], m);
        }
      }
    }
    flush<NW>(ce, co, cs);
    if (DIST) flush<NW>(de, dd, ds);
  }
  if (DIST) {
    for (int m = T; m < T * S; m <<= 1)  // warp-uniform
      n_first += __shfl_xor_sync(FULL, n_first, m);
  }
  if (sp != 0 || ok == 0) return;
  int* cdst = a.c + o * a.W + col0;
  int* ddst = DIST ? a.d + o * a.W + col0 : nullptr;
#pragma unroll
  for (int k = 0; k < COLS; ++k) {
    cs[k] -= 128 * n_live;
    if (DIST) ds[k] -= 128 * n_first;
  }
  if (ok == COLS && (a.W & 3) == 0) {
#pragma unroll
    for (int q = 0; q < NW; ++q) {
      reinterpret_cast<int4*>(cdst)[q] = make_int4(
          cs[4 * q], cs[4 * q + 1], cs[4 * q + 2], cs[4 * q + 3]);
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

template <int VEC, int COLS>
void (*pick(bool dist))(CountParams) {
  return dist ? retrieval_count_kernel<VEC, COLS, true>
              : retrieval_count_kernel<VEC, COLS, false>;
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
  // a staged slot packs (row << 1) | first into an int
  if (M <= 0 || W <= 0 || BB <= 0 || R < 0 || H <= 0 || H >= (1LL << 30) ||
      (first == nullptr) != (d == nullptr))
    return cudaErrorInvalidValue;
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
  // the widest load every row start allows (mem rows are W bytes apart):
  // 8-byte loads of 8 columns a thread on narrow rows, else 16 columns a
  // thread in 16-, 4- or 1-byte loads
  const unsigned long long base = (unsigned long long)mem;
  const int vec = (W <= 64 && W % 8 == 0 && (base & 7) == 0)   ? 8
                  : (W % 16 == 0 && (base & 15) == 0)           ? 16
                  : (W % 4 == 0 && (base & 3) == 0)             ? 4
                                                                : 1;
  const int cols = vec == 8 ? 8 : 16;
  // the rows the launch may touch, and the widest column tile (a power of
  // two from MIN_TILE to MAX_TILE bytes) whose row tiles fit L2_FIT
  const long long gathered = M * (long long)R * BB;
  const long long rows = gathered < H ? (gathered > 0 ? gathered : 1) : H;
  int tile = MAX_TILE;
  while (tile > MIN_TILE && (long long)tile * rows > L2_FIT) tile /= 2;
  // threads a team: its tile, no wider than W needs
  int T = 1;
  while (T * cols < tile && T * cols < W) T *= 2;
  const int TW = T * cols;
  const int tiles = (W + TW - 1) / TW;
  // the R split: until the threads in flight span about one tile of all
  // the output rows, with a row's S teams in one warp (T S <= 32), at most
  // MAX_SPLIT and R / 16 (a team keeps at least 16 slots of a row)
  int S = 1;
  while (S < MAX_SPLIT && 2 * S * T <= 32 && 16 * S <= R &&
         RESIDENT * cols > (long long)S * M * BB * TW)
    S *= 2;
  p.T = T;
  p.S = S;
  p.G = THREADS / (T * S);
  // slots a row a round: a power of two from a warp to MAX_RT that covers
  // R, while the block's rows stage at most STAGE_SLOTS
  int shift = 5;
  while ((1 << shift) < R && (1 << shift) < MAX_RT &&
         p.G << (shift + 1) <= STAGE_SLOTS)
    ++shift;
  p.rt_shift = shift;
  p.RT = 1 << shift;
  p.row_blocks = (M * BB + p.G - 1) / p.G;
  const unsigned grid = (unsigned)(p.row_blocks * tiles);
  const unsigned threads = THREADS;
  const size_t smem = (size_t)THREADS * 2 * sizeof(long long) +
                      (size_t)(THREADS + p.G * p.RT) * sizeof(int);
  const bool dist = first != nullptr;
  void (*kern)(CountParams) = vec == 16  ? pick<16, 16>(dist)
                              : vec == 8 ? pick<8, 8>(dist)
                              : vec == 4 ? pick<4, 16>(dist)
                                         : pick<1, 16>(dist);
  kern<<<grid, threads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

const char* retrieval_count_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
