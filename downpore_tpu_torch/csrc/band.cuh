// One 32-wide DTW band update on one warp: lane i owns band lane i.
//
// The recurrence of downpore_tpu/ops/pallas_band.py:_band_kernel and
// downpore_tpu/ops/dtw.py:_band_update (ref: the reference's SSE kernel,
// sequence/alignment/asm_amd64.s:17-149):
//
//   raw[i] = min(p[i], p[i+1], p[i-1] + d[i-1], p[i-2] + d[i-2] + d[i-1])
//            + d[i]                      every add saturating at FULL
//   m      = min(raw)                    over the warp
//   out[i] = max(raw[i] - m, 0), then FULL where >= threshold
//
// Out-of-range neighbours count as FULL.  The neighbour terms are warp
// shuffles and the row minimum a warp reduction, so a band never leaves
// registers.  Adds wrap as two's-complement int32, as the reference
// engines' int32 lanes do, before the saturating min.
#pragma once

namespace band {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

template <int FULL>
__device__ __forceinline__ int sat_add(int a, int b) {
  return min(wrap_add(a, b), FULL);
}

// Band step for lane `lane` with previous band value `p` and distance `d`.
// A lane with `valid` false takes part as p = FULL (set by the caller) and
// leaves the row minimum alone (raw = FULL).  Returns the new band value;
// `*m` receives the row minimum on every lane.
template <int FULL>
__device__ __forceinline__ int step(int p, int d, int lane, int threshold,
                                    bool valid, int* m) {
  int stay = __shfl_down_sync(kFullMask, p, 1);
  if (lane == 31) stay = FULL;
  const int pd = sat_add<FULL>(p, d);
  int skip1 = __shfl_up_sync(kFullMask, pd, 1);
  if (lane == 0) skip1 = FULL;
  const int d_next = __shfl_down_sync(kFullMask, d, 1);
  // two[i] = sat(pd[i] + d[i+1]); skip2[i] = two[i-2]
  const int two = sat_add<FULL>(pd, d_next);
  int skip2 = __shfl_up_sync(kFullMask, two, 2);
  if (lane < 2) skip2 = FULL;
  const int best = min(min(p, stay), min(skip1, skip2));
  int raw = sat_add<FULL>(best, d);
  if (!valid) raw = FULL;
  const int mn = __reduce_min_sync(kFullMask, raw);
  int out = max(raw - mn, 0);
  if (out >= threshold) out = FULL;
  *m = mn;
  return out;
}

// Index of the warp's minimum of x, ties to the HIGHEST lane
// (ops/dtw.py:_argmin_last): one min over the key x * 64 + (31 - lane),
// exact while 0 <= x < 2^25.
__device__ __forceinline__ int argmin_last(int x, int lane) {
  const int key = x * 64 + (31 - lane);
  const int mn = __reduce_min_sync(kFullMask, key);
  return 31 - (mn & 63);
}

}  // namespace band
