// Batched DTW band update for Hopper (sm_90a): one warp per band.
//
// Replaces downpore_tpu/ops/pallas_band.py:_band_kernel
// (pallas_update_bands): for each of B bands of width W <= 32, with
// saturation at BAND_FULL = 0xFFFF,
//
//   out[b] = band step of (poffs[b], ds[b]) (see band.cuh),  min[b] = row min
//
// What bounds it: device-memory bandwidth.  Each band is 2 x W int32 in and
// W + 1 int32 out with ~20 integer operations per lane, far below the
// card's compute rate per byte; the Pallas version padded W to 128 lanes
// and B to 256-row blocks to fit its tiles.  Here lane i of a warp owns
// band lane i, the neighbour terms are shuffles and the row minimum a warp
// reduction, so each value is read and written once, neighbouring lanes on
// neighbouring addresses.  Lanes at or past W take part as the Pallas
// kernel's padding does (poffs = FULL, ds = FULL / 4) and never set the
// minimum.  The same step (band.cuh) is the inner loop of the beam kernel.

#include <cuda_runtime.h>

#include "band.cuh"

namespace {

constexpr int kBandFull = 0xFFFF;
constexpr int kWarpsPerBlock = 8;

__global__ void band_update_kernel(const int* __restrict__ ds,
                                   const int* __restrict__ poffs,
                                   int* __restrict__ out,
                                   int* __restrict__ out_min, int B, int W,
                                   int threshold) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= B) return;  // whole warp leaves together
  const bool valid = lane < W;
  const size_t off = (size_t)row * W + lane;
  const int d = valid ? ds[off] : kBandFull / 4;
  const int p = valid ? poffs[off] : kBandFull;
  int m;
  const int o = band::step<kBandFull>(p, d, lane, threshold, valid, &m);
  if (valid) out[off] = o;
  if (lane == 0) out_min[row] = m;
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success).  ds, poffs
// and out are [B, W] int32 and min is [B] int32, contiguous, on the
// current device; 1 <= W <= 32.
int band_update_launch(const int* ds, const int* poffs, int* out,
                       int* out_min, int B, int W, int threshold,
                       void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (W < 1 || W > 32) return (int)cudaErrorInvalidValue;
  const long long blocks = ((long long)B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  band_update_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                       (cudaStream_t)stream>>>(ds, poffs, out, out_min, B, W,
                                               threshold);
  return (int)cudaGetLastError();
}

const char* band_update_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
