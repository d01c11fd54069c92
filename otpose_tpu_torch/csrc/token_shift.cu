// One-token moves along the last axis of a contiguous (R, L) tensor: the
// +-1 halo that a k = 3 depthwise conv over tokens needs.
//
//   mode 0, right:   out[r, j] = x[r, j - 1], out[r, 0] = 0
//   mode 1, left:    out[r, j] = x[r, j + 1], out[r, L - 1] = 0
//   mode 2, rotate:  out[r, j] = x[r, (j - 1) mod L]
//   mode 3, handoff: out[r, 0] = x[r, L - 1], zeros elsewhere
//
// Replaces: the probe kernels of tools/probe_shift.py, which asked which
// bf16 lane-shift constructs Mosaic compiles on a TPU (right: k_concat,
// k_slice_pad, k_f32_roll, k_scratch_store, k_unaligned_load; rotate:
// k_bitcast_roll; left: k_concat_left; handoff: k_masked_sum_col).  On
// Hopper nothing about a one-element shift is hard: any thread can read any
// address, so all eight are one copy with a source column per mode.
//
// What bounds it on the H100: device memory, 2 * R * L * itemsize bytes.
// Design: one thread per output element; a warp reads 32 neighbouring
// elements of a row (one element to the side of the ones it writes) and
// writes 32 neighbouring ones, so both are coalesced.  The elements are
// copied as raw 16- or 32-bit words, so the result is exact.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename U>
__global__ void __launch_bounds__(kThreads)
token_shift_kernel(const U* __restrict__ x, U* __restrict__ out, long long n, int L, int mode) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n) return;
  const int j = (int)(idx % L);
  const long long row = idx - j;
  int src;                           // source column, -1 for a zero
  switch (mode) {
    case 0: src = j - 1; break;
    case 1: src = j + 1 < L ? j + 1 : -1; break;
    case 2: src = j == 0 ? L - 1 : j - 1; break;
    default: src = j == 0 ? L - 1 : -1; break;
  }
  out[idx] = src >= 0 ? x[row + src] : U(0);
}

}  // namespace

// x, out: contiguous (R, L); itemsize 2 (bf16) or 4 (f32); mode 0..3 as above.
extern "C" int otp_token_shift(const void* x, void* out, long long R, int L, int itemsize,
                               int mode, void* stream) {
  if (R < 1 || L < 1 || mode < 0 || mode > 3) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long n = R * (long long)L;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (itemsize == 2) {
    token_shift_kernel<uint16_t><<<(unsigned)blocks, kThreads, 0, st>>>(
        (const uint16_t*)x, (uint16_t*)out, n, L, mode);
  } else if (itemsize == 4) {
    token_shift_kernel<uint32_t><<<(unsigned)blocks, kThreads, 0, st>>>(
        (const uint32_t*)x, (uint32_t*)out, n, L, mode);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
