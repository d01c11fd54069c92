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
// Hopper any thread can read any address, so all eight are one copy with a
// displacement of one element; what is left to design is how the bytes move.
//
// What bounds it on the H100: device memory.  right, left and rotate read
// and write R * L * itemsize bytes each; handoff writes them and reads R
// elements.  No arithmetic touches a value: elements move as raw 16- or
// 32-bit words, so the result is exact.
//
// Design.  A warp moves the most bytes an instruction when each thread
// loads and stores 16 bytes at a 16-byte boundary, but the output is the
// input displaced by one element, so the two cannot both be aligned by
// moving the pointer.  Here both are: a thread loads the aligned input
// vector that lies under its aligned output vector, takes the one element
// it lacks from its neighbour's vector by a warp shuffle (lane 0 of a +1
// shift and the last lane of a -1 shift read that element themselves, one
// 2- or 4-byte load a warp), and builds the output vector in registers with
// funnel shifts over neighbouring 32-bit words.  Each thread first issues
// all its loads (kUnroll vectors, kThreads apart, and its edge element),
// then shuffles and stores, so a block has kUnroll * kThreads * 16 bytes in
// flight.
//
// Rows are walked by blocks: blockIdx.x is a chunk of kUnroll * kThreads
// vectors of a row and blockIdx.y strides over rows, so no thread divides
// by L, and the mode is a template parameter.  A row's vectors start at its
// first 16-byte boundary; the `head` elements before it and the elements
// after its last whole vector (at most VEC - 1 each) are moved one element a
// thread by the row's first block, as are columns 0 and L - 1 when they fall
// there; when column 0 (or L - 1) lies in a vector, the thread that owns
// that vector puts the edge value in.  A row of L * itemsize bytes that is
// not a multiple of 16 (L odd in bf16, say) only moves the boundary from
// row to row (`head` is computed per row from the row's address), so such
// shapes take the vector path too; rows shorter than a vector are all head.
// The vector path needs x and out to sit at the same offset from a 16-byte
// boundary.  torch's allocations do; a contiguous view at another offset
// takes `token_shift_scalar_kernel`, one element a thread with the same
// walk: correct, not fast.
//
// handoff reads one column, so it is a vectorised fill: zero vectors, and
// x[r, L - 1] placed by the thread that writes column 0.
//
// The grid is one block for each (chunk, row) up to 65535 rows, and strides
// beyond.  The constants below were chosen by graph-replay timings at
// (2176, 6912) bf16 on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md has the
// readings): a grid sized to the card, 4 or 8 blocks a multiprocessor
// striding over rows, was 4-12% slower than a block a chunk and 16 blocks
// equal to it; 128, 256 and 512 threads and 1, 2 or 4 vectors a thread were
// within 2% of each other and 8 vectors 6-8% slower for right and rotate;
// evict-first loads and stores (`__ldcs`, `__stcs`) left the three copies
// where they were and made handoff up to 13% faster.  A TMA bulk copy was not
// tried: its shared-memory side must be 16-byte aligned as well, so the
// one-element displacement would still need a pass through registers.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;                   // vectors a thread has in flight
constexpr int kChunk = kThreads * kUnroll;   // vectors of a row that one block moves
constexpr unsigned kFull = 0xffffffffu;
enum Mode { kRight = 0, kLeft = 1, kRotate = 2, kHandoff = 3 };

// out[r, j] of one row xr, element by element (heads, tails, scalar path)
template <typename U, int MODE>
__device__ __forceinline__ U shifted(const U* __restrict__ xr, int j, int L) {
  if (MODE == kRight) return j > 0 ? xr[j - 1] : U(0);
  if (MODE == kLeft) return j + 1 < L ? xr[j + 1] : U(0);
  if (MODE == kRotate) return xr[j > 0 ? j - 1 : L - 1];
  return j == 0 ? xr[L - 1] : U(0);
}

// The vector one element up: (e, v[0], ..., v[VEC - 2]); `top` holds e in
// its highest sizeof(U) bytes.
template <typename U> __device__ __forceinline__ uint4 shift_up(uint4 v, uint32_t top);
template <> __device__ __forceinline__ uint4 shift_up<uint16_t>(uint4 v, uint32_t top) {
  return make_uint4(__funnelshift_l(top, v.x, 16), __funnelshift_l(v.x, v.y, 16),
                    __funnelshift_l(v.y, v.z, 16), __funnelshift_l(v.z, v.w, 16));
}
template <> __device__ __forceinline__ uint4 shift_up<uint32_t>(uint4 v, uint32_t top) {
  return make_uint4(top, v.x, v.y, v.z);
}

// The vector one element down: (v[1], ..., v[VEC - 1], e); `low` holds e in
// its lowest sizeof(U) bytes.
template <typename U> __device__ __forceinline__ uint4 shift_down(uint4 v, uint32_t low);
template <> __device__ __forceinline__ uint4 shift_down<uint16_t>(uint4 v, uint32_t low) {
  return make_uint4(__funnelshift_r(v.x, v.y, 16), __funnelshift_r(v.y, v.z, 16),
                    __funnelshift_r(v.z, v.w, 16), __funnelshift_r(v.w, low, 16));
}
template <> __device__ __forceinline__ uint4 shift_down<uint32_t>(uint4 v, uint32_t low) {
  return make_uint4(v.y, v.z, v.w, low);
}

template <typename U, int MODE>
__global__ void __launch_bounds__(kThreads)
token_shift_kernel(const U* __restrict__ x, U* __restrict__ out, int R, int L) {
  constexpr int VEC = 16 / (int)sizeof(U);
  constexpr int kTop = 32 - 8 * (int)sizeof(U);   // shift of an element to a word's top
  const int tid = threadIdx.x, lane = tid & 31;
  for (long long row = blockIdx.y; row < R; row += gridDim.y) {
    const U* __restrict__ xr = x + row * L;
    U* __restrict__ orow = out + row * L;
    // elements before the row's first 16-byte boundary (the same in x and out)
    const int mis = (int)(((uintptr_t)orow & 15) / sizeof(U));
    const int head = min(L, (VEC - mis) & (VEC - 1));
    const int nvec = (L - head) / VEC;
    const int tail = head + nvec * VEC;            // first element after the vectors
    if (blockIdx.x == 0) {
      const int nscalar = head + (L - tail);       // at most 2 * (VEC - 1)
      if (tid < nscalar) {
        const int j = tid < head ? tid : tail + (tid - head);
        orow[j] = shifted<U, MODE>(xr, j, L);
      }
    }
    const int v0 = blockIdx.x * kChunk, v1 = min(nvec, v0 + kChunk);
    const uint4* __restrict__ xv = reinterpret_cast<const uint4*>(xr + head);
    uint4* __restrict__ ov = reinterpret_cast<uint4*>(orow + head);
    if (MODE == kHandoff) {
      for (int i = v0 + tid; i < v1; i += kThreads) {
        uint4 z = make_uint4(0u, 0u, 0u, 0u);
        if (head == 0 && i == 0) z.x = (uint32_t)xr[L - 1];   // column 0: the lowest bytes
        __stcs(ov + i, z);
      }
    } else {
      uint4 v[kUnroll];
      uint32_t edge[kUnroll];     // the element a shuffle cannot bring, as shift_* take it
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = v0 + u * kThreads + tid;
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        edge[u] = 0u;
        if (i < v1) {
          v[u] = __ldcs(xv + i);
          if (MODE == kLeft) {
            if (lane == 31 || i + 1 >= v1) {
              const int j = head + (i + 1) * VEC;    // x[r, j] goes to out[r, j - 1]
              if (j < L) edge[u] = (uint32_t)xr[j];
            }
          } else if (lane == 0) {
            const int j = head + i * VEC;            // out[r, j] takes x[r, j - 1]
            if (j > 0) edge[u] = (uint32_t)xr[j - 1] << kTop;
            else if (MODE == kRotate) edge[u] = (uint32_t)xr[L - 1] << kTop;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = v0 + u * kThreads + tid;
        if (MODE == kLeft) {
          uint32_t low = __shfl_down_sync(kFull, v[u].x, 1);
          if (lane == 31 || i + 1 >= v1) low = edge[u];
          if (i < v1) __stcs(ov + i, shift_down<U>(v[u], low));
        } else {
          uint32_t top = __shfl_up_sync(kFull, v[u].w, 1);
          if (lane == 0) top = edge[u];
          if (i < v1) __stcs(ov + i, shift_up<U>(v[u], top));
        }
      }
    }
  }
}

// x and out at different offsets from a 16-byte boundary: one element a thread
template <typename U, int MODE>
__global__ void __launch_bounds__(kThreads)
token_shift_scalar_kernel(const U* __restrict__ x, U* __restrict__ out, int R, int L) {
  for (long long row = blockIdx.y; row < R; row += gridDim.y) {
    const U* __restrict__ xr = x + row * L;
    U* __restrict__ orow = out + row * L;
    for (int j = blockIdx.x * kThreads + threadIdx.x; j < L; j += gridDim.x * kThreads)
      orow[j] = shifted<U, MODE>(xr, j, L);
  }
}

template <typename U, int MODE>
int launch(const void* x, void* out, int R, int L, cudaStream_t st) {
  constexpr int VEC = 16 / (int)sizeof(U);
  const bool same_offset = (((uintptr_t)x ^ (uintptr_t)out) & 15) == 0;
  const int rows = R < 65535 ? R : 65535;
  if (same_offset) {
    const int chunks = (L / VEC + kChunk - 1) / kChunk;
    const int gx = chunks > 0 ? chunks : 1;
    token_shift_kernel<U, MODE><<<dim3(gx, rows), kThreads, 0, st>>>(
        (const U*)x, (U*)out, R, L);
  } else {
    int gx = (L + kThreads - 1) / kThreads;
    if (gx > 1024) gx = 1024;
    token_shift_scalar_kernel<U, MODE><<<dim3(gx, rows), kThreads, 0, st>>>(
        (const U*)x, (U*)out, R, L);
  }
  return (int)cudaGetLastError();
}

template <typename U>
int launch_mode(const void* x, void* out, int R, int L, int mode, cudaStream_t st) {
  switch (mode) {
    case kRight: return launch<U, kRight>(x, out, R, L, st);
    case kLeft: return launch<U, kLeft>(x, out, R, L, st);
    case kRotate: return launch<U, kRotate>(x, out, R, L, st);
    default: return launch<U, kHandoff>(x, out, R, L, st);
  }
}

}  // namespace

// x, out: contiguous (R, L), aligned to their element; itemsize 2 (bf16) or
// 4 (f32); mode 0..3 as above.
extern "C" int otp_token_shift(const void* x, void* out, long long R, int L, int itemsize,
                               int mode, void* stream) {
  if (R < 1 || R > 0x7fffffffLL || L < 1 || mode < 0 || mode > 3 ||
      (itemsize != 2 && itemsize != 4))
    return (int)cudaErrorInvalidValue;
  if ((((uintptr_t)x | (uintptr_t)out) & (uintptr_t)(itemsize - 1)) != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  if (itemsize == 2) return launch_mode<uint16_t>(x, out, (int)R, L, mode, st);
  return launch_mode<uint32_t>(x, out, (int)R, L, mode, st);
}
