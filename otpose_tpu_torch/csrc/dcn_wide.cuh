// Shared by the DCN's wide paths (csrc/deform_conv.cu, csrc/deform_conv_bwd.cu,
// O > 32 in the exact mode): the work split into equal ranges of a list, the
// weights split into TF32 hi and lo as the backward's mma.m16n8k8 B
// fragments and as the forward's `wgmma` B tiles, and the `wgmma` calls.
#pragma once

#include <cuda_runtime.h>

#include "mma.cuh"

namespace otp_dcn {

// A list of N = planes x n items (plane-major) cut into G equal ranges,
// block z taking [z N / G, (z + 1) N / G): the blocks whose ranges hold
// plane q's first and last items.  A plane's items that fall to several
// blocks are a segment of each, and segments are summed in block order.
__host__ __device__ inline long long seg_first(long long q, long long n, long long N,
                                               long long G) {
  return ((q * n + 1) * G + N - 1) / N - 1;
}
__host__ __device__ inline long long seg_last(long long q, long long n, long long N,
                                              long long G) {
  return ((q + 1) * n * G + N - 1) / N - 1;
}

// The most segments a plane of n items has (the partial rows it needs)
inline int seg_rows(long long planes, long long n, long long G) {
  const long long N = planes * n;
  int J = 1;
  for (long long q = 0; q < planes; ++q) {
    const long long cnt = seg_last(q, n, N, G) - seg_first(q, n, N, G) + 1;
    if (cnt > J) J = (int)cnt;
  }
  return J;
}

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The product's columns: O rounded up to 16 (two n8 tiles, the backward's
// m16 tiles of outputs); the forward takes them 144 a launch
__host__ __device__ constexpr int product_cols(int O) { return round_up(O, 16); }

// A dilation group's K: its dn dilations' nine taps, column dl * 9 + k, in
// whole k8 steps
__host__ __device__ constexpr int group_k(int dn) { return round_up(9 * dn, 8); }

// The weights of dilations [d0, d0 + dn) as the B fragments of split-TF32
// mma.m16n8k8 for the backward's G = g W^T (B[o][K] = W[o, K]), one float4
// (b0 hi, b1 hi, b0 lo, b1 lo) a lane, from the pack w (D, C, 9, OP), zero
// past O: for channel c, o step s (of `steps` = cols / 8), K tile t (of
// `tiles` = K / 8) and lane, with K = dl * 9 + k (zero past 9 dn),
//   b0 = W[o = 8 s + lane % 4, K = 8 t + lane / 4], b1 at o + 4.
__global__ void wide_wfrag_kernel(const float* __restrict__ w, float4* __restrict__ out, int C,
                                  int OP, int O, int d0, int dn, int steps, int tiles) {
  const long long n = (long long)C * steps * tiles * 32;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int lane = (int)(i & 31);
    long long r = i >> 5;
    const int t = (int)(r % tiles);
    r /= tiles;
    const int s = (int)(r % steps), c = (int)(r / steps);
    const int kq = lane & 3, ng = lane >> 2;
    auto at = [&](int K, int o) {
      if (K >= 9 * dn || o >= O) return 0.f;
      const int dl = K / 9, k = K - 9 * dl;
      return w[(((size_t)(d0 + dl) * C + c) * 9 + k) * OP + o];
    };
    const float b0 = at(8 * t + ng, 8 * s + kq), b1 = at(8 * t + ng, 8 * s + kq + 4);
    uint32_t h0, l0, h1, l1;
    otp_mma::split_tf32(b0, h0, l0);
    otp_mma::split_tf32(b1, h1, l1);
    out[i] = make_float4(__uint_as_float(h0), __uint_as_float(h1), __uint_as_float(l0),
                         __uint_as_float(l1));
  }
}

inline cudaError_t wide_wfrag(const float* w, float4* out, int C, int OP, int O, int d0, int dn,
                              int steps, int tiles, cudaStream_t st) {
  const long long n = (long long)C * steps * tiles * 32;
  const long long blocks = (n + 255) / 256;
  wide_wfrag_kernel<<<(unsigned)(blocks < 1024 ? blocks : 1024), 256, 0, st>>>(
      w, out, C, OP, O, d0, dn, steps, tiles);
  return cudaGetLastError();
}

// The weights of dilations [d0, d0 + dn) as `wgmma` B tiles (N = outputs x
// K, K-major, the 128-byte swizzle): for channel c, K chunk ch (32 values a
// 128-byte row) and part (0 hi, 1 lo), kRows144 rows of 32 f32, row n
// holding W[o = o0 + n, K = 32 ch + kk] (zero past `cols`, 9 dn and O) at
// float n * 32 + ((kk / 4) ^ (n % 8)) * 4 + kk % 4.  A channel's tiles are
// contiguous, (ch, part)-major, so a copy keeps the swizzle where the
// destination is 1024-byte aligned.
constexpr int kRows144 = 144;   // a tile's rows: the N of one m64n144k8 product
__global__ void wide_wtile_kernel(const float* __restrict__ w, float* __restrict__ out, int C,
                                  int OP, int O, int o0, int d0, int dn, int cols, int chunks) {
  const long long n = (long long)C * chunks * kRows144 * 32;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int kk = (int)(i & 31);
    long long r = i >> 5;
    const int n = (int)(r % kRows144);
    r /= kRows144;
    const int ch = (int)(r % chunks), c = (int)(r / chunks);
    const int K = 32 * ch + kk, o = o0 + n;
    float v = 0.f;
    if (K < 9 * dn && n < cols && o < O) {
      const int dl = K / 9, k = K - 9 * dl;
      v = w[(((size_t)(d0 + dl) * C + c) * 9 + k) * OP + o];
    }
    uint32_t hi, lo;
    otp_mma::split_tf32(v, hi, lo);
    float* tile = out + (((size_t)c * chunks + ch) * 2) * kRows144 * 32;
    const int e = n * 32 + ((kk >> 2) ^ (n & 7)) * 4 + (kk & 3);
    tile[e] = __uint_as_float(hi);
    tile[(size_t)kRows144 * 32 + e] = __uint_as_float(lo);
  }
}

inline cudaError_t wide_wtile(const float* w, float* out, int C, int OP, int O, int o0, int d0,
                              int dn, int cols, int chunks, cudaStream_t st) {
  const long long n = (long long)C * chunks * kRows144 * 32;
  const long long blocks = (n + 255) / 256;
  wide_wtile_kernel<<<(unsigned)(blocks < 1024 ? blocks : 1024), 256, 0, st>>>(
      w, out, C, OP, O, o0, d0, dn, cols, chunks);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// wgmma with A in registers (the forward's product)
// ---------------------------------------------------------------------------

// a shared-memory descriptor: K-major rows of 128 bytes with the 128-byte
// swizzle, 8-row groups 1024 bytes apart (the tile 1024-byte aligned)
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 144, f32) += A (64 x 8 tf32, in registers: warp w of the
// warpgroup holds rows 16 w + [0, 16) as mma.m16n8k8's A fragment) B (144 x
// 8 tf32, K-major in shared memory)^T.  d[4 i .. 4 i + 3]: rows g, g + 8,
// columns 8 i + 2 q, + 1 of the warp's 16 rows.
__device__ __forceinline__ void wgmma_n144_tf32(float (&d)[72], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %76, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71"
      "}, {%72, %73, %74, %75}, %77, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(1), "l"(db));
}

// a product's register operands stay live and unchanged until a wait: the
// compiler sees them read and written here, so it neither reuses their
// registers while `wgmma` reads them nor moves reads of d above the wait
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// the accumulators stay where the products left them: reads of d after a
// wait are not moved above it
__device__ __forceinline__ void fence_acc72(float (&d)[72]) {
#pragma unroll
  for (int i = 0; i < 72; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

}  // namespace otp_dcn
