// Tensor-core building blocks: `ldmatrix`, the m16n8k16 bf16 `mma.sync` with
// f32 accumulators (the bf16 kernels), the m16n8k8 TF32 one with the split
// f32 product built on it (the f32 kernels), and 16-byte `cp.async`.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, q = lane % 4):
//   A (16 x 16, row-major): a0 = A[g][2q..2q+1],   a1 = A[g+8][2q..],
//                           a2 = A[g][2q+8..],     a3 = A[g+8][2q+8..]
//   B (16 x 8):             b0 = B[2q..2q+1][g],   b1 = B[2q+8..2q+9][g]
//   C (16 x 8, f32):        c0, c1 = C[g][2q, 2q+1], c2, c3 = C[g+8][2q, 2q+1]
// `ldmatrix` gives lane l the pair at row l / 4, columns 2 (l % 4) of each
// 8 x 8 matrix (`.trans`: of the transposed matrix); lanes 8m..8m+7 give the
// row addresses of matrix m.  The row-address helpers below follow that.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace otp_mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16 x 16 bf16) @ b (16 x 8 bf16), f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)),
               "l"(gmem));
}

// the same copy where `valid`; else it reads nothing and writes 16 zero bytes
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// two f32 values rounded to bf16 and packed as one 32-bit register (lo first)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Row address, for lane `lane`, of an A tile (16 rows x 16 columns) of a
// row-major matrix with leading dimension `ld` (elements): x4 load.
__device__ __forceinline__ int a_off(int lane, int ld) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
}

// B fragments of two n8 tiles from a matrix stored [n][k] (k contiguous):
// x4 load giving {b0, b1} of rows n 0-7 then {b0, b1} of rows n 8-15.
__device__ __forceinline__ int bnk_x4_off(int lane, int ld) {
  return ((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 8;
}

// B fragment of one n8 tile from a matrix stored [n][k]: x2 load.
__device__ __forceinline__ int bnk_x2_off(int lane, int ld) {
  return (lane & 7) * ld + ((lane >> 3) & 1) * 8;
}

// B fragment of one n8 tile from a matrix stored [k][n] (n contiguous):
// x2.trans load.
__device__ __forceinline__ int bkn_x2_off(int lane, int ld) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * ld;
}

// B fragments of two n8 tiles from a matrix stored [k][n]: x4.trans load
// giving {b0, b1} of columns n 0-7 then {b0, b1} of columns n 8-15.
__device__ __forceinline__ int bkn_x4_off(int lane, int ld) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
}

// ---------------------------------------------------------------------------
// f32 as split TF32
// ---------------------------------------------------------------------------
// Fragment layouts of mma.m16n8k8 .tf32 (one 32-bit element a register):
//   A (16 x 8, row-major): a0 = A[g][q],  a1 = A[g+8][q],  a2 = A[g][q+4],  a3 = A[g+8][q+4]
//   B (8 x 8):             b0 = B[q][g],  b1 = B[q+4][g]
//   C (16 x 8, f32):       as m16n8k16.
// `ldmatrix` moves 16-byte rows, so on f32 data it gives lane l the element
// at row l / 4, column l % 4 of each 8 x 4 matrix: exactly these A fragments
// from a row-major tile, and B fragments from a matrix stored [n][k].  The
// `*_f32` row-address helpers are the ones above with 4 f32 columns a row
// segment in place of 8 bf16.
//
// One TF32 pass keeps 11 significant bits.  f32 accuracy takes three: with
// x = hi + lo, hi = x rounded to TF32 and lo = (x - hi) rounded to TF32
// (|x - hi - lo| <= 2^-22 |x|), a b = lo_a hi_b + hi_a lo_b + hi_a hi_b up to
// the dropped lo_a lo_b (2^-22), each product of two TF32 values exact in
// the f32 accumulator.

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// four f32 values (a fragment as `ldmatrix` gives it) split into hi and lo
__device__ __forceinline__ void split_tf32_x4(const uint32_t (&r)[4], uint32_t (&hi)[4],
                                              uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(r[i]), hi[i], lo[i]);
}

// d += a (16 x 8 TF32) @ b (8 x 8 TF32), f32 accumulation
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a @ b to f32 accuracy: the three TF32 passes, small terms first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4], uint32_t bhi0,
                                           uint32_t bhi1, uint32_t blo0, uint32_t blo1) {
  mma_tf32(d, alo, bhi0, bhi1);
  mma_tf32(d, ahi, blo0, blo1);
  mma_tf32(d, ahi, bhi0, bhi1);
}

__device__ __forceinline__ int a_off_f32(int lane, int ld) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 4;
}

__device__ __forceinline__ int bnk_x4_off_f32(int lane, int ld) {
  return ((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 4;
}

__device__ __forceinline__ int bnk_x2_off_f32(int lane, int ld) {
  return (lane & 7) * ld + ((lane >> 3) & 1) * 4;
}

}  // namespace otp_mma
