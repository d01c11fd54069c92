// One tensor-core product mainloop for Hopper (sm_90a), shared by the wide
// paths of `fused_mlp.cu` and `fused_attn.cu`.
//
//   D (M x N, f32 accumulators) = A (M x K) B (N x K)^T
//
// A and B are both K-major (K contiguous in device memory), so one
// mainloop serves bf16 and f32: `wgmma` takes MN-major shared-memory
// operands only for 16-bit types, and the callers write their activations in
// the layout each product wants.  A block owns a 128 x 128 output tile and
// walks K in steps of 128 bytes (64 bf16 or 32 f32 values):
//   - warps 0-3 and 4-7 are two consumer warpgroups: each owns 64 rows of
//     the tile and issues `wgmma.mma_async` m64n128 on a stage (k16 in bf16,
//     k8 in tf32), one commit group a stage, releasing the stage before last
//     once the newer group is issued, so the tensor cores always have a
//     group in flight;
//   - warp 8 is the producer: one thread keeps a ring of STAGES
//     shared-memory stages filled with `cp.async.bulk.tensor` (TMA) loads of
//     the A and B boxes, each stage guarded by a full and an empty
//     `mbarrier` (the TMA reports its bytes to the full barrier; the
//     consumers arrive on the empty one when their products have read it);
//   - the boxes are loaded with the 128-byte swizzle, which is the layout
//     the `wgmma` descriptors name, and TMA zero-fills every box element past
//     the tensor's extent, so the ragged edges of C, H and T need no masks:
//     a row past M or N computes a value nobody stores, a K element past the
//     extent adds zero.
// A weight byte fetched from L2 serves the 128 tokens of a tile.  bf16 keeps
// three stages (96 KB) so that two blocks share an SM, one's epilogue (the
// MLP's GELU, the stores) running beside the other's products; a producer
// warp rather than a warpgroup leaves the 288 threads of a block the
// registers that takes.  f32 holds hi and lo of both operands: three stages
// are 192 KB, one block an SM.  (Measured against 128 x 256 tiles on
// m64n256 with four stages and one block an SM: PERF.md §6.)
//
// f32 runs in split TF32 with the rule of `mma.cuh`: each operand is stored
// twice, hi = rna_tf32(x) and lo = rna_tf32(x - hi) (`split_tf32`), by
// whoever writes it (the weights' split kernel, the LN passes, the product
// epilogues, the softmax), and a stage holds A_hi, A_lo, B_hi and B_lo;
// every k8 step issues lo_a hi_b, hi_a lo_b, hi_a hi_b into one f32
// accumulator, small terms first.
//
// The caller describes the problems of a launch by an epilogue class E
// (blockIdx.z selects a problem): `E::coords(z)` gives the operand rows and
// K offsets and the K length, and `E::tile(z, m0, n0, cw, acc, smem, tid)`
// stores consumer cw's 64 x 128 accumulators, rows m0 on (`store_fragments`
// walks them for an epilogue that stores element pairs).
// No atomics and no split of K inside a launch: a call gives the same bits
// every time.
//
// Tensor maps are built on the host (`make_map`) by libcuda's
// `cuTensorMapEncodeTiled`, found with `cudaGetDriverEntryPoint*` so the
// library links no -lcuda, and passed as `__grid_constant__` parameters.
#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

namespace otp_hg {

constexpr int kBM = 128, kBN = 128;   // a block's output tile
constexpr int kConsumers = 2;         // consumer warpgroups, 64 rows of the tile each
constexpr int kThreads = 128 * kConsumers + 32;   // and one producer warp
constexpr int kRowBytes = 128;        // a box row: one 128-byte swizzle row of K

template <typename T> struct Cfg;
template <> struct Cfg<__nv_bfloat16> {
  static constexpr int BK = 64;       // K values a stage
  static constexpr int STAGES = 3;
  static constexpr int BLOCKS = 2;    // blocks an SM: one's epilogue beside the other's products
  static constexpr int PARTS = 1;     // the operand itself
};
template <> struct Cfg<float> {
  static constexpr int BK = 32;
  static constexpr int STAGES = 3;
  static constexpr int BLOCKS = 1;
  static constexpr int PARTS = 2;     // hi and lo
};


constexpr int kABytes = kBM * kRowBytes;   // a part's boxes
constexpr int kBBytes = kBN * kRowBytes;
template <typename T>
constexpr int kStageBytes = Cfg<T>::PARTS * (kABytes + kBBytes);

// dynamic shared memory of a launch: the stages, 1024 bytes to align them
// (the 128-byte swizzle repeats every 1024 bytes) and the barriers
template <typename T>
constexpr size_t smem_bytes() {
  return (size_t)Cfg<T>::STAGES * kStageBytes<T> + 1024 + 2 * Cfg<T>::STAGES * 8;
}

// One A or B operand of a launch, hi and (f32) lo.
struct Operand {
  CUtensorMap map[2];
};

// What a block's problem reads: rows [a_row, a_row + kBM) of A and [b_row,
// b_row + kBN) of B (the tile's offsets included by the kernel), from K
// offsets a_k and b_k on, klen values of K.  A row may start anywhere; a K
// offset times the element size must be a multiple of 16 bytes (TMA's rule
// for a box's start along the contiguous dimension).
struct Coords {
  int a_row, a_k, b_row, b_k, klen;
};

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Errors of the map encoder are returned to Python as kMapError + CUresult.
constexpr int kMapError = 10000;

// A K-major matrix of `rows` rows of `k` values of `elem` bytes (K extent k:
// TMA zero-fills past it), rows `ld` values apart (ld * elem a multiple of
// 16), loaded as boxes of `box_rows` rows of 128 bytes with the 128-byte
// swizzle.  Returns 0 or kMapError + the CUresult.
inline int make_map(CUtensorMap* m, const void* base, int elem, uint64_t k, uint64_t rows,
                    uint64_t ld, uint32_t box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kMapError + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {k, rows};
  const cuuint64_t strides[1] = {ld * (uint64_t)elem};
  const cuuint32_t box[2] = {(cuuint32_t)(kRowBytes / elem), box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(m, elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                        2, const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kMapError + (int)r;
}

// An operand of T (boxes of 128 rows, kBM = kBN): hi at `base`, and in f32
// lo at `base` + `lo_offset` values (the callers keep both halves in one
// buffer).
template <typename T>
int make_operand(Operand* op, const T* base, size_t lo_offset, uint64_t k, uint64_t rows,
                 uint64_t ld) {
  for (int p = 0; p < Cfg<T>::PARTS; ++p) {
    const int err = make_map(&op->map[p], base + p * lo_offset, (int)sizeof(T), k, rows, ld,
                             kBM);
    if (err) return err;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// device: barriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t su32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(su32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(su32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(su32(bar)) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(su32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int k,
                                         int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(su32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(su32(bar)), "r"(k), "r"(row)
      : "memory");
}

// a shared-memory matrix descriptor: K-major rows of 128 bytes with the
// 128-byte swizzle, 8-row groups 1024 bytes apart (the tile is 1024-aligned)
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((su32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
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
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32) += A (64 x 16 bf16) B (128 x 16 bf16)^T, both K-major
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 128, f32) += A (64 x 8 tf32) B (128 x 8 tf32)^T, both K-major
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Walk a consumer's accumulators as element pairs: row m (of the 64) and
// columns n, n + 1 (of the 128), calling st(m, n, v0, v1).  Lane l of warp
// w holds rows 16 w + l / 4 and 8 more, columns 8 j + 2 (l % 4), + 1.
template <typename F>
__device__ __forceinline__ void store_fragments(const float (&acc)[64], int tid, F&& st) {
  const int warp = tid >> 5, lane = tid & 31;
  const int r = warp * 16 + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    st(r, 8 * j + c, acc[4 * j], acc[4 * j + 1]);
    st(r + 8, 8 * j + c, acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// ---------------------------------------------------------------------------
// operand writers: a value of T into a product operand, in f32 as hi at p
// and lo at p + lo_off (the split of `mma.cuh`)
// ---------------------------------------------------------------------------

template <typename T> __device__ __forceinline__ void put(T* p, size_t lo_off, float v);
template <> __device__ __forceinline__ void put<__nv_bfloat16>(__nv_bfloat16* p, size_t, float v) {
  *p = __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ void put<float>(float* p, size_t lo_off, float v) {
  uint32_t h, l;
  otp_mma::split_tf32(v, h, l);
  p[0] = __uint_as_float(h);
  p[lo_off] = __uint_as_float(l);
}

// four neighbouring values (p 8-byte aligned in bf16, 16 in f32)
template <typename T> __device__ __forceinline__ void put4(T* p, size_t lo_off, float4 v);
template <> __device__ __forceinline__ void put4<__nv_bfloat16>(__nv_bfloat16* p, size_t, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(otp_mma::pack_bf16(v.x, v.y), otp_mma::pack_bf16(v.z, v.w));
}
template <> __device__ __forceinline__ void put4<float>(float* p, size_t lo_off, float4 v) {
  uint4 h, l;
  otp_mma::split_tf32(v.x, h.x, l.x);
  otp_mma::split_tf32(v.y, h.y, l.y);
  otp_mma::split_tf32(v.z, h.z, l.z);
  otp_mma::split_tf32(v.w, h.w, l.w);
  *reinterpret_cast<uint4*>(p) = h;
  *reinterpret_cast<uint4*>(p + lo_off) = l;
}

// two neighbouring values: one paired store where `both` (p then aligned
// to the pair), else the first alone
template <typename T>
__device__ __forceinline__ void put2(T* p, size_t lo_off, float v0, float v1, bool both) {
  if (!both) {
    put<T>(p, lo_off, v0);
  } else if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<uint32_t*>(p) = otp_mma::pack_bf16(v0, v1);
  } else {
    uint2 h, l;
    otp_mma::split_tf32(v0, h.x, l.x);
    otp_mma::split_tf32(v1, h.y, l.y);
    *reinterpret_cast<uint2*>(p) = h;
    *reinterpret_cast<uint2*>(p + lo_off) = l;
  }
}

// f32 weights split once a call into hi (at hi) and lo (at hi + lo_off) for
// the products
__global__ void split_tf32_kernel(const float* __restrict__ src, float* __restrict__ hi,
                                  size_t lo_off, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    put<float>(hi + i, lo_off, src[i]);
}

inline void split_weights(const float* src, float* hi, size_t lo_off, long long n,
                          cudaStream_t st) {
  split_tf32_kernel<<<264, 256, 0, st>>>(src, hi, lo_off, n);
}

constexpr int kTileLd = 33;   // a token-major tile's row stride in shared memory (32 lanes)

// A tile of CH channels x 32 token lanes in shared memory (f32, tile[c
// kTileLd + t]) written token-major for a product: lanes t in [tbeg, tend)
// to row row0 + t of `ld` values, columns c0 + c for c0 + c < cmax (a
// multiple of 4); 256 threads, each CH / 8 neighbouring channels of one
// lane, so a warp's stores are four rows of 8 CH contiguous bytes.  (ld a
// multiple of 4, so every 4-value group is aligned.)  The LN passes write
// their token-major outputs this way: lanes hold tokens there, and a lane
// storing its own token's channels (a row a lane) measured slower.
template <typename T, int CH>
__device__ __forceinline__ void store_token_tile(const float* tile, T* dst, size_t lo_off,
                                                 size_t row0, int ld, int c0, int cmax,
                                                 int tbeg, int tend, int tid) {
  constexpr int V = CH / 8;
  const int t = tid >> 3, cl = (tid & 7) * V;
  if (t < tbeg || t >= tend) return;
  T* row = dst + (row0 + t) * ld + c0;
#pragma unroll
  for (int i = 0; i < V; i += 4) {
    if (c0 + cl + i >= cmax) return;
    const float* v = tile + (cl + i) * kTileLd + t;
    put4<T>(row + cl + i, lo_off,
            make_float4(v[0], v[kTileLd], v[2 * kTileLd], v[3 * kTileLd]));
  }
}

// f(c, load(c)) for c = first, first + stride, ... below n, in that order,
// eight loads issued before their uses (the LN passes over C wait on their
// loads more than on their arithmetic).
template <typename L, typename F>
__device__ __forceinline__ void batched(int first, int stride, int n, L&& load, F&& f) {
  int c = first;
  for (; c + 7 * stride < n; c += 8 * stride) {
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = load(c + i * stride);
#pragma unroll
    for (int i = 0; i < 8; ++i) f(c + i * stride, v[i]);
  }
  for (; c < n; c += stride) f(c, load(c));
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// Grid: x the tile's N index, y its M index, z the problem.  E (the
// epilogue) gives each problem's Coords and stores each consumer's tile;
// its `tile` may use `scratch`, the consumer's share of the stages (after
// every consumer has finished its products), for a staged store.
template <typename T, typename E>
__global__ void __launch_bounds__(kThreads, Cfg<T>::BLOCKS)
hgemm_kernel(const __grid_constant__ Operand a, const __grid_constant__ Operand b, const E epi) {
  constexpr int BK = Cfg<T>::BK, S = Cfg<T>::STAGES, P = Cfg<T>::PARTS;
  constexpr int AB = kABytes, BB = kBBytes, STAGE = kStageBytes<T>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * STAGE);
  uint64_t* empty = full + S;

  const int z = blockIdx.z, m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const Coords c = epi.coords(z);
  const int nk = c.klen > 0 ? (c.klen + BK - 1) / BK : 0;
  const int cw = threadIdx.x >> 7, tid = threadIdx.x & 127;   // consumer cw; cw 2: the producer

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (cw == kConsumers) {
    // producer: one thread keeps the ring full
    if (tid == 0) {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % S;
        if (kb >= S) mbar_wait(&empty[s], (kb / S - 1) & 1);
        uint8_t* st = smem + s * STAGE;
        mbar_expect_tx(&full[s], STAGE);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          tma_load(st + p * AB, &a.map[p], &full[s], c.a_k + kb * BK, c.a_row + m0);
          tma_load(st + P * AB + p * BB, &b.map[p], &full[s], c.b_k + kb * BK, c.b_row + n0);
        }
      }
    }
    return;
  }

  // consumer cw: rows 64 cw .. 64 cw + 63 of the tile
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int kb = 0; kb < nk; ++kb) {
    const int s = kb % S;
    mbar_wait(&full[s], (kb / S) & 1);
    const uint8_t* st = smem + s * STAGE;
    const uint64_t da = sw128_desc(st + cw * 64 * kRowBytes);
    const uint64_t db = sw128_desc(st + P * AB);
    wgmma_fence();
    if constexpr (P == 1) {
#pragma unroll
      for (int kk = 0; kk < kRowBytes / 32; ++kk) wgmma_bf16(acc, da + 2 * kk, db + 2 * kk);
    } else {
      const uint64_t da_lo = sw128_desc(st + AB + cw * 64 * kRowBytes);
      const uint64_t db_lo = sw128_desc(st + P * AB + BB);
#pragma unroll
      for (int kk = 0; kk < kRowBytes / 32; ++kk) {
        wgmma_tf32(acc, da_lo + 2 * kk, db + 2 * kk);
        wgmma_tf32(acc, da + 2 * kk, db_lo + 2 * kk);
        wgmma_tf32(acc, da + 2 * kk, db + 2 * kk);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();     // the previous stage's products are done: release it
    if (kb > 0 && tid == 0) mbar_arrive(&empty[(kb - 1) % S]);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  named_sync(1, 128 * kConsumers);   // every product has read its stages
  epi.tile(z, m0 + 64 * cw, n0, cw, acc, smem + cw * (S * STAGE / kConsumers), tid);
}

template <typename T, typename E>
int launch(const Operand& a, const Operand& b, const E& epi, int m, int n, int problems,
           cudaStream_t st) {
  if (m <= 0 || n <= 0 || problems <= 0) return 0;
  constexpr size_t smem = smem_bytes<T>();
  cudaFuncSetAttribute(hgemm_kernel<T, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM, problems);
  hgemm_kernel<T, E><<<grid, kThreads, smem, st>>>(a, b, epi);
  return (int)cudaGetLastError();
}

}  // namespace otp_hg
