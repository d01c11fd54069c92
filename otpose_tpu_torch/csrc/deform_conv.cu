// Mean of D modulated deformable 3x3 convs (DCNv2) over one input, with one
// channel per deformable group:
//
//   out[b, o, p] = sum_d sum_{c,k} w[d, o, c, k] * smp_d[b, c*9+k, p] / D + mean_d(bias[d, o])
//
// One kernel, two rounding modes (template parameter `Mode`), each the whole
// sample function of one plain version:
//   kExact   (ops/cuda/deform_conv.py, the model's): position (py + tap) + off,
//            f32 bilinear with corner weights hy*hx, hy*lx, ly*hx, ly*lx in that
//            order, smp = sample * mask, f32 all the way, rounded once at the
//            output.
//   kPallas3 (ops/cuda/deform_conv_fused.py, the experiment's): position
//            (off + tap) + py, separable tent with the y weights rounded to the
//            compute dtype and the x weights f32, rows summed per column first,
//            smp = rnd(rnd(sample) * mask).
// In f32 the two are one function up to the order of f32 sums.  Offsets are
// laid out (group, tap, y/x), masks are raw (no sigmoid), the padding equals
// the dilation, and a sample takes its in-bounds corners when -1 < y < H and
// -1 < x < W.
//
// Replaces: otpose_tpu/ops/deform_conv.py:276 modulated_deform_conv_multi (XLA
// "tent matmul", not Pallas, a workaround for slow TPU gathers) and
// tools/exp_deform_pallas3.py:50 make_pallas3 (kernel `kern` :70-106,
// pallas_call :128), which kept a whole channel plane on chip and contracted
// separable tent weights on the MXU.  Only two tent weights per axis are
// non-zero, so this kernel gathers the four corners directly.
//
// What bounds it on the H100: device memory first.  Each output pixel needs
// 27 offset and mask values per (dilation, channel): 515 MB in bf16 at the
// flagship shape (B 16, C = O = 17, 96x72, five dilations), 0.154 ms at
// 3.35 TB/s, against 2.9 GFLOP of f32 FMA (0.043 ms).  Instruction issue is
// a second limit close to it: the compiled loop spends about a hundred
// instructions on each of the 84.6 M samples, a fifth of them the
// contraction's FMAs (tools/dcn_sass.py counts them).
//
// Design:
// - A block owns (b, a tile of 512 pixels (bf16 and f32), a range of the C*D
//   (channel, dilation) stages, channel outer).  Two pixels per thread,
//   threads of a warp on neighbouring pixels, so every copy is coalesced.
// - A ring of shared-memory stages holds the 18 offset rows, 9 mask rows and
//   the (9, O) f32 weights of a stage, filled by 16-byte `cp.async`
//   (zero-filled past the image) while the previous stage is sampled: 28 KB
//   (bf16) or 56 KB (f32) in flight a block, over the ~25 KB an SM needs at
//   3.35 TB/s and ~1 us.  Two stages, not three: a third costs a resident
//   block an SM, and a three-stage build measured slower (PERF.md).
//   When a row of x is not a multiple of 16 bytes, rows are copied element
//   by element (template `Wide` = false).
// - x's channel plane is staged in shared memory with the stage that starts
//   the channel, with a one-pixel border of zeros, so a sample's four corners
//   are four shared loads with no bounds checks.  Gathers through L1 were
//   slower (PERF.md): the corners of a warp's 32 samples spread over many
//   cache lines.  That path (template `XS` = false) remains for planes too
//   large to fit beside the ring.
// - Offsets and masks come from shared memory, so the nine taps of both
//   pixels are independent; pixel + tap is computed once a stage.
// - The contraction keeps the O <= 32 f32 accumulators of both pixels in
//   registers; each float4 weight read (a broadcast) feeds eight FMAs.  O is
//   padded to OP = 4 * NQ (NQ in {2, 5, 8}) with zero weights.
// - Fill at small B: when B * tiles leaves SMs without a block (B = 1: 14
//   tiles), the wrapper splits the stages over gridDim.z blocks, which write
//   f32 partial sums that a second kernel adds in a fixed order (no atomics,
//   deterministic).
// - Any D, by groups of launches (otp_deform): D above kMaxD is cut into
//   groups of kMaxD dilations, each a launch that writes its f32 partial sums
//   into slots of its own, and the reduction kernel adds every slot in a
//   fixed order, divides by the whole D and adds the mean bias once.  In the
//   make_pallas3 mode O above 32 is padded to a multiple of 32 and each
//   group of 32 outputs is a launch at OP = 32 over the same x, reading its
//   columns of the weights (row stride `ldw`) and writing its rows of the
//   output (`ldo` rows an item).  The exact mode past 32 outputs takes the
//   wide path below.
// - The D pointers and dilations arrive in a __grid_constant__ struct and are
//   copied to shared memory with compile-time indices, so no pointer table
//   lives in local memory (no stack frame).
//
// The wide path (otp_deform_wide: the exact mode, O > 32; the 133-joint
// and 136-joint models run O = C = 133 and 136).  Groups of 32 outputs
// would sample everything again for each group: at O = 133 the offsets and
// masks (496 of the 507 MB a bf16 call moves) were read five times, and the
// contraction, 2 x 133 flops a sample (22 GFLOP at B = 2, D = 5), ran on
// scalar FMAs.  Bounded, like the narrow kernel, by those bytes read once
// (0.151 ms in bf16 at B = 2, D = 5) and by the instructions that sample;
// the contraction is a matrix product, 0.14 ms at the TF32 peak in three
// passes.  Design:
// - Every output from one sampling: an item is (b, a tile of pixels, a
//   channel c) with the D dilations of its launch (groups of kWideMaxD = 5,
//   so K stays within 48: D = 9 is two launches) and is one ring slot: the
//   block samples its 9 D taps into an A tile in shared memory (K = 9 D
//   rows rounded up to 8, f32) between two barriers (a slot a dilation,
//   4.5 samples a thread between barriers, measured 1.10 ms on the H100,
//   PERF.md), then M / 64
//   warpgroups add A^T W with `wgmma` m64n144k8 in split TF32
//   (three passes: f32-exact products like the narrow kernel's FMAs, so no
//   rounding point is added; A split in registers, W's hi and lo tiles in
//   shared memory), all O outputs of the tile in registers: O rounded up
//   to 16 (otp_dcn::product_cols: 144 at 133 and 136), a warpgroup 64
//   pixels x 144 columns, one m64n144k8 product a pass; past 144 outputs
//   each 144 are a launch of their own.  mma.sync m16n8k8 ran the same
//   product at its own rate, about half of the card's TF32 peak: 35% of a
//   1.09 ms call at O = 133, D = 5 in bf16 (H100, PERF.md); m64n16k8 products
//   waited on after each k8 step took longer still.
// - The weights are split once a call into swizzled K-major tiles
//   (otp_dcn::wide_wtile_kernel); an item's tiles come into shared memory
//   by cp.async with its first stage.
// - The ring's rows (cp.async) and the x planes with their zero border are
//   the narrow kernel's; a block is 16 warps, one an SM (WCfg: bf16 tiles of
//   128 pixels, f32 of 64), the next item's rows and plane loaded while the
//   block samples and multiplies one.
// - The items are cut into equal ranges of one wave of blocks, so B = 1
//   fills the card too; a block writes each tile it leaves as an f32
//   partial row, and a reduction adds a tile's rows in block order, then the
//   dilation groups in group order: no atomics, the same bits every call.
#include <vector>

#include "common.cuh"
#include "dcn_wide.cuh"
#include "mma.cuh"

namespace {

using otp_mma::cp_async16;
using otp_mma::cp_async_commit;
using otp_mma::cp_async_wait;
using otp_mma::smem_u32;

constexpr int kMaxD = 8;
constexpr int kPix = 2;                  // pixels per thread
constexpr int kRows = 27;                // 18 offset + 9 mask rows of one stage
constexpr int kReduceThreads = 256;
constexpr int kSmemLimit = 227 * 1024;   // shared memory one block may use

enum { kExact = 0, kPallas3 = 1 };

// Threads a block, ring stages and the resident blocks an SM that the
// register cap is set for, by compute dtype.  With the x planes staged, an
// SM holds two bf16 blocks (2 x 28.4 KB of stages + 2 x 17.2 KB of planes
// each) or one f32 block (2 x 56 KB + 2 x 31.4 KB).
template <typename T> struct Cfg;
template <> struct Cfg<__nv_bfloat16> {
  static constexpr int threads = 256, stages = 2, blocks = 2;
};
template <> struct Cfg<float> {
  static constexpr int threads = 256, stages = 2, blocks = 1;
};

template <typename T>
__host__ __device__ constexpr int tile() {
  return Cfg<T>::threads * kPix;
}

template <typename T, int OP>
__host__ __device__ constexpr int stage_bytes() {
  return kRows * tile<T>() * (int)sizeof(T) + 9 * OP * (int)sizeof(float);
}

// An x plane in shared memory: H + 2 rows of `ld` elements, pixel (y, x) at
// (y + 1) * ld + kLead + x, with a one-pixel border of zeros (the corners a
// sample takes outside the image) and rows that start on 16 bytes.
template <typename T>
struct Plane {
  static constexpr int kLead = 16 / (int)sizeof(T);
  __host__ __device__ static int ld(int W) { return (kLead + W + 1 + kLead - 1) / kLead * kLead; }
  __host__ __device__ static int elems(int H, int W) { return (H + 2) * ld(W); }
};

struct Args {
  const void* x;                // (B, C, H, W)
  const void* offs[kMaxD];      // (B, 18 C, H, W) each
  const void* masks[kMaxD];     // (B, 9 C, H, W) each
  int dils[kMaxD];
  const float* w;               // (D, C, 9, ldw) f32, zero past O: this launch's columns
  const float* bias;            // (OP,) f32, the mean over D
  void* out;                    // (B, ldo, H, W): this launch's rows, written without partial
  float* partial;               // (slots, B, ldo, H*W): this launch's rows, written when given
  int B, C, O, H, W, D;
  int ldw;                      // the weight rows' length (the pack's OP)
  int ldo;                      // output rows an item (the whole O)
  int zbase;                    // this launch's first partial slot
  int nx;                       // x plane slots in shared memory (XS)
};

// 16-byte cp.async that copies `bytes` (0 or 16) and zero-fills the rest
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(bytes));
}

// The four corners (y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1) of
// a position inside (-1, H) x (-1, W), zero outside the image, and its floors.
// XS: from a plane in shared memory with its zero border (`img` at pixel
// (0, 0), rows `ld` apart); else through L1 from the (H, W) plane in device
// memory, at clamped indices.
template <typename T, bool XS>
__device__ __forceinline__ void corners(const T* __restrict__ img, int ld, int H, int W, float sy,
                                        float sx, float& fy, float& fx, float (&v)[4]) {
  const int y0 = __float2int_rd(sy), x0 = __float2int_rd(sx);
  fy = (float)y0;
  fx = (float)x0;
  if constexpr (XS) {
    const T* a = img + y0 * ld + x0;
    v[0] = to_f<T>(a[0]);
    v[1] = to_f<T>(a[1]);
    v[2] = to_f<T>(a[ld]);
    v[3] = to_f<T>(a[ld + 1]);
  } else {
    const bool ky0 = y0 >= 0, ky1 = y0 + 1 < H, kx0 = x0 >= 0, kx1 = x0 + 1 < W;
    const T* r0 = img + max(y0, 0) * W;
    const T* r1 = img + min(y0 + 1, H - 1) * W;
    const int c0 = max(x0, 0), c1 = min(x0 + 1, W - 1);
    v[0] = ky0 && kx0 ? to_f<T>(__ldg(r0 + c0)) : 0.f;
    v[1] = ky0 && kx1 ? to_f<T>(__ldg(r0 + c1)) : 0.f;
    v[2] = ky1 && kx0 ? to_f<T>(__ldg(r1 + c0)) : 0.f;
    v[3] = ky1 && kx1 ? to_f<T>(__ldg(r1 + c1)) : 0.f;
  }
}

// kExact: bilinear, f32, corner weights and their sum in the plain version's
// order (a corner outside the image adds w * 0)
__device__ __forceinline__ float bilinear_exact(float sy, float sx, float fy, float fx,
                                                const float (&v)[4]) {
  const float ly = __fsub_rn(sy, fy), lx = __fsub_rn(sx, fx);
  const float hy = __fsub_rn(1.f, ly), hx = __fsub_rn(1.f, lx);
  float s = __fmul_rn(__fmul_rn(hy, hx), v[0]);
  s = __fadd_rn(s, __fmul_rn(__fmul_rn(hy, lx), v[1]));
  s = __fadd_rn(s, __fmul_rn(__fmul_rn(ly, hx), v[2]));
  return __fadd_rn(s, __fmul_rn(__fmul_rn(ly, lx), v[3]));
}

// kPallas3: make_pallas3's separable tent at the two integer neighbours on
// each axis, y weights rounded to T, x weights f32, rows summed per column
template <typename T>
__device__ __forceinline__ float tent_pallas3(float sy, float sx, float fy, float fx,
                                              const float (&v)[4]) {
  const float wy0 = rnd<T>(fmaxf(__fsub_rn(1.f, fabsf(__fsub_rn(sy, fy))), 0.f));
  const float wy1 = rnd<T>(fmaxf(__fsub_rn(1.f, fabsf(__fsub_rn(sy, fy + 1.f))), 0.f));
  const float wx0 = fmaxf(__fsub_rn(1.f, fabsf(__fsub_rn(sx, fx))), 0.f);
  const float wx1 = fmaxf(__fsub_rn(1.f, fabsf(__fsub_rn(sx, fx + 1.f))), 0.f);
  const float col0 = __fadd_rn(__fmul_rn(v[0], wy0), __fmul_rn(v[2], wy1));
  const float col1 = __fadd_rn(__fmul_rn(v[1], wy0), __fmul_rn(v[3], wy1));
  return __fadd_rn(__fmul_rn(col0, wx0), __fmul_rn(col1, wx1));
}

template <typename T, int Mode, bool Wide, int NQ, bool XS>
__global__ void __launch_bounds__(Cfg<T>::threads, NQ <= 5 ? Cfg<T>::blocks : 1)
deform_staged_kernel(const __grid_constant__ Args a) {
  constexpr int NT = Cfg<T>::threads, TP = tile<T>(), S = Cfg<T>::stages;
  constexpr int OP = 4 * NQ, SB = stage_bytes<T, OP>();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ const T* offs[kMaxD];
  __shared__ const T* masks[kMaxD];
  __shared__ int dils[kMaxD];
  const int H = a.H, W = a.W, P = H * W, C = a.C, D = a.D;
  // only a launch of OP = 32 can be one of several O groups, whose weight
  // rows and output rows are longer than its own: below it, the strides are
  // compile-time OP and O
  const int ldw = OP == 32 ? a.ldw : OP, ldo = OP == 32 ? a.ldo : a.O;
  // XS: channel c's plane in slot c % nx; nx is 2 when D >= S - 1 (a slot is
  // refilled only after the channel two back is consumed), else S
  T* xs = reinterpret_cast<T*>(smem + S * SB);
  const int ld = Plane<T>::ld(W), xplane = Plane<T>::elems(H, W);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int d = 0; d < kMaxD; ++d) {
      offs[d] = static_cast<const T*>(a.offs[d]);
      masks[d] = static_cast<const T*>(a.masks[d]);
      dils[d] = a.dils[d];
    }
  }
  if constexpr (XS) {   // the zero borders; the copies fill only the interiors
    uint4* z = reinterpret_cast<uint4*>(xs);
    for (int e = threadIdx.x; e < a.nx * xplane * (int)sizeof(T) / 16; e += NT)
      z[e] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  const int p0 = blockIdx.x * TP, b = blockIdx.y;
  const int n = C * D;
  const int t0 = blockIdx.z * n / gridDim.z, nst = (blockIdx.z + 1) * n / gridDim.z - t0;
  const T* xb = static_cast<const T*>(a.x) + (size_t)b * C * P;

  // stage i of this block (global stage t0 + i) into ring slot i % S, with
  // the plane of its channel when the channel starts there
  auto load = [&](int i) {
    const int t = t0 + i, c = t / D, d = t - c * D;
    unsigned char* st = smem + (i % S) * SB;
    const size_t bc = (size_t)b * C + c;
    const T* src_off = offs[d] + bc * 18 * P + p0;
    const T* src_msk = masks[d] + bc * 9 * P + p0;
    const T* src_x = xb + (size_t)c * P;
    T* dst = reinterpret_cast<T*>(st);
    T* xdst = xs + (c % a.nx) * xplane + ld + Plane<T>::kLead;   // pixel (0, 0)
    const bool plane = XS && (i == 0 || d == 0);
    if constexpr (Wide) {
      constexpr int E = 16 / (int)sizeof(T), CPR = TP / E;   // elements a chunk, chunks a row
      for (int e = threadIdx.x; e < kRows * CPR; e += NT) {
        const int r = e / CPR, q = e - r * CPR;
        const T* src = (r < 18 ? src_off + (size_t)r * P : src_msk + (size_t)(r - 18) * P) + q * E;
        const bool in = p0 + q * E < P;
        cp_async16_zfill(dst + r * TP + q * E, in ? src : src_off, in ? 16 : 0);
      }
      if (plane) {
        const int cpw = W / E;   // chunks an image row
        for (int e = threadIdx.x; e < H * cpw; e += NT) {
          const int y = e / cpw, q = e - y * cpw;
          cp_async16(xdst + y * ld + q * E, src_x + y * W + q * E);
        }
      }
    } else {
      for (int e = threadIdx.x; e < kRows * TP; e += NT) {
        const int r = e / TP, q = e - r * TP;
        const T* src = r < 18 ? src_off + (size_t)r * P : src_msk + (size_t)(r - 18) * P;
        dst[e] = p0 + q < P ? src[q] : from_f<T>(0.f);
      }
      if (plane)
        for (int e = threadIdx.x; e < P; e += NT) xdst[e / W * ld + e % W] = src_x[e];
    }
    const float* wsrc = a.w + ((size_t)d * C + c) * 9 * ldw;
    float* wdst = reinterpret_cast<float*>(st + kRows * TP * sizeof(T));
    if (ldw == OP) {   // known at compile time below OP = 32
      for (int e = threadIdx.x; e < 9 * OP / 4; e += NT) cp_async16(wdst + 4 * e, wsrc + 4 * e);
    } else {
      for (int e = threadIdx.x; e < 9 * OP / 4; e += NT) {
        const int k = e / (OP / 4), q = e - k * (OP / 4);
        cp_async16(wdst + 4 * e, wsrc + k * ldw + 4 * q);
      }
    }
  };

  float py[kPix], px[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int p = p0 + threadIdx.x + j * NT;
    py[j] = (float)(p / W);
    px[j] = (float)(p % W);
  }
  const float Hf = (float)H, Wf = (float)W;
  float acc[kPix][OP];
#pragma unroll
  for (int j = 0; j < kPix; ++j)
#pragma unroll
    for (int o = 0; o < OP; ++o) acc[j][o] = 0.f;

#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < nst) load(i);
    cp_async_commit();
  }
  OTP_PHASE_START;
  for (int i = 0; i < nst; ++i) {
    cp_async_wait<S - 2>();    // stage i has landed (this thread's copies)
    __syncthreads();           // everyone's copies, and stage i - 1 is consumed
    if (i + S - 1 < nst) load(i + S - 1);
    cp_async_commit();
    OTP_PHASE(0);

    const int t = t0 + i, c = t / D, d = t - c * D;
    const T* so = reinterpret_cast<const T*>(smem + (i % S) * SB);
    const float* sw = reinterpret_cast<const float*>(smem + (i % S) * SB + kRows * TP * sizeof(T));
    const int dil = dils[d];
    const T* img = XS ? xs + (c % a.nx) * xplane + ld + Plane<T>::kLead : xb + (size_t)c * P;
    float v[9][kPix];
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const int lp = threadIdx.x + j * NT;
      // the tap offsets and the exact mode's pixel + tap, once a stage
      float tap[3], by[3], bx[3];
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        tap[u] = (float)((u - 1) * dil);
        by[u] = __fadd_rn(py[j], tap[u]);
        bx[u] = __fadd_rn(px[j], tap[u]);
      }
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const float oy = to_f<T>(so[(2 * k) * TP + lp]);
        const float ox = to_f<T>(so[(2 * k + 1) * TP + lp]);
        float m = to_f<T>(so[(18 + k) * TP + lp]);
        float sy, sx;
        if constexpr (Mode == kExact) {
          sy = __fadd_rn(by[k / 3], oy);
          sx = __fadd_rn(bx[k % 3], ox);
        } else {
          sy = __fadd_rn(__fadd_rn(oy, tap[k / 3]), py[j]);
          sx = __fadd_rn(__fadd_rn(ox, tap[k % 3]), px[j]);
        }
        // a position outside (-1, H) x (-1, W) (NaN included) samples 0:
        // it is moved to (0, 0) and its mask to 0
        if (!(sy > -1.f && sy < Hf && sx > -1.f && sx < Wf)) sy = sx = m = 0.f;
        float fy, fx, q[4];
        corners<T, XS>(img, ld, H, W, sy, sx, fy, fx, q);
        if constexpr (Mode == kExact)
          v[k][j] = __fmul_rn(bilinear_exact(sy, sx, fy, fx, q), m);
        else
          v[k][j] = rnd<T>(__fmul_rn(rnd<T>(tent_pallas3<T>(sy, sx, fy, fx, q)), m));
      }
    }
    OTP_PHASE(1);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const float4* wk = reinterpret_cast<const float4*>(sw + k * OP);
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float4 w4 = wk[q];
#pragma unroll
        for (int j = 0; j < kPix; ++j) {
          acc[j][4 * q] = fmaf(w4.x, v[k][j], acc[j][4 * q]);
          acc[j][4 * q + 1] = fmaf(w4.y, v[k][j], acc[j][4 * q + 1]);
          acc[j][4 * q + 2] = fmaf(w4.z, v[k][j], acc[j][4 * q + 2]);
          acc[j][4 * q + 3] = fmaf(w4.w, v[k][j], acc[j][4 * q + 3]);
        }
      }
    }
    OTP_PHASE(2);
  }

  const int O = a.O;
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int p = p0 + threadIdx.x + j * NT;
    if (p >= P) continue;
    if (a.partial == nullptr) {
      T* ob = static_cast<T*>(a.out) + (size_t)b * ldo * P + p;
#pragma unroll
      for (int o = 0; o < OP; ++o)
        if (o < O) ob[(size_t)o * P] = from_f<T>(acc[j][o] / (float)D + a.bias[o]);
    } else {
      float* pb = a.partial + ((size_t)(a.zbase + blockIdx.z) * a.B + b) * ldo * P + p;
#pragma unroll
      for (int o = 0; o < OP; ++o)
        if (o < O) pb[(size_t)o * P] = acc[j][o];
    }
  }
}

// out = (sum of the partial sums, in slot order) / D + bias, rounded
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
deform_reduce_kernel(const float* __restrict__ partial, const float* __restrict__ bias,
                     T* __restrict__ out, int split, int n, int O, int P, int D) {
  OTP_PHASE_START;
  const int i = blockIdx.x * kReduceThreads + threadIdx.x;
  if (i < n) {
    float s = partial[i];
    for (int k = 1; k < split; ++k) s += partial[(size_t)k * n + i];
    out[i] = from_f<T>(s / (float)D + bias[(i / P) % O]);
  }
  OTP_PHASE(3);
}

template <typename T, int Mode, bool Wide, int NQ, bool XS>
cudaError_t launch(const Args& a, dim3 grid, cudaStream_t st) {
  const int smem = Cfg<T>::stages * stage_bytes<T, 4 * NQ>() +
                   (XS ? a.nx * Plane<T>::elems(a.H, a.W) * (int)sizeof(T) : 0);
  auto kern = deform_staged_kernel<T, Mode, Wide, NQ, XS>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, Cfg<T>::threads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int Mode, bool Wide, bool XS>
cudaError_t launch_op(int OP, const Args& a, dim3 grid, cudaStream_t st) {
  switch (OP) {
    case 8: return launch<T, Mode, Wide, 2, XS>(a, grid, st);
    case 20: return launch<T, Mode, Wide, 5, XS>(a, grid, st);
    case 32: return launch<T, Mode, Wide, 8, XS>(a, grid, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int Mode, bool Wide>
cudaError_t launch_xs(bool xs, int OP, const Args& a, dim3 grid, cudaStream_t st) {
  return xs ? launch_op<T, Mode, Wide, true>(OP, a, grid, st)
            : launch_op<T, Mode, Wide, false>(OP, a, grid, st);
}

// the kernel for (mode, wide, OP), gathering from x planes staged in shared
// memory when two (or S) planes fit beside the ring, else through L1
template <typename T>
cudaError_t launch_all(int mode, bool wide, int OP, Args& a, dim3 grid, cudaStream_t st) {
  constexpr int S = Cfg<T>::stages;
  a.nx = a.D >= S - 1 ? 2 : S;
  const bool xs =
      S * stage_bytes<T, 32>() + a.nx * Plane<T>::elems(a.H, a.W) * (int)sizeof(T) <= kSmemLimit;
  if (mode == kExact)
    return wide ? launch_xs<T, kExact, true>(xs, OP, a, grid, st)
                : launch_xs<T, kExact, false>(xs, OP, a, grid, st);
  return wide ? launch_xs<T, kPallas3, true>(xs, OP, a, grid, st)
              : launch_xs<T, kPallas3, false>(xs, OP, a, grid, st);
}

// ---------------------------------------------------------------------------
// The wide path: the exact mode past 32 outputs (otp_deform_wide)
// ---------------------------------------------------------------------------
using otp_dcn::group_k;
using otp_dcn::product_cols;
using otp_dcn::seg_first;
using otp_dcn::seg_last;

constexpr int kWideCols = 144;  // product columns a launch: one m64n144k8 product a pass
constexpr int kWideMaxD = 5;    // dilations a launch: K = 45 -> 48, the A tile's depth
constexpr int kWideThreads = 512;   // four warpgroups

// The pixels of an item (M: M / 64 warpgroups run the product), ring slots
// and x plane slots, by dtype (a block of 16 warps, one an SM).  A ring slot
// is an item: the 27 offset and mask rows of each of its dilations.  At
// D = 5 and 144 columns a bf16 block holds 2 x 34.6 KB of ring, the A tile
// (26.1 KB), the item's W tiles (73.7 KB) and two x planes (2 x 17.2 KB);
// an f32 block 2 x 34.6 KB, 13.8 KB, 73.7 KB and 2 x 31.4 KB.
template <typename T> struct WCfg;
template <> struct WCfg<__nv_bfloat16> { static constexpr int M = 128, stages = 2, planes = 2; };
template <> struct WCfg<float> { static constexpr int M = 64, stages = 2, planes = 2; };

template <typename T>
__host__ __device__ inline int wide_slot_bytes(int dn) {   // a ring slot: an item's rows
  return (dn * kRows * WCfg<T>::M * (int)sizeof(T) + 15) / 16 * 16;
}

struct WArgs {
  const void* x;                // (B, C, H, W)
  const void* offs[kMaxD];      // (B, 18 C, H, W) each: this launch's dilations
  const void* masks[kMaxD];     // (B, 9 C, H, W) each
  int dils[kMaxD];
  const float* wt;              // W tiles (C, chunks, 2, 144, 32): otp_dcn::wide_wtile_kernel
  float* partial;               // (B tiles J, cols, M) f32: each segment's sums
  int B, C, H, W, D;            // D: this launch's dilations
  int ks, chunks;               // k8 steps an item (group_k(D) / 8), 32-value K chunks
  int cols;                     // this launch's product columns
  int tiles, J;                 // pixel tiles an image, segments a tile
  long long N;                  // items: B tiles C
};

// Items are (b, pixel tile u, channel c), channel inner; a block takes an
// equal range of them (otp_dcn::seg_first).  An item is one ring slot (its
// channel's rows at each of its D dilations) and two barriers: the block's
// threads sample its 9 D taps (a warp one tap of 32 pixels at a time) into
// the A tile (K x M pixels, f32, rows dl * 9 + k), then M / 64 warpgroups
// add A^T W (M pixels x cols outputs) with `wgmma` m64n144k8 in split TF32
// (A split in registers, two k8 steps' in flight; W's hi and lo tiles in
// shared memory, zero past cols) into accumulators that stay in registers
// until the block leaves the tile.  The item's W tiles come into shared
// memory by cp.async as it starts.
template <typename T, bool Wide, bool XS>
__global__ void __launch_bounds__(kWideThreads, 1)
deform_wide_kernel(const __grid_constant__ WArgs a) {
  constexpr int NT = kWideThreads, S = WCfg<T>::stages, NX = WCfg<T>::planes, M = WCfg<T>::M;
  constexpr int LDA = M + 8;                         // A's row: conflict-free fragment loads
  static_assert(NT % M == 0 && M % 64 == 0, "threads must tile the pixels");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ const T* offs[kMaxD];
  __shared__ const T* masks[kMaxD];
  __shared__ int dils[kMaxD];
  // the W tiles first, 1024-byte aligned (the swizzle's period)
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const int H = a.H, W = a.W, P = H * W, C = a.C, dn = a.D, Kc = 8 * a.ks, cols = a.cols;
  const int RB = wide_slot_bytes<T>(dn);
  const int wfl = a.chunks * 2 * kWideCols * 32;     // the item's W tiles, floats
  float* Wt = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + wfl * 4;
  float* As = reinterpret_cast<float*>(ring + S * RB);
  T* xs = reinterpret_cast<T*>(As + Kc * LDA);
  const int ld = Plane<T>::ld(W), xplane = Plane<T>::elems(H, W);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int d = 0; d < kMaxD; ++d) {
      offs[d] = static_cast<const T*>(a.offs[d]);
      masks[d] = static_cast<const T*>(a.masks[d]);
      dils[d] = a.dils[d];
    }
  }
  // A's rows past 9 D stay zero; the x planes' borders too
  for (int e = threadIdx.x; e < Kc * LDA; e += NT) As[e] = 0.f;
  if constexpr (XS) {
    uint4* z = reinterpret_cast<uint4*>(xs);
    for (int e = threadIdx.x; e < NX * xplane * (int)sizeof(T) / 16; e += NT)
      z[e] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  const long long G = gridDim.x, z = blockIdx.x;
  const long long t0 = z * a.N / G;
  const int items = (int)((z + 1) * a.N / G - t0);
  const T* xg = static_cast<const T*>(a.x);

  // item j into ring slot j % S: rows dl * 27 + r of its tile, and x's
  // plane of its (b, c) into plane slot j % NX
  auto load = [&](int j) {
    const long long t = t0 + j, q = t / C;
    const int c = (int)(t - q * C), b = (int)(q / a.tiles), p0 = (int)(q % a.tiles) * M;
    const size_t bc = (size_t)b * C + c;
    T* dst = reinterpret_cast<T*>(ring + (j % S) * RB);
    if constexpr (Wide) {
      constexpr int E = 16 / (int)sizeof(T), CPR = M / E;
      for (int e = threadIdx.x; e < dn * kRows * CPR; e += NT) {
        const int rr = e / CPR, qq = e - rr * CPR, dl = rr / kRows, r = rr - dl * kRows;
        const T* src = (r < 18 ? offs[dl] + (bc * 18 + r) * P : masks[dl] + (bc * 9 + r - 18) * P) +
                       p0 + qq * E;
        const bool in = p0 + qq * E < P;
        cp_async16_zfill(dst + rr * M + qq * E, in ? src : offs[dl], in ? 16 : 0);
      }
    } else {
      for (int e = threadIdx.x; e < dn * kRows * M; e += NT) {
        const int rr = e / M, qq = e - rr * M, dl = rr / kRows, r = rr - dl * kRows;
        const T* src = r < 18 ? offs[dl] + (bc * 18 + r) * P : masks[dl] + (bc * 9 + r - 18) * P;
        dst[e] = p0 + qq < P ? src[p0 + qq] : from_f<T>(0.f);
      }
    }
    if constexpr (XS) {
      const T* src_x = xg + bc * P;
      T* xdst = xs + (j % NX) * xplane + ld + Plane<T>::kLead;   // pixel (0, 0)
      if constexpr (Wide) {
        constexpr int E = 16 / (int)sizeof(T);
        const int cpw = W / E;
        for (int e = threadIdx.x; e < H * cpw; e += NT) {
          const int y = e / cpw, qq = e - y * cpw;
          cp_async16(xdst + y * ld + qq * E, src_x + y * W + qq * E);
        }
      } else {
        for (int e = threadIdx.x; e < P; e += NT) xdst[e / W * ld + e % W] = src_x[e];
      }
    }
  };
  // item j's W tiles into Wt
  auto load_w = [&](int j) {
    const float* src = a.wt + (size_t)((t0 + j) % C) * wfl;
    for (int e = threadIdx.x; e < wfl / 4; e += NT) cp_async16(Wt + 4 * e, src + 4 * e);
  };

  // the sampler: pixel pl of the tile, taps kk0, kk0 + NT / M, ... of the
  // item's 9 D (a warp's lanes share one)
  const int pl = threadIdx.x % M, kk0 = threadIdx.x / M;
  // the product: warpgroup wg < M / 64 holds pixels wg * 64 + [0, 64), its
  // warp w4 the 16 rows w4 * 16 + [0, 16), and the launch's columns
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, qd = lane & 3;
  const int wg = warp >> 2, row0 = warp * 16;
  float acc[2 * kWideCols / 4];
#pragma unroll
  for (int e = 0; e < 2 * kWideCols / 4; ++e) acc[e] = 0.f;
  // k8 step s of the product: A's fragment of the warp's rows split into
  // (ah, al) (free once step s - 2 is done), then lo hi, hi lo, hi hi
  auto step = [&](int s, uint32_t (&ah)[4], uint32_t (&al)[4]) {
    otp_dcn::wgmma_wait<1>();
    otp_dcn::fence_regs(ah);   // step s - 2's products have read them
    otp_dcn::fence_regs(al);
    const float* ap = As + (8 * s + qd) * LDA + row0 + g;
    otp_mma::split_tf32(ap[0], ah[0], al[0]);             // A[g][q]
    otp_mma::split_tf32(ap[8], ah[1], al[1]);             // A[g + 8][q]
    otp_mma::split_tf32(ap[4 * LDA], ah[2], al[2]);       // A[g][q + 4]
    otp_mma::split_tf32(ap[4 * LDA + 8], ah[3], al[3]);   // A[g + 8][q + 4]
    // chunk s / 4's hi and lo tiles, k8 step s % 4 (32 bytes) into them
    const float* tile = Wt + (s >> 2) * 2 * kWideCols * 32;
    const uint64_t dhi = otp_dcn::sw128_desc(tile) + 2 * (s & 3);
    const uint64_t dlo = otp_dcn::sw128_desc(tile + kWideCols * 32) + 2 * (s & 3);
    otp_dcn::wgmma_fence();
    otp_dcn::wgmma_n144_tf32(acc, al, dhi);
    otp_dcn::wgmma_n144_tf32(acc, ah, dlo);
    otp_dcn::wgmma_n144_tf32(acc, ah, dhi);
    otp_dcn::wgmma_commit();
  };
  const float Hf = (float)H, Wf = (float)W;

#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < items) load(i);
    cp_async_commit();
  }
  OTP_PHASE_START;
  for (int j = 0; j < items; ++j) {
    cp_async_wait<S - 2>();    // item j has landed (this thread's copies)
    __syncthreads();           // everyone's, and item j - 1 (and its product) is done
    if (j + S - 1 < items) load(j + S - 1);
    load_w(j);
    cp_async_commit();
    OTP_PHASE(0);

    const long long t = t0 + j, q = t / C;
    const int c = (int)(t - q * C), b = (int)(q / a.tiles), p = (int)(q % a.tiles) * M + pl;
    const T* slot = reinterpret_cast<const T*>(ring + (j % S) * RB);
    const T* img = XS ? xs + (j % NX) * xplane + ld + Plane<T>::kLead
                      : xg + ((size_t)b * C + c) * P;
    const float py = (float)(p / W), px = (float)(p % W);
#pragma unroll 4
    for (int kk = kk0; kk < 9 * dn; kk += NT / M) {
      const int dl = kk / 9, k = kk - 9 * dl, dil = dils[dl];
      const T* so = slot + dl * kRows * M;
      const float oy = to_f<T>(so[(2 * k) * M + pl]);
      const float ox = to_f<T>(so[(2 * k + 1) * M + pl]);
      float m = to_f<T>(so[(18 + k) * M + pl]);
      // (pixel + tap) + offset, as the narrow kernel's exact mode
      float sy = __fadd_rn(__fadd_rn(py, (float)((k / 3 - 1) * dil)), oy);
      float sx = __fadd_rn(__fadd_rn(px, (float)((k % 3 - 1) * dil)), ox);
      if (!(sy > -1.f && sy < Hf && sx > -1.f && sx < Wf)) sy = sx = m = 0.f;
      float fy, fx, v4[4];
      corners<T, XS>(img, ld, H, W, sy, sx, fy, fx, v4);
      As[kk * LDA + pl] = __fmul_rn(bilinear_exact(sy, sx, fy, fx, v4), m);
    }
    OTP_PHASE(1);

    cp_async_wait<0>();
    __syncthreads();   // the item's A tile is whole, its W tiles landed
    if (wg < M / 64) {
      uint32_t ah0[4], al0[4], ah1[4], al1[4];
#pragma unroll 1
      for (int s = 0; s < a.ks; s += 2) {
        step(s, ah0, al0);
        if (s + 1 < a.ks) step(s + 1, ah1, al1);
      }
      otp_dcn::wgmma_wait<0>();
      otp_dcn::fence_regs(ah0);
      otp_dcn::fence_regs(al0);
      otp_dcn::fence_regs(ah1);
      otp_dcn::fence_regs(al1);
      otp_dcn::fence_acc72(acc);
    }
    OTP_PHASE(2);
    // the block leaves the tile: its segment's sums out (pixel rows g,
    // g + 8 of the warp's 16; columns 8 i + 2 q, + 1)
    if (wg < M / 64 && (j == items - 1 || (t + 1) / C != q)) {
      const long long row = q * a.J + (z - seg_first(q, C, a.N, G));
      float* pr = a.partial + (size_t)row * cols * M;
#pragma unroll
      for (int i = 0; i < kWideCols / 8; ++i) {
        const int o = 8 * i + 2 * qd, r = row0 + g;
        if (o < cols) {
          pr[(size_t)o * M + r] = acc[4 * i];
          pr[(size_t)(o + 1) * M + r] = acc[4 * i + 1];
          pr[(size_t)o * M + r + 8] = acc[4 * i + 2];
          pr[(size_t)(o + 1) * M + r + 8] = acc[4 * i + 3];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * i + e] = 0.f;
      }
    }
  }
}

// out[b, o, p] of one launch's outputs [o0, o0 + on): its segments' sums in
// block order, then over the dilation groups (amode 1 the first, 2 a
// middle one, 3 the last; 0 the one group) in group order in the f32 plane
// acc, divided by the whole D, plus the mean bias, rounded once
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
deform_wide_reduce_kernel(const float* __restrict__ partial, const float* __restrict__ bias,
                          T* __restrict__ out, float* acc, int B, int O, int P, int M, int tiles,
                          int J, int cols, int o0, int on, int C, long long N, long long G,
                          int Dall, int amode) {
  const long long i = (long long)blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= (long long)B * on * P) return;
  const int p = (int)(i % P);
  const long long r = i / P;
  const int oo = (int)(r % on), b = (int)(r / on);
  const long long q = (long long)b * tiles + p / M;
  const int cnt = (int)(seg_last(q, C, N, G) - seg_first(q, C, N, G) + 1);
  const float* src = partial + ((size_t)q * J * cols + oo) * M + p % M;
  float s = 0.f;
  for (int j = 0; j < cnt; ++j) s += src[(size_t)j * cols * M];
  const size_t e = ((size_t)b * O + o0 + oo) * P + p;
  if (amode == 1) acc[e] = s;
  else if (amode == 2) acc[e] = acc[e] + s;
  else out[e] = from_f<T>((amode == 3 ? acc[e] + s : s) / (float)Dall + bias[o0 + oo]);
}

template <typename T, typename F>
cudaError_t with_wide(bool wide, bool xs, F f) {
  if (wide)
    return xs ? f(deform_wide_kernel<T, true, true>) : f(deform_wide_kernel<T, true, false>);
  return xs ? f(deform_wide_kernel<T, false, true>) : f(deform_wide_kernel<T, false, false>);
}

// One launch: a group of dn dilations and `cols` product columns
struct WPlan {
  int M, xs, smem, G, J, tiles, ks, chunks;
  long long N;
};

template <typename T>
cudaError_t wide_plan(int B, int C, int H, int W, int dn, bool wide, WPlan& pl) {
  constexpr int S = WCfg<T>::stages;
  pl.M = WCfg<T>::M;
  pl.ks = group_k(dn) / 8;
  pl.chunks = (pl.ks + 3) / 4;
  auto smem_of = [&](bool xs) {
    return 1024 + pl.chunks * 2 * kWideCols * 128 + S * wide_slot_bytes<T>(dn) +
           8 * pl.ks * (pl.M + 8) * 4 +
           (xs ? WCfg<T>::planes * Plane<T>::elems(H, W) * (int)sizeof(T) : 0);
  };
  pl.xs = smem_of(true) <= kSmemLimit;
  pl.smem = smem_of(pl.xs);
  if (pl.smem > kSmemLimit) return cudaErrorInvalidValue;
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = with_wide<T>(wide, pl.xs, [&](auto kern) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         pl.smem);
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, kWideThreads, pl.smem);
  });
  if (err != cudaSuccess) return err;
  if (occ < 1) return cudaErrorInvalidConfiguration;
  pl.tiles = (H * W + pl.M - 1) / pl.M;
  pl.N = (long long)B * pl.tiles * C;
  pl.G = (int)(pl.N < (long long)sms * occ ? pl.N : (long long)sms * occ);
  pl.J = otp_dcn::seg_rows((long long)B * pl.tiles, C, pl.G);
  return cudaSuccess;
}

// A call's launches, a group of kWideMaxD dilations (j) and of kWideCols
// product columns (k) each, and its scratch: each launch's W tiles and
// partial sums, the f32 sum over dilation groups
struct WLayout {
  std::vector<WPlan> plans;                 // j * nog + k
  std::vector<size_t> wt, part;             // by j * nog + k
  size_t acc, bytes;
  int nd, nog, cols;
};

template <typename T>
cudaError_t wide_layout(int B, int C, int O, int H, int W, int D, bool wide, WLayout& L) {
  L.cols = product_cols(O);
  L.nd = (D + kWideMaxD - 1) / kWideMaxD;
  L.nog = (L.cols + kWideCols - 1) / kWideCols;
  L.plans.resize(L.nd * L.nog);
  L.wt.resize(L.nd * L.nog);
  L.part.resize(L.nd * L.nog);
  size_t at = 0;
  auto piece = [&](size_t bytes) {
    const size_t here = at;
    at += (bytes + 255) / 256 * 256;
    return here;
  };
  for (int j = 0; j < L.nd; ++j) {
    const int dn = D - j * kWideMaxD < kWideMaxD ? D - j * kWideMaxD : kWideMaxD;
    for (int k = 0; k < L.nog; ++k) {
      const int cols = L.cols - k * kWideCols < kWideCols ? L.cols - k * kWideCols : kWideCols;
      WPlan& pl = L.plans[j * L.nog + k];
      cudaError_t err = wide_plan<T>(B, C, H, W, dn, wide, pl);
      if (err != cudaSuccess) return err;
      L.wt[j * L.nog + k] = piece((size_t)C * pl.chunks * 2 * kWideCols * 128);
      L.part[j * L.nog + k] = piece((size_t)B * pl.tiles * pl.J * cols * pl.M * 4);
    }
  }
  L.acc = piece(L.nd > 1 ? (size_t)B * O * H * W * 4 : 0);
  L.bytes = at;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_wide(const void* x, const void* const* offs, const void* const* masks,
                        const int* dils, const float* w, const float* bias, void* out,
                        void* scratch, int B, int C, int O, int OP, int H, int W, int D,
                        bool wide, cudaStream_t st) {
  WLayout L;
  cudaError_t err = wide_layout<T>(B, C, O, H, W, D, wide, L);
  if (err != cudaSuccess) return err;
  unsigned char* base = static_cast<unsigned char*>(scratch);
  const int P = H * W;
  for (int j = 0; j < L.nd; ++j) {
    const int d0 = j * kWideMaxD, dn = D - d0 < kWideMaxD ? D - d0 : kWideMaxD;
    for (int k = 0; k < L.nog; ++k) {
      const WPlan& pl = L.plans[j * L.nog + k];
      const int cols = L.cols - k * kWideCols < kWideCols ? L.cols - k * kWideCols : kWideCols;
      float* wt = reinterpret_cast<float*>(base + L.wt[j * L.nog + k]);
      err = otp_dcn::wide_wtile(w, wt, C, OP, O, k * kWideCols, d0, dn, cols, pl.chunks, st);
      if (err != cudaSuccess) return err;
      WArgs a{};
      a.x = x;
      for (int d = 0; d < dn; ++d) {
        a.offs[d] = offs[d0 + d];
        a.masks[d] = masks[d0 + d];
        a.dils[d] = dils[d0 + d];
      }
      a.wt = wt;
      a.partial = reinterpret_cast<float*>(base + L.part[j * L.nog + k]);
      a.B = B, a.C = C, a.H = H, a.W = W, a.D = dn;
      a.ks = pl.ks, a.chunks = pl.chunks, a.cols = cols;
      a.tiles = pl.tiles, a.J = pl.J, a.N = pl.N;
      err = with_wide<T>(wide, pl.xs, [&](auto kern) {
        cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             pl.smem);
        if (e != cudaSuccess) return e;
        kern<<<pl.G, kWideThreads, pl.smem, st>>>(a);
        return cudaGetLastError();
      });
      if (err != cudaSuccess) return err;
    }
  }
  for (int j = 0; j < L.nd; ++j) {
    const int amode = L.nd == 1 ? 0 : j == 0 ? 1 : j == L.nd - 1 ? 3 : 2;
    for (int k = 0; k < L.nog; ++k) {
      const WPlan& pl = L.plans[j * L.nog + k];
      const int o0 = k * kWideCols;
      const int cols = L.cols - o0 < kWideCols ? L.cols - o0 : kWideCols;
      const int on = O - o0 < cols ? O - o0 : cols;
      const long long n = (long long)B * on * P;
      deform_wide_reduce_kernel<T><<<(unsigned)((n + kReduceThreads - 1) / kReduceThreads),
                                     kReduceThreads, 0, st>>>(
          reinterpret_cast<const float*>(base + L.part[j * L.nog + k]), bias,
          static_cast<T*>(out), reinterpret_cast<float*>(base + L.acc), B, O, P, pl.M, pl.tiles,
          pl.J, cols, o0, on, C, pl.N, pl.G, D, amode);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

}  // namespace

extern "C" int otp_deform_max_groups() { return kMaxD; }
extern "C" int otp_deform_tile(int dtype) {
  OTP_DISPATCH(dtype, { return tile<T>(); });
  return 0;
}

// x: (B, C, H, W); offs[d]: (B, 2*9*C, H, W); masks[d]: (B, 9*C, H, W), all in
// the compute dtype and contiguous (`wide`: 16-byte aligned, W a multiple of
// 16 bytes).
// w: (D, C, 9, OP) f32 with tap k = 3*ky+kx, zero past O; bias: (OP,) f32;
// OP is 8, 20 or 32, or a multiple of 32 above 32 (groups of 32 outputs).
// out: (B, O, H, W).  split > 1 splits each launch's C*min(D, kMaxD) stages
// over as many blocks per tile (at most its own stages); D above kMaxD runs
// in groups of kMaxD dilations.  Either needs partial: (slots, B, O, H*W)
// f32 scratch, slots the sum over the dilation groups of each one's split.
// mode: 0 = exact, 1 = make_pallas3's rounding.
extern "C" int otp_deform(const void* x, const void* const* offs, const void* const* masks,
                          const int* dils, const void* w, const void* bias, void* out,
                          void* partial, int B, int C, int O, int OP, int H, int W, int D,
                          int split, int mode, int wide, int dtype, void* stream) {
  const bool op_ok = OP == 8 || OP == 20 || OP == 32 || (OP > 32 && OP % 32 == 0);
  if (D < 1 || B < 1 || C < 1 || H < 1 || W < 1 || O < 1 || O > OP || !op_ok ||
      split < 1 || split > C * (D < kMaxD ? D : kMaxD) ||
      ((split > 1 || D > kMaxD) && partial == nullptr) ||
      (mode != kExact && mode != kPallas3))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int P = H * W, opg = OP < 32 ? OP : 32;
  OTP_DISPATCH(dtype, {
    int slots = 0;
    for (int d0 = 0; d0 < D; d0 += kMaxD) {
      const int dn = D - d0 < kMaxD ? D - d0 : kMaxD;
      const int sp = split < C * dn ? split : C * dn;
      const dim3 grid((P + tile<T>() - 1) / tile<T>(), B, sp);
      for (int o0 = 0; o0 < O; o0 += opg) {
        Args a{};
        a.x = x;
        for (int d = 0; d < dn; ++d) {
          a.offs[d] = offs[d0 + d];
          a.masks[d] = masks[d0 + d];
          a.dils[d] = dils[d0 + d];
        }
        a.w = (const float*)w + (size_t)d0 * C * 9 * OP + o0;
        a.bias = (const float*)bias + o0;
        a.out = static_cast<T*>(out) + (size_t)o0 * P;
        a.partial = partial == nullptr ? nullptr : (float*)partial + (size_t)o0 * P;
        a.B = B, a.C = C, a.O = O - o0 < opg ? O - o0 : opg, a.H = H, a.W = W, a.D = dn;
        a.ldw = OP, a.ldo = O, a.zbase = slots;
        cudaError_t err = launch_all<T>(mode, wide != 0, opg, a, grid, st);
        if (err != cudaSuccess) return (int)err;
      }
      slots += sp;
    }
    if (partial != nullptr) {
      const int n = B * O * P;
      deform_reduce_kernel<T><<<(n + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0,
                                st>>>((const float*)partial, (const float*)bias, (T*)out,
                                      slots, n, O, P, D);
    }
  });
  return (int)cudaGetLastError();
}

// The exact mode past 32 outputs (the wide path): the product columns a
// launch takes (outputs past them are further launches), and the bytes of
// scratch otp_deform_wide needs for these shapes, or -1 for shapes it does
// not take (and -2 - the CUDA error where one occurred).
extern "C" int otp_deform_wide_cols() { return kWideCols; }
extern "C" int otp_deform_wide_dilations() { return kWideMaxD; }
extern "C" long long otp_deform_wide_scratch(int B, int C, int O, int H, int W, int D, int wide,
                                             int dtype) {
  if (D < 1 || B < 1 || C < 1 || H < 1 || W < 1 || O <= 32) return -1;
  WLayout L;
  cudaError_t err = cudaErrorInvalidValue;
  OTP_DISPATCH(dtype, { err = wide_layout<T>(B, C, O, H, W, D, wide != 0, L); });
  return err == cudaSuccess ? (long long)L.bytes : -2 - (long long)err;
}

// x, offs, masks as otp_deform (exact mode); w: the pack (D, C, 9, OP) f32
// with OP >= product_cols(O), zero past O; bias: (OP,) f32; out: (B, O, H,
// W); scratch: otp_deform_wide_scratch(...) bytes, 256-byte aligned.
extern "C" int otp_deform_wide(const void* x, const void* const* offs, const void* const* masks,
                               const int* dils, const void* w, const void* bias, void* out,
                               void* scratch, int B, int C, int O, int OP, int H, int W, int D,
                               int wide, int dtype, void* stream) {
  if (D < 1 || B < 1 || C < 1 || H < 1 || W < 1 || O <= 32 || OP < product_cols(O))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  OTP_DISPATCH(dtype, {
    return (int)launch_wide<T>(x, offs, masks, dils, (const float*)w, (const float*)bias, out,
                               scratch, B, C, O, OP, H, W, D, wide != 0, st);
  });
  return (int)cudaErrorInvalidValue;
}
