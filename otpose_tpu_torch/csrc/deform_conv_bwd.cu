// Backward of the multi-dilation modulated deformable conv of
// csrc/deform_conv.cu in its exact mode:
//
//   out[b, o, p] = sum_d sum_{c,k} W[d, o, c, k] * m_dck[b, p] * s_dck[b, p] / D + mean_d(bias[d, o])
//
// where s is the zero-padded bilinear sample of x[b, c] at
// (py + ky*dil - dil + off_y, px + kx*dil - dil + off_x) and m the raw mask.
// With g = d loss / d out and G = (1/D) * sum_o W[d, o, c, k] * g[b, o, p]:
//
//   d mask  = G * s
//   d off_y = G * m * ds/dy,  d off_x = G * m * ds/dx   (the four corners'
//             derivative, zero for a corner outside the image; the original
//             CUDA dmcn_get_coordinate_weight convention)
//   d x     = G * m * (corner weight), scattered to the four corners
//   d W[d, o, c, k] = (1/D) * sum_{b,p} g[b, o, p] * m * s
//   d bias[d, o]    = (1/D) * sum_{b,p} g[b, o, p]
//
// A sample outside (-1, H) x (-1, W) contributes nothing, as in the forward.
// Every gradient is computed in f32 and rounded once to its tensor's dtype.
//
// Replaces: the gradient that the JAX package gets by differentiating its XLA
// tent matmul (otpose_tpu/ops/deform_conv.py:276 modulated_deform_conv_multi,
// scan body :342-367) with jax.grad; there is no Pallas kernel for it.
//
// What bounds it on the H100: device memory.  The offsets and masks are read
// once and their gradients written once: 27 values a (dilation, channel,
// pixel) each way, 2 x 254 MB in bf16 at the flagship shape (B = 8,
// C = O = 17, 96x72, five dilations), 0.152 ms at 3.35 TB/s; x, g and d x add
// 1%.  Instruction issue is close behind: the compiled pixel loop is ~290
// instructions a sample (42 of them the FMAs of G and d W), 0.42 ms for the
// 42 M samples at four a clock on 132 SMs; it runs at about half that rate,
// held by latency (PERF.md).
//
// Design (the forward's structure, csrc/deform_conv.cu):
// - Work is a list of stages: (item b, channel c, dilation d, a tile of TS
//   pixels), in that order.  The grid is one wave of blocks (SMs x resident
//   blocks); block z takes the contiguous range [z N / G, (z + 1) N / G) of
//   the N stages, so every block has the same work at any B (B = 1 fills the
//   card too).  A (b, c) plane whose stages fall to several blocks is a
//   segment of each.
// - Warps by tap (two warps a tap, 18 a block): the warps of tap k read
//   the stage's offset rows 2k, 2k + 1 and mask row k and own
//   d W[d, :, c, k], whose O running sums stay in their registers until d
//   changes (a butterfly reduce over the warp, then one writer a row in
//   shared memory, the two warps' rows added in order).  G is O FMAs on g
//   against W's row for (d, c, k), read through L1.
// - A ring of two shared-memory stages, filled by 16-byte `cp.async` while
//   the previous stage is computed: the 27 offset and mask rows of the tile
//   and g's tile, transposed by a first kernel to (pixel, OPG) so a pixel's
//   g is three (bf16) or five (f32) 16-byte loads.  Rows of x that are not a
//   multiple of 16 bytes take element copies (template `Wide` = false).
// - x's (b, c) plane is staged in shared memory with a one-pixel zero
//   border, so a sample's four corners are four shared loads with no bounds
//   checks.
// - d x is summed exactly, in 64-bit fixed point, in a shared plane of two
//   32-bit words a pixel: each corner's f32 contribution c is scaled by 2^F
//   and rounded to an integer v, and two native integer atomics add v's low
//   word (returning the old one, whence the carry) and its high word plus
//   the carry.  Shared f32 atomics compile to a compare-and-swap loop, which
//   measured 0.44 ms of 1.06 at bf16 B = 8 against 0.04 ms for native
//   integer ones (PERF.md).  F comes from a bound on every
//   contribution, |c| <= max|g| * max_{d,c,k} sum_o |W| / D * max|m|
//   (the first two from the first kernel, max|m| from a pass over the masks,
//   ~0.03 ms), and on the count of samples of a plane (2^lbits), so no
//   sum can leave 64 bits and the resolution is 2^(lbits - 62) of the bound
//   (2^-43 at the flagship shape).  Integer sums do not depend on their order: the segment's plane
//   is written once as a partial f32 plane and the partials are added in a
//   fixed order, so d x is the same bits from call to call.  A non-finite
//   contribution marks its plane, whose d x is then NaN.  Planes too large
//   for shared memory (template `XS` = false) gather x through L1 and add
//   the integers to a 64-bit plane in device memory.
// - d offset and d mask have one writer each.  Partial planes and partial
//   d W rows are summed in a fixed order by reduction kernels, and d bias
//   from the first kernel's per-tile sums: every gradient is the same bits
//   from call to call.
// - Any D, by groups of launches (otp_deform_bwd): D above kMaxD is cut
//   into groups of kMaxD dilations, each a launch with its own scratch.
//   d W and d bias are per group, and the offset and mask gradients of
//   different dilations are independent.  d x is summed over the groups in
//   f32, in group order, and rounded once; the fixed point's bound uses the
//   whole D.
//
// The wide path (O > 32; the 133- and 136-joint models run O = C = 133 and
// 136), dcn_bwd_wide_kernel.  G sums over every output, and O groups would
// carry it through device memory and sample once a group (five launches in
// a row at O = 133, each re-reading g, the offsets and the masks), with G
// and d W on scalar FMAs: 2 x 133 a sample each.  Bounded, like the narrow
// kernel, by the offsets and masks read once and their gradients written
// once (0.300 ms in bf16 at B = 2, D = 5), and by the instructions that
// sample.  Design:
// - No O groups: an item is (plane (b, c), a tile of 64 pixels) with the
//   dilations of its launch (groups of kWideMaxD = 5, so K stays within 48),
//   the items cut into equal ranges of one wave of blocks as above.  As an
//   item starts, G[K, p] = (1/D) sum_o W[o, K] g[p, o] for its 9 D taps K
//   is one product over O on the tensor cores (mma.sync m16n8k8 in split
//   TF32; g's tile, from the first kernel's (pixel, output) layout, is A;
//   W's B fragments are split once a call, otp_dcn::wide_wfrag_kernel, and
//   come into shared memory with each plane where it holds them (bf16; f32
//   reads them through L1)), cut into 48 equal tasks of half of K each so
//   that no warp holds two whole tiles (4.20 -> 3.93 ms at O = 133, D = 5
//   in bf16 on the H100, PERF.md), kept in shared memory.
// - A ring slot is an item, all of its dilations (with g's tile where two
//   slots fit): three barriers an item.  A slot a dilation left one sample a
//   thread between barriers (4.89 ms on the H100, PERF.md).
// - The sampling is the narrow kernel's (warp w: tap w % 9, 32 pixels, at
//   each dilation): d mask, d offset, d x in the fixed-point plane, m s
//   kept in shared memory.
// - Then d W[o, K] += sum_p g[p, o] (m s)[K, p] is the second product (K
//   of the product the tile's pixels); the outputs x taps accumulators stay
//   in registers until the plane changes and go out as the segment's
//   partial row, which the reduction adds in block order.
// - bf16 g is exact in TF32, so its products take two passes (g W hi +
//   g W lo), f32 three; every gradient is f32 and rounded once, with no
//   float atomics: the same bits every call.
// - g's tile of the next item is loaded with the item before it (two
//   slots) where shared memory holds both, else when the item starts.
//   The d W accumulators hold 288 outputs; a call takes O to that, and the
//   wrapper runs larger O as a call a range of outputs
//   (ops/cuda/deform_conv.py::backward_by_ranges).
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
constexpr int kMaxO = 32;
constexpr int kTaps = 9;
constexpr int kRows = 27;                // 18 offset + 9 mask rows of one stage
constexpr int kStages = 2;
constexpr int kPrepThreads = 256;
constexpr int kReduceThreads = 256;
constexpr int kSmemLimit = 227 * 1024;   // shared memory one block may use
constexpr int kStats = 3;                // scratch words: max|g|, max sum|W|, max|m|

// Pixels a stage, resident blocks an SM (the register cap) and warps a tap,
// by dtype.  One block of 18 warps an SM: the cap is 96 registers a thread
// for two blocks of 288 threads or one of 576, and one block can give the
// SM's whole shared memory to stages of 512 (bf16) or 256 (f32) pixels, so
// a barrier comes every 8 samples a thread, not every 4 (PERF.md:
// 0.90 against 1.10 ms at bf16 B = 8).  At 96x72 a bf16 block holds
// 2 x 52 KB of ring, a 17.2 KB x plane, a 55.3 KB d x plane and 7.2 KB of
// d W rows, an f32 block 2 x 48 KB, 31.4 KB, 55.3 KB and 7.2 KB.
template <typename T> struct Cfg;
template <> struct Cfg<__nv_bfloat16> { static constexpr int tile = 512, blocks = 1, wpt = 2; };
template <> struct Cfg<float> { static constexpr int tile = 256, blocks = 1, wpt = 2; };

// threads a block: wpt warps a tap
template <typename T>
__host__ __device__ constexpr int threads() {
  return 32 * kTaps * Cfg<T>::wpt;
}

// g's row in the transposed layout: OP values padded to 16 bytes
template <typename T, int OP>
__host__ __device__ constexpr int gld() {
  constexpr int E = 16 / (int)sizeof(T);
  return (OP + E - 1) / E * E;
}

template <typename T, int OP>
__host__ __device__ constexpr int stage_bytes() {
  return (kRows + gld<T, OP>()) * Cfg<T>::tile * (int)sizeof(T);
}

// x's plane in shared memory, as in the forward: H + 2 rows of `ld`
// elements, pixel (y, x) at (y + 1) * ld + kLead + x, a one-pixel border of
// zeros, rows that start on 16 bytes
template <typename T>
struct Plane {
  static constexpr int kLead = 16 / (int)sizeof(T);
  __host__ __device__ static int ld(int W) { return (kLead + W + 1 + kLead - 1) / kLead * kLead; }
  __host__ __device__ static int elems(int H, int W) { return (H + 2) * ld(W); }
};

// F of d x's fixed point, from the scratch words (max|g|, max over
// (d, c, k) of sum_o |W|, max|m|; non-negative floats as bits) and lbits >=
// log2 of the samples of a plane: every |c| 2^F < 2^(62 - lbits), so
// sum|v| < 2^62 however the samples fall.  0 where the bound is 0 or not
// finite (a non-finite contribution marks its plane anyway).
__device__ __forceinline__ int fixed_shift(const unsigned* stats, int D, int lbits) {
  const double cmax = (double)__uint_as_float(stats[0]) * __uint_as_float(stats[1]) / D *
                      __uint_as_float(stats[2]);
  if (!(cmax > 0.0) || !isfinite(cmax)) return 0;
  int e;
  frexp(cmax, &e);   // cmax < 2^e
  return 62 - lbits - e;
}

// A stage's (plane q = b C + c, dilation d, tile u), stepped in that order
struct Stage {
  int q, d, u;
  __device__ void next(int D, int tiles) {
    if (++u == tiles) {
      u = 0;
      if (++d == D) d = 0, ++q;
    }
  }
};

__host__ __device__ inline int align16(int bytes) { return (bytes + 15) / 16 * 16; }

// The blocks whose stage ranges hold plane q's first and last stages, for
// n stages a plane, N in all and G blocks (block z starts at z N / G)
using otp_dcn::seg_first;
using otp_dcn::seg_last;

struct BwdArgs {
  const void* x;                // (B, C, H, W)
  const void* offs[kMaxD];      // (B, 18 C, H, W) each
  const void* masks[kMaxD];     // (B, 9 C, H, W) each
  int dils[kMaxD];
  const float* w;               // (D, C, 9, OP) f32, zero past O
  const void* gt;               // (B, Pp, OPG) g transposed, zero past P and O
  void* d_off;                  // (D, B, 18 C, H, W)
  void* d_mask;                 // (D, B, 9 C, H, W)
  float* pdx;                   // XS: (B C J, H W) partial planes
  long long* pdx64;             // not XS: (B C, H W) fixed-point planes, zeroed
  float* pw;                    // (B C J, D * 9 * OP) partial d W rows
  unsigned* stats;              // kStats words (fixed_shift), then B C plane flags
  int B, C, O, H, W, D, tiles, Pp, J, lbits;
  int Dall;                     // the whole D (the mean's divisor)
  long long N;                  // stages: B C D tiles
};

// 16 bytes of T as floats
template <typename T> __device__ __forceinline__ void unpack16(const uint4& u, float* f);
template <> __device__ __forceinline__ void unpack16<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x), f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z), f[3] = __uint_as_float(u.w);
}
template <> __device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& u, float* f) {
  const uint32_t v[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(v[i] << 16);
    f[2 * i + 1] = __uint_as_float(v[i] & 0xffff0000u);
  }
}

// 16-byte cp.async that copies `bytes` (0 or 16) and zero-fills the rest
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(bytes));
}

template <typename T, bool Wide, int NQ, bool XS>
__global__ void __launch_bounds__(threads<T>(), NQ <= 5 ? Cfg<T>::blocks : 1)
dcn_bwd_kernel(const __grid_constant__ BwdArgs a) {
  constexpr int TS = Cfg<T>::tile, OP = 4 * NQ, OPG = gld<T, OP>(), S = kStages;
  constexpr int NT = threads<T>(), WPT = Cfg<T>::wpt;
  constexpr int SB = stage_bytes<T, OP>();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ const T* offs[kMaxD];
  __shared__ const T* masks[kMaxD];
  __shared__ int dils[kMaxD];
  const int H = a.H, W = a.W, P = H * W, C = a.C, D = a.D, O = a.O, tiles = a.tiles;
  const long long n = (long long)D * tiles, G = gridDim.x, z = blockIdx.x;
  const int ld = Plane<T>::ld(W);
  T* xs = reinterpret_cast<T*>(smem + S * SB);
  // d x's plane: the low words, then the high words, of P pixels
  unsigned* dlo = reinterpret_cast<unsigned*>(smem + S * SB +
                                              align16(Plane<T>::elems(H, W) * (int)sizeof(T)));
  int* dhi = reinterpret_cast<int*>(dlo + P);
  float* dws = XS ? reinterpret_cast<float*>(dhi + P) : reinterpret_cast<float*>(smem + S * SB);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int d = 0; d < kMaxD; ++d) {
      offs[d] = static_cast<const T*>(a.offs[d]);
      masks[d] = static_cast<const T*>(a.masks[d]);
      dils[d] = a.dils[d];
    }
  }
  if constexpr (XS) {   // x's border and d x; the copies fill x's interior
    uint4* zx = reinterpret_cast<uint4*>(xs);
    for (int e = threadIdx.x; e < Plane<T>::elems(H, W) * (int)sizeof(T) / 16; e += NT)
      zx[e] = make_uint4(0, 0, 0, 0);
    for (int e = threadIdx.x; e < 2 * P; e += NT) dlo[e] = 0u;
  }
  for (int e = threadIdx.x; e < WPT * D * kTaps * OP; e += NT) dws[e] = 0.f;
  __syncthreads();

  const long long s0 = z * a.N / G;
  const int nst = (int)((z + 1) * a.N / G - s0);
  Stage cur;   // the block's first stage
  cur.q = (int)(s0 / n);
  cur.d = (int)(s0 - cur.q * n) / tiles;
  cur.u = (int)(s0 - cur.q * n) - cur.d * tiles;
  // x's plane of q into the shared plane
  auto load_plane = [&](int q) {
    const T* src = static_cast<const T*>(a.x) + (size_t)q * P;
    T* dst = xs + ld + Plane<T>::kLead;   // pixel (0, 0)
    if constexpr (Wide) {
      constexpr int E = 16 / (int)sizeof(T);
      const int cpw = W / E;   // chunks an image row
      for (int e = threadIdx.x; e < H * cpw; e += NT) {
        const int y = e / cpw, c16 = e - y * cpw;
        cp_async16(dst + y * ld + c16 * E, src + y * W + c16 * E);
      }
    } else {
      for (int e = threadIdx.x; e < P; e += NT) dst[e / W * ld + e % W] = src[e];
    }
  };
  // stage st into ring slot `slot`: the 27 rows of its tile and g's tile
  auto load = [&](const Stage& st, int slot) {
    const int q = st.q, d = st.d, p0 = st.u * TS;
    T* dst = reinterpret_cast<T*>(smem + slot * SB);
    const T* src_off = offs[d] + (size_t)q * 18 * P + p0;
    const T* src_msk = masks[d] + (size_t)q * 9 * P + p0;
    if constexpr (Wide) {
      constexpr int E = 16 / (int)sizeof(T), CPR = TS / E;   // elements a chunk, chunks a row
      for (int e = threadIdx.x; e < kRows * CPR; e += NT) {
        const int r = e / CPR, c16 = e - r * CPR;
        const T* src = (r < 18 ? src_off + (size_t)r * P : src_msk + (size_t)(r - 18) * P) +
                       c16 * E;
        const bool in = p0 + c16 * E < P;
        cp_async16_zfill(dst + r * TS + c16 * E, in ? src : src_off, in ? 16 : 0);
      }
    } else {
      for (int e = threadIdx.x; e < kRows * TS; e += NT) {
        const int r = e / TS, c1 = e - r * TS;
        const T* src = r < 18 ? src_off + (size_t)r * P : src_msk + (size_t)(r - 18) * P;
        dst[e] = p0 + c1 < P ? src[c1] : from_f<T>(0.f);
      }
    }
    const T* gsrc = static_cast<const T*>(a.gt) + ((size_t)(q / C) * a.Pp + p0) * OPG;
    T* gdst = dst + kRows * TS;
    for (int e = threadIdx.x; e < TS * OPG * (int)sizeof(T) / 16; e += NT)
      cp_async16(gdst + e * (16 / (int)sizeof(T)), gsrc + e * (16 / (int)sizeof(T)));
  };

  // warp w: tap w % 9, the (w / 9)-th of the tap's WPT warps
  const int k = (threadIdx.x >> 5) % kTaps, h = (threadIdx.x >> 5) / kTaps, lane = threadIdx.x & 31;
  float acc[OP];
#pragma unroll
  for (int o = 0; o < OP; ++o) acc[o] = 0.f;
  int acc_d = -1;
  // the warp's running d W sums into row (acc_d, k) of the shared rows
  auto flush_acc = [&]() {
#pragma unroll
    for (int o = 0; o < OP; ++o) {
      float v = acc[o];
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
      if (lane == 0 && acc_d >= 0 && o < O) dws[((h * D + acc_d) * kTaps + k) * OP + o] += v;
      acc[o] = 0.f;
    }
  };
  // c 2^F = (c s1) s2, both factors powers of two that a float holds
  const int F = fixed_shift(a.stats, a.Dall, a.lbits);
  const float s1 = exp2f((float)(F / 2)), s2 = exp2f((float)(F - F / 2));
  const double unscale = exp2(-(double)F);
  // plane q's segment of this block: its partial d x plane and d W rows
  // out, the shared ones zeroed (after a barrier)
  auto write_segment = [&](int q) {
    const long long row = (long long)q * a.J + (z - seg_first(q, n, a.N, G));
    if constexpr (XS) {
      float* dst = a.pdx + row * P;
      for (int e = threadIdx.x; e < P; e += NT) {
        const long long v = (long long)(((unsigned long long)(unsigned)dhi[e] << 32) | dlo[e]);
        dst[e] = (float)((double)v * unscale);
        dlo[e] = 0u;
        dhi[e] = 0;
      }
    }
    float* wdst = a.pw + row * (D * kTaps * OP);
    for (int e = threadIdx.x; e < D * kTaps * OP; e += NT) {
      float sum = 0.f;
      for (int j = 0; j < WPT; ++j) {   // the tap's warps in order
        sum += dws[j * D * kTaps * OP + e];
        dws[j * D * kTaps * OP + e] = 0.f;
      }
      wdst[e] = sum;
    }
  };

  int q_cur = cur.q;
  if constexpr (XS) load_plane(q_cur);
  Stage ahead = cur;   // the next stage to load
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < nst) load(ahead, i);
    ahead.next(D, tiles);
    cp_async_commit();
  }
  const float Hf = (float)H, Wf = (float)W, inv_d = 1.f / (float)a.Dall, inv_w = 1.f / (float)W;
  OTP_PHASE_START;
  for (int i = 0; i < nst; ++i) {
    cp_async_wait<S - 2>();    // stage i has landed (this thread's copies)
    __syncthreads();           // everyone's copies, and stage i - 1 is consumed
    if (i > 0) cur.next(D, tiles);
    const int q = cur.q, d = cur.d, u = cur.u;
    if (q != q_cur) {          // a new plane: the last one's segment out, its x in
      flush_acc();
      acc_d = -1;
      __syncthreads();
      write_segment(q_cur);
      q_cur = q;
      if constexpr (XS) {
        load_plane(q);
        cp_async_commit();
        cp_async_wait<0>();
      }
      __syncthreads();
    }
    if (i + S - 1 < nst) load(ahead, (i + S - 1) % S);
    ahead.next(D, tiles);
    cp_async_commit();
    if (d != acc_d) {
      flush_acc();
      acc_d = d;
    }
    OTP_PHASE(0);

    const int b = q / C, c = q - b * C, dil = dils[d], p0 = u * TS;
    const T* so = reinterpret_cast<const T*>(smem + (i % S) * SB);
    const T* gtile = so + kRows * TS;
    // W's row for (d, c, k), read through L1 for each sample (a broadcast):
    // held in registers it cost more in spills than it saved (PERF.md)
    const float4* wk =
        reinterpret_cast<const float4*>(a.w + (((size_t)d * C + c) * kTaps + k) * OP);
    const float ty = (float)((k / 3 - 1) * dil), tx = (float)((k % 3 - 1) * dil);
    T* dob = static_cast<T*>(a.d_off) + (((size_t)d * a.B + b) * 18 * C + 18 * c + 2 * k) * P;
    T* dmb = static_cast<T*>(a.d_mask) + (((size_t)d * a.B + b) * 9 * C + 9 * c + k) * P;
    const T* img = XS ? xs + ld + Plane<T>::kLead : static_cast<const T*>(a.x) + (size_t)q * P;
    long long* dimg = a.pdx64 + (size_t)q * P;   // not XS
    bool bad = false;                             // a non-finite contribution
#pragma unroll 1
    for (int jj = h * 32 + lane; jj < TS; jj += 32 * WPT) {
      const int p = p0 + jj;
      if (p >= P) break;
      const float oy = to_f<T>(so[(2 * k) * TS + jj]);
      const float ox = to_f<T>(so[(2 * k + 1) * TS + jj]);
      float m = to_f<T>(so[(18 + k) * TS + jj]);
      const int py = __float2int_rd(((float)p + 0.5f) * inv_w), px = p - py * W;
      // the forward's position: (pixel + tap) + offset
      float sy = __fadd_rn(__fadd_rn((float)py, ty), oy);
      float sx = __fadd_rn(__fadd_rn((float)px, tx), ox);
      const bool valid = sy > -1.f && sy < Hf && sx > -1.f && sx < Wf;   // false for NaN
      if (!valid) sy = sx = m = 0.f;
      const int y0 = __float2int_rd(sy), x0 = __float2int_rd(sx);
      float v00, v01, v10, v11;
      if constexpr (XS) {
        const T* c0 = img + y0 * ld + x0;
        v00 = to_f<T>(c0[0]);
        v01 = to_f<T>(c0[1]);
        v10 = to_f<T>(c0[ld]);
        v11 = to_f<T>(c0[ld + 1]);
      } else {
        const bool ky0 = y0 >= 0, ky1 = y0 + 1 < H, kx0 = x0 >= 0, kx1 = x0 + 1 < W;
        const T* r0 = img + max(y0, 0) * W;
        const T* r1 = img + min(y0 + 1, H - 1) * W;
        const int c0 = max(x0, 0), c1 = min(x0 + 1, W - 1);
        v00 = ky0 && kx0 ? to_f<T>(__ldg(r0 + c0)) : 0.f;
        v01 = ky0 && kx1 ? to_f<T>(__ldg(r0 + c1)) : 0.f;
        v10 = ky1 && kx0 ? to_f<T>(__ldg(r1 + c0)) : 0.f;
        v11 = ky1 && kx1 ? to_f<T>(__ldg(r1 + c1)) : 0.f;
      }
      const float ly = __fsub_rn(sy, (float)y0), lx = __fsub_rn(sx, (float)x0);
      const float hy = __fsub_rn(1.f, ly), hx = __fsub_rn(1.f, lx);
      float s = __fmul_rn(__fmul_rn(hy, hx), v00);
      s = __fadd_rn(s, __fmul_rn(__fmul_rn(hy, lx), v01));
      s = __fadd_rn(s, __fmul_rn(__fmul_rn(ly, hx), v10));
      s = __fadd_rn(s, __fmul_rn(__fmul_rn(ly, lx), v11));
      float dsy = hx * (v10 - v00) + lx * (v11 - v01);
      float dsx = hy * (v01 - v00) + ly * (v11 - v10);
      if (!valid) s = dsy = dsx = 0.f;
      OTP_PHASE(1);
      // g after the sampling, so that its registers are not held across it
      float gv[OPG];
      {
        const uint4* gp = reinterpret_cast<const uint4*>(gtile + jj * OPG);
#pragma unroll
        for (int j = 0; j < OPG * (int)sizeof(T) / 16; ++j)
          unpack16<T>(gp[j], gv + j * (16 / (int)sizeof(T)));
      }
      float G = 0.f;
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const float4 w4 = __ldg(wk + j);
        G = fmaf(w4.x, gv[4 * j], G);
        G = fmaf(w4.y, gv[4 * j + 1], G);
        G = fmaf(w4.z, gv[4 * j + 2], G);
        G = fmaf(w4.w, gv[4 * j + 3], G);
      }
      G *= inv_d;
      OTP_PHASE(2);
      const float gm = G * m;
      if (valid) {
        bad |= !isfinite(gm);
        const bool ky0 = y0 >= 0, ky1 = y0 + 1 < H, kx0 = x0 >= 0, kx1 = x0 + 1 < W;
        const int e0 = y0 * W + x0;
        // the corners' contributions in fixed point; a corner outside the
        // image adds nothing
        auto add = [&](bool in, int e, float cv) {
          if (!in) return;
          const long long v = __float2ll_rn(cv * s1 * s2);
          if constexpr (XS) {
            const unsigned lo = (unsigned)v, old = atomicAdd(dlo + e, lo);
            atomicAdd(dhi + e, (int)(v >> 32) + (int)(old + lo < old));
          } else {
            atomicAdd(reinterpret_cast<unsigned long long*>(dimg + e), (unsigned long long)v);
          }
        };
        add(ky0 && kx0, e0, gm * hy * hx);
        add(ky0 && kx1, e0 + 1, gm * hy * lx);
        add(ky1 && kx0, e0 + W, gm * ly * hx);
        add(ky1 && kx1, e0 + W + 1, gm * ly * lx);
      }
      OTP_PHASE(3);
      dmb[p] = from_f<T>(G * s);
      dob[p] = from_f<T>(G * m * dsy);
      dob[(size_t)P + p] = from_f<T>(G * m * dsx);
      const float ms = m * s;
#pragma unroll
      for (int o = 0; o < OP; ++o) acc[o] = fmaf(gv[o], ms, acc[o]);
      OTP_PHASE(4);
    }
    if (bad) atomicOr(a.stats + kStats + q, 1u);
  }
  flush_acc();
  __syncthreads();
  write_segment(q_cur);
  OTP_PHASE(5);
}

// The largest of a block's non-negative values (as bits) into *word.
__device__ __forceinline__ void block_max_into(float v, unsigned* word) {
  __shared__ float part[32];
  for (int m = 16; m > 0; m >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, m));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) v = fmaxf(v, part[w]);
    atomicMax(word, __float_as_uint(v));
  }
}

struct MaskPtrs {
  const void* m[kMaxD];
};

// max|m| over the D mask maps (n values each) into stats[2]
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
dcn_bwd_mmax_kernel(const __grid_constant__ MaskPtrs mp, long long n, unsigned* stats) {
  const T* m = static_cast<const T*>(mp.m[blockIdx.y]);
  float v = 0.f;
  for (long long i = (long long)blockIdx.x * kReduceThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kReduceThreads) {
    const float x = to_f<T>(m[i]);
    v = fmaxf(v, fabsf(x)) + 0.f * x;
  }
  block_max_into(v, stats + 2);
}

// d x (B, C, H, W) in T: the segments' partial planes added in block
// order, or (not XS) the fixed-point plane scaled back; NaN for a marked
// plane.  Over groups of dilations (amode 1 the first, 2 a middle one, 3
// the last; 0 the one group) the groups' sums are added in group order in
// the f32 plane acc and rounded once, by the last.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
dcn_bwd_dx_kernel(const float* __restrict__ pdx, const long long* __restrict__ pdx64,
                  const unsigned* __restrict__ stats, T* __restrict__ dx, float* acc,
                  long long total, int P, int J, long long n, long long N, long long G, int xs,
                  int D, int lbits, int amode) {
  OTP_PHASE_START;
  const long long i = (long long)blockIdx.x * kReduceThreads + threadIdx.x;
  if (i < total) {
    const long long q = i / P, p = i - q * P;
    float s;
    if (stats[kStats + q]) {
      s = __int_as_float(0x7fffffff);
    } else if (xs) {
      const int cnt = (int)(seg_last(q, n, N, G) - seg_first(q, n, N, G) + 1);
      s = 0.f;
      for (int j = 0; j < cnt; ++j) s += pdx[(q * J + j) * P + p];
    } else {
      s = (float)((double)pdx64[i] * exp2(-(double)fixed_shift(stats, D, lbits)));
    }
    if (amode == 1) acc[i] = s;
    else if (amode == 2) acc[i] = acc[i] + s;
    else dx[i] = from_f<T>(amode == 3 ? acc[i] + s : s);
  }
  OTP_PHASE(6);
}

// One launch's d W rows (its D dilations from d0, its O outputs from o0)
// of dw (Dall, Oall, C, 3, 3) and its d bias entries of dbias (Dall, Oall),
// f32: the segments' rows and the tiles' g sums added in a fixed order,
// over the whole D
__global__ void __launch_bounds__(kReduceThreads)
dcn_bwd_w_kernel(const float* __restrict__ pw, const float* __restrict__ bpart,
                 float* __restrict__ dw, float* __restrict__ dbias, int B, int C, int O, int OP,
                 int D, int J, long long n, long long N, long long G, int nbias, int d0, int o0,
                 int Oall, int Dall) {
  const int i = blockIdx.x * kReduceThreads + threadIdx.x;
  const int nw = D * O * C * kTaps;
  if (i >= nw + O) return;
  float s = 0.f;
  if (i < nw) {   // i = ((d * O + o) * C + c) * 9 + k
    const int k = i % kTaps, dc = i / kTaps, c = dc % C, dO = dc / C, o = dO % O, d = dO / O;
    const int e = (d * kTaps + k) * OP + o, rw = D * kTaps * OP;
    for (int b = 0; b < B; ++b) {
      const long long q = (long long)b * C + c;
      const int cnt = (int)(seg_last(q, n, N, G) - seg_first(q, n, N, G) + 1);
      for (int j = 0; j < cnt; ++j) s += pw[(q * J + j) * rw + e];
    }
    dw[(((size_t)(d0 + d) * Oall + o0 + o) * C + c) * kTaps + k] = s / (float)Dall;
  } else {
    const int o = i - nw;
    for (int r = 0; r < nbias; ++r) s += bpart[(size_t)r * O + o];
    s /= (float)Dall;
    for (int d = 0; d < D; ++d) dbias[(size_t)(d0 + d) * Oall + o0 + o] = s;
  }
}


// ---------------------------------------------------------------------------
// The wide path (O > 32): G and d W on the tensor cores, no O groups
// ---------------------------------------------------------------------------
constexpr int kWideThreads = 576;   // 18 warps: a tap and 32 pixels each
constexpr int kWideTile = 64;       // pixels an item
constexpr int kWideMaxD = 5;        // dilations a launch: K = 45 -> 48, the G and m s tiles' depth
constexpr int kWideLdm = kWideTile + 4;   // G's and m s's rows: conflict-free fragments
constexpr int kWideMaxCols = 288;   // product columns the d W accumulators hold
constexpr int kWideNW = 3;          // d W's n8 tiles (taps) a warp: K <= 48, two halves
constexpr int kWideMW = 2;          // d W's m16 tiles (outputs) a warp

constexpr int kWideStages = 2;      // ring slots: an item each

// a ring slot: an item's 27 rows of each of its dn dilations
template <typename T>
__host__ __device__ inline int wide_ring_bytes(int dn) {
  return align16(dn * kRows * kWideTile * (int)sizeof(T));
}

// g's rows in shared memory: the product's columns and 16 bytes, so both
// products' fragment loads take distinct banks (or pairs)
template <typename T>
__host__ __device__ constexpr int wide_ldg(int cols) {
  return cols + 16 / (int)sizeof(T);
}

// The first kernel of both paths: g (B, O, P) -> gt (B, Pp, cols) in T,
// zero past P and O (a pixel's outputs contiguous, 32 at a time through
// shared memory; cols: the narrow kernel's OPG or the wide one's product
// columns); each 256-pixel tile's sums of g over its pixels, bpart (B * nb,
// O), in a fixed order; max|g| into stats[0]; in block (0, 0) the largest
// sum_o |W| of a (d, c, k) row of the pack (wrows rows of OP) into stats[1]
template <typename T>
__global__ void __launch_bounds__(kPrepThreads)
dcn_bwd_prep_kernel(const T* __restrict__ g, T* __restrict__ gt, float* __restrict__ bpart,
                         const float* __restrict__ w, unsigned* stats, int O, int cols, int P,
                         int Pp, int wrows, int OP) {
  __shared__ float gs[32][kPrepThreads + 1];
  const int b = blockIdx.y, t = threadIdx.x, p = blockIdx.x * kPrepThreads + t;
  const int warp = t >> 5, lane = t & 31;
  float gmax = 0.f;
  for (int o0 = 0; o0 < cols; o0 += 32) {
    __syncthreads();   // the previous chunk's sums are taken
#pragma unroll 4
    for (int oo = 0; oo < 32; ++oo) {
      const int o = o0 + oo;
      const float v = o < O && p < P ? to_f<T>(g[((size_t)b * O + o) * P + p]) : 0.f;
      gs[oo][t] = v;
      gmax = fmaxf(gmax, fabsf(v)) + 0.f * v;   // + 0 * v: a NaN g makes the bound NaN
    }
    if (p < Pp) {
      alignas(16) T vals[32];
#pragma unroll
      for (int oo = 0; oo < 32; ++oo) vals[oo] = from_f<T>(gs[oo][t]);
      const int n16 = (cols - o0 < 32 ? cols - o0 : 32) * (int)sizeof(T) / 16;
      uint4* dst = reinterpret_cast<uint4*>(gt + ((size_t)b * Pp + p) * cols + o0);
      for (int j = 0; j < n16; ++j) dst[j] = reinterpret_cast<const uint4*>(vals)[j];
    }
    __syncthreads();
    for (int oo = warp; oo < 32 && o0 + oo < O; oo += kPrepThreads / 32) {
      float s = 0.f;
      for (int i = 0; i < kPrepThreads / 32; ++i) s += gs[oo][lane + 32 * i];
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
      if (lane == 0) bpart[((size_t)b * gridDim.x + blockIdx.x) * O + o0 + oo] = s;
    }
  }
  block_max_into(gmax, stats);
  if (blockIdx.x == 0 && blockIdx.y == 0) {
    float wmax = 0.f;
    for (int r = t; r < wrows; r += kPrepThreads) {
      float sum = 0.f;
      for (int o = 0; o < OP; ++o) sum += fabsf(w[(size_t)r * OP + o]);
      wmax = fmaxf(wmax, sum) + 0.f * sum;
    }
    __syncthreads();
    block_max_into(wmax, stats + 1);
  }
}

struct WBwdArgs {
  const void* x;                // (B, C, H, W)
  const void* offs[kMaxD];      // (B, 18 C, H, W) each: this launch's dilations
  const void* masks[kMaxD];     // (B, 9 C, H, W) each
  int dils[kMaxD];
  const float4* wf;             // G's B fragments (C, cols / 8, Kc / 8, 32)
  const void* gt;               // (B, Pp, cols) g transposed, zero past P and O
  void* d_off;                  // (D, B, 18 C, H, W): this launch's dilations
  void* d_mask;                 // (D, B, 9 C, H, W)
  float* pdx;                   // XS: (B C J, H W) partial planes
  long long* pdx64;             // not XS: (B C, H W) fixed-point planes, zeroed
  float* pw;                    // (B C J, D * 9 * cols) partial d W rows
  unsigned* stats;              // kStats words (fixed_shift), then B C plane flags
  int B, C, O, H, W, D, tiles, Pp, J, lbits;
  int cols, ks;                 // the product's columns; K steps an item (group_k(D) / 8)
  int gslots;                   // g tiles in shared memory: 2 (loaded an item ahead) or 1
  int wstage;                   // 1: W^T in shared memory with each plane; 0: read through L1
  int Dall;                     // the whole D (the mean's divisor)
  long long N;                  // items: B C tiles
};

// d += a b in split TF32: three passes, or two where a holds bf16 values
// (exact in TF32: their lo is zero)
template <typename T>
__device__ __forceinline__ void mma_split(float (&d)[4], const uint32_t (&ahi)[4],
                                          const uint32_t (&alo)[4], uint32_t bh0, uint32_t bh1,
                                          uint32_t bl0, uint32_t bl1) {
  if constexpr (sizeof(T) == 2) {
    otp_mma::mma_tf32(d, ahi, bl0, bl1);
    otp_mma::mma_tf32(d, ahi, bh0, bh1);
  } else {
    otp_mma::mma_3xtf32(d, ahi, alo, bh0, bh1, bl0, bl1);
  }
}

// the same product into two accumulators, the lo terms into dsm and hi hi
// into dbig, so that a k8 step's products wait on half as long a chain
template <typename T>
__device__ __forceinline__ void mma_split2(float (&dsm)[4], float (&dbig)[4],
                                           const uint32_t (&ahi)[4], const uint32_t (&alo)[4],
                                           uint32_t bh0, uint32_t bh1, uint32_t bl0,
                                           uint32_t bl1) {
  if constexpr (sizeof(T) != 2) otp_mma::mma_tf32(dsm, alo, bh0, bh1);
  otp_mma::mma_tf32(dsm, ahi, bl0, bl1);
  otp_mma::mma_tf32(dbig, ahi, bh0, bh1);
}

// a value of T as a TF32 operand, hi and lo (lo zero for bf16)
template <typename T>
__device__ __forceinline__ void tf32_of(T v, uint32_t& hi, uint32_t& lo) {
  if constexpr (sizeof(T) == 2) {
    hi = __float_as_uint(to_f<T>(v));
    lo = 0u;
  } else {
    otp_mma::split_tf32(to_f<T>(v), hi, lo);
  }
}

// Items are (plane q = b C + c, a tile u of 64 pixels), plane-major; a
// block takes an equal range of them.  An item is one ring slot: the 27
// offset and mask rows of each of its D dilations (and g's tile, with two g
// slots).  The warps first compute G[K, p] = (1/D) sum_o W[o, K] g[p, o]
// for its 9 D taps K (a product over O on the tensor cores) into shared
// memory; each thread then samples its tap (warp w: tap w % 9, pixels
// (w / 9) 32 + lane) at each dilation, writes d mask and d offset, adds d x
// to the fixed-point plane as the narrow kernel does, and keeps m s; then
// the warps add d W[o, K] += sum_p g[p, o] (m s)[K, p] (a product over the
// tile's pixels) into accumulators that stay in registers until the plane
// changes.  Three barriers an item: a ring stage a dilation, one sample a
// thread between barriers, measured 4.89 ms at O = 133, D = 5 in bf16 on
// the H100 (PERF.md).
template <typename T, bool Wide, bool XS>
__global__ void __launch_bounds__(kWideThreads, 1)
dcn_bwd_wide_kernel(const __grid_constant__ WBwdArgs a) {
  constexpr int NT = kWideThreads, M = kWideTile, S = kWideStages, LDM = kWideLdm;
  constexpr int E = 16 / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ const T* offs[kMaxD];
  __shared__ const T* masks[kMaxD];
  __shared__ int dils[kMaxD];
  const int H = a.H, W = a.W, P = H * W, C = a.C, dn = a.D, cols = a.cols, Kc = 8 * a.ks;
  const int RB = wide_ring_bytes<T>(dn);   // a ring slot: an item's rows
  const int ldg = wide_ldg<T>(cols);
  T* gsl = reinterpret_cast<T*>(smem + S * RB);
  const int gbytes = align16(a.gslots * M * ldg * (int)sizeof(T));
  float* Gs = reinterpret_cast<float*>(smem + S * RB + gbytes);   // (Kc, LDM)
  float* MSs = Gs + Kc * LDM;                                        // (Kc, LDM)
  float4* Wts = reinterpret_cast<float4*>(MSs + Kc * LDM);           // (cols / 8, ks, 32)
  const int wcount = cols / 8 * a.ks * 32;
  unsigned char* rest = reinterpret_cast<unsigned char*>(Wts + (a.wstage ? wcount : 0));
  const int ld = Plane<T>::ld(W);
  T* xs = reinterpret_cast<T*>(rest);
  unsigned* dlo =
      reinterpret_cast<unsigned*>(rest + align16(Plane<T>::elems(H, W) * (int)sizeof(T)));
  int* dhi = reinterpret_cast<int*>(dlo + P);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int d = 0; d < kMaxD; ++d) {
      offs[d] = static_cast<const T*>(a.offs[d]);
      masks[d] = static_cast<const T*>(a.masks[d]);
      dils[d] = a.dils[d];
    }
  }
  // m s's rows past 9 D stay 0 (the G products leave 0 there too)
  for (int e = threadIdx.x; e < Kc * LDM; e += NT) MSs[e] = 0.f;
  if constexpr (XS) {
    uint4* zx = reinterpret_cast<uint4*>(xs);
    for (int e = threadIdx.x; e < Plane<T>::elems(H, W) * (int)sizeof(T) / 16; e += NT)
      zx[e] = make_uint4(0, 0, 0, 0);
    for (int e = threadIdx.x; e < 2 * P; e += NT) dlo[e] = 0u;
  }
  __syncthreads();

  const long long n = a.tiles, G = gridDim.x, z = blockIdx.x;
  const long long s0 = z * a.N / G;
  const int items = (int)((z + 1) * a.N / G - s0);
  const T* xg = static_cast<const T*>(a.x);
  auto load_plane = [&](long long q) {
    const T* src = xg + (size_t)q * P;
    T* dst = xs + ld + Plane<T>::kLead;   // pixel (0, 0)
    if constexpr (Wide) {
      const int cpw = W / E;
      for (int e = threadIdx.x; e < H * cpw; e += NT) {
        const int y = e / cpw, c16 = e - y * cpw;
        cp_async16(dst + y * ld + c16 * E, src + y * W + c16 * E);
      }
    } else {
      for (int e = threadIdx.x; e < P; e += NT) dst[e / W * ld + e % W] = src[e];
    }
  };
  // channel c's G fragments (W^T) into Wts, with each plane (wstage)
  auto load_wt = [&](long long q) {
    const float4* src = a.wf + (size_t)(q % C) * wcount;
    for (int e = threadIdx.x; e < wcount; e += NT) cp_async16(Wts + e, src + e);
  };
  // g's tile of item j into its slot
  auto load_g = [&](int j) {
    const long long t = s0 + j, q = t / n;
    const int b = (int)(q / C), p0 = (int)(t - q * n) * M;
    const T* src = static_cast<const T*>(a.gt) + ((size_t)b * a.Pp + p0) * cols;
    T* dst = gsl + (j % a.gslots) * M * ldg;
    const int cpr = cols / E;   // chunks a row
    for (int e = threadIdx.x; e < M * cpr; e += NT) {
      const int r = e / cpr, c16 = e - r * cpr;
      cp_async16(dst + r * ldg + c16 * E, src + (size_t)r * cols + c16 * E);
    }
  };
  // item j into ring slot j % S: the 27 rows of each dilation (row dl 27 +
  // r) over its tile, and g's tile where two slots take it ahead
  auto load = [&](int j) {
    const long long t = s0 + j, q = t / n;
    const int p0 = (int)(t - q * n) * M;
    T* dst = reinterpret_cast<T*>(smem + (j % S) * RB);
    if constexpr (Wide) {
      constexpr int CPR = M / E;
      for (int e = threadIdx.x; e < dn * kRows * CPR; e += NT) {
        const int rr = e / CPR, c16 = e - rr * CPR, dl = rr / kRows, r = rr - dl * kRows;
        const T* src = (r < 18 ? offs[dl] + ((size_t)q * 18 + r) * P
                               : masks[dl] + ((size_t)q * 9 + r - 18) * P) + p0 + c16 * E;
        const bool in = p0 + c16 * E < P;
        cp_async16_zfill(dst + rr * M + c16 * E, in ? src : offs[dl], in ? 16 : 0);
      }
    } else {
      for (int e = threadIdx.x; e < dn * kRows * M; e += NT) {
        const int rr = e / M, c1 = e - rr * M, dl = rr / kRows, r = rr - dl * kRows;
        const T* src = r < 18 ? offs[dl] + ((size_t)q * 18 + r) * P
                              : masks[dl] + ((size_t)q * 9 + r - 18) * P;
        dst[e] = p0 + c1 < P ? src[p0 + c1] : from_f<T>(0.f);
      }
    }
    if (a.gslots == 2) load_g(j);
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, qd = lane & 3;
  const int k = warp % kTaps, pl = (warp / kTaps) * 32 + lane;   // the sampler's tap and pixel
  // d W: warp (mi, h) holds output tiles mi, mi + 9 and tap tiles h nh + [0, nh)
  const int nnt = a.ks, nh = (nnt + 1) / 2, mi = warp % 9, wh = warp / 9;
  float acc[kWideMW][kWideNW][4];
#pragma unroll
  for (int mm = 0; mm < kWideMW; ++mm)
#pragma unroll
    for (int jj = 0; jj < kWideNW; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mm][jj][e] = 0.f;
  // the d W accumulators into plane q's partial row (columns K < 9 D)
  auto flush_acc = [&](long long q) {
    const long long row = q * a.J + (z - seg_first(q, n, a.N, G));
    float* dst = a.pw + (size_t)row * dn * kTaps * cols;
#pragma unroll
    for (int mm = 0; mm < kWideMW; ++mm) {
      const int mo = (mi + 9 * mm) * 16;
#pragma unroll
      for (int jj = 0; jj < kWideNW; ++jj) {
        const int nt = wh * nh + jj;
        if (mo < cols && jj < nh && nt < nnt) {
          const int K = 8 * nt + 2 * qd, o = mo + g8;
          if (K < 9 * dn) {
            dst[(size_t)K * cols + o] = acc[mm][jj][0];
            dst[(size_t)K * cols + o + 8] = acc[mm][jj][2];
          }
          if (K + 1 < 9 * dn) {
            dst[(size_t)(K + 1) * cols + o] = acc[mm][jj][1];
            dst[(size_t)(K + 1) * cols + o + 8] = acc[mm][jj][3];
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mm][jj][e] = 0.f;
      }
    }
  };
  const int F = fixed_shift(a.stats, a.Dall, a.lbits);
  const float s1 = exp2f((float)(F / 2)), s2 = exp2f((float)(F - F / 2));
  // plane q's d x segment out as a partial f32 plane, the shared one zeroed
  auto write_segment = [&](long long q) {
    if constexpr (XS) {
      const double unscale = exp2(-(double)F);
      const long long row = q * a.J + (z - seg_first(q, n, a.N, G));
      float* dst = a.pdx + row * P;
      for (int e = threadIdx.x; e < P; e += NT) {
        const long long v = (long long)(((unsigned long long)(unsigned)dhi[e] << 32) | dlo[e]);
        dst[e] = (float)((double)v * unscale);
        dlo[e] = 0u;
        dhi[e] = 0;
      }
    }
  };

  long long q_cur = s0 / n;
  if constexpr (XS) load_plane(q_cur);
  if (a.wstage) load_wt(q_cur);
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < items) load(i);
    cp_async_commit();
  }
  const float Hf = (float)H, Wf = (float)W, inv_d = 1.f / (float)a.Dall;
  OTP_PHASE_START;
  for (int j = 0; j < items; ++j) {
    cp_async_wait<S - 2>();    // item j has landed (this thread's copies)
    __syncthreads();           // everyone's, and item j - 1 is done
    const long long t = s0 + j, q = t / n;
    const int u = (int)(t - q * n);
    if (q != q_cur) {   // a new plane: the last one's d W and d x out, its x and W^T in
      flush_acc(q_cur);
      write_segment(q_cur);
      q_cur = q;
      if constexpr (XS) load_plane(q);
      if (a.wstage) load_wt(q);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    if (j + S - 1 < items) load(j + S - 1);
    cp_async_commit();
    const int b = (int)(q / C), c = (int)(q - (long long)b * C);
    const T* gtile = gsl + (j % a.gslots) * M * ldg;
    if (a.gslots == 1) {   // g's one slot is free now: load and wait
      load_g(j);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    OTP_PHASE(0);

    // G = (g W) / D as 48 equal tasks of warps 0-15: (m16 tile of pixels,
    // n8 tile of taps, half of the k8 steps over the outputs up to O); the
    // first half's sums go to Gs, the second's to MSs (each sampler thread
    // reads both of its own entry before it writes m s there; the rows past
    // 9 D get 0, W^T being zero there), so no warp holds two whole tiles
    if (warp < 16) {
      const int ksteps = (a.O + 7) / 8, half = (ksteps + 1) / 2;
      // from W^T in shared memory or through L1: each loop knows its space
      auto gprod = [&](const float4* wf) {
#pragma unroll 1
        for (int task = warp; task < 48; task += 16) {
          const int tile = task % 24, h = task / 24, m0 = (tile & 3) * 16, nt = tile >> 2;
          if (nt >= nnt) continue;
          float gsm[4] = {0.f, 0.f, 0.f, 0.f}, gbig[4] = {0.f, 0.f, 0.f, 0.f};
          const int s1 = h ? ksteps : half;
#pragma unroll 1
          for (int s = h * half; s < s1; ++s) {
            uint32_t ahi[4], alo[4];
            const T* ap = gtile + (m0 + g8) * ldg + 8 * s + qd;
            tf32_of<T>(ap[0], ahi[0], alo[0]);               // A[g][q]
            tf32_of<T>(ap[8 * ldg], ahi[1], alo[1]);         // A[g + 8][q]
            tf32_of<T>(ap[4], ahi[2], alo[2]);               // A[g][q + 4]
            tf32_of<T>(ap[8 * ldg + 4], ahi[3], alo[3]);     // A[g + 8][q + 4]
            const float4 bq = wf[(s * nnt + nt) * 32];
            mma_split2<T>(gsm, gbig, ahi, alo, __float_as_uint(bq.x), __float_as_uint(bq.y),
                          __float_as_uint(bq.z), __float_as_uint(bq.w));
          }
          // C fragment: pixel rows g, g + 8; taps 2 q, 2 q + 1
          float* gp = (h ? MSs : Gs) + (8 * nt + 2 * qd) * LDM + m0 + g8;
          gp[0] = gsm[0] + gbig[0];
          gp[LDM] = gsm[1] + gbig[1];
          gp[8] = gsm[2] + gbig[2];
          gp[LDM + 8] = gsm[3] + gbig[3];
        }
      };
      if (a.wstage) gprod(Wts + lane);
      else gprod(a.wf + (size_t)c * wcount + lane);
    }
    __syncthreads();
    OTP_PHASE(1);

    // the samples of (tap k, pixel pl) at each dilation, as the narrow kernel
    const int p = u * M + pl;
    const T* slot = reinterpret_cast<const T*>(smem + (j % S) * RB);
    bool bad = false;   // a non-finite contribution
    // unrolled, so that a thread's samples at the item's dilations overlap
#pragma unroll
    for (int dl = 0; dl < kWideMaxD; ++dl) {
      if (dl >= dn) break;
      const int dil = dils[dl], K = dl * kTaps + k;
      float ms = 0.f;
      if (p < P) {
        const T* so = slot + dl * kRows * M;
        const float oy = to_f<T>(so[(2 * k) * M + pl]);
        const float ox = to_f<T>(so[(2 * k + 1) * M + pl]);
        float m = to_f<T>(so[(18 + k) * M + pl]);
        const int py = p / W, px = p - py * W;
        const float ty = (float)((k / 3 - 1) * dil), tx = (float)((k % 3 - 1) * dil);
        float sy = __fadd_rn(__fadd_rn((float)py, ty), oy);
        float sx = __fadd_rn(__fadd_rn((float)px, tx), ox);
        const bool valid = sy > -1.f && sy < Hf && sx > -1.f && sx < Wf;   // false for NaN
        if (!valid) sy = sx = m = 0.f;
        const int y0 = __float2int_rd(sy), x0 = __float2int_rd(sx);
        float v00, v01, v10, v11;
        if constexpr (XS) {
          const T* c0 = xs + ld + Plane<T>::kLead + y0 * ld + x0;
          v00 = to_f<T>(c0[0]);
          v01 = to_f<T>(c0[1]);
          v10 = to_f<T>(c0[ld]);
          v11 = to_f<T>(c0[ld + 1]);
        } else {
          const T* img = xg + (size_t)q * P;
          const bool ky0 = y0 >= 0, ky1 = y0 + 1 < H, kx0 = x0 >= 0, kx1 = x0 + 1 < W;
          const T* r0 = img + max(y0, 0) * W;
          const T* r1 = img + min(y0 + 1, H - 1) * W;
          const int c0 = max(x0, 0), c1 = min(x0 + 1, W - 1);
          v00 = ky0 && kx0 ? to_f<T>(__ldg(r0 + c0)) : 0.f;
          v01 = ky0 && kx1 ? to_f<T>(__ldg(r0 + c1)) : 0.f;
          v10 = ky1 && kx0 ? to_f<T>(__ldg(r1 + c0)) : 0.f;
          v11 = ky1 && kx1 ? to_f<T>(__ldg(r1 + c1)) : 0.f;
        }
        const float ly = __fsub_rn(sy, (float)y0), lx = __fsub_rn(sx, (float)x0);
        const float hy = __fsub_rn(1.f, ly), hx = __fsub_rn(1.f, lx);
        float s = __fmul_rn(__fmul_rn(hy, hx), v00);
        s = __fadd_rn(s, __fmul_rn(__fmul_rn(hy, lx), v01));
        s = __fadd_rn(s, __fmul_rn(__fmul_rn(ly, hx), v10));
        s = __fadd_rn(s, __fmul_rn(__fmul_rn(ly, lx), v11));
        float dsy = hx * (v10 - v00) + lx * (v11 - v01);
        float dsx = hy * (v01 - v00) + ly * (v11 - v10);
        if (!valid) s = dsy = dsx = 0.f;
        const float Gv = (Gs[K * LDM + pl] + MSs[K * LDM + pl]) * inv_d;
        const float gm = Gv * m;
        if (valid) {
          bad |= !isfinite(gm);
          const bool ky0 = y0 >= 0, ky1 = y0 + 1 < H, kx0 = x0 >= 0, kx1 = x0 + 1 < W;
          const int e0 = y0 * W + x0;
          long long* dimg = a.pdx64 + (size_t)q * P;
          auto add = [&](bool in, int e, float cv) {
            if (!in) return;
            const long long v = __float2ll_rn(cv * s1 * s2);
            if constexpr (XS) {
              const unsigned lo = (unsigned)v, old = atomicAdd(dlo + e, lo);
              atomicAdd(dhi + e, (int)(v >> 32) + (int)(old + lo < old));
            } else {
              atomicAdd(reinterpret_cast<unsigned long long*>(dimg + e), (unsigned long long)v);
            }
          };
          add(ky0 && kx0, e0, gm * hy * hx);
          add(ky0 && kx1, e0 + 1, gm * hy * lx);
          add(ky1 && kx0, e0 + W, gm * ly * hx);
          add(ky1 && kx1, e0 + W + 1, gm * ly * lx);
        }
        T* dob = static_cast<T*>(a.d_off) + (((size_t)dl * a.B + b) * 18 * C + 18 * c + 2 * k) * P;
        T* dmb = static_cast<T*>(a.d_mask) + (((size_t)dl * a.B + b) * 9 * C + 9 * c + k) * P;
        dmb[p] = from_f<T>(Gv * s);
        dob[p] = from_f<T>(Gv * m * dsy);
        dob[(size_t)P + p] = from_f<T>(Gv * m * dsx);
        ms = m * s;
      }
      MSs[K * LDM + pl] = ms;
    }
    if (bad) atomicOr(a.stats + kStats + q, 1u);
    __syncthreads();   // the item's m s is whole
    OTP_PHASE(2);

    // d W[o, K] += sum_p g[p, o] (m s)[K, p]: A = g^T (outputs x pixels),
    // B = m s (pixels x taps), K of the product the tile's 64 pixels
#pragma unroll 1
    for (int s = 0; s < M / 8; ++s) {
      uint32_t bh[kWideNW][2], bl[kWideNW][2];
#pragma unroll
      for (int jj = 0; jj < kWideNW; ++jj) {
        const int nt = wh * nh + jj;
        if (jj < nh && nt < nnt) {
          const float* bp = MSs + (8 * nt + g8) * LDM + 8 * s + qd;
          otp_mma::split_tf32(bp[0], bh[jj][0], bl[jj][0]);   // B[q][g]
          otp_mma::split_tf32(bp[4], bh[jj][1], bl[jj][1]);   // B[q + 4][g]
        }
      }
#pragma unroll
      for (int mm = 0; mm < kWideMW; ++mm) {
        const int mo = (mi + 9 * mm) * 16;
        if (mo < cols) {
          uint32_t ahi[4], alo[4];
          const T* ap = gtile + (8 * s + qd) * ldg + mo + g8;
          tf32_of<T>(ap[0], ahi[0], alo[0]);               // A[g][q] = g[p = q][o = g]
          tf32_of<T>(ap[8], ahi[1], alo[1]);               // A[g + 8][q]
          tf32_of<T>(ap[4 * ldg], ahi[2], alo[2]);         // A[g][q + 4]
          tf32_of<T>(ap[4 * ldg + 8], ahi[3], alo[3]);     // A[g + 8][q + 4]
#pragma unroll
          for (int jj = 0; jj < kWideNW; ++jj)
            if (jj < nh && wh * nh + jj < nnt)
              mma_split<T>(acc[mm][jj], ahi, alo, bh[jj][0], bh[jj][1], bl[jj][0], bl[jj][1]);
        }
      }
    }
    OTP_PHASE(3);
  }
  flush_acc(q_cur);
  __syncthreads();
  write_segment(q_cur);
  OTP_PHASE(4);
}

// ---------------------------------------------------------------------------
// The host side: plans, scratch and launches of both paths
// ---------------------------------------------------------------------------

// One launch's grid and shared memory: a group of D dilations at OP
// outputs (narrow) or `cols` product columns (wide)
struct Plan {
  int G, J, xs, tiles, Pp, nb, smem, lbits, gslots, wstage, ks;
  long long N;
};

// f(kernel) on the narrow kernel's instantiation for (wide, OP, xs)
template <typename T, bool Wide, bool XS, typename F>
cudaError_t with_op(int OP, F f) {
  switch (OP) {
    case 8: return f(dcn_bwd_kernel<T, Wide, 2, XS>);
    case 20: return f(dcn_bwd_kernel<T, Wide, 5, XS>);
    case 32: return f(dcn_bwd_kernel<T, Wide, 8, XS>);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename F>
cudaError_t with_narrow(bool wide, bool xs, int OP, F f) {
  if (wide) return xs ? with_op<T, true, true>(OP, f) : with_op<T, true, false>(OP, f);
  return xs ? with_op<T, false, true>(OP, f) : with_op<T, false, false>(OP, f);
}

template <typename T, typename F>
cudaError_t with_wide(bool wide, bool xs, F f) {
  if (wide) return xs ? f(dcn_bwd_wide_kernel<T, true, true>)
                      : f(dcn_bwd_wide_kernel<T, true, false>);
  return xs ? f(dcn_bwd_wide_kernel<T, false, true>) : f(dcn_bwd_wide_kernel<T, false, false>);
}

// f(kernel) on the main kernel for (wide, xs, OP): the wide one past 32
template <typename T, typename F>
cudaError_t with_kernel(bool wide, bool xs, int OP, F f) {
  return OP > kMaxO ? with_wide<T>(wide, xs, f) : with_narrow<T>(wide, xs, OP, f);
}

template <typename T>
int opg_of(int OP) {
  return OP == 8 ? gld<T, 8>() : OP == 20 ? gld<T, 20>() : gld<T, 32>();
}

// dilations a launch: kMaxD (narrow), kWideMaxD (wide); group j's count
__host__ inline int group_max(int OP) { return OP > kMaxO ? kWideMaxD : kMaxD; }
__host__ inline int group_dn(int j, int D, int gmax) {
  return D - j * gmax < gmax ? D - j * gmax : gmax;
}

// The plan of one launch over D of the call's Dall dilations: at OP <= 32
// outputs the narrow kernel, past them the wide one at `cols` columns
template <typename T>
cudaError_t make_plan(int B, int C, int OP, int cols, int H, int W, int D, int Dall, bool wide,
                      Plan& pl) {
  const bool wd = OP > kMaxO;
  const int TS = wd ? kWideTile : Cfg<T>::tile, NT = wd ? kWideThreads : threads<T>();
  const int P = H * W;
  pl.ks = otp_dcn::group_k(D) / 8;
  auto smem_of = [&](bool xs, int gslots, bool wstage) {
    const int planes = xs ? align16(Plane<T>::elems(H, W) * (int)sizeof(T)) + 2 * P * 4 : 0;
    if (wd)
      return kWideStages * wide_ring_bytes<T>(D) +
             align16(gslots * TS * wide_ldg<T>(cols) * (int)sizeof(T)) +
             2 * 8 * pl.ks * kWideLdm * 4 + (wstage ? cols / 8 * pl.ks * 32 * 16 : 0) + planes;
    return kStages * (kRows + opg_of<T>(OP)) * TS * (int)sizeof(T) + planes +
           Cfg<T>::wpt * D * kTaps * OP * 4;
  };
  // shared memory, wide: the x and d x planes first, then g's second slot,
  // then W^T (else read through L1)
  pl.xs = smem_of(true, 1, false) <= kSmemLimit;
  pl.gslots = wd && smem_of(pl.xs, 2, false) <= kSmemLimit ? 2 : 1;
  pl.wstage = wd && smem_of(pl.xs, pl.gslots, true) <= kSmemLimit;
  pl.smem = smem_of(pl.xs, pl.gslots, pl.wstage);
  if (pl.smem > kSmemLimit) return cudaErrorInvalidValue;
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = with_kernel<T>(wide, pl.xs, OP, [&](auto kern) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         pl.smem);
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, NT, pl.smem);
  });
  if (err != cudaSuccess) return err;
  if (occ < 1) return cudaErrorInvalidConfiguration;
  pl.tiles = (P + TS - 1) / TS;
  pl.Pp = pl.tiles * TS;
  pl.nb = (pl.Pp + kPrepThreads - 1) / kPrepThreads;
  // stages a plane: D tiles (narrow); items a plane: its tiles (wide)
  const long long n = wd ? pl.tiles : (long long)D * pl.tiles;
  pl.N = (long long)B * C * n;
  pl.G = (int)(pl.N < (long long)sms * occ ? pl.N : (long long)sms * occ);
  pl.lbits = 0;
  while ((1LL << pl.lbits) < (long long)kTaps * Dall * P) ++pl.lbits;
  pl.J = otp_dcn::seg_rows((long long)B * C, n, pl.G);
  return cudaSuccess;
}

// Where the scratch buffer's pieces lie: g transposed and its tile sums,
// the stats words, d x's f32 sum (more than one dilation group), and each
// dilation group's partial d W rows and d x planes (and, wide, G's weight
// fragments)
struct Layout {
  std::vector<Plan> plans;   // a dilation group each
  size_t gt, bpart, stats, dxacc, bytes;
  std::vector<size_t> pw, pdx, frag;
  int nd, cols;
};

template <typename T>
cudaError_t make_layout(int B, int C, int O, int OP, int H, int W, int D, bool wide, Layout& L) {
  const bool wd = OP > kMaxO;
  const size_t P = (size_t)H * W;
  const int gmax = group_max(OP);
  L.nd = (D + gmax - 1) / gmax;
  L.cols = wd ? otp_dcn::product_cols(O) : opg_of<T>(OP);   // g's transposed rows
  L.plans.resize(L.nd);
  for (int j = 0; j < L.nd; ++j) {
    cudaError_t err = make_plan<T>(B, C, OP, L.cols, H, W, group_dn(j, D, gmax), D, wide,
                                   L.plans[j]);
    if (err != cudaSuccess) return err;
  }
  size_t at = 0;
  auto piece = [&](size_t bytes) {
    const size_t here = at;
    at += (bytes + 255) / 256 * 256;
    return here;
  };
  const Plan& p0 = L.plans[0];
  L.gt = piece((size_t)B * p0.Pp * L.cols * sizeof(T));
  L.bpart = piece((size_t)B * p0.nb * O * 4);
  L.stats = piece((size_t)(kStats + B * C) * 4);
  L.dxacc = piece(L.nd > 1 ? (size_t)B * C * P * 4 : 0);
  L.pw.resize(L.nd);
  L.pdx.resize(L.nd);
  L.frag.resize(L.nd);
  for (int j = 0; j < L.nd; ++j) {
    const Plan& pl = L.plans[j];
    const int dn = group_dn(j, D, gmax), rowlen = wd ? L.cols : OP;
    L.pw[j] = piece((size_t)B * C * pl.J * dn * kTaps * rowlen * 4);
    L.pdx[j] = piece((size_t)B * C * P * (pl.xs ? pl.J * 4 : 8));
    L.frag[j] = piece(wd ? (size_t)C * L.cols * 8 * pl.ks * 8 : 0);
  }
  L.bytes = at;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* x, const void* const* offs, const void* const* masks,
                   const int* dils, const float* w, const void* g, void* d_off, void* d_mask,
                   void* dx, void* scratch, float* dw, float* dbias, int B, int C, int O, int OP,
                   int H, int W, int D, bool wide, cudaStream_t st) {
  Layout L;
  cudaError_t err = make_layout<T>(B, C, O, OP, H, W, D, wide, L);
  if (err != cudaSuccess) return err;
  const bool wd = OP > kMaxO;
  const int P = H * W, cols = L.cols, gmax = group_max(OP);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  unsigned* stats = reinterpret_cast<unsigned*>(base + L.stats);
  err = cudaMemsetAsync(stats, 0, (size_t)(kStats + B * C) * 4, st);
  for (int j = 0; j < L.nd && err == cudaSuccess; ++j)
    if (!L.plans[j].xs) err = cudaMemsetAsync(base + L.pdx[j], 0, (size_t)B * C * P * 8, st);
  if (err != cudaSuccess) return err;
  // g transposed and its tile sums; the bound's largest sum_o |W| over the
  // pack's whole rows
  const int nb = L.plans[0].nb, Pp = L.plans[0].Pp;
  const dim3 pgrid(nb, B);
  T* gt = reinterpret_cast<T*>(base + L.gt);
  float* bpart = reinterpret_cast<float*>(base + L.bpart);
  dcn_bwd_prep_kernel<T><<<pgrid, kPrepThreads, 0, st>>>(
      static_cast<const T*>(g), gt, bpart, w, stats, O, cols, P, Pp, D * C * kTaps, OP);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long nm = (long long)B * 9 * C * P;
  const long long mblocks = (nm + kReduceThreads * 8 - 1) / (kReduceThreads * 8);
  for (int j = 0; j < L.nd; ++j) {
    MaskPtrs mp{};
    const int dn = group_dn(j, D, gmax);
    for (int d = 0; d < dn; ++d) mp.m[d] = masks[j * gmax + d];
    dcn_bwd_mmax_kernel<T><<<dim3((unsigned)(mblocks < 1024 ? mblocks : 1024), dn),
                             kReduceThreads, 0, st>>>(mp, nm, stats);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  for (int j = 0; j < L.nd; ++j) {
    const Plan& pl = L.plans[j];
    const int d0 = j * gmax, dn = group_dn(j, D, gmax);
    const long long n = wd ? pl.tiles : (long long)dn * pl.tiles, total = (long long)B * C * P;
    T* doff = static_cast<T*>(d_off) + (size_t)d0 * B * 18 * C * P;
    T* dmask = static_cast<T*>(d_mask) + (size_t)d0 * B * 9 * C * P;
    float* pdx = reinterpret_cast<float*>(base + L.pdx[j]);
    long long* pdx64 = reinterpret_cast<long long*>(base + L.pdx[j]);
    float* pw = reinterpret_cast<float*>(base + L.pw[j]);
    if (wd) {
      float4* frag = reinterpret_cast<float4*>(base + L.frag[j]);
      err = otp_dcn::wide_wfrag(w, frag, C, OP, O, d0, dn, cols / 8, pl.ks, st);
      if (err != cudaSuccess) return err;
      WBwdArgs a{};
      a.x = x;
      for (int d = 0; d < dn; ++d) {
        a.offs[d] = offs[d0 + d];
        a.masks[d] = masks[d0 + d];
        a.dils[d] = dils[d0 + d];
      }
      a.wf = frag, a.gt = gt, a.d_off = doff, a.d_mask = dmask;
      a.pdx = pdx, a.pdx64 = pdx64, a.pw = pw, a.stats = stats;
      a.B = B, a.C = C, a.O = O, a.H = H, a.W = W, a.D = dn, a.tiles = pl.tiles, a.Pp = pl.Pp;
      a.J = pl.J, a.lbits = pl.lbits, a.cols = cols, a.ks = pl.ks, a.gslots = pl.gslots;
      a.wstage = pl.wstage;
      a.Dall = D, a.N = pl.N;
      err = with_wide<T>(wide, pl.xs, [&](auto kern) {
        cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             pl.smem);
        if (e != cudaSuccess) return e;
        kern<<<pl.G, kWideThreads, pl.smem, st>>>(a);
        return cudaGetLastError();
      });
    } else {
      BwdArgs a{};
      a.x = x;
      for (int d = 0; d < dn; ++d) {
        a.offs[d] = offs[d0 + d];
        a.masks[d] = masks[d0 + d];
        a.dils[d] = dils[d0 + d];
      }
      a.w = w + (size_t)d0 * C * kTaps * OP;
      a.gt = gt, a.d_off = doff, a.d_mask = dmask;
      a.pdx = pdx, a.pdx64 = pdx64, a.pw = pw, a.stats = stats;
      a.B = B, a.C = C, a.O = O, a.H = H, a.W = W, a.D = dn;
      a.tiles = pl.tiles, a.Pp = pl.Pp, a.J = pl.J, a.N = pl.N, a.lbits = pl.lbits, a.Dall = D;
      err = with_narrow<T>(wide, pl.xs, OP, [&](auto kern) {
        cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             pl.smem);
        if (e != cudaSuccess) return e;
        kern<<<pl.G, threads<T>(), pl.smem, st>>>(a);
        return cudaGetLastError();
      });
    }
    if (err != cudaSuccess) return err;
    const int amode = L.nd == 1 ? 0 : j == 0 ? 1 : j == L.nd - 1 ? 3 : 2;
    dcn_bwd_dx_kernel<T><<<(unsigned)((total + kReduceThreads - 1) / kReduceThreads),
                           kReduceThreads, 0, st>>>(
        pdx, pdx64, stats, static_cast<T*>(dx), reinterpret_cast<float*>(base + L.dxacc), total,
        P, pl.J, n, pl.N, pl.G, pl.xs, D, pl.lbits, amode);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int outs = dn * O * C * kTaps + O;
    dcn_bwd_w_kernel<<<(outs + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0, st>>>(
        pw, bpart, dw, dbias, B, C, O, wd ? cols : OP, dn, pl.J, n, pl.N, pl.G, B * nb, d0, 0, O,
        D);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// OP: 8, 20 or 32 (the narrow kernel), or a multiple of 32 above 32 whose
// product columns (O rounded up to 16) the wide kernel's accumulators hold
bool bad_shape(int B, int C, int O, int OP, int H, int W, int D) {
  const bool op_ok = OP == 8 || OP == 20 || OP == 32 ||
                     (OP > 32 && OP % 32 == 0 && otp_dcn::product_cols(O) <= kWideMaxCols);
  return D < 1 || B < 1 || C < 1 || H < 1 || W < 1 || O < 1 || O > OP || !op_ok || B > 65535;
}

}  // namespace

// The most outputs a backward call takes (the wide kernel's d W accumulators),
// and the wide kernel's dilations a launch
extern "C" int otp_deform_bwd_max_outputs() { return kWideMaxCols; }
extern "C" int otp_deform_bwd_wide_dilations() { return kWideMaxD; }

// Bytes of scratch that otp_deform_bwd needs for these shapes, or -1 for
// shapes it does not take (and -2 - the CUDA error where one occurred).
extern "C" long long otp_deform_bwd_scratch(int B, int C, int O, int OP, int H, int W, int D,
                                            int wide, int dtype) {
  if (bad_shape(B, C, O, OP, H, W, D)) return -1;
  Layout L;
  cudaError_t err = cudaErrorInvalidValue;
  OTP_DISPATCH(dtype, { err = make_layout<T>(B, C, O, OP, H, W, D, wide != 0, L); });
  return err == cudaSuccess ? (long long)L.bytes : -2 - (long long)err;
}

// x: (B, C, H, W); offs[d]: (B, 18 C, H, W); masks[d]: (B, 9 C, H, W); g:
// (B, O, H, W), all in the compute dtype and contiguous (`wide`: 16-byte
// aligned, W a multiple of 16 bytes); w: (D, C, 9, OP) f32 (the forward's
// pack: OP 8, 20 or 32, or a multiple of 32 above 32).  Writes d_off (D, B,
// 18 C, H, W), d_mask (D, B, 9 C, H, W) and dx (B, C, H, W) in the compute
// dtype, dw (D, O, C, 3, 3) and dbias (D, O) in f32; scratch:
// otp_deform_bwd_scratch(...) bytes, 256-byte aligned.
extern "C" int otp_deform_bwd(const void* x, const void* const* offs, const void* const* masks,
                              const int* dils, const void* w, const void* g, void* d_off,
                              void* d_mask, void* dx, void* scratch, void* dw, void* dbias,
                              int B, int C, int O, int OP, int H, int W, int D, int wide,
                              int dtype, void* stream) {
  if (bad_shape(B, C, O, OP, H, W, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  OTP_DISPATCH(dtype, {
    return (int)launch<T>(x, offs, masks, dils, (const float*)w, g, d_off, d_mask, dx, scratch,
                          (float*)dw, (float*)dbias, B, C, O, OP, H, W, D, wide != 0, st);
  });
  return (int)cudaErrorInvalidValue;
}
