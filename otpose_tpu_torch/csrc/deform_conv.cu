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
// - Any O and any D, by groups of launches (otp_deform): O above 32 is
//   padded to a multiple of 32 and each group of 32 outputs is a launch at
//   OP = 32 over the same x, reading its columns of the weights (row
//   stride `ldw`) and writing its rows of the output (`ldo` rows an item);
//   D above kMaxD is cut into groups of kMaxD dilations, each a launch that
//   writes its f32 partial sums into slots of its own, and the reduction
//   kernel adds every slot in a fixed order, divides by the whole D and adds
//   the mean bias once.  O <= 32 and D <= kMaxD is one launch, as before.
// - The D pointers and dilations arrive in a __grid_constant__ struct and are
//   copied to shared memory with compile-time indices, so no pointer table
//   lives in local memory (no stack frame).
#include "common.cuh"
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
