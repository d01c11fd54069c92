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
// scan body :221-246) with jax.grad; there is no Pallas kernel for it.
//
// What bounds it on the H100: device memory.  The offsets and masks are read
// once and their gradients written once: 27 values a (dilation, channel,
// pixel) each way, 2 x 254 MB in bf16 at the flagship shape (B = 8,
// C = O = 17, 96x72, five dilations), 0.152 ms at 3.35 TB/s; x, g and d x add
// 1%.  The arithmetic (O FMAs for G and ~40 more a sample) is 0.03 ms at the
// f32 rate.
//
// Design (a first, simple kernel; no TMA, wgmma or pipeline):
// - One thread a pixel; a block owns 256 pixels of one (item, channel) and
//   loops over the D*9 (dilation, tap) stages.  Reads of offsets and masks
//   and writes of their gradients are coalesced along the pixels.
// - g's O rows of the tile and the channel's (D, 9, OP) weights sit in
//   shared memory; G is O FMAs from there.
// - d offset and d mask have one writer each.  d x goes to an f32 buffer by
//   atomicAdd (its sums' order, and so its last bits, may vary from run to
//   run).  x's corners are read through L1.
// - d W: each thread keeps m * s of its pixel for every stage in shared
//   memory; after the loop the block contracts them with g's tile (a fixed
//   order over its 256 pixels) into one partial row a block, and a second
//   kernel adds the blocks' rows in a fixed order, so d W and d bias are
//   the same bits from run to run.
#include "common.cuh"

namespace {

constexpr int kMaxD = 8;
constexpr int kMaxO = 32;
constexpr int kThreads = 256;          // pixels a block
constexpr int kGld = kThreads + 1;     // g rows padded against bank conflicts
constexpr int kReduceThreads = 256;

struct BwdArgs {
  const void* x;                // (B, C, H, W)
  const void* offs[kMaxD];      // (B, 18 C, H, W) each
  const void* masks[kMaxD];     // (B, 9 C, H, W) each
  int dils[kMaxD];
  const float* w;               // (D, C, 9, OP) f32, zero past O
  const void* g;                // (B, O, H, W)
  void* d_off;                  // (D, B, 18 C, H, W)
  void* d_mask;                 // (D, B, 9 C, H, W)
  float* dx;                    // (B, C, H, W) f32, zeroed by the caller
  float* partial;               // (B * tiles, C, D * 9 + 1, O) f32
  int B, C, O, OP, H, W, D, tiles;
};

__host__ __device__ inline int smem_floats(int O, int OP, int D) {
  return O * kGld + D * 9 * OP + D * 9 * kThreads;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dcn_bwd_kernel(const __grid_constant__ BwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  __shared__ const T* offs[kMaxD];
  __shared__ const T* masks[kMaxD];
  __shared__ int dils[kMaxD];
  const int H = a.H, W = a.W, P = H * W, C = a.C, O = a.O, OP = a.OP, D = a.D, B = a.B;
  const int tile = blockIdx.x, c = blockIdx.y, b = blockIdx.z, t = threadIdx.x;
  const int p = tile * kThreads + t;
  const bool in = p < P;
  float* gs = sm;                       // [O][kGld]
  float* ws = gs + O * kGld;            // [D * 9][OP]
  float* ms = ws + D * 9 * OP;          // [D * 9][kThreads]
  if (t == 0) {
#pragma unroll
    for (int d = 0; d < kMaxD; ++d) {
      offs[d] = static_cast<const T*>(a.offs[d]);
      masks[d] = static_cast<const T*>(a.masks[d]);
      dils[d] = a.dils[d];
    }
  }
  const T* gb = static_cast<const T*>(a.g) + (size_t)b * O * P;
  for (int o = 0; o < O; ++o) gs[o * kGld + t] = in ? to_f<T>(gb[(size_t)o * P + p]) : 0.f;
  for (int e = t; e < D * 9 * OP; e += kThreads) {
    const int d = e / (9 * OP), r = e - d * 9 * OP;
    ws[e] = a.w[((size_t)d * C + c) * 9 * OP + r];
  }
  __syncthreads();

  const float py = in ? (float)(p / W) : 0.f, px = in ? (float)(p % W) : 0.f;
  const float Hf = (float)H, Wf = (float)W, inv_d = 1.f / (float)D;
  const size_t bc = (size_t)b * C + c;
  const T* xc = static_cast<const T*>(a.x) + bc * P;
  float* dxc = a.dx + bc * P;
  for (int d = 0; d < D; ++d) {
    const int dil = dils[d];
    const T* ob = offs[d] + bc * 18 * P + p;
    const T* mb = masks[d] + bc * 9 * P + p;
    T* dob = static_cast<T*>(a.d_off) + ((size_t)d * B * C + bc) * 18 * P + p;
    T* dmb = static_cast<T*>(a.d_mask) + ((size_t)d * B * C + bc) * 9 * P + p;
    for (int k = 0; k < 9; ++k) {
      const float* wk = ws + (d * 9 + k) * OP;
      float G = 0.f;
      for (int o = 0; o < O; ++o) G = fmaf(wk[o], gs[o * kGld + t], G);
      G *= inv_d;
      float oy = 0.f, ox = 0.f, m = 0.f;
      if (in) {
        oy = to_f<T>(ob[(size_t)(2 * k) * P]);
        ox = to_f<T>(ob[(size_t)(2 * k + 1) * P]);
        m = to_f<T>(mb[(size_t)k * P]);
      }
      // the forward's position: (pixel + tap) + offset
      const float sy = __fadd_rn(__fadd_rn(py, (float)((k / 3 - 1) * dil)), oy);
      const float sx = __fadd_rn(__fadd_rn(px, (float)((k % 3 - 1) * dil)), ox);
      float s = 0.f, dsy = 0.f, dsx = 0.f;
      if (in && sy > -1.f && sy < Hf && sx > -1.f && sx < Wf) {
        const int y0 = __float2int_rd(sy), x0 = __float2int_rd(sx);
        const float ly = __fsub_rn(sy, (float)y0), lx = __fsub_rn(sx, (float)x0);
        const float hy = __fsub_rn(1.f, ly), hx = __fsub_rn(1.f, lx);
        const bool ky0 = y0 >= 0, ky1 = y0 + 1 < H, kx0 = x0 >= 0, kx1 = x0 + 1 < W;
        const int i00 = y0 * W + x0;
        const float v00 = ky0 && kx0 ? to_f<T>(xc[i00]) : 0.f;
        const float v01 = ky0 && kx1 ? to_f<T>(xc[i00 + 1]) : 0.f;
        const float v10 = ky1 && kx0 ? to_f<T>(xc[i00 + W]) : 0.f;
        const float v11 = ky1 && kx1 ? to_f<T>(xc[i00 + W + 1]) : 0.f;
        s = __fmul_rn(__fmul_rn(hy, hx), v00);
        s = __fadd_rn(s, __fmul_rn(__fmul_rn(hy, lx), v01));
        s = __fadd_rn(s, __fmul_rn(__fmul_rn(ly, hx), v10));
        s = __fadd_rn(s, __fmul_rn(__fmul_rn(ly, lx), v11));
        dsy = hx * (v10 - v00) + lx * (v11 - v01);
        dsx = hy * (v01 - v00) + ly * (v11 - v10);
        const float gm = G * m;
        if (ky0 && kx0) atomicAdd(dxc + i00, gm * hy * hx);
        if (ky0 && kx1) atomicAdd(dxc + i00 + 1, gm * hy * lx);
        if (ky1 && kx0) atomicAdd(dxc + i00 + W, gm * ly * hx);
        if (ky1 && kx1) atomicAdd(dxc + i00 + W + 1, gm * ly * lx);
      } else {
        m = 0.f;
      }
      if (in) {
        dmb[(size_t)k * P] = from_f<T>(G * s);
        dob[(size_t)(2 * k) * P] = from_f<T>(G * m * dsy);
        dob[(size_t)(2 * k + 1) * P] = from_f<T>(G * m * dsx);
      }
      ms[(d * 9 + k) * kThreads + t] = m * s;
    }
  }
  __syncthreads();

  // the block's row of d W sums (stage, o) and of d bias sums (o), each
  // over the tile's pixels in order
  const int R = D * 9 + 1;
  float* row = a.partial + (((size_t)b * a.tiles + tile) * C + c) * R * O;
  for (int e = t; e < R * O; e += kThreads) {
    const int r = e / O, o = e - r * O;
    const float* gr = gs + o * kGld;
    float acc = 0.f;
    if (r < D * 9) {
      const float* mr = ms + r * kThreads;
      for (int q = 0; q < kThreads; ++q) acc = fmaf(mr[q], gr[q], acc);
    } else {
      for (int q = 0; q < kThreads; ++q) acc += gr[q];
    }
    row[e] = acc;
  }
}

// d W (D, O, C, 3, 3) and d bias (D, O), f32: the blocks' rows added in a
// fixed order, over D
__global__ void __launch_bounds__(kReduceThreads)
dcn_bwd_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                      float* __restrict__ dbias, int n, int C, int O, int D) {
  const int R = D * 9 + 1;
  const int i = blockIdx.x * kReduceThreads + threadIdx.x;
  const int nw = D * O * C * 9;
  if (i >= nw + O) return;
  int c = 0, r, o;
  if (i < nw) {   // i = ((d * O + o) * C + c) * 9 + k
    const int k = i % 9, dc = i / 9;
    c = dc % C;
    const int dO = dc / C;
    o = dO % O;
    r = (dO / O) * 9 + k;
  } else {
    o = i - nw;
    r = D * 9;
  }
  float s = 0.f;
  for (int j = 0; j < n; ++j) s += partial[(((size_t)j * C + c) * R + r) * O + o];
  s /= (float)D;
  if (i < nw) {
    dw[i] = s;
  } else {
    for (int d = 0; d < D; ++d) dbias[d * O + o] = s;
  }
}

template <typename T>
cudaError_t launch(const BwdArgs& a, float* dw, float* dbias, cudaStream_t st) {
  const int smem = smem_floats(a.O, a.OP, a.D) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(dcn_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dcn_bwd_kernel<T><<<dim3(a.tiles, a.C, a.B), kThreads, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int outs = a.D * a.O * a.C * 9 + a.O;
  dcn_bwd_reduce_kernel<<<(outs + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0, st>>>(
      a.partial, dw, dbias, a.B * a.tiles, a.C, a.O, a.D);
  return cudaGetLastError();
}

}  // namespace

extern "C" int otp_deform_bwd_tile() { return kThreads; }

// x: (B, C, H, W); offs[d]: (B, 18 C, H, W); masks[d]: (B, 9 C, H, W); g:
// (B, O, H, W), all in the compute dtype and contiguous; w: (D, C, 9, OP) f32
// (the forward's pack).  Writes d_off (D, B, 18 C, H, W) and d_mask
// (D, B, 9 C, H, W) in the compute dtype, adds into dx (B, C, H, W) f32
// (zeroed by the caller), and writes dw (D, O, C, 3, 3) and dbias (D, O)
// f32, with partial: (B * tiles, C, D * 9 + 1, O) f32 scratch, tiles =
// ceil(H * W / otp_deform_bwd_tile()).
extern "C" int otp_deform_bwd(const void* x, const void* const* offs, const void* const* masks,
                              const int* dils, const void* w, const void* g, void* d_off,
                              void* d_mask, void* dx, void* partial, void* dw, void* dbias,
                              int B, int C, int O, int OP, int H, int W, int D, int dtype,
                              void* stream) {
  if (D < 1 || D > kMaxD || B < 1 || C < 1 || H < 1 || W < 1 || O < 1 || O > OP ||
      OP > kMaxO || B > 65535 || C > 65535)
    return (int)cudaErrorInvalidValue;
  BwdArgs a{};
  a.x = x;
  for (int d = 0; d < D; ++d) {
    a.offs[d] = offs[d];
    a.masks[d] = masks[d];
    a.dils[d] = dils[d];
  }
  a.w = (const float*)w;
  a.g = g;
  a.d_off = d_off;
  a.d_mask = d_mask;
  a.dx = (float*)dx;
  a.partial = (float*)partial;
  a.B = B, a.C = C, a.O = O, a.OP = OP, a.H = H, a.W = W, a.D = D;
  a.tiles = (H * W + kThreads - 1) / kThreads;
  cudaStream_t st = (cudaStream_t)stream;
  OTP_DISPATCH(dtype, { return (int)launch<T>(a, (float*)dw, (float*)dbias, st); });
  return (int)cudaErrorInvalidValue;
}
