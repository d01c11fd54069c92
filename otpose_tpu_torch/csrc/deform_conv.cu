// Mean of D modulated deformable 3x3 convs (DCNv2) over one input, with one
// channel per deformable group:
//
//   out[b, o, p] = sum_d sum_k sum_c w[d, o, c, k] * mask_d[b, c*9+k, p]
//                  * bilinear(x[b, c], p + tap_d(k) + offset_d[b, c, k, p]) / D
//                  + mean_d(bias[d, o])
//
// Replaces: otpose_tpu/ops/deform_conv.py::modulated_deform_conv_multi.  That
// is not a Pallas kernel but an XLA "tent matmul", a workaround for slow TPU
// gathers; the original CUDA op sampled directly, and so does this kernel.
// Offsets are laid out (group, tap, y/x), masks are raw (no sigmoid), the
// padding equals the dilation, sample positions are f32, and a sample
// contributes its in-bounds corners when -1 < y < H and -1 < x < W.
//
// What bounds it on the H100: device memory.  At the flagship shape it must
// read ~0.5 GB of offsets and masks (bf16) for ~2 GFLOP of work.  Design:
// one thread per (b, output pixel), threads of a warp on neighbouring
// pixels, so every offset and mask read is coalesced and each is read once.
// The D x 9 x C x O weights sit in shared memory, read as warp broadcasts;
// the O outputs are f32 accumulators in registers.  The input gathers hit
// L1/L2: neighbouring pixels sample neighbouring positions.
#include "common.cuh"

namespace {

constexpr int kMaxD = 8;
constexpr int kThreads = 128;

template <typename T>
struct Ptrs {
  const T* p[kMaxD];
};

struct Dils {
  int v[kMaxD];
};

template <typename T>
__device__ __forceinline__ float sample(const T* __restrict__ img, int H, int W, float sy,
                                        float sx) {
  if (!(sy > -1.f && sy < (float)H && sx > -1.f && sx < (float)W)) return 0.f;
  const float fy = floorf(sy), fx = floorf(sx);
  const int y0 = (int)fy, x0 = (int)fx;
  const float ly = sy - fy, lx = sx - fx, hy = 1.f - ly, hx = 1.f - lx;
  float v = 0.f;
  if (y0 >= 0) {
    if (x0 >= 0) v += hy * hx * to_f<T>(img[y0 * W + x0]);
    if (x0 + 1 < W) v += hy * lx * to_f<T>(img[y0 * W + x0 + 1]);
  }
  if (y0 + 1 < H) {
    if (x0 >= 0) v += ly * hx * to_f<T>(img[(y0 + 1) * W + x0]);
    if (x0 + 1 < W) v += ly * lx * to_f<T>(img[(y0 + 1) * W + x0 + 1]);
  }
  return v;
}

template <typename T, int MaxO>
__global__ void __launch_bounds__(kThreads)
deform_multi_kernel(const T* __restrict__ x, Ptrs<T> offs, Ptrs<T> masks, Dils dils,
                    const float* __restrict__ w, const float* __restrict__ bias_mean,
                    T* __restrict__ out, int B, int C, int O, int H, int W, int D) {
  extern __shared__ float w_sh[];   // (D, 9, C, O)
  const int nw = D * 9 * C * O;
  for (int i = threadIdx.x; i < nw; i += kThreads) w_sh[i] = w[i];
  __syncthreads();

  const int P = H * W;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= B * P) return;
  const int b = idx / P, p = idx % P;
  const int py = p / W, px = p % W;
  const T* xb = x + (size_t)b * C * P;

  float acc[MaxO];
#pragma unroll
  for (int o = 0; o < MaxO; ++o) acc[o] = 0.f;

  for (int d = 0; d < D; ++d) {
    const int dil = dils.v[d];
    const T* off = offs.p[d] + (size_t)b * 18 * C * P + p;
    const T* msk = masks.p[d] + (size_t)b * 9 * C * P + p;
    for (int k = 0; k < 9; ++k) {
      const float by = (float)py + (float)((k / 3) * dil - dil);
      const float bx = (float)px + (float)((k % 3) * dil - dil);
      const float* wk = w_sh + (d * 9 + k) * C * O;
      for (int c = 0; c < C; ++c) {
        const int g = c * 9 + k;
        const float sy = by + to_f<T>(off[(size_t)(2 * g) * P]);
        const float sx = bx + to_f<T>(off[(size_t)(2 * g + 1) * P]);
        const float v = sample<T>(xb + (size_t)c * P, H, W, sy, sx) *
                        to_f<T>(msk[(size_t)g * P]);
        const float* wc = wk + c * O;
#pragma unroll
        for (int o = 0; o < MaxO; ++o)
          if (o < O) acc[o] += wc[o] * v;
      }
    }
  }
  T* ob = out + (size_t)b * O * P + p;
#pragma unroll
  for (int o = 0; o < MaxO; ++o)
    if (o < O) ob[(size_t)o * P] = from_f<T>(acc[o] / (float)D + bias_mean[o]);
}

}  // namespace

extern "C" int otp_deform_max_groups() { return kMaxD; }

// x: (B, C, H, W); offs[d]: (B, 2*9*C, H, W); masks[d]: (B, 9*C, H, W), all in
// the compute dtype and contiguous.  w: (D, 9, C, O) f32, with tap k = 3*ky+kx.
// bias_mean: (O,) f32.  out: (B, O, H, W).
extern "C" int otp_deform_multi(const void* x, const void* const* offs,
                                const void* const* masks, const int* dils, const void* w,
                                const void* bias_mean, void* out, int B, int C, int O,
                                int H, int W, int D, int dtype, void* stream) {
  if (D < 1 || D > kMaxD || O > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = sizeof(float) * (size_t)D * 9 * C * O;
  Dils dl;
  for (int d = 0; d < kMaxD; ++d) dl.v[d] = d < D ? dils[d] : 0;
  const int blocks = (B * H * W + kThreads - 1) / kThreads;
  OTP_DISPATCH(dtype, {
    Ptrs<T> op, mp;
    for (int d = 0; d < kMaxD; ++d) {
      op.p[d] = d < D ? (const T*)offs[d] : nullptr;
      mp.p[d] = d < D ? (const T*)masks[d] : nullptr;
    }
    if (O <= 16) {
      cudaFuncSetAttribute(deform_multi_kernel<T, 16>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      deform_multi_kernel<T, 16><<<blocks, kThreads, smem, st>>>(
          (const T*)x, op, mp, dl, (const float*)w, (const float*)bias_mean, (T*)out, B, C,
          O, H, W, D);
    } else {
      cudaFuncSetAttribute(deform_multi_kernel<T, 32>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      deform_multi_kernel<T, 32><<<blocks, kThreads, smem, st>>>(
          (const T*)x, op, mp, dl, (const float*)w, (const float*)bias_mean, (T*)out, B, C,
          O, H, W, D);
    }
  });
  return (int)cudaGetLastError();
}
