// Mean of D modulated deformable 3x3 convs (DCNv2), one channel per
// deformable group, computed as a fused sampler: the same function as
// deform_conv.cu, with the rounding points of the TPU experiment it replaces.
//
//   out[b, o, p] = sum_d sum_{c,k} w[d, c, k, o] * smp_d[b, c*9+k, p] / D + mean_d(bias[d, o])
//   smp = rnd(rnd(sample) * mask),  sample = sum_x wx * sum_y rnd(wy) * x[y, x]
//
// Replaces: tools/exp_deform_pallas3.py::make_pallas3 (kernel body `kern`).
// That Pallas kernel built separable tent weights max(0, 1 - |s - i|) for
// every row and column of the image and contracted them on the MXU (an
// H-long dot per sample where bilinear needs 4 products), because TPU
// gathers were slow.  Only two tent weights per axis are non-zero, so this
// kernel evaluates those two directly and keeps the rounding points that
// make the experiment differ from deform_conv.cu in bf16: the y weights are
// rounded to the compute dtype (`wy.astype(cd)`), the x weights stay f32, a
// sample is rounded, multiplied by the mask in the compute dtype and rounded
// again, and the weight contraction is f32 with f32 weights.  In f32 it is
// deform_conv.cu's function.
//
// What bounds it on the H100: device memory, as for deform_conv.cu (~0.5 GB
// of offsets and masks at the flagship shape in bf16).  Design: what the
// experiment was after, "sample into on-chip memory, then contract".  One
// block per (b, tile of 64 pixels).  For each dilation the block stages the
// 9*C masked samples of its pixels (threads on neighbouring pixels, so the
// offset and mask reads are coalesced and each is read once) and that
// dilation's (9*C, O) f32 weights in shared memory, then contracts them into
// an (O, 64) output tile held in registers across the D dilations: each
// thread owns one pixel and every fourth output channel.  The sum over the
// groups that Pallas made by revisiting its output block on a sequential
// grid happens inside the block, with no atomics.
#include "common.cuh"

namespace {

constexpr int kMaxD = 8;
constexpr int kTile = 64;                  // pixels per block
constexpr int kThreads = 256;
constexpr int kGroups = kThreads / kTile;  // output-channel groups per pixel
constexpr int kMaxOpt = 8;                 // outputs per thread: O <= 32

template <typename T>
struct Ptrs {
  const T* p[kMaxD];
};

struct Dils {
  int v[kMaxD];
};

// The separable tent sample of make_pallas3 at the two integer neighbours on
// each axis: y weights rounded to T, x weights f32, rows summed per column
// first.  Zero when the position is outside (-1, H) x (-1, W).
template <typename T>
__device__ __forceinline__ float tent_sample(const T* __restrict__ img, int H, int W, float sy,
                                             float sx) {
  if (!(sy > -1.f && sy < (float)H && sx > -1.f && sx < (float)W)) return 0.f;
  const int y0 = (int)floorf(sy), x0 = (int)floorf(sx);
  float col0 = 0.f, col1 = 0.f;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    const int y = y0 + dy;
    if (y < 0 || y >= H) continue;
    const float wy = rnd<T>(fmaxf(1.f - fabsf(sy - (float)y), 0.f));
    if (x0 >= 0) col0 += to_f<T>(img[y * W + x0]) * wy;
    if (x0 + 1 < W) col1 += to_f<T>(img[y * W + x0 + 1]) * wy;
  }
  const float wx0 = fmaxf(1.f - fabsf(sx - (float)x0), 0.f);
  const float wx1 = fmaxf(1.f - fabsf(sx - (float)(x0 + 1)), 0.f);
  return col0 * wx0 + col1 * wx1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
deform_fused_kernel(const T* __restrict__ x, Ptrs<T> offs, Ptrs<T> masks, Dils dils,
                    const float* __restrict__ w, const float* __restrict__ bias_mean,
                    T* __restrict__ out, int C, int O, int H, int W, int D) {
  extern __shared__ float sh[];
  const int n = 9 * C;                 // (group, tap) rows, i = c * 9 + k
  float* s_sh = sh;                    // (n, kTile) masked samples
  float* w_sh = sh + n * kTile;        // (n, O) weights of one dilation
  const int P = H * W;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kTile;
  const int lane = threadIdx.x % kTile, og = threadIdx.x / kTile;
  const T* xb = x + (size_t)b * C * P;

  float acc[kMaxOpt];
#pragma unroll
  for (int j = 0; j < kMaxOpt; ++j) acc[j] = 0.f;

  for (int d = 0; d < D; ++d) {
    __syncthreads();                   // the previous dilation's contraction is done
    const float* wd = w + (size_t)d * n * O;
    for (int e = threadIdx.x; e < n * O; e += kThreads) w_sh[e] = wd[e];
    const int dil = dils.v[d];
    const T* off = offs.p[d] + (size_t)b * 2 * n * P;
    const T* msk = masks.p[d] + (size_t)b * n * P;
    for (int e = threadIdx.x; e < n * kTile; e += kThreads) {
      const int i = e / kTile, p = p0 + e % kTile;
      float v = 0.f;
      if (p < P) {
        const int c = i / 9, k = i % 9;
        // (offset + tap) + pixel: make_pallas3's order of the f32 sums
        const float ty = (float)((k / 3) * dil - dil), tx = (float)((k % 3) * dil - dil);
        const float sy = (to_f<T>(off[(size_t)(2 * i) * P + p]) + ty) + (float)(p / W);
        const float sx = (to_f<T>(off[(size_t)(2 * i + 1) * P + p]) + tx) + (float)(p % W);
        const float s = tent_sample<T>(xb + (size_t)c * P, H, W, sy, sx);
        v = rnd<T>(rnd<T>(s) * to_f<T>(msk[(size_t)i * P + p]));
      }
      s_sh[e] = v;
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float s = s_sh[i * kTile + lane];
      const float* wi = w_sh + i * O;   // one output group per warp: broadcast reads
#pragma unroll
      for (int j = 0; j < kMaxOpt; ++j) {
        const int o = og + kGroups * j;
        if (o < O) acc[j] += wi[o] * s;
      }
    }
  }
  const int p = p0 + lane;
  if (p >= P) return;
#pragma unroll
  for (int j = 0; j < kMaxOpt; ++j) {
    const int o = og + kGroups * j;
    if (o < O) out[((size_t)b * O + o) * P + p] = from_f<T>(acc[j] / (float)D + bias_mean[o]);
  }
}

}  // namespace

extern "C" int otp_deform_fused_max_groups() { return kMaxD; }
extern "C" int otp_deform_fused_max_outputs() { return kGroups * kMaxOpt; }
extern "C" int otp_deform_fused_tile() { return kTile; }

// x: (B, C, H, W); offs[d]: (B, 2*9*C, H, W); masks[d]: (B, 9*C, H, W), all in
// the compute dtype and contiguous.  w: (D, C, 9, O) f32, tap k = 3*ky+kx.
// bias_mean: (O,) f32.  out: (B, O, H, W).
extern "C" int otp_deform_fused(const void* x, const void* const* offs,
                                const void* const* masks, const int* dils, const void* w,
                                const void* bias_mean, void* out, int B, int C, int O,
                                int H, int W, int D, int dtype, void* stream) {
  if (D < 1 || D > kMaxD || O < 1 || O > kGroups * kMaxOpt || B < 1 || H * W < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = sizeof(float) * (size_t)9 * C * (kTile + O);
  Dils dl;
  for (int d = 0; d < kMaxD; ++d) dl.v[d] = d < D ? dils[d] : 0;
  const dim3 grid((H * W + kTile - 1) / kTile, B);
  OTP_DISPATCH(dtype, {
    Ptrs<T> op, mp;
    for (int d = 0; d < kMaxD; ++d) {
      op.p[d] = d < D ? (const T*)offs[d] : nullptr;
      mp.p[d] = d < D ? (const T*)masks[d] : nullptr;
    }
    cudaFuncSetAttribute(deform_fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    deform_fused_kernel<T><<<grid, kThreads, smem, st>>>(
        (const T*)x, op, mp, dl, (const float*)w, (const float*)bias_mean, (T*)out, C, O, H,
        W, D);
  });
  return (int)cudaGetLastError();
}
