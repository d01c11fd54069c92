// Fused transformer MLP with residual on (B, C, T):
//
//   out = x + (round(W2 @ round(gelu(round(W1 @ LN_C(x)) + b1))) + b2)
//
// Replaces: otpose_tpu/ops/pallas/fused_mlp.py::fused_mlp_residual_ct (Pallas
// kernel `_kernel`, pallas_call in `_fused_mlp_jit`).  The drop-path scale is
// folded into W2/b2 by the caller, as in `fused_mlp_block_ct`.
//
// What bounds it on the H100: ~33 GFLOP per flagship launch at T = 6912
// (hidden 4C = 544) against 60 MB of compulsory traffic, so operations.
// The point of the fusion is that the (B, 4C, T) GELU intermediate never
// reaches device memory.  This first version runs the two products as f32
// FMA loops from shared memory, not on the tensor cores.
//
// Design.  One block owns a tile of 64 tokens with all C channels, so the
// channel LayerNorm is a reduction inside the block.  W1 and W2 (296 KB in
// bf16 at C = 136) cannot both sit in shared memory as the TPU kernel held
// them, so the hidden dimension is walked in tiles of 32 rows: each step
// stages one W1 tile and one W2 tile, computes that slice of GELU(W1 x + b1)
// into shared memory and adds its contribution to the second product, which
// each thread keeps in f32 registers across hidden tiles (one rounding at
// the end, like the f32-accumulated matmul of the plain version).  GELU is
// the exact erf form (erff); the TPU kernel's polynomial existed only
// because Mosaic had no erf.  A ragged last token tile is masked.
#include "common.cuh"

namespace {

constexpr int kMT = 64;        // tokens per block
constexpr int kHT = 32;        // hidden rows per tile
constexpr int kThreads = 256;
constexpr int kGroups = kThreads / kMT;   // row groups in the second product
constexpr int kMaxRows = 40;              // C <= kGroups * kMaxRows = 160

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_mlp_kernel(const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ lnw,
                 const float* __restrict__ lnb, const float* __restrict__ w1,
                 const float* __restrict__ b1, const float* __restrict__ w2,
                 const float* __restrict__ b2, int C, int H, int Tn) {
  extern __shared__ float sm[];
  float* xn_sh = sm;                 // C x kMT
  float* w1_sh = xn_sh + C * kMT;    // kHT x C
  float* w2_sh = w1_sh + kHT * C;    // C x kHT
  float* h_sh = w2_sh + C * kHT;     // kHT x kMT
  float* mu_sh = h_sh + kHT * kMT;   // kMT
  float* sd_sh = mu_sh + kMT;        // kMT

  const int tid = threadIdx.x, b = blockIdx.y;
  const int t0 = blockIdx.x * kMT;
  const int tcount = min(kMT, Tn - t0);
  const T* xb = x + (size_t)b * C * Tn + t0;
  T* ob = out + (size_t)b * C * Tn + t0;

  for (int i = tid; i < C * kMT; i += kThreads) {
    const int c = i / kMT, t = i % kMT;
    xn_sh[i] = t < tcount ? to_f<T>(xb[(size_t)c * Tn + t]) : 0.f;
  }
  __syncthreads();
  if (tid < tcount) {
    float s = 0.f;
    for (int c = 0; c < C; ++c) s += xn_sh[c * kMT + tid];
    const float mu = s / C;
    float v = 0.f;
    for (int c = 0; c < C; ++c) {
      const float r = xn_sh[c * kMT + tid] - mu;
      v += r * r;
    }
    mu_sh[tid] = mu;
    sd_sh[tid] = sqrtf(v / C + 1e-5f);
  }
  __syncthreads();
  for (int i = tid; i < C * kMT; i += kThreads) {
    const int c = i / kMT, t = i % kMT;
    if (t < tcount)
      xn_sh[i] = rnd<T>((xn_sh[i] - mu_sh[t]) / sd_sh[t] * lnw[c] + lnb[c]);
  }

  const int t = tid % kMT, grp = tid / kMT;
  float acc[kMaxRows];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) acc[r] = 0.f;

  for (int h0 = 0; h0 < H; h0 += kHT) {
    __syncthreads();
    for (int i = tid; i < kHT * C; i += kThreads) {
      const int k = i / C, c = i % C;
      w1_sh[i] = h0 + k < H ? w1[(size_t)(h0 + k) * C + c] : 0.f;
    }
    for (int i = tid; i < C * kHT; i += kThreads) {
      const int c = i / kHT, k = i % kHT;
      w2_sh[i] = h0 + k < H ? w2[(size_t)c * H + h0 + k] : 0.f;
    }
    __syncthreads();
    for (int k = grp; k < kHT; k += kGroups) {
      float a = 0.f;
      const float* wr = w1_sh + k * C;
      for (int c = 0; c < C; ++c) a += wr[c] * xn_sh[c * kMT + t];
      float g = 0.f;
      if (h0 + k < H) {
        const float hv = rnd<T>(rnd<T>(a) + b1[h0 + k]);
        g = rnd<T>(0.5f * hv * (1.f + erff(hv * 0.70710678118654752f)));
      }
      h_sh[k * kMT + t] = g;
    }
    __syncthreads();
    for (int k = 0; k < kHT; ++k) {
      const float g = h_sh[k * kMT + t];
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        const int c = grp + r * kGroups;
        if (c < C) acc[r] += w2_sh[c * kHT + k] * g;
      }
    }
  }
  if (t >= tcount) return;
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    const int c = grp + r * kGroups;
    if (c < C) {
      const float y = rnd<T>(rnd<T>(acc[r]) + b2[c]);
      const size_t off = (size_t)c * Tn + t;
      ob[off] = from_f<T>(to_f<T>(xb[off]) + y);
    }
  }
}

size_t smem_bytes(int C) {
  return sizeof(float) * ((size_t)C * kMT + 2 * (size_t)kHT * C + kHT * kMT + 2 * kMT);
}

}  // namespace

extern "C" size_t otp_fused_mlp_smem(int C) { return smem_bytes(C); }

extern "C" int otp_fused_mlp_max_channels() { return kGroups * kMaxRows; }

// x, out: (B, C, T) in the compute dtype.  lnw/lnb: (C,) f32.  w1: (H, C),
// b1: (H,), w2: (C, H), b2: (C,), f32 and already rounded to the compute
// dtype (w2/b2 with the drop-path scale folded in).
extern "C" int otp_fused_mlp(const void* x, void* out, const void* lnw, const void* lnb,
                             const void* w1, const void* b1, const void* w2, const void* b2,
                             int B, int C, int H, int Tn, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = smem_bytes(C);
  OTP_DISPATCH(dtype, {
    cudaFuncSetAttribute(fused_mlp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    fused_mlp_kernel<T><<<dim3((Tn + kMT - 1) / kMT, B), kThreads, smem, st>>>(
        (const T*)x, (T*)out, (const float*)lnw, (const float*)lnb, (const float*)w1,
        (const float*)b1, (const float*)w2, (const float*)b2, C, H, Tn);
  });
  return (int)cudaGetLastError();
}
