// Fused transformer MLP with residual on (B, C, T):
//
//   out = x + (round(W2 @ round(gelu(round(W1 @ LN_C(x)) + b1))) + b2)
//
// Replaces: otpose_tpu/ops/pallas/fused_mlp.py::fused_mlp_residual_ct (Pallas
// kernel `_kernel`, pallas_call in `_fused_mlp_jit`).  The drop-path scale is
// folded into W2/b2 by the caller (`ops/cuda/fused_mlp.py::pack_mlp_weights`),
// as in `fused_mlp_block_ct`.
//
// What bounds it on the H100: 32.7 GFLOP per flagship launch at
// (B, C, T) = (16, 136, 6912) (hidden 4C = 544) against 60 MB of compulsory
// traffic: 0.033 ms on the bf16 tensor cores against 0.018 ms of HBM, so
// operations.  The point of the fusion is that the (B, 4C, T) GELU
// intermediate never reaches device memory.
//
// bf16: `fused_mlp_tc_kernel`, on the tensor cores (mma.sync m16n8k16, bf16
// in, f32 accumulators, operands through ldmatrix).
//   - Weights come packed once per block of the model: W1 (Hp, Cp) and W2
//     (Cp, Hp) in bf16, C zero-padded to Cp (a multiple of 16, the mma depth)
//     and the hidden 4C to Hp (a multiple of the 32-row hidden tile).  Padded
//     rows and columns are zero, so they add nothing.
//   - A block owns 48 tokens with all C channels, so the channel LayerNorm
//     stays a reduction inside the block (f32 statistics, one rounding).
//     Three warps each own 16 tokens.  48 tokens give 144 blocks at B = 1,
//     T = 6912 (the inference path), more than the 132 SMs; 64 would give 108
//     and leave SMs idle.  About 74 KB of shared memory lets three blocks
//     share an SM.  The x tile arrives by cp.async; the LN multiplies by a
//     reciprocal of the deviation taken once a token (an IEEE division per
//     element cost more than the rest of the LN).  The kernel is a template
//     on Cp / 16, so its register arrays hold no unused channel tiles.
//   - Tokens are the M side of both products (the transposed form
//     out^T = gelu(xn^T W1^T) W2^T), so a warp's GELU tile comes out of the
//     first product's accumulators in exactly the register layout of the
//     second product's A operand: it is rounded to bf16 in registers and
//     never touches shared or device memory.  The warp's LayerNorm output
//     (its A operand of the first product) stays in registers for the whole
//     kernel.
//   - W1 and W2 (313 KB at C = 136) do not fit beside the activations, so
//     they stream from L2 in 32-row hidden tiles (18 KB a tile, with its 32
//     b1 values), double buffered with cp.async: tile i + 1 is in flight
//     while tile i is used.
//   - The second product's f32 accumulators (16 tokens x Cp a warp) live in
//     registers across all hidden tiles; one rounding at the end, as the
//     plain version's f32-accumulated matmul.  The output goes back through
//     shared memory so that the stores to (B, C, T) are coalesced.
//   Rounding points as the plain version: rnd(rnd(acc1) + b1), GELU in f32
//   (the exact erf form) rounded, rnd(rnd(acc2) + b2), rnd(x + y).
//
// f32: `fused_mlp_kernel`, f32 FMA loops from shared memory (the parity path:
// on the tensor cores f32 would run as TF32).  A block owns 64 tokens and
// walks the hidden rows in tiles of 32.
#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace otp_mma;

// ---------------------------------------------------------------------------
// f32: FMA loops
// ---------------------------------------------------------------------------

constexpr int kMT = 64;        // tokens per block
constexpr int kHT = 32;        // hidden rows per tile (both kernels)
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

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 3;
constexpr int kTcTok = 16 * kTcWarps;      // tokens per block: 48
constexpr int kTcThreads = 32 * kTcWarps;  // 96 = 2 threads per token in the LN
constexpr int kMaxCp = 160;
constexpr int kLDX = kTcTok + 8;           // x tile (Cp x tokens) row stride
constexpr int kLDW2 = kHT + 8;             // W2 tile (Cp x kHT) row stride

__device__ __forceinline__ float rnd_bf(float v) { return rnd<bf16>(v); }

// GELU of rnd(rnd(acc) + bias), not yet rounded (the caller packs to bf16)
__device__ __forceinline__ float gelu_pre(float acc, float bias) {
  const float hv = rnd_bf(rnd_bf(acc) + bias);
  return 0.5f * hv * (1.f + erff(hv * 0.70710678118654752f));
}

// KC = Cp / 16: the k steps of the first product (Cp / 8 n8 tiles in the
// second), a template parameter so the register arrays have no unused part.
template <int KC>
__global__ void __launch_bounds__(kTcThreads)
fused_mlp_tc_kernel(const bf16* __restrict__ x, bf16* __restrict__ out,
                    const float* __restrict__ lnw, const float* __restrict__ lnb,
                    const bf16* __restrict__ w1, const float* __restrict__ b1,
                    const bf16* __restrict__ w2, const float* __restrict__ b2, int C, int Hp,
                    int Tn) {
  constexpr int Cp = 16 * KC, NC = 2 * KC;
  constexpr int LDN = Cp + 8;                   // xn and W1 tile row stride
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* x_sh = reinterpret_cast<bf16*>(smem);   // Cp x kLDX: x, then out
  bf16* xn_sh = x_sh + Cp * kLDX;               // kTcTok x LDN: LN_C(x)^T
  bf16* w1_sh = xn_sh + kTcTok * LDN;           // 2 stages of kHT x LDN
  bf16* w2_sh = w1_sh + 2 * kHT * LDN;          // 2 stages of Cp x kLDW2
  float* b1_sh = reinterpret_cast<float*>(w2_sh + 2 * Cp * kLDW2);   // 2 stages of kHT
  float* mu_sh = b1_sh + 2 * kHT;
  float* rs_sh = mu_sh + kTcTok;                // 1 / standard deviation
  float* part_sh = rs_sh + kTcTok;              // kTcThreads
  float* lnw_sh = part_sh + kTcThreads;         // C
  float* lnb_sh = lnw_sh + C;                   // C

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int b = blockIdx.y, t0 = blockIdx.x * kTcTok;
  const int tcount = min(kTcTok, Tn - t0);
  const bf16* xb = x + (size_t)b * C * Tn + t0;
  bf16* ob = out + (size_t)b * C * Tn + t0;
  const int ntiles = Hp / kHT;
  const bf16 zero = __float2bfloat16(0.f);
  OTP_PHASE_START;

  // the x tile: cp.async where its rows are whole and 16-byte aligned
  const bool vec = tcount == kTcTok && Tn % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  if (vec) {
    for (int e = tid; e < C * (kTcTok / 8); e += kTcThreads) {
      const int c = e / (kTcTok / 8), ch = e % (kTcTok / 8);
      cp_async16(x_sh + c * kLDX + ch * 8, xb + (size_t)c * Tn + ch * 8);
    }
    for (int i = tid; i < (Cp - C) * kTcTok; i += kTcThreads)
      x_sh[(C + i / kTcTok) * kLDX + i % kTcTok] = zero;
  } else {
    for (int i = tid; i < Cp * kTcTok; i += kTcThreads) {
      const int c = i / kTcTok, t = i % kTcTok;
      x_sh[c * kLDX + t] = (c < C && t < tcount) ? xb[(size_t)c * Tn + t] : zero;
    }
  }
  cp_async_commit();
  for (int c = tid; c < C; c += kTcThreads) {
    lnw_sh[c] = lnw[c];
    lnb_sh[c] = lnb[c];
  }

  // one hidden tile of W1 (kHT rows of Cp) and of W2 (Cp rows of kHT)
  auto load_tile = [&](int i, int stage) {
    const int h0 = i * kHT;
    bf16* d1 = w1_sh + stage * kHT * LDN;
    for (int e = tid; e < kHT * (Cp / 8); e += kTcThreads) {
      const int r = e / (Cp / 8), ch = e % (Cp / 8);
      cp_async16(d1 + r * LDN + ch * 8, w1 + (size_t)(h0 + r) * Cp + ch * 8);
    }
    bf16* d2 = w2_sh + stage * Cp * kLDW2;
    for (int e = tid; e < Cp * (kHT / 8); e += kTcThreads) {
      const int r = e / (kHT / 8), ch = e % (kHT / 8);
      cp_async16(d2 + r * kLDW2 + ch * 8, w2 + (size_t)r * Hp + h0 + ch * 8);
    }
    if (tid < kHT / 4) cp_async16(b1_sh + stage * kHT + tid * 4, b1 + h0 + tid * 4);
    cp_async_commit();
  };
  load_tile(0, 0);
  cp_async_wait<1>();          // the x tile has landed
  __syncthreads();
  OTP_PHASE(0);
  {
    // LN statistics in f32: two threads a token, each over half the channels
    const int t = tid % kTcTok, half = tid / kTcTok;
    float s = 0.f;
#pragma unroll 8
    for (int c = half; c < C; c += 2) s += __bfloat162float(x_sh[c * kLDX + t]);
    part_sh[tid] = s;
    __syncthreads();
    const float mu = (part_sh[t] + part_sh[t + kTcTok]) / C;
    __syncthreads();
    float v = 0.f;
#pragma unroll 8
    for (int c = half; c < C; c += 2) {
      const float r = __bfloat162float(x_sh[c * kLDX + t]) - mu;
      v += r * r;
    }
    part_sh[tid] = v;
    __syncthreads();
    if (half == 0) {
      mu_sh[t] = mu;
      rs_sh[t] = 1.f / sqrtf((part_sh[t] + part_sh[t + kTcTok]) / C + 1e-5f);
    }
    __syncthreads();
  }
  // (x - mu) times the reciprocal of the deviation, taken once a token: an
  // IEEE division per element costs more than the rest of the LN, and the
  // reciprocal moves the f32 value by an ulp or so before the bf16 rounding
#pragma unroll 4
  for (int i = tid; i < Cp * kTcTok; i += kTcThreads) {
    const int t = i / Cp, c = i % Cp;
    float v = 0.f;
    if (c < C)
      v = (__bfloat162float(x_sh[c * kLDX + t]) - mu_sh[t]) * rs_sh[t] * lnw_sh[c] + lnb_sh[c];
    xn_sh[t * LDN + c] = __float2bfloat16_rn(v);
  }
  __syncthreads();
  OTP_PHASE(1);

  // this warp's 16 tokens of LN_C(x)^T: the first product's A operand
  uint32_t afr[KC][4];
  const bf16* arow = xn_sh + warp * 16 * LDN + a_off(lane, LDN);
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) ldsm_x4(afr[kk], arow + kk * 16);

  float acc[NC][4];
#pragma unroll
  for (int j = 0; j < NC; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {
      load_tile(i + 1, (i + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    OTP_PHASE(2);
    const bf16* w1s = w1_sh + (i & 1) * kHT * LDN;
    const bf16* w2s = w2_sh + (i & 1) * Cp * kLDW2;
    const float* b1s = b1_sh + (i & 1) * kHT;

    // first product: h (16 tokens x kHT hidden) = xn^T @ W1_tile^T
    float h[kHT / 8][4];
#pragma unroll
    for (int j = 0; j < kHT / 8; ++j) h[j][0] = h[j][1] = h[j][2] = h[j][3] = 0.f;
    const bf16* brow = w1s + bnk_x4_off(lane, LDN);
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
#pragma unroll
      for (int np = 0; np < kHT / 16; ++np) {
        uint32_t r[4];
        ldsm_x4(r, brow + np * 16 * LDN + kk * 16);
        mma_bf16(h[2 * np], afr[kk], r[0], r[1]);
        mma_bf16(h[2 * np + 1], afr[kk], r[2], r[3]);
      }
    }
    OTP_PHASE(3);
    // epilogue in registers: the C fragments of n8 tiles 2s and 2s + 1 are
    // the A fragment of k step s of the second product
    uint32_t gfr[kHT / 16][4];
#pragma unroll
    for (int j = 0; j < kHT / 8; ++j) {
      const int hc = j * 8 + 2 * q;
      const float bb0 = b1s[hc], bb1 = b1s[hc + 1];
      gfr[j >> 1][(j & 1) * 2 + 0] = pack_bf16(gelu_pre(h[j][0], bb0), gelu_pre(h[j][1], bb1));
      gfr[j >> 1][(j & 1) * 2 + 1] = pack_bf16(gelu_pre(h[j][2], bb0), gelu_pre(h[j][3], bb1));
    }
    OTP_PHASE(4);
    // second product: acc (16 tokens x Cp) += gelu @ W2_tile^T
    const bf16* b2row = w2s + bnk_x4_off(lane, kLDW2);
#pragma unroll
    for (int s = 0; s < kHT / 16; ++s) {
#pragma unroll
      for (int np = 0; np < NC / 2; ++np) {
        uint32_t r[4];
        ldsm_x4(r, b2row + np * 16 * kLDW2 + s * 16);
        mma_bf16(acc[2 * np], gfr[s], r[0], r[1]);
        mma_bf16(acc[2 * np + 1], gfr[s], r[2], r[3]);
      }
    }
    OTP_PHASE(5);
    __syncthreads();   // the next iteration refills this stage
  }

  // out = x + rnd(rnd(acc) + b2), in place in the x tile, then coalesced
#pragma unroll
  for (int j = 0; j < NC; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = j * 8 + 2 * q + (e & 1), t = warp * 16 + g + (e >> 1) * 8;
      if (c < C) {
        const float y = rnd_bf(rnd_bf(acc[j][e]) + b2[c]);
        bf16* p = x_sh + c * kLDX + t;
        *p = __float2bfloat16_rn(__bfloat162float(*p) + y);
      }
    }
  }
  __syncthreads();
  if (vec) {
    for (int e = tid; e < C * (kTcTok / 8); e += kTcThreads) {
      const int c = e / (kTcTok / 8), ch = e % (kTcTok / 8);
      *reinterpret_cast<uint4*>(ob + (size_t)c * Tn + ch * 8) =
          *reinterpret_cast<const uint4*>(x_sh + c * kLDX + ch * 8);
    }
  } else {
    for (int i = tid; i < C * kTcTok; i += kTcThreads) {
      const int c = i / kTcTok, t = i % kTcTok;
      if (t < tcount) ob[(size_t)c * Tn + t] = x_sh[c * kLDX + t];
    }
  }
  OTP_PHASE(6);
}

size_t tc_smem_bytes(int Cp) {
  const size_t ldn = Cp + 8;
  return sizeof(bf16) * ((size_t)Cp * kLDX + kTcTok * ldn + 2 * kHT * ldn +
                         2 * (size_t)Cp * kLDW2) +
         sizeof(float) * (2 * kHT + 2 * kTcTok + kTcThreads + 2 * Cp);
}

template <int KC>
int launch_tc(const void* x, void* out, const void* lnw, const void* lnb, const void* w1,
              const void* b1, const void* w2, const void* b2, int B, int C, int Hp, int Tn,
              cudaStream_t st) {
  const size_t smem = tc_smem_bytes(16 * KC);
  cudaFuncSetAttribute(fused_mlp_tc_kernel<KC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  fused_mlp_tc_kernel<KC><<<dim3((Tn + kTcTok - 1) / kTcTok, B), kTcThreads, smem, st>>>(
      (const bf16*)x, (bf16*)out, (const float*)lnw, (const float*)lnb, (const bf16*)w1,
      (const float*)b1, (const bf16*)w2, (const float*)b2, C, Hp, Tn);
  return (int)cudaGetLastError();
}

}  // namespace

// f32.  x, out: (B, C, T).  lnw/lnb: (C,).  w1: (H, C), b1: (H,), w2: (C, H),
// b2: (C,), w2/b2 with the drop-path scale folded in.
extern "C" int otp_fused_mlp_f32(const void* x, void* out, const void* lnw, const void* lnb,
                                 const void* w1, const void* b1, const void* w2,
                                 const void* b2, int B, int C, int H, int Tn, void* stream) {
  if (C > kGroups * kMaxRows) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = smem_bytes(C);
  cudaFuncSetAttribute(fused_mlp_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  fused_mlp_kernel<float><<<dim3((Tn + kMT - 1) / kMT, B), kThreads, smem, st>>>(
      (const float*)x, (float*)out, (const float*)lnw, (const float*)lnb, (const float*)w1,
      (const float*)b1, (const float*)w2, (const float*)b2, C, H, Tn);
  return (int)cudaGetLastError();
}

// bf16.  x, out: (B, C, T) bf16.  lnw/lnb: (C,) f32.  w1: (Hp, Cp) bf16,
// b1: (Hp,) f32, w2: (Cp, Hp) bf16, b2: (Cp,) f32, zero-padded, the biases
// already rounded to bf16 (`pack_mlp_weights`).  Cp: a multiple of 16 in
// [C, C + 16); Hp: a multiple of 32.
extern "C" int otp_fused_mlp_tc(const void* x, void* out, const void* lnw, const void* lnb,
                                const void* w1, const void* b1, const void* w2, const void* b2,
                                int B, int C, int Cp, int Hp, int Tn, void* stream) {
  if (Cp % 16 || Cp < C || Cp >= C + 16 || Cp > kMaxCp || Hp % kHT || Hp <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (Cp / 16) {
#define OTP_KC(K) \
  case K: return launch_tc<K>(x, out, lnw, lnb, w1, b1, w2, b2, B, C, Hp, Tn, st);
    OTP_KC(1) OTP_KC(2) OTP_KC(3) OTP_KC(4) OTP_KC(5)
    OTP_KC(6) OTP_KC(7) OTP_KC(8) OTP_KC(9) OTP_KC(10)
#undef OTP_KC
  }
  return (int)cudaErrorInvalidValue;
}
