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
// f32: `fused_mlp_tf32_kernel`, the same plan in split TF32 (mma.sync
// m16n8k8: each operand split as hi + lo, three passes lo hi + hi lo + hi hi
// into f32 accumulators, `csrc/mma.cuh`), to f32 accuracy: the JAX package's
// f32 path asks its matrix unit for the highest precision.  Bound on the
// H100: three TF32 passes of the 32.7 GFLOP at 495 TFLOP/s, 0.198 ms,
// against 120 MB of traffic in f32 (0.036 ms), so operations.
//   - Weights packed once (`pack_mlp_weights`): W1 (Hp, Cp) and W2 (Cp, Hp)
//     f32, C zero-padded to Cp (a multiple of 8, the TF32 mma depth: 136
//     stays 136), split into hi and lo where they are loaded, so the pack
//     holds the weights themselves.
//   - Fragment layouts: in TF32 two n8 C tiles are not the next product's A
//     fragment (C holds columns 2q and 2q + 1, A wants q and q + 4).  The
//     hidden index is a sum index of the second product, so the pack
//     permutes W2's hidden columns inside each group of 8 (`HIDDEN_ORDER`)
//     and the GELU tile stays in the lanes that computed it.
//   - Registers: the LN output split in hi and lo is four times the bf16
//     kernel's packed pairs (136 registers at Cp = 136 beside the 68 of the
//     accumulators), so it stays in shared memory and each warp reads its A
//     fragments with ldmatrix (which gives the TF32 layouts on f32 data)
//     for every hidden tile.
//   - 128 tokens and eight warps a block, 145 KB of shared memory at C = 136
//     (one block an SM; 238 registers a thread): the LN reads x straight from
//     device memory into registers (two threads a token), W1 / W2 hidden
//     tiles of 32 stream from L2 double buffered by cp.async, the second
//     product's accumulators stay in registers, and the output tile goes
//     back through the freed weight buffers for coalesced stores of x + y
//     (x read again).  128 tokens, not 64 with two blocks an SM, halve the
//     weight traffic a token for the eval's B = 16; at B = 1 they leave 54
//     blocks for 132 SMs.
//   No rounding points of bf16: f32 LN (the division of the plain version),
//   GELU in its exact erf form, out = x + (acc + b2).
//
// Wide (`fused_mlp_wide_tc_kernel`, `fused_mlp_wide_tf32_kernel`): C padded
// past 160, up to 1152 (the temporal encoders are 8 x joints wide: 1064 at
// 133 joints).  The narrow kernels' per-warp registers (16 tokens x Cp of
// LN output and accumulators) and the f32 kernel's 128-token LN tile do not
// fit there, so a block of 16 warps owns 32 tokens, the LN output and a
// 256-wide GELU tile sit in shared memory, and the output channels are
// split across the warps; the GELU intermediate still never reaches device
// memory.  Bound at (B, C, T) = (2, 1064, 6912), hidden 4256: 250 GFLOP at
// 989 TFLOP/s, 0.253 ms, against 59 MB (0.018 ms), so operations; f32 three
// TF32 passes, 1.52 ms.  Each block streams both weight matrices (18 MB in
// bf16 at C = 1064) from L2, so L2 bandwidth, not the tensor cores, is what
// this design reaches first.
#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace otp_mma;

constexpr int kHT = 32;        // hidden rows per tile (both kernels)

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

// ---------------------------------------------------------------------------
// f32: split TF32 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kF32Warps = 8;
constexpr int kF32Tok = 16 * kF32Warps;       // tokens per block: 128
constexpr int kF32Threads = 32 * kF32Warps;   // 256 = 2 threads a token in the LN
constexpr int kLDW2f = kHT + 4;               // W2 tile (Cp x kHT) row stride
constexpr int kLDOf = kF32Tok + 4;            // output tile (Cp x tokens) row stride

__device__ __forceinline__ float gelu_f32(float h) {
  return 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
}

// KC = Cp / 8: the k steps of the first product and the n8 tiles of the
// second, a template parameter so the register arrays have no unused part.
template <int KC>
__global__ void __launch_bounds__(kF32Threads, 1)
fused_mlp_tf32_kernel(const float* __restrict__ x, float* __restrict__ out,
                      const float* __restrict__ lnw, const float* __restrict__ lnb,
                      const float* __restrict__ w1, const float* __restrict__ b1,
                      const float* __restrict__ w2, const float* __restrict__ b2, int C, int Hp,
                      int Tn) {
  constexpr int Cp = 8 * KC, LDA = Cp + 4;      // LDA = 4 mod 8: ldmatrix without conflicts
  constexpr int PER = Cp / 2;                   // channels a thread holds in the LN
  extern __shared__ __align__(16) unsigned char smem[];
  float* xn_sh = reinterpret_cast<float*>(smem);   // kF32Tok x LDA: LN_C(x)^T
  float* w1_sh = xn_sh + kF32Tok * LDA;            // 2 stages of kHT x LDA
  float* w2_sh = w1_sh + 2 * kHT * LDA;            // 2 stages of Cp x kLDW2f
  float* b1_sh = w2_sh + 2 * Cp * kLDW2f;          // 2 stages of kHT
  float* part_sh = b1_sh + 2 * kHT;                // kF32Threads
  float* y_sh = w1_sh;                             // after the loop: Cp x kLDOf

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int b = blockIdx.y, t0 = blockIdx.x * kF32Tok;
  const int tcount = min(kF32Tok, Tn - t0);
  const float* xb = x + (size_t)b * C * Tn + t0;
  float* ob = out + (size_t)b * C * Tn + t0;
  const int ntiles = Hp / kHT;
  OTP_PHASE_START;

  // one hidden tile of W1 (kHT rows of Cp), of W2 (Cp rows of kHT) and of b1
  auto load_tile = [&](int i, int stage) {
    const int h0 = i * kHT;
    float* d1 = w1_sh + stage * kHT * LDA;
    for (int e = tid; e < kHT * (Cp / 4); e += kF32Threads) {
      const int r = e / (Cp / 4), ch = e % (Cp / 4);
      cp_async16(d1 + r * LDA + ch * 4, w1 + (size_t)(h0 + r) * Cp + ch * 4);
    }
    float* d2 = w2_sh + stage * Cp * kLDW2f;
    for (int e = tid; e < Cp * (kHT / 4); e += kF32Threads) {
      const int r = e / (kHT / 4), ch = e % (kHT / 4);
      cp_async16(d2 + r * kLDW2f + ch * 4, w2 + (size_t)r * Hp + h0 + ch * 4);
    }
    if (tid < kHT / 4) cp_async16(b1_sh + stage * kHT + tid * 4, b1 + h0 + tid * 4);
    cp_async_commit();
  };
  load_tile(0, 0);
  OTP_PHASE(0);
  {
    // the LN in f32, two threads a token, each holding half the channels in
    // registers (read straight from x: lanes are neighbouring tokens)
    const int t = tid % kF32Tok, half = tid / kF32Tok;
    const bool live = t < tcount;
    float v[PER];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = half + 2 * i;
      v[i] = (live && c < C) ? __ldg(xb + (size_t)c * Tn + t) : 0.f;
      s += v[i];
    }
    part_sh[tid] = s;
    __syncthreads();
    const float mu = (part_sh[t] + part_sh[t + kF32Tok]) / C;
    __syncthreads();
    float var = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i)
      if (half + 2 * i < C) {
        const float r = v[i] - mu;
        var += r * r;
      }
    part_sh[tid] = var;
    __syncthreads();
    const float sd = sqrtf((part_sh[t] + part_sh[t + kF32Tok]) / C + 1e-5f);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = half + 2 * i;
      xn_sh[t * LDA + c] = (live && c < C) ? (v[i] - mu) / sd * lnw[c] + lnb[c] : 0.f;
    }
  }
  OTP_PHASE(1);

  float acc[KC][4];
#pragma unroll
  for (int j = 0; j < KC; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const float* arow = xn_sh + warp * 16 * LDA + a_off_f32(lane, LDA);

  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {
      load_tile(i + 1, (i + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    OTP_PHASE(2);
    const float* w1s = w1_sh + (i & 1) * kHT * LDA;
    const float* w2s = w2_sh + (i & 1) * Cp * kLDW2f;
    const float* b1s = b1_sh + (i & 1) * kHT;

    // first product: h (16 tokens x kHT hidden) = xn^T @ W1_tile^T
    float h[kHT / 8][4];
#pragma unroll
    for (int j = 0; j < kHT / 8; ++j) h[j][0] = h[j][1] = h[j][2] = h[j][3] = 0.f;
    const float* brow = w1s + bnk_x4_off_f32(lane, LDA);
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      uint32_t a[4], ahi[4], alo[4];
      ldsm_x4(a, arow + kk * 8);
      split_tf32_x4(a, ahi, alo);
#pragma unroll
      for (int np = 0; np < kHT / 16; ++np) {
        uint32_t r[4], rhi[4], rlo[4];
        ldsm_x4(r, brow + np * 16 * LDA + kk * 8);
        split_tf32_x4(r, rhi, rlo);
        mma_3xtf32(h[2 * np], ahi, alo, rhi[0], rhi[1], rlo[0], rlo[1]);
        mma_3xtf32(h[2 * np + 1], ahi, alo, rhi[2], rhi[3], rlo[2], rlo[3]);
      }
    }
    OTP_PHASE(3);
    // epilogue in registers.  The C fragment of n8 tile j holds hidden
    // columns 2q and 2q + 1; the A fragment of k step j of the second product
    // wants k positions q and q + 4.  The pack orders W2's hidden columns so
    // that, inside each group of 8, position q holds hidden 2q and position
    // q + 4 hidden 2q + 1 (`ops/cuda/fused_mlp.py::HIDDEN_ORDER`), so the GELU
    // values need no move between lanes.
    uint32_t ghi[kHT / 8][4], glo[kHT / 8][4];
#pragma unroll
    for (int j = 0; j < kHT / 8; ++j) {
      const int hc = j * 8 + 2 * q;
      const float bb0 = b1s[hc], bb1 = b1s[hc + 1];
      split_tf32(gelu_f32(h[j][0] + bb0), ghi[j][0], glo[j][0]);   // token g, hidden 2q
      split_tf32(gelu_f32(h[j][2] + bb0), ghi[j][1], glo[j][1]);   // token g + 8, hidden 2q
      split_tf32(gelu_f32(h[j][1] + bb1), ghi[j][2], glo[j][2]);   // token g, hidden 2q + 1
      split_tf32(gelu_f32(h[j][3] + bb1), ghi[j][3], glo[j][3]);   // token g + 8, 2q + 1
    }
    OTP_PHASE(4);
    // second product: acc (16 tokens x Cp) += gelu @ W2_tile^T
    const float* b2row = w2s + bnk_x4_off_f32(lane, kLDW2f);
#pragma unroll
    for (int s = 0; s < kHT / 8; ++s) {
#pragma unroll
      for (int np = 0; np < KC / 2; ++np) {
        uint32_t r[4], rhi[4], rlo[4];
        ldsm_x4(r, b2row + np * 16 * kLDW2f + s * 8);
        split_tf32_x4(r, rhi, rlo);
        mma_3xtf32(acc[2 * np], ghi[s], glo[s], rhi[0], rhi[1], rlo[0], rlo[1]);
        mma_3xtf32(acc[2 * np + 1], ghi[s], glo[s], rhi[2], rhi[3], rlo[2], rlo[3]);
      }
      if (KC & 1) {
        uint32_t r0, r1, h0, h1, l0, l1;
        ldsm_x2(r0, r1, w2s + bnk_x2_off_f32(lane, kLDW2f) + (KC - 1) * 8 * kLDW2f + s * 8);
        split_tf32(__uint_as_float(r0), h0, l0);
        split_tf32(__uint_as_float(r1), h1, l1);
        mma_3xtf32(acc[KC - 1], ghi[s], glo[s], h0, h1, l0, l1);
      }
    }
    OTP_PHASE(5);
    __syncthreads();   // the next iteration refills this stage; the last frees y_sh
  }

  // y = acc + b2 into the output tile (channels x tokens), then
  // out = x + y with coalesced loads and stores
#pragma unroll
  for (int j = 0; j < KC; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = j * 8 + 2 * q + (e & 1), t = warp * 16 + g + (e >> 1) * 8;
      if (c < C) y_sh[c * kLDOf + t] = acc[j][e] + b2[c];
    }
  }
  __syncthreads();
  const bool vec = tcount == kF32Tok && Tn % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (vec) {
    for (int e = tid; e < C * (kF32Tok / 4); e += kF32Threads) {
      const int c = e / (kF32Tok / 4), ch = e % (kF32Tok / 4);
      const float4 xv = __ldg(reinterpret_cast<const float4*>(xb + (size_t)c * Tn + ch * 4));
      const float4 yv = *reinterpret_cast<const float4*>(y_sh + c * kLDOf + ch * 4);
      *reinterpret_cast<float4*>(ob + (size_t)c * Tn + ch * 4) =
          make_float4(xv.x + yv.x, xv.y + yv.y, xv.z + yv.z, xv.w + yv.w);
    }
  } else {
    for (int i = tid; i < C * kF32Tok; i += kF32Threads) {
      const int c = i / kF32Tok, t = i % kF32Tok;
      if (t < tcount) ob[(size_t)c * Tn + t] = xb[(size_t)c * Tn + t] + y_sh[c * kLDOf + t];
    }
  }
  OTP_PHASE(6);
}

size_t tf32_smem_bytes(int Cp) {
  const size_t lda = Cp + 4;
  return sizeof(float) * (kF32Tok * lda + 2 * kHT * lda + 2 * (size_t)Cp * kLDW2f + 2 * kHT +
                          kF32Threads);
}

template <int KC>
int launch_tf32(const void* x, void* out, const void* lnw, const void* lnb, const void* w1,
                const void* b1, const void* w2, const void* b2, int B, int C, int Hp, int Tn,
                cudaStream_t st) {
  const size_t smem = tf32_smem_bytes(8 * KC);
  cudaFuncSetAttribute(fused_mlp_tf32_kernel<KC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  fused_mlp_tf32_kernel<KC><<<dim3((Tn + kF32Tok - 1) / kF32Tok, B), kF32Threads, smem, st>>>(
      (const float*)x, (float*)out, (const float*)lnw, (const float*)lnb, (const float*)w1,
      (const float*)b1, (const float*)w2, (const float*)b2, C, Hp, Tn);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// wide: C padded past kMaxCp, both dtypes
// ---------------------------------------------------------------------------

constexpr int kWWarps = 16;
constexpr int kWThreads = 32 * kWWarps;   // 512
constexpr int kWTok = 32;                 // tokens a block: two m16 tiles
constexpr int kWHid = 16 * kWWarps;       // hidden rows a tile: 16 a warp
constexpr int kWMaxNJ = 9;                // output n8 tiles a warp: Cp <= 16 x 8 x 9 = 1152
constexpr int kWideMaxCp = 128 * kWMaxNJ;
constexpr int kWLDO = kWTok + 8;          // the output tile's row stride (bf16)
constexpr int kWLDOf = kWTok + 4;         // (f32)

// The wide kernels read their B fragments straight from the weight rows,
// several k positions a load, so the A operand in shared memory keeps its k
// positions in the order those loads deliver them (the sums are unchanged).
// Each map takes an index along the weights' k to its column in the tile:
//   perm_k16  bf16, 8-byte loads: lane q holds k 4q..4q+3 of a k16 step as
//             b0 (mma k 2q, 2q + 1) and b1 (8 + 2q, 9 + 2q);
//   perm_k32  bf16, 16-byte loads: lane q holds k 8q..8q+7 of two k16 steps;
//   perm_k8f  f32 (TF32 m16n8k8), 8-byte loads: lane q holds k 2q as b0 (mma
//             k q) and 2q + 1 as b1 (q + 4).
__device__ __forceinline__ int perm_k16(int k) {
  const int c = k & 15, q = c >> 2, v = c & 3;
  return (k & ~15) | ((v >> 1) << 3) | (q << 1) | (v & 1);
}
__device__ __forceinline__ int perm_k32(int k) {
  const int c = k & 31, q = c >> 3, v = c & 7;
  return (k & ~31) | ((v >> 2) << 4) | (((v >> 1) & 1) << 3) | (q << 1) | (v & 1);
}
__device__ __forceinline__ int perm_k8f(int k) {
  const int c = k & 7;
  return (k & ~7) | ((c & 1) << 2) | (c >> 1);
}

// LN_C of the block's tokens into xn (tokens x channels, row stride ld,
// channel c at column perm_k16(c) in bf16, perm_k8f(c) in f32: the first
// product's order), rounded to T, zero for padded channels and tokens past
// tcount.  Lanes are
// tokens, warps stride the channels; the statistics in JAX's order (the
// mean, then the mean of the squared residual), the warps' partial sums
// added in warp order; the plain version's division.
template <typename T>
__device__ __forceinline__ void wide_ln_tile(const T* __restrict__ xb, int C, int Cp, int Tn,
                                             int tcount, const float* __restrict__ lnw,
                                             const float* __restrict__ lnb, T* xn, int ld,
                                             float* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool live = lane < tcount;
  float s = 0.f;
  if (live)
    for (int c = warp; c < C; c += kWWarps) s += to_f<T>(xb[(size_t)c * Tn + lane]);
  part[warp * 32 + lane] = s;
  __syncthreads();
  float mu = 0.f;
#pragma unroll
  for (int i = 0; i < kWWarps; ++i) mu += part[i * 32 + lane];
  mu /= C;
  __syncthreads();
  float var = 0.f;
  if (live)
    for (int c = warp; c < C; c += kWWarps) {
      const float r = to_f<T>(xb[(size_t)c * Tn + lane]) - mu;
      var += r * r;
    }
  part[warp * 32 + lane] = var;
  __syncthreads();
  var = 0.f;
#pragma unroll
  for (int i = 0; i < kWWarps; ++i) var += part[i * 32 + lane];
  const float sd = sqrtf(var / C + 1e-5f);
  for (int c = warp; c < Cp; c += kWWarps) {
    float v = 0.f;
    if (live && c < C)
      v = __fadd_rn(__fmul_rn(__fdiv_rn(to_f<T>(xb[(size_t)c * Tn + lane]) - mu, sd), lnw[c]),
                    lnb[c]);
    xn[lane * ld + (sizeof(T) == 2 ? perm_k16(c) : perm_k8f(c))] = from_f<T>(v);
  }
  __syncthreads();
}

// bf16, C padded past 160.  A block of 16 warps owns 32 tokens with all C
// channels: the LN output (tokens x Cp) sits in shared memory, and the
// hidden dimension goes in tiles of 256, each warp computing 16 hidden rows
// of the first product for both token tiles, their GELU rounded into a
// shared tile (tokens x 256), then every warp the second product for its
// output n8 tiles (warp, warp + 16, ...; NJ of them, a template parameter)
// over the whole tile, its f32 accumulators in registers across all hidden
// tiles.  Each weight element is used by one warp of the block, so the B
// fragments come straight from L2 and never pass through shared memory: 8
// bytes a lane (one k16 step) in the first product, 16 (two k16 steps) in
// the second, the A tiles' columns in the matching order (`perm_k16`,
// `perm_k32`).  The output goes back through shared memory for coalesced
// stores of x + y.  Rounding points as the narrow kernel.
template <int NJ>
__global__ void __launch_bounds__(kWThreads, 1)
fused_mlp_wide_tc_kernel(const bf16* __restrict__ x, bf16* __restrict__ out,
                         const float* __restrict__ lnw, const float* __restrict__ lnb,
                         const bf16* __restrict__ w1, const float* __restrict__ b1,
                         const bf16* __restrict__ w2, const float* __restrict__ b2, int C,
                         int Cp, int Hp, int Tn) {
  constexpr int LDG = kWHid + 8;
  const int LDN = Cp + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xn_sh = reinterpret_cast<bf16*>(smem);   // kWTok x LDN: LN_C(x)^T
  bf16* g_sh = xn_sh + kWTok * LDN;              // kWTok x LDG: the GELU tile
  float* part_sh = reinterpret_cast<float*>(g_sh + kWTok * LDG);   // kWWarps x 32
  bf16* o_sh = reinterpret_cast<bf16*>(smem);    // after the hidden loop: Cp x kWLDO

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int b = blockIdx.y, t0 = blockIdx.x * kWTok;
  const int tcount = min(kWTok, Tn - t0);
  const bf16* xb = x + (size_t)b * C * Tn + t0;
  bf16* ob = out + (size_t)b * C * Tn + t0;
  wide_ln_tile(xb, C, Cp, Tn, tcount, lnw, lnb, xn_sh, LDN, part_sh);

  float acc[NJ][2][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      acc[j][mi][0] = acc[j][mi][1] = acc[j][mi][2] = acc[j][mi][3] = 0.f;

  for (int h0 = 0; h0 < Hp; h0 += kWHid) {
    const int hv = min(kWHid, Hp - h0);   // a multiple of 32
    if (16 * warp < hv) {
      // first product: h (32 tokens x this warp's 16 hidden) = xn^T @ W1_rows^T
      float h[2][2][4] = {};
      const bf16* xa = xn_sh + a_off(lane, LDN);
      const bf16* wr = w1 + (size_t)(h0 + 16 * warp + g) * Cp + 4 * q;
#pragma unroll 4
      for (int kk = 0; kk < Cp / 16; ++kk) {
        uint32_t a0[4], a1[4];
        ldsm_x4(a0, xa + kk * 16);
        ldsm_x4(a1, xa + 16 * LDN + kk * 16);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint2 r =
              __ldg(reinterpret_cast<const uint2*>(wr + (size_t)j * 8 * Cp + kk * 16));
          mma_bf16(h[0][j], a0, r.x, r.y);
          mma_bf16(h[1][j], a1, r.x, r.y);
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int hl = 16 * warp + 8 * j + 2 * q;   // hl, hl + 1: neighbouring columns
          const float bb0 = b1[h0 + hl], bb1 = b1[h0 + hl + 1];
          bf16* dst = g_sh + (mi * 16 + g) * LDG + perm_k32(hl);
          *reinterpret_cast<uint32_t*>(dst) =
              pack_bf16(gelu_pre(h[mi][j][0], bb0), gelu_pre(h[mi][j][1], bb1));
          *reinterpret_cast<uint32_t*>(dst + 8 * LDG) =
              pack_bf16(gelu_pre(h[mi][j][2], bb0), gelu_pre(h[mi][j][3], bb1));
        }
      }
    }
    __syncthreads();
    // second product: acc (32 tokens x this warp's n8 tiles) += gelu @ W2_tile^T
    const bf16* ga = g_sh + a_off(lane, LDG);
    for (int s = 0; s < hv / 32; ++s) {   // two k16 steps a 16-byte weight load
      uint32_t a[2][2][4];                // [k16 step][m16 tile]
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        ldsm_x4(a[st][0], ga + s * 32 + st * 16);
        ldsm_x4(a[st][1], ga + 16 * LDG + s * 32 + st * 16);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int nt = warp + kWWarps * j;
        if (nt * 8 < Cp) {
          const uint4 r = __ldg(reinterpret_cast<const uint4*>(
              w2 + (size_t)(nt * 8 + g) * Hp + h0 + s * 32 + 8 * q));
          mma_bf16(acc[j][0], a[0][0], r.x, r.y);
          mma_bf16(acc[j][1], a[0][1], r.x, r.y);
          mma_bf16(acc[j][0], a[1][0], r.z, r.w);
          mma_bf16(acc[j][1], a[1][1], r.z, r.w);
        }
      }
    }
    __syncthreads();   // the next tile overwrites g_sh; the last frees o_sh
  }

  // y = rnd(rnd(acc) + b2) into the output tile, then out = rnd(x + y)
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int nt = warp + kWWarps * j;
    if (nt * 8 >= Cp) continue;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * q + (e & 1), t = mi * 16 + g + (e >> 1) * 8;
        if (c < C) o_sh[c * kWLDO + t] = __float2bfloat16_rn(rnd_bf(rnd_bf(acc[j][mi][e]) + b2[c]));
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < C * kWTok; i += kWThreads) {
    const int c = i / kWTok, t = i % kWTok;
    if (t < tcount)
      ob[(size_t)c * Tn + t] = __float2bfloat16_rn(__bfloat162float(xb[(size_t)c * Tn + t]) +
                                                   __bfloat162float(o_sh[c * kWLDO + t]));
  }
}

// f32, C padded past 160: the bf16 wide kernel's plan in split TF32.  The
// LN output and the GELU tile stay f32 in shared memory (ldmatrix gives
// their TF32 A fragments), split where they are read.  The weights come by
// 8-byte loads (one k8 step, `perm_k8f`); the GELU value of a hidden unit
// goes to the tile column that meets its W2 pack column (`HIDDEN_ORDER`:
// hidden 2k of a group of 8 at column k, 2k + 1 at k + 4).  No rounding
// points of bf16, as the narrow kernel.
template <int NJ>
__global__ void __launch_bounds__(kWThreads, 1)
fused_mlp_wide_tf32_kernel(const float* __restrict__ x, float* __restrict__ out,
                           const float* __restrict__ lnw, const float* __restrict__ lnb,
                           const float* __restrict__ w1, const float* __restrict__ b1,
                           const float* __restrict__ w2, const float* __restrict__ b2, int C,
                           int Cp, int Hp, int Tn) {
  constexpr int LDG = kWHid + 4;                 // 4 mod 8: ldmatrix without conflicts
  const int LDA = Cp + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* xn_sh = reinterpret_cast<float*>(smem);   // kWTok x LDA: LN_C(x)^T
  float* g_sh = xn_sh + kWTok * LDA;               // kWTok x LDG: the GELU tile
  float* part_sh = g_sh + kWTok * LDG;             // kWWarps x 32
  float* o_sh = xn_sh;                             // after the hidden loop: Cp x kWLDOf

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int b = blockIdx.y, t0 = blockIdx.x * kWTok;
  const int tcount = min(kWTok, Tn - t0);
  const float* xb = x + (size_t)b * C * Tn + t0;
  float* ob = out + (size_t)b * C * Tn + t0;
  wide_ln_tile(xb, C, Cp, Tn, tcount, lnw, lnb, xn_sh, LDA, part_sh);

  float acc[NJ][2][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      acc[j][mi][0] = acc[j][mi][1] = acc[j][mi][2] = acc[j][mi][3] = 0.f;

  for (int h0 = 0; h0 < Hp; h0 += kWHid) {
    const int hv = min(kWHid, Hp - h0);
    if (16 * warp < hv) {
      float h[2][2][4] = {};
      const float* xa = xn_sh + a_off_f32(lane, LDA);
      const float* wr = w1 + (size_t)(h0 + 16 * warp + g) * Cp + 2 * q;
#pragma unroll 2
      for (int kk = 0; kk < Cp / 8; ++kk) {
        uint32_t ahi[2][4], alo[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          uint32_t a[4];
          ldsm_x4(a, xa + mi * 16 * LDA + kk * 8);
          split_tf32_x4(a, ahi[mi], alo[mi]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float2 r =
              __ldg(reinterpret_cast<const float2*>(wr + (size_t)j * 8 * Cp + kk * 8));
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(r.x, bh0, bl0);
          split_tf32(r.y, bh1, bl1);
          mma_3xtf32(h[0][j], ahi[0], alo[0], bh0, bh1, bl0, bl1);
          mma_3xtf32(h[1][j], ahi[1], alo[1], bh0, bh1, bl0, bl1);
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // hidden hl sits in W2's pack column col (`HIDDEN_ORDER`), which
            // the 8-byte loads deliver at k position perm_k8f(col)
            const int hl = 16 * warp + 8 * j + 2 * q + (e & 1);
            const int col = (hl & ~7) | ((hl & 1) << 2) | ((hl & 7) >> 1);
            g_sh[(mi * 16 + g + (e >> 1) * 8) * LDG + perm_k8f(col)] =
                gelu_f32(h[mi][j][e] + b1[h0 + hl]);
          }
        }
      }
    }
    __syncthreads();
    const float* ga = g_sh + a_off_f32(lane, LDG);
    for (int s = 0; s < hv / 8; ++s) {
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        uint32_t a[4];
        ldsm_x4(a, ga + mi * 16 * LDG + s * 8);
        split_tf32_x4(a, ahi[mi], alo[mi]);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int nt = warp + kWWarps * j;
        if (nt * 8 < Cp) {
          const float2 r = __ldg(reinterpret_cast<const float2*>(
              w2 + (size_t)(nt * 8 + g) * Hp + h0 + s * 8 + 2 * q));
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(r.x, bh0, bl0);
          split_tf32(r.y, bh1, bl1);
          mma_3xtf32(acc[j][0], ahi[0], alo[0], bh0, bh1, bl0, bl1);
          mma_3xtf32(acc[j][1], ahi[1], alo[1], bh0, bh1, bl0, bl1);
        }
      }
    }
    __syncthreads();
  }

  // y = acc + b2 into the output tile, then out = x + y
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int nt = warp + kWWarps * j;
    if (nt * 8 >= Cp) continue;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * q + (e & 1), t = mi * 16 + g + (e >> 1) * 8;
        if (c < C) o_sh[c * kWLDOf + t] = acc[j][mi][e] + b2[c];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < C * kWTok; i += kWThreads) {
    const int c = i / kWTok, t = i % kWTok;
    if (t < tcount) ob[(size_t)c * Tn + t] = xb[(size_t)c * Tn + t] + o_sh[c * kWLDOf + t];
  }
}

size_t wide_smem_bytes(int Cp, int dtype) {
  const size_t el = dtype == 1 ? sizeof(bf16) : sizeof(float), pad = 16 / el;
  const size_t tiles = el * kWTok * (Cp + pad + kWHid + pad) + sizeof(float) * 32 * kWWarps;
  const size_t out = el * (size_t)Cp * (dtype == 1 ? kWLDO : kWLDOf);
  return tiles > out ? tiles : out;
}

template <int NJ>
int launch_wide(const void* x, void* out, const void* lnw, const void* lnb, const void* w1,
                const void* b1, const void* w2, const void* b2, int B, int C, int Cp, int Hp,
                int Tn, int dtype, cudaStream_t st) {
  const size_t smem = wide_smem_bytes(Cp, dtype);
  const dim3 grid((Tn + kWTok - 1) / kWTok, B);
  if (dtype == 1) {
    cudaFuncSetAttribute(fused_mlp_wide_tc_kernel<NJ>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    fused_mlp_wide_tc_kernel<NJ><<<grid, kWThreads, smem, st>>>(
        (const bf16*)x, (bf16*)out, (const float*)lnw, (const float*)lnb, (const bf16*)w1,
        (const float*)b1, (const bf16*)w2, (const float*)b2, C, Cp, Hp, Tn);
  } else {
    cudaFuncSetAttribute(fused_mlp_wide_tf32_kernel<NJ>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    fused_mlp_wide_tf32_kernel<NJ><<<grid, kWThreads, smem, st>>>(
        (const float*)x, (float*)out, (const float*)lnw, (const float*)lnb, (const float*)w1,
        (const float*)b1, (const float*)w2, (const float*)b2, C, Cp, Hp, Tn);
  }
  return (int)cudaGetLastError();
}

int dispatch_wide(const void* x, void* out, const void* lnw, const void* lnb, const void* w1,
                  const void* b1, const void* w2, const void* b2, int B, int C, int Cp, int Hp,
                  int Tn, int dtype, cudaStream_t st) {
  switch ((Cp + 127) / 128) {
#define OTP_NJ(K) \
  case K: return launch_wide<K>(x, out, lnw, lnb, w1, b1, w2, b2, B, C, Cp, Hp, Tn, dtype, st);
    OTP_NJ(2) OTP_NJ(3) OTP_NJ(4) OTP_NJ(5) OTP_NJ(6) OTP_NJ(7) OTP_NJ(8) OTP_NJ(9)
#undef OTP_NJ
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// f32.  x, out: (B, C, T).  lnw/lnb: (C,).  w1: (Hp, Cp), b1: (Hp,),
// w2: (Cp, Hp) with its hidden columns in `HIDDEN_ORDER` inside each group of
// 8, b2: (Cp,), zero-padded, w2/b2 with the drop-path scale folded in
// (`pack_mlp_weights`).  Cp: a multiple of 8 in [C, C + 8), at most 1152 (past
// 160 the wide kernel); Hp: a multiple of 32.
extern "C" int otp_fused_mlp_f32(const void* x, void* out, const void* lnw, const void* lnb,
                                 const void* w1, const void* b1, const void* w2,
                                 const void* b2, int B, int C, int Cp, int Hp, int Tn,
                                 void* stream) {
  if (Cp % 8 || Cp < C || Cp >= C + 8 || Cp > kWideMaxCp || Hp % kHT || Hp <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (Cp > kMaxCp) return dispatch_wide(x, out, lnw, lnb, w1, b1, w2, b2, B, C, Cp, Hp, Tn, 0, st);
  switch (Cp / 8) {
#define OTP_KC(K) \
  case K: return launch_tf32<K>(x, out, lnw, lnb, w1, b1, w2, b2, B, C, Hp, Tn, st);
    OTP_KC(1) OTP_KC(2) OTP_KC(3) OTP_KC(4) OTP_KC(5) OTP_KC(6) OTP_KC(7)
    OTP_KC(8) OTP_KC(9) OTP_KC(10) OTP_KC(11) OTP_KC(12) OTP_KC(13) OTP_KC(14)
    OTP_KC(15) OTP_KC(16) OTP_KC(17) OTP_KC(18) OTP_KC(19) OTP_KC(20)
#undef OTP_KC
  }
  return (int)cudaErrorInvalidValue;
}

// bf16.  x, out: (B, C, T) bf16.  lnw/lnb: (C,) f32.  w1: (Hp, Cp) bf16,
// b1: (Hp,) f32, w2: (Cp, Hp) bf16, b2: (Cp,) f32, zero-padded, the biases
// already rounded to bf16 (`pack_mlp_weights`).  Cp: a multiple of 16 in
// [C, C + 16), at most 1152 (past 160 the wide kernel); Hp: a multiple of 32.
extern "C" int otp_fused_mlp_tc(const void* x, void* out, const void* lnw, const void* lnb,
                                const void* w1, const void* b1, const void* w2, const void* b2,
                                int B, int C, int Cp, int Hp, int Tn, void* stream) {
  if (Cp % 16 || Cp < C || Cp >= C + 16 || Cp > kWideMaxCp || Hp % kHT || Hp <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (Cp > kMaxCp) return dispatch_wide(x, out, lnw, lnb, w1, b1, w2, b2, B, C, Cp, Hp, Tn, 1, st);
  switch (Cp / 16) {
#define OTP_KC(K) \
  case K: return launch_tc<K>(x, out, lnw, lnb, w1, b1, w2, b2, B, C, Hp, Tn, st);
    OTP_KC(1) OTP_KC(2) OTP_KC(3) OTP_KC(4) OTP_KC(5)
    OTP_KC(6) OTP_KC(7) OTP_KC(8) OTP_KC(9) OTP_KC(10)
#undef OTP_KC
  }
  return (int)cudaErrorInvalidValue;
}
