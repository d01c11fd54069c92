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
// Wide (`otp_fused_mlp_wide`): C padded past 160, up to 1152 (the temporal
// encoders are 8 x joints wide: 1064 at 133 joints).  There W1 and W2 are
// 18 MB in bf16 (the Pallas kernel keeps them in VMEM; an SM has 227 KB),
// so the two products run as tiled matrix products on Hopper's `wgmma`, fed
// by TMA (`hopper_gemm.cuh`: 128 x 128 output tiles, a ring of stages, a
// producer warp and two consumer warpgroups), through scratch in device
// memory:
//   (a) `wide_ln_kernel`: LN_C(x) written token-major, (B T) x Cp, the
//       first product's A operand (K = C contiguous);
//   (b) G = gelu(xn W1^T + b1), the bias and GELU in the epilogue, G
//       rounded to the compute dtype (JAX's rounding point) and stored
//       token-major, (B T) x Hp;
//   (c) out = x + rnd(rnd(G W2^T) + b2), the epilogue going through shared
//       memory so that x is read and out written along T.
// A weight byte fetched from L2 serves the 128 tokens of a tile (the narrow
// kernels' 48, the first wide design's 32).  G's round trip is 235 MB in
// bf16 at (B, C, T) = (2, 1064, 6912), about 0.07 ms of HBM against the
// 0.253 ms operations bound.  f32 keeps split TF32: the weights are split
// into hi and lo by `otp_hg::split_tf32_kernel` once a call, the LN output and G
// where they are written, and every k8 step runs three `wgmma` passes (tf32
// operands must be K-major, which every operand here is).  The f32 pack
// keeps W2's hidden columns in order past 160 channels (`HIDDEN_ORDER` is
// the narrow kernel's).  Bound at (2, 1064, 6912), hidden 4256: 250 GFLOP at
// 989 TFLOP/s, 0.253 ms, against 59 MB (0.018 ms), so operations; f32 three
// TF32 passes, 1.52 ms.
#include "common.cuh"
#include "hopper_gemm.cuh"
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
// wide: C padded past kMaxCp, both dtypes, two products on `hopper_gemm.cuh`
// ---------------------------------------------------------------------------

constexpr int kWideMaxCp = 1152;   // the gate's limit (`fused_mlp.WIDE_MAX_CHANNELS`)
constexpr int kLnWarps = 8;        // wide_ln_kernel: 32 tokens a block, warps over C
constexpr int kLnChunk = 64;       // channels a token-major store pass

// (a) LN_C of 32 tokens a block into xn (rows b T + t, Cp values a row:
// the first product's A operand, token-major), rounded to T (f32: split
// hi / lo), zero in the padded channels.  Lanes are tokens and warps stride
// the channels, four loads in flight a warp; the statistics in JAX's order
// (the mean, then the mean of the squared residual), the warps' partial sums
// added in warp order; the plain version's division; the output through
// shared memory in chunks of channels (`otp_hg::store_token_tile`).  x is
// read three times (L2).
template <typename T>
__global__ void __launch_bounds__(32 * kLnWarps)
wide_ln_kernel(const T* __restrict__ x, const float* __restrict__ lnw,
               const float* __restrict__ lnb, T* __restrict__ xn, size_t lo_off, int C, int Cp,
               int Tn) {
  __shared__ float part[kLnWarps][32];
  __shared__ float tile[kLnChunk * otp_hg::kTileLd];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y, t0 = blockIdx.x * 32;
  const int tcount = min(32, Tn - t0);
  const bool live = lane < tcount;
  const T* xb = x + (size_t)b * C * Tn + t0 + lane;
  float s = 0.f;
  if (live) {
#pragma unroll 4
    for (int c = warp; c < C; c += kLnWarps) s += to_f<T>(xb[(size_t)c * Tn]);
  }
  part[warp][lane] = s;
  __syncthreads();
  float mu = 0.f;
#pragma unroll
  for (int i = 0; i < kLnWarps; ++i) mu += part[i][lane];
  mu /= C;
  __syncthreads();
  float var = 0.f;
  if (live) {
#pragma unroll 4
    for (int c = warp; c < C; c += kLnWarps) {
      const float r = to_f<T>(xb[(size_t)c * Tn]) - mu;
      var += r * r;
    }
  }
  part[warp][lane] = var;
  __syncthreads();
  var = 0.f;
#pragma unroll
  for (int i = 0; i < kLnWarps; ++i) var += part[i][lane];
  const float sd = sqrtf(var / C + 1e-5f);
  for (int c0 = 0; c0 < Cp; c0 += kLnChunk) {
    for (int i = warp; i < kLnChunk; i += kLnWarps) {
      const int c = c0 + i;
      float v = 0.f;
      if (live && c < C)
        v = __fadd_rn(__fmul_rn(__fdiv_rn(to_f<T>(xb[(size_t)c * Tn]) - mu, sd), lnw[c]),
                      lnb[c]);
      tile[i * otp_hg::kTileLd + lane] = v;
    }
    __syncthreads();
    otp_hg::store_token_tile<T, kLnChunk>(tile, xn, lo_off, (size_t)b * Tn + t0, Cp, c0, Cp, 0,
                                          tcount, threadIdx.x);
    __syncthreads();
  }
}

// (b) G (rows x Hp, token-major: the second product's A operand) =
// gelu(xn W1^T + b1), rounded as the narrow kernels round it: bf16
// rnd(gelu(rnd(rnd(acc) + b1))), f32 gelu(acc + b1) split hi / lo.
template <typename T>
struct MlpUp {
  T* g;
  size_t lo_off;
  const float* b1;
  int rows, hp, c;
  __device__ otp_hg::Coords coords(int) const { return {0, 0, 0, 0, c}; }
  __device__ void tile(int, int m0, int n0, int, const float (&acc)[64], uint8_t*,
                       int tid) const {
    otp_hg::store_fragments(acc, tid, [&](int r, int cc, float v0, float v1) {
      const int m = m0 + r, n = n0 + cc;   // Hp is a multiple of 32: n + 1 < Hp too
      if (m >= rows || n >= hp) return;
      T* p = g + (size_t)m * hp + n;
      if constexpr (sizeof(T) == 2)
        *reinterpret_cast<uint32_t*>(p) = pack_bf16(gelu_pre(v0, b1[n]), gelu_pre(v1, b1[n + 1]));
      else
        otp_hg::put2<T>(p, lo_off, gelu_f32(v0 + b1[n]), gelu_f32(v1 + b1[n + 1]), true);
    });
  }
};

// (c) out = x + y, y = G W2^T + b2 rounded as the narrow kernels round it
// (bf16 rnd(rnd(acc) + b2), then rnd(x + y); f32 x + (acc + b2)).  The
// accumulators hold tokens x channels; the tile goes through shared memory
// (channels x tokens) so that the loads of x and the stores along T are
// coalesced.
template <typename T>
struct MlpDown {
  const T* x;
  T* out;
  const float* b2;
  int C, Tn, rows, hp;
  __device__ otp_hg::Coords coords(int) const { return {0, 0, 0, 0, hp}; }
  __device__ void tile(int, int m0, int n0, int cw, const float (&acc)[64], uint8_t* scratch,
                       int tid) const {
    constexpr int LD = 64 + 16 / (int)sizeof(T);
    T* ys = reinterpret_cast<T*>(scratch);   // 128 channels x LD tokens
    otp_hg::store_fragments(acc, tid, [&](int r, int cc, float v0, float v1) {
      const int n = n0 + cc;
      const float bb0 = n < C ? b2[n] : 0.f, bb1 = n + 1 < C ? b2[n + 1] : 0.f;
      if constexpr (sizeof(T) == 2) {
        ys[cc * LD + r] = __float2bfloat16_rn(rnd_bf(rnd_bf(v0) + bb0));
        ys[(cc + 1) * LD + r] = __float2bfloat16_rn(rnd_bf(rnd_bf(v1) + bb1));
      } else {
        ys[cc * LD + r] = v0 + bb0;
        ys[(cc + 1) * LD + r] = v1 + bb1;
      }
    });
    otp_hg::named_sync(2 + cw, 128);
    const int warp = tid >> 5, lane = tid & 31;
    size_t base[2];
    bool ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + lane + 32 * h, b = m / Tn;
      ok[h] = m < rows;
      base[h] = (size_t)b * C * Tn + (m - b * Tn);
    }
    // eight channel rows at a time, their 16 loads of x in flight together
    for (int c8 = 0; c8 < otp_hg::kBN / 4; c8 += 8) {
      float xs[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + warp + 4 * (c8 + j);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          xs[j][h] = ok[h] && n < C ? to_f<T>(x[base[h] + (size_t)n * Tn]) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cl = warp + 4 * (c8 + j);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (ok[h] && n0 + cl < C)
            out[base[h] + (size_t)(n0 + cl) * Tn] =
                from_f<T>(xs[j][h] + to_f<T>(ys[cl * LD + lane + 32 * h]));
      }
    }
    otp_hg::named_sync(2 + cw, 128);   // the consumer's next block reuses ys
  }
};

// The wide path on one stream: (f32: the weights split), the LN into xn,
// G = gelu(xn W1^T + b1), out = x + G W2^T + b2.  Scratch in device memory
// (`ops/cuda/fused_mlp.py::wide_plan`): xn (rows x Cp) and G (rows x Hp),
// rows = B T, in f32 each followed by its lo half; f32 wsplit: W1's and
// W2's hi and lo, 4 Hp Cp values.
template <typename T>
int launch_wide(const void* x, void* out, const void* lnw, const void* lnb, const void* w1,
                const void* b1, const void* w2, const void* b2, void* xn, void* g, void* wsplit,
                int B, int C, int Cp, int Hp, int Tn, cudaStream_t st) {
  const int rows = B * Tn;
  const size_t xn_lo = (size_t)rows * Cp, g_lo = (size_t)rows * Hp, w_lo = (size_t)Hp * Cp;
  const T* w1p = static_cast<const T*>(w1);
  const T* w2p = static_cast<const T*>(w2);
  if constexpr (sizeof(T) == 4) {
    float* ws = static_cast<float*>(wsplit);   // W1 hi, W1 lo, W2 hi, W2 lo
    otp_hg::split_weights(w1p, ws, w_lo, (long long)w_lo, st);
    otp_hg::split_weights(w2p, ws + 2 * w_lo, w_lo, (long long)w_lo, st);
    w1p = ws;
    w2p = ws + 2 * w_lo;
  }
  wide_ln_kernel<T><<<dim3((Tn + 31) / 32, B), 32 * kLnWarps, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(lnw), static_cast<const float*>(lnb),
      static_cast<T*>(xn), xn_lo, C, Cp, Tn);
  otp_hg::Operand a, b;
  int err;
  if ((err = otp_hg::make_operand<T>(&a, static_cast<const T*>(xn), xn_lo, C, rows, Cp)) ||
      (err = otp_hg::make_operand<T>(&b, w1p, w_lo, C, Hp, Cp)))
    return err;
  const MlpUp<T> up{static_cast<T*>(g), g_lo, static_cast<const float*>(b1), rows, Hp, C};
  if ((err = otp_hg::launch<T>(a, b, up, rows, Hp, 1, st))) return err;
  if ((err = otp_hg::make_operand<T>(&a, static_cast<const T*>(g), g_lo, Hp, rows, Hp)) ||
      (err = otp_hg::make_operand<T>(&b, w2p, w_lo, Hp, C, Hp)))
    return err;
  const MlpDown<T> down{static_cast<const T*>(x), static_cast<T*>(out),
                        static_cast<const float*>(b2), C, Tn, rows, Hp};
  return otp_hg::launch<T>(a, b, down, rows, C, 1, st);
}

}  // namespace

// f32.  x, out: (B, C, T).  lnw/lnb: (C,).  w1: (Hp, Cp), b1: (Hp,),
// w2: (Cp, Hp) with its hidden columns in `HIDDEN_ORDER` inside each group of
// 8, b2: (Cp,), zero-padded, w2/b2 with the drop-path scale folded in
// (`pack_mlp_weights`).  Cp: a multiple of 8 in [C, C + 8), at most 160
// (past it `otp_fused_mlp_wide`); Hp: a multiple of 32.
extern "C" int otp_fused_mlp_f32(const void* x, void* out, const void* lnw, const void* lnb,
                                 const void* w1, const void* b1, const void* w2,
                                 const void* b2, int B, int C, int Cp, int Hp, int Tn,
                                 void* stream) {
  if (Cp % 8 || Cp < C || Cp >= C + 8 || Cp > kMaxCp || Hp % kHT || Hp <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
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
// [C, C + 16), at most 160 (past it `otp_fused_mlp_wide`); Hp: a multiple
// of 32.
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

// Either dtype (0 = f32, 1 = bf16), C padded past 160 up to 1152: the
// arguments of the entries above in the wide pack's layout (f32: w2's hidden
// columns in order), and the scratch of `launch_wide` (`fused_mlp.py::
// wide_plan`; wsplit unused in bf16).  Cp: C rounded up to 16 (bf16) or 8.
extern "C" int otp_fused_mlp_wide(const void* x, void* out, const void* lnw, const void* lnb,
                                  const void* w1, const void* b1, const void* w2,
                                  const void* b2, void* xn, void* g, void* wsplit, int B, int C,
                                  int Cp, int Hp, int Tn, int dtype, void* stream) {
  const int align = dtype == 1 ? 16 : 8;
  if ((dtype != 0 && dtype != 1) || Cp % align || Cp < C || Cp >= C + align || Cp <= kMaxCp ||
      Cp > kWideMaxCp || Hp % kHT || Hp <= 0 || B < 1 || Tn < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  OTP_DISPATCH(dtype, return launch_wide<T>(x, out, lnw, lnb, w1, b1, w2, b2, xn, g, wsplit, B,
                                            C, Cp, Hp, Tn, st));
  return (int)cudaErrorInvalidValue;
}
