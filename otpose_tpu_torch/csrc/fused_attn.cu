// Fused channel attention for a stride-1 MaskedMHCA block on (B, C, T).
//
// Replaces: otpose_tpu/ops/pallas/fused_attn.py::fused_attn_ct (Pallas kernel
// `_kernel`, pallas_call in `_fused_attn_jit`).  Computes
//
//   n      = LN_C(x)                                    (ln1)
//   p      = Wp @ LN_C(dwconv_k3(n, dw_p)) + bp          p in {q, k, v}
//   S_h    = round(q_h * round(1/sqrt(hs))) @ k_h^T     summed over all of T
//   att_h  = softmax(round(S_h)) in f32, rounded
//   out_h  = att_h @ v_h                                pre-scramble (B, C, T)
//
// What bounds it on the H100: per flagship launch (B = 16, C = 136, two
// heads of 68, T = 6912, bf16) it must move 60 MB (read x, write out: 0.018
// ms at 3.35 TB/s) and do 16.4 GFLOP (three C x C projections over B*T
// tokens, same-head scores, att @ v: 0.017 ms on the bf16 tensor cores), so
// the two bounds are about even.
//
// The TPU kernel ran its grid in order, parked all of v in VMEM and summed S
// in a scratch across T chunks.  Blocks here run in parallel and in no
// order, and v (C x T x 2 B = 1.9 MB per item) cannot stay on chip, so the
// work is three kernels on one stream:
//   1. qkv_scores: block (split, b) walks T chunks.  It loads the chunk with
//      a one-token halo on each side, applies ln1 to the halo columns too
//      (the depthwise conv sees the normalised row, zero-padded at the ends
//      of T), runs the depthwise convs with the model's three-step rounding
//      and their LayerNorms, builds q, k, v, writes v to a bf16 scratch in
//      device memory and adds the chunk's same-head scores to a per-block
//      sum.  At the end each block stores its sum as its split's partial of
//      S, and a reduction kernel adds the partials in split order (a fixed
//      order, so a call gives the same bits every time; f32 atomics into one
//      S, the first design, summed in the order the blocks finished).
//   2. softmax: one thread per row of S.
//   3. att_v: block (T tile, b) reads v back and writes att @ v.
//
// bf16 (`*_tc_kernel`, `attn_softmax_kernel`): the products run on the tensor
// cores (mma.sync m16n8k16, bf16 in, f32 accumulators, ldmatrix operands).
//   - The three projection weights come packed once per model block
//     (`ops/cuda/fused_attn.py::pack_attn_weights`): (3, Cp, Cp) bf16 with C
//     zero-padded to Cp, a multiple of 16 (136 -> 144).  A phase-1 block
//     copies them into shared memory once with cp.async (131 KB at C = 136)
//     and keeps them for all its chunks, beside the per-channel LN and conv
//     parameters (read for every element; through L1 they were the largest
//     single cost of the front).  That is 186 KB at C = 136, one block of 16
//     warps per SM, and the wrapper launches about one block per SM
//     (nsplit = 132 / B blocks per item, each walking every nsplit-th chunk).
//   - A chunk is 32 tokens.  Its x body arrives by cp.async (the halo tokens
//     by plain loads), issued while the previous chunk is still in its
//     projections.  The scalar front runs as column passes: the threads of a
//     token column (8 for ln1, 16 for each conv + LN) hold their channels in
//     registers, reduce the LN statistics with shuffles and store once, so
//     the conv output never makes a round trip through shared memory.  The
//     LN multiplies by a reciprocal of the deviation taken once a column.
//     16 warps, not 8, because this front is bound by latency, not by issue.
//   - Projections: P (Cp x 32) = Wp @ Y.  Warp w < Cp / 16 owns m16 row tile
//     w and all four n8 token tiles, so each weight fragment is read from
//     shared memory once a chunk; epilogue rnd(rnd(acc) + pb), q then times
//     the bf16 1/sqrt(hs) and rounded.  Tokens past T get q = k = 0, so they
//     add nothing to S.
//   - Scores: S_h (hs x hs) += q_h k_h^T with K = tokens.  Only same-head
//     blocks are computed, hs padded to m16 x n8 tiles (68 -> 80 x 72); the
//     tiles are dealt round-robin to the warps, whose accumulators stay in
//     registers across all of the block's chunks.  Padded rows and columns
//     are never stored.
//   - Softmax: S rounded to bf16, then f32, over the hs real columns only, so
//     the padded columns count as -inf (a zero-padded score column would add
//     exp(0 - m) to every row's sum).  att is rounded to bf16 and stored with
//     its columns zero-padded to a multiple of 16, the K of the next product.
//   - att @ v: out_h (hs x 64 tokens) = att_h @ v_h per block, one n8 token
//     tile per warp, staged through shared memory for coalesced stores.
//   - v is stored, not recomputed: the scratch costs 60 MB of traffic (0.018
//     ms at the bound); recomputing it in phase 3 would read x again (30 MB,
//     0.009 ms) and redo ln1, the depthwise conv, its LN and the 4.1 GFLOP
//     projection, whose scalar front is the slow part of phase 1.
// f32 (`qkv_scores_tf32_kernel`, `attn_softmax_f32_kernel`,
// `att_v_tf32_kernel`): the same three phases in split TF32 (mma.sync
// m16n8k8, each operand split as hi + lo, three passes lo hi + hi lo + hi hi
// into f32 accumulators, `csrc/mma.cuh`), to f32 accuracy: the JAX package's
// f32 path asks its matrix unit for the highest precision, and the scores
// sum over all of T with |S| in the hundreds.  Bound on the H100: three TF32
// passes of the 16.4 GFLOP at 495 TFLOP/s, 0.099 ms, against 120 MB of f32
// traffic (0.036 ms), so operations.
//   - Weights packed once: (3, Cp, Cp) f32 with C zero-padded to Cp, a
//     multiple of 8 (the TF32 mma depth: 136 stays 136), split where they
//     are loaded.  The three f32 projections would take 228 KB of shared
//     memory at C = 136 (227 KB a block), so one projection's weights are
//     resident at a time, the next streaming from L2 by cp.async while the
//     depthwise conv and LN run (see `qkv_scores_tf32_kernel`).
//   - The scalar front is the bf16 kernel's column passes on f32 tiles; the
//     conv is the plain version's three products and two sums, unfused.
//   - v is an f32 scratch in device memory, as in the plain f32 path; the
//     softmax is f32 with att's columns zero-padded to kp = hs rounded up to
//     8, the K of att @ v.
// Wide (`otp_fused_attn_wide`), both dtypes: the shapes the kernels above
// do not take, C padded past 160, or in f32 one head of more than 136
// channels (at 133 joints the temporal encoders are C = 1064 in two heads
// of 532, the flow encoder one head of 133).  There the three projection
// weights are 3 Cp^2 (6.9 MB in bf16 at C = 1064) and one head's scores 34
// x 67 m16n8 tiles, so nothing per C stays on chip: each step writes its
// result to device memory in the layout the next product wants, and the
// products run on Hopper's `wgmma` fed by TMA (`hopper_gemm.cuh`, the
// mainloop the wide MLP shares; every operand K-major, so f32 runs there in
// split TF32 too):
//   1. `wide_ln1_kernel` (ln1 into out, free until att @ v) and
//      `wide_conv_ln_kernel` (the three depthwise convs and their LNs),
//      statistics over C in JAX's order, written token-major y (3, B, T,
//      Cp): the projections' B operand;
//   2. the projections, out channels x tokens, with the model's epilogue
//      rounding and q's scale: q and k channel-major (the scores' operands,
//      K = T), v token-major, a head's channels a row (att @ v's B
//      operand, K = the head's channels);
//   3. the scores, q_h k_h^T, split over T (`fused_attn.wide_split`) into f32
//      partials;
//   4. `wide_softmax_kernel`: the partials added in split order, the
//      softmax, one warp a row;
//   5. att @ v into out.
// Rounding points as above; f32: the projection weights split into hi and
// lo once a call, every other operand where it is written.  Bound at (B, C,
// T) = (2, 1064, 6912) in bf16: 125 GFLOP (three C x C projections, scores,
// att @ v) at 989 TFLOP/s, 0.127 ms, against 59 MB of compulsory traffic
// (0.018 ms), so operations; in f32 three TF32 passes, 0.76 ms.
#include "common.cuh"
#include "hopper_gemm.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 256;

// S (the first n floats of s) = the nsplit partials of n floats each, added
// in split order
__global__ void qkv_scores_reduce_kernel(float* __restrict__ s, long long n, int nsplit) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float acc = s[e];
  for (int p = 1; p < nsplit; ++p) acc += s[p * n + e];
  s[e] = acc;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using namespace otp_mma;

constexpr int kWarps = kThreads / 32;
constexpr int kTcTok = 32;               // tokens per chunk in qkv_scores_tc
constexpr int kTcHalo = kTcTok + 2;
constexpr int kLDT = kTcTok + 8;         // row stride of the chunk tiles (80 B)
constexpr int kLDN = kTcTok + 24;        // ln1 tile: halo, body at column 8, halo (112 B)
constexpr int kH0 = 7;                   // its column of the left halo token
constexpr int kMaxCp = 160;
constexpr int kThreads1 = 512;           // qkv_scores_tc: 16 warps hide its latencies
constexpr int kWarps1 = kThreads1 / 32;
constexpr int kHaloPer = (2 * kMaxCp + kThreads1 - 1) / kThreads1;   // halo values a thread fetches
constexpr int kSubs = kThreads1 / kTcTok;       // threads a token column in the conv + LN: 16
constexpr int kChPer = kMaxCp / kSubs;          // channels each of them holds
constexpr int kSubs1 = 8;                       // the same in ln1 (64 columns, 34 used)
constexpr int kChPer1 = kMaxCp / kSubs1;
constexpr int kTokV = 8 * kWarps;        // tokens per block in att_v_tc: 64
constexpr int kLDV = kTokV + 8;          // 144 B
constexpr float kEps = 1e-5f;

__device__ __forceinline__ float rnd_bf(float v) { return rnd<bf16>(v); }

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }

// LayerNorm over C of one tile column whose values SUBS threads hold, the
// thread `sub` channels sub, sub + SUBS, ... in v[]: f32 mean and standard
// deviation combined with shuffles (the SUBS threads are adjacent lanes),
// then (v - mu) * (1 / sd) * w[c] + b[c] (0 where `zero`) stored as D (bf16
// or f32) at dst[c * ld] when `store`.  Every lane of the warp calls it.  The
// reciprocal, taken once a column, keeps an IEEE division (a branchy
// sequence of dependent instructions) out of the per-element work; it moves
// the f32 value by at most an ulp or so before the bf16 rounding.
template <int PER, int SUBS, typename D>
__device__ __forceinline__ void ln_column(const float (&v)[PER], int C, int sub,
                                          const float* __restrict__ w,
                                          const float* __restrict__ b, D* dst, int ld,
                                          bool store, bool zero) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i)
    if (sub + SUBS * i < C) s += v[i];
#pragma unroll
  for (int m = 1; m < SUBS; m <<= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  const float mu = s / C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i)
    if (sub + SUBS * i < C) {
      const float r = v[i] - mu;
      q += r * r;
    }
#pragma unroll
  for (int m = 1; m < SUBS; m <<= 1) q += __shfl_xor_sync(0xffffffffu, q, m);
  const float rs = 1.f / sqrtf(q / C + kEps);
  if (!store) return;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = sub + SUBS * i;
    if (c < C) dst[c * ld] = from_f<D>(zero ? 0.f : (v[i] - mu) * rs * w[c] + b[c]);
  }
}

// SMAX: score tiles (m16 x n8) a warp holds, at least
// ceil(n_head * ceil(hs / 16) * ceil(hs / 8) / kWarps1).
template <int SMAX>
__global__ void __launch_bounds__(kThreads1, 1)
qkv_scores_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ ln1w,
                     const float* __restrict__ ln1b, const float* __restrict__ dw,
                     const float* __restrict__ nw, const float* __restrict__ nb,
                     const bf16* __restrict__ pw, const float* __restrict__ pb,
                     bf16* __restrict__ v_out, float* __restrict__ s_out, int C, int Cp, int Tn,
                     int hs, int n_head, int nsplit, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int LDW = Cp + 8, R = Cp + 16;
  bf16* w_sh = reinterpret_cast<bf16*>(smem);   // 3 x Cp x LDW: Wq, Wk, Wv
  bf16* n_sh = w_sh + 3 * Cp * LDW;             // C x kLDN: ln1(x) with its halo
  bf16* y_sh = n_sh + C * kLDN;                 // Cp x kLDT: LN(dwconv), then v
  bf16* q_sh = y_sh + Cp * kLDT;                // R x kLDT
  bf16* k_sh = q_sh + R * kLDT;                 // R x kLDT
  // the per-channel parameters, read for every element, from shared memory
  float* ln1w_sh = reinterpret_cast<float*>(k_sh + R * kLDT);   // C
  float* ln1b_sh = ln1w_sh + C;                                  // C
  float* nw_sh = ln1b_sh + C;                                    // 3 x C
  float* nb_sh = nw_sh + 3 * C;                                  // 3 x C
  float* pb_sh = nb_sh + 3 * C;                                  // 3 x Cp
  bf16* dw_sh = reinterpret_cast<bf16*>(pb_sh + 3 * Cp);         // 3 x C x 4: 3 taps, 0

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const int b = blockIdx.y;
  const int nchunks = (Tn + kTcTok - 1) / kTcTok;
  const bf16* xb = x + (size_t)b * C * Tn;
  const int MT = Cp / 16;
  const int MTh = (hs + 15) / 16, NTh = (hs + 7) / 8, ntiles = n_head * MTh * NTh;
  const bf16 zero = __float2bfloat16(0.f);

  // A chunk's x: the 32-token body by cp.async where it is whole and its
  // rows 16-byte aligned, the two halo tokens by plain loads into registers.
  // The next chunk is fetched once the depthwise convs have read this one,
  // so its latency hides behind the last LN, the projections and the scores.
  const bool vec = Tn % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  bf16 halo[kHaloPer];
  auto fetch = [&](int chunk) {
    const int t0 = chunk * kTcTok;
    if (vec && t0 + kTcTok <= Tn) {
      for (int e = tid; e < C * (kTcTok / 8); e += kThreads1) {
        const int c = e / (kTcTok / 8), ch = e % (kTcTok / 8);
        cp_async16(n_sh + c * kLDN + kH0 + 1 + ch * 8, xb + (size_t)c * Tn + t0 + ch * 8);
      }
    }
    cp_async_commit();
#pragma unroll
    for (int k = 0; k < kHaloPer; ++k) {
      const int e = tid + k * kThreads1, c = e >> 1;
      const int t = (e & 1) ? t0 + kTcTok : t0 - 1;
      halo[k] = (c < C && t >= 0 && t < Tn) ? xb[(size_t)c * Tn + t] : zero;
    }
  };
  auto land = [&](int chunk) {
    const int t0 = chunk * kTcTok;
    cp_async_wait<0>();
#pragma unroll
    for (int k = 0; k < kHaloPer; ++k) {
      const int e = tid + k * kThreads1, c = e >> 1;
      if (c < C) n_sh[c * kLDN + ((e & 1) ? kH0 + 1 + kTcTok : kH0)] = halo[k];
    }
    if (!(vec && t0 + kTcTok <= Tn)) {
      for (int i = tid; i < C * kTcTok; i += kThreads1) {
        const int c = i / kTcTok, j = i % kTcTok, t = t0 + j;
        n_sh[c * kLDN + kH0 + 1 + j] = t < Tn ? xb[(size_t)c * Tn + t] : zero;
      }
    }
    __syncthreads();
  };

  {
    const int cpr = Cp / 8;
    for (int e = tid; e < 3 * Cp * cpr; e += kThreads1) {
      const int r = e / cpr, ch = e % cpr;
      cp_async16(w_sh + r * LDW + ch * 8, pw + (size_t)r * Cp + ch * 8);
    }
    cp_async_commit();
  }
  for (int i = tid; i < C; i += kThreads1) {
    ln1w_sh[i] = ln1w[i];
    ln1b_sh[i] = ln1b[i];
  }
  for (int i = tid; i < 3 * C; i += kThreads1) {
    nw_sh[i] = nw[i];
    nb_sh[i] = nb[i];
  }
  for (int i = tid; i < 3 * Cp; i += kThreads1) pb_sh[i] = pb[i];
  for (int i = tid; i < 12 * C; i += kThreads1)
    dw_sh[i] = __float2bfloat16((i & 3) == 3 ? 0.f : dw[(i >> 2) * 3 + (i & 3)]);
  // rows past C of y and past Cp of q and k stay zero for the whole kernel
  for (int i = tid; i < Cp * kLDT; i += kThreads1) y_sh[i] = zero;
  for (int i = tid; i < 2 * R * kLDT; i += kThreads1) q_sh[i] = zero;   // q_sh, k_sh
  cp_async_wait<0>();
  __syncthreads();

  float sacc[SMAX][4];
#pragma unroll
  for (int s = 0; s < SMAX; ++s) sacc[s][0] = sacc[s][1] = sacc[s][2] = sacc[s][3] = 0.f;

  if (blockIdx.x < nchunks) fetch(blockIdx.x);
  for (int chunk = blockIdx.x; chunk < nchunks; chunk += nsplit) {
    const int t0 = chunk * kTcTok;
    const int tcount = min(kTcTok, Tn - t0);
    OTP_PHASE_START;
    land(chunk);
    OTP_PHASE(0);
    bf16* nh = n_sh + kH0;                      // column j: token t0 - 1 + j
    {
      // ln1 of the 34 columns: kSubs1 threads a column
      const int j = tid / kSubs1, sub = tid % kSubs1, t = t0 - 1 + j;
      float v[kChPer1];
#pragma unroll
      for (int i = 0; i < kChPer1; ++i) {
        const int c = sub + kSubs1 * i;
        v[i] = (j < kTcHalo && c < C) ? bf(nh[c * kLDN + j]) : 0.f;
      }
      ln_column<kChPer1, kSubs1>(v, C, sub, ln1w_sh, ln1b_sh, nh + j, kLDN, j < kTcHalo,
                                 t < 0 || t >= Tn);
    }
    __syncthreads();
    OTP_PHASE(1);

    for (int p = 0; p < 3; ++p) {
      {
        // depthwise conv with the model's three-step rounding, then its LN:
        // kSubs threads a token column, the conv outputs kept in registers
        const int t = tid / kSubs, sub = tid % kSubs;
        const bf16* dwp = dw_sh + p * C * 4;
        float v[kChPer];
#pragma unroll
        for (int i = 0; i < kChPer; ++i) {
          const int c = min(sub + kSubs * i, C - 1);   // straight-line code; masked below
          const bf16* nr = nh + c * kLDN + t;
          const uint2 d = *reinterpret_cast<const uint2*>(dwp + c * 4);   // the 3 taps
          const float d0 = __uint_as_float(d.x << 16), d1 = __uint_as_float(d.x & 0xffff0000u);
          const float d2 = __uint_as_float(d.y << 16);
          const float a = rnd_bf(rnd_bf(bf(nr[0]) * d0) + rnd_bf(bf(nr[1]) * d1));
          v[i] = sub + kSubs * i < C ? rnd_bf(a + rnd_bf(bf(nr[2]) * d2)) : 0.f;
        }
        ln_column<kChPer, kSubs>(v, C, sub, nw_sh + p * C, nb_sh + p * C, y_sh + t, kLDT, true,
                                 false);
      }
      __syncthreads();
      OTP_PHASE(2);
      if (p == 2 && chunk + nsplit < nchunks) fetch(chunk + nsplit);   // n_sh is free

      // projection: P (Cp x 32 tokens) = Wp @ Y.  Warp w < MT owns m16 row
      // tile w and all four n8 token tiles, so each weight fragment is read
      // from shared memory once a chunk.
      const bf16* wp = w_sh + p * Cp * LDW;
      float pacc[kTcTok / 8][4];
#pragma unroll
      for (int j = 0; j < kTcTok / 8; ++j) pacc[j][0] = pacc[j][1] = pacc[j][2] = pacc[j][3] = 0.f;
      if (warp < MT) {
        const bf16* wa = wp + warp * 16 * LDW + a_off(lane, LDW);
        const bf16* yb = y_sh + bkn_x4_off(lane, kLDT);
#pragma unroll 3
        for (int kk = 0; kk < MT; ++kk) {
          uint32_t a[4], b01[4], b23[4];
          ldsm_x4(a, wa + kk * 16);
          ldsm_x4_trans(b01, yb + kk * 16 * kLDT);
          ldsm_x4_trans(b23, yb + kk * 16 * kLDT + 16);
          mma_bf16(pacc[0], a, b01[0], b01[1]);
          mma_bf16(pacc[1], a, b01[2], b01[3]);
          mma_bf16(pacc[2], a, b23[0], b23[1]);
          mma_bf16(pacc[3], a, b23[2], b23[3]);
        }
      }
      OTP_PHASE(3);
      if (p == 2) __syncthreads();   // v goes to y_sh: every warp has read it
      if (warp < MT) {
        bf16* dst = p == 0 ? q_sh : (p == 1 ? k_sh : y_sh);
#pragma unroll
        for (int j = 0; j < kTcTok / 8; ++j) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int o = warp * 16 + g + hh * 8, tt = j * 8 + 2 * qd;
            const float bias = pb_sh[p * Cp + o];
            float v0 = rnd_bf(rnd_bf(pacc[j][2 * hh]) + bias);
            float v1 = rnd_bf(rnd_bf(pacc[j][2 * hh + 1]) + bias);
            if (p == 0) {
              v0 *= scale;   // rounded by the pack below
              v1 *= scale;
            }
            if (p < 2) {
              if (tt >= tcount) v0 = 0.f;
              if (tt + 1 >= tcount) v1 = 0.f;
            }
            *reinterpret_cast<uint32_t*>(dst + o * kLDT + tt) = pack_bf16(v0, v1);
          }
        }
      }
      __syncthreads();
      if (p == 2) {
        bf16* vb = v_out + (size_t)b * C * Tn + t0;
        if (vec && tcount == kTcTok) {
          for (int e = tid; e < C * (kTcTok / 8); e += kThreads1) {
            const int c = e / (kTcTok / 8), ch = e % (kTcTok / 8);
            *reinterpret_cast<uint4*>(vb + (size_t)c * Tn + ch * 8) =
                *reinterpret_cast<const uint4*>(y_sh + c * kLDT + ch * 8);
          }
        } else {
          for (int i = tid; i < C * kTcTok; i += kThreads1) {
            const int c = i / kTcTok, t = i % kTcTok;
            if (t < tcount) vb[(size_t)c * Tn + t] = y_sh[c * kLDT + t];
          }
        }
      }
      OTP_PHASE(4);
    }

    // same-head scores of this chunk, K = its tokens.  A warp's slots past
    // the last tile repeat that tile (straight-line code, so the fragment
    // loads of all slots issue together); their sums are never stored.
#pragma unroll
    for (int s = 0; s < SMAX; ++s) {
      const int tile = min(warp + kWarps1 * s, ntiles - 1);
      const int h = tile / (MTh * NTh), r = tile % (MTh * NTh);
      const int mt = r / NTh, nt = r % NTh;
      const bf16* qa = q_sh + (h * hs + mt * 16) * kLDT + a_off(lane, kLDT);
      const bf16* kb = k_sh + (h * hs + nt * 8) * kLDT + bnk_x2_off(lane, kLDT);
#pragma unroll
      for (int kk = 0; kk < kTcTok / 16; ++kk) {
        uint32_t a[4], b0, b1;
        ldsm_x4(a, qa + kk * 16);
        ldsm_x2(b0, b1, kb + kk * 16);
        mma_bf16(sacc[s], a, b0, b1);
      }
    }
    OTP_PHASE(5);
  }

  float* sb = s_out + ((size_t)blockIdx.x * gridDim.y + b) * C * hs;
#pragma unroll
  for (int s = 0; s < SMAX; ++s) {
    const int tile = warp + kWarps1 * s;
    if (tile < ntiles) {
      const int h = tile / (MTh * NTh), r = tile % (MTh * NTh);
      const int mt = r / NTh, nt = r % NTh;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = mt * 16 + g + (e >> 1) * 8, j = nt * 8 + 2 * qd + (e & 1);
        if (i < hs && j < hs) sb[(size_t)(h * hs + i) * hs + j] = sacc[s][e];
      }
    }
  }
}

// att (rows x kp) = softmax(rnd(S)) over the hs real columns, rounded; the
// columns [hs, kp) are zero
__global__ void attn_softmax_kernel(const float* __restrict__ s, bf16* __restrict__ att,
                                    int rows, int hs, int kp) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* sr = s + (size_t)r * hs;
  bf16* ar = att + (size_t)r * kp;
  float m = -INFINITY;
  for (int j = 0; j < hs; ++j) m = fmaxf(m, rnd_bf(sr[j]));
  float sum = 0.f;
  for (int j = 0; j < hs; ++j) sum += expf(rnd_bf(sr[j]) - m);
  for (int j = 0; j < hs; ++j) ar[j] = __float2bfloat16_rn(expf(rnd_bf(sr[j]) - m) / sum);
  for (int j = hs; j < kp; ++j) ar[j] = __float2bfloat16(0.f);
}

__global__ void __launch_bounds__(kThreads)
att_v_tc_kernel(const bf16* __restrict__ att, const bf16* __restrict__ v,
                bf16* __restrict__ out, int C, int Tn, int hs, int n_head, int kp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int LDA = kp + 8, R = C + 16;
  bf16* a_sh = reinterpret_cast<bf16*>(smem);   // R x LDA: att, rows past C zero
  bf16* v_sh = a_sh + R * LDA;                  // R x kLDV: v tile, rows past C zero
  bf16* o_sh = v_sh + R * kLDV;                 // C x kLDV: out tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const int b = blockIdx.y, t0 = blockIdx.x * kTokV;
  const int tcount = min(kTokV, Tn - t0);
  const bf16 zero = __float2bfloat16(0.f);
  const bf16* ab = att + (size_t)b * C * kp;
  const bf16* vb = v + (size_t)b * C * Tn + t0;
  // att rows are 16-byte aligned (kp is a multiple of 16); v rows where the
  // tile is whole and T a multiple of 8
  for (int e = tid; e < C * (kp / 8); e += kThreads) {
    const int c = e / (kp / 8), ch = e % (kp / 8);
    cp_async16(a_sh + c * LDA + ch * 8, ab + (size_t)c * kp + ch * 8);
  }
  for (int i = tid; i < 16 * kp; i += kThreads) a_sh[(C + i / kp) * LDA + i % kp] = zero;
  if (tcount == kTokV && Tn % 8 == 0) {
    for (int e = tid; e < C * (kTokV / 8); e += kThreads) {
      const int c = e / (kTokV / 8), ch = e % (kTokV / 8);
      cp_async16(v_sh + c * kLDV + ch * 8, vb + (size_t)c * Tn + ch * 8);
    }
  } else {
    for (int i = tid; i < C * kTokV; i += kThreads) {
      const int c = i / kTokV, t = i % kTokV;
      v_sh[c * kLDV + t] = t < tcount ? vb[(size_t)c * Tn + t] : zero;
    }
  }
  for (int i = tid; i < 16 * kTokV; i += kThreads) v_sh[(C + i / kTokV) * kLDV + i % kTokV] = zero;
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int MTh = (hs + 15) / 16, KT = kp / 16;
  for (int pr = 0; pr < n_head * MTh; ++pr) {
    const int h = pr / MTh, mt = pr % MTh;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const bf16* aa = a_sh + (h * hs + mt * 16) * LDA + a_off(lane, LDA);
    const bf16* vv = v_sh + h * hs * kLDV + bkn_x2_off(lane, kLDV) + warp * 8;
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t a[4], b0, b1;
      ldsm_x4(a, aa + kk * 16);
      ldsm_x2_trans(b0, b1, vv + kk * 16 * kLDV);
      mma_bf16(acc, a, b0, b1);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = mt * 16 + g + hh * 8;
      if (i < hs)
        *reinterpret_cast<uint32_t*>(o_sh + (h * hs + i) * kLDV + warp * 8 + 2 * qd) =
            pack_bf16(acc[2 * hh], acc[2 * hh + 1]);
    }
  }
  __syncthreads();
  for (int i = tid; i < C * kTokV; i += kThreads) {
    const int c = i / kTokV, t = i % kTokV;
    if (t < tcount) out[((size_t)b * C + c) * Tn + t0 + t] = o_sh[c * kLDV + t];
  }
}

// ---------------------------------------------------------------------------
// f32: split TF32 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kLDNf = kTcTok + 12;       // ln1 tile: halo at column 3, body 4..35, halo 36
constexpr int kH0f = 3;
constexpr int kLDQf = kTcTok + 4;        // q and k tiles (channels x tokens): 4 mod 8
constexpr int kLDVf = kTokV + 8;         // att_v_tf32's v and out tiles: 8 mod 32
constexpr int kF32MaxSlots = 10;         // score tiles a warp holds without spilling

// one warp's m16 x n8 tile d += A @ B in split TF32, A's fragment and B's
// two registers as ldmatrix gives them (f32 bits)
__device__ __forceinline__ void mma_split(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  uint32_t ahi[4], alo[4], bh0, bh1, bl0, bl1;
  split_tf32_x4(a, ahi, alo);
  split_tf32(__uint_as_float(b0), bh0, bl0);
  split_tf32(__uint_as_float(b1), bh1, bl1);
  mma_3xtf32(d, ahi, alo, bh0, bh1, bl0, bl1);
}

// Phase 1 in f32.  The bf16 kernel's plan (one block an SM walking every
// nsplit-th chunk of 32 tokens, column passes for the front, the same-head
// score tiles dealt to the warps and held in registers across chunks,
// partial sums stored per split), with four differences:
//   - the three f32 projection weights (3 x 136 x 140 x 4 = 228 KB at
//     C = 136) do not fit beside the tiles in 227 KB, so one projection's
//     weights sit in shared memory at a time: W[p + 1] streams from L2 by
//     cp.async while the depthwise conv and LN of p + 1 run, which do not
//     read them (and W[0] of the next chunk behind the scores and ln1);
//   - 512 threads leave 128 registers a thread, which the split fragments
//     and the score tiles share.  With up to 6 score tiles a warp (the
//     flagship: 90 tiles), warp w < Mp / 16 computes m16 row tile w of a
//     projection over all four token tiles, as in bf16; with 7 to 10 (hs up
//     to 136) the projection is dealt to all 16 warps as tasks of one row
//     tile by two token tiles, which need fewer registers and split each
//     weight fragment twice (-Xptxas -v: no spills either way; more than
//     10 tiles a warp spilled, so the wrapper refuses those shapes);
//   - LN(dwconv) is stored token-major (kTcTok x LDY), so that ldmatrix
//     gives the projection's B fragments (TF32 fragments hold one 32-bit
//     element a register: a matrix stored [k][n] has no transposing load);
//   - v goes from the accumulators straight to the f32 scratch (each lane
//     pair writes whole 32-byte sectors), not through shared memory.
// SMAX: score tiles (m16 x n8) a warp holds, at least
// ceil(n_head * ceil(hs / 16) * ceil(hs / 8) / kWarps1).
template <int SMAX>
__global__ void __launch_bounds__(kThreads1, 1)
qkv_scores_tf32_kernel(const float* __restrict__ x, const float* __restrict__ ln1w,
                       const float* __restrict__ ln1b, const float* __restrict__ dw,
                       const float* __restrict__ nw, const float* __restrict__ nb,
                       const float* __restrict__ pw, const float* __restrict__ pb,
                       float* __restrict__ v_out, float* __restrict__ s_out, int C, int Cp,
                       int Tn, int hs, int n_head, int nsplit, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Mp = (Cp + 15) & ~15, LDW = Cp + 4, LDY = Cp + 4, R = C + 16;
  float* w_sh = reinterpret_cast<float*>(smem);   // Mp x LDW: one projection's weights
  float* n_sh = w_sh + Mp * LDW;                  // C x kLDNf: ln1(x) with its halo
  float* y_sh = n_sh + C * kLDNf;                 // kTcTok x LDY: LN(dwconv)^T
  float* q_sh = y_sh + kTcTok * LDY;              // R x kLDQf
  float* k_sh = q_sh + R * kLDQf;                 // R x kLDQf
  float* ln1w_sh = k_sh + R * kLDQf;              // C
  float* ln1b_sh = ln1w_sh + C;                   // C
  float* nw_sh = ln1b_sh + C;                     // 3 x C
  float* nb_sh = nw_sh + 3 * C;                   // 3 x C
  float* pb_sh = nb_sh + 3 * C;                   // 3 x Cp
  float* dw_sh = pb_sh + 3 * Cp;                  // 3 x C x 4: 3 taps, 0

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const int b = blockIdx.y;
  const int nchunks = (Tn + kTcTok - 1) / kTcTok;
  const float* xb = x + (size_t)b * C * Tn;
  const int MT = Mp / 16, KT = Cp / 8;
  const int MTh = (hs + 15) / 16, NTh = (hs + 7) / 8, ntiles = n_head * MTh * NTh;

  // A chunk's x: the body by cp.async where it is whole and its rows
  // 16-byte aligned, the two halo tokens by plain loads into registers
  const bool vec = Tn % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  float halo[kHaloPer];
  auto fetch = [&](int chunk) {
    const int t0 = chunk * kTcTok;
    if (vec && t0 + kTcTok <= Tn) {
      for (int e = tid; e < C * (kTcTok / 4); e += kThreads1) {
        const int c = e / (kTcTok / 4), ch = e % (kTcTok / 4);
        cp_async16(n_sh + c * kLDNf + kH0f + 1 + ch * 4, xb + (size_t)c * Tn + t0 + ch * 4);
      }
    }
    cp_async_commit();
#pragma unroll
    for (int k = 0; k < kHaloPer; ++k) {
      const int e = tid + k * kThreads1, c = e >> 1;
      const int t = (e & 1) ? t0 + kTcTok : t0 - 1;
      halo[k] = (c < C && t >= 0 && t < Tn) ? xb[(size_t)c * Tn + t] : 0.f;
    }
  };
  // the x chunk has landed (W_0, committed after it, may still be in flight)
  auto land = [&](int chunk) {
    const int t0 = chunk * kTcTok;
    cp_async_wait<1>();
#pragma unroll
    for (int k = 0; k < kHaloPer; ++k) {
      const int e = tid + k * kThreads1, c = e >> 1;
      if (c < C) n_sh[c * kLDNf + ((e & 1) ? kH0f + 1 + kTcTok : kH0f)] = halo[k];
    }
    if (!(vec && t0 + kTcTok <= Tn)) {
      for (int i = tid; i < C * kTcTok; i += kThreads1) {
        const int c = i / kTcTok, j = i % kTcTok, t = t0 + j;
        n_sh[c * kLDNf + kH0f + 1 + j] = t < Tn ? xb[(size_t)c * Tn + t] : 0.f;
      }
    }
    __syncthreads();
  };
  // projection p's weights (Cp rows of Cp) into w_sh
  auto load_w = [&](int p) {
    const float* src = pw + (size_t)p * Cp * Cp;
    for (int e = tid; e < Cp * (Cp / 4); e += kThreads1) {
      const int r = e / (Cp / 4), ch = e % (Cp / 4);
      cp_async16(w_sh + r * LDW + ch * 4, src + (size_t)r * Cp + ch * 4);
    }
    cp_async_commit();
  };

  for (int i = tid; i < C; i += kThreads1) {
    ln1w_sh[i] = ln1w[i];
    ln1b_sh[i] = ln1b[i];
  }
  for (int i = tid; i < 3 * C; i += kThreads1) {
    nw_sh[i] = nw[i];
    nb_sh[i] = nb[i];
  }
  for (int i = tid; i < 3 * Cp; i += kThreads1) pb_sh[i] = pb[i];
  for (int i = tid; i < 12 * C; i += kThreads1)
    dw_sh[i] = (i & 3) == 3 ? 0.f : dw[(i >> 2) * 3 + (i & 3)];
  // zero for the whole kernel: weight rows past Cp, y columns past C, q and
  // k rows past C (the tiles of the last head read up to 15 rows past it)
  for (int i = tid; i < (Mp - Cp) * LDW; i += kThreads1) w_sh[Cp * LDW + i] = 0.f;
  for (int i = tid; i < kTcTok * LDY; i += kThreads1) y_sh[i] = 0.f;
  for (int i = tid; i < 2 * R * kLDQf; i += kThreads1) q_sh[i] = 0.f;   // q_sh, k_sh
  __syncthreads();

  float sacc[SMAX][4];
#pragma unroll
  for (int s = 0; s < SMAX; ++s) sacc[s][0] = sacc[s][1] = sacc[s][2] = sacc[s][3] = 0.f;

  if (blockIdx.x < nchunks) {
    fetch(blockIdx.x);
    load_w(0);
  }
  for (int chunk = blockIdx.x; chunk < nchunks; chunk += nsplit) {
    const int t0 = chunk * kTcTok;
    const int tcount = min(kTcTok, Tn - t0);
    const bool more = chunk + nsplit < nchunks;
    OTP_PHASE_START;
    land(chunk);
    OTP_PHASE(0);
    float* nh = n_sh + kH0f;                    // column j: token t0 - 1 + j
    {
      // ln1 of the 34 columns: kSubs1 threads a column
      const int j = tid / kSubs1, sub = tid % kSubs1, t = t0 - 1 + j;
      float v[kChPer1];
#pragma unroll
      for (int i = 0; i < kChPer1; ++i) {
        const int c = sub + kSubs1 * i;
        v[i] = (j < kTcHalo && c < C) ? nh[c * kLDNf + j] : 0.f;
      }
      ln_column<kChPer1, kSubs1>(v, C, sub, ln1w_sh, ln1b_sh, nh + j, kLDNf, j < kTcHalo,
                                 t < 0 || t >= Tn);
    }
    __syncthreads();
    OTP_PHASE(1);

    for (int p = 0; p < 3; ++p) {
      {
        // depthwise conv as the plain version's three products and two sums
        // (no fused multiply-add), then its LN: kSubs threads a token column
        const int t = tid / kSubs, sub = tid % kSubs;
        const float* dwp = dw_sh + p * C * 4;
        float v[kChPer];
#pragma unroll
        for (int i = 0; i < kChPer; ++i) {
          const int c = min(sub + kSubs * i, C - 1);   // straight-line code; masked below
          const float* nr = nh + c * kLDNf + t;
          const float2 d01 = *reinterpret_cast<const float2*>(dwp + c * 4);   // the 3 taps
          const float a = __fadd_rn(__fmul_rn(nr[0], d01.x), __fmul_rn(nr[1], d01.y));
          v[i] = sub + kSubs * i < C ? __fadd_rn(a, __fmul_rn(nr[2], dwp[c * 4 + 2])) : 0.f;
        }
        ln_column<kChPer, kSubs>(v, C, sub, nw_sh + p * C, nb_sh + p * C, y_sh + t * LDY, 1,
                                 true, false);
      }
      __syncthreads();
      OTP_PHASE(2);
      if (p == 2) {
        if (more) fetch(chunk + nsplit);   // n_sh is free
        else cp_async_commit();            // keeps the wait below the same
      }
      if (p == 2) cp_async_wait<1>();      // W_2 (the next chunk's x may still be in flight)
      else cp_async_wait<0>();
      __syncthreads();
      OTP_PHASE(6);

      // the epilogue of one m16 x n8 tile of the projection (row tile mt,
      // token tile nt): q, scaled, into q_sh; k into k_sh; v to the scratch
      auto store = [&](const float (&acc)[4], int mt, int nt) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int o = mt * 16 + g + hh * 8, tt = nt * 8 + 2 * qd;
          if (o >= C) continue;
          const float bias = pb_sh[p * Cp + o];
          float v0 = acc[2 * hh] + bias, v1 = acc[2 * hh + 1] + bias;
          if (p == 2) {
            float* vr = v_out + ((size_t)b * C + o) * Tn + t0 + tt;
            if (tt + 1 < tcount && Tn % 2 == 0) {
              *reinterpret_cast<float2*>(vr) = make_float2(v0, v1);
            } else {
              if (tt < tcount) vr[0] = v0;
              if (tt + 1 < tcount) vr[1] = v1;
            }
            continue;
          }
          if (p == 0) {
            v0 *= scale;
            v1 *= scale;
          }
          if (tt >= tcount) v0 = 0.f;
          if (tt + 1 >= tcount) v1 = 0.f;
          *reinterpret_cast<float2*>((p == 0 ? q_sh : k_sh) + o * kLDQf + tt) =
              make_float2(v0, v1);
        }
      };
      // projection: P (Mp x 32 tokens) = Wp @ Y
      if constexpr (SMAX <= 6) {
        // warp w < MT owns m16 row tile w and all four token tiles, as in bf16
        float pacc[kTcTok / 8][4];
#pragma unroll
        for (int j = 0; j < kTcTok / 8; ++j)
          pacc[j][0] = pacc[j][1] = pacc[j][2] = pacc[j][3] = 0.f;
        if (warp < MT) {
          const float* wa = w_sh + warp * 16 * LDW + a_off_f32(lane, LDW);
          const float* yb = y_sh + bnk_x4_off_f32(lane, LDY);
#pragma unroll 1
          for (int kk = 0; kk < KT; ++kk) {
            uint32_t a[4], b01[4], b23[4];
            ldsm_x4(a, wa + kk * 8);
            ldsm_x4(b01, yb + kk * 8);
            ldsm_x4(b23, yb + 16 * LDY + kk * 8);
            uint32_t ahi[4], alo[4], bhi[4], blo[4];
            split_tf32_x4(a, ahi, alo);
            split_tf32_x4(b01, bhi, blo);
            mma_3xtf32(pacc[0], ahi, alo, bhi[0], bhi[1], blo[0], blo[1]);
            mma_3xtf32(pacc[1], ahi, alo, bhi[2], bhi[3], blo[2], blo[3]);
            split_tf32_x4(b23, bhi, blo);
            mma_3xtf32(pacc[2], ahi, alo, bhi[0], bhi[1], blo[0], blo[1]);
            mma_3xtf32(pacc[3], ahi, alo, bhi[2], bhi[3], blo[2], blo[3]);
          }
        }
        OTP_PHASE(3);
        __syncthreads();   // every warp is done with w_sh and y_sh
        if (p < 2) load_w(p + 1);
        else if (more) load_w(0);
        if (warp < MT) {
#pragma unroll
          for (int j = 0; j < kTcTok / 8; ++j) store(pacc[j], warp, j);
        }
      } else {
        // more score tiles than fit beside a warp's four token tiles: tasks
        // of one row tile by two token tiles, dealt to all warps, each
        // storing its epilogue at once (the projection reads neither q_sh
        // nor k_sh)
        for (int task = warp; task < 2 * MT; task += kWarps1) {
          const int mt = task % MT, nt0 = 2 * (task / MT);
          float pacc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
          const float* wa = w_sh + mt * 16 * LDW + a_off_f32(lane, LDW);
          const float* yb = y_sh + nt0 * 8 * LDY + bnk_x4_off_f32(lane, LDY);
#pragma unroll 1
          for (int kk = 0; kk < KT; ++kk) {
            uint32_t a[4], bt[4], ahi[4], alo[4], bhi[4], blo[4];
            ldsm_x4(a, wa + kk * 8);
            ldsm_x4(bt, yb + kk * 8);
            split_tf32_x4(a, ahi, alo);
            split_tf32_x4(bt, bhi, blo);
            mma_3xtf32(pacc[0], ahi, alo, bhi[0], bhi[1], blo[0], blo[1]);
            mma_3xtf32(pacc[1], ahi, alo, bhi[2], bhi[3], blo[2], blo[3]);
          }
          store(pacc[0], mt, nt0);
          store(pacc[1], mt, nt0 + 1);
        }
        OTP_PHASE(3);
        __syncthreads();   // every warp is done with w_sh and y_sh
        if (p < 2) load_w(p + 1);
        else if (more) load_w(0);
      }
      OTP_PHASE(4);
    }
    __syncthreads();   // q and k of the chunk are complete

    // same-head scores of this chunk, K = its tokens.  A warp's slots past
    // the last tile repeat that tile; their sums are never stored.
#pragma unroll
    for (int s = 0; s < SMAX; ++s) {
      const int tile = min(warp + kWarps1 * s, ntiles - 1);
      const int h = tile / (MTh * NTh), r = tile % (MTh * NTh);
      const int mt = r / NTh, nt = r % NTh;
      const float* qa = q_sh + (h * hs + mt * 16) * kLDQf + a_off_f32(lane, kLDQf);
      const float* kb = k_sh + (h * hs + nt * 8) * kLDQf + bnk_x2_off_f32(lane, kLDQf);
#pragma unroll
      for (int kk = 0; kk < kTcTok / 8; ++kk) {
        uint32_t a[4], b0, b1;
        ldsm_x4(a, qa + kk * 8);
        ldsm_x2(b0, b1, kb + kk * 8);
        mma_split(sacc[s], a, b0, b1);
      }
    }
    OTP_PHASE(5);
  }

  float* sb = s_out + ((size_t)blockIdx.x * gridDim.y + b) * C * hs;
#pragma unroll
  for (int s = 0; s < SMAX; ++s) {
    const int tile = warp + kWarps1 * s;
    if (tile < ntiles) {
      const int h = tile / (MTh * NTh), r = tile % (MTh * NTh);
      const int mt = r / NTh, nt = r % NTh;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = mt * 16 + g + (e >> 1) * 8, j = nt * 8 + 2 * qd + (e & 1);
        if (i < hs && j < hs) sb[(size_t)(h * hs + i) * hs + j] = sacc[s][e];
      }
    }
  }
}

// att (rows x kp) = softmax(S) in f32 over the hs real columns; the columns
// [hs, kp) are zero
__global__ void attn_softmax_f32_kernel(const float* __restrict__ s, float* __restrict__ att,
                                        int rows, int hs, int kp) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* sr = s + (size_t)r * hs;
  float* ar = att + (size_t)r * kp;
  float m = -INFINITY;
  for (int j = 0; j < hs; ++j) m = fmaxf(m, sr[j]);
  float sum = 0.f;
  for (int j = 0; j < hs; ++j) sum += expf(sr[j] - m);
  for (int j = 0; j < hs; ++j) ar[j] = expf(sr[j] - m) / sum;
  for (int j = hs; j < kp; ++j) ar[j] = 0.f;
}

// out_h (hs x 64 tokens) = att_h @ v_h per block in split TF32, K = hs
// padded to kp (a multiple of 8; att's padded columns are zero), one n8
// token tile a warp.  v's B fragments are plain loads (v is stored [k][n]).
__global__ void __launch_bounds__(kThreads)
att_v_tf32_kernel(const float* __restrict__ att, const float* __restrict__ v,
                  float* __restrict__ out, int C, int Tn, int hs, int n_head, int kp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int LDA = kp + 4, R = C + 16;
  float* a_sh = reinterpret_cast<float*>(smem);   // R x LDA: att, rows past C zero
  float* v_sh = a_sh + R * LDA;                   // (C + 8) x kLDVf: v tile, rows past C zero
  float* o_sh = v_sh + (C + 8) * kLDVf;           // C x kLDVf: out tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const int b = blockIdx.y, t0 = blockIdx.x * kTokV;
  const int tcount = min(kTokV, Tn - t0);
  const float* ab = att + (size_t)b * C * kp;
  const float* vb = v + (size_t)b * C * Tn + t0;
  // att rows are 16-byte aligned (kp is a multiple of 8); v rows where the
  // tile is whole and T a multiple of 4
  for (int e = tid; e < C * (kp / 4); e += kThreads) {
    const int c = e / (kp / 4), ch = e % (kp / 4);
    cp_async16(a_sh + c * LDA + ch * 4, ab + (size_t)c * kp + ch * 4);
  }
  for (int i = tid; i < 16 * kp; i += kThreads) a_sh[(C + i / kp) * LDA + i % kp] = 0.f;
  if (tcount == kTokV && Tn % 4 == 0) {
    for (int e = tid; e < C * (kTokV / 4); e += kThreads) {
      const int c = e / (kTokV / 4), ch = e % (kTokV / 4);
      cp_async16(v_sh + c * kLDVf + ch * 4, vb + (size_t)c * Tn + ch * 4);
    }
  } else {
    for (int i = tid; i < C * kTokV; i += kThreads) {
      const int c = i / kTokV, t = i % kTokV;
      v_sh[c * kLDVf + t] = t < tcount ? vb[(size_t)c * Tn + t] : 0.f;
    }
  }
  for (int i = tid; i < 8 * kTokV; i += kThreads) v_sh[(C + i / kTokV) * kLDVf + i % kTokV] = 0.f;
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int MTh = (hs + 15) / 16, KT = kp / 8;
  for (int pr = 0; pr < n_head * MTh; ++pr) {
    const int h = pr / MTh, mt = pr % MTh;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const float* aa = a_sh + (h * hs + mt * 16) * LDA + a_off_f32(lane, LDA);
    const float* vv = v_sh + (h * hs + qd) * kLDVf + warp * 8 + g;
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, aa + kk * 8);
      mma_split(acc, a, __float_as_uint(vv[kk * 8 * kLDVf]),
                __float_as_uint(vv[(kk * 8 + 4) * kLDVf]));
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = mt * 16 + g + hh * 8;
      if (i < hs)
        *reinterpret_cast<float2*>(o_sh + (h * hs + i) * kLDVf + warp * 8 + 2 * qd) =
            make_float2(acc[2 * hh], acc[2 * hh + 1]);
    }
  }
  __syncthreads();
  if (tcount == kTokV && Tn % 4 == 0) {
    for (int e = tid; e < C * (kTokV / 4); e += kThreads) {
      const int c = e / (kTokV / 4), ch = e % (kTokV / 4);
      *reinterpret_cast<float4*>(out + ((size_t)b * C + c) * Tn + t0 + ch * 4) =
          *reinterpret_cast<const float4*>(o_sh + c * kLDVf + ch * 4);
    }
  } else {
    for (int i = tid; i < C * kTokV; i += kThreads) {
      const int c = i / kTokV, t = i % kTokV;
      if (t < tcount) out[((size_t)b * C + c) * Tn + t0 + t] = o_sh[c * kLDVf + t];
    }
  }
}

size_t tf32_scores_smem(int C, int Cp) {
  const size_t mp = (Cp + 15) / 16 * 16, ld = Cp + 4;
  return sizeof(float) * (mp * ld + (size_t)C * kLDNf + kTcTok * ld +
                          2 * (size_t)(C + 16) * kLDQf + 20 * (size_t)C + 3 * (size_t)Cp);
}

size_t tf32_att_v_smem(int C, int kp) {
  return sizeof(float) * ((size_t)(C + 16) * (kp + 4) + (size_t)(C + 8) * kLDVf +
                          (size_t)C * kLDVf);
}

int round16(int n) { return (n + 15) / 16 * 16; }

size_t tc_scores_smem(int C, int Cp) {
  return sizeof(bf16) * (3 * (size_t)Cp * (Cp + 8) + (size_t)C * kLDN + (size_t)Cp * kLDT +
                         2 * (size_t)(Cp + 16) * kLDT + 12 * (size_t)C) +
         sizeof(float) * (8 * (size_t)C + 3 * (size_t)Cp);
}

size_t tc_att_v_smem(int C, int kp) {
  return sizeof(bf16) * ((size_t)(C + 16) * (kp + 8) + (size_t)(C + 16) * kLDV +
                         (size_t)C * kLDV);
}

void reduce_scores(float* s, long long n, int nsplit, cudaStream_t st) {
  if (nsplit > 1)
    qkv_scores_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(s, n, nsplit);
}

// C padded to the mma depth (16 in bf16, 8 in f32)
int pad_channels(int C, int dtype) { return dtype == 1 ? round16(C) : (C + 7) / 8 * 8; }

// Whether a shape takes the narrow kernels: the padded C within kMaxCp, and
// in f32 one head's score tiles within what 16 warps hold in registers.
bool narrow(int C, int n_head, int dtype) {
  const int hs = C / n_head;
  return pad_channels(C, dtype) <= kMaxCp &&
         (dtype == 1 || n_head * ((hs + 15) / 16) * ((hs + 7) / 8) <= kWarps1 * kF32MaxSlots);
}

// ---------------------------------------------------------------------------
// wide: C past kMaxCp in either dtype, or one f32 head of more same-head
// score tiles than 16 warps of kF32MaxSlots hold (hs past 136); the
// products on `hopper_gemm.cuh`
// ---------------------------------------------------------------------------

constexpr int kLnWarps = 8;      // the wide LN passes: warps over C
constexpr int kFrTok = 30;       // wide_conv_ln: tokens a block, lanes 1..30
constexpr int kFrChunk = 32;     // channels a token-major store pass
constexpr int kSplitTok = 64;    // the scores' split of T: whole K steps of a product

// Each lane's sum over the block's warps of v, in warp order (the
// statistics' order of the narrow kernels' column passes).
__device__ __forceinline__ float warp_order_sum(float (*part)[32], float v) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  part[warp][lane] = v;
  __syncthreads();
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kLnWarps; ++i) acc += part[i][lane];
  __syncthreads();
  return acc;
}

// ln1 of 32 tokens a block into n (B, C, T), channel-major, rounded to T:
// lanes are tokens and warps stride the channels, eight loads in flight a
// warp (`otp_hg::batched`); the statistics in JAX's order (the mean, then the
// mean of the squared residual); the plain version's division.
template <typename T>
__global__ void __launch_bounds__(32 * kLnWarps)
wide_ln1_kernel(const T* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, T* __restrict__ n, int C, int Tn) {
  __shared__ float part[kLnWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = blockIdx.x * 32 + lane;
  const bool live = t < Tn;
  const size_t base = (size_t)blockIdx.y * C * Tn + t;
  auto xv = [&](int c) { return live ? to_f<T>(x[base + (size_t)c * Tn]) : 0.f; };
  float s = 0.f;
  otp_hg::batched(warp, kLnWarps, C, xv, [&](int, float v) { s += v; });
  const float mu = warp_order_sum(part, s) / C;
  float q = 0.f;
  otp_hg::batched(warp, kLnWarps, C, xv, [&](int, float v) {
    const float r = v - mu;
    q += live ? r * r : 0.f;
  });
  const float sd = sqrtf(warp_order_sum(part, q) / C + kEps);
  if (!live) return;
  otp_hg::batched(warp, kLnWarps, C, xv, [&](int c, float v) {
    n[base + (size_t)c * Tn] = from_f<T>(__fadd_rn(__fmul_rn(__fdiv_rn(v - mu, sd), w[c]), bias[c]));
  });
}

// For p = blockIdx.z (q, k or v): the depthwise k3 conv of ln1's output n
// (zero-padded at the ends of T) with the plain version's rounding and its
// LayerNorm, written token-major into y[p] (of (3, B, T, Cp): the
// projections' B operand; f32 split hi / lo, lo at y + lo_off).  Lane l
// holds token t0 - 1 + l: lanes 1..30 are the block's tokens and lanes 0
// and 31 their halo, so every lane does the same work and a conv reads its
// neighbours by shuffles.  Warps stride the channels, four loads in flight
// a warp; the statistics in JAX's order, in warp order; the output through
// shared memory in chunks of channels (`otp_hg::store_token_tile`).  The
// conv values (T values: the conv rounds to T) stay in dynamic shared
// memory for the variance and the output where a small cache holds them
// (`conv_cache_bytes`), else each pass recomputes them from n (L2).
template <typename T>
__global__ void __launch_bounds__(32 * kLnWarps)
wide_conv_ln_kernel(const T* __restrict__ n, const float* __restrict__ dw,
                    const float* __restrict__ nw, const float* __restrict__ nb,
                    T* __restrict__ y, size_t lo_off, int B, int C, int Cp, int Tn, int cached) {
  extern __shared__ __align__(16) unsigned char conv_raw[];
  T* cache = reinterpret_cast<T*>(conv_raw);   // C x 32 lanes, where `cached`
  __shared__ float part[kLnWarps][32];
  __shared__ float tile[kFrChunk * otp_hg::kTileLd];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y, p = blockIdx.z, t0 = blockIdx.x * kFrTok, tt = t0 - 1 + lane;
  const bool live = tt >= 0 && tt < Tn;
  const T* nl = n + (size_t)b * C * Tn + tt;
  dw += (size_t)p * C * 3;
  nw += p * C;
  nb += p * C;
  auto nv = [&](int c) { return live ? to_f<T>(nl[(size_t)c * Tn]) : 0.f; };
  // the conv of channel c at this lane's token from n1, its ln1 value there
  auto conv = [&](int c, float n1) {
    const float n0 = __shfl_up_sync(0xffffffffu, n1, 1);
    const float n2 = __shfl_down_sync(0xffffffffu, n1, 1);
    const float* d = dw + (size_t)c * 3;
    const float a = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(n0, d[0])), rnd<T>(__fmul_rn(n1, d[1]))));
    return rnd<T>(__fadd_rn(a, rnd<T>(__fmul_rn(n2, d[2]))));
  };
  // f(c, v) for the conv v of every channel c of this warp: computed with
  // four loads ahead (and kept where `keep`), or read from the cache
  auto each_conv = [&](bool keep, auto&& f) {
    if (cached && !keep) {
      for (int c = warp; c < C; c += kLnWarps) f(c, to_f<T>(cache[c * 32 + lane]));
      return;
    }
    auto g = [&](int c, float v) {
      if (keep) cache[c * 32 + lane] = from_f<T>(v);
      f(c, v);
    };
    int c = warp;
    for (; c + 3 * kLnWarps < C; c += 4 * kLnWarps) {
      float ns[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ns[i] = nv(c + i * kLnWarps);
#pragma unroll
      for (int i = 0; i < 4; ++i) g(c + i * kLnWarps, conv(c + i * kLnWarps, ns[i]));
    }
    for (; c < C; c += kLnWarps) g(c, conv(c, nv(c)));
  };
  float s = 0.f;
  each_conv(cached, [&](int, float v) { s += v; });
  const float mu = warp_order_sum(part, s) / C;
  float q = 0.f;
  each_conv(false, [&](int, float v) {
    const float r = v - mu;
    q += r * r;
  });
  const float sd = sqrtf(warp_order_sum(part, q) / C + kEps);

  // the normalised values, a chunk of channels at a time through shared
  // memory into token-major rows (lanes 1..30 that hold a token of T)
  const int tend = min(kFrTok + 1, Tn - t0 + 1);
  for (int c0 = 0; c0 < Cp; c0 += kFrChunk) {
#pragma unroll
    for (int i = warp; i < kFrChunk; i += kLnWarps) {
      const int c = c0 + i;   // uniform across the warp: its shuffles stay whole
      float v = 0.f;
      if (c < C) {
        const float cv = cached ? to_f<T>(cache[c * 32 + lane]) : conv(c, nv(c));
        v = __fadd_rn(__fmul_rn(__fdiv_rn(cv - mu, sd), nw[c]), nb[c]);
      }
      tile[i * otp_hg::kTileLd + lane] = v;
    }
    __syncthreads();
    otp_hg::store_token_tile<T, kFrChunk>(tile, y, lo_off, ((size_t)p * B + b) * Tn + t0 - 1, Cp,
                                          c0, Cp, 1, tend, threadIdx.x);
    __syncthreads();
  }
}

// The conv-value cache of `wide_conv_ln_kernel` for C channels, or 0 where
// it would leave room for fewer than four blocks an SM (then the passes
// recompute the convs: the first pass, which waits on its loads, needs the
// warps; measured at C = 208 and 1064, PERF.md §6).
template <typename T>
size_t conv_cache_bytes(int C) {
  const size_t bytes = (size_t)C * 32 * sizeof(T);
  return bytes <= 48 * 1024 ? bytes : 0;
}

// The projections, problem z = p B + b: rows of pw[p] (A, Cp x Cp) against
// y[p][b] (B, tokens x C), so the accumulators hold channels x tokens.
// Epilogue rnd(rnd(acc) + pb), q then times scale (rounded by the store):
// q and k into qk (2, B, C, Tp) channel-major (the scores' operands, K = T),
// v into vt (B, n_head, T, kp) token-major, a head's channels at the start
// of its own rows (att @ v's B operand, K = the head's channels: a TMA box
// starts on a 16-byte boundary of a row, which h hs values need not be).
template <typename T>
struct AttnProj {
  T* qk;
  T* vt;
  size_t qk_lo, vt_lo;
  const float* pb;
  int B, C, Cp, Tn, Tp, hs, kp;
  float scale;
  __device__ otp_hg::Coords coords(int z) const { return {z / B * Cp, 0, z * Tn, 0, C}; }
  __device__ void tile(int z, int m0, int n0, int, const float (&acc)[64], uint8_t*,
                       int tid) const {
    const int p = z / B, b = z % B;
    otp_hg::store_fragments(acc, tid, [&](int r, int cc, float v0, float v1) {
      const int m = m0 + r, n = n0 + cc;
      if (m >= C || n >= Tn) return;
      const float bb = pb[p * Cp + m];
      v0 = rnd<T>(__fadd_rn(rnd<T>(v0), bb));
      v1 = rnd<T>(__fadd_rn(rnd<T>(v1), bb));
      if (p == 0) {
        v0 = __fmul_rn(v0, scale);
        v1 = __fmul_rn(v1, scale);
      }
      const bool both = n + 1 < Tn;
      if (p < 2) {
        otp_hg::put2<T>(qk + ((size_t)z * C + m) * Tp + n, qk_lo, v0, v1, both);
      } else {
        const int h = m / hs;
        T* d = vt + (((size_t)b * (C / hs) + h) * Tn + n) * kp + (m - h * hs);
        otp_hg::put<T>(d, vt_lo, v0);
        if (both) otp_hg::put<T>(d + kp, vt_lo, v1);
      }
    });
  }
};

// The scores, problem z = (s B + b) n_head + h: q_h (hs x T) against k_h
// over the tokens of split s, [s kspan, (s + 1) kspan), into partial s of
// S[b][h] (hs x hs, f32).
struct AttnScores {
  float* s;
  int B, C, Tn, hs, n_head, kspan;
  __device__ otp_hg::Coords coords(int z) const {
    const int h = z % n_head, b = (z / n_head) % B, k0 = z / (n_head * B) * kspan;
    const int row = b * C + h * hs;
    return {row, k0, B * C + row, k0, min(kspan, Tn - k0)};
  }
  __device__ void tile(int z, int m0, int n0, int, const float (&acc)[64], uint8_t*,
                       int tid) const {
    const int h = z % n_head, bs = z / n_head;   // bs = s B + b
    float* dst = s + ((size_t)bs * C + (size_t)h * hs) * hs;
    otp_hg::store_fragments(acc, tid, [&](int r, int cc, float v0, float v1) {
      const int m = m0 + r, n = n0 + cc;
      if (m >= hs || n >= hs) return;
      dst[(size_t)m * hs + n] = v0;
      if (n + 1 < hs) dst[(size_t)m * hs + n + 1] = v1;
    });
  }
};

// att @ v, problem z = b n_head + h: att[b][h] (A, hs x kp) against vt[b][h]
// (B, tokens x hs), K past hs zero-filled, rounded into out[b][h] (hs x T).
template <typename T>
struct AttnOut {
  T* out;
  int C, Tn, hs, n_head;
  __device__ otp_hg::Coords coords(int z) const {
    return {z * hs, 0, z * Tn, 0, hs};
  }
  __device__ void tile(int z, int m0, int n0, int, const float (&acc)[64], uint8_t*,
                       int tid) const {
    T* dst = out + (size_t)z * hs * Tn;   // rows b C + h hs
    otp_hg::store_fragments(acc, tid, [&](int r, int cc, float v0, float v1) {
      const int m = m0 + r, n = n0 + cc;
      if (m >= hs || n >= Tn) return;
      T* d = dst + (size_t)m * Tn + n;
      if (n + 1 < Tn && (reinterpret_cast<uintptr_t>(d) & (2 * sizeof(T) - 1)) == 0) {
        if constexpr (sizeof(T) == 2) *reinterpret_cast<uint32_t*>(d) = pack_bf16(v0, v1);
        else *reinterpret_cast<float2*>(d) = make_float2(v0, v1);
      } else {
        d[0] = from_f<T>(v0);
        if (n + 1 < Tn) d[1] = from_f<T>(v1);
      }
    });
  }
};

// S = the nsplit partials added in split order (written back into partial
// 0), then att = softmax over the hs real columns, one warp a row: bf16
// softmax(rnd(S)) rounded, f32 split hi / lo (lo at att + lo_off); att's
// columns [hs, kp) zero.
template <typename T>
__global__ void __launch_bounds__(256)
wide_softmax_kernel(float* __restrict__ s, T* __restrict__ att, size_t lo_off, int rows, int hs,
                    int kp, int nsplit) {
  const int lane = threadIdx.x & 31, r = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (r >= rows) return;
  const size_t n = (size_t)rows * hs;
  float* sr = s + (size_t)r * hs;
  float m = -INFINITY;
  for (int j = lane; j < hs; j += 32) {
    float v = sr[j];
    for (int p = 1; p < nsplit; ++p) v += sr[p * n + j];
    v = rnd<T>(v);
    sr[j] = v;
    m = fmaxf(m, v);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float sum = 0.f;
  for (int j = lane; j < hs; j += 32) sum += expf(sr[j] - m);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  T* ar = att + (size_t)r * kp;
  for (int j = lane; j < kp; j += 32)
    otp_hg::put<T>(ar + j, lo_off, j < hs ? expf(sr[j] - m) / sum : 0.f);
}

// The wide path on one stream: (f32: the projection weights split), ln1
// into out, the convs' LNs into y, the projections into qk and vt, the scores' split
// partials into s, their sum and the softmax into att, att @ v into out.
// Scratch in device memory (`ops/cuda/fused_attn.py::wide_plan`), in f32
// each operand followed by its lo half.
template <typename T>
int launch_wide(const void* x, const void* ln1w, const void* ln1b, const void* dw,
                const void* nw, const void* nb, const void* pw, const void* pb, void* y_scr,
                void* qk_scr, void* vt_scr, void* s_scr, void* att_scr, void* w_scr, void* out,
                int B, int C, int Cp, int Tn, int n_head, float scale, int nsplit, int kspan,
                cudaStream_t st) {
  constexpr int dtype = sizeof(T) == 2 ? 1 : 0;
  const int hs = C / n_head, kp = pad_channels(hs, dtype), Tp = (Tn + 7) / 8 * 8;
  const size_t y_lo = (size_t)3 * B * Tn * Cp, qk_lo = (size_t)2 * B * C * Tp;
  const size_t vt_lo = (size_t)B * C / hs * Tn * kp, att_lo = (size_t)B * C * kp;
  const size_t w_lo = (size_t)3 * Cp * Cp;
  T* y = static_cast<T*>(y_scr);
  T* qk = static_cast<T*>(qk_scr);
  T* vt = static_cast<T*>(vt_scr);
  T* att = static_cast<T*>(att_scr);
  const T* w = static_cast<const T*>(pw);
  if constexpr (dtype == 0) {
    otp_hg::split_weights(static_cast<const float*>(pw), static_cast<float*>(w_scr), w_lo,
                          (long long)w_lo, st);
    w = static_cast<const T*>(w_scr);
  }
  wide_ln1_kernel<T><<<dim3((Tn + 31) / 32, B), 32 * kLnWarps, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(ln1w), static_cast<const float*>(ln1b),
      static_cast<T*>(out), C, Tn);
  const size_t cache = conv_cache_bytes<T>(C);
  cudaFuncSetAttribute(wide_conv_ln_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)cache);
  wide_conv_ln_kernel<T><<<dim3((Tn + kFrTok - 1) / kFrTok, B, 3), 32 * kLnWarps, cache, st>>>(
      static_cast<const T*>(out), static_cast<const float*>(dw), static_cast<const float*>(nw),
      static_cast<const float*>(nb), y, y_lo, B, C, Cp, Tn, cache > 0);
  otp_hg::Operand a, b;
  int err;
  if ((err = otp_hg::make_operand<T>(&a, w, w_lo, C, 3 * Cp, Cp)) ||
      (err = otp_hg::make_operand<T>(&b, y, y_lo, C, (uint64_t)3 * B * Tn, Cp)))
    return err;
  const AttnProj<T> proj{qk, vt, qk_lo, vt_lo, static_cast<const float*>(pb), B, C, Cp, Tn, Tp,
                         hs, kp, scale};
  if ((err = otp_hg::launch<T>(a, b, proj, C, Tn, 3 * B, st))) return err;
  // q and k are rows of the same operand
  if ((err = otp_hg::make_operand<T>(&a, qk, qk_lo, Tn, (uint64_t)2 * B * C, Tp))) return err;
  const AttnScores scores{static_cast<float*>(s_scr), B, C, Tn, hs, n_head, kspan};
  if ((err = otp_hg::launch<T>(a, a, scores, hs, hs, nsplit * B * n_head, st))) return err;
  const int rows = B * C;
  wide_softmax_kernel<T><<<(rows + 7) / 8, 256, 0, st>>>(static_cast<float*>(s_scr), att, att_lo,
                                                         rows, hs, kp, nsplit);
  if ((err = otp_hg::make_operand<T>(&a, att, att_lo, hs, rows, kp)) ||
      (err = otp_hg::make_operand<T>(&b, vt, vt_lo, hs, (uint64_t)B * n_head * Tn, kp)))
    return err;
  const AttnOut<T> av{static_cast<T*>(out), C, Tn, hs, n_head};
  return otp_hg::launch<T>(a, b, av, hs, Tn, B * n_head, st);
}

}  // namespace

// 1 where a shape (heads that divide C) takes the narrow kernels, 0 where
// it takes the wide path: `ops/cuda/fused_attn.py::narrow` states the same.
extern "C" int otp_fused_attn_narrow(int C, int n_head, int dtype) {
  return narrow(C, n_head, dtype) ? 1 : 0;
}

// Dynamic shared memory the largest of the kernels of `dtype` (0 = f32,
// 1 = bf16) needs at a shape: the narrow kernels' where they take it (see
// `narrow`), else the wide path's, which holds no per-C state on chip.
extern "C" size_t otp_fused_attn_smem(int C, int n_head, int dtype) {
  const int hs = C / n_head;
  if (!narrow(C, n_head, dtype))
    return dtype == 1 ? otp_hg::smem_bytes<bf16>() : otp_hg::smem_bytes<float>();
  if (dtype == 1) {
    const size_t a = tc_scores_smem(C, round16(C)), c = tc_att_v_smem(C, round16(hs));
    return a > c ? a : c;
  }
  const size_t a = tf32_scores_smem(C, (C + 7) / 8 * 8), c = tf32_att_v_smem(C, (hs + 7) / 8 * 8);
  return a > c ? a : c;
}

// Either dtype (0 = f32, 1 = bf16), a shape `narrow` refuses.  x, out:
// (B, C, T); ln1w/ln1b: (C,) f32; dw: (3, C, 3), nw/nb: (3, C), f32; pw:
// (3, Cp, Cp) and pb: (3, Cp) f32, zero-padded (`pack_attn_weights`, Cp =
// `pad_channels(C)`).  Scratch (`fused_attn.py::wide_plan`), in f32 each
// operand followed by its lo half: y_scr (3, B, T, Cp), qk_scr (2, B, C,
// Tp) with Tp = T rounded up to 8, vt_scr (B, n_head, T, kp), att_scr (B, C, kp)
// with kp = `pad_channels(hs)`, w_scr (f32: 2 x 3 Cp Cp; unused in bf16);
// s_scr (nsplit, B, C, hs) f32.  The scores' split s sums tokens
// [s kspan, (s + 1) kspan), kspan a multiple of 64 with nsplit kspan >= T.
extern "C" int otp_fused_attn_wide(const void* x, const void* ln1w, const void* ln1b,
                                   const void* dw, const void* nw, const void* nb,
                                   const void* pw, const void* pb, void* y_scr, void* qk_scr,
                                   void* vt_scr, void* s_scr, void* att_scr, void* w_scr,
                                   void* out, int B, int C, int Cp, int Tn, int n_head,
                                   float scale, int nsplit, int kspan, int dtype,
                                   void* stream) {
  if (n_head <= 0 || C <= 0 || C % n_head || (dtype != 0 && dtype != 1) || B < 1 || Tn < 1 ||
      Cp != pad_channels(C, dtype) || narrow(C, n_head, dtype) || nsplit < 1 || kspan < 1 ||
      kspan % kSplitTok || (long long)nsplit * kspan < Tn)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  OTP_DISPATCH(dtype, return launch_wide<T>(x, ln1w, ln1b, dw, nw, nb, pw, pb, y_scr, qk_scr,
                                            vt_scr, s_scr, att_scr, w_scr, out, B, C, Cp, Tn,
                                            n_head, scale, nsplit, kspan, st));
  return (int)cudaErrorInvalidValue;
}

// f32.  x, v_scr, out: (B, C, T).  ln1w/ln1b: (C,).  dw: (3, C, 3), nw/nb:
// (3, C).  pw: (3, Cp, Cp) and pb: (3, Cp), zero-padded (`pack_attn_weights`),
// Cp = C rounded up to 8.  s_scr: (nsplit, B, C, hs); att_scr: (B, C, kp) with
// kp = hs rounded up to 8.
extern "C" int otp_fused_attn_f32(const void* x, const void* ln1w, const void* ln1b,
                                  const void* dw, const void* nw, const void* nb,
                                  const void* pw, const void* pb, void* v_scr, void* s_scr,
                                  void* att_scr, void* out, int B, int C, int Cp, int Tn,
                                  int n_head, float scale, int nsplit, void* stream) {
  if (n_head <= 0 || C % n_head || Cp != (C + 7) / 8 * 8 || Cp > kMaxCp)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int hs = C / n_head, kp = (hs + 7) / 8 * 8;
  const int ntiles = n_head * ((hs + 15) / 16) * ((hs + 7) / 8);
  const int per_warp = (ntiles + kWarps1 - 1) / kWarps1;
  const size_t smem_a = tf32_scores_smem(C, Cp), smem_c = tf32_att_v_smem(C, kp);
  const dim3 grid_a(nsplit, B);
#define OTP_SCORES(S)                                                                     \
  do {                                                                                    \
    cudaFuncSetAttribute(qkv_scores_tf32_kernel<S>,                                       \
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);       \
    qkv_scores_tf32_kernel<S><<<grid_a, kThreads1, smem_a, st>>>(                         \
        (const float*)x, (const float*)ln1w, (const float*)ln1b, (const float*)dw,        \
        (const float*)nw, (const float*)nb, (const float*)pw, (const float*)pb,           \
        (float*)v_scr, (float*)s_scr, C, Cp, Tn, hs, n_head, nsplit, scale);              \
  } while (0)
  // the score accumulators share the 128 registers a thread has with the
  // projection's split fragments: no more slots than the shape needs
  if (per_warp <= 4) OTP_SCORES(4);
  else if (per_warp <= 6) OTP_SCORES(6);      // the flagship: 90 tiles
  else if (per_warp <= 8) OTP_SCORES(8);
  else if (per_warp <= kF32MaxSlots) OTP_SCORES(kF32MaxSlots);   // hs = 136, one head: 153
  else return (int)cudaErrorInvalidValue;
#undef OTP_SCORES
  const int rows = B * C;
  reduce_scores((float*)s_scr, (long long)rows * hs, nsplit, st);
  attn_softmax_f32_kernel<<<(rows + 127) / 128, 128, 0, st>>>((const float*)s_scr,
                                                              (float*)att_scr, rows, hs, kp);
  cudaFuncSetAttribute(att_v_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_c);
  att_v_tf32_kernel<<<dim3((Tn + kTokV - 1) / kTokV, B), kThreads, smem_c, st>>>(
      (const float*)att_scr, (const float*)v_scr, (float*)out, C, Tn, hs, n_head, kp);
  return (int)cudaGetLastError();
}

// bf16.  x, v_scr, out: (B, C, T) bf16.  ln1w/ln1b: (C,) f32.  dw: (3, C, 3),
// nw/nb: (3, C), f32.  pw: (3, Cp, Cp) bf16 and pb: (3, Cp) f32, zero-padded
// (`pack_attn_weights`).  s_scr: (nsplit, B, C, hs) f32; att_scr: (B, C, kp)
// bf16 with kp = hs rounded up to 16.
extern "C" int otp_fused_attn_tc(const void* x, const void* ln1w, const void* ln1b,
                                 const void* dw, const void* nw, const void* nb,
                                 const void* pw, const void* pb, void* v_scr, void* s_scr,
                                 void* att_scr, void* out, int B, int C, int Cp, int Tn,
                                 int n_head, float scale, int nsplit, void* stream) {
  if (n_head <= 0 || C % n_head || Cp != round16(C) || Cp > kMaxCp)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int hs = C / n_head, kp = round16(hs);
  const int ntiles = n_head * ((hs + 15) / 16) * ((hs + 7) / 8);
  const int per_warp = (ntiles + kWarps1 - 1) / kWarps1;
  const size_t smem_a = tc_scores_smem(C, Cp), smem_c = tc_att_v_smem(C, kp);
  const dim3 grid_a(nsplit, B);
#define OTP_SCORES(S)                                                                     \
  do {                                                                                    \
    cudaFuncSetAttribute(qkv_scores_tc_kernel<S>,                                         \
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);       \
    qkv_scores_tc_kernel<S><<<grid_a, kThreads1, smem_a, st>>>(                           \
        (const bf16*)x, (const float*)ln1w, (const float*)ln1b, (const float*)dw,         \
        (const float*)nw, (const float*)nb, (const bf16*)pw, (const float*)pb,            \
        (bf16*)v_scr, (float*)s_scr, C, Cp, Tn, hs, n_head, nsplit, scale);               \
  } while (0)
  if (per_warp <= 4) OTP_SCORES(4);
  else if (per_warp <= 8) OTP_SCORES(8);
  else if (per_warp <= 16) OTP_SCORES(16);   // C <= 160: at most 200 tiles, 13 a warp
  else return (int)cudaErrorInvalidValue;
#undef OTP_SCORES
  const int rows = B * C;
  reduce_scores((float*)s_scr, (long long)rows * hs, nsplit, st);
  attn_softmax_kernel<<<(rows + 127) / 128, 128, 0, st>>>((const float*)s_scr, (bf16*)att_scr,
                                                          rows, hs, kp);
  cudaFuncSetAttribute(att_v_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_c);
  att_v_tc_kernel<<<dim3((Tn + kTokV - 1) / kTokV, B), kThreads, smem_c, st>>>(
      (const bf16*)att_scr, (const bf16*)v_scr, (bf16*)out, C, Tn, hs, n_head, kp);
  return (int)cudaGetLastError();
}
