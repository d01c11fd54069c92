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
// f32 (`qkv_scores_kernel`, `softmax_kernel`, `att_v_kernel`): the same three
// phases as f32 FMA loops from shared memory, the parity path (on the tensor
// cores f32 would run as TF32).
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kTT = 32;       // tokens per chunk in qkv_scores (one per lane)
constexpr int kThreads = 256;
constexpr int kTV = 128;      // tokens per block in att_v

// Two blocks an SM, the most its shared memory holds at C = 136 (110 KB a
// block): without that hint ptxas aimed at more blocks and spilled.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
qkv_scores_kernel(const T* __restrict__ x, const float* __restrict__ ln1w,
                  const float* __restrict__ ln1b, const float* __restrict__ dw,
                  const float* __restrict__ nw, const float* __restrict__ nb,
                  const float* __restrict__ pw, const float* __restrict__ pb,
                  T* __restrict__ v_out, float* __restrict__ s_out, int C, int Tn,
                  int hs, int nsplit, float scale) {
  extern __shared__ float sm[];
  const int LDN = kTT + 2, LD = kTT + 1;
  float* n_sh = sm;                 // C x LDN   ln1(x) with halo
  float* y_sh = n_sh + C * LDN;     // C x LD    dwconv, then its LN
  float* q_sh = y_sh + C * LD;      // C x LD    q * scale
  float* k_sh = q_sh + C * LD;      // C x LD
  float* s_sh = k_sh + C * LD;      // C x hs    this block's score sum
  float* mu_sh = s_sh + C * hs;     // LDN
  float* sd_sh = mu_sh + LDN;       // LDN

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = kThreads / 32;
  const int b = blockIdx.y;
  const int nchunks = (Tn + kTT - 1) / kTT;
  const T* xb = x + (size_t)b * C * Tn;
  const float eps = 1e-5f;

  for (int e = tid; e < C * hs; e += kThreads) s_sh[e] = 0.f;

  for (int chunk = blockIdx.x; chunk < nchunks; chunk += nsplit) {
    const int t0 = chunk * kTT;
    const int tcount = min(kTT, Tn - t0);
    __syncthreads();
    for (int i = tid; i < C * LDN; i += kThreads) {
      const int c = i / LDN, j = i % LDN, t = t0 - 1 + j;
      n_sh[i] = (t >= 0 && t < Tn) ? to_f<T>(xb[(size_t)c * Tn + t]) : 0.f;
    }
    __syncthreads();
    if (tid < LDN) {
      float s = 0.f;
      for (int c = 0; c < C; ++c) s += n_sh[c * LDN + tid];
      const float mu = s / C;
      float v = 0.f;
      for (int c = 0; c < C; ++c) {
        const float r = n_sh[c * LDN + tid] - mu;
        v += r * r;
      }
      mu_sh[tid] = mu;
      sd_sh[tid] = sqrtf(v / C + eps);
    }
    __syncthreads();
    for (int i = tid; i < C * LDN; i += kThreads) {
      const int c = i / LDN, j = i % LDN, t = t0 - 1 + j;
      n_sh[i] = (t >= 0 && t < Tn)
          ? rnd<T>((n_sh[i] - mu_sh[j]) / sd_sh[j] * ln1w[c] + ln1b[c]) : 0.f;
    }
    __syncthreads();

    for (int p = 0; p < 3; ++p) {
      const float* dwp = dw + p * C * 3;
      for (int i = tid; i < C * kTT; i += kThreads) {
        const int c = i / kTT, t = i % kTT;
        if (t < tcount) {
          const float* nr = n_sh + c * LDN + t;
          const float a = rnd<T>(rnd<T>(nr[0] * dwp[c * 3 + 0]) +
                                 rnd<T>(nr[1] * dwp[c * 3 + 1]));
          y_sh[c * LD + t] = rnd<T>(a + rnd<T>(nr[2] * dwp[c * 3 + 2]));
        }
      }
      __syncthreads();
      if (tid < tcount) {
        float s = 0.f;
        for (int c = 0; c < C; ++c) s += y_sh[c * LD + tid];
        const float mu = s / C;
        float v = 0.f;
        for (int c = 0; c < C; ++c) {
          const float r = y_sh[c * LD + tid] - mu;
          v += r * r;
        }
        mu_sh[tid] = mu;
        sd_sh[tid] = sqrtf(v / C + eps);
      }
      __syncthreads();
      for (int i = tid; i < C * kTT; i += kThreads) {
        const int c = i / kTT, t = i % kTT;
        if (t < tcount)
          y_sh[c * LD + t] = rnd<T>((y_sh[c * LD + t] - mu_sh[t]) / sd_sh[t] *
                                    nw[p * C + c] + nb[p * C + c]);
      }
      __syncthreads();
      // projection: lane = token, warps stride over output channels
      const float* wp = pw + (size_t)p * C * C;
      if (lane < tcount) {
        for (int o = warp; o < C; o += nwarps) {
          const float* wr = wp + (size_t)o * C;
          float acc = 0.f;
          for (int c = 0; c < C; ++c) acc += __ldg(wr + c) * y_sh[c * LD + lane];
          const float val = rnd<T>(rnd<T>(acc) + pb[p * C + o]);
          if (p == 0) {
            q_sh[o * LD + lane] = rnd<T>(val * scale);
          } else if (p == 1) {
            k_sh[o * LD + lane] = val;
          } else {
            v_out[((size_t)b * C + o) * Tn + t0 + lane] = from_f<T>(val);
          }
        }
      }
      __syncthreads();
    }
    // same-head scores of this chunk
    for (int e = tid; e < C * hs; e += kThreads) {
      const int i = e / hs;
      const int j = (i / hs) * hs + e % hs;
      const float* qr = q_sh + i * LD;
      const float* kr = k_sh + j * LD;
      float acc = 0.f;
      for (int t = 0; t < tcount; ++t) acc += qr[t] * kr[t];
      s_sh[e] += acc;
    }
  }
  __syncthreads();
  float* sb = s_out + ((size_t)blockIdx.x * gridDim.y + b) * C * hs;
  for (int e = tid; e < C * hs; e += kThreads) sb[e] = s_sh[e];
}

// S (the first n floats of s) = the nsplit partials of n floats each, added
// in split order
__global__ void qkv_scores_reduce_kernel(float* __restrict__ s, long long n, int nsplit) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float acc = s[e];
  for (int p = 1; p < nsplit; ++p) acc += s[p * n + e];
  s[e] = acc;
}

template <typename T>
__global__ void softmax_kernel(const float* __restrict__ s, float* __restrict__ att,
                               int rows, int hs) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* sr = s + (size_t)r * hs;
  float* ar = att + (size_t)r * hs;
  float m = -INFINITY;
  for (int j = 0; j < hs; ++j) m = fmaxf(m, rnd<T>(sr[j]));
  float sum = 0.f;
  for (int j = 0; j < hs; ++j) {
    const float e = expf(rnd<T>(sr[j]) - m);
    ar[j] = e;
    sum += e;
  }
  for (int j = 0; j < hs; ++j) ar[j] = rnd<T>(ar[j] / sum);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
att_v_kernel(const float* __restrict__ att, const T* __restrict__ v, T* __restrict__ out,
             int C, int Tn, int hs) {
  extern __shared__ float sm[];
  float* a_sh = sm;               // C x hs
  float* v_sh = a_sh + C * hs;    // C x kTV
  const int tid = threadIdx.x, b = blockIdx.y;
  const int t0 = blockIdx.x * kTV;
  const int tcount = min(kTV, Tn - t0);
  const float* ab = att + (size_t)b * C * hs;
  const T* vb = v + (size_t)b * C * Tn;
  for (int i = tid; i < C * hs; i += kThreads) a_sh[i] = ab[i];
  for (int i = tid; i < C * kTV; i += kThreads) {
    const int c = i / kTV, t = i % kTV;
    v_sh[i] = t < tcount ? to_f<T>(vb[(size_t)c * Tn + t0 + t]) : 0.f;
  }
  __syncthreads();
  const int t = tid % kTV;
  if (t >= tcount) return;
  for (int i = tid / kTV; i < C; i += kThreads / kTV) {
    const float* ar = a_sh + i * hs;
    const float* vr = v_sh + (i / hs) * hs * kTV + t;
    float acc = 0.f;
    for (int j = 0; j < hs; ++j) acc += ar[j] * vr[j * kTV];
    out[((size_t)b * C + i) * Tn + t0 + t] = from_f<T>(acc);
  }
}

size_t smem_scores(int C, int hs) {
  return sizeof(float) * ((size_t)C * (kTT + 2) + 3 * (size_t)C * (kTT + 1) +
                          (size_t)C * hs + 2 * (kTT + 2));
}

size_t smem_att_v(int C, int hs) {
  return sizeof(float) * ((size_t)C * hs + (size_t)C * kTV);
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
// then rnd((v - mu) * (1 / sd) * w[c] + b[c]) (0 where `zero`) stored at
// dst[c * ld] when `store`.  Every lane of the warp calls it.  The
// reciprocal, taken once a column, keeps an IEEE division (a branchy
// sequence of dependent instructions) out of the per-element work; it moves
// the f32 value by at most an ulp or so before the bf16 rounding.
template <int PER, int SUBS>
__device__ __forceinline__ void ln_column(const float (&v)[PER], int C, int sub,
                                          const float* __restrict__ w,
                                          const float* __restrict__ b, bf16* dst, int ld,
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
    if (c < C) dst[c * ld] = __float2bfloat16_rn(zero ? 0.f : (v[i] - mu) * rs * w[c] + b[c]);
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

}  // namespace

// Dynamic shared memory the largest of the kernels of `dtype` needs (0 =
// f32, 1 = bf16); the bf16 kernels take C <= 160 only.
extern "C" size_t otp_fused_attn_smem(int C, int n_head, int dtype) {
  const int hs = C / n_head;
  if (dtype == 1) {
    if (C > kMaxCp) return (size_t)-1;
    const size_t a = tc_scores_smem(C, round16(C)), c = tc_att_v_smem(C, round16(hs));
    return a > c ? a : c;
  }
  const size_t a = smem_scores(C, hs), c = smem_att_v(C, hs);
  return a > c ? a : c;
}

// f32.  x, v_scr, out: (B, C, T).  ln1w/ln1b: (C,).  dw: (3, C, 3), nw/nb:
// (3, C), pw: (3, C_out, C_in), pb: (3, C).  s_scr: (nsplit, B, C, hs);
// att_scr: (B, C, hs).
extern "C" int otp_fused_attn_f32(const void* x, const void* ln1w, const void* ln1b,
                                  const void* dw, const void* nw, const void* nb,
                                  const void* pw, const void* pb, void* v_scr, void* s_scr,
                                  void* att_scr, void* out, int B, int C, int Tn, int n_head,
                                  float scale, int nsplit, void* stream) {
  using T = float;
  cudaStream_t st = (cudaStream_t)stream;
  const int hs = C / n_head;
  const size_t smem_a = smem_scores(C, hs), smem_c = smem_att_v(C, hs);
  cudaFuncSetAttribute(qkv_scores_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_a);
  cudaFuncSetAttribute(att_v_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_c);
  qkv_scores_kernel<T><<<dim3(nsplit, B), kThreads, smem_a, st>>>(
      (const T*)x, (const float*)ln1w, (const float*)ln1b, (const float*)dw, (const float*)nw,
      (const float*)nb, (const float*)pw, (const float*)pb, (T*)v_scr, (float*)s_scr, C, Tn,
      hs, nsplit, scale);
  const int rows = B * C;
  reduce_scores((float*)s_scr, (long long)rows * hs, nsplit, st);
  softmax_kernel<T><<<(rows + 127) / 128, 128, 0, st>>>((const float*)s_scr, (float*)att_scr,
                                                        rows, hs);
  att_v_kernel<T><<<dim3((Tn + kTV - 1) / kTV, B), kThreads, smem_c, st>>>(
      (const float*)att_scr, (const T*)v_scr, (T*)out, C, Tn, hs);
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
