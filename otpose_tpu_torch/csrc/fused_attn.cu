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
// What bounds it on the H100: per flagship launch (B = 16, bf16) it must
// move 60 MB (read x, write out: 0.018 ms at 3.35 TB/s) and do 16.4 GFLOP
// (three C x C projections over B*T tokens, same-head scores, att @ v:
// 0.017 ms on the bf16 tensor cores), so the two bounds are about even.
// This first version runs the operations as f32 FMA loops from shared
// memory, off the tensor cores (C = 136 and hs = 68 do not fit the mma
// tiles without padding, and correctness comes first), so in practice its
// operations bound it.
//
// Design.  The TPU kernel ran its grid in order, parked all of v in VMEM and
// summed S in a scratch across T chunks.  Blocks here run in parallel and in
// no order, and v (C x T x 2 B = 1.9 MB per item) cannot stay on chip, so the
// work is three kernels on one stream:
//   1. qkv_scores: block (split, b) walks T chunks of 32 tokens.  It loads
//      the chunk with a one-token halo on each side, applies ln1 to the halo
//      columns too (the depthwise conv sees the normalised row, zero-padded
//      at the ends of T), builds q, k, v in shared memory, writes v to a
//      global scratch and adds the chunk's same-head scores to a per-block
//      shared sum.  Only the same-head (C x hs) entries are computed.  At the
//      end each block adds its sum to S with atomics (the sum's order varies
//      from run to run; S is f32).
//   2. softmax: one thread per row of S.
//   3. att_v: block (T chunk, b) re-reads v and writes att @ v.
#include "common.cuh"

namespace {

constexpr int kTT = 32;       // tokens per chunk in qkv_scores (one per lane)
constexpr int kThreads = 256;
constexpr int kTV = 128;      // tokens per block in att_v

template <typename T>
__global__ void __launch_bounds__(kThreads)
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
  float* sb = s_out + (size_t)b * C * hs;
  for (int e = tid; e < C * hs; e += kThreads) atomicAdd(sb + e, s_sh[e]);
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

}  // namespace

// Dynamic shared memory the larger of the two tiled kernels needs.
extern "C" size_t otp_fused_attn_smem(int C, int n_head) {
  const int hs = C / n_head;
  const size_t a = smem_scores(C, hs), c = smem_att_v(C, hs);
  return a > c ? a : c;
}

// x, v_scr, out: (B, C, T) in the compute dtype.  ln1w/ln1b: (C,) f32.
// dw: (3, C, 3), nw/nb: (3, C), pw: (3, C_out, C_in), pb: (3, C), all f32 and
// already rounded to the compute dtype where the model rounds them.
// s_scr, att_scr: (B, C, hs) f32.
extern "C" int otp_fused_attn(const void* x, const void* ln1w, const void* ln1b,
                              const void* dw, const void* nw, const void* nb,
                              const void* pw, const void* pb, void* v_scr, void* s_scr,
                              void* att_scr, void* out, int B, int C, int Tn, int n_head,
                              float scale, int nsplit, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int hs = C / n_head;
  cudaError_t err = cudaMemsetAsync(s_scr, 0, sizeof(float) * (size_t)B * C * hs, st);
  if (err != cudaSuccess) return (int)err;
  const size_t smem_a = smem_scores(C, hs), smem_c = smem_att_v(C, hs);
  OTP_DISPATCH(dtype, {
    cudaFuncSetAttribute(qkv_scores_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem_a);
    cudaFuncSetAttribute(att_v_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem_c);
    qkv_scores_kernel<T><<<dim3(nsplit, B), kThreads, smem_a, st>>>(
        (const T*)x, (const float*)ln1w, (const float*)ln1b, (const float*)dw,
        (const float*)nw, (const float*)nb, (const float*)pw, (const float*)pb, (T*)v_scr,
        (float*)s_scr, C, Tn, hs, nsplit, scale);
    const int rows = B * C;
    softmax_kernel<T><<<(rows + 127) / 128, 128, 0, st>>>((const float*)s_scr,
                                                          (float*)att_scr, rows, hs);
    att_v_kernel<T><<<dim3((Tn + kTV - 1) / kTV, B), kThreads, smem_c, st>>>(
        (const float*)att_scr, (const T*)v_scr, (T*)out, C, Tn, hs);
  });
  return (int)cudaGetLastError();
}
