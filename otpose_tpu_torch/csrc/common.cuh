// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel takes its activations in the model's compute dtype (float or
// __nv_bfloat16) and computes in f32.  `rnd<T>` rounds an f32 value to T and
// back: the kernels call it exactly where the PyTorch plain versions (and the
// JAX package before them) store an intermediate in the compute dtype, so a
// bf16 kernel rounds at the same points as its plain version.
#pragma once

#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}

// dtype codes passed from Python: 0 = float32, 1 = bfloat16
#define OTP_DISPATCH(code, ...)                   \
  do {                                            \
    if ((code) == 0) {                            \
      using T = float;                            \
      __VA_ARGS__;                                \
    } else if ((code) == 1) {                     \
      using T = __nv_bfloat16;                    \
      __VA_ARGS__;                                \
    } else {                                      \
      return (int)cudaErrorInvalidValue;          \
    }                                             \
  } while (0)

// Phase clocks, read by `tools/kernel_phases.py`.  In a build with
// -DOTP_PHASE_CLOCK, OTP_PHASE(k) adds to slot k the clock64() cycles that
// thread 0 of the block spent since OTP_PHASE_START or its previous mark,
// and otp_phase_cycles copies the slots out and zeroes them.  Otherwise the
// marks are empty and the kernels are unchanged.
#ifdef OTP_PHASE_CLOCK
__device__ unsigned long long otp_phase_slots[16];
#define OTP_PHASE_START long long otp_phase_t0 = clock64()
#define OTP_PHASE(k)                                                                 \
  do {                                                                               \
    if (threadIdx.x == 0) {                                                          \
      const long long otp_now = clock64();                                           \
      atomicAdd(&otp_phase_slots[k], (unsigned long long)(otp_now - otp_phase_t0));  \
      otp_phase_t0 = otp_now;                                                        \
    }                                                                                \
  } while (0)
extern "C" int otp_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, otp_phase_slots, sizeof(otp_phase_slots));
  if (err != cudaSuccess) return (int)err;
  static const unsigned long long zero[16] = {};
  return (int)cudaMemcpyToSymbol(otp_phase_slots, zero, sizeof(zero));
}
#else
#define OTP_PHASE_START
#define OTP_PHASE(k)
#endif

extern "C" const char* otp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
