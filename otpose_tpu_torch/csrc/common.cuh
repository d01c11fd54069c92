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

extern "C" const char* otp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
