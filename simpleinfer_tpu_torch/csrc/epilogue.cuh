// Shared by the port's CUDA kernels: dtype codes, f32 conversions and the
// epilogue activations (the names of kernels/matmul.resolve_activation).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace si {

// dtype codes shared with the Python wrappers
enum DType { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2 };

// activation codes shared with kernels/matmul.py (_ACT_CODES)
enum Act {
  ACT_NONE = 0, ACT_RELU = 1, ACT_SILU = 2, ACT_SIGMOID = 3,
  ACT_HARDSIGMOID = 4, ACT_HARDSWISH = 5, ACT_RELU6 = 6, ACT_TANH = 7,
  ACT_MISH = 8, ACT_GELU = 9, ACT_GELU_TANH = 10, ACT_LEAKY_RELU = 11,
  ACT_ELU = 12,
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // round to nearest even, like torch
}

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ float hardsigmoid_f(float v) {
  return fminf(fmaxf(v * (1.0f / 6.0f) + 0.5f, 0.0f), 1.0f);
}

__device__ __forceinline__ float activate(float v, int act, float a) {
  switch (act) {
    case ACT_RELU: return v > 0.0f ? v : 0.0f;
    case ACT_SILU: return v * sigmoid_f(v);
    case ACT_SIGMOID: return sigmoid_f(v);
    case ACT_HARDSIGMOID: return hardsigmoid_f(v);
    case ACT_HARDSWISH: return v * hardsigmoid_f(v);
    case ACT_RELU6: return fminf(fmaxf(v, 0.0f), 6.0f);
    case ACT_TANH: return tanhf(v);
    case ACT_MISH: {
      // softplus with torch's overflow threshold
      float sp = v > 20.0f ? v : log1pf(expf(v));
      return v * tanhf(sp);
    }
    case ACT_GELU:  // exact (erf) form
      return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
    case ACT_GELU_TANH: {
      float u = 0.79788456080286536f * (v + 0.044715f * v * v * v);
      return 0.5f * v * (1.0f + tanhf(u));
    }
    case ACT_LEAKY_RELU: return v >= 0.0f ? v : v * a;
    case ACT_ELU: return v > 0.0f ? v : a * expm1f(v);
    default: return v;
  }
}

// a bias element of either float dtype, as f32
__device__ __forceinline__ float load_bias(const void* bias, int dtype,
                                           int n) {
  return dtype == DT_BF16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[n])
             : static_cast<const float*>(bias)[n];
}

}  // namespace si
