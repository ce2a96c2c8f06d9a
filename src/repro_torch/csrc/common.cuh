// Helpers shared by the port's attention kernels: f32 <-> storage type
// conversion, warp reductions, and the error-code convention of the plain
// C entry points (0 = success, a cudaError_t from cudaGetLastError() after
// the launches, or kUnsupported when the arguments have no instantiation).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

constexpr float kNegInf = -1e30f;    // the reference's NEG_INF mask value
constexpr int kUnsupported = -1;     // dtype / head_dim / group size not built

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, typename F>
int dispatch_dim(int d, const F& f) {
  switch (d) {
    case 16: return f.template run<T, 16>();
    case 32: return f.template run<T, 32>();
    case 64: return f.template run<T, 64>();
    case 128: return f.template run<T, 128>();
    default: return kUnsupported;
  }
}

// Calls f.run<T, D>() for the runtime (dtype, head_dim); returns
// kUnsupported for a pair that is not instantiated.
template <typename F>
int dispatch_dtype_dim(int dtype, int d, const F& f) {
  if (dtype == kFloat32) return dispatch_dim<float>(d, f);
  if (dtype == kBFloat16) return dispatch_dim<__nv_bfloat16>(d, f);
  return kUnsupported;
}

inline const char* error_string(int code) {
  if (code == kUnsupported) return "unsupported dtype, head_dim or group size";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace repro
