// Helpers shared by the port's attention kernels: f32 <-> storage type
// conversion, warp reductions, the dispatch on (query dtype, K/V storage
// dtype, head_dim), and the error-code convention of the plain C entry
// points (0 = success, a cudaError_t from cudaGetLastError() after the
// launches, or kUnsupported when the arguments have no instantiation).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace repro {

constexpr float kNegInf = -1e30f;    // the reference's NEG_INF mask value
constexpr int kUnsupported = -1;     // dtype / head_dim / group size not built

// dtype codes of the C entry points: the query dtype T (also the K/V
// dtype of the float kernels), and the K/V storage dtype S of the
// quantized ones
enum DType : int { kFloat32 = 0, kBFloat16 = 1, kInt8 = 2, kFloat8E4M3 = 3 };

// The value format of a kernel's K/V: stored as the query's own dtype T
// (S == T, the float kernels K1-K3), or quantized, S = int8_t or
// __nv_fp8_e4m3 with one f16 scale per (cache row, KV head), laid out as
// the values with a last dimension of 1 (K7, K8, K10).
template <typename T, typename S>
constexpr bool kQuantized = !std::is_same<T, S>::value;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// A quantized tile row is read four 1-byte values at a time: one 32-bit
// word, lowest address first, converted to f32.
template <typename S>
__device__ __forceinline__ float byte_to_float(uint32_t byte);
template <>
__device__ __forceinline__ float byte_to_float<int8_t>(uint32_t byte) {
  return static_cast<float>(static_cast<int8_t>(byte));
}
template <>
__device__ __forceinline__ float byte_to_float<__nv_fp8_e4m3>(uint32_t byte) {
  __nv_fp8_e4m3 x;
  x.__x = static_cast<__nv_fp8_storage_t>(byte);
  return static_cast<float>(x);
}

template <typename S>
__device__ __forceinline__ float4 word_to_float4(uint32_t w) {
  return make_float4(byte_to_float<S>(w & 0xffu),
                     byte_to_float<S>((w >> 8) & 0xffu),
                     byte_to_float<S>((w >> 16) & 0xffu),
                     byte_to_float<S>(w >> 24));
}

// q . k over D f32 values in shared memory, both 16-byte aligned, read
// four at a time and summed in column order.
template <int D>
__device__ __forceinline__ float dot4(const float* q, const float* k) {
  float s = 0.f;
#pragma unroll 8
  for (int c = 0; c < D; c += 4) {
    const float4 a = *reinterpret_cast<const float4*>(q + c);
    const float4 b = *reinterpret_cast<const float4*>(k + c);
    s += a.x * b.x;
    s += a.y * b.y;
    s += a.z * b.z;
    s += a.w * b.w;
  }
  return s;
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

template <typename T, typename S, typename F>
int dispatch_dim(int d, const F& f) {
  switch (d) {
    case 16: return f.template run<T, S, 16>();
    case 32: return f.template run<T, S, 32>();
    case 64: return f.template run<T, S, 64>();
    case 128: return f.template run<T, S, 128>();
    default: return kUnsupported;
  }
}

// Calls f.run<T, T, D>() for the runtime (dtype, head_dim) of a float
// kernel; returns kUnsupported for a pair that is not instantiated.
template <typename F>
int dispatch_dtype_dim(int dtype, int d, const F& f) {
  if (dtype == kFloat32) return dispatch_dim<float, float>(d, f);
  if (dtype == kBFloat16)
    return dispatch_dim<__nv_bfloat16, __nv_bfloat16>(d, f);
  return kUnsupported;
}

template <typename T, typename F>
int dispatch_store_dim(int store, int d, const F& f) {
  if (store == kInt8) return dispatch_dim<T, int8_t>(d, f);
  if (store == kFloat8E4M3) return dispatch_dim<T, __nv_fp8_e4m3>(d, f);
  return kUnsupported;
}

// Calls f.run<T, S, D>() for the runtime (query dtype, K/V storage dtype,
// head_dim) of a quantized kernel.
template <typename F>
int dispatch_quant(int dtype, int store, int d, const F& f) {
  if (dtype == kFloat32) return dispatch_store_dim<float>(store, d, f);
  if (dtype == kBFloat16) return dispatch_store_dim<__nv_bfloat16>(store, d, f);
  return kUnsupported;
}

inline const char* error_string(int code) {
  if (code == kUnsupported) return "unsupported dtype, head_dim or group size";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace repro
