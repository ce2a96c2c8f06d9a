// Helpers shared by the port's attention kernels: f32 <-> storage type
// conversion, warp reductions, the dispatch on (query dtype, K/V storage
// dtype, (Dk, Dv) head dims), and the error-code convention of the plain C entry
// points (0 = success, a cudaError_t from cudaGetLastError() after the
// launches, or kUnsupported when the arguments have no instantiation).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

namespace repro {

constexpr float kNegInf = -1e30f;    // the reference's NEG_INF mask value
constexpr int kUnsupported = -1;     // dtype / head_dim / group size not built
constexpr float kLog2e = 1.4426950408889634f;   // exp(x) = exp2(x log2 e)

using bf16 = __nv_bfloat16;

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

// The 16 / sizeof(T) values of one 16-byte load (a float kernel's K, V or
// q row, T = float or bf16) as f32 into dst.
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& raw, float* dst) {
  constexpr int kV = 16 / sizeof(T);
  T tmp[kV];
  memcpy(tmp, &raw, 16);
#pragma unroll
  for (int i = 0; i < kV; ++i) dst[i] = to_float(tmp[i]);
}

// Stage a 32-row tile of a float kernel's K ([32][k_stride] f32) and V
// ([32][DV] f32) in shared memory: `slab(r)` is the index of row r's
// [DK] / [DV] slab in k / v, or -1 for a row past the valid ones (staged
// as zeros).  16-byte loads (DK and DV are multiples of 16 / sizeof(T),
// the wrappers check the base pointers), four in flight a thread before
// they are converted and stored: the tile's load latency is paid once a
// batch instead of once a value.
template <typename T, int DK, int DV, int kThreadsPerBlock, typename Slab>
__device__ __forceinline__ void stage_kv_rows(const T* __restrict__ k,
                                              const T* __restrict__ v,
                                              float* ks, int k_stride,
                                              float* vs, const Slab& slab) {
  constexpr int kRows = 32, kBatch = 4;
  constexpr int kV = 16 / sizeof(T);
  constexpr int kKW = DK / kV, kRowW = (DK + DV) / kV;
  static_assert(DK % kV == 0 && DV % kV == 0, "whole 16-byte words");
  constexpr int kIters = (kRows * kRowW + kThreadsPerBlock - 1) /
                         kThreadsPerBlock;
#pragma unroll
  for (int j0 = 0; j0 < kIters; j0 += kBatch) {
    uint4 raw[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = threadIdx.x + (j0 + u) * kThreadsPerBlock;
      raw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (j0 + u < kIters && i < kRows * kRowW) {
        const int r = i / kRowW, wi = i % kRowW;
        const long long at = slab(r);
        if (at >= 0) {
          const T* src = wi < kKW ? k + at * DK + wi * kV
                                  : v + at * DV + (wi - kKW) * kV;
          raw[u] = __ldg(reinterpret_cast<const uint4*>(src));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = threadIdx.x + (j0 + u) * kThreadsPerBlock;
      if (j0 + u < kIters && i < kRows * kRowW) {
        const int r = i / kRowW, wi = i % kRowW;
        unpack16<T>(raw[u], wi < kKW ? ks + r * k_stride + wi * kV
                                     : vs + r * DV + (wi - kKW) * kV);
      }
    }
  }
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

// A (Dk, Dv) head-dim pair a kernel is built for: Dk is the width of q
// and k (the score contraction), Dv that of v and of the output.  A list
// of pairs is a DimList; each kernel file names the pairs it builds.
template <int DK, int DV>
struct Dims {};
template <typename... Pairs>
struct DimList {};

// The square pairs (the dense decoder's head dims and the hybrid
// family's 80): the quantized kernels (K7-K10) take these only.
using SquareDims = DimList<Dims<16, 16>, Dims<32, 32>, Dims<64, 64>,
                           Dims<80, 80>, Dims<128, 128>>;

template <typename T, typename S, typename F>
int dispatch_dims(int, int, const F&, DimList<>) {
  return kUnsupported;
}

// Calls f.run<T, S, DK, DV>() for the pair of the list equal to the
// runtime (dk, dv); kUnsupported when no pair is.
template <typename T, typename S, typename F, int DK, int DV,
          typename... Rest>
int dispatch_dims(int dk, int dv, const F& f,
                  DimList<Dims<DK, DV>, Rest...>) {
  if (dk == DK && dv == DV) return f.template run<T, S, DK, DV>();
  return dispatch_dims<T, S>(dk, dv, f, DimList<Rest...>{});
}

// Calls f.run<T, T, DK, DV>() for the runtime (dtype, dk, dv) of a float
// kernel, over the pairs of List.
template <typename List, typename F>
int dispatch_dtype_dims(int dtype, int dk, int dv, const F& f) {
  if (dtype == kFloat32) return dispatch_dims<float, float>(dk, dv, f, List{});
  if (dtype == kBFloat16)
    return dispatch_dims<__nv_bfloat16, __nv_bfloat16>(dk, dv, f, List{});
  return kUnsupported;
}

template <typename T, typename F>
int dispatch_store_dim(int store, int d, const F& f) {
  if (store == kInt8) return dispatch_dims<T, int8_t>(d, d, f, SquareDims{});
  if (store == kFloat8E4M3)
    return dispatch_dims<T, __nv_fp8_e4m3>(d, d, f, SquareDims{});
  return kUnsupported;
}

// Calls f.run<T, S, D, D>() for the runtime (query dtype, K/V storage
// dtype, head_dim) of a quantized kernel (the pairs of SquareDims).
template <typename F>
int dispatch_quant(int dtype, int store, int d, const F& f) {
  if (dtype == kFloat32) return dispatch_store_dim<float>(store, d, f);
  if (dtype == kBFloat16) return dispatch_store_dim<__nv_bfloat16>(store, d, f);
  return kUnsupported;
}

// Opt `kernel` into `bytes` of dynamic shared memory: a block may use more
// than 48 KB only after this call (up to 227 KB on the H100).
template <typename K>
cudaError_t allow_dynamic_smem(K* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// ------------------------------------------------------------ KV rings
//
// The pipelined kernels (K4, K5, K6, K9) stage their 32-row K/V tiles
// through a ring of kDepth stages in shared memory, filled by cp.async:
// tiles t + 1 .. t + kDepth - 1 are in flight while tile t is computed.
// A stage holds the tile's storage bytes as they lie in device memory;
// each value is widened to f32 where it is read (exactly, as the classic
// kernels widen it when they stage a tile), so the arithmetic and its
// order are the classic kernels' and the results equal theirs bit for
// bit.

// A 16-byte copy from device to shared memory, not cached in L1.  With
// `valid` false nothing is read and the 16 bytes are zeros (src-size 0):
// a row past the valid ones lands as zeros, as the classic kernels stage
// it.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0));
}

// A 4-byte copy from device to shared memory (an f32 value whose address
// need not be 16-byte aligned); zeros where `valid` is false.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One ring stage: a 32-row tile of K ([32] rows of DK values of storage
// type S, each row padded by 16 bytes so that lane j's 16-byte reads of
// row j fall in distinct banks) followed by its V rows ([32][DV]).
template <typename S, int DK, int DV>
struct RingTile {
  static_assert(DK * sizeof(S) % 16 == 0 && DV * sizeof(S) % 16 == 0,
                "rows of whole 16-byte chunks");
  static constexpr int kRows = 32;
  static constexpr int kKChunks = DK * sizeof(S) / 16;
  static constexpr int kVChunks = DV * sizeof(S) / 16;
  static constexpr int kKRow = DK * sizeof(S) + 16;     // bytes
  static constexpr int kVRow = DV * sizeof(S);          // bytes
  static constexpr int kVOff = kRows * kKRow;           // bytes
  static constexpr int kBytes = kVOff + kRows * kVRow;  // multiple of 16
};

// Start the cp.async copies of one tile into `stage` (not committed):
// `slab(r)` is the index of row r's [DK] / [DV] slab in k / v, or -1 for a
// row past the valid ones (never read; zero-filled).  Neighbouring threads
// copy neighbouring 16-byte chunks of a row.
template <typename S, int DK, int DV, int kThreadsPerBlock, typename Slab>
__device__ __forceinline__ void fetch_kv_tile(const S* __restrict__ k,
                                              const S* __restrict__ v,
                                              unsigned char* stage,
                                              const Slab& slab) {
  using R = RingTile<S, DK, DV>;
  constexpr int kRowW = R::kKChunks + R::kVChunks;
  for (int i = threadIdx.x; i < R::kRows * kRowW; i += kThreadsPerBlock) {
    const int r = i / kRowW, w = i % kRowW;
    const long long at = slab(r);
    const size_t row = at >= 0 ? static_cast<size_t>(at) : 0;
    if (w < R::kKChunks)
      cp_async16(stage + r * R::kKRow + w * 16,
                 reinterpret_cast<const unsigned char*>(k + row * DK) + w * 16,
                 at >= 0);
    else
      cp_async16(stage + R::kVOff + r * R::kVRow + (w - R::kKChunks) * 16,
                 reinterpret_cast<const unsigned char*>(v + row * DV) +
                     (w - R::kKChunks) * 16,
                 at >= 0);
  }
}

// q . k over DK columns in column order: q in f32 shared memory, the k row
// a ring row of storage type S read 16 bytes at a time and widened to
// f32.  The same sequence of multiply-adds as the classic kernels' loops
// over their f32 tiles.
template <typename S, int DK>
__device__ __forceinline__ float ring_dot(const float* q,
                                          const unsigned char* krow) {
  constexpr int kV = 16 / sizeof(S);
  float s = 0.f;
#pragma unroll 4
  for (int c = 0; c < DK; c += kV) {
    float kx[kV];
    unpack16<S>(*reinterpret_cast<const uint4*>(krow + c * sizeof(S)), kx);
#pragma unroll
    for (int u = 0; u < kV; ++u) s += q[c + u] * kx[u];
  }
  return s;
}

// ------------------------------------------------------------ tensor cores
//
// The warp-level mma.sync path shared by K14 / K15 (moe_gmm.cu), the bf16
// flash kernels (flash_attention.cu) and the bf16-query decode kernels
// (decode_attention.cu).  Fragment layouts of m16n8k16 (lane = 4 g + t):
// an A operand (16 x 16, row) holds (g, 2t..2t+1), (g + 8, 2t..),
// (g, 2t + 8..), (g + 8, 2t + 8..); a B operand (16 x 8, col) (2t..2t+1, g)
// and (2t + 8.., g); an accumulator (16 x 8) (g, 2t..2t+1) and
// (g + 8, 2t..2t+1).

// Four 8 x 8 b16 matrices from shared memory (ldmatrix): lanes 8 i .. 8 i +
// 7 give the row addresses of matrix i; with .trans each is transposed.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Two 8 x 8 b16 matrices (lanes 0-7 and 8-15 give the row addresses; the
// others' are ignored): the B operand of one 8-column tile.
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a));
}

// The lane's row and column offsets of the ldmatrix_x4 that loads an A
// operand from a row-major [m][k] tile, or the B operands of two 8-column
// tiles of a row-major [k][n] tile with .trans (matrices: rows 0-7 / 8-15
// x columns 0-7 / 8-15; for an x2 load, lanes 0-15 give rows 0-15 of
// column 0) ...
__device__ __forceinline__ int frag_row(int lane) {
  return (lane % 8) + ((lane / 8) % 2) * 8;
}
__device__ __forceinline__ int frag_col(int lane) { return (lane / 16) * 8; }
// ... and of the one that loads the B operands of two 8-row tiles of a
// row-major [n][k] tile without .trans, or an A operand of a row-major
// [k][m] tile with .trans (for an x2 load, lanes 0-15 give rows 0-7 at
// columns 0 and 8).
__device__ __forceinline__ int brow(int lane) {
  return (lane % 8) + (lane / 16) * 8;
}
__device__ __forceinline__ int bcol(int lane) { return ((lane / 8) % 2) * 8; }

// c += a (16 x 16, row) b (16 x 8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 bytes of values of type W as bf16 into dst (16-byte aligned): bf16
// as it is; 16 int8 / e4m3 values converted (exactly: both fit bf16's
// 8-bit significand and its exponent range) into 32 bytes.  The 1-byte
// tensor-core kernels (K7-K9, K15, K10's tiles) make their operands so.
template <typename W>
__device__ __forceinline__ void store_bf16(const uint4& v, uint4* dst) {
  if constexpr (sizeof(W) == 2) {
    dst[0] = v;
  } else {
    W tmp[16];
    memcpy(tmp, &v, 16);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint4 o;
      o.x = pack_bf16(to_float(tmp[8 * h + 0]), to_float(tmp[8 * h + 1]));
      o.y = pack_bf16(to_float(tmp[8 * h + 2]), to_float(tmp[8 * h + 3]));
      o.z = pack_bf16(to_float(tmp[8 * h + 4]), to_float(tmp[8 * h + 5]));
      o.w = pack_bf16(to_float(tmp[8 * h + 6]), to_float(tmp[8 * h + 7]));
      dst[h] = o;
    }
  }
}

inline const char* error_string(int code) {
  if (code == kUnsupported) return "unsupported dtype, head dims or group size";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace repro
