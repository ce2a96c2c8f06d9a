// Helpers shared by the port's kernels: f32 <-> storage type conversion,
// warp reductions, the dispatch on (query dtype, K/V storage dtype, (Dk, Dv)
// head dims), the mma.sync fragments, Hopper's asynchronous primitives (TMA,
// mbarrier, wgmma, setmaxnreg), and the error-code convention of the plain C
// entry points (0 = success, a cudaError_t from cudaGetLastError() after the
// launches, kUnsupported when the arguments have no instantiation, or a
// tensor-map code below kTensorMapError).
#pragma once

#include <cuda.h>   // CUtensorMap and its enums (no libcuda link: see moe_gmm.cu)
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
// kTensorMapError - r: cuTensorMapEncodeTiled returned CUresult r (> 0);
// kTensorMapError itself: libcuda has no cuTensorMapEncodeTiled
constexpr int kTensorMapError = -1000;
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

// ------------------------------------------------------------ Hopper
//
// The asynchronous primitives of the warp-specialised kernels
// (moe_gmm.cu's gmm_wgmma_kernel): the Tensor Memory Accelerator copies a
// whole tile between device memory and shared memory on one thread's
// request and counts its bytes on an mbarrier in shared memory; wgmma
// multiplies 64-row tiles of a warpgroup (4 warps) straight from shared
// memory into f32 registers, asynchronously.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// An mbarrier whose phase completes after `count` arrivals and the bytes
// announced by expect_tx (call from one thread, then mbar_fence_init).
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA copies for this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// One arrival (a consumer releasing a ring stage).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Spins until the barrier's phase of parity `parity` has completed (a
// fresh barrier counts the phase before its first, parity 1, as complete).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// TMA: the box of a 3-D tensor map at coordinates (c0 innermost, c1, c2)
// into shared memory, its bytes counted on `bar`; elements past the
// tensor's edges land as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// TMA: a box of shared memory out to a 3-D tensor map at (c0, c1, c2);
// elements past the tensor's edges are not written.  Tracked by bulk
// groups (bulk_commit, bulk_wait_read, bulk_wait).
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.tile.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Closes this thread's issued TMA stores into one bulk group.
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most N bulk groups still read their shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Waits until at most N bulk groups are still writing device memory.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's shared-memory writes visible to the async proxy (a
// TMA store that reads them next).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier of `threads` threads (a multiple of 32) on hardware barrier
// `id` (1-15; __syncthreads is 0): one warpgroup's, for example.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Moves the registers of this warpgroup's threads down to N (a producer's)
// or up to N (a consumer's, from what the producers released).
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// The wgmma descriptor of a bf16 operand tile in shared memory laid out as
// TMA writes it with 128-byte swizzle (a 1024-byte aligned tile of
// 128-byte rows): `lbo` and `sbo` in bytes.  K-major operand (rows of 64
// contraction values): sbo = 1024 between 8-row groups, lbo unused; the
// k-th 16-deep slice starts 32 k bytes in.  MN-major operand ([k][64]
// boxes): lbo between 64-wide boxes along M or N, sbo = 1024 between
// 8-row groups along k; the k-th slice starts 2048 k bytes in.
__device__ __forceinline__ uint64_t wgmma_desc(const void* tile, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;   // layout: 128-byte swizzle
}

// Orders register writes before the wgmma that reads or accumulates them.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// Closes the wgmma issued since the last commit into one group.
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N wgmma groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Tells the compiler that the accumulators change here (after a
// wgmma_wait), so that no read of them moves above it.
template <int N>
__device__ __forceinline__ void wgmma_fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32; thread t of the warpgroup holds rows 16 (t / 32) +
// (t % 32) / 4 + 8 h, columns 8 j + 2 (t % 4) + i in d[4 j + 2 h + i]) +=
// A (64 x 16) B (16 x 128), bf16, both from shared memory through their
// descriptors; kTA / kTB: A stored M-major / B stored N-major (wgmma's
// transpose bits); scale_d 0 overwrites d instead.
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTA), "n"(kTB));
}

inline const char* error_string(int code) {
  if (code == kUnsupported) return "unsupported dtype, head dims or group size";
  if (code == kTensorMapError)
    return "libcuda has no cuTensorMapEncodeTiled";
  if (code < kTensorMapError)
    return "cuTensorMapEncodeTiled refused an operand (its CUresult is "
           "-1000 - code)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace repro
