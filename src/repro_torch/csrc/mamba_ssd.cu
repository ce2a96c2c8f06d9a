// K12: the Mamba2 SSD chunked scan for Hopper.
//
// Replaces the Pallas kernel ssd_fwd / _ssd_kernel in
// src/repro/kernels/mamba_ssd/kernel.py.  On the TPU the grid is (B, H,
// S/chunk) with the chunk axis run in order, carrying the [P, N] state in
// VMEM scratch from one grid step to the next.
//
// Per chunk of kQ rows, with cum = cumsum(dt * a) and L[i, j] =
// exp(cum_i - cum_j) for i >= j (0 otherwise), group h / (H / G) feeding
// head h:
//   y      = ((C B^T) o L) (x dt) + (C o exp(cum)) state^T
//   state <- state exp(cum_last) + x^T (B o exp(cum_last - cum) o dt)
//
// What bounds it on the H100: at the serve path's prefill shape (B = 1,
// S = 512, H = 48, P = 64, N = 128, bf16) the call moves about 8 MB (x
// and y, B and C, dt, the f32 final state) against about 1 GFLOP: bytes,
// 2.5 us at 3.35 TB/s.  This first version runs every product on the
// CUDA cores in f32 and recomputes C B^T once per P slice, so arithmetic
// and shared-memory traffic bound it; tensor cores are later work.
//
// Design: one block of 128 threads per (slice of kPS = 16 head-dim
// columns, head, batch row).  A state row state[p, :] depends only on
// column p of x, so the slices are independent: P = 64 gives 192 blocks
// at B = 1, H = 48 (one block per head would give 48 for 132 SMs).  The
// TPU's sequential chunk axis becomes a loop inside the block; the
// block's [kPS, N] state slice stays on chip for the whole sequence (in
// registers, owner thread per (n, p range), mirrored to shared memory for
// the next chunk's C state^T), so only y and the final state are
// written.  Each chunk's dt (and cum, one warp scan), B, C and x are
// staged in shared memory as f32, about 100 KB at N = 128 (dynamic shared
// memory), loaded 16 bytes at a time with several loads in flight per
// thread (the chunk's loads wait on memory once, not once per value).  Three products per chunk: C B^T as a 64 x 64 tile (each
// thread 4 rows x 8 columns), masked BEFORE exp (cum_i - cum_j for i < j
// is positive and may overflow, and inf * 0 is NaN) and scaled by dt_j;
// y from it and from C state^T; the state update from x dt decay and B.
// No atomics: a call repeats bit for bit.  Any S: rows past S load as
// zero (x, B, C and dt: their dt a is 0, so cum stays at the last valid
// row), write no y, and the chunk's decay is taken at its last valid row.
// An initial state (or zeros) seeds the scan.
//
// K13 replaces ssd_fwd_quantized / _ssd_quant_kernel (same file): K12
// with x as int8 or fp8 e4m3 and one f16 scale per (token, head).  It is
// this kernel with the other value format for x (S != T): a row's 16 x
// values are one 16-byte load, converted four to a 32-bit word
// (common.cuh), multiplied by the row's scale and rounded to B's dtype at
// load, as the reference's oracle dequantizes before its scan; y comes out
// in B's dtype.

#include "common.cuh"

#include <cstring>

namespace repro {
namespace {

constexpr int kThreads = 128;
constexpr int kQ = 64;       // chunk rows (autotune.SSD_CHUNK)
constexpr int kPS = 16;      // head-dim columns per block
static_assert(kQ == 2 * 32, "the cum scan gives each lane of a warp 2 rows");

// 16 bytes of a row, loaded at once and converted to f32: four f32, eight
// bf16, or sixteen 1-byte values (four 32-bit words, common.cuh's
// word_to_float4).
template <typename T>
struct Vec16 {
  static constexpr int kN = 16 / static_cast<int>(sizeof(T));
  __device__ static void to_float(const uint4& v, float* out);
};
template <>
__device__ __forceinline__ void Vec16<float>::to_float(const uint4& v,
                                                       float* out) {
  out[0] = __uint_as_float(v.x);
  out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z);
  out[3] = __uint_as_float(v.w);
}
template <>
__device__ __forceinline__ void Vec16<__nv_bfloat16>::to_float(
    const uint4& v, float* out) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    __nv_bfloat162 pair;
    memcpy(&pair, &w[k], sizeof(pair));
    const float2 f = __bfloat1622float2(pair);
    out[2 * k] = f.x;
    out[2 * k + 1] = f.y;
  }
}
template <typename S>
__device__ __forceinline__ void bytes16_to_float(const uint4& v, float* out) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 f = word_to_float4<S>(w[k]);
    out[4 * k] = f.x;
    out[4 * k + 1] = f.y;
    out[4 * k + 2] = f.z;
    out[4 * k + 3] = f.w;
  }
}

// Shared memory, in floats: B and C tiles [kQ][N + 1] (+1: a warp's reads
// of consecutive rows fall in distinct banks), the masked score tile
// [kQ][kQ + 1], the x tile and the decay-weighted x tile [kQ][kPS], the
// state slice [kPS][N + 1], and cum and dt [kQ].
template <int N>
constexpr int smem_floats() {
  return 2 * kQ * (N + 1) + kQ * (kQ + 1) + 2 * kQ * kPS + kPS * (N + 1) +
         2 * kQ;
}

// T: the dtype of B, C and y; S: the storage dtype of x (T itself, or
// int8_t / __nv_fp8_e4m3 with the f16 scales x_scale, null otherwise).
template <typename T, typename S, int N>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const S* __restrict__ x, const __half* __restrict__ x_scale,
           const float* __restrict__ dt, const float* __restrict__ a,
           const T* __restrict__ b_in, const T* __restrict__ c_in,
           const float* __restrict__ init, T* __restrict__ y,
           float* __restrict__ state_out, int s, int h, int p, int g) {
  constexpr bool kQuant = kQuantized<T, S>;
  constexpr int kB = N + 1;                       // B, C and state stride
  constexpr int kPer = kPS * N / kThreads;        // state entries / thread
  static_assert(kThreads % N == 0 && (kThreads / N) * kPer == kPS,
                "the state slice must split evenly over the threads");
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;
  float* cs = bs + kQ * kB;
  float* ms = cs + kQ * kB;                       // [kQ][kQ + 1]
  float* xs = ms + kQ * (kQ + 1);                 // [kQ][kPS]
  float* xw = xs + kQ * kPS;                      // x dt exp(cum_last - cum)
  float* st = xw + kQ * kPS;                      // [kPS][N + 1]
  float* cum = st + kPS * kB;
  float* dts = cum + kQ;

  const int p0 = blockIdx.x * kPS;
  const int hh = blockIdx.y;
  const int b = blockIdx.z;
  const int gg = hh / (h / g);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const float a_h = a[hh];

  // the state slice: thread tid owns entries (p0 + pb + pp, n), pp < kPer
  const int n_own = tid % N;
  const int pb = (tid / N) * kPer;
  const size_t st_base =
      (static_cast<size_t>(b) * h + hh) * p * N + static_cast<size_t>(p0) * N;
  float stv[kPer];
#pragma unroll
  for (int pp = 0; pp < kPer; ++pp) {
    const size_t off = st_base + static_cast<size_t>(pb + pp) * N + n_own;
    stv[pp] = init != nullptr ? init[off] : 0.f;
    st[(pb + pp) * kB + n_own] = stv[pp];
  }

  // the C B^T tile: thread tid computes rows rg + 16 k, columns cg + 8 m
  const int rg = tid / 8, cg = tid % 8;
  // y: thread tid computes column pc of rows r0 + 8 k
  const int pc = tid % kPS, r0 = tid / kPS;

  for (int c0 = 0; c0 < s; c0 += kQ) {
    const int nv = min(kQ, s - c0);    // valid rows of this chunk
    __syncthreads();   // the previous chunk's tiles and state are consumed

    if (warp == 0) {
      // dt and cum = cumsum(dt a) over the chunk: lane l holds rows 2l,
      // 2l + 1; rows past S get dt = 0
      const int ra = 2 * lane, rb = ra + 1;
      const size_t row0 = static_cast<size_t>(b) * s + c0;
      const float da = ra < nv ? dt[(row0 + ra) * h + hh] : 0.f;
      const float db = rb < nv ? dt[(row0 + rb) * h + hh] : 0.f;
      const float ea = da * a_h, eb = db * a_h;
      float incl = ea + eb;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
      cum[ra] = excl + ea;
      cum[rb] = (excl + ea) + eb;
      dts[ra] = da;
      dts[rb] = db;
    }
    // B and C rows, 16 bytes a load, kBatch loads of each in flight at
    // once (a loop of dependent loads would pay the memory latency once
    // per load); rows past S are zero
    {
      constexpr int kV = Vec16<T>::kN;
      constexpr int kRowVecs = N / kV;
      constexpr int kIters = kQ * kRowVecs / kThreads;
      constexpr int kBatch = kIters < 4 ? kIters : 4;
      static_assert(kIters % kBatch == 0, "whole batches of loads");
#pragma unroll
      for (int it0 = 0; it0 < kIters; it0 += kBatch) {
        uint4 bv[kBatch], cv[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int i = tid + (it0 + k) * kThreads;
          const int r = i / kRowVecs, c = (i % kRowVecs) * kV;
          bv[k] = cv[k] = make_uint4(0u, 0u, 0u, 0u);
          if (r < nv) {
            const size_t off =
                ((static_cast<size_t>(b) * s + c0 + r) * g + gg) * N + c;
            bv[k] = *reinterpret_cast<const uint4*>(b_in + off);
            cv[k] = *reinterpret_cast<const uint4*>(c_in + off);
          }
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int i = tid + (it0 + k) * kThreads;
          const int r = i / kRowVecs, c = (i % kRowVecs) * kV;
          float fb[kV], fc[kV];
          Vec16<T>::to_float(bv[k], fb);
          Vec16<T>::to_float(cv[k], fc);
#pragma unroll
          for (int e = 0; e < kV; ++e) {
            bs[r * kB + c + e] = fb[e];
            cs[r * kB + c + e] = fc[e];
          }
        }
      }
    }
    // the x tile: a row's kPS values are 16-byte aligned (p and p0 are
    // multiples of 16; the wrapper checks the base pointer)
    if constexpr (kQuant) {
      // one 16-byte load per row (sixteen 1-byte values), scaled by the
      // row's scale and rounded to B's dtype, as the oracle dequantizes
      static_assert(kPS == 16, "one 16-byte load per quantized row");
      if (tid < kQ) {
        const int r = tid;
        float v[kPS];
        if (r < nv) {
          const size_t row = (static_cast<size_t>(b) * s + c0 + r) * h + hh;
          const float sc = to_float(x_scale[row]);
          bytes16_to_float<S>(
              *reinterpret_cast<const uint4*>(x + row * p + p0), v);
#pragma unroll
          for (int e = 0; e < kPS; ++e)
            v[e] = to_float(from_float<T>(v[e] * sc));
        } else {
#pragma unroll
          for (int e = 0; e < kPS; ++e) v[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < kPS; e += 4)
          *reinterpret_cast<float4*>(&xs[r * kPS + e]) =
              make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
      }
    } else {
      constexpr int kV = Vec16<T>::kN;
      constexpr int kRowVecs = kPS / kV;
      constexpr int kIters = kQ * kRowVecs / kThreads;
      uint4 xv[kIters];
#pragma unroll
      for (int k = 0; k < kIters; ++k) {
        const int i = tid + k * kThreads;
        const int r = i / kRowVecs, c = (i % kRowVecs) * kV;
        xv[k] = make_uint4(0u, 0u, 0u, 0u);
        if (r < nv)
          xv[k] = *reinterpret_cast<const uint4*>(
              x + ((static_cast<size_t>(b) * s + c0 + r) * h + hh) * p + p0 +
              c);
      }
#pragma unroll
      for (int k = 0; k < kIters; ++k) {
        const int i = tid + k * kThreads;
        const int r = i / kRowVecs, c = (i % kRowVecs) * kV;
        float v[kV];
        Vec16<T>::to_float(xv[k], v);
#pragma unroll
        for (int e = 0; e < kV; e += 4)
          *reinterpret_cast<float4*>(&xs[r * kPS + c + e]) =
              make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
      }
    }
    __syncthreads();

    // the chunk's decay is taken at its last valid row
    const float cum_last = cum[nv - 1];
    {
      float acc[4][8];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int m = 0; m < 8; ++m) acc[k][m] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[8];
#pragma unroll
        for (int k = 0; k < 4; ++k) cv[k] = cs[(rg + 16 * k) * kB + n];
#pragma unroll
        for (int m = 0; m < 8; ++m) bv[m] = bs[(cg + 8 * m) * kB + n];
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int m = 0; m < 8; ++m) acc[k][m] += cv[k] * bv[m];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = rg + 16 * k;
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const int j = cg + 8 * m;
          // mask before exp: cum_i - cum_j <= 0 only for j <= i
          ms[i * (kQ + 1) + j] =
              j <= i ? acc[k][m] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
        }
      }
    }
    for (int i = tid; i < kQ * kPS; i += kThreads) {
      const int r = i / kPS;
      xw[i] = xs[i] * (expf(cum_last - cum[r]) * dts[r]);
    }
    __syncthreads();

    {
      constexpr int kRows = kQ / (kThreads / kPS);   // 8 rows per thread
      float acc[kRows], inter[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) acc[k] = inter[k] = 0.f;
#pragma unroll 4
      for (int j = 0; j < kQ; ++j) {
        const float xv = xs[j * kPS + pc];
#pragma unroll
        for (int k = 0; k < kRows; ++k)
          acc[k] += ms[(r0 + 8 * k) * (kQ + 1) + j] * xv;
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float sv = st[pc * kB + n];
#pragma unroll
        for (int k = 0; k < kRows; ++k)
          inter[k] += cs[(r0 + 8 * k) * kB + n] * sv;
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int i = r0 + 8 * k;
        if (i < nv)
          y[((static_cast<size_t>(b) * s + c0 + i) * h + hh) * p + p0 + pc] =
              from_float<T>(acc[k] + expf(cum[i]) * inter[k]);
      }
    }
    __syncthreads();   // every read of the entering state is done

    {
      const float decay = expf(cum_last);
      float con[kPer];
#pragma unroll
      for (int pp = 0; pp < kPer; ++pp) con[pp] = 0.f;
#pragma unroll 4
      for (int j = 0; j < kQ; ++j) {
        const float bv = bs[j * kB + n_own];
#pragma unroll
        for (int pp = 0; pp < kPer; ++pp)
          con[pp] += xw[j * kPS + pb + pp] * bv;
      }
#pragma unroll
      for (int pp = 0; pp < kPer; ++pp) {
        stv[pp] = stv[pp] * decay + con[pp];
        st[(pb + pp) * kB + n_own] = stv[pp];
      }
    }
  }

#pragma unroll
  for (int pp = 0; pp < kPer; ++pp)
    state_out[st_base + static_cast<size_t>(pb + pp) * N + n_own] = stv[pp];
}

struct SsdLaunch {
  const void *x, *x_scale, *dt, *a, *b_in, *c_in, *init;
  void *y, *state;
  int bsz, s, h, p, g;
  cudaStream_t stream;

  template <typename T, typename S, int N>
  int run() const {
    const int smem = smem_floats<N>() * static_cast<int>(sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<T, S, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_kernel<T, S, N><<<dim3(p / kPS, h, bsz), kThreads, smem, stream>>>(
        static_cast<const S*>(x), static_cast<const __half*>(x_scale),
        static_cast<const float*>(dt), static_cast<const float*>(a),
        static_cast<const T*>(b_in), static_cast<const T*>(c_in),
        static_cast<const float*>(init), static_cast<T*>(y),
        static_cast<float*>(state), s, h, p, g);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename T, typename S>
int dispatch_state(int n, const SsdLaunch& launch) {
  switch (n) {
    case 16: return launch.run<T, S, 16>();
    case 64: return launch.run<T, S, 64>();
    case 128: return launch.run<T, S, 128>();
    default: return kUnsupported;
  }
}

bool supported(int bsz, int s, int h, int p, int g, int chunk) {
  return bsz > 0 && s > 0 && h > 0 && g > 0 && h % g == 0 &&
         (p == 16 || p == 32 || p == 64) && chunk == kQ;
}

}  // namespace
}  // namespace repro

// K12.  x [B, S, H, P] and y (dtype `dtype`, float32 or bfloat16), dt
// [B, S, H] f32, a [H] f32, b_in and c_in [B, S, G, N] (dtype `dtype`),
// init [B, H, P, N] f32 or null (zeros), state [B, H, P, N] f32 out; all
// contiguous.  P in {16, 32, 64}, N in {16, 64, 128}, chunk == 64.
extern "C" int ssd_fwd(const void* x, const void* dt, const void* a,
                       const void* b_in, const void* c_in, void* y,
                       void* state, const void* init, int bsz, int s, int h,
                       int p, int g, int n, int chunk, int dtype,
                       void* stream) {
  if (!repro::supported(bsz, s, h, p, g, chunk)) return repro::kUnsupported;
  const repro::SsdLaunch launch{x, nullptr, dt, a, b_in, c_in, init, y,
                                state, bsz, s, h, p, g,
                                static_cast<cudaStream_t>(stream)};
  if (dtype == repro::kFloat32)
    return repro::dispatch_state<float, float>(n, launch);
  if (dtype == repro::kBFloat16)
    return repro::dispatch_state<__nv_bfloat16, __nv_bfloat16>(n, launch);
  return repro::kUnsupported;
}

// K13.  K12 with x [B, S, H, P] of storage dtype `store` (int8 or fp8
// e4m3) and x_scale [B, S, H, 1] f16; b_in, c_in and y of dtype `dtype`.
extern "C" int ssd_fwd_quantized(const void* x, const void* x_scale,
                                 const void* dt, const void* a,
                                 const void* b_in, const void* c_in, void* y,
                                 void* state, const void* init, int bsz,
                                 int s, int h, int p, int g, int n, int chunk,
                                 int dtype, int store, void* stream) {
  if (!repro::supported(bsz, s, h, p, g, chunk)) return repro::kUnsupported;
  const repro::SsdLaunch launch{x, x_scale, dt, a, b_in, c_in, init, y,
                                state, bsz, s, h, p, g,
                                static_cast<cudaStream_t>(stream)};
  if (dtype == repro::kFloat32) {
    if (store == repro::kInt8)
      return repro::dispatch_state<float, int8_t>(n, launch);
    if (store == repro::kFloat8E4M3)
      return repro::dispatch_state<float, __nv_fp8_e4m3>(n, launch);
  } else if (dtype == repro::kBFloat16) {
    if (store == repro::kInt8)
      return repro::dispatch_state<__nv_bfloat16, int8_t>(n, launch);
    if (store == repro::kFloat8E4M3)
      return repro::dispatch_state<__nv_bfloat16, __nv_fp8_e4m3>(n, launch);
  }
  return repro::kUnsupported;
}

extern "C" const char* repro_error_string(int code) {
  return repro::error_string(code);
}
