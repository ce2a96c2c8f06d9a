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
// 2.5 us at 3.35 TB/s.  Two paths, picked by B's dtype: bf16 (the
// model's serve dtype) runs the four products of a chunk on the tensor
// cores, ssd_mma_kernel ("bf16 on the tensor cores" below); f32, the
// parity dtype the card-vs-CPU checks hold to 1e-5, keeps the first
// version, ssd_kernel, whose products run on the CUDA cores in f32 and
// recompute C B^T once per 16-column P slice, so that arithmetic and
// shared-memory traffic bound it.
//
// Design of the f32 kernel: one block of 128 threads per (slice of kPS =
// 16 head-dim columns, head, batch row).  A state row state[p, :] depends
// only on column p of x, so the slices are independent: P = 64 gives 192
// blocks at B = 1, H = 48 (one block per head would give 48 for 132 SMs).
// The TPU's sequential chunk axis becomes a loop inside the block; the
// block's [kPS, N] state slice stays on chip for the whole sequence (in
// registers, owner thread per (n, p range), mirrored to shared memory for
// the next chunk's C state^T), so only y and the final state are
// written.  Each chunk's dt (and cum, one warp scan), B, C and x are
// staged in shared memory as f32, about 100 KB at N = 128 (dynamic shared
// memory), loaded 16 bytes at a time with several loads in flight per
// thread (the chunk's loads wait on memory once, not once per value).
// Three products per chunk: C B^T as a 64 x 64 tile (each thread 4 rows x
// 8 columns), masked BEFORE exp (cum_i - cum_j for i < j is positive and
// may overflow, and inf * 0 is NaN) and scaled by dt_j; y from it and from
// C state^T; the state update from x dt decay and B.  No atomics: a call
// repeats bit for bit.  Any S: rows past S load as zero (x, B, C and dt:
// their dt a is 0, so cum stays at the last valid row), write no y, and
// the chunk's decay is taken at its last valid row.  An initial state (or
// zeros) seeds the scan.
//
// K13 replaces ssd_fwd_quantized / _ssd_quant_kernel (same file): K12
// with x as int8 or fp8 e4m3 and one f16 scale per (token, head).  It is
// this kernel with the other value format for x (S != T), in both paths:
// each x value is multiplied by its row's scale and rounded to B's dtype
// where it is staged, as the reference's oracle dequantizes before its
// scan; y comes out in B's dtype.  In bf16 that rounded value is the very
// operand K12 reads from a bf16 x, so bf16 K13 equals bf16 K12 on
// dequantize(x_q, x_scale).bfloat16() bit for bit.
//
// bf16 on the tensor cores (ssd_mma_kernel): one block of Q / 16 warps
// per (slice of PB head-dim columns, head, batch row), PB = min(P, 32)
// fixed at dispatch (mma_p_block below): at the served P = 64 the 96
// blocks of halves beat 48 whole heads and 192 quarters on 132 SMs, though
// each slice repeats C B^T (measured on the H100, PERF.md).  The chunk Q
// is a template argument, the caller's choice among the built instances
// (64 everywhere, 32 and 128 at the served (PB, N) pairs; the f32 kernel
// and K16 keep kQ = 64): a longer chunk halves the sequential state
// handoffs, a shorter one the quadratic in-chunk work.  A block's shared
// memory (SsdMmaSmem) at Q = 64 is 96.5 KB at PB = 32, N = 128 (97.75 KB
// for K13), so two blocks share an SM's 227 KB.  Per chunk of Q rows the
// block runs four products as mma.sync m16n8k16 (bf16 in, f32
// accumulate), warp w owning chunk rows 16 w .. 16 w + 15 for the first
// three:
//   1. S = C B^T over N, C and B raw bf16 tiles read with ldmatrix; only
//      the 16-column slabs at or left of the warp's diagonal (causal), C
//      B^T once per chunk and P slice;
//   2. y += M x, M = mask(S) o exp(cum_i - cum_j) o dt_j formed one
//      16-column slab at a time and rounded to bf16 as the A operand
//      straight from the accumulators (masked before exp, as above);
//   3. y = exp(cum_i) (C state^T)[i, :] (computed first, scaled after the
//      product), the entering state read as bf16: y is rounded to bf16
//      anyway, so the state operand's rounding (2^-9 of a term) stays
//      within y's tolerance;
//   4. state <- state exp(cum_last) + (x o w)^T B, w_j = exp(cum_last -
//      cum_j) dt_j.  The state stays in f32 accumulator fragments for the
//      whole sequence (the warps split its [PB, N] tiles) and is what every
//      decode step continues from, held to 1e-5: a decay-weighted operand
//      rounded once to bf16 would cost 2^-9 of a term, so x o w (f32) is
//      split into a bf16 high part and the bf16 rounding of the rest, two
//      products, about 2^-17 of a term.  The split is formed in registers
//      from the ldmatrix'd x fragments: no pass over shared memory.
// The new state, rounded to bf16, goes to the other of two state buffers
// for the next chunk's product 3, so a chunk needs one barrier.  A 2-stage
// cp.async ring brings chunk c + 1's C, B, x and dt (rows past S as zeros,
// without a read) while chunk c is computed; each warp scans cum itself
// (two values a lane, shuffles) into its own shared array.  K13 stages its
// 1-byte x through the ring and converts it, scaled, into a bf16 tile
// after the barrier (a second barrier); the row scales are loaded a chunk
// ahead into registers.  The chunk's decay is taken at its last valid
// row; no atomics, so a call repeats bit for bit.

#include "common.cuh"

#include <cstring>

namespace repro {
namespace {

constexpr int kThreads = 128;
constexpr int kQ = 64;       // chunk rows (autotune.SSD_CHUNK)
constexpr int kPS = 16;      // head-dim columns per block
static_assert(kQ == 2 * 32, "the cum scan gives each lane of a warp 2 rows");

// 16 bytes of a row, loaded at once and converted to f32: four f32 (the
// f32 kernel's B, C and x), or sixteen 1-byte values (four 32-bit words,
// common.cuh's word_to_float4).
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
// state slice [kPS][N + 1], cum [kQ] in f64 (8-byte aligned: every region
// before it is an even number of floats) and dt [kQ].
template <int N>
constexpr int smem_floats() {
  return 2 * kQ * (N + 1) + kQ * (kQ + 1) + 2 * kQ * kPS + kPS * (N + 1) +
         3 * kQ;
}

// T: the dtype of B, C and y (float: bf16 runs ssd_mma_kernel); S: the
// storage dtype of x (T itself, or int8_t / __nv_fp8_e4m3 with the f16
// scales x_scale, null otherwise).
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
  double* cum = reinterpret_cast<double*>(st + kPS * kB);
  float* dts = reinterpret_cast<float*>(cum + kQ);

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
      // 2l + 1; rows past S get dt = 0.  cum runs in f64: the decay's
      // exponents are differences of it, and a tree scan in f32 rounds
      // neighbouring rows' sums apart by up to |cum| 2^-24 (1.7e-5 of y
      // against the plain version at chip_smoke phase 3c's ragged shape,
      // H100), where a sequential one keeps them together.
      const int ra = 2 * lane, rb = ra + 1;
      const size_t row0 = static_cast<size_t>(b) * s + c0;
      const float da = ra < nv ? dt[(row0 + ra) * h + hh] : 0.f;
      const float db = rb < nv ? dt[(row0 + rb) * h + hh] : 0.f;
      const double ea = static_cast<double>(da) * a_h;
      const double eb = static_cast<double>(db) * a_h;
      double incl = ea + eb;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      double excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.0;
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
    const double cum_last = cum[nv - 1];
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
              j <= i ? acc[k][m] * expf(static_cast<float>(cum[i] - cum[j])) *
                           dts[j]
                     : 0.f;
        }
      }
    }
    for (int i = tid; i < kQ * kPS; i += kThreads) {
      const int r = i / kPS;
      xw[i] = xs[i] * (expf(static_cast<float>(cum_last - cum[r])) * dts[r]);
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
              from_float<T>(acc[k] + expf(static_cast<float>(cum[i])) *
                                         inter[k]);
      }
    }
    __syncthreads();   // every read of the entering state is done

    {
      const float decay = expf(static_cast<float>(cum_last));
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

// ------------------------------------------------- bf16 on the tensor cores

// Shared memory of ssd_mma_kernel<S, PB, N, Q>, in bytes: two ring
// stages, each the chunk's C and B tiles ([Q][N + 8] bf16), its x tile
// ([Q][PB + 8] bf16, or [Q][PB + 16] bytes for K13) and its dt ([Q] f32);
// two [PB][N + 8] bf16 state buffers; each warp's cum ([Q] f32); for K13
// the converted [Q][PB + 8] bf16 x tile and the chunk's Q row scales
// (f32).  Every row is padded by 16 bytes, so that the 8 row addresses of
// each ldmatrix fall in distinct banks.  At PB = 32, N = 128: 56.5 KB at Q
// = 32 (3 blocks an SM), 96.5 KB at 64 (2), 178 KB at 128 (1); K13 adds
// Q (2 PB + 20) bytes.
template <typename S, int PB, int N, int Q>
struct SsdMmaSmem {
  static constexpr bool kQuant = !std::is_same<S, bf16>::value;
  static constexpr int kNS = N + 8;                 // C, B, state row stride
  static constexpr int kXS = PB + 8;                // bf16 x row stride
  static constexpr int kXRow = kQuant ? PB + 16 : 2 * kXS;   // staged x row
  static constexpr int kCOff = 0;
  static constexpr int kBOff = kCOff + 2 * Q * kNS;
  static constexpr int kXOff = kBOff + 2 * Q * kNS;
  static constexpr int kDtOff = kXOff + Q * kXRow;
  static constexpr int kStage = kDtOff + 4 * Q;
  static constexpr int kStOff = 2 * kStage;
  static constexpr int kStBytes = 2 * PB * kNS;
  static constexpr int kCumOff = kStOff + 2 * kStBytes;
  static constexpr int kXqOff = kCumOff + 4 * (Q / 16) * Q;   // a warp's cum
  static constexpr int kScOff = kXqOff + (kQuant ? 2 * Q * kXS : 0);
  static constexpr int kBytes = kScOff + (kQuant ? 4 * Q : 0);
  static_assert(kXRow % 16 == 0 && kStage % 16 == 0 && kStBytes % 16 == 0,
                "16-byte aligned rows and regions");
  static_assert(kBytes <= 227 * 1024, "a block opts into at most 227 KB");
};

// S: the storage type of x (bf16 for K12; int8_t or __nv_fp8_e4m3 with the
// f16 scales x_scale for K13, null otherwise); B, C and y are bf16.  Q:
// the chunk's rows, Q / 16 warps of 16 (32, 64 or 128: the caller's
// choice among the built instances, mma_chunk; 64 is the analytic pick).
// The chunk moves where the state is handed on and which rows' products
// meet in one f32 sum, so two chunks agree within rounding, not bit for
// bit (y within the bf16 tolerance of the plain version at that chunk).
template <typename S, int PB, int N, int Q>
__global__ void __launch_bounds__(2 * Q, 1)
ssd_mma_kernel(const S* __restrict__ x, const __half* __restrict__ x_scale,
               const float* __restrict__ dt, const float* __restrict__ a,
               const bf16* __restrict__ b_in, const bf16* __restrict__ c_in,
               const float* __restrict__ init, bf16* __restrict__ y,
               float* __restrict__ state_out, int s, int h, int p, int g) {
  using L = SsdMmaSmem<S, PB, N, Q>;
  constexpr int kQ = Q;
  constexpr int kThreads = 2 * Q;      // Q / 16 warps
  constexpr int kW = Q / 16;
  static_assert(Q % 32 == 0 && Q <= 128, "a lane scans Q / 32 rows");
  constexpr bool kQuant = L::kQuant;
  constexpr int kNS = L::kNS, kXS = L::kXS;
  constexpr int kKN = N / 16;          // mma steps over N
  constexpr int kYT = PB / 8;          // 8-column tiles of a warp's y rows
  constexpr int kNP = N / 16;          // 16-column pairs of a state row tile
  constexpr int kUnits = PB / 16 * kNP;          // (row tile, pair) units
  constexpr int kUPW = kUnits >= kW ? kUnits / kW : 1;  // units a warp owns
  static_assert(kNP % kUPW == 0 && (kUnits < kW || kUnits % kW == 0),
                "a warp's units share one row tile");
  extern __shared__ __align__(16) unsigned char ssd_smem[];

  const int p0 = blockIdx.x * PB;
  const int hh = blockIdx.y;
  const int b = blockIdx.z;
  const int gg = hh / (h / g);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, t2 = (lane % 4) * 2;
  const int fr = frag_row(lane), fc = frag_col(lane);
  const int br = brow(lane), bc = bcol(lane);
  const float a_h = a[hh];
  const int n_chunks = (s + kQ - 1) / kQ;
  float* cum = reinterpret_cast<float*>(ssd_smem + L::kCumOff) + warp * kQ;
  bf16* st_buf = reinterpret_cast<bf16*>(ssd_smem + L::kStOff);

  // chunk c's C, B, x and dt into stage c % 2, then a commit (an empty
  // group past the last chunk); rows past S land as zeros without a read
  const auto fetch = [&](int c) {
    if (c < n_chunks) {
      unsigned char* stg = ssd_smem + (c % 2) * L::kStage;
      const int c0 = c * kQ, nv = min(kQ, s - c0);
      constexpr int kRowC = N / 8;                 // 16-byte chunks a row
      constexpr int kBC = 2 * kQ * kRowC;
#pragma unroll
      for (int u = 0; u < (kBC + kThreads - 1) / kThreads; ++u) {
        const int i = tid + u * kThreads;
        if (kBC % kThreads != 0 && i >= kBC) break;
        const int which = i / (kQ * kRowC);        // 0: C, 1: B
        const int r = (i / kRowC) % kQ, cc = i % kRowC;
        const bool live = r < nv;
        const size_t row =
            (static_cast<size_t>(b) * s + c0 + (live ? r : 0)) * g + gg;
        cp_async16(stg + (which ? L::kBOff : L::kCOff) + 2 * (r * kNS + cc * 8),
                   (which ? b_in : c_in) + row * N + cc * 8, live);
      }
      constexpr int kXC = PB * static_cast<int>(sizeof(S)) / 16;
#pragma unroll
      for (int u = 0; u < (kQ * kXC + kThreads - 1) / kThreads; ++u) {
        const int i = tid + u * kThreads;
        if ((kQ * kXC) % kThreads != 0 && i >= kQ * kXC) break;
        const int r = i / kXC, cc = i % kXC;
        const bool live = r < nv;
        const size_t row =
            (static_cast<size_t>(b) * s + c0 + (live ? r : 0)) * h + hh;
        cp_async16(stg + L::kXOff + r * L::kXRow + cc * 16,
                   reinterpret_cast<const unsigned char*>(x + row * p + p0) +
                       cc * 16,
                   live);
      }
      if (tid < kQ) {
        const bool live = tid < nv;
        cp_async4(stg + L::kDtOff + 4 * tid,
                  dt + (static_cast<size_t>(b) * s + c0 + (live ? tid : 0)) * h
                      + hh,
                  live);
      }
    }
    cp_async_commit();
  };
  // K13: thread r < Q holds the scale of row r of the next chunk (0 past
  // S), loaded a chunk ahead so that its latency hides behind a chunk
  const auto scale_of = [&](int c) -> float {
    if (!kQuant || tid >= kQ || c >= n_chunks || c * kQ + tid >= s)
      return 0.f;
    return to_float(
        x_scale[(static_cast<size_t>(b) * s + c * kQ + tid) * h + hh]);
  };
  fetch(0);
  float sc_next = scale_of(0);

  // the warp's state units: row tile mt (rows p0 + 16 mt ..), column pairs
  // np0 .. np0 + kUPW - 1; warps past kUnits own none
  const bool owner = warp * kUPW < kUnits;
  const int mt = (warp * kUPW) / kNP, np0 = (warp * kUPW) % kNP;
  float st[kUPW][2][4];
  {
    const size_t base = (static_cast<size_t>(b) * h + hh) * p * N;
#pragma unroll
    for (int u = 0; u < kUPW; ++u)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int n = (np0 + u) * 16 + k * 8 + t2;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int pr = mt * 16 + gr + 8 * e;
          float2 v = make_float2(0.f, 0.f);
          if (owner && init != nullptr)
            v = *reinterpret_cast<const float2*>(
                init + base + static_cast<size_t>(p0 + pr) * N + n);
          st[u][k][2 * e] = v.x;
          st[u][k][2 * e + 1] = v.y;
          if (owner)
            *reinterpret_cast<uint32_t*>(st_buf + pr * kNS + n) =
                pack_bf16(v.x, v.y);
        }
      }
  }

  float* scs = reinterpret_cast<float*>(ssd_smem + L::kScOff);   // K13
  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = c * kQ, nv = min(kQ, s - c0);
    if constexpr (kQuant) {
      if (tid < kQ) scs[tid] = sc_next;   // chunk c - 1's scales are consumed
      sc_next = scale_of(c + 1);
    }
    cp_async_wait<0>();
    __syncthreads();   // chunk c landed, chunk c - 1 and its state consumed
    fetch(c + 1);
    const unsigned char* stg = ssd_smem + (c % 2) * L::kStage;
    const bf16* cs = reinterpret_cast<const bf16*>(stg + L::kCOff);
    const bf16* bs = reinterpret_cast<const bf16*>(stg + L::kBOff);
    const float* dts = reinterpret_cast<const float*>(stg + L::kDtOff);
    const bf16* xs = reinterpret_cast<const bf16*>(stg + L::kXOff);
    if constexpr (kQuant) {
      // x's bytes times the row's scale, rounded to bf16, into the x tile
      bf16* xq = reinterpret_cast<bf16*>(ssd_smem + L::kXqOff);
#pragma unroll
      for (int u = 0; u < (kQ * PB / 16 + kThreads - 1) / kThreads; ++u) {
        const int i = tid + u * kThreads;
        if ((kQ * PB / 16) % kThreads != 0 && i >= kQ * PB / 16) break;
        const int r = i / (PB / 16), cc = i % (PB / 16);
        float v[16];
        bytes16_to_float<S>(
            *reinterpret_cast<const uint4*>(stg + L::kXOff + r * L::kXRow +
                                            cc * 16),
            v);
        const float sc = scs[r];
        uint32_t w[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          w[e] = pack_bf16(v[2 * e] * sc, v[2 * e + 1] * sc);
        uint4* dst = reinterpret_cast<uint4*>(xq + r * kXS + cc * 16);
        dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
        dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
      }
      __syncthreads();
      xs = xq;
    }
    // cum = cumsum(dt a) over the chunk, in the warp's own array: lane l
    // holds rows kR l .. kR l + kR - 1 (rows past S have dt = 0); at Q = 64
    // the sums of the first version (two rows a lane) in its order
    {
      constexpr int kR = Q / 32;
      float ev[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) ev[r] = dts[kR * lane + r] * a_h;
      float incl = ev[0];
#pragma unroll
      for (int r = 1; r < kR; ++r) incl += ev[r];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      float run = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) run = 0.f;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        run += ev[r];
        cum[kR * lane + r] = run;
      }
    }
    __syncwarp();

    // the warp's C rows as A operands, for products 1 and 3
    uint32_t cf[kKN][4];
#pragma unroll
    for (int ks = 0; ks < kKN; ++ks)
      ldmatrix_x4(cf[ks], cs + (warp * 16 + fr) * kNS + ks * 16 + fc);

    // 3: y = exp(cum_i) (C state^T), the entering state in bf16
    float yv[kYT][4];
#pragma unroll
    for (int n = 0; n < kYT; ++n) yv[n][0] = yv[n][1] = yv[n][2] = yv[n][3] = 0.f;
    const bf16* st_in = st_buf + (c % 2) * PB * kNS;
#pragma unroll
    for (int ks = 0; ks < kKN; ++ks)
#pragma unroll
      for (int np = 0; np < PB / 16; ++np) {
        uint32_t sb[4];
        ldmatrix_x4(sb, st_in + (np * 16 + br) * kNS + ks * 16 + bc);
        mma_bf16(yv[2 * np], cf[ks], sb[0], sb[1]);
        mma_bf16(yv[2 * np + 1], cf[ks], sb[2], sb[3]);
      }
    const int i0 = warp * 16 + gr, i1 = i0 + 8;
    const float ci0 = cum[i0], ci1 = cum[i1];
    {
      const float e0 = expf(ci0), e1 = expf(ci1);
#pragma unroll
      for (int n = 0; n < kYT; ++n) {
        yv[n][0] *= e0;
        yv[n][1] *= e0;
        yv[n][2] *= e1;
        yv[n][3] *= e1;
      }
    }
    // 1 and 2, one 16-column slab of S at a time up to the diagonal
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk) {
      if (kk > warp) break;
      float sc[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < kKN; ++ks) {
        uint32_t kb[4];
        ldmatrix_x4(kb, bs + (kk * 16 + br) * kNS + ks * 16 + bc);
        mma_bf16(sc[0], cf[ks], kb[0], kb[1]);
        mma_bf16(sc[1], cf[ks], kb[2], kb[3]);
      }
      uint32_t pa[4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int j = kk * 16 + hf * 8 + t2;
        const float cj0 = cum[j], cj1 = cum[j + 1];
        const float d0 = dts[j], d1 = dts[j + 1];
        // mask before exp: cum_i - cum_j <= 0 only for j <= i
        const float m00 = j <= i0 ? sc[hf][0] * expf(ci0 - cj0) * d0 : 0.f;
        const float m01 = j + 1 <= i0 ? sc[hf][1] * expf(ci0 - cj1) * d1 : 0.f;
        const float m10 = j <= i1 ? sc[hf][2] * expf(ci1 - cj0) * d0 : 0.f;
        const float m11 = j + 1 <= i1 ? sc[hf][3] * expf(ci1 - cj1) * d1 : 0.f;
        pa[2 * hf] = pack_bf16(m00, m01);
        pa[2 * hf + 1] = pack_bf16(m10, m11);
      }
#pragma unroll
      for (int np = 0; np < PB / 16; ++np) {
        uint32_t xb[4];
        ldmatrix_x4_trans(xb, xs + (kk * 16 + fr) * kXS + np * 16 + fc);
        mma_bf16(yv[2 * np], pa, xb[0], xb[1]);
        mma_bf16(yv[2 * np + 1], pa, xb[2], xb[3]);
      }
    }
    {
      const size_t row0 = (static_cast<size_t>(b) * s + c0) * h + hh;
#pragma unroll
      for (int n = 0; n < kYT; ++n) {
        const int col = p0 + n * 8 + t2;
        if (i0 < nv)
          *reinterpret_cast<__nv_bfloat162*>(
              y + (row0 + static_cast<size_t>(i0) * h) * p + col) =
              __floats2bfloat162_rn(yv[n][0], yv[n][1]);
        if (i1 < nv)
          *reinterpret_cast<__nv_bfloat162*>(
              y + (row0 + static_cast<size_t>(i1) * h) * p + col) =
              __floats2bfloat162_rn(yv[n][2], yv[n][3]);
      }
    }

    // 4: state <- state exp(cum_last) + (x o w)^T B, x o w split in two
    // bf16 parts; the chunk's decay is taken at its last valid row
    if (owner) {
      const float cl = cum[nv - 1];
      const float decay = expf(cl);
#pragma unroll
      for (int u = 0; u < kUPW; ++u)
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[u][k][e] *= decay;
#pragma unroll
      for (int ks = 0; ks < kQ / 16; ++ks) {
        // x^T's A operand: (p = g, j = 2t, 2t + 1), (g + 8, ..), then j + 8
        uint32_t xa[4];
        ldmatrix_x4_trans(xa, xs + (ks * 16 + br) * kXS + mt * 16 + bc);
        const int j0 = ks * 16 + t2, j1 = j0 + 8;
        const float w[4] = {expf(cl - cum[j0]) * dts[j0],
                            expf(cl - cum[j0 + 1]) * dts[j0 + 1],
                            expf(cl - cum[j1]) * dts[j1],
                            expf(cl - cum[j1 + 1]) * dts[j1 + 1]};
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          __nv_bfloat162 pair;
          memcpy(&pair, &xa[r], sizeof(pair));
          const float2 xv = __bfloat1622float2(pair);
          const float v0 = xv.x * w[(r / 2) * 2], v1 = xv.y * w[(r / 2) * 2 + 1];
          const __nv_bfloat162 top = __floats2bfloat162_rn(v0, v1);
          const float2 tf = __bfloat1622float2(top);
          memcpy(&hi[r], &top, sizeof(top));
          lo[r] = pack_bf16(v0 - tf.x, v1 - tf.y);
        }
#pragma unroll
        for (int u = 0; u < kUPW; ++u) {
          uint32_t bq[4];
          ldmatrix_x4_trans(bq,
                            bs + (ks * 16 + fr) * kNS + (np0 + u) * 16 + fc);
          mma_bf16(st[u][0], lo, bq[0], bq[1]);
          mma_bf16(st[u][0], hi, bq[0], bq[1]);
          mma_bf16(st[u][1], lo, bq[2], bq[3]);
          mma_bf16(st[u][1], hi, bq[2], bq[3]);
        }
      }
      // the leaving state in bf16, into the other buffer, for chunk c + 1
      bf16* st_out = st_buf + ((c + 1) % 2) * PB * kNS;
#pragma unroll
      for (int u = 0; u < kUPW; ++u)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int n = (np0 + u) * 16 + k * 8 + t2;
          const int pr = mt * 16 + gr;
          *reinterpret_cast<uint32_t*>(st_out + pr * kNS + n) =
              pack_bf16(st[u][k][0], st[u][k][1]);
          *reinterpret_cast<uint32_t*>(st_out + (pr + 8) * kNS + n) =
              pack_bf16(st[u][k][2], st[u][k][3]);
        }
    }
  }
  cp_async_wait<0>();   // only empty groups remain

  if (owner) {
    const size_t base = (static_cast<size_t>(b) * h + hh) * p * N;
#pragma unroll
    for (int u = 0; u < kUPW; ++u)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int n = (np0 + u) * 16 + k * 8 + t2;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int pr = p0 + mt * 16 + gr + 8 * e;
          *reinterpret_cast<float2*>(state_out + base +
                                     static_cast<size_t>(pr) * N + n) =
              make_float2(st[u][k][2 * e], st[u][k][2 * e + 1]);
        }
      }
  }
}

// Head-dim columns one tensor-core block takes: 32, or the whole head where
// it is narrower (the grid is P / PB slices x H x B).
constexpr int mma_p_block(int p) { return p < 32 ? p : 32; }

// The chunks the tensor-core kernel is built for at (PB, N): 64 at every
// pair; 32 and 128 besides at the served pairs (32 head-dim columns a
// block, N = 64 or 128: mamba2-780m, zamba2-2.7b).  ops.chunks mirrors it.
constexpr bool mma_chunk_built(int pb, int n, int chunk) {
  return chunk == kQ || ((chunk == 32 || chunk == 128) && pb == 32 &&
                         (n == 64 || n == 128));
}

struct SsdLaunch {
  const void *x, *x_scale, *dt, *a, *b_in, *c_in, *init;
  void *y, *state;
  int bsz, s, h, p, g, chunk;
  cudaStream_t stream;

  // bf16 (T) on the tensor cores, mma_p_block(P) head-dim columns a block,
  // at the chunk the caller chose (mma_chunk); f32 on the CUDA cores at kQ
  template <typename T, typename S, int N>
  int run() const {
    if constexpr (std::is_same<T, bf16>::value) {
      switch (p) {
        case 16: return mma_chunk<S, mma_p_block(16), N>();
        case 32: return mma_chunk<S, mma_p_block(32), N>();
        case 64: return mma_chunk<S, mma_p_block(64), N>();
        default: return kUnsupported;
      }
    } else {
      if (chunk != kQ) return kUnsupported;
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
  }

  template <typename S, int PB, int N>
  int mma_chunk() const {
    if (!mma_chunk_built(PB, N, chunk)) return kUnsupported;
    if constexpr (mma_chunk_built(PB, N, 32) && mma_chunk_built(PB, N, 128)) {
      if (chunk == 32) return mma<S, PB, N, 32>();
      if (chunk == 128) return mma<S, PB, N, 128>();
    }
    return mma<S, PB, N, kQ>();
  }

  template <typename S, int PB, int N, int Q>
  int mma() const {
    const size_t smem = SsdMmaSmem<S, PB, N, Q>::kBytes;
    const cudaError_t err =
        allow_dynamic_smem(ssd_mma_kernel<S, PB, N, Q>, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();       // not left for the next launch's check
      return static_cast<int>(err);
    }
    ssd_mma_kernel<S, PB, N, Q><<<dim3(p / PB, h, bsz), 2 * Q, smem, stream>>>(
        static_cast<const S*>(x), static_cast<const __half*>(x_scale),
        static_cast<const float*>(dt), static_cast<const float*>(a),
        static_cast<const bf16*>(b_in), static_cast<const bf16*>(c_in),
        static_cast<const float*>(init), static_cast<bf16*>(y),
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

bool supported(int bsz, int s, int h, int p, int g) {
  return bsz > 0 && s > 0 && h > 0 && g > 0 && h % g == 0 &&
         (p == 16 || p == 32 || p == 64);
}

// ------------------------------------------------------------------ K16
//
// K16: the backward of the SSD scan (K12).  It replaces no Pallas kernel:
// the reference trains the scan by jnp autodiff of models/ssm.py's
// ssd_chunked, which XLA lowers as it likes; here the backward is a
// kernel written by hand, so that no plain version runs on the card's
// training path.
//
// Per chunk of kQ rows (padded with zero rows past S, whose dt a is 0, so
// cum stays at the last valid row's and the chunk's decay is taken there,
// as K12 takes it), with u_j = dt_j x_j, L_ij = exp(cum_i - cum_j) for
// j <= i (0 otherwise, masked before exp), M_ij = (C_i . B_j) L_ij and
// G_ij = dy_i . u_j, h_in the state entering the chunk and dh the
// gradient of the state leaving it (d_final, or 0, after the last chunk):
//   du_j    = sum_i M_ij dy_i + exp(cum_Q - cum_j) (dh B_j)
//   dx_j    = dt_j du_j,  ddt_j = x_j . du_j + a dda_j
//   dC_i    = sum_j G_ij L_ij B_j + exp(cum_i) h_in^T dy_i
//   dB_j    = sum_i G_ij L_ij C_i + exp(cum_Q - cum_j) dh^T u_j
//   dh_in   = exp(cum_Q) dh + sum_i exp(cum_i) dy_i C_i^T
//   dcum_i  = sum_j T_ij - sum_k T_ki + exp(cum_i) dy_i . (h_in C_i) - W_i
//             (+ exp(cum_Q) <dh, h_in> + sum_j W_j at the chunk's last row)
// with T_ij = M_ij G_ij and W_j = exp(cum_Q - cum_j) u_j . (dh B_j);
// dda is the reverse cumulative sum of dcum within the chunk, and da sums
// dt dda.  (cum_Q is the chunk's last row's cum.)
//
// What bounds it on the H100: at mamba2-780m's training shape (B = 2, S =
// 1024, H = 48, P = 64, N = 128, bf16) the products are about 10.4 GFLOP
// (the state recompute and the backward's ten per chunk, as chip_smoke.py's
// ssd_bwd_flops counts them) against about 40.6 MB of inputs and outputs,
// so bytes bound it (about 12 us), the operations only just under them at
// the bf16 tensor-core rate.  Two paths, picked by x's dtype: bf16 (the
// training dtype) on the tensor cores, ssd_bwd_mma_kernel (below); f32,
// the parity dtype held to 1e-5 of the f64 gradient, on the CUDA cores,
// ssd_bwd_kernel.
//
// Design of the f32 kernel: one block of 256 threads per (head, batch
// row), the whole head (P columns) a block, so that no sum crosses the
// head-dim axis.  Pass one runs the chunks forward, the [P, N] state in
// registers, and writes the state entering each chunk to an f32 scratch
// [B, H, NC, P, N] (50 MB at the training shape).  Pass two runs the
// chunks backward, carrying dh [P, N] in shared memory: per chunk it
// stages C, B, x, dy (f32, rows padded to an odd stride, so that every
// product below reads conflict-free) and h_in, and runs the products as
// register-tiled loops over shared memory (BwdFrag), far below either
// roof.  Everything but dx and d_initial sums over the heads of a group: a
// block writes dB and dC per head (f32 partials [B, S, H, N]) and da per
// (batch row, head); the wrapper adds them up.  The chunk's cumulative
// decay runs in f64 (chunk_cum), and so do dcum's intra-chunk sums, whose
// terms cancel in pairs (each T_ij enters at row i and leaves at row j),
// and its reverse scan.  No atomics: a call repeats bit for bit.  Shared
// memory is 200 KB at P = 64, N = 128: one block an SM.
namespace bwd {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// An [M][N] product over the block: thread t owns rows t / kCT + kRT a
// (a < TM) and columns t % kCT + kCT b (b < TN); the kCT threads of a row
// are consecutive lanes of one warp (kCT is 16 or 32).
constexpr int tile_cols(int n) { return n >= 64 ? 4 : (n >= 32 ? 2 : 1); }

template <int M, int N>
struct BwdFrag {
  static constexpr int TN = tile_cols(N);
  static constexpr int kCT = N / TN;
  static constexpr int kRT = kThreads / kCT;
  static constexpr int TM = M / kRT;
  static_assert(kCT * TN == N && kRT * TM == M && TM >= 1,
                "the product must tile the block's threads");
  float v[TM][TN];

  __device__ static int row(int a) { return threadIdx.x / kCT + kRT * a; }
  __device__ static int col(int b) { return threadIdx.x % kCT + kCT * b; }
  __device__ static bool row_leader() { return threadIdx.x % kCT == 0; }

  __device__ void zero() {
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int b = 0; b < TN; ++b) v[a][b] = 0.f;
  }

  // v[m][n] += sum_k fa(m, k) fb(k, n), k in order
  template <int K, typename FA, typename FB>
  __device__ void mac(const FA& fa, const FB& fb) {
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int a = 0; a < TM; ++a) av[a] = fa(row(a), k);
#pragma unroll
      for (int b = 0; b < TN; ++b) bv[b] = fb(k, col(b));
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int b = 0; b < TN; ++b) v[a][b] += av[a] * bv[b];
    }
  }

  // The sum over a row's kCT threads of each thread's part[a], in every
  // one of them (a butterfly over consecutive lanes: the same order in
  // every run).
  __device__ static void row_sums(float (&part)[TM]) {
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int o = kCT / 2; o > 0; o >>= 1)
        part[a] += __shfl_xor_sync(0xffffffffu, part[a], o);
  }
};

// Shared memory, in floats: C and B [kQ][N + 1], x and dy [kQ][P + 1],
// h_in and dh [P][N + 1], the M and G tiles [kQ][kQ + 1] (odd strides: a
// warp's reads of one column over consecutive rows fall in distinct
// banks), six [kQ] vectors (dt, exp(cum), exp(cum_Q - cum), x . du, W,
// the inter-chunk dcum), then in f64 cum and the row and column sums of
// T [kQ] each and the per-warp partials of <dh, h_in>.
template <int P, int N>
struct BwdSmem {
  static constexpr int kNS = N + 1, kPS = P + 1, kMS = kQ + 1;
  static constexpr int kC = 0;
  static constexpr int kB = kC + kQ * kNS;
  static constexpr int kX = kB + kQ * kNS;
  static constexpr int kDy = kX + kQ * kPS;
  static constexpr int kHin = kDy + kQ * kPS;
  static constexpr int kDh = kHin + P * kNS;
  static constexpr int kM = kDh + P * kNS;
  static constexpr int kG = kM + kQ * kMS;
  static constexpr int kVec = kG + kQ * kMS;
  static constexpr int kDbl = kVec + 6 * kQ;     // f64 from here on
  static constexpr int kFloats = kDbl + 2 * (3 * kQ + kWarps);
  static constexpr size_t kBytes = sizeof(float) * kFloats;
  static_assert(kDbl % 2 == 0, "8-byte aligned f64 vectors");
  static_assert(kBytes <= 227 * 1024, "a block opts into at most 227 KB");
};

// Stage R rows of W values (row r at src + r * step; zeros from row nv
// on) as f32 into dst[r * (W + 1) + c], 16 bytes a load, every load of a
// thread issued before the first is used.  Plain loads, not the read-only
// path: the state scratch is written earlier in the same launch.
template <typename T, int W, int R = kQ>
__device__ __forceinline__ void stage_rows(float* dst, const T* src,
                                           size_t step, int nv) {
  constexpr int kV = 16 / static_cast<int>(sizeof(T));
  constexpr int kRowV = W / kV;
  constexpr int kIters = (R * kRowV + kThreads - 1) / kThreads;
  static_assert(W % kV == 0, "rows of whole 16-byte loads");
  uint4 raw[kIters];
#pragma unroll
  for (int u = 0; u < kIters; ++u) {
    const int i = threadIdx.x + u * kThreads;
    const int r = i / kRowV, c = (i % kRowV) * kV;
    raw[u] = make_uint4(0u, 0u, 0u, 0u);
    if (i < R * kRowV && r < nv)
      raw[u] = *reinterpret_cast<const uint4*>(src + r * step + c);
  }
#pragma unroll
  for (int u = 0; u < kIters; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i >= R * kRowV) break;
    const int r = i / kRowV, c = (i % kRowV) * kV;
    float v[kV];
    unpack16<T>(raw[u], v);
#pragma unroll
    for (int e = 0; e < kV; ++e) dst[r * (W + 1) + c + e] = v[e];
  }
}

// Warp 0: cum = cumsum(dt a) over the chunk (lane l holds rows 2l, 2l + 1,
// K12's scan) in f64, with exp(cum) and exp(cum_Q - cum) beside it.  The
// decay's exponents are differences of cum, which grows to hundreds over a
// chunk: in f32 the difference of two such sums loses about |cum| 2^-24
// (some 3e-5 of the gradient of dt at mamba2's shape, H100), in f64
// nothing that shows.
__device__ __forceinline__ void chunk_cum(const float* dts, float a_h,
                                          double* cum, float* ecum,
                                          float* edec) {
  const int lane = threadIdx.x % 32;
  const int ra = 2 * lane, rb = ra + 1;
  const double ea = static_cast<double>(dts[ra]) * a_h;
  const double eb = static_cast<double>(dts[rb]) * a_h;
  double incl = ea + eb;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  double excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0;
  const double ca = excl + ea, cb = (excl + ea) + eb;
  const double last = __shfl_sync(0xffffffffu, cb, 31);
  cum[ra] = ca;
  cum[rb] = cb;
  ecum[ra] = expf(static_cast<float>(ca));
  ecum[rb] = expf(static_cast<float>(cb));
  edec[ra] = expf(static_cast<float>(last - ca));
  edec[rb] = expf(static_cast<float>(last - cb));
}

// exp(cum_i - cum_j), the exponent taken in f64 (chunk_cum)
__device__ __forceinline__ float decay_between(const double* cum, int i,
                                               int j) {
  return expf(static_cast<float>(cum[i] - cum[j]));
}

// T: the dtype of x, B, C, dy and dx (built for f32: bf16 runs
// ssd_bwd_mma_kernel); P head-dim columns, N state columns.
template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const T* __restrict__ b_in,
               const T* __restrict__ c_in, const float* __restrict__ init,
               const T* __restrict__ dy, const float* __restrict__ d_final,
               T* __restrict__ dx, float* __restrict__ ddt,
               float* __restrict__ da_part, float* __restrict__ db_part,
               float* __restrict__ dc_part, float* __restrict__ d_init,
               float* __restrict__ states, int s, int h, int g) {
  using L = BwdSmem<P, N>;
  constexpr int kNS = L::kNS, kPS = L::kPS, kMS = L::kMS;
  extern __shared__ __align__(16) float bwd_smem[];
  float* cs = bwd_smem + L::kC;
  float* bs = bwd_smem + L::kB;
  float* xs = bwd_smem + L::kX;
  float* dys = bwd_smem + L::kDy;
  float* hin = bwd_smem + L::kHin;
  float* dh = bwd_smem + L::kDh;
  float* ms = bwd_smem + L::kM;
  float* gs = bwd_smem + L::kG;
  float* dts = bwd_smem + L::kVec;
  float* ecum = dts + kQ;              // exp(cum_i)
  float* edec = ecum + kQ;             // exp(cum_Q - cum_j)
  float* xdu = edec + kQ;              // x_j . du_j
  float* wv = xdu + kQ;                // W_j
  float* inter = wv + kQ;              // exp(cum_i) dy_i . (h_in C_i)
  // dcum's intra-chunk terms cancel: each T_ij enters at i and leaves at
  // j, and dda (their reverse cumulative sum) keeps only the pairs that
  // straddle a row.  The sums that cancel run in f64, so that dda keeps
  // f32's precision of its own size, not of the terms'.
  double* cum = reinterpret_cast<double*>(bwd_smem + L::kDbl);
  double* trow = cum + kQ;             // sum_j T_ij
  double* tcol = trow + kQ;            // sum_i T_ij
  double* red = tcol + kQ;             // per-warp partials of <dh, h_in>

  const int hh = blockIdx.x;
  const int b = blockIdx.y;
  const int gg = hh / (h / g);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const float a_h = a[hh];
  const int nc = (s + kQ - 1) / kQ;
  const size_t state_base = (static_cast<size_t>(b) * h + hh) * P * N;
  float* st_scratch = states + state_base * nc;   // [NC][P][N]
  // row r of chunk c0 of x / dy (head hh) and of B / C (group gg)
  const auto x_row = [&](int c0) {
    return (static_cast<size_t>(b) * s + c0) * h * P +
           static_cast<size_t>(hh) * P;
  };
  const auto n_row = [&](int c0) {
    return (static_cast<size_t>(b) * s + c0) * g * N +
           static_cast<size_t>(gg) * N;
  };
  const auto stage_dt = [&](int c0, int nv) {
    if (tid < kQ)
      dts[tid] = tid < nv ? dt[(static_cast<size_t>(b) * s + c0 + tid) * h +
                               hh]
                          : 0.f;
  };

  // ---- pass one: the state entering each chunk, into the scratch
  {
    using F = BwdFrag<P, N>;
    F st;
#pragma unroll
    for (int i = 0; i < F::TM; ++i)
#pragma unroll
      for (int j = 0; j < F::TN; ++j)
        st.v[i][j] = init != nullptr
                         ? init[state_base + F::row(i) * N + F::col(j)]
                         : 0.f;
    for (int c = 0; c < nc; ++c) {
#pragma unroll
      for (int i = 0; i < F::TM; ++i)
#pragma unroll
        for (int j = 0; j < F::TN; ++j)
          st_scratch[(static_cast<size_t>(c) * P + F::row(i)) * N +
                     F::col(j)] = st.v[i][j];
      if (c + 1 == nc) break;
      const int c0 = c * kQ;    // a chunk before the last is whole
      __syncthreads();          // the previous chunk's tiles are consumed
      stage_rows<T, P>(xs, x + x_row(c0), static_cast<size_t>(h) * P, kQ);
      stage_rows<T, N>(bs, b_in + n_row(c0), static_cast<size_t>(g) * N, kQ);
      stage_dt(c0, kQ);
      __syncthreads();
      if (warp == 0) chunk_cum(dts, a_h, cum, ecum, edec);
      __syncthreads();
      const float decay = ecum[kQ - 1];
#pragma unroll
      for (int i = 0; i < F::TM; ++i)
#pragma unroll
        for (int j = 0; j < F::TN; ++j) st.v[i][j] *= decay;
      // state += (x o w)^T B, w_j = exp(cum_Q - cum_j) dt_j
      st.template mac<kQ>(
          [&](int p, int j) { return xs[j * kPS + p] * (edec[j] * dts[j]); },
          [&](int j, int n) { return bs[j * kNS + n]; });
    }
  }

  // ---- pass two: the chunks backward, dh in shared memory
  for (int i = tid; i < P * N; i += kThreads)
    dh[(i / N) * kNS + i % N] =
        d_final != nullptr ? d_final[state_base + i] : 0.f;
  double da_acc = 0.0;          // warp 0: sum of dt dda over the chunks
  for (int c = nc - 1; c >= 0; --c) {
    const int c0 = c * kQ, nv = min(kQ, s - c0);
    __syncthreads();   // the previous chunk's reads and dh's update are done
    stage_rows<T, N>(cs, c_in + n_row(c0), static_cast<size_t>(g) * N, nv);
    stage_rows<T, N>(bs, b_in + n_row(c0), static_cast<size_t>(g) * N, nv);
    stage_rows<T, P>(xs, x + x_row(c0), static_cast<size_t>(h) * P, nv);
    stage_rows<T, P>(dys, dy + x_row(c0), static_cast<size_t>(h) * P, nv);
    stage_rows<float, N, P>(hin, st_scratch + static_cast<size_t>(c) * P * N,
                            N, P);
    stage_dt(c0, nv);
    __syncthreads();
    if (warp == 0) chunk_cum(dts, a_h, cum, ecum, edec);
    __syncthreads();

    // M = (C B^T) o L and G = dy u^T, both masked to j <= i
    {
      using F = BwdFrag<kQ, kQ>;
      F m;
      m.zero();
      m.template mac<N>([&](int i, int n) { return cs[i * kNS + n]; },
                        [&](int n, int j) { return bs[j * kNS + n]; });
      F gq;
      gq.zero();
      gq.template mac<P>([&](int i, int p) { return dys[i * kPS + p]; },
                         [&](int p, int j) { return xs[j * kPS + p]; });
#pragma unroll
      for (int ia = 0; ia < F::TM; ++ia)
#pragma unroll
        for (int jb = 0; jb < F::TN; ++jb) {
          const int i = F::row(ia), j = F::col(jb);
          // mask before exp: cum_i - cum_j <= 0 only for j <= i
          ms[i * kMS + j] =
              j <= i ? m.v[ia][jb] * decay_between(cum, i, j) : 0.f;
          gs[i * kMS + j] = j <= i ? gq.v[ia][jb] * dts[j] : 0.f;
        }
    }
    __syncthreads();
    // T = M o G: its row sums (threads 0..63) and column sums (64..127);
    // every thread its share of <dh, h_in>
    if (tid < kQ) {
      double r = 0.0;
      for (int j = 0; j <= tid; ++j)
        r += static_cast<double>(ms[tid * kMS + j] * gs[tid * kMS + j]);
      trow[tid] = r;
    } else if (tid < 2 * kQ) {
      const int j = tid - kQ;
      double r = 0.0;
      for (int i = j; i < kQ; ++i)
        r += static_cast<double>(ms[i * kMS + j] * gs[i * kMS + j]);
      tcol[j] = r;
    }
    {
      double part = 0.0;
      for (int i = tid; i < P * N; i += kThreads)
        part += static_cast<double>(dh[(i / N) * kNS + i % N] *
                                    hin[(i / N) * kNS + i % N]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) red[warp] = part;
    }
    __syncthreads();
    // G <- G o L, in place
    for (int e = tid; e < kQ * kQ; e += kThreads) {
      const int i = e / kQ, j = e % kQ;
      if (j <= i) gs[i * kMS + j] *= decay_between(cum, i, j);
    }
    __syncthreads();

    // du = M^T dy + exp(cum_Q - cum_j) (B dh^T): dx, x . du and W
    {
      using F = BwdFrag<kQ, P>;
      F du, v2;
      du.zero();
      v2.zero();
      du.template mac<kQ>([&](int j, int i) { return ms[i * kMS + j]; },
                          [&](int i, int p) { return dys[i * kPS + p]; });
      v2.template mac<N>([&](int j, int n) { return bs[j * kNS + n]; },
                         [&](int n, int p) { return dh[p * kNS + n]; });
      float pd[F::TM], pw[F::TM];
#pragma unroll
      for (int ia = 0; ia < F::TM; ++ia) {
        const int j = F::row(ia);
        const float e = edec[j], d = dts[j];
        pd[ia] = pw[ia] = 0.f;
#pragma unroll
        for (int pb = 0; pb < F::TN; ++pb) {
          const int p = F::col(pb);
          const float u = du.v[ia][pb] + e * v2.v[ia][pb];
          const float xv = xs[j * kPS + p];
          pd[ia] += xv * u;
          pw[ia] += xv * v2.v[ia][pb];
          if (j < nv)
            dx[x_row(c0) + static_cast<size_t>(j) * h * P + p] =
                from_float<T>(d * u);
        }
      }
      F::row_sums(pd);
      F::row_sums(pw);
      if (F::row_leader())
#pragma unroll
        for (int ia = 0; ia < F::TM; ++ia) {
          const int j = F::row(ia);
          xdu[j] = pd[ia];
          wv[j] = edec[j] * dts[j] * pw[ia];
        }
    }
    // dC = (G o L) B + exp(cum_i) (dy h_in), and the inter-chunk dcum
    {
      using F = BwdFrag<kQ, N>;
      F dc, d2;
      dc.zero();
      d2.zero();
      dc.template mac<kQ>([&](int i, int j) { return gs[i * kMS + j]; },
                          [&](int j, int n) { return bs[j * kNS + n]; });
      d2.template mac<P>([&](int i, int p) { return dys[i * kPS + p]; },
                         [&](int p, int n) { return hin[p * kNS + n]; });
      float pi[F::TM];
#pragma unroll
      for (int ia = 0; ia < F::TM; ++ia) {
        const int i = F::row(ia);
        const float e = ecum[i];
        pi[ia] = 0.f;
#pragma unroll
        for (int nb = 0; nb < F::TN; ++nb) {
          const int n = F::col(nb);
          pi[ia] += cs[i * kNS + n] * d2.v[ia][nb];
          if (i < nv)
            dc_part[((static_cast<size_t>(b) * s + c0 + i) * h + hh) * N + n] =
                dc.v[ia][nb] + e * d2.v[ia][nb];
        }
      }
      F::row_sums(pi);
      if (F::row_leader())
#pragma unroll
        for (int ia = 0; ia < F::TM; ++ia)
          inter[F::row(ia)] = ecum[F::row(ia)] * pi[ia];
    }
    // dB = (G o L)^T C + exp(cum_Q - cum_j) dt_j (x dh)
    {
      using F = BwdFrag<kQ, N>;
      F db, e2;
      db.zero();
      e2.zero();
      db.template mac<kQ>([&](int j, int i) { return gs[i * kMS + j]; },
                          [&](int i, int n) { return cs[i * kNS + n]; });
      e2.template mac<P>([&](int j, int p) { return xs[j * kPS + p]; },
                         [&](int p, int n) { return dh[p * kNS + n]; });
#pragma unroll
      for (int ja = 0; ja < F::TM; ++ja) {
        const int j = F::row(ja);
        const float e = edec[j] * dts[j];
        if (j < nv)
#pragma unroll
          for (int nb = 0; nb < F::TN; ++nb)
            db_part[((static_cast<size_t>(b) * s + c0 + j) * h + hh) * N +
                    F::col(nb)] = db.v[ja][nb] + e * e2.v[ja][nb];
      }
    }
    __syncthreads();   // every read of dh_out and of the vectors above done

    // dh <- exp(cum_Q) dh + (dy o exp(cum))^T C, each thread on its own
    // entries of dh (no other thread reads dh here)
    {
      using F = BwdFrag<P, N>;
      F nh;
      nh.zero();
      nh.template mac<kQ>(
          [&](int p, int i) { return dys[i * kPS + p] * ecum[i]; },
          [&](int i, int n) { return cs[i * kNS + n]; });
      const float decay = ecum[kQ - 1];
#pragma unroll
      for (int pa = 0; pa < F::TM; ++pa)
#pragma unroll
        for (int nb = 0; nb < F::TN; ++nb) {
          float& d = dh[F::row(pa) * kNS + F::col(nb)];
          d = decay * d + nh.v[pa][nb];
        }
    }
    // warp 0: dcum, its reverse cumulative sum dda (f64), ddt and da
    if (warp == 0) {
      double dot = 0.0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) dot += red[w];
      const int ra = 2 * lane, rb = ra + 1;
      double wsum = static_cast<double>(wv[ra]) + wv[rb];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        wsum += __shfl_xor_sync(0xffffffffu, wsum, o);
      double ga = (trow[ra] - tcol[ra]) +
                  (static_cast<double>(inter[ra]) - wv[ra]);
      double gb = (trow[rb] - tcol[rb]) +
                  (static_cast<double>(inter[rb]) - wv[rb]);
      if (rb == kQ - 1) gb += ecum[kQ - 1] * dot + wsum;
      // reverse inclusive scan: dda_i = sum_{k >= i} dcum_k
      double incl = ga + gb;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double t = __shfl_down_sync(0xffffffffu, incl, o);
        if (lane + o < 32) incl += t;
      }
      double excl = __shfl_down_sync(0xffffffffu, incl, 1);
      if (lane == 31) excl = 0.0;
      const double ddb = excl + gb, dda = ddb + ga;
      const size_t row0 = (static_cast<size_t>(b) * s + c0) * h + hh;
      if (ra < nv)
        ddt[row0 + static_cast<size_t>(ra) * h] =
            static_cast<float>(xdu[ra] + a_h * dda);
      if (rb < nv)
        ddt[row0 + static_cast<size_t>(rb) * h] =
            static_cast<float>(xdu[rb] + a_h * ddb);
      double part = dts[ra] * dda + dts[rb] * ddb;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      da_acc += part;
    }
  }
  __syncthreads();   // the last dh update is done
  if (d_init != nullptr)
    for (int i = tid; i < P * N; i += kThreads)
      d_init[state_base + i] = dh[(i / N) * kNS + i % N];
  if (tid == 0)
    da_part[static_cast<size_t>(b) * h + hh] = static_cast<float>(da_acc);
}

// ------------------------------------------- K16 bf16 on the tensor cores
//
// ssd_bwd_mma_kernel<P, N> is the bf16 path of K16 (bf16 x, B, C and
// dy: the training dtype); the f32 path, the parity dtype held to 1e-5 of
// the f64 gradient, stays ssd_bwd_kernel above.  The same call and bound
// (40.6 MB against 10.4 GFLOP at mamba2-780m's training shape: bytes, 12
// us).  Its design:
//
// * A grid of H x B blocks of 8 warps, one block a head and an SM (174 KB
//   of shared memory at P = 64, N = 128).  Warp w takes the chunk's rows
//   16 (w % 4) .. + 15 in every product over them, and of their output
//   columns (or of C B^T's and dy x^T's 16-column slabs) those of parity
//   w / 4; the [P, N] products (the state, dh) are split into (16-row tile,
//   16-column pair) units, each warp owning some.  Two blocks a head, each
//   taking half of the state's N columns (both repeating dh's update and C
//   B^T and dy x^T), lost at both training shapes on the card (PERF.md).
// * Every product is mma.sync m16n8k16 (bf16 in, f32 accumulate), its
//   operands read with ldmatrix: pass one's state recompute (state <-
//   state e^{cum_Q} + (x o w)^T B) and, walking the chunks back, S = C
//   B^T, G = dy x^T, du = M^T dy + e^{cum_Q - cum_j} (B dh^T), dC = (G o
//   L) B + e^{cum_i} (dy h_in), dB = (G o L)^T C + e^{cum_Q - cum_j} dt_j
//   (x dh) and dh <- e^{cum_Q} dh + (dy o e^{cum})^T C.  M and G come
//   from the raw bf16 C, B, dy and x, and the f32 weights (L, dt, the
//   decays) are applied to the accumulators after each product, so T_ij =
//   M_ij G_ij is as exact as f32 accumulation makes it.  M and G o L are
//   rounded to bf16 as A operands from the accumulators (through shared
//   memory, which the products that read them transposed need); so are
//   the decay-weighted x and dy of the two state updates, and the state
//   and dh where they are operands (both stay f32 in the accumulators).
//   A bf16 high / low split of each, as in K12's state update, was tried
//   on the card: it moved only da and d_initial, both well within the bf16
//   tolerance of 1e-2 either way, and cost time.  cum, T's row and column
//   sums and dcum's reverse scan run in f64; the scan of chunk c runs in
//   one warp while the others compute chunk c - 1.
// * A 2-stage cp.async ring brings chunk c - 1's C, B, x, dy (bf16) and dt
//   while chunk c is computed; rows past S land as zeros without a read.
// * The state scratch stays, in bf16 (the state is read back only as an
//   operand and into <dh, h_in>): pass one writes the state entering each
//   chunk, [B, H, ceil(S / 64), P, N] (25.2 MB at mamba2's training shape,
//   21.0 MB at zamba2's), each thread the entries it reads back in pass
//   two.
// No atomics: a call repeats bit for bit.
constexpr int kMmaThreads = 256;
constexpr int kMmaWarps = kMmaThreads / 32;
// The warp that runs a chunk's dcum scan, one chunk late: warp 4 takes
// rows 0-15 at odd slabs of C B^T, of which there are none, so the scan
// of chunk c + 1 overlaps chunk c's first products.
constexpr int kTailWarp = 4;

// Shared memory of ssd_bwd_mma_kernel<P, N>, in bytes: two ring stages,
// each the chunk's C and B tiles ([64][N + 8] bf16), its x and dy tiles
// ([64][P + 8] bf16) and its dt ([64] f32); h_in and dh ([P][N + 8] bf16)
// as operands; M and G o L ([64][72]
// bf16); per warp cum ([64] f64), e^{cum} and e^{cum_Q - cum} ([64] f32
// each); and, for two chunks (the tail scans a chunk late), T's row sums
// by column half ([2][64] f64) and column sums by row tile ([4][64] f64),
// each warp's part of <dh, h_in> ([8] f64), x . du, W and the inter-chunk
// dcum by column half ([3][2][64] f32) and dt ([64] f32).  Rows are padded
// by 16 bytes, so that the 8 row addresses of each ldmatrix fall in
// distinct banks.
template <int P, int N>
struct BwdMmaSmem {
  static constexpr int kCS = N + 8;              // C, B, h_in and dh stride
  static constexpr int kXS = P + 8;              // x and dy row stride
  static constexpr int kMS = kQ + 8;             // M and G o L row stride
  static constexpr int kCOff = 0;
  static constexpr int kBOff = kCOff + 2 * kQ * kCS;
  static constexpr int kXOff = kBOff + 2 * kQ * kCS;
  static constexpr int kDyOff = kXOff + 2 * kQ * kXS;
  static constexpr int kDtOff = kDyOff + 2 * kQ * kXS;
  static constexpr int kStage = kDtOff + 4 * kQ;
  static constexpr int kHOff = 2 * kStage;
  static constexpr int kDhOff = kHOff + 2 * P * kCS;
  static constexpr int kMOff = kDhOff + 2 * P * kCS;
  static constexpr int kGOff = kMOff + 2 * kQ * kMS;
  static constexpr int kCumOff = kGOff + 2 * kQ * kMS;
  static constexpr int kCumBytes = 16 * kQ;      // one warp's three vectors
  static constexpr int kTailOff = kCumOff + kMmaWarps * kCumBytes;
  // one chunk's tail inputs, from kTailOff + parity * kTailBytes
  static constexpr int kTrow = 0;                          // f64 [2][kQ]
  static constexpr int kTcol = kTrow + 8 * 2 * kQ;         // f64 [4][kQ]
  static constexpr int kDot = kTcol + 8 * 4 * kQ;          // f64 [8]
  static constexpr int kVec = kDot + 8 * kMmaWarps;        // f32 [3][2][kQ]
  static constexpr int kDt = kVec + 4 * 3 * 2 * kQ;        // f32 [kQ]
  static constexpr int kTailBytes = kDt + 4 * kQ;
  static constexpr int kBytes = kTailOff + 2 * kTailBytes;
  static_assert(kStage % 16 == 0 && kHOff % 16 == 0 && kDhOff % 16 == 0 &&
                    kMOff % 16 == 0,
                "16-byte aligned rows and regions");
  static_assert(kBytes <= 227 * 1024, "a block opts into at most 227 KB");
};

// The A operand (16 rows m, 16 chunk rows k) of a row-weighted tile read
// transposed: `raw` from ldmatrix_x4_trans of a bf16 [k][m] tile, w the
// weights of rows k = 2t, 2t + 1, 2t + 8, 2t + 9; the products rounded to
// bf16.
__device__ __forceinline__ void weighted_a(const uint32_t (&raw)[4],
                                           const float (&w)[4],
                                           uint32_t (&out)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    __nv_bfloat162 pair;
    memcpy(&pair, &raw[q], sizeof(pair));
    const float2 v = __bfloat1622float2(pair);
    out[q] = pack_bf16(v.x * w[(q / 2) * 2], v.y * w[(q / 2) * 2 + 1]);
  }
}

template <int P, int N>
__global__ void __launch_bounds__(kMmaThreads, 1)
ssd_bwd_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ a,
                   const bf16* __restrict__ b_in,
                   const bf16* __restrict__ c_in,
                   const float* __restrict__ init,
                   const bf16* __restrict__ dy,
                   const float* __restrict__ d_final, bf16* __restrict__ dx,
                   float* __restrict__ ddt, float* __restrict__ da_part,
                   float* __restrict__ db_part, float* __restrict__ dc_part,
                   float* __restrict__ d_init, bf16* __restrict__ states,
                   int s, int h, int g) {
  using L = BwdMmaSmem<P, N>;
  constexpr int kCS = L::kCS, kXS = L::kXS, kMS = L::kMS;
  constexpr int kMT = P / 16;            // 16-row tiles of the state
  constexpr int kNP = N / 16;            // 16-column pairs of a row tile
  constexpr int kU = kMT * kNP;          // (row tile, pair) units
  constexpr int kUPW = kU >= kMmaWarps ? kU / kMmaWarps : 1;  // a warp's
  constexpr int kStride = kMmaWarps / kMT;   // pairs from unit to unit
  static_assert(kMmaWarps % kMT == 0 &&
                    (kU < kMmaWarps || kU % kMmaWarps == 0),
                "every unit has one owner, a warp's units one row tile");
  extern __shared__ __align__(16) unsigned char bwd_mma_smem[];
  unsigned char* const sm = bwd_mma_smem;

  const int hh = blockIdx.x;
  const int b = blockIdx.y;
  const int gg = hh / (h / g);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  // the warp's 16 chunk rows (tile wr) and its half of their columns (wc)
  const int wr = warp % 4, wc = warp / 4;
  const int gr = lane / 4, t2 = (lane % 4) * 2;
  const int fr = frag_row(lane), fc = frag_col(lane);
  const int br = brow(lane), bc = bcol(lane);
  const float a_h = a[hh];
  const int nc = (s + kQ - 1) / kQ;
  // the warp's state units: row tile mt, pairs np_of(k), k < kUPW; with
  // fewer than 8 units, warps past kU own none
  const bool owner = warp < kU;
  const int mt = warp % kMT;
  const auto np_of = [&](int k) { return warp / kMT + k * kStride; };
  const size_t st_base = (static_cast<size_t>(b) * h + hh) * P * N;
  bf16* const scratch = states + st_base * nc;
  // the [P][N] offset of entries (2 e, 2 e + 1) of tile kt of pair np
  const auto st_off = [&](int np, int kt, int e) {
    return (mt * 16 + gr + 8 * e) * N + np * 16 + kt * 8 + t2;
  };
  double* const cum =
      reinterpret_cast<double*>(sm + L::kCumOff + warp * L::kCumBytes);
  float* const ecum = reinterpret_cast<float*>(cum + kQ);     // e^{cum_i}
  float* const edec = ecum + kQ;                    // e^{cum_Q - cum_j}
  bf16* const hs = reinterpret_cast<bf16*>(sm + L::kHOff);
  bf16* const dhs = reinterpret_cast<bf16*>(sm + L::kDhOff);
  bf16* const ms = reinterpret_cast<bf16*>(sm + L::kMOff);
  bf16* const gls = reinterpret_cast<bf16*>(sm + L::kGOff);
  // chunk c's tail inputs
  const auto tail_at = [&](int c, int off) {
    return sm + L::kTailOff + (c % 2) * L::kTailBytes + off;
  };

  // chunk c's B, x and dt (and C and dy when with_c) into stage c % 2,
  // then a commit (an empty group for c outside [0, nc)); rows past S land
  // as zeros without a read
  const auto fetch = [&](int c, bool with_c) {
    if (c >= 0 && c < nc) {
      unsigned char* stg = sm + (c % 2) * L::kStage;
      const int c0 = c * kQ, nv = min(kQ, s - c0);
      constexpr int kRowC = N / 8;                 // 16-byte pieces a row
      for (int i = tid; i < 2 * kQ * kRowC; i += kMmaThreads) {
        const int which = i / (kQ * kRowC);        // 0: B, 1: C
        if (which && !with_c) break;
        const int rr = (i / kRowC) % kQ, cc = i % kRowC;
        const bool live = rr < nv;
        const size_t row =
            (static_cast<size_t>(b) * s + c0 + (live ? rr : 0)) * g + gg;
        cp_async16(
            stg + (which ? L::kCOff : L::kBOff) + 2 * (rr * kCS + cc * 8),
            (which ? c_in : b_in) + row * N + cc * 8, live);
      }
      constexpr int kRowX = P / 8;
      for (int i = tid; i < 2 * kQ * kRowX; i += kMmaThreads) {
        const int which = i / (kQ * kRowX);        // 0: x, 1: dy
        if (which && !with_c) break;
        const int rr = (i / kRowX) % kQ, cc = i % kRowX;
        const bool live = rr < nv;
        const size_t row =
            (static_cast<size_t>(b) * s + c0 + (live ? rr : 0)) * h + hh;
        cp_async16(
            stg + (which ? L::kDyOff : L::kXOff) + 2 * (rr * kXS + cc * 8),
            (which ? dy : x) + row * P + cc * 8, live);
      }
      if (tid < kQ) {
        const bool live = tid < nv;
        cp_async4(stg + L::kDtOff + 4 * tid,
                  dt + (static_cast<size_t>(b) * s + c0 + (live ? tid : 0)) * h
                      + hh,
                  live);
      }
    }
    cp_async_commit();
  };

  // ---- pass one: the state entering each chunk into the scratch (bf16: it
  // is read back only as an operand and in <dh, h_in>)
  {
    float st[kUPW][2][4];
#pragma unroll
    for (int k = 0; k < kUPW; ++k)
#pragma unroll
      for (int kt = 0; kt < 2; ++kt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float2 v = make_float2(0.f, 0.f);
          if (owner && init != nullptr)
            v = *reinterpret_cast<const float2*>(
                init + st_base + st_off(np_of(k), kt, e));
          st[k][kt][2 * e] = v.x;
          st[k][kt][2 * e + 1] = v.y;
        }
    if (nc > 1) fetch(0, false);
    for (int c = 0;; ++c) {
#pragma unroll
      for (int k = 0; k < kUPW; ++k)
        if (owner)
#pragma unroll
          for (int kt = 0; kt < 2; ++kt)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              *reinterpret_cast<uint32_t*>(
                  scratch + static_cast<size_t>(c) * P * N +
                  st_off(np_of(k), kt, e)) =
                  pack_bf16(st[k][kt][2 * e], st[k][kt][2 * e + 1]);
      if (c + 1 == nc) break;
      cp_async_wait<0>();
      __syncthreads();   // chunk c landed, chunk c - 1's tiles are consumed
      fetch(c + 1 < nc - 1 ? c + 1 : -1, false);   // the last is not needed
      const unsigned char* stg = sm + (c % 2) * L::kStage;
      const bf16* xs = reinterpret_cast<const bf16*>(stg + L::kXOff);
      const bf16* bs = reinterpret_cast<const bf16*>(stg + L::kBOff);
      const float* dts = reinterpret_cast<const float*>(stg + L::kDtOff);
      chunk_cum(dts, a_h, cum, ecum, edec);
      __syncwarp();
      if (owner) {
        // a chunk before the last is whole: its decay is at row kQ - 1
        const float decay = ecum[kQ - 1];
#pragma unroll
        for (int k = 0; k < kUPW; ++k)
#pragma unroll
          for (int kt = 0; kt < 2; ++kt)
#pragma unroll
            for (int e = 0; e < 4; ++e) st[k][kt][e] *= decay;
        // state += (x o w)^T B, w_j = e^{cum_Q - cum_j} dt_j
#pragma unroll
        for (int ks = 0; ks < kQ / 16; ++ks) {
          uint32_t raw[4], xw[4];
          ldmatrix_x4_trans(raw, xs + (ks * 16 + br) * kXS + mt * 16 + bc);
          const int j0 = ks * 16 + t2, j1 = j0 + 8;
          const float w[4] = {edec[j0] * dts[j0], edec[j0 + 1] * dts[j0 + 1],
                              edec[j1] * dts[j1], edec[j1 + 1] * dts[j1 + 1]};
          weighted_a(raw, w, xw);
#pragma unroll
          for (int k = 0; k < kUPW; ++k) {
            uint32_t bq[4];
            ldmatrix_x4_trans(bq,
                              bs + (ks * 16 + fr) * kCS + np_of(k) * 16 + fc);
            mma_bf16(st[k][0], xw, bq[0], bq[1]);
            mma_bf16(st[k][1], xw, bq[2], bq[3]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // both stages are free for pass two
  }

  // ---- pass two: the chunks backward, all of dh in f32 fragments
  float dh[kUPW][2][4];
  // dh (f32) into its bf16 operand tile
  const auto store_dh = [&]() {
#pragma unroll
    for (int k = 0; k < kUPW; ++k)
#pragma unroll
      for (int kt = 0; kt < 2; ++kt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          *reinterpret_cast<uint32_t*>(
              dhs + (mt * 16 + gr + 8 * e) * kCS + np_of(k) * 16 + kt * 8 +
              t2) = pack_bf16(dh[k][kt][2 * e], dh[k][kt][2 * e + 1]);
  };
#pragma unroll
  for (int k = 0; k < kUPW; ++k)
#pragma unroll
    for (int kt = 0; kt < 2; ++kt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float2 v = make_float2(0.f, 0.f);
        if (owner && d_final != nullptr)
          v = *reinterpret_cast<const float2*>(d_final + st_base +
                                               st_off(np_of(k), kt, e));
        dh[k][kt][2 * e] = v.x;
        dh[k][kt][2 * e + 1] = v.y;
      }
  if (owner) store_dh();

  // the tail warp: chunk c's part of dcum from its tail inputs, its reverse
  // cumulative sum dda (f64), ddt and da (e_last: e^{cum_Q} of chunk c)
  double da_acc = 0.0;
  const auto tail = [&](int c, float e_last) {
    const double* trow = reinterpret_cast<const double*>(tail_at(c, L::kTrow));
    const double* tcol = reinterpret_cast<const double*>(tail_at(c, L::kTcol));
    const double* dotp = reinterpret_cast<const double*>(tail_at(c, L::kDot));
    const float* xdu = reinterpret_cast<const float*>(tail_at(c, L::kVec));
    const float* wv = xdu + 2 * kQ;
    const float* inter = wv + 2 * kQ;
    const float* dts = reinterpret_cast<const float*>(tail_at(c, L::kDt));
    const int c0 = c * kQ, nv = min(kQ, s - c0);
    double dot = 0.0;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) dot += dotp[w];
    const int ra = 2 * lane, rb = ra + 1;
    const double wa = static_cast<double>(wv[ra]) + wv[kQ + ra];
    const double wb = static_cast<double>(wv[rb]) + wv[kQ + rb];
    double wsum = wa + wb;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      wsum += __shfl_xor_sync(0xffffffffu, wsum, o);
    double ga = (static_cast<double>(inter[ra]) + inter[kQ + ra]) - wa;
    double gb = (static_cast<double>(inter[rb]) + inter[kQ + rb]) - wb;
    // T's column sums: the row tiles at or below the rows' slab
    double ca = 0.0, cb = 0.0;
    for (int t = ra / 16; t < 4; ++t) {
      ca += tcol[t * kQ + ra];
      cb += tcol[t * kQ + rb];
    }
    ga += (trow[ra] + trow[kQ + ra]) - ca;
    gb += (trow[rb] + trow[kQ + rb]) - cb;
    if (rb == kQ - 1) gb += e_last * dot + wsum;
    // reverse inclusive scan: dda_i = sum_{k >= i} dcum_k
    double incl = ga + gb;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double t = __shfl_down_sync(0xffffffffu, incl, o);
      if (lane + o < 32) incl += t;
    }
    double excl = __shfl_down_sync(0xffffffffu, incl, 1);
    if (lane == 31) excl = 0.0;
    const double ddb = excl + gb, dda = ddb + ga;
    float* out = ddt + (static_cast<size_t>(b) * s + c0) * h + hh;
    if (ra < nv)
      out[static_cast<size_t>(ra) * h] = static_cast<float>(
          (static_cast<double>(xdu[ra]) + xdu[kQ + ra]) + a_h * dda);
    if (rb < nv)
      out[static_cast<size_t>(rb) * h] = static_cast<float>(
          (static_cast<double>(xdu[rb]) + xdu[kQ + rb]) + a_h * ddb);
    double part = dts[ra] * dda + dts[rb] * ddb;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    da_acc += part;
  };

  float e_last = 0.f;           // the tail warp: e^{cum_Q} of chunk c + 1
  fetch(nc - 1, true);
  for (int c = nc - 1; c >= 0; --c) {
    const int c0 = c * kQ, nv = min(kQ, s - c0);
    cp_async_wait<0>();
    __syncthreads();   // chunk c landed; chunk c + 1 and dh's update done
    fetch(c - 1, true);
    const unsigned char* stg = sm + (c % 2) * L::kStage;
    const bf16* cs = reinterpret_cast<const bf16*>(stg + L::kCOff);
    const bf16* bs = reinterpret_cast<const bf16*>(stg + L::kBOff);
    const bf16* xs = reinterpret_cast<const bf16*>(stg + L::kXOff);
    const bf16* dys = reinterpret_cast<const bf16*>(stg + L::kDyOff);
    const float* dts = reinterpret_cast<const float*>(stg + L::kDtOff);
    double* const trow = reinterpret_cast<double*>(tail_at(c, L::kTrow));
    double* const tcol = reinterpret_cast<double*>(tail_at(c, L::kTcol));
    double* const dotp = reinterpret_cast<double*>(tail_at(c, L::kDot));
    float* const xdu = reinterpret_cast<float*>(tail_at(c, L::kVec));
    float* const wv = xdu + 2 * kQ;
    float* const inter = wv + 2 * kQ;
    // h_in of this chunk: what this thread wrote in pass one
    uint32_t hv[kUPW][2][2];
#pragma unroll
    for (int k = 0; k < kUPW; ++k)
#pragma unroll
      for (int kt = 0; kt < 2; ++kt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          hv[k][kt][e] =
              owner ? *reinterpret_cast<const uint32_t*>(
                            scratch + static_cast<size_t>(c) * P * N +
                            st_off(np_of(k), kt, e))
                      : 0u;
    if (warp == kTailWarp) {
      // chunk c + 1's tail, then this chunk's dt and e^{cum_Q} kept for
      // its own
      if (c + 1 < nc) tail(c + 1, e_last);
      float* dt_keep = reinterpret_cast<float*>(tail_at(c, L::kDt));
      dt_keep[lane] = dts[lane];
      dt_keep[lane + 32] = dts[lane + 32];
    }
    chunk_cum(dts, a_h, cum, ecum, edec);
    __syncwarp();
    if (warp == kTailWarp) e_last = ecum[kQ - 1];
    const int i0 = wr * 16 + gr, i1 = i0 + 8;   // the warp's rows
    const size_t row0 = static_cast<size_t>(b) * s + c0;

    // S = C B^T and G = dy x^T, one 16-column slab at a time up to the
    // diagonal, the warp taking the slabs of its parity: M = S o L and G o
    // L (G_ij = (dy_i . x_j) dt_j) into shared memory as bf16; T = M o G
    // summed by row (the warp's slabs) and by column (a slab's 16 rows) in
    // f64
    {
      const double ci0 = cum[i0], ci1 = cum[i1];
      double rs0 = 0.0, rs1 = 0.0;
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk) {
        if (kk > wr) break;
        if (kk % 2 != wc) continue;
        float sc[2][4] = {}, gc[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < N / 16; ++ks) {
          uint32_t af[4], bf[4];
          ldmatrix_x4(af, cs + (wr * 16 + fr) * kCS + ks * 16 + fc);
          ldmatrix_x4(bf, bs + (kk * 16 + br) * kCS + ks * 16 + bc);
          mma_bf16(sc[0], af, bf[0], bf[1]);
          mma_bf16(sc[1], af, bf[2], bf[3]);
        }
#pragma unroll
        for (int kp = 0; kp < P / 16; ++kp) {
          uint32_t af[4], bf[4];
          ldmatrix_x4(af, dys + (wr * 16 + fr) * kXS + kp * 16 + fc);
          ldmatrix_x4(bf, xs + (kk * 16 + br) * kXS + kp * 16 + bc);
          mma_bf16(gc[0], af, bf[0], bf[1]);
          mma_bf16(gc[1], af, bf[2], bf[3]);
        }
        double colp[4];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int j = kk * 16 + hf * 8 + t2;
          float m[4], gl[4];
          double t[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int jj = j + e % 2;
            // mask before exp: cum_i - cum_j <= 0 only for j <= i
            float mv = 0.f, gv = 0.f, lv = 0.f;
            if (jj <= (e < 2 ? i0 : i1)) {
              lv = expf(static_cast<float>((e < 2 ? ci0 : ci1) - cum[jj]));
              mv = sc[hf][e] * lv;
              gv = gc[hf][e] * dts[jj];
            }
            m[e] = mv;
            gl[e] = gv * lv;
            t[e] = static_cast<double>(mv) * gv;
          }
          rs0 += t[0] + t[1];
          rs1 += t[2] + t[3];
          colp[2 * hf] = t[0] + t[2];
          colp[2 * hf + 1] = t[1] + t[3];
          *reinterpret_cast<uint32_t*>(ms + i0 * kMS + j) =
              pack_bf16(m[0], m[1]);
          *reinterpret_cast<uint32_t*>(ms + i1 * kMS + j) =
              pack_bf16(m[2], m[3]);
          *reinterpret_cast<uint32_t*>(gls + i0 * kMS + j) =
              pack_bf16(gl[0], gl[1]);
          *reinterpret_cast<uint32_t*>(gls + i1 * kMS + j) =
              pack_bf16(gl[2], gl[3]);
        }
        // the slab's column sums over its 16 rows (the 8 lanes of a
        // column), lanes 0-3 writing them
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int o = 4; o < 32; o <<= 1)
            colp[q] += __shfl_xor_sync(0xffffffffu, colp[q], o);
        if (gr == 0) {
          double* tc = tcol + wr * kQ + kk * 16 + t2;
          tc[0] = colp[0];
          tc[1] = colp[1];
          tc[8] = colp[2];
          tc[9] = colp[3];
        }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        rs0 += __shfl_xor_sync(0xffffffffu, rs0, o);
        rs1 += __shfl_xor_sync(0xffffffffu, rs1, o);
      }
      if (lane % 4 == 0) {
        trow[wc * kQ + i0] = rs0;
        trow[wc * kQ + i1] = rs1;
      }
    }

    // h_in into its operand tile, and the warp's part of <dh, h_in> (dh
    // leaving the chunk)
    {
      double part = 0.0;
#pragma unroll
      for (int k = 0; k < kUPW; ++k)
        if (owner)
#pragma unroll
          for (int kt = 0; kt < 2; ++kt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              __nv_bfloat162 pair;
              memcpy(&pair, &hv[k][kt][e], sizeof(pair));
              const float2 v = __bfloat1622float2(pair);
              part += static_cast<double>(dh[k][kt][2 * e]) * v.x +
                      static_cast<double>(dh[k][kt][2 * e + 1]) * v.y;
              *reinterpret_cast<uint32_t*>(
                  hs + (mt * 16 + gr + 8 * e) * kCS + np_of(k) * 16 + kt * 8 +
                  t2) = hv[k][kt][e];
            }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) dotp[warp] = part;
    }
    __syncthreads();   // M, G o L, h_in and T's sums are in place

    // du = M^T dy + e^{cum_Q - cum_j} (B dh^T) on dx's columns, 16 at a
    // time, the warp taking those of its parity: dx = dt du, and
    // the warp's parts of x . du and W
    {
      const float ed0 = edec[i0], ed1 = edec[i1];
      const float d0 = dts[i0], d1 = dts[i1];
      float xu0 = 0.f, xu1 = 0.f, xv0 = 0.f, xv1 = 0.f;
#pragma unroll
      for (int pg = 0; pg < P; pg += 32) {
        if (pg + 16 * wc >= P) break;
        const int pcol = pg + 16 * wc;
        float du[2][4] = {}, v2[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < kQ / 16; ++kk) {
          if (kk < wr) continue;
          uint32_t af[4], bf[4];
          ldmatrix_x4_trans(af, ms + (kk * 16 + br) * kMS + wr * 16 + bc);
          ldmatrix_x4_trans(bf, dys + (kk * 16 + fr) * kXS + pcol + fc);
          mma_bf16(du[0], af, bf[0], bf[1]);
          mma_bf16(du[1], af, bf[2], bf[3]);
        }
#pragma unroll
        for (int ks = 0; ks < N / 16; ++ks) {
          uint32_t af[4], bf[4];
          ldmatrix_x4(af, bs + (wr * 16 + fr) * kCS + ks * 16 + fc);
          ldmatrix_x4(bf, dhs + (pcol + br) * kCS + ks * 16 + bc);
          mma_bf16(v2[0], af, bf[0], bf[1]);
          mma_bf16(v2[1], af, bf[2], bf[3]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int col = pcol + nt * 8 + t2;
          const float2 x0 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(xs + i0 * kXS + col));
          const float2 x1 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(xs + i1 * kXS + col));
          const float u00 = du[nt][0] + ed0 * v2[nt][0];
          const float u01 = du[nt][1] + ed0 * v2[nt][1];
          const float u10 = du[nt][2] + ed1 * v2[nt][2];
          const float u11 = du[nt][3] + ed1 * v2[nt][3];
          xu0 += x0.x * u00 + x0.y * u01;
          xu1 += x1.x * u10 + x1.y * u11;
          xv0 += x0.x * v2[nt][0] + x0.y * v2[nt][1];
          xv1 += x1.x * v2[nt][2] + x1.y * v2[nt][3];
          if (i0 < nv)
            *reinterpret_cast<__nv_bfloat162*>(
                dx + ((row0 + i0) * h + hh) * P + col) =
                __floats2bfloat162_rn(d0 * u00, d0 * u01);
          if (i1 < nv)
            *reinterpret_cast<__nv_bfloat162*>(
                dx + ((row0 + i1) * h + hh) * P + col) =
                __floats2bfloat162_rn(d1 * u10, d1 * u11);
        }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        xu0 += __shfl_xor_sync(0xffffffffu, xu0, o);
        xu1 += __shfl_xor_sync(0xffffffffu, xu1, o);
        xv0 += __shfl_xor_sync(0xffffffffu, xv0, o);
        xv1 += __shfl_xor_sync(0xffffffffu, xv1, o);
      }
      if (lane % 4 == 0) {
        xdu[wc * kQ + i0] = xu0;
        xdu[wc * kQ + i1] = xu1;
        wv[wc * kQ + i0] = ed0 * d0 * xv0;
        wv[wc * kQ + i1] = ed1 * d1 * xv1;
      }
    }

    // dC = (G o L) B + e^{cum_i} (dy h_in) and dB = (G o L)^T C +
    // e^{cum_Q - cum_j} dt_j (x dh) on the state's columns, 16 at a
    // time, the warp taking those of its parity; the warp's part of
    // e^{cum_i} dy_i . (h_in C_i)
    {
      const float ec0 = ecum[i0], ec1 = ecum[i1];
      const float ew0 = edec[i0] * dts[i0], ew1 = edec[i1] * dts[i1];
      float in0 = 0.f, in1 = 0.f;
#pragma unroll
      for (int ng = 0; ng < N; ng += 32) {
        if (ng + 16 * wc >= N) break;
        const int ncol = ng + 16 * wc;
        float dc[2][4] = {}, d2[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < kQ / 16; ++kk) {
          if (kk > wr) break;
          uint32_t af[4], bf[4];
          ldmatrix_x4(af, gls + (wr * 16 + fr) * kMS + kk * 16 + fc);
          ldmatrix_x4_trans(bf, bs + (kk * 16 + fr) * kCS + ncol + fc);
          mma_bf16(dc[0], af, bf[0], bf[1]);
          mma_bf16(dc[1], af, bf[2], bf[3]);
        }
#pragma unroll
        for (int kp = 0; kp < P / 16; ++kp) {
          uint32_t af[4], bf[4];
          ldmatrix_x4(af, dys + (wr * 16 + fr) * kXS + kp * 16 + fc);
          ldmatrix_x4_trans(bf, hs + (kp * 16 + fr) * kCS + ncol + fc);
          mma_bf16(d2[0], af, bf[0], bf[1]);
          mma_bf16(d2[1], af, bf[2], bf[3]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int col = ncol + nt * 8 + t2;
          const float2 c0v = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(cs + i0 * kCS + col));
          const float2 c1v = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(cs + i1 * kCS + col));
          in0 += c0v.x * d2[nt][0] + c0v.y * d2[nt][1];
          in1 += c1v.x * d2[nt][2] + c1v.y * d2[nt][3];
          if (i0 < nv)
            *reinterpret_cast<float2*>(dc_part + ((row0 + i0) * h + hh) * N +
                                       col) =
                make_float2(dc[nt][0] + ec0 * d2[nt][0],
                            dc[nt][1] + ec0 * d2[nt][1]);
          if (i1 < nv)
            *reinterpret_cast<float2*>(dc_part + ((row0 + i1) * h + hh) * N +
                                       col) =
                make_float2(dc[nt][2] + ec1 * d2[nt][2],
                            dc[nt][3] + ec1 * d2[nt][3]);
        }
        float db[2][4] = {}, e2[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < kQ / 16; ++kk) {
          if (kk < wr) continue;
          uint32_t af[4], bf[4];
          ldmatrix_x4_trans(af, gls + (kk * 16 + br) * kMS + wr * 16 + bc);
          ldmatrix_x4_trans(bf, cs + (kk * 16 + fr) * kCS + ncol + fc);
          mma_bf16(db[0], af, bf[0], bf[1]);
          mma_bf16(db[1], af, bf[2], bf[3]);
        }
#pragma unroll
        for (int kp = 0; kp < P / 16; ++kp) {
          uint32_t af[4], bf[4];
          ldmatrix_x4(af, xs + (wr * 16 + fr) * kXS + kp * 16 + fc);
          ldmatrix_x4_trans(bf, dhs + (kp * 16 + fr) * kCS + ncol + fc);
          mma_bf16(e2[0], af, bf[0], bf[1]);
          mma_bf16(e2[1], af, bf[2], bf[3]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int col = ncol + nt * 8 + t2;
          if (i0 < nv)
            *reinterpret_cast<float2*>(db_part + ((row0 + i0) * h + hh) * N +
                                       col) =
                make_float2(db[nt][0] + ew0 * e2[nt][0],
                            db[nt][1] + ew0 * e2[nt][1]);
          if (i1 < nv)
            *reinterpret_cast<float2*>(db_part + ((row0 + i1) * h + hh) * N +
                                       col) =
                make_float2(db[nt][2] + ew1 * e2[nt][2],
                            db[nt][3] + ew1 * e2[nt][3]);
        }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        in0 += __shfl_xor_sync(0xffffffffu, in0, o);
        in1 += __shfl_xor_sync(0xffffffffu, in1, o);
      }
      if (lane % 4 == 0) {
        inter[wc * kQ + i0] = ec0 * in0;
        inter[wc * kQ + i1] = ec1 * in1;
      }
    }
    __syncthreads();   // every read of dh's, h_in's, M's and G o L's tiles

    // dh <- e^{cum_Q} dh + (dy o e^{cum})^T C, then its operand tile
    if (owner) {
      const float decay = ecum[kQ - 1];
#pragma unroll
      for (int k = 0; k < kUPW; ++k)
#pragma unroll
        for (int kt = 0; kt < 2; ++kt)
#pragma unroll
          for (int e = 0; e < 4; ++e) dh[k][kt][e] *= decay;
#pragma unroll
      for (int ks = 0; ks < kQ / 16; ++ks) {
        uint32_t raw[4], yw[4];
        ldmatrix_x4_trans(raw, dys + (ks * 16 + br) * kXS + mt * 16 + bc);
        const int j0 = ks * 16 + t2, j1 = j0 + 8;
        const float w[4] = {ecum[j0], ecum[j0 + 1], ecum[j1], ecum[j1 + 1]};
        weighted_a(raw, w, yw);
#pragma unroll
        for (int k = 0; k < kUPW; ++k) {
          uint32_t bq[4];
          ldmatrix_x4_trans(bq,
                            cs + (ks * 16 + fr) * kCS + np_of(k) * 16 + fc);
          mma_bf16(dh[k][0], yw, bq[0], bq[1]);
          mma_bf16(dh[k][1], yw, bq[2], bq[3]);
        }
      }
      store_dh();
    }
  }
  cp_async_wait<0>();   // only empty groups remain
  if (warp == kTailWarp) {
    tail(0, e_last);
    if (lane == 0)
      da_part[static_cast<size_t>(b) * h + hh] = static_cast<float>(da_acc);
  }
  if (d_init != nullptr)
#pragma unroll
    for (int k = 0; k < kUPW; ++k)
      if (owner)
#pragma unroll
        for (int kt = 0; kt < 2; ++kt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            *reinterpret_cast<float2*>(d_init + st_base +
                                       st_off(np_of(k), kt, e)) =
                make_float2(dh[k][kt][2 * e], dh[k][kt][2 * e + 1]);
}

struct BwdLaunch {
  const void *x, *dt, *a, *b_in, *c_in, *init, *dy, *d_final;
  void *dx, *ddt, *da_part, *db_part, *dc_part, *d_init, *states;
  int bsz, s, h, g;
  cudaStream_t stream;

  // f32 on the CUDA cores: one block a head
  template <int P, int N>
  int cuda_cores() const {
    const size_t smem = BwdSmem<P, N>::kBytes;
    const cudaError_t err =
        allow_dynamic_smem(ssd_bwd_kernel<float, P, N>, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();       // not left for the next launch's check
      return static_cast<int>(err);
    }
    ssd_bwd_kernel<float, P, N><<<dim3(h, bsz), kThreads, smem, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(a), static_cast<const float*>(b_in),
        static_cast<const float*>(c_in), static_cast<const float*>(init),
        static_cast<const float*>(dy), static_cast<const float*>(d_final),
        static_cast<float*>(dx), static_cast<float*>(ddt),
        static_cast<float*>(da_part), static_cast<float*>(db_part),
        static_cast<float*>(dc_part), static_cast<float*>(d_init),
        static_cast<float*>(states), s, h, g);
    return static_cast<int>(cudaGetLastError());
  }

  // bf16 on the tensor cores: one block a head
  template <int P, int N>
  int mma() const {
    const size_t smem = BwdMmaSmem<P, N>::kBytes;
    const cudaError_t err = allow_dynamic_smem(ssd_bwd_mma_kernel<P, N>, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(err);
    }
    ssd_bwd_mma_kernel<P, N><<<dim3(h, bsz), kMmaThreads, smem, stream>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(a), static_cast<const bf16*>(b_in),
        static_cast<const bf16*>(c_in), static_cast<const float*>(init),
        static_cast<const bf16*>(dy), static_cast<const float*>(d_final),
        static_cast<bf16*>(dx), static_cast<float*>(ddt),
        static_cast<float*>(da_part), static_cast<float*>(db_part),
        static_cast<float*>(dc_part), static_cast<float*>(d_init),
        static_cast<bf16*>(states), s, h, g);
    return static_cast<int>(cudaGetLastError());
  }

  template <int P, int N>
  int run(int dtype) const {
    if (dtype == kFloat32) return cuda_cores<P, N>();
    if (dtype == kBFloat16) return mma<P, N>();
    return kUnsupported;
  }

  template <int P>
  int state_dim(int n, int dtype) const {
    switch (n) {
      case 16: return run<P, 16>(dtype);
      case 64: return run<P, 64>(dtype);
      case 128: return run<P, 128>(dtype);
      default: return kUnsupported;
    }
  }

  int dims(int p, int n, int dtype) const {
    switch (p) {
      case 16: return state_dim<16>(n, dtype);
      case 32: return state_dim<32>(n, dtype);
      case 64: return state_dim<64>(n, dtype);
      default: return kUnsupported;
    }
  }
};

}  // namespace bwd

}  // namespace
}  // namespace repro

// K12.  x [B, S, H, P] and y (dtype `dtype`, float32 or bfloat16), dt
// [B, S, H] f32, a [H] f32, b_in and c_in [B, S, G, N] (dtype `dtype`),
// init [B, H, P, N] f32 or null (zeros), state [B, H, P, N] f32 out; all
// contiguous.  P in {16, 32, 64}, N in {16, 64, 128}, chunk == 64.  bf16
// runs the tensor-core kernel, f32 the CUDA-core kernel.
extern "C" int ssd_fwd(const void* x, const void* dt, const void* a,
                       const void* b_in, const void* c_in, void* y,
                       void* state, const void* init, int bsz, int s, int h,
                       int p, int g, int n, int chunk, int dtype,
                       void* stream) {
  if (!repro::supported(bsz, s, h, p, g)) return repro::kUnsupported;
  const repro::SsdLaunch launch{x, nullptr, dt, a, b_in, c_in, init, y,
                                state, bsz, s, h, p, g, chunk,
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
  if (!repro::supported(bsz, s, h, p, g)) return repro::kUnsupported;
  const repro::SsdLaunch launch{x, x_scale, dt, a, b_in, c_in, init, y,
                                state, bsz, s, h, p, g, chunk,
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

// K16.  The backward of K12 on the same x, dt, a, b_in, c_in and init
// (null: zeros), with dy [B, S, H, P] (x's dtype `dtype`) and d_final [B,
// H, P, N] f32 (null: zeros), the gradients of y and of the final state.
// Writes dx [B, S, H, P] (dtype), ddt [B, S, H] f32, da_part [B, H] f32,
// db_part and dc_part [B, S, H, N] f32 (per head: the caller sums each
// group's heads), d_init [B, H, P, N] f32 (skipped when null), using
// states [B, H, ceil(S / 64), P, N] as scratch (f32; bf16 for bfloat16
// calls); all contiguous.  P in {16, 32, 64}, N in {16, 64, 128}, chunk
// == 64; bfloat16 runs on the tensor cores, float32 on the CUDA cores.
extern "C" int ssd_bwd(const void* x, const void* dt, const void* a,
                       const void* b_in, const void* c_in, const void* init,
                       const void* dy, const void* d_final, void* dx,
                       void* ddt, void* da_part, void* db_part,
                       void* dc_part, void* d_init, void* states, int bsz,
                       int s, int h, int p, int g, int n, int chunk,
                       int dtype, void* stream) {
  if (!repro::supported(bsz, s, h, p, g) || chunk != repro::kQ)
    return repro::kUnsupported;
  const repro::bwd::BwdLaunch launch{
      x, dt, a, b_in, c_in, init, dy, d_final, dx, ddt, da_part, db_part,
      dc_part, d_init, states, bsz, s, h, g,
      static_cast<cudaStream_t>(stream)};
  return launch.dims(p, n, dtype);
}

// The chunks K12 and K13 are built for at head dim p, state dim n and
// B's dtype (f32: the CUDA-core kernel's 64 only), into out (at most
// `max`); returns their count.
extern "C" int ssd_fwd_chunks(int p, int n, int dtype, int* out, int max) {
  if (!repro::supported(1, 1, 1, p, 1) || (n != 16 && n != 64 && n != 128))
    return 0;
  int k = 0;
  for (int chunk : {32, 64, 128}) {
    const bool built =
        dtype == repro::kBFloat16
            ? repro::mma_chunk_built(repro::mma_p_block(p), n, chunk)
            : dtype == repro::kFloat32 && chunk == repro::kQ;
    if (!built) continue;
    if (k < max) out[k] = chunk;
    ++k;
  }
  return k;
}

extern "C" const char* repro_error_string(int code) {
  return repro::error_string(code);
}
