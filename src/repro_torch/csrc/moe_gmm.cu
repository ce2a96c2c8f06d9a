// K14, K15 and K17: the grouped expert matmul of the MoE layer and its
// backward, for Hopper.
//
// K14 replaces the Pallas kernel gmm / _gmm_kernel in
// src/repro/kernels/moe_gmm/kernel.py:41: out[e] = x[e] @ w[e] for every
// expert e, x [E, C, d] (the expert's capacity buffer), w [E, d, f], out
// [E, C, f] in x's dtype, the sum over d in f32 and rounded once.  On the
// TPU the grid is (E, C/bc, f/bf, d/bd) with the contraction axis run in
// order and an f32 VMEM accumulator carried across its steps.
//
// K15 replaces gmm_quantized / _gmm_quant_kernel (same file, :104): K14
// with int8 or fp8 e4m3 weights and one f32 scale per (expert, output
// column), w_scale [E, 1, f].  The scale is constant along d, so it
// multiplies the finished f32 accumulator once, as in the Pallas body.  In
// f32 this is not K14 on the dequantized weights bit for bit: there each
// product is scaled before the sum.
//
// K17 is K14's backward, which the reference does not have as a kernel
// (it differentiates the einsum of src/repro/models/moe.py:133-136): from
// x, w and the gradient dy [E, C, f] of out, dx[e] = dy[e] w[e]^T [E, C,
// d] and dw[e] = x[e]^T dy[e] [E, d, f], each summed in f32 and rounded
// once to its dtype, two launches.
//
// What bounds them on the H100 (3.35 TB/s, 989 TFLOP/s bf16), at the
// main path's shapes (E = 64, d = 2048, f = 1408, bf16): bytes, at every C
// up to 240.  A product reads or writes every expert's weights (or weight
// gradient) once, 369 MB.  At decode (C = 8) that is 3 GFLOP on 0.111 ms
// of bytes; at a 488-token prefill (C = 64) 23.6 GFLOP (0.024 ms) on 0.119
// ms; at the training shape (C = 240) each of K14, dx and dw moves about
// 475 MB (the weights and two activation buffers) for 88.6 GFLOP: 0.142
// ms of bytes against 0.090 of operations.  So a design must read each
// weight tile once, keep enough bytes in flight, and at C = 240 still feed
// the tensor cores at two thirds of their rate.
//
// The paths (the wrapper's shape rule names the one a call runs, GmmPath):
//   gmm_wgmma_kernel (bf16 K14 at C > 32 and every bf16 K17 call, when
//     d and f are multiples of 8 and the operands 16-byte aligned: what
//     TMA can address): warp specialised on wgmma and TMA (below).  The
//     tile takes the whole capacity (up to 256 rows: two consumer
//     warpgroups of 128 at C = 240, one m64 warpgroup at C = 64), so each
//     weight tile is fetched from device memory once a product; the
//     operands are read where they lie (wgmma's transpose bits, no
//     transposed copy of the weights); a ring of TMA stages keeps 144-192
//     KB in flight an SM; persistent blocks overlap each tile's TMA
//     stores with the next tile's products (dw writes 369 MB).  For K14
//     the tile height and the ring's stage count are the caller's choice
//     among the built instances (wgmma_forward); that rule is the
//     analytic pick.
//   gmm_stream_kernel (bf16 x at C <= 32, d a multiple of 8, f of 16
//     bytes of weights, x and w 16-byte aligned: every decode product):
//     a weight stream on the tensor cores, the operands swapped so that
//     the weights are the 16-row A operand, behind a multistage cp.async
//     ring (below), 64, 128 (the analytic pick) or 256 columns a block at
//     the caller's choice; K15's 1-byte chunks are made into bf16 once a
//     stage;
//   gmm_mma_kernel (bf16 at C > 32 that TMA cannot address, and K15 there:
//     its 1-byte weights are converted to bf16 as they are staged, which
//     wgmma's bf16 operands from shared memory cannot take):
//     mma.sync m16n8k16 over one tile, 64 x 64 x 64, register-staged;
//   gmm_bwd_mma_kernel (bf16 K17 that TMA cannot address): mma.sync over
//     128 x 128 tiles behind a cp.async ring;
//   gmm_kernel and gmm_bwd_f32_kernel (f32, the parity dtype, and the
//     ragged bf16 decode shapes): the CUDA cores.
// No atomics and no split of the contraction in any: each output is
// summed by one thread or warpgroup in contraction order, so a repeated
// call gives the same bits.

#include "common.cuh"

#include <algorithm>
#include <atomic>
#include <cstring>
#include <type_traits>

namespace repro {
namespace {

// gmm_kernel: one block of 256 threads per (64-column f-tile, row tile,
// expert); the TPU's sequential d axis becomes a loop inside the block
// over 64-row chunks of w and x staged as f32 in shared memory, the next
// chunk's loads issued into registers before the current chunk is
// consumed.  A thread computes 4 neighbouring columns of RM rows; the
// block's 256 threads are 16 column groups x KS slices of each chunk's
// contraction rows x the row groups, the row tile following C:
//   C <= 8:  RM 8, KS 16 (one row group of 8 rows);
//   C <= 32: RM 8, KS 4  (4 row groups: 32 rows);
//   else:    RM 4, KS 1  (16 row groups: 64-row tiles).
// With KS > 1 the slices' f32 partials meet in shared memory and are
// summed in slice order.  Ragged E, C, d and f are masked; the 16-byte
// loads need f to be a multiple of 16 / sizeof(weight) and an aligned w,
// else the block reads the weights one element at a time.
constexpr int kThreads = 256;
constexpr int kBF = 64;                  // output columns per block
constexpr int kBD = 64;                  // contraction rows per chunk
constexpr int kColGroups = kBF / 4;      // a thread computes 4 columns
constexpr int kSmemFloats = kBD * (64 + 4) + kBD * kBF;   // 33 KB

template <int RM, int KS>
struct Tile {
  static constexpr int kRowGroups = kThreads / (kColGroups * KS);
  static constexpr int kRows = RM * kRowGroups;       // rows per block
  static constexpr int kSliceRows = kBD / KS;         // per thread, chunk
  // x is staged transposed, [kBD][kXStride]: +4 keeps the float4 reads of
  // a row aligned and spreads the transposing stores over the banks
  static constexpr int kXStride = kRows + 4;
  static_assert(kRowGroups * kColGroups * KS == kThreads, "thread layout");
  static_assert(kBD * (kXStride + kBF) <= kSmemFloats, "tiles fit");
  static_assert(KS == 1 || KS * kRows * kBF <= kSmemFloats, "partials fit");
};

// The raw storage of one weight element, for the element-wise loads.
template <int N> struct RawOf;
template <> struct RawOf<1> { using type = uint8_t; };
template <> struct RawOf<2> { using type = uint16_t; };
template <> struct RawOf<4> { using type = uint32_t; };

// 16 bytes of a weight row: columns col .. col + 16 / sizeof(W) - 1 at
// element offset off; zero past f or when the row is masked.
template <typename W>
__device__ __forceinline__ uint4 load_w16(const W* __restrict__ w, size_t off,
                                          int col, int f, bool vec,
                                          bool row_ok) {
  constexpr int E = 16 / sizeof(W);
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (!row_ok || col >= f) return r;
  if (vec) return __ldg(reinterpret_cast<const uint4*>(w + off));
  using Raw = typename RawOf<sizeof(W)>::type;
  Raw tmp[E];
#pragma unroll
  for (int i = 0; i < E; ++i)
    tmp[i] = col + i < f ? reinterpret_cast<const Raw*>(w)[off + i] : Raw(0);
  memcpy(&r, tmp, 16);
  return r;
}

// The 16 / sizeof(W) weights of a 16-byte load as f32, into dst (16-byte
// aligned), four to a store.
template <typename W>
__device__ __forceinline__ void unpack16x4(const uint4& v, float4* dst) {
  constexpr int E = 16 / sizeof(W);
  W tmp[E];
  memcpy(tmp, &v, 16);
#pragma unroll
  for (int i = 0; i < E; i += 4)
    dst[i / 4] = make_float4(to_float(tmp[i]), to_float(tmp[i + 1]),
                             to_float(tmp[i + 2]), to_float(tmp[i + 3]));
}

// T: the dtype of x and out; W: the weights' (T for K14, int8_t or
// __nv_fp8_e4m3 for K15, which passes its f32 w_scale [E, 1, f]).
template <typename T, typename W, int RM, int KS>
__global__ void __launch_bounds__(kThreads)
gmm_kernel(const T* __restrict__ x, const W* __restrict__ w,
           const float* __restrict__ w_scale, T* __restrict__ out, int c,
           int d, int f, int vec) {
  using Tl = Tile<RM, KS>;
  constexpr int kRows = Tl::kRows;
  constexpr int kE = 16 / sizeof(W);                       // weights a load
  constexpr int kWLoads = kBD * kBF / kE / kThreads;       // per thread
  constexpr int kXLoads = (kRows * kBD + kThreads - 1) / kThreads;
  static_assert(kBD * kBF % (kE * kThreads) == 0, "weight loads divide");
  constexpr int kXStride = Tl::kXStride;
  __shared__ __align__(16) float smem[kSmemFloats];
  float (*xs)[kXStride] = reinterpret_cast<float (*)[kXStride]>(smem);
  float (*ws)[kBF] = reinterpret_cast<float (*)[kBF]>(smem + kBD * kXStride);

  const int f0 = blockIdx.x * kBF;
  const int r0 = blockIdx.y * kRows;
  const int e = blockIdx.z;
  const int tid = threadIdx.x;
  const int cg = tid % kColGroups;
  const int slice = (tid / kColGroups) % KS;
  const int rg = tid / (kColGroups * KS);
  const T* xe = x + static_cast<size_t>(e) * c * d;
  const W* we = w + static_cast<size_t>(e) * d * f;

  uint4 wreg[kWLoads];
  T xreg[kXLoads];
  auto load_chunk = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kWLoads; ++j) {
      const int i = tid + j * kThreads;
      const int kk = i / (kBF / kE), col = (i % (kBF / kE)) * kE;
      wreg[j] = load_w16<W>(we, static_cast<size_t>(k0 + kk) * f + f0 + col,
                            f0 + col, f, vec != 0, k0 + kk < d);
    }
#pragma unroll
    for (int j = 0; j < kXLoads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / kBD, kk = i % kBD;
      const bool ok = i < kRows * kBD && r0 + r < c && k0 + kk < d;
      xreg[j] = ok ? xe[static_cast<size_t>(r0 + r) * d + k0 + kk]
                   : from_float<T>(0.f);
    }
  };
  auto store_chunk = [&]() {
#pragma unroll
    for (int j = 0; j < kWLoads; ++j) {
      const int i = tid + j * kThreads;
      const int kk = i / (kBF / kE), col = (i % (kBF / kE)) * kE;
      unpack16x4<W>(wreg[j], reinterpret_cast<float4*>(&ws[kk][col]));
    }
#pragma unroll
    for (int j = 0; j < kXLoads; ++j) {
      const int i = tid + j * kThreads;
      if (i < kRows * kBD) xs[i % kBD][i / kBD] = to_float(xreg[j]);
    }
  };

  float acc[RM][4];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;

  load_chunk(0);
  store_chunk();
  __syncthreads();
  for (int k0 = 0; k0 < d; k0 += kBD) {
    const bool more = k0 + kBD < d;
    if (more) load_chunk(k0 + kBD);   // in flight while this chunk is used
#pragma unroll 4
    for (int i = 0; i < Tl::kSliceRows; ++i) {
      const int kk = slice * Tl::kSliceRows + i;
      const float4 wv = *reinterpret_cast<const float4*>(&ws[kk][cg * 4]);
#pragma unroll
      for (int r4 = 0; r4 < RM; r4 += 4) {
        const float4 xv =
            *reinterpret_cast<const float4*>(&xs[kk][rg * RM + r4]);
        const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[r4 + q][0] += xr[q] * wv.x;
          acc[r4 + q][1] += xr[q] * wv.y;
          acc[r4 + q][2] += xr[q] * wv.z;
          acc[r4 + q][3] += xr[q] * wv.w;
        }
      }
    }
    __syncthreads();   // the chunk is consumed
    if (more) {
      store_chunk();
      __syncthreads();
    }
  }

  if constexpr (KS == 1) {
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int row = r0 + rg * RM + r;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = f0 + cg * 4 + q;
        if (row < c && col < f) {
          float a = acc[r][q];
          if (w_scale != nullptr) a *= w_scale[static_cast<size_t>(e) * f + col];
          out[(static_cast<size_t>(e) * c + row) * f + col] = from_float<T>(a);
        }
      }
    }
  } else {
    // the slices' partials [KS][kRows][kBF], summed in slice order
    float* part = smem;
#pragma unroll
    for (int r = 0; r < RM; ++r)
      *reinterpret_cast<float4*>(
          &part[(slice * kRows + rg * RM + r) * kBF + cg * 4]) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    __syncthreads();
    for (int o = tid; o < kRows * kBF; o += kThreads) {
      const int row = r0 + o / kBF, col = f0 + o % kBF;
      if (row >= c || col >= f) continue;
      float a = 0.f;
#pragma unroll
      for (int s = 0; s < KS; ++s) a += part[s * kRows * kBF + o];
      if (w_scale != nullptr) a *= w_scale[static_cast<size_t>(e) * f + col];
      out[(static_cast<size_t>(e) * c + row) * f + col] = from_float<T>(a);
    }
  }
}

// ------------------------------------------------------------ tensor cores

// The bf16 path at C > 32 (a prefill's capacity buffers): K14 and K15 on
// the tensor cores.  One block of 256 threads per (64-column f-tile,
// 64-row tile, expert), the contraction in 64-deep chunks staged as bf16
// in shared memory (rows padded by 16 bytes, so that the 8 row addresses
// of each ldmatrix fall in distinct banks), the next chunk's loads in
// flight in registers while the current one is consumed.  Warp w owns
// rows 16 (w % 4) .. + 15 and columns 32 (w / 4) .. + 31 of the tile:
// per 16-deep step one ldmatrix for A, two transposed ldmatrix for B and
// four mma.sync m16n8k16 into f32 accumulators, rounded once (after K15's
// column scale) to bf16.
template <typename W>
__global__ void __launch_bounds__(kThreads)
gmm_mma_kernel(const __nv_bfloat16* __restrict__ x, const W* __restrict__ w,
               const float* __restrict__ w_scale,
               __nv_bfloat16* __restrict__ out, int c, int d, int f,
               int xvec, int wvec) {
  constexpr int kM = 64;                            // rows per block
  constexpr int kXS = kBD + 8, kWS = kBF + 8;       // staged row strides
  constexpr int kE = 16 / sizeof(W);                // weights a load
  constexpr int kWLoads = kBD * kBF / kE / kThreads;
  constexpr int kXLoads = kM * kBD / 8 / kThreads;
  __shared__ __align__(16) __nv_bfloat16 xs[kM][kXS];    // [row][k]
  __shared__ __align__(16) __nv_bfloat16 ws[kBD][kWS];   // [k][column]

  const int f0 = blockIdx.x * kBF;
  const int r0 = blockIdx.y * kM;
  const int e = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp % 4) * 16, wn = (warp / 4) * 32;
  const __nv_bfloat16* xe = x + static_cast<size_t>(e) * c * d;
  const W* we = w + static_cast<size_t>(e) * d * f;

  uint4 xreg[kXLoads], wreg[kWLoads];
  auto load_chunk = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kXLoads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / (kBD / 8), kk = (i % (kBD / 8)) * 8;
      xreg[j] = load_w16<__nv_bfloat16>(
          xe, static_cast<size_t>(r0 + r) * d + k0 + kk, k0 + kk, d,
          xvec != 0, r0 + r < c);
    }
#pragma unroll
    for (int j = 0; j < kWLoads; ++j) {
      const int i = tid + j * kThreads;
      const int kk = i / (kBF / kE), col = (i % (kBF / kE)) * kE;
      wreg[j] = load_w16<W>(we, static_cast<size_t>(k0 + kk) * f + f0 + col,
                            f0 + col, f, wvec != 0, k0 + kk < d);
    }
  };
  auto store_chunk = [&]() {
#pragma unroll
    for (int j = 0; j < kXLoads; ++j) {
      const int i = tid + j * kThreads;
      *reinterpret_cast<uint4*>(&xs[i / (kBD / 8)][(i % (kBD / 8)) * 8]) =
          xreg[j];
    }
#pragma unroll
    for (int j = 0; j < kWLoads; ++j) {
      const int i = tid + j * kThreads;
      store_bf16<W>(wreg[j], reinterpret_cast<uint4*>(
                                 &ws[i / (kBF / kE)][(i % (kBF / kE)) * kE]));
    }
  };

  float acc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[n][q] = 0.f;

  load_chunk(0);
  store_chunk();
  __syncthreads();
  for (int k0 = 0; k0 < d; k0 += kBD) {
    const bool more = k0 + kBD < d;
    if (more) load_chunk(k0 + kBD);   // in flight while this chunk is used
#pragma unroll
    for (int ks = 0; ks < kBD; ks += 16) {
      const int lr = frag_row(lane), lc = frag_col(lane);
      uint32_t a[4];
      ldmatrix_x4(a, &xs[wm + lr][ks + lc]);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, &ws[ks + lr][wn + nb * 16 + lc]);
        mma_bf16(acc[2 * nb], a, b[0], b[1]);
        mma_bf16(acc[2 * nb + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();   // the chunk is consumed
    if (more) {
      store_chunk();
      __syncthreads();
    }
  }

  const int g = lane / 4, t2 = (lane % 4) * 2;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = r0 + wm + g + (q / 2) * 8;
      const int col = f0 + wn + n * 8 + t2 + q % 2;
      if (row < c && col < f) {
        float a = acc[n][q];
        if (w_scale != nullptr) a *= w_scale[static_cast<size_t>(e) * f + col];
        out[(static_cast<size_t>(e) * c + row) * f + col] =
            __float2bfloat16(a);
      }
    }
  }
}

// K17 in bf16: dx and dw on the tensor cores.  Per expert e the kernel
// computes out[M][N] = A[M][K] B[K][N] with each operand read where it
// lies: A stored [M][K] (kAT false: dy for dx) or [K][M] (kAT true: x for
// dw), B stored [K][N] (kBT false: dy for dw) or [N][K] (kBT true: w for
// dx, which no transposed copy of the 369 MB weights precedes).  One block
// of 8 warps per (128-column N-tile, 128-row M-tile, expert); warp w owns
// rows 64 (w / 4) .. + 63 and columns 32 (w % 4) .. + 31: four m16 tiles
// by four n8 tiles, 16 mma.sync m16n8k16 per 16-deep step against four A
// and two B ldmatrix (.trans where the operand is stored with the
// contraction outer).  The contraction runs in 32-deep chunks through a
// kBwdStages-stage cp.async ring of raw bf16 tiles in the operands' own
// orientation (rows padded by 16 bytes: the 8 row addresses of each
// ldmatrix fall in distinct banks); an operand whose rows are not whole
// 16-byte copies is read an element at a time into its stage instead.
// The f32 sums are rounded once to bf16 into a [128][128 + 8] tile of
// shared memory and leave it as whole 16-byte rows (dw's output is 369 MB
// at the training shape: written two bytes at a time from the fragments,
// a 32-byte sector carried 8).  Ragged M, N and K are masked.  dw's
// contraction is the C capacity rows (240 at the training shape: 8
// chunks); its grid is 11 x 16 x 64 = 11,264 blocks.
constexpr int kBwdTile = 128;      // M and N of a block
constexpr int kBwdChunk = 32;      // contraction rows of a ring stage
constexpr int kBwdStages = 3;

// Shared memory of gmm_bwd_mma_kernel, in bf16 elements: kBwdStages stages
// of the A tile then the B tile, each [outer][inner + 8] as stored; after
// the loop the output tile [kBwdTile][kBwdTile + 8] over them.
template <bool kAT, bool kBT>
struct BwdSmem {
  static constexpr int kAO = kAT ? kBwdChunk : kBwdTile;   // A's rows
  static constexpr int kAI = kAT ? kBwdTile : kBwdChunk;   // its columns
  static constexpr int kBO = kBT ? kBwdTile : kBwdChunk;
  static constexpr int kBI = kBT ? kBwdChunk : kBwdTile;
  static constexpr int kAS = kAI + 8, kBS = kBI + 8;      // row strides
  static constexpr int kBOff = kAO * kAS;                 // B in a stage
  static constexpr int kStage = kBOff + kBO * kBS;
  static constexpr int kOS = kBwdTile + 8;                // output stride
  static constexpr int kElems =
      kBwdStages * kStage > kBwdTile * kOS ? kBwdStages * kStage
                                           : kBwdTile * kOS;
  static constexpr size_t kBytes = sizeof(bf16) * kElems;
};

// 16 bytes of an operand stored [rows][cols] (an expert's slab) at (row,
// col) into shared memory: by cp.async when its rows are whole 16-byte
// copies (vec), else an element at a time; zeros past rows or cols.
__device__ __forceinline__ void bwd_copy16(bf16* dst, const bf16* __restrict__ src,
                                           int row, int col, int rows,
                                           int cols, bool vec) {
  const bool ok = row < rows && col < cols;
  if (vec) {
    cp_async16(dst, src + (ok ? static_cast<size_t>(row) * cols + col : 0),
               ok);
  } else {
    *reinterpret_cast<uint4*>(dst) = load_w16<bf16>(
        src, static_cast<size_t>(row) * cols + col, col, cols, false,
        row < rows);
  }
}

template <bool kAT, bool kBT>
__global__ void __launch_bounds__(kThreads)
gmm_bwd_mma_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                   bf16* __restrict__ out, int m, int n, int kdim, int avec,
                   int bvec, int ovec) {
  using L = BwdSmem<kAT, kBT>;
  constexpr int kMT = 4, kNT = 4;                   // a warp's m16 / n8 tiles
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  bf16* smem = reinterpret_cast<bf16*>(bwd_smem);
  const int n0 = blockIdx.x * kBwdTile;
  const int m0 = blockIdx.y * kBwdTile;
  const int e = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  const bf16* ae = a + static_cast<size_t>(e) * m * kdim;
  const bf16* be = b + static_cast<size_t>(e) * kdim * n;
  const int n_chunks = (kdim + kBwdChunk - 1) / kBwdChunk;

  // chunk t into its stage, then a commit (an empty group past the last
  // chunk, so that every iteration waits for the same count)
  const auto fetch = [&](int t) {
    if (t < n_chunks) {
      bf16* st = smem + (t % kBwdStages) * L::kStage;
      const int k0 = t * kBwdChunk;
      for (int i = tid; i < L::kAO * (L::kAI / 8); i += kThreads) {
        const int r = i / (L::kAI / 8), c = (i % (L::kAI / 8)) * 8;
        bwd_copy16(st + r * L::kAS + c, ae, (kAT ? k0 : m0) + r,
                   (kAT ? m0 : k0) + c, kAT ? kdim : m, kAT ? m : kdim,
                   avec != 0);
      }
      for (int i = tid; i < L::kBO * (L::kBI / 8); i += kThreads) {
        const int r = i / (L::kBI / 8), c = (i % (L::kBI / 8)) * 8;
        bwd_copy16(st + L::kBOff + r * L::kBS + c, be, (kBT ? n0 : k0) + r,
                   (kBT ? k0 : n0) + c, kBT ? n : kdim, kBT ? kdim : n,
                   bvec != 0);
      }
    }
    cp_async_commit();
  };
  for (int t = 0; t < kBwdStages - 1; ++t) fetch(t);

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
  const int fr = frag_row(lane), fc = frag_col(lane);
  const int br = brow(lane), bc = bcol(lane);
  for (int t = 0; t < n_chunks; ++t) {
    cp_async_wait<kBwdStages - 2>();   // this thread's copies of chunk t
    __syncthreads();                   // everyone's; chunk t - 1 consumed
    fetch(t + kBwdStages - 1);         // into the stage t - 1 left
    const bf16* as = smem + (t % kBwdStages) * L::kStage;
    const bf16* bs = as + L::kBOff;
#pragma unroll
    for (int ks = 0; ks < kBwdChunk; ks += 16) {
      uint32_t af[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int row = wm + mt * 16;
        if constexpr (kAT)
          ldmatrix_x4_trans(af[mt], as + (ks + br) * L::kAS + row + bc);
        else
          ldmatrix_x4(af[mt], as + (row + fr) * L::kAS + ks + fc);
      }
#pragma unroll
      for (int nb = 0; nb < kNT / 2; ++nb) {
        const int col = wn + nb * 16;
        uint32_t bf[4];
        if constexpr (kBT)
          ldmatrix_x4(bf, bs + (col + br) * L::kBS + ks + bc);
        else
          ldmatrix_x4_trans(bf, bs + (ks + fr) * L::kBS + col + fc);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(acc[mt][2 * nb], af[mt], bf[0], bf[1]);
          mma_bf16(acc[mt][2 * nb + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();   // only empty groups remain
  __syncthreads();      // every warp is done with the stages

  // the f32 sums rounded once, into the output tile, then whole rows out
  bf16* ot = smem;
  const int g = lane / 4, t2 = (lane % 4) * 2;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<__nv_bfloat162*>(
            ot + (wm + mt * 16 + g + 8 * h) * L::kOS + wn + nt * 8 + t2) =
            __floats2bfloat162_rn(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
  __syncthreads();
  bf16* oe = out + static_cast<size_t>(e) * m * n;
  for (int i = tid; i < kBwdTile * (kBwdTile / 8); i += kThreads) {
    const int r = i / (kBwdTile / 8), c = (i % (kBwdTile / 8)) * 8;
    const int row = m0 + r, col = n0 + c;
    if (row >= m || col >= n) continue;
    const bf16* src = ot + r * L::kOS + c;
    bf16* dst = oe + static_cast<size_t>(row) * n + col;
    if (ovec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int u = 0; u < 8 && col + u < n; ++u) dst[u] = src[u];
    }
  }
}

// f32 K17 on the CUDA cores (the parity dtype): out[M][N] = A B per
// expert with A and B read in place as gmm_mma_kernel reads them (kAT,
// kBT).  One block of 256 threads per (64-column, 64-row tile, expert),
// each thread 4 x 4 outputs; the contraction in 16-deep chunks staged in
// shared memory as [k][m] and [k][n] whatever the stored orientation, and
// summed in order in f32 registers.
template <bool kAT, bool kBT>
__global__ void __launch_bounds__(kThreads)
gmm_bwd_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ out, int m, int n, int kdim) {
  constexpr int kT = 64, kKC = 16;
  __shared__ __align__(16) float as[kKC][kT + 4];
  __shared__ __align__(16) float bs[kKC][kT + 4];
  const int n0 = blockIdx.x * kT;
  const int m0 = blockIdx.y * kT;
  const int e = blockIdx.z;
  const int tid = threadIdx.x;
  const int tm = tid / 16, tn = tid % 16;
  const float* ae = a + static_cast<size_t>(e) * m * kdim;
  const float* be = b + static_cast<size_t>(e) * kdim * n;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < kdim; k0 += kKC) {
    // neighbouring threads read along the operand's stored rows (an
    // expert's operand has fewer than 2^31 values: int offsets)
    for (int i = tid; i < kT * kKC; i += kThreads) {
      const int mm = kAT ? i % kT : i / kKC, kk = kAT ? i / kT : i % kKC;
      const int gm = m0 + mm, gk = k0 + kk;
      as[kk][mm] = gm < m && gk < kdim
                       ? ae[kAT ? gk * m + gm : gm * kdim + gk] : 0.f;
    }
    for (int i = tid; i < kT * kKC; i += kThreads) {
      const int nn = kBT ? i / kKC : i % kT, kk = kBT ? i % kKC : i / kT;
      const int gn = n0 + nn, gk = k0 + kk;
      bs[kk][nn] = gn < n && gk < kdim
                       ? be[kBT ? gn * kdim + gk : gk * n + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKC; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&as[kk][tm * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&bs[kk][tn * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += ar[i] * bw[j];
    }
    __syncthreads();   // the chunk is consumed
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + tm * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tn * 4 + j;
      if (row < m && col < n)
        out[(static_cast<size_t>(e) * m + row) * n + col] = acc[i][j];
    }
  }
}

// ------------------------------------------------------------ wgmma
//
// The bf16 grouped product on Hopper's wgmma and TMA: K14 at C > 32 and
// both products of K17.  Per expert e the kernel computes out[M][N] =
// A[M][K] B[K][N] with each operand read where it lies: A stored [M][K]
// (kAT false: x for K14, dy for dx) or [K][M] (kAT true: x for dw), B
// stored [K][N] (kBT false: w for K14, dy for dw) or [N][K] (kBT true: w
// for dx); wgmma's transpose bits take the stored orientation, so no
// operand is copied transposed.  Every operand and the output is a 3-D
// TMA map over [E][rows][cols] with the expert outermost and 128-byte
// swizzle: a box past an expert's last row or column lands as zeros (C =
// 240 in a 256-row tile) and a store past it is clipped, without reading
// or writing the next expert's rows.
//
// A block is persistent: it walks the output tiles t = blockIdx.x,
// blockIdx.x + gridDim.x, ... in a fixed expert-major order (one block an
// SM, so the experts in flight keep their activations in the L2).  Warp
// specialised: warpgroup 0 is the producer, one thread of which keeps
// TMA loads of 64-deep stages (A's kBM x 64 and B's 64 x 128 values)
// running through a ring of kStages stages with a full and an empty
// mbarrier each (4 stages of 48 KB at 256 rows, 6 of 24 KB at 64);
// warpgroups 1 .. kWG are consumers, each owning kBM / kWG rows of the
// tile: per stage 4 x kMW wgmma m64n128k16 into f32 registers, the stage
// released once the next stage's products are issued (one wgmma group in
// flight).  A tile's epilogue rounds the f32 sums once to bf16, one
// 64-column box of the consumer's rows at a time, into a box of shared
// memory in TMA's swizzled layout, and issues its TMA store; the second
// box waits only for the first store to have read the box, and the last
// store runs while the next tile's products do.  (Staging the whole
// [kBM][128] tile at once leaves room for 3 stages at 256 rows, and was
// slower: PERF.md, PR 29.)  Each output
// element is summed by one warpgroup in contraction order: no split of K,
// no atomics, the same bits on a repeated call.  setmaxnreg moves
// registers from the producer (40) to the consumers (232) when there are
// two consumer warpgroups.
constexpr int kWgBK = 64;          // contraction depth of a ring stage
constexpr int kWgBN = 128;         // output columns of a tile
constexpr int kWgSmemMax = 232448;   // shared memory a block may use
constexpr int kWgMaxStages = 6;    // the stage cap K17 and a default K14 take

// The ring holds as many stages as fit beside the output boxes, at most
// kCap: the caller's choice for K14 (wgmma_forward), kWgMaxStages for K17.
// Neither the tile height nor the stage count moves a sum: every output is
// summed by one warpgroup over the same 16-deep wgmma steps in contraction
// order, so every (kBM, stages) gives the same bits.
template <int kBM, int kCap = kWgMaxStages>
struct WgmmaTile {
  static constexpr int kWG = kBM == 64 ? 1 : 2;     // consumer warpgroups
  static constexpr int kRows = kBM / kWG;            // rows a consumer owns
  static constexpr int kMW = kRows / 64;             // its m64 blocks
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr int kABytes = kBM * kWgBK * 2;
  static constexpr int kBBytes = kWgBN * kWgBK * 2;
  static constexpr int kStage = kABytes + kBBytes;
  static constexpr int kBox = kRows * 128;           // [kRows][64] bf16
  static constexpr int kOut = kWG * kBox;            // a box per consumer
  // 1024 bytes of slack to align the tiles, the output boxes, 2 barriers
  // a stage
  static constexpr int kFixed = 1024 + kOut + 2 * 8 * kCap;
  static constexpr int kStages =
      (kWgSmemMax - kFixed) / kStage < kCap ? (kWgSmemMax - kFixed) / kStage
                                            : kCap;
  static constexpr int kBytes = kFixed + kStages * kStage;
  static_assert(kMW * kWG * 64 == kBM && kStages >= 2, "tile layout");
};

template <bool kAT, bool kBT, int kBM, int kCap>
__global__ void __launch_bounds__(WgmmaTile<kBM, kCap>::kThreads, 1)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const __grid_constant__ CUtensorMap map_out, int m, int n,
                 int kdim, int e) {
  using L = WgmmaTile<kBM, kCap>;
  constexpr int kStages = L::kStages, kMW = L::kMW;
  extern __shared__ unsigned char wg_smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wg_smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* otile = ring + kStages * L::kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(otile + L::kOut);
  uint64_t* empty = full + kStages;

  const int tiles_n = (n + kWgBN - 1) / kWgBN;
  const int per_expert = ((m + kBM - 1) / kBM) * tiles_n;
  const int tiles = per_expert * e;
  const int nk = (kdim + kWgBK - 1) / kWgBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], L::kWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {   // the producer
    if constexpr (L::kWG > 1) setmaxnreg_dec<40>();
    if (threadIdx.x != 0) return;
    int s = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int ex = t / per_expert, r = t % per_expert;
      const int m0 = (r / tiles_n) * kBM, n0 = (r % tiles_n) * kWgBN;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(&empty[s], phase ^ 1);
        unsigned char* as = ring + s * L::kStage;
        unsigned char* bs = as + L::kABytes;
        const int k0 = kb * kWgBK;
        mbar_arrive_expect_tx(&full[s], L::kStage);
        if constexpr (kAT) {   // [k0, k0 + 64) x 64 columns of M, kBM / 64 boxes
#pragma unroll
          for (int i = 0; i < kBM / 64; ++i)
            tma_load_3d(as + i * 8192, &map_a, &full[s], m0 + 64 * i, k0, ex);
        } else {               // kBM rows x [k0, k0 + 64)
          tma_load_3d(as, &map_a, &full[s], k0, m0, ex);
        }
        if constexpr (kBT) {   // 128 rows of N x [k0, k0 + 64)
          tma_load_3d(bs, &map_b, &full[s], k0, n0, ex);
        } else {               // [k0, k0 + 64) x 64 columns of N, two boxes
          tma_load_3d(bs, &map_b, &full[s], n0, k0, ex);
          tma_load_3d(bs + 8192, &map_b, &full[s], n0 + 64, k0, ex);
        }
        if (++s == kStages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // a consumer: rows c * kRows .. + kRows - 1 of each tile
  if constexpr (L::kWG > 1) setmaxnreg_inc<232>();
  const int c = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  unsigned char* box = otile + c * L::kBox;
  float acc[kMW][64];   // a tile's first product overwrites (scale_d 0)
#pragma unroll
  for (int mb = 0; mb < kMW; ++mb)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[mb][i] = 0.f;
  int s = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int ex = t / per_expert, r = t % per_expert;
    const int m0 = (r / tiles_n) * kBM, n0 = (r % tiles_n) * kWgBN;
    int held = -1;   // the stage whose products are still in flight
    for (int kb = 0; kb < nk; ++kb) {
      mbar_wait(&full[s], phase);
      const unsigned char* as = ring + s * L::kStage;
      const unsigned char* bs = as + L::kABytes;
      wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < kWgBK / 16; ++k16) {
        const uint64_t db =
            kBT ? wgmma_desc(bs + 32 * k16, 16, 1024)
                : wgmma_desc(bs + 2048 * k16, 8192, 1024);
#pragma unroll
        for (int mb = 0; mb < kMW; ++mb) {
          const int blk = c * kMW + mb;   // the tile's m64 block
          const uint64_t da =
              kAT ? wgmma_desc(as + blk * 8192 + 2048 * k16, 8192, 1024)
                  : wgmma_desc(as + blk * 8192 + 32 * k16, 16, 1024);
          wgmma_m64n128k16<kAT ? 1 : 0, kBT ? 0 : 1>(acc[mb], da, db,
                                                   kb > 0 || k16 > 0);
        }
      }
      wgmma_commit();
      if (held >= 0) {
        wgmma_wait<1>();   // the previous stage's products are done
        if (tid == 0) mbar_arrive(&empty[held]);
      }
      held = s;
      if (++s == kStages) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mb = 0; mb < kMW; ++mb) wgmma_fence_operands(acc[mb]);
    if (tid == 0) mbar_arrive(&empty[held]);

    // the epilogue, one 64-column box at a time: the box is written
    // once the store that last left it has read it
    const int row0 = m0 + c * L::kRows;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      if (tid == 0) bulk_wait_read<0>();
      named_barrier(1 + c, 128);
#pragma unroll
      for (int mb = 0; mb < kMW; ++mb)
#pragma unroll
        for (int j = 8 * b; j < 8 * b + 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // row `row` of the consumer's rows, columns 8 j + 2 (lane % 4)
            // and + 1, its 16-byte chunks swizzled as TMA reads them
            const int row = mb * 64 + warp * 16 + lane / 4 + 8 * h;
            const int chunk = (j % 8) ^ (row % 8);
            *reinterpret_cast<uint32_t*>(box + row * 128 + chunk * 16 +
                                         (lane % 4) * 4) =
                pack_bf16(acc[mb][4 * j + 2 * h], acc[mb][4 * j + 2 * h + 1]);
          }
      fence_async_smem();
      named_barrier(1 + c, 128);
      if (tid == 0 && row0 < m && n0 + 64 * b < n) {
        tma_store_3d(&map_out, box, n0 + 64 * b, row0, ex);
        bulk_commit();
      }
    }
  }
  if (tid == 0) bulk_wait<0>();   // the last stores are out
}

// The bf16 path at C <= 32 (decode): a weight stream on the tensor cores,
// K14 over bf16 weights and K15 over int8 / e4m3 weights, in place of the
// Pallas gmm / _gmm_kernel and gmm_quantized / _gmm_quant_kernel at the
// decode shapes.  A decode product reads every expert's weights once for a
// few rows of x (64 x 2048 x 1408 bf16 = 369 MB for 3 GFLOP at C = 8;
// half the bytes in int8), so the kernel is built to keep the weight
// stream in flight: the operands are swapped, out^T [f, C] = w^T [f, d]
// x^T [d, C], so that the weights are the 16-row A operand (from a [d][f]
// tile through ldmatrix.trans) and the capacity rows the n8 B operand (x's
// [C][d] rows through ldmatrix): at C = 8 one m16n8k16 step uses every lane
// with no padding; C = 9-32 takes NT = 2 or 4 n-tiles.  One block of kSF
// / 16 warps per (kSF-column f-tile, expert), warp w owning columns 16 w ..
// 16 w + 15: kSF, the tile's width, is the caller's choice (64, 128 or
// 256 columns: 4, 8 or 16 warps; the analytic pick is 128), which moves
// no sum (each column is summed by one warp in contraction order at every
// width, so every width gives the same bits).  The contraction runs
// through a kStreamStages-stage cp.async ring of raw chunks (64 rows of
// w's kSF columns, 16 KB in bf16 at 128 columns, 8 KB in 1-byte weights,
// and the chunk's x rows), 3 chunks in flight while one is consumed, 2-4
// blocks an SM at 128 columns: some 50-100 KB in flight an SM, where
// Little's law at 3.35 TB/s asks about 20 KB.  bf16 weights are used where
// they land.  1-byte weights: ldmatrix.trans takes no 8-bit elements, and
// an A fragment pairs two contraction rows of a column, so after the
// ring's barrier the block converts the chunk once into one bf16 chunk
// (exact for int8 and e4m3) and meets a second barrier before the
// products; the f32 column scale multiplies the finished accumulator once,
// as in the Pallas body.  The f32 accumulators are rounded once into out
// [e, c, f] (no split of the contraction, no atomics: a repeated call
// gives the same bits).  The grid is one block per tile (at 128 columns
// 704 for the gate and up products, 1,024 for down): the ring keeps the
// tail wave's bytes in flight.  Rows past d or C and columns past f land
// as zeros without a read: d a multiple of 8, f a multiple of 16 /
// sizeof(weight), and x and
// w 16-byte aligned (the wrapper's shape rule sends other shapes to
// gmm_kernel).
constexpr int kSD = 64;           // contraction rows of a ring stage
constexpr int kStreamStages = 4;
// The tile widths kSF (output columns, A rows, of a block) the library
// builds are 64, 128 and 256 (GmmLaunch::stream_width; ops.STREAM_COLUMNS
// mirrors them).

// Shared memory of gmm_stream_kernel, in bytes: kStreamStages stages, each
// the chunk's weights (bf16 W: [kSD][kSF + 8], rows padded by 16 bytes so
// that the 8 row addresses of an ldmatrix fall in distinct banks; 1-byte
// W: [kSD][kSF] raw bytes) then its [NT * 8][kSD + 8] bf16 x rows; for
// 1-byte W, then the [kSD][kSF + 8] bf16 chunk the bytes become.  150 KB
// at the widest (256 columns, bf16, NT 4): one block an SM.
template <typename W, int NT, int kSF>
struct StreamSmem {
  static constexpr int kThreads = 2 * kSF;             // kSF / 16 warps
  static constexpr bool kWide = sizeof(W) == 2;        // staged as it is
  static constexpr int kWS = kSF + 8, kXS = kSD + 8;   // bf16 row strides
  static constexpr size_t kXOff =                      // x rows, in a stage
      kWide ? sizeof(bf16) * kSD * kWS : static_cast<size_t>(kSD) * kSF;
  static constexpr size_t kStage = kXOff + sizeof(bf16) * NT * 8 * kXS;
  static constexpr size_t kTile = kStreamStages * kStage;
  static constexpr size_t kBytes =
      kTile + (kWide ? 0 : sizeof(bf16) * kSD * kWS);
};

template <typename W, int NT, int kSF>
__global__ void __launch_bounds__(StreamSmem<W, NT, kSF>::kThreads)
gmm_stream_kernel(const __nv_bfloat16* __restrict__ x,
                  const W* __restrict__ w, const float* __restrict__ w_scale,
                  __nv_bfloat16* __restrict__ out, int c, int d, int f) {
  using L = StreamSmem<W, NT, kSF>;
  constexpr int kThreads = L::kThreads;
  constexpr bool kWide = L::kWide;
  constexpr int kE = 16 / sizeof(W);   // weights a 16-byte copy
  extern __shared__ __align__(16) unsigned char stream_smem[];
  bf16* wt = reinterpret_cast<bf16*>(stream_smem + L::kTile);   // 1-byte W
  const int f0 = blockIdx.x * kSF;
  const int e = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const bf16* xe = x + static_cast<size_t>(e) * c * d;
  const W* we = w + static_cast<size_t>(e) * d * f;
  const int n_chunks = (d + kSD - 1) / kSD;
  const auto stage = [&](int ch) {
    return stream_smem + (ch % kStreamStages) * L::kStage;
  };

  // chunk `ch` into its stage, then a commit (an empty group past the
  // last chunk, so that every iteration waits for the same count)
  const auto fetch = [&](int ch) {
    if (ch < n_chunks) {
      unsigned char* st = stage(ch);
      const int d0 = ch * kSD;
      for (int i = tid; i < kSD * (kSF / kE); i += kThreads) {
        const int r = i / (kSF / kE), col = (i % (kSF / kE)) * kE;
        const bool in = d0 + r < d && f0 + col < f;
        cp_async16(st + sizeof(W) * (r * (kWide ? L::kWS : kSF) + col),
                   we + (in ? static_cast<size_t>(d0 + r) * f + f0 + col : 0),
                   in);
      }
      bf16* xs = reinterpret_cast<bf16*>(st + L::kXOff);
      for (int i = tid; i < NT * 8 * (kSD / 8); i += kThreads) {
        const int r = i / (kSD / 8), col = (i % (kSD / 8)) * 8;
        const bool in = r < c && d0 + col < d;
        cp_async16(xs + r * L::kXS + col,
                   xe + (in ? static_cast<size_t>(r) * d + d0 + col : 0), in);
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < kStreamStages - 1; ++i) fetch(i);

  const int br = brow(lane), bc = bcol(lane);
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int ch = 0; ch < n_chunks; ++ch) {
    cp_async_wait<kStreamStages - 2>();   // this thread's copies of chunk ch
    __syncthreads();                      // every thread's; ch - 1 consumed
    fetch(ch + kStreamStages - 1);        // into the stage ch - 1 left
    const unsigned char* st = stage(ch);
    const bf16* ws = reinterpret_cast<const bf16*>(st);
    if constexpr (!kWide) {
      // the chunk's bytes into the bf16 chunk, 16 a thread and step
      for (int i = tid; i < kSD * (kSF / 16); i += kThreads) {
        const int r = i / (kSF / 16), col = (i % (kSF / 16)) * 16;
        store_bf16<W>(*reinterpret_cast<const uint4*>(st + r * kSF + col),
                      reinterpret_cast<uint4*>(wt + r * L::kWS + col));
      }
      __syncthreads();                    // the bf16 chunk is whole
      ws = wt;
    }
    const bf16* xs = reinterpret_cast<const bf16*>(st + L::kXOff);
#pragma unroll
    for (int ks = 0; ks < kSD; ks += 16) {
      uint32_t a[4];
      ldmatrix_x4_trans(a, ws + (ks + br) * L::kWS + warp * 16 + bc);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t xb[2];
        ldmatrix_x2(xb, xs + (n * 8 + br) * L::kXS + ks + bc);
        mma_bf16(acc[n], a, xb[0], xb[1]);
      }
    }
  }
  cp_async_wait<0>();   // only empty groups remain

  // acc[n]: columns g and g + 8 of the warp's 16, rows 2t and 2t + 1 of
  // n-tile n; K15's column scale on the finished sum, then one rounding
  const int g = lane / 4, t2 = (lane % 4) * 2;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int col = f0 + warp * 16 + g + (q / 2) * 8;
    if (col >= f) continue;
    const float sc = kWide ? 1.f : w_scale[static_cast<size_t>(e) * f + col];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int row = n * 8 + t2 + q % 2;
      if (row < c) {
        float a = acc[n][q];
        if constexpr (!kWide) a *= sc;
        out[(static_cast<size_t>(e) * c + row) * f + col] =
            __float2bfloat16(a);
      }
    }
  }
}

// cuTensorMapEncodeTiled, found through the CUDA runtime's entry-point
// query (no link against libcuda); null if libcuda has none.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// The TMA map of a contiguous bf16 tensor [e][rows][cols] in boxes of 64
// columns (128 bytes, the swizzle's width) x box_rows rows x 1 expert,
// 128-byte swizzle, zeros past every edge: 0, or a kTensorMapError code.
int tensor_map(CUtensorMap* map, const void* base, int e, int rows, int cols,
               int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kTensorMapError;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(e)};
  const cuuint64_t strides[2] = {2ull * cols, 2ull * cols * rows};   // bytes
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError - static_cast<int>(r);
}

// Whether TMA can address a bf16 operand: rows of whole 16-byte units
// (cols a multiple of 8) from a 16-byte aligned base.
bool tma_ok(const void* base, int cols) {
  return cols % 8 == 0 && reinterpret_cast<uintptr_t>(base) % 16 == 0;
}

// The blocks of one gmm_wgmma_kernel instance that the current device
// holds at once (its SMs times the blocks an SM holds), with the shared
// memory the instance needs allowed: queried at the first launch on a
// device and kept, so that later launches spend no attribute or
// occupancy query.
template <bool kAT, bool kBT, int kBM, int kCap>
cudaError_t wgmma_blocks(int* blocks) {
  using L = WgmmaTile<kBM, kCap>;
  constexpr int kDevices = 64;
  static std::atomic<int> held[kDevices];   // 0: not yet queried
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kDevices) {
    *blocks = held[device].load(std::memory_order_relaxed);
    if (*blocks > 0) return cudaSuccess;
  }
  const auto kernel = gmm_wgmma_kernel<kAT, kBT, kBM, kCap>;
  int sms = 0, per_sm = 0;
  err = allow_dynamic_smem(kernel, L::kBytes);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, L::kThreads, L::kBytes);
  if (err != cudaSuccess) return err;
  *blocks = sms * per_sm;
  if (device < kDevices) held[device].store(*blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

// out[e] = A[e] B[e] on gmm_wgmma_kernel at one tile height, [M][N] per
// expert over K (A and B stored as kAT / kBT say), on `stream`: as many
// persistent blocks as the SMs hold at once, at most one a tile.
template <bool kAT, bool kBT, int kBM, int kCap = kWgMaxStages>
int wgmma_launch(const void* a, const void* b, void* out, int e, int m,
                 int n, int k, cudaStream_t stream) {
  using L = WgmmaTile<kBM, kCap>;
  CUtensorMap map_a, map_b, map_out;
  int rc = kAT ? tensor_map(&map_a, a, e, k, m, 64)
               : tensor_map(&map_a, a, e, m, k, kBM);
  if (rc == 0)
    rc = kBT ? tensor_map(&map_b, b, e, n, k, kWgBN)
             : tensor_map(&map_b, b, e, k, n, 64);
  if (rc == 0) rc = tensor_map(&map_out, out, e, m, n, L::kRows);
  if (rc != 0) return rc;
  int blocks = 0;
  const cudaError_t err = wgmma_blocks<kAT, kBT, kBM, kCap>(&blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto kernel = gmm_wgmma_kernel<kAT, kBT, kBM, kCap>;
  const long long tiles = static_cast<long long>(e) *
                          ((m + kBM - 1) / kBM) * ((n + kWgBN - 1) / kWgBN);
  const int grid = static_cast<int>(std::min<long long>(tiles, blocks));
  kernel<<<grid, L::kThreads, L::kBytes, stream>>>(map_a, map_b, map_out, m,
                                                   n, k, e);
  return static_cast<int>(cudaGetLastError());
}

// The tile height follows M: one m64 warpgroup at M <= 64, two of 64
// rows at M <= 128, two of 128 rows above (C = 240 in one tile: each
// weight tile is fetched once).
template <bool kAT, bool kBT>
int wgmma_product(const void* a, const void* b, void* out, int e, int m,
                  int n, int k, cudaStream_t stream) {
  if (m <= 64) return wgmma_launch<kAT, kBT, 64>(a, b, out, e, m, n, k, stream);
  if (m <= 128)
    return wgmma_launch<kAT, kBT, 128>(a, b, out, e, m, n, k, stream);
  return wgmma_launch<kAT, kBT, 256>(a, b, out, e, m, n, k, stream);
}

// K14's forward at C > 32 at the tile height (block_c) and ring stages the
// caller chose among the built instances, which ops.WGMMA_TILES mirrors:
// 64 rows at 4, 6 or 8 stages, 128 at 4 or 6, 256 at the 4 that fit.  The
// analytic pick is wgmma_product's rule at kWgMaxStages (64 and 128 rows:
// 6 stages; 256: 4).
static_assert(WgmmaTile<64, 4>::kStages == 4 && WgmmaTile<64>::kStages == 6 &&
                  WgmmaTile<64, 8>::kStages == 8 &&
                  WgmmaTile<128, 4>::kStages == 4 &&
                  WgmmaTile<128>::kStages == 6 && WgmmaTile<256>::kStages == 4,
              "the stage counts ops.WGMMA_TILES lists");
int wgmma_forward(const void* x, const void* w, void* out, int e, int c,
                  int f, int d, int block_c, int stages,
                  cudaStream_t stream) {
  if (block_c == 64) {
    if (stages == 4)
      return wgmma_launch<false, false, 64, 4>(x, w, out, e, c, f, d, stream);
    if (stages == 6)
      return wgmma_launch<false, false, 64>(x, w, out, e, c, f, d, stream);
    if (stages == 8)
      return wgmma_launch<false, false, 64, 8>(x, w, out, e, c, f, d, stream);
  } else if (block_c == 128) {
    if (stages == 4)
      return wgmma_launch<false, false, 128, 4>(x, w, out, e, c, f, d, stream);
    if (stages == 6)
      return wgmma_launch<false, false, 128>(x, w, out, e, c, f, d, stream);
  } else if (block_c == 256 && stages == WgmmaTile<256>::kStages) {
    return wgmma_launch<false, false, 256>(x, w, out, e, c, f, d, stream);
  }
  return kUnsupported;
}

// The kernel a call runs (the wrapper's shape rule picks it): the CUDA
// cores (f32, ragged bf16 decode shapes), gmm_mma_kernel (bf16 at C > 32
// that TMA cannot address, and K15's 1-byte weights there),
// gmm_stream_kernel (bf16 at C <= 32 with d a multiple of 8, f of 16 /
// sizeof(weight), aligned x and w) or gmm_wgmma_kernel (bf16 K14 at C > 32
// and K17 when every operand's rows are 16-byte multiples from 16-byte
// aligned bases).
enum GmmPath : int { kCudaCores = 0, kMmaPrefill = 1, kStream = 2,
                     kWgmma = 3 };

// block_c, block_f and stages: the tile the caller chose for the stream
// (block_f: kSF; block_c must be the 8 NT rows C takes; stages
// kStreamStages) and the wgmma path (block_c: kBM; stages: the ring's);
// the other paths have one tile each and take none.
struct GmmLaunch {
  const void *x, *w;
  const float* w_scale;   // null for K14
  void* out;
  int e, c, d, f, w_align, x_align, path, block_c, block_f, stages;
  cudaStream_t stream;

  template <typename W, int NT, int kSF>
  int stream_launch() const {
    using L = StreamSmem<W, NT, kSF>;
    const cudaError_t err =
        allow_dynamic_smem(gmm_stream_kernel<W, NT, kSF>, L::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    gmm_stream_kernel<W, NT, kSF><<<dim3((f + kSF - 1) / kSF, e), L::kThreads,
                                    L::kBytes, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const W*>(w),
        w_scale, static_cast<__nv_bfloat16*>(out), c, d, f);
    return static_cast<int>(cudaGetLastError());
  }

  // the stream kernel at the tile width the caller chose (block_f) and the
  // NT n-tiles C takes (block_c = 8 NT)
  template <typename W, int NT>
  int stream_width() const {
    if (block_c != 8 * NT || stages != kStreamStages) return kUnsupported;
    if (block_f == 64) return stream_launch<W, NT, 64>();
    if (block_f == 128) return stream_launch<W, NT, 128>();
    if (block_f == 256) return stream_launch<W, NT, 256>();
    return kUnsupported;
  }

  template <typename T, typename W, int RM, int KS>
  int launch() const {
    using Tl = Tile<RM, KS>;
    const dim3 grid((f + kBF - 1) / kBF, (c + Tl::kRows - 1) / Tl::kRows, e);
    const int vec = f % (16 / static_cast<int>(sizeof(W))) == 0 && w_align;
    gmm_kernel<T, W, RM, KS><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const W*>(w), w_scale,
        static_cast<T*>(out), c, d, f, vec);
    return static_cast<int>(cudaGetLastError());
  }

  template <typename T, typename W>
  int run() const {
    constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
    if (path == kWgmma) {
      if constexpr (kBf16 && std::is_same<W, __nv_bfloat16>::value) {
        if (!tma_ok(x, d) || !tma_ok(w, f) || !tma_ok(out, f) ||
            block_f != kWgBN)
          return kUnsupported;
        return wgmma_forward(x, w, out, e, c, f, d, block_c, stages, stream);
      }
      return kUnsupported;
    }
    if (path == kStream) {
      if constexpr (kBf16) {
        constexpr int kE = 16 / static_cast<int>(sizeof(W));
        if (c > 32 || d % 8 != 0 || f % kE != 0 || !w_align || !x_align)
          return kUnsupported;
        if (c <= 8) return stream_width<W, 1>();
        if (c <= 16) return stream_width<W, 2>();
        return stream_width<W, 4>();
      }
      return kUnsupported;
    }
    if (path != (kBf16 && c > 32 ? kMmaPrefill : kCudaCores))
      return kUnsupported;
    if constexpr (kBf16) {
      if (c > 32) {   // the tensor cores
        const dim3 grid((f + kBF - 1) / kBF, (c + 63) / 64, e);
        const int wvec = f % (16 / static_cast<int>(sizeof(W))) == 0 && w_align;
        const int xvec = d % 8 == 0 && x_align;
        gmm_mma_kernel<W><<<grid, kThreads, 0, stream>>>(
            static_cast<const __nv_bfloat16*>(x), static_cast<const W*>(w),
            w_scale, static_cast<__nv_bfloat16*>(out), c, d, f, xvec, wvec);
        return static_cast<int>(cudaGetLastError());
      }
    }
    if (c <= 8) return launch<T, W, 8, 16>();
    if (c <= 32) return launch<T, W, 8, 4>();
    return launch<T, W, 4, 1>();
  }
};

// K17: dx = dy w^T ([E, C, f] x [E, d, f] -> [E, C, d]), then dw = x^T dy
// ([E, C, d] x [E, C, f] -> [E, d, f]), two launches on `stream`; bf16 on
// gmm_wgmma_kernel (path kWgmma: d and f multiples of 8, every operand
// 16-byte aligned) or gmm_bwd_mma_kernel (path kMmaPrefill), f32 on
// gmm_bwd_f32_kernel (path kCudaCores).
struct GmmBwdLaunch {
  const void *x, *w, *dy;
  void *dx, *dw;
  int e, c, d, f, path;
  cudaStream_t stream;

  static int aligned(const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  }

  // out[M][N] = A B per expert on the tensor cores (see gmm_bwd_mma_kernel)
  template <bool kAT, bool kBT>
  int mma(const void* a, const void* b, void* out, int m, int n, int k,
          int avec, int bvec) const {
    const size_t smem = BwdSmem<kAT, kBT>::kBytes;
    const cudaError_t err =
        allow_dynamic_smem(gmm_bwd_mma_kernel<kAT, kBT>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    gmm_bwd_mma_kernel<kAT, kBT>
        <<<dim3((n + kBwdTile - 1) / kBwdTile, (m + kBwdTile - 1) / kBwdTile,
                e),
           kThreads, smem, stream>>>(
            static_cast<const bf16*>(a), static_cast<const bf16*>(b),
            static_cast<bf16*>(out), m, n, k, avec, bvec,
            n % 8 == 0 && aligned(out));
    return static_cast<int>(cudaGetLastError());
  }

  int tensor_cores() const {   // bf16
    if (path == kWgmma) {
      if (!tma_ok(x, d) || !tma_ok(w, f) || !tma_ok(dy, f) ||
          !tma_ok(dx, d) || !tma_ok(dw, f))
        return kUnsupported;
      const int rc = wgmma_product<false, true>(dy, w, dx, e, c, d, f, stream);
      if (rc != 0) return rc;
      return wgmma_product<true, false>(x, dy, dw, e, d, f, c, stream);
    }
    if (path != kMmaPrefill) return kUnsupported;
    const int fvec = f % 8 == 0, dvec = d % 8 == 0;
    const int rc = mma<false, true>(dy, w, dx, c, d, f, fvec && aligned(dy),
                                    fvec && aligned(w));
    if (rc != 0) return rc;
    return mma<true, false>(x, dy, dw, d, f, c, dvec && aligned(x),
                            fvec && aligned(dy));
  }

  int cuda_cores() const {     // f32
    if (path != kCudaCores) return kUnsupported;
    const float *xf = static_cast<const float*>(x),
                *wf = static_cast<const float*>(w),
                *dyf = static_cast<const float*>(dy);
    gmm_bwd_f32_kernel<false, true>
        <<<dim3((d + 63) / 64, (c + 63) / 64, e), kThreads, 0, stream>>>(
            dyf, wf, static_cast<float*>(dx), c, d, f);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    gmm_bwd_f32_kernel<true, false>
        <<<dim3((f + 63) / 64, (d + 63) / 64, e), kThreads, 0, stream>>>(
            xf, dyf, static_cast<float*>(dw), d, f, c);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace
}  // namespace repro

// K14.  x [E, C, d], w [E, d, f], out [E, C, f], all of dtype `dtype`
// (f32 or bf16), contiguous; `path` a GmmPath (the wrapper's shape rule):
// a path this call cannot take is unsupported; block_c, block_f and
// stages the tile of the stream or wgmma path (GmmLaunch), one the library
// has not built unsupported.
extern "C" int moe_gmm(const void* x, const void* w, void* out, int e, int c,
                       int d, int f, int dtype, int path, int block_c,
                       int block_f, int stages, void* stream) {
  if (e <= 0 || c <= 0 || f <= 0 || e > 65535) return repro::kUnsupported;
  const repro::GmmLaunch launch{
      x, w, nullptr, out, e, c, d, f,
      reinterpret_cast<uintptr_t>(w) % 16 == 0,
      reinterpret_cast<uintptr_t>(x) % 16 == 0, path, block_c, block_f,
      stages, static_cast<cudaStream_t>(stream)};
  if (dtype == repro::kFloat32) return launch.run<float, float>();
  if (dtype == repro::kBFloat16)
    return launch.run<__nv_bfloat16, __nv_bfloat16>();
  return repro::kUnsupported;
}

// K15.  K14 with w_q [E, d, f] of storage dtype `store` (int8 or fp8
// e4m3) and w_scale [E, 1, f] f32; x and out of dtype `dtype`; `path` and
// the tile as for K14 (at C > 32 K15 runs gmm_mma_kernel's one tile).
extern "C" int moe_gmm_quantized(const void* x, const void* w_q,
                                 const void* w_scale, void* out, int e, int c,
                                 int d, int f, int dtype, int store, int path,
                                 int block_c, int block_f, int stages,
                                 void* stream) {
  if (e <= 0 || c <= 0 || f <= 0 || e > 65535) return repro::kUnsupported;
  const repro::GmmLaunch launch{
      x, w_q, static_cast<const float*>(w_scale), out, e, c, d, f,
      reinterpret_cast<uintptr_t>(w_q) % 16 == 0,
      reinterpret_cast<uintptr_t>(x) % 16 == 0, path, block_c, block_f,
      stages, static_cast<cudaStream_t>(stream)};
  if (dtype == repro::kFloat32) {
    if (store == repro::kInt8) return launch.run<float, int8_t>();
    if (store == repro::kFloat8E4M3) return launch.run<float, __nv_fp8_e4m3>();
  } else if (dtype == repro::kBFloat16) {
    if (store == repro::kInt8) return launch.run<__nv_bfloat16, int8_t>();
    if (store == repro::kFloat8E4M3)
      return launch.run<__nv_bfloat16, __nv_fp8_e4m3>();
  }
  return repro::kUnsupported;
}

// K17.  x [E, C, d], w [E, d, f], dy [E, C, f] (the gradient of K14's
// out), dx [E, C, d] and dw [E, d, f], all of dtype `dtype` (f32 or bf16),
// contiguous; `path` as the wrapper's rule names it (bf16: kWgmma or
// kMmaPrefill, f32: kCudaCores).
extern "C" int moe_gmm_bwd(const void* x, const void* w, const void* dy,
                           void* dx, void* dw, int e, int c, int d, int f,
                           int dtype, int path, void* stream) {
  const long long per_expert = static_cast<long long>(d) * std::max(c, f);
  if (e <= 0 || c <= 0 || d <= 0 || f <= 0 || e > 65535 ||
      (c + 63) / 64 > 65535 || (d + 63) / 64 > 65535 ||
      std::max(per_expert, static_cast<long long>(c) * f) >= (1LL << 31))
    return repro::kUnsupported;
  const repro::GmmBwdLaunch launch{x, w, dy, dx, dw, e, c, d, f, path,
                                   static_cast<cudaStream_t>(stream)};
  if (dtype == repro::kFloat32) return launch.cuda_cores();
  if (dtype == repro::kBFloat16) return launch.tensor_cores();
  return repro::kUnsupported;
}

// The tiles K14 and K15 take on the two paths with a choice, as rows of
// five ints (path, block_c, block_f, block_d, stages), into out (at most
// `max` rows); returns the row count.  The stream path's block_c is the 8
// NT rows a C of up to 8, 16 or 32 takes.  ops.tile_options lists the same.
extern "C" int moe_gmm_tiles(int* out, int max) {
  using repro::WgmmaTile;
  const int wgmma[][2] = {{64, 4}, {64, 6}, {64, 8},
                          {128, 4}, {128, 6}, {256, WgmmaTile<256>::kStages}};
  int n = 0;
  const auto row = [&](int path, int bc, int bf, int bd, int stages) {
    if (n < max) {
      int* r = out + 5 * n;
      r[0] = path;
      r[1] = bc;
      r[2] = bf;
      r[3] = bd;
      r[4] = stages;
    }
    ++n;
  };
  for (const auto& t : wgmma)
    row(repro::kWgmma, t[0], repro::kWgBN, repro::kWgBK, t[1]);
  for (int nt : {1, 2, 4})
    for (int bf : {64, 128, 256})
      row(repro::kStream, 8 * nt, bf, repro::kSD, repro::kStreamStages);
  return n;
}

extern "C" const char* repro_error_string(int code) {
  return repro::error_string(code);
}
