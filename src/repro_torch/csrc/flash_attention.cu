// K1: flash-attention forward (causal GQA, online softmax) for Hopper.
//
// Replaces the Pallas kernel flash_attention_fwd / _fa_kernel in
// src/repro/kernels/flash_attention/kernel.py.  On the TPU the grid is
// (B, Hq, Sq/bq, Skv/bk) with the KV axis run in order, carrying m, l and
// the accumulator in VMEM scratch from one grid step to the next.
//
// What bounds it on the H100: at the serve path's prefill shapes (one
// request, Sq <= 512 queries, Hq = 16, D = 128) the causal work is about
// 1 GFLOP per layer against a few MB of Q, K, V and O.  With tensor cores
// that is bound by bytes; this first version runs both products on the
// CUDA cores in f32, so arithmetic and shared-memory traffic bound it.
//
// Design: one block of 128 threads per (16-query tile, query head, batch
// row).  The TPU's sequential KV grid axis becomes a loop inside the block
// over 32-row KV tiles staged in shared memory as f32; m, l and the
// [16, D] accumulator stay on chip for the whole loop, so only O and lse
// are written to device memory.  The loop ends at the last KV row any
// query of the tile can see (causal diagonal and kv_len), so the max_len
// cache behind a short prefill is never read.  Each warp owns 4 query
// rows: lane j scores KV row j of the tile, row max and row sum are warp
// shuffles, and in the P.V product lanes walk consecutive head-dim
// columns.  Unlike the Pallas kernel, the query alignment (q_offset) and
// the valid KV length (kv_len, scalar or per row) are arguments.
//
// K10 replaces flash_attention_fwd_quantized / _fa_quant_kernel (same
// file): K1 over int8 or fp8 e4m3 K/V with one f16 scale per (cache row,
// KV head).  It is K1's kernel with the other value format (kQuantized<T,
// S>, common.cuh): the tile's values are read four to a 32-bit load and
// converted to f32 in shared memory, its 32 k- and v-scales loaded once
// beside them (requested before the values); the k-scale
// multiplies each score column after q.k and before 1/sqrt(D), the
// v-scale multiplies p only inside the p.v product, and l sums the
// unscaled p.  It keeps K1's kv_len and q_offset, which the Pallas K10
// lacks (it aligns the queries at Skv - Sq).
//
// K11 replaces flash_attention_bwd (same file; _fa_bwd_dq_kernel and
// _fa_bwd_dkv_kernel): the flash backward with recompute from lse, for
// every KV row valid and the suffix alignment Skv - Sq (causal or not).
// With qs = q / sqrt(D): dd = rowsum(do * out), p = exp(qs.k - lse)
// (exactly 0 where masked, so a row that sees no KV row adds nothing),
// ds = p * (do.v - dd); dv = p^T do, dk = ds^T qs, dq = ds k / sqrt(D).
//
// What bounds it on the H100: five products of 2 * S^2 * D / 2 flops per
// head under the causal mask (about 21.5 GFLOP at B=2, S=1024, Hq=16,
// D=128) against about 40 MB of inputs and outputs: operations, by far,
// even at the tensor cores' rate.  This first version runs the products
// on the CUDA cores in f32, as K1 does; tensor cores are later work.
//
// Design.  The TPU kernels carry their sums across a sequential grid axis
// in VMEM scratch; here each sum is a loop inside one block and nothing
// crosses blocks, so the gradients are the same from run to run (no
// atomics):
//   1. dq: one block of 128 threads per (16-query tile, q-head, batch
//      row), K1's layout.  It stages q / sqrt(D) and do, computes the
//      tile's dd (fused: written to f32 scratch for step 2), then loops
//      over 32-row KV tiles in order up to the causal limit: lane j scores
//      KV row j for its warp's 4 query rows (s and do.v), and the warp
//      adds ds . k into its [4, D] accumulator in registers (lane l holds
//      columns l, l + 32, ...).
//   2. dk/dv: one block per (32-row KV tile, q-head, batch row), holding
//      its K and V tile in shared memory and the [32, D] dk and dv sums
//      in registers, looping over 16-query tiles from the first one the
//      causal mask lets see the tile.  A (KV tile, q-head) block keeps the
//      grid at B * Hq * Skv / 32 blocks (1,024 at the training shape, for
//      132 SMs) where a block per KV head would give 64.
//   3. GQA: step 2 writes per-q-head partials to f32 scratch [B, Skv, Hq,
//      D]; a small kernel sums each group of G q-heads in f32 and rounds
//      once to k's dtype.  (The Pallas op rounds each partial to k's
//      dtype before its sum: in bf16 the two differ by about one bf16
//      ulp of the gradient.)
// Tiles are staged as f32 in dynamic shared memory (about 52 KB at D =
// 128, above the 48 KB static limit); ragged edges are masked, no length
// needs to divide a tile.

#include "common.cuh"

#include <algorithm>

namespace repro {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 16;                    // query rows per block
constexpr int kBK = 32;                    // KV rows per tile: one per lane
constexpr int kRowsPerWarp = kBQ / kWarps;

// T: the query's dtype; S: the K/V storage dtype (T itself, or int8_t /
// __nv_fp8_e4m3 with the f16 scales k_scale / v_scale, null otherwise).
template <typename T, typename S, int D>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const T* __restrict__ q, const S* __restrict__ k,
              const S* __restrict__ v, const __half* __restrict__ k_scale,
              const __half* __restrict__ v_scale, T* __restrict__ out,
              float* __restrict__ lse, const int* __restrict__ kv_len_rows,
              int kv_len_all, int sq, int skv, int hq, int hkv, int q_offset,
              int causal) {
  constexpr bool kQuant = kQuantized<T, S>;
  constexpr int kAcc = kRowsPerWarp * D / 32;   // accumulator slots per lane
  // K rows are padded so that lane j's reads of row j are conflict-free:
  // +1 for the float kernels' column reads; +4 keeps the quantized
  // kernels' float4 reads conflict-free and 16-byte aligned
  constexpr int kKStride = kQuant ? D + 4 : D + 1;
  __shared__ __align__(16) float qs[kBQ][D];
  __shared__ __align__(16) float ks[kBK][kKStride];
  __shared__ __align__(16) float vs[kBK][D];
  __shared__ float ps[kBQ][kBK];
  __shared__ float cs[kBQ];           // per-row rescale of the accumulator
  __shared__ float ls[kBQ];           // final per-row softmax denominators
  __shared__ float ksc[kBK], vsc[kBK];   // the tile's scales (quantized)

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const float sqrt_d = sqrtf(static_cast<float>(D));

  int kvl = kv_len_rows != nullptr ? kv_len_rows[b] : kv_len_all;
  kvl = max(0, min(kvl, skv));
  // exclusive end of the KV rows any query of this tile can see
  int kv_end = kvl;
  if (causal) kv_end = min(kv_end, max(0, q_offset + min(q0 + kBQ, sq)));

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D, qi = q0 + r;
    float qx = 0.f;
    if (qi < sq) {
      qx = to_float(q[(static_cast<size_t>(b) * sq + qi) * hq * D +
                      static_cast<size_t>(h) * D + c]);
      if (!kQuant) qx = qx / sqrt_d;   // quantized: 1/sqrt(D) after ks
    }
    qs[r][c] = qx;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kAcc];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();   // the previous tile is consumed; qs is written
    // this tile's scales, loaded before the values so that their latency
    // overlaps the value loads
    float k_sc = 0.f, v_sc = 0.f;
    if constexpr (kQuant) {
      if (tid < kBK && k0 + tid < kv_end) {
        const size_t off =
            (static_cast<size_t>(b) * skv + k0 + tid) * hkv + hk;
        k_sc = to_float(k_scale[off]);
        v_sc = to_float(v_scale[off]);
      }
    }
    if constexpr (kQuant) {
      // one 32-bit word (four 1-byte values) per load: a row's D bytes
      // are whole, 4-byte aligned words (D % 16 == 0; the wrapper checks
      // the base pointers)
      constexpr int kWords = D / 4;
      for (int i = tid; i < kBK * kWords; i += kThreads) {
        const int r = i / kWords, c = (i % kWords) * 4, kr = k0 + r;
        float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
        if (kr < kv_end) {
          const size_t off = (static_cast<size_t>(b) * skv + kr) * hkv * D +
                             static_cast<size_t>(hk) * D + c;
          kx = word_to_float4<S>(*reinterpret_cast<const uint32_t*>(k + off));
          vx = word_to_float4<S>(*reinterpret_cast<const uint32_t*>(v + off));
        }
        *reinterpret_cast<float4*>(&ks[r][c]) = kx;
        *reinterpret_cast<float4*>(&vs[r][c]) = vx;
      }
    } else {
      for (int i = tid; i < kBK * D; i += kThreads) {
        const int r = i / D, c = i % D, kr = k0 + r;
        float kx = 0.f, vx = 0.f;
        if (kr < kv_end) {
          const size_t off = (static_cast<size_t>(b) * skv + kr) * hkv * D +
                             static_cast<size_t>(hk) * D + c;
          kx = to_float(k[off]);
          vx = to_float(v[off]);
        }
        ks[r][c] = kx;
        vs[r][c] = vx;
      }
    }
    if constexpr (kQuant) {
      if (tid < kBK) {
        ksc[tid] = k_sc;
        vsc[tid] = v_sc;
      }
    }
    __syncthreads();

    const int kpos = k0 + lane;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      float s = 0.f;
      if constexpr (kQuant) {
        s = dot4<D>(qs[r], ks[lane]) * ksc[lane] / sqrt_d;
      } else {
#pragma unroll 8
        for (int c = 0; c < D; ++c) s += qs[r][c] * ks[lane][c];
      }
      const bool ok = kpos < kvl && (!causal || kpos <= q_offset + q0 + r);
      s = ok ? s : kNegInf;
      const float m_new = fmaxf(m[rr], warp_max(s));
      const float p = ok ? expf(s - m_new) : 0.f;
      const float corr = expf(m[rr] - m_new);
      l[rr] = l[rr] * corr + warp_sum(p);   // l sums the unscaled p
      m[rr] = m_new;
      ps[r][lane] = kQuant ? p * vsc[lane] : p;
      if (lane == 0) cs[r] = corr;
    }
    __syncwarp();

#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int idx = lane + 32 * j;
      const int r = warp * kRowsPerWarp + idx / D;
      const int c = idx % D;
      float a = acc[j] * cs[r];
#pragma unroll 8
      for (int t = 0; t < kBK; ++t) a += ps[r][t] * vs[t][c];
      acc[j] = a;
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const float lr = fmaxf(l[rr], 1e-30f);
      ls[r] = lr;
      if (q0 + r < sq)
        lse[(static_cast<size_t>(b) * hq + h) * sq + q0 + r] = m[rr] + logf(lr);
    }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int idx = lane + 32 * j;
    const int r = warp * kRowsPerWarp + idx / D;
    const int c = idx % D;
    const int qi = q0 + r;
    if (qi < sq)
      out[(static_cast<size_t>(b) * sq + qi) * hq * D +
          static_cast<size_t>(h) * D + c] = from_float<T>(acc[j] / ls[r]);
  }
}

struct FaLaunch {
  const void *q, *k, *v, *k_scale, *v_scale;   // scales null for float K/V
  void *out, *lse;
  const int* kv_len_rows;
  int kv_len_all, b, sq, skv, hq, hkv, q_offset, causal;
  cudaStream_t stream;

  template <typename T, typename S, int D>
  int run() const {
    const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
    fa_fwd_kernel<T, S, D><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const S*>(k),
        static_cast<const S*>(v), static_cast<const __half*>(k_scale),
        static_cast<const __half*>(v_scale), static_cast<T*>(out),
        static_cast<float*>(lse), kv_len_rows, kv_len_all, sq, skv, hq, hkv,
        q_offset, causal);
    return static_cast<int>(cudaGetLastError());
  }
};

// ---------------------------------------------------------------- K11

// Shared memory of the two backward kernels, in floats: two [kBQ][D]
// query-side tiles (q / sqrt(D), do), two [kBK][D + 1] KV tiles (k, v;
// +1 keeps lane j's reads of row j conflict-free), two [kBQ][kBK] score
// tiles and the query tile's lse and dd.
template <int D>
constexpr size_t bwd_smem_floats() {
  return 2 * kBQ * D + 2 * kBK * (D + 1) + 2 * kBQ * kBK + 2 * kBQ;
}

// Stage a [kBQ][D] tile of q / sqrt(D) and of do (zero past sq).
template <typename T, int D>
__device__ __forceinline__ void stage_q_tile(const T* __restrict__ q,
                                             const T* __restrict__ dout,
                                             float* qs, float* dos, int b,
                                             int q0, int h, int sq, int hq) {
  const float sqrt_d = sqrtf(static_cast<float>(D));
  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D, qi = q0 + r;
    float qx = 0.f, dx = 0.f;
    if (qi < sq) {
      const size_t off = (static_cast<size_t>(b) * sq + qi) * hq * D +
                         static_cast<size_t>(h) * D + c;
      qx = to_float(q[off]) / sqrt_d;
      dx = to_float(dout[off]);
    }
    qs[i] = qx;
    dos[i] = dx;
  }
}

// Stage a [kBK][D + 1] tile of k and of v, rows k0.. of KV head hk (zero
// from row `end` on).
template <typename T, int D>
__device__ __forceinline__ void stage_kv_tile(const T* __restrict__ k,
                                              const T* __restrict__ v,
                                              float* ks, float* vs, int b,
                                              int k0, int hk, int end,
                                              int skv, int hkv) {
  for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
    const int r = i / D, c = i % D, kr = k0 + r;
    float kx = 0.f, vx = 0.f;
    if (kr < end) {
      const size_t off = (static_cast<size_t>(b) * skv + kr) * hkv * D +
                         static_cast<size_t>(hk) * D + c;
      kx = to_float(k[off]);
      vx = to_float(v[off]);
    }
    ks[r * (D + 1) + c] = kx;
    vs[r * (D + 1) + c] = vx;
  }
}

// Lane `lane` scores KV row `lane` of the staged tile against the warp's
// kRowsPerWarp query rows r0.. of the staged query tile: s = qs.k and
// dp = do.v over D columns, each KV value read once for all the rows.
template <int D>
__device__ __forceinline__ void score_rows(const float* qs, const float* dos,
                                           const float* ks, const float* vs,
                                           int r0, int lane,
                                           float (&s)[kRowsPerWarp],
                                           float (&dp)[kRowsPerWarp]) {
  const float* kr = ks + lane * (D + 1);
  const float* vr = vs + lane * (D + 1);
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) s[rr] = dp[rr] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    const float kc = kr[c], vc = vr[c];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      s[rr] += qs[(r0 + rr) * D + c] * kc;
      dp[rr] += dos[(r0 + rr) * D + c] * vc;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ out,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 float* __restrict__ dd, T* __restrict__ dq, int sq, int skv,
                 int hq, int hkv, int causal) {
  // lane `lane` accumulates columns lane + 32 cc of the warp's rows (at
  // D = 16 the upper half of the warp has no column)
  constexpr int kCols = (D + 31) / 32;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kBQ * D;
  float* ks = dos + kBQ * D;
  float* vs = ks + kBK * (D + 1);
  float* dss = vs + kBK * (D + 1);              // [kBQ][kBK]: p (dp - dd)
  float* lse_s = dss + 2 * kBQ * kBK;
  float* dd_s = lse_s + kBQ;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int offset = skv - sq;                  // suffix alignment

  stage_q_tile<T, D>(q, dout, qs, dos, b, q0, h, sq, hq);
  __syncthreads();
  // dd = rowsum(do * out) for the warp's own rows, kept for step 2
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr, qi = q0 + r;
    float part = 0.f;
    if (qi < sq) {
      const size_t base = (static_cast<size_t>(b) * sq + qi) * hq * D +
                          static_cast<size_t>(h) * D;
      for (int c = lane; c < D; c += 32)
        part += dos[r * D + c] * to_float(out[base + c]);
    }
    part = warp_sum(part);
    if (lane == 0) {
      const size_t row = (static_cast<size_t>(b) * hq + h) * sq + qi;
      dd_s[r] = part;
      lse_s[r] = qi < sq ? lse[row] : 0.f;
      if (qi < sq) dd[row] = part;
    }
  }
  __syncwarp();

  // exclusive end of the KV rows any query of this tile can see
  int kv_end = skv;
  if (causal) kv_end = min(skv, max(0, offset + min(q0 + kBQ, sq)));

  const int r0 = warp * kRowsPerWarp;
  float acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) acc[rr][cc] = 0.f;

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();   // the previous tile is consumed
    stage_kv_tile<T, D>(k, v, ks, vs, b, k0, hk, kv_end, skv, hkv);
    __syncthreads();
    const int kpos = k0 + lane;
    float s[kRowsPerWarp], dp[kRowsPerWarp];
    score_rows<D>(qs, dos, ks, vs, r0, lane, s, dp);
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = r0 + rr, qi = q0 + r;
      const bool ok =
          qi < sq && kpos < kv_end && (!causal || kpos <= offset + qi);
      const float p = ok ? expf(s[rr] - lse_s[r]) : 0.f;
      dss[r * kBK + lane] = p * (dp[rr] - dd_s[r]);
    }
    __syncwarp();
    // dq[r, c] += sum_t ds[r, t] k[t, c], over the tile's rows in order
#pragma unroll 4
    for (int t = 0; t < kBK; ++t) {
      float kx[kCols];
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc)
        kx[cc] = ks[t * (D + 1) + min(lane + 32 * cc, D - 1)];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float d = dss[(r0 + rr) * kBK + t];
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) acc[rr][cc] += d * kx[cc];
      }
    }
  }

  const float sqrt_d = sqrtf(static_cast<float>(D));
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int qi = q0 + r0 + rr;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      const int c = lane + 32 * cc;
      if (qi < sq && c < D)
        dq[(static_cast<size_t>(b) * sq + qi) * hq * D +
           static_cast<size_t>(h) * D + c] = from_float<T>(acc[rr][cc] / sqrt_d);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ dd, float* __restrict__ dk_part,
                  float* __restrict__ dv_part, int sq, int skv, int hq,
                  int hkv, int causal) {
  constexpr int kAcc = kBK * D / kThreads;      // (row, column) per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kBQ * D;
  float* ks = dos + kBQ * D;
  float* vs = ks + kBK * (D + 1);
  float* ps = vs + kBK * (D + 1);               // [kBQ][kBK]: p
  float* dss = ps + kBQ * kBK;                  // [kBQ][kBK]: p (dp - dd)
  float* lse_s = dss + kBQ * kBK;
  float* dd_s = lse_s + kBQ;

  const int k0 = blockIdx.x * kBK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int offset = skv - sq;

  stage_kv_tile<T, D>(k, v, ks, vs, b, k0, hk, skv, skv, hkv);
  // the first query that sees KV row k0 is k0 - offset
  int q_begin = 0;
  if (causal) q_begin = max(0, k0 - offset) / kBQ * kBQ;

  float dk_acc[kAcc], dv_acc[kAcc];
#pragma unroll
  for (int m = 0; m < kAcc; ++m) {
    dk_acc[m] = 0.f;
    dv_acc[m] = 0.f;
  }

  const int kpos = k0 + lane;
  // slot m of a thread holds KV row j0 + m * kJStep, column c (D divides
  // the 128 threads' span)
  constexpr int kJStep = kThreads / D;
  const int c = tid % D, j0 = tid / D;
  for (int q0 = q_begin; q0 < sq; q0 += kBQ) {
    __syncthreads();   // the previous query tile is consumed
    stage_q_tile<T, D>(q, dout, qs, dos, b, q0, h, sq, hq);
    if (tid < kBQ) {
      const int qi = q0 + tid;
      const size_t row = (static_cast<size_t>(b) * hq + h) * sq + qi;
      lse_s[tid] = qi < sq ? lse[row] : 0.f;
      dd_s[tid] = qi < sq ? dd[row] : 0.f;
    }
    __syncthreads();
    float s[kRowsPerWarp], dp[kRowsPerWarp];
    score_rows<D>(qs, dos, ks, vs, warp * kRowsPerWarp, lane, s, dp);
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr, qi = q0 + r;
      const bool ok =
          qi < sq && kpos < skv && (!causal || kpos <= offset + qi);
      const float p = ok ? expf(s[rr] - lse_s[r]) : 0.f;
      ps[r * kBK + lane] = p;
      dss[r * kBK + lane] = p * (dp[rr] - dd_s[r]);
    }
    __syncthreads();   // every warp's rows of p and ds are written
    // dv[j, c] += sum_i p[i, j] do[i, c]; dk[j, c] += sum_i ds[i, j] qs[i, c]
#pragma unroll 4
    for (int i = 0; i < kBQ; ++i) {
      const float dx = dos[i * D + c], qx = qs[i * D + c];
#pragma unroll
      for (int m = 0; m < kAcc; ++m) {
        const int j = j0 + m * kJStep;
        dv_acc[m] += ps[i * kBK + j] * dx;
        dk_acc[m] += dss[i * kBK + j] * qx;
      }
    }
  }

#pragma unroll
  for (int m = 0; m < kAcc; ++m) {
    const int j = j0 + m * kJStep, kr = k0 + j;
    if (kr < skv) {
      const size_t off = (static_cast<size_t>(b) * skv + kr) * hq * D +
                         static_cast<size_t>(h) * D + c;
      dk_part[off] = dk_acc[m];
      dv_part[off] = dv_acc[m];
    }
  }
}

// dk[b, s, hk, c] = sum over the group's q-heads of the f32 partials
// [b, s, hk * g + i, c], in order i = 0 .. g - 1, rounded once; dv alike.
template <typename T>
__global__ void fa_bwd_group_sum_kernel(const float* __restrict__ dk_part,
                                        const float* __restrict__ dv_part,
                                        T* __restrict__ dk,
                                        T* __restrict__ dv, size_t n,
                                        int hkv, int g, int d) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t c = i % d, rest = i / d;
    const size_t hk = rest % hkv, row = rest / hkv;
    const size_t base = (row * hkv * g + hk * g) * d + c;
    float sk = 0.f, sv = 0.f;
    for (int j = 0; j < g; ++j) {
      sk += dk_part[base + static_cast<size_t>(j) * d];
      sv += dv_part[base + static_cast<size_t>(j) * d];
    }
    dk[i] = from_float<T>(sk);
    dv[i] = from_float<T>(sv);
  }
}

struct FaBwdLaunch {
  const void *q, *k, *v, *out, *dout, *lse;
  void *dq, *dk, *dv, *dd, *dk_part, *dv_part;
  int b, sq, skv, hq, hkv, causal;
  cudaStream_t stream;

  template <typename T, typename S, int D>
  int run() const {
    static_assert(std::is_same<T, S>::value, "K11 takes float K/V only");
    const int smem = static_cast<int>(bwd_smem_floats<D>() * sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(
        fa_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fa_bwd_dkv_kernel<T, D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const T* qt = static_cast<const T*>(q);
    const T* kt = static_cast<const T*>(k);
    const T* vt = static_cast<const T*>(v);
    const T* dot = static_cast<const T*>(dout);
    fa_bwd_dq_kernel<T, D>
        <<<dim3((sq + kBQ - 1) / kBQ, hq, b), kThreads, smem, stream>>>(
            qt, kt, vt, static_cast<const T*>(out), dot,
            static_cast<const float*>(lse), static_cast<float*>(dd),
            static_cast<T*>(dq), sq, skv, hq, hkv, causal);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    fa_bwd_dkv_kernel<T, D>
        <<<dim3((skv + kBK - 1) / kBK, hq, b), kThreads, smem, stream>>>(
            qt, kt, vt, dot, static_cast<const float*>(lse),
            static_cast<const float*>(dd), static_cast<float*>(dk_part),
            static_cast<float*>(dv_part), sq, skv, hq, hkv, causal);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const size_t n = static_cast<size_t>(b) * skv * hkv * D;
    const int blocks = static_cast<int>(
        std::min<size_t>((n + 255) / 256, 132 * 16));
    fa_bwd_group_sum_kernel<T><<<blocks, 256, 0, stream>>>(
        static_cast<const float*>(dk_part), static_cast<const float*>(dv_part),
        static_cast<T*>(dk), static_cast<T*>(dv), n, hkv, hq / hkv, D);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace
}  // namespace repro

// q [B, Sq, Hq, D], k and v [B, Skv, Hkv, D], out [B, Sq, Hq, D] (all of
// dtype `dtype`, contiguous); lse [B, Hq, Sq] f32.  kv_len_rows is a device
// int32 [B] or null, in which case kv_len_all applies to every row.  Query
// i sits at absolute position q_offset + i.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, void* lse,
                                   const void* kv_len_rows, int kv_len_all,
                                   int b, int sq, int skv, int hq, int hkv,
                                   int d, int q_offset, int causal, int dtype,
                                   void* stream) {
  if (hkv <= 0 || hq % hkv != 0) return repro::kUnsupported;
  const repro::FaLaunch launch{
      q, k, v, nullptr, nullptr, out, lse,
      static_cast<const int*>(kv_len_rows), kv_len_all, b, sq, skv, hq, hkv,
      q_offset, causal, static_cast<cudaStream_t>(stream)};
  return repro::dispatch_dtype_dim(dtype, d, launch);
}

// K10.  K1 over a quantized cache: k and v [B, Skv, Hkv, D] of storage
// dtype `store` (int8 or fp8 e4m3), k_scale and v_scale [B, Skv, Hkv, 1]
// f16; q and out of dtype `dtype`.  Everything else as for K1.
extern "C" int flash_attention_fwd_quantized(
    const void* q, const void* k, const void* k_scale, const void* v,
    const void* v_scale, void* out, void* lse, const void* kv_len_rows,
    int kv_len_all, int b, int sq, int skv, int hq, int hkv, int d,
    int q_offset, int causal, int dtype, int store, void* stream) {
  if (hkv <= 0 || hq % hkv != 0) return repro::kUnsupported;
  const repro::FaLaunch launch{
      q, k, v, k_scale, v_scale, out, lse,
      static_cast<const int*>(kv_len_rows), kv_len_all, b, sq, skv, hq, hkv,
      q_offset, causal, static_cast<cudaStream_t>(stream)};
  return repro::dispatch_quant(dtype, store, d, launch);
}

// K11.  q, out, dout and dq [B, Sq, Hq, D]; k, v, dk and dv [B, Skv,
// Hkv, D] (all of dtype `dtype`, contiguous); lse [B, Hq, Sq] f32 from K1
// with every KV row valid and query i at position Skv - Sq + i.  Scratch
// the caller allocates: dd [B, Hq, Sq] f32, dk_part and dv_part [B, Skv,
// Hq, D] f32.  Three launches on `stream`: dq (and dd), dk/dv partials,
// the GQA group sum.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* dout, const void* lse,
                                   void* dq, void* dk, void* dv, void* dd,
                                   void* dk_part, void* dv_part, int b,
                                   int sq, int skv, int hq, int hkv, int d,
                                   int causal, int dtype, void* stream) {
  if (hkv <= 0 || hq % hkv != 0) return repro::kUnsupported;
  const repro::FaBwdLaunch launch{
      q, k, v, out, dout, lse, dq, dk, dv, dd, dk_part, dv_part,
      b, sq, skv, hq, hkv, causal, static_cast<cudaStream_t>(stream)};
  return repro::dispatch_dtype_dim(dtype, d, launch);
}

extern "C" const char* repro_error_string(int code) {
  return repro::error_string(code);
}
