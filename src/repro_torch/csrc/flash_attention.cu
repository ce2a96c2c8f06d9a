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

#include "common.cuh"

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

extern "C" const char* repro_error_string(int code) {
  return repro::error_string(code);
}
