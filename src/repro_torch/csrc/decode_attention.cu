// K2 and K3: split-K flash-decode (one query token per row, GQA) for
// Hopper, over a contiguous cache (K2) or a shared page pool (K3).
//
// K2 replaces the Pallas kernel decode_attention_fwd / _decode_kernel in
// src/repro/kernels/decode_attention/kernel.py, with its partial-softmax
// combine (kernel.py:117-122).  On the TPU the grid is (B, Hkv, splits);
// each step loads the G = Hq/Hkv query heads of one KV head as a [G, D]
// tile, reads kv_len by scalar prefetch and writes partials (o, m, l).
//
// K3 replaces paged_decode_attention_fwd / _paged_decode_kernel (same
// file), whose grid walks one logical page per step and DMAs the physical
// page the scalar-prefetched page table names; its combine (kernel.py:
// 477-482) is K2's.  A page (16 rows x 128 dims, 4 KB per KV head in bf16)
// is far too little work for a block on the H100, so K3 is not one block
// per page: it is K2's split kernel with another address policy for a
// cache row.  ContiguousRows addresses row kr of batch row b at
// b * S + kr; PagedRows at pt[b, kr / ps] * ps + kr % ps.  The splits run
// over the logical rows [0, P * ps), so K3 has K2's split boundaries,
// tiles and summation order, and gives K2's result on the gathered cache
// bit for bit.  The table entry of each of a tile's 32 rows is read once,
// by one thread, into shared memory one tile ahead of its use.
//
// What bounds it on the H100: bytes.  A decode tick reads every live KV
// row once and does 4*G*D flops per row, about 8 flops per byte in bf16 at
// G = 8 — far below the ~295 flops per byte where the tensor cores would
// become the limit.  The time is the KV stream plus launch latency.
//
// K2 and K3 are templated on (Dk, Dv): q and k have Dk columns, v and the
// output Dv (SplitDims: the dense decoder's square head dims, MLA's
// absorbed decode over one latent KV head of kv_lora + qk_rope = 576
// columns whose first 512 are V, with all of the model's query heads in
// its group: 16 for deepseek-v2-lite, 128 for deepseek-v2-236b, and the
// reduced MLA config's 40 / 32).  The tiles live in dynamic shared memory
// (SplitSmem): 44 KB at 128 / 128, 179 KB at 576 / 512 (one block an SM).
//
// Design: one block of 128 threads per (split, query group, batch row).  A
// block holds kGMax = 16 query heads of one KV head; a KV head whose group
// G = Hq / Hkv is larger is split over ceil(G / 16) blocks along the grid's
// y axis (QueryGroup below), each writing its heads' partials at their own
// rows of the [B, Hkv, splits, G] layout, so the combine does not know the
// split; at G <= 16 that is one block a KV head, as the Pallas grid's
// (B, Hkv, splits) step.  Each group block streams the same cache rows of
// its KV head (at G = 128 the second to eighth reads of a tile come from
// the L2).  The split count is chosen by the wrapper so that the blocks
// (B * Hkv * ceil(G / 16) * splits) cover the SMs, with at least 64 rows
// per split, so a small decode batch still spreads its KV stream over the
// whole card.  Each block reads its own
// row's kv_len (clamped to S) and streams only the live rows of its split,
// 32 at a time through shared memory; a split that lies wholly past
// kv_len reads nothing and writes m = NEG_INF, l = 0, o = 0 (the Pallas
// kernel's m > NEG_INF/2 guard).  Within a tile, warp w scores query heads
// w, w + 4, ...: lane j takes KV row j, and the running max and sum are
// warp shuffles.  Partials go to f32 scratch, and a second small kernel
// (one block per query head and row) rescales and sums them in split
// order.  That is the f32 path (the parity dtype), over an f32 or a
// 1-byte cache; bf16 queries run decode_split_mma_kernel (a bf16 cache)
// or decode_split_quant_mma_kernel (a 1-byte cache) on the tensor cores
// ("bf16 on the tensor cores" below), with the same grid, split plan,
// partials and combine.
//
// The sequence-sharded decode (models/attention.py
// distributed_decode_attention, the reference's shard_map flash-decode)
// runs K2's two kernels apart: decode_attention_fwd_partials launches the
// split kernel alone over one rank's block of cache rows (its local
// lengths clamped to the block), the ranks' partials are gathered and
// laid side by side as more splits, and decode_attention_combine launches
// the combine kernel alone over them.  With the same split size, R blocks
// of ns splits give one K2 call at R * ns splits bit for bit: a split's
// tiles, masking and sums depend only on its rows and its live count.
//
// K7 and K8 replace decode_attention_fwd_quantized / _decode_quant_kernel
// and paged_decode_attention_fwd_quantized / _paged_decode_quant_kernel
// (same file): K2 and K3 over int8 or fp8 e4m3 K/V with one f16 scale per
// (cache row, KV head).  They are the same split kernel with the other
// value format (kQuantized<T, S>, common.cuh): K7 with ContiguousRows, K8
// with PagedRows, so K8 on a pool equals K7 on the gathered cache bit for
// bit.  The scales are constant along both contractions, so, as in the
// Pallas body, the k-scale multiplies each score column after q.k and
// before 1/sqrt(D), the v-scale multiplies p only inside the p.v product,
// and l sums the unscaled p.  A tick then reads 1 byte per value and 2
// per scale and row: about half of K2's bytes at D = 128.  With f32
// queries (the CUDA cores) each tile's values are converted to f32 in
// shared memory as the float ones are, read four values to a 32-bit load,
// and its 32 k- and v-scales are requested before its values; bf16
// queries (every served call) run decode_split_quant_mma_kernel on the
// tensor cores ("K7, K8 and K9 on the tensor cores" below).
//
// K5, K6 and K9 replace decode_attention_fwd_pipelined /
// _decode_pipelined_kernel, paged_decode_attention_fwd_pipelined /
// _paged_decode_pipelined_kernel and
// paged_decode_attention_fwd_quantized_pipelined /
// _paged_decode_quant_pipelined_kernel (same file): K2, K3 and K8 with
// the KV fetch overlapped with compute through a `num_buffers`-slot DMA
// ring.  The TPU's K5 walks all splits of a (B, Hkv) pair in one program;
// at the main-path shape (B = 8, Hkv = 2) that would be 16 blocks for 132
// SMs, so here each keeps K2's split-parallel grid, and the ring runs
// inside each block's split: a multistage cp.async pipeline (common.cuh,
// "KV rings") with tiles t + 1 .. t + depth - 1 in flight while tile t
// is computed.  A stage holds a tile's raw bytes (bf16, f32, int8 or
// e4m3; 16 bytes a copy, rows past s1 zero-filled without a read, their
// table entries never read); values are widened where they are read, in
// the split kernel's order, so K5 == K2, K6 == K3 and K9 == K8 bit for
// bit at every depth and page placement.  They are bound by bytes as K2
// is; the ring hides the per-tile load latency that K2 pays between its
// barriers.  K9's f16 scales sit at a stride of Hkv x 2 bytes (not the 4
// bytes cp.async needs at Hkv = 1), so they are loaded into registers one
// tile ahead.  That is decode_split_pipelined_kernel, the f32 queries'.
// In f32 at MLA's (576, 512) no ring fits (depth 2 takes 289 KB); in
// bf16, K5 and K6 are decode_split_mma_kernel at depth 2 or 4, whose
// 32-row stages at (576, 512) fit depth 2 (159 KB) but not 4, and the
// wrapper halves the depth until the ring fits; bf16 K9 is
// decode_split_quant_mma_kernel at depth 2 or 4.

#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 32;                       // KV rows per tile: one per lane
constexpr int kGMax = 16;                     // query heads a block holds
constexpr int kRowsPerWarp = kGMax / kWarps;

// The split blocks a KV head's group of G = hq / hkv query heads takes:
// ceil(G / kGMax), along the grid's y axis beside the KV heads.
__host__ __device__ inline int group_blocks(int hq, int hkv) {
  return (hq / hkv + kGMax - 1) / kGMax;
}

// What split block (blockIdx.x, blockIdx.y, blockIdx.z) = (split, hk *
// group_blocks + gi, b) holds: query heads g0 = kGMax gi .. g0 + count - 1
// (count = min(kGMax, G - g0)) of KV head hk.  A head's products, maxima
// and sums never meet another head's, so how the group is cut moves no
// bit.  The fields are ints, and the 64-bit indices below are formed
// where they are used, so that no more than before stays live across a
// block's tile loop.
struct QueryGroup {
  int hk;      // the KV head
  int g0;      // its first query head within the KV head's group
  int count;   // query heads the block holds, 1 .. kGMax
};

__device__ __forceinline__ QueryGroup query_group(int hq, int hkv) {
  const int blocks = group_blocks(hq, hkv);
  const int hk = blockIdx.y / blocks;
  const int g0 = (blockIdx.y % blocks) * kGMax;
  return {hk, g0, min(kGMax, hq / hkv - g0)};
}

// The row of q [B * Hq, Dk] of the block's first query head.
__device__ __forceinline__ size_t group_q_row(const QueryGroup& grp, int hq,
                                              int hkv) {
  return static_cast<size_t>(blockIdx.z) * hq + grp.hk * (hq / hkv) +
         grp.g0;
}

// The index of the block's first partial in the [B, Hkv, splits, G]
// stats layout (its o_part rows of Dv at the same index).
__device__ __forceinline__ size_t group_part(const QueryGroup& grp, int hq,
                                             int hkv, int num_splits) {
  return ((static_cast<size_t>(blockIdx.z) * hkv + grp.hk) * num_splits +
          blockIdx.x) * (hq / hkv) + grp.g0;
}

// Where logical cache row kr of batch row b lives: the index of its
// [Hkv, D] slab in the k / v storage.
struct ContiguousRows {            // k, v [B, S, Hkv, D]
  int s_len;
  __device__ size_t row(int b, int kr) const {
    return static_cast<size_t>(b) * s_len + kr;
  }
};

struct PagedRows {                 // k, v [Np, ps, Hkv, D], pt [B, P]
  const int* pt;
  int pages, page_size;
  __device__ size_t row(int b, int kr) const {
    const int phys = pt[static_cast<size_t>(b) * pages + kr / page_size];
    return static_cast<size_t>(phys) * page_size + kr % page_size;
  }
};

// Shared memory of decode_split_kernel, in floats: the [kGMax][DK] query
// tile, the [kBK][kKStride] K tile (rows padded so that lane j's reads of
// row j are conflict-free: +1 for the float kernels' column reads; +4
// keeps the quantized kernels' float4 reads conflict-free and 16-byte
// aligned), the [kBK][DV] V tile, the [kGMax][kBK] probabilities, the
// per-head rescale and the tile's k- and v-scales (quantized); then the
// slab index of each row of tiles t and t + 1 (size_t, 8-byte aligned).
template <bool kQuant, int DK, int DV>
struct SplitSmem {
  static constexpr int kKStride = kQuant ? DK + 4 : DK + 1;
  static constexpr int kQs = 0;
  static constexpr int kKs = kQs + kGMax * DK;
  static constexpr int kVs = kKs + kBK * kKStride;
  static constexpr int kPs = kVs + kBK * DV;
  static constexpr int kCs = kPs + kGMax * kBK;
  static constexpr int kKsc = kCs + kGMax;
  static constexpr int kVsc = kKsc + kBK;
  static constexpr int kRowAt = (kVsc + kBK + 1) / 2 * 2;   // in floats
  static constexpr size_t kBytes = kRowAt * sizeof(float) +
                                   2 * kBK * sizeof(size_t);
};

// T: the query's dtype; S: the K/V storage dtype (T itself, or int8_t /
// __nv_fp8_e4m3 with the f16 scales k_scale / v_scale, null otherwise).
// DK: the width of q and k; DV: that of v and of the output.
template <typename T, typename S, int DK, int DV, typename Rows>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const S* __restrict__ k,
                    const S* __restrict__ v,
                    const __half* __restrict__ k_scale,
                    const __half* __restrict__ v_scale,
                    const int* __restrict__ kv_len,
                    float* __restrict__ o_part, float* __restrict__ m_part,
                    float* __restrict__ l_part, Rows rows, int s_len, int hq,
                    int hkv, int num_splits, int split_size) {
  constexpr bool kQuant = kQuantized<T, S>;
  static_assert(!kQuant || DK == DV, "the quantized kernel is square");
  static_assert(kGMax * DV % kThreads == 0, "heads x DV split evenly");
  constexpr int kAcc = kGMax * DV / kThreads;  // accumulator slots per thread
  using L = SplitSmem<kQuant, DK, DV>;
  constexpr int kKStride = L::kKStride;
  extern __shared__ __align__(16) float smem[];
  float (*qs)[DK] = reinterpret_cast<float (*)[DK]>(smem + L::kQs);
  float (*ks)[kKStride] = reinterpret_cast<float (*)[kKStride]>(smem + L::kKs);
  float (*vs)[DV] = reinterpret_cast<float (*)[DV]>(smem + L::kVs);
  float (*ps)[kBK] = reinterpret_cast<float (*)[kBK]>(smem + L::kPs);
  float* cs = smem + L::kCs;       // per-head rescale of the accumulator
  float* ksc = smem + L::kKsc;     // the tile's scales (quantized)
  float* vsc = smem + L::kVsc;
  // slab index of each row, tiles t and t + 1
  size_t (*row_at)[kBK] = reinterpret_cast<size_t (*)[kBK]>(smem + L::kRowAt);

  const int split = blockIdx.x;
  const int b = blockIdx.z;
  const QueryGroup grp = query_group(hq, hkv);
  const int hk = grp.hk;
  const int g_count = grp.count;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // partials of this block's heads: [g_count] stats, [g_count, DV] outputs
  const size_t part = group_part(grp, hq, hkv, num_splits);

  const int kvl = max(0, min(kv_len[b], s_len));
  const int s0 = split * split_size;
  const int s1 = min(s0 + split_size, kvl);
  if (s1 <= s0) {
    for (int i = tid; i < g_count * DV; i += kThreads) o_part[part * DV + i] = 0.f;
    for (int g = tid; g < g_count; g += kThreads) {
      m_part[part + g] = kNegInf;
      l_part[part + g] = 0.f;
    }
    return;
  }

  const float sqrt_d = sqrtf(static_cast<float>(DK));
  {
    // the block's query rows, 16 bytes a load (DK * sizeof(T) is a
    // multiple of 16)
    constexpr int kV = 16 / sizeof(T), kQW = DK / kV;
    for (int i = tid; i < g_count * kQW; i += kThreads) {
      const int g = i / kQW, c = (i % kQW) * kV;
      float qx[kV];
      unpack16<T>(__ldg(reinterpret_cast<const uint4*>(
                      q + (group_q_row(grp, hq, hkv) + g) * DK + c)),
                  qx);
#pragma unroll
      for (int u = 0; u < kV; ++u)   // quantized: 1/sqrt(D) after ks
        qs[g][c + u] = kQuant ? qx[u] : qx[u] / sqrt_d;
    }
  }
  // rows of the first tile; a row at or past s1 is never loaded, and its
  // table entry (which may lie outside the table) is never read
  if (tid < kBK) row_at[0][tid] = s0 + tid < s1 ? rows.row(b, s0 + tid) : 0;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kAcc];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;

  for (int k0 = s0, t = 0; k0 < s1; k0 += kBK, t ^= 1) {
    __syncthreads();   // the previous tile is consumed; qs, row_at[t] written
    // this tile's scales, at its rows' slab indices: loaded before the
    // values so that their latency overlaps the value loads
    float k_sc = 0.f, v_sc = 0.f;
    if constexpr (kQuant) {
      if (tid < kBK && k0 + tid < s1) {
        const size_t off = row_at[t][tid] * hkv + hk;
        k_sc = to_float(k_scale[off]);
        v_sc = to_float(v_scale[off]);
      }
    }
    if constexpr (kQuant) {
      // one 32-bit word (four 1-byte values) per load: a row's D bytes
      // are whole, 4-byte aligned words (D % 16 == 0; the wrapper checks
      // the base pointers)
      constexpr int kWords = DK / 4;
      for (int i = tid; i < kBK * kWords; i += kThreads) {
        const int r = i / kWords, c = (i % kWords) * 4, kr = k0 + r;
        float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
        if (kr < s1) {
          const size_t off = (row_at[t][r] * hkv + hk) * DK + c;
          kx = word_to_float4<S>(*reinterpret_cast<const uint32_t*>(k + off));
          vx = word_to_float4<S>(*reinterpret_cast<const uint32_t*>(v + off));
        }
        *reinterpret_cast<float4*>(&ks[r][c]) = kx;
        *reinterpret_cast<float4*>(&vs[r][c]) = vx;
      }
    } else {
      stage_kv_rows<S, DK, DV, kThreads>(
          k, v, &ks[0][0], kKStride, &vs[0][0], [&](int r) -> long long {
            return k0 + r < s1
                       ? static_cast<long long>(row_at[t][r] * hkv + hk)
                       : -1;
          });
    }
    if constexpr (kQuant) {
      if (tid < kBK) {
        ksc[tid] = k_sc;
        vsc[tid] = v_sc;
      }
    }
    if (tid < kBK) {   // the next tile's rows; row_at[t ^ 1] was last read
      const int kr = k0 + kBK + tid;   // before this iteration's first sync
      row_at[t ^ 1][tid] = kr < s1 ? rows.row(b, kr) : 0;
    }
    __syncthreads();

    const bool ok = k0 + lane < s1;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int g = warp + kWarps * rr;
      if (g < g_count) {               // uniform across the warp
        float s = 0.f;
        if constexpr (kQuant) {
          s = dot4<DK>(qs[g], ks[lane]) * ksc[lane] / sqrt_d;
        } else {
#pragma unroll 8
          for (int c = 0; c < DK; ++c) s += qs[g][c] * ks[lane][c];
        }
        s = ok ? s : kNegInf;
        const float m_new = fmaxf(m[rr], warp_max(s));
        const float p = ok ? expf(s - m_new) : 0.f;
        const float corr = expf(m[rr] - m_new);
        l[rr] = l[rr] * corr + warp_sum(p);   // l sums the unscaled p
        m[rr] = m_new;
        ps[g][lane] = kQuant ? p * vsc[lane] : p;
        if (lane == 0) cs[g] = corr;
      }
    }
    __syncthreads();   // ps and cs rows come from every warp

#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int idx = tid + kThreads * j;
      const int g = idx / DV, c = idx % DV;
      if (g < g_count) {
        float a = acc[j] * cs[g];
#pragma unroll 8
        for (int t = 0; t < kBK; ++t) a += ps[g][t] * vs[t][c];
        acc[j] = a;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int idx = tid + kThreads * j;
    if (idx / DV < g_count) o_part[part * DV + idx] = acc[j];
  }
  if (lane == 0) {
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int g = warp + kWarps * rr;
      if (g < g_count) {
        m_part[part + g] = m[rr];
        l_part[part + g] = l[rr];
      }
    }
  }
}

// One block per (query head, batch row): out = sum_s w_s o_s / sum_s w_s l_s
// with w_s = exp(m_s - max_s m_s).
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ o_part,
                      const float* __restrict__ m_part,
                      const float* __restrict__ l_part, T* __restrict__ out,
                      int hq, int hkv, int num_splits, int d) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g_count = hq / hkv;
  const int hk = h / g_count;
  const int g = h % g_count;
  const size_t first =
      (static_cast<size_t>(b) * hkv + hk) * num_splits * g_count + g;
  float m_glob = kNegInf;
  for (int s = 0; s < num_splits; ++s)
    m_glob = fmaxf(m_glob, m_part[first + static_cast<size_t>(s) * g_count]);
  float l_glob = 0.f;
  for (int s = 0; s < num_splits; ++s) {
    const size_t i = first + static_cast<size_t>(s) * g_count;
    l_glob += l_part[i] * expf(m_part[i] - m_glob);
  }
  const float denom = fmaxf(l_glob, 1e-30f);
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float o = 0.f;
    for (int s = 0; s < num_splits; ++s) {
      const size_t i = first + static_cast<size_t>(s) * g_count;
      o += o_part[i * d + c] * expf(m_part[i] - m_glob);
    }
    out[(static_cast<size_t>(b) * hq + h) * d + c] = from_float<T>(o / denom);
  }
}

// One launch of decode_combine_kernel after a split kernel.
template <typename T, typename Launch>
int launch_combine(const Launch& a, int dv) {
  decode_combine_kernel<T><<<dim3(a.hq, a.b), kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.o_part), static_cast<const float*>(a.m_part),
      static_cast<const float*>(a.l_part), static_cast<T*>(a.out), a.hq,
      a.hkv, a.num_splits, dv);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------- bf16 on the tensor cores
//
// bf16 K2 and K3 (kDepth 1) and K5 and K6 (kDepth 2, 4) are one kernel,
// decode_split_mma_kernel<Dk, Dv, kDepth, Rows>: in bf16 it replaces the
// Pallas decode_attention_fwd, paged_decode_attention_fwd,
// decode_attention_fwd_pipelined and paged_decode_attention_fwd_pipelined
// (src/repro/kernels/decode_attention/kernel.py).  Its grid and split plan
// are K2's; its products run as mma.sync m16n8k16, bf16 x bf16 -> f32, on
// raw bf16 tiles that cp.async brings into shared memory (fragments and
// ldmatrix offsets: common.cuh, "tensor cores").
//
// What bounds it: latency, then bytes.  At the qwen tick (B = 8, 2 KV
// heads, 1,024-row cache, the served lengths) the live cache is about
// 2 MB, 0.6 us at the HBM rate, while the CUDA-core split kernel above
// took 31 us there in bf16 (H100 80GB HBM3): each lane runs one dependent
// chain of Dk multiply-adds per query head and KV row, and re-reads every
// V value from shared memory once per head.
// Here a block's query heads (a KV head's whole group at G <= 16, else
// one of its ceil(G / 16) slices of 16, QueryGroup) are the 16 rows of one
// A operand (rows past the block's count are zeros, never written), so a
// tile's scores are DKP / 16 mma steps a warp and its P.V a few more; the
// split's time is its tiles' load latency, which the ring (depth 2, 4)
// overlaps with the previous tile's products.
//
// Per tile of kBK rows (64; 32 at MLA's 576 / 512, whose 64-row stage
// would leave no room for a ring), decode_mma_tile: warp w scores rows w
// kBK / 4 .. + kBK / 4 - 1 of the tile against all 16 query rows (S = Q
// K^T; K the B operand through ldmatrix; two chains of k-steps, summed at
// the end), the row maxima meet in shared memory, every warp forms the
// same m, and each warp's probabilities P = exp(S / sqrt(Dk) - m) go to
// shared memory as bf16.  Then warp w computes O += P V for its quarter of
// O's columns (V the B operand through ldmatrix.trans): at Dv = 512 that
// is 64 f32 accumulators a thread, where one warp holding all of O would
// need 256.  Every warp applies the same rescale, so each keeps a partial
// l of its own f32 p (its lanes' columns), and the partials meet once, at
// the end, in warp order (decode_mma_finish).  The arithmetic and its
// order do not depend on the depth (only when the copies are issued
// does), and the row address (Rows) only says where a row's bytes come
// from: K5 == K2, K6 == K3 and K3 on a pool == K2 on the gathered cache,
// bit for bit.  Rows past s1 land as zeros without a read (their table
// entries are never read) and score -inf; Dk = 40 is zero-padded to 48,
// which adds nothing to a score.  The partials (o unnormalized, m, l) are
// K2's, so decode_combine_kernel sums them as before.
//
// bf16 K7, K8 and K9 (1-byte K/V with f16 row scales) are its sibling
// decode_split_quant_mma_kernel<S, D, kDepth, Rows> below: the same grid,
// split plan, tile arithmetic and partials, over 1-byte tiles.

// The tile constants of the tensor-core split kernels: kBK KV rows a tile,
// Dk rounded up to 16, the bf16 row strides of the K tile and the query
// tile (kKS), the V tile (kVS) and the probabilities (kPS), each padded by
// 16 bytes so that the 8 row addresses of an ldmatrix fall in distinct
// banks, and the 8-column tiles of O a warp holds.  With no more tiles
// than warps (Dv <= 32) warp w holds tile w; otherwise the warps hold
// pairs of tiles (one ldmatrix.x4.trans feeds two), split as evenly as
// they go: the first kNP % kWarps warps take one pair more (Dv = 80: 5
// pairs as 2, 1, 1, 1).  kON is the most a warp holds.  Which warp holds
// a tile moves no bit of it: a tile's products and their order are the
// same wherever it lies.
template <int DK, int DV>
struct DecodeMmaTile {
  static_assert(DV % 16 == 0, "P.V takes 16 columns of v a step");
  static constexpr int kBK = DK + DV <= 256 ? 64 : 32;   // KV rows a tile
  static constexpr int kDKP = (DK + 15) / 16 * 16;
  static constexpr int kKS = kDKP + 8, kVS = DV + 8, kPS = kBK + 8;  // strides
  static constexpr int kKC = kDKP / 8, kVC = DV / 8;   // 16-byte chunks a row
  static constexpr int kVOff = kBK * kKS;              // elements
  static constexpr int kElems = kVOff + kBK * kVS;     // a K and V tile
  static constexpr int kNT = DV / 8;                   // 8-column tiles of O
  static constexpr bool kSingles = kNT <= kWarps;      // one tile a warp
  static constexpr int kNP = kNT / 2;                  // pairs of tiles
  static constexpr bool kEvenPairs = kNP % kWarps == 0;
  static constexpr int kON =
      kSingles ? 1 : 2 * ((kNP + kWarps - 1) / kWarps);   // a warp's, most
  // warp w's first O tile and how many it holds
  __host__ __device__ static constexpr int first_tile(int w) {
    return kSingles ? w
                    : 2 * (w * (kNP / kWarps) +
                           (w < kNP % kWarps ? w : kNP % kWarps));
  }
  __host__ __device__ static constexpr int tiles(int w) {
    return kSingles ? (w < kNT ? 1 : 0)
                    : 2 * (kNP / kWarps + (w < kNP % kWarps ? 1 : 0));
  }
};

// Shared memory of decode_split_mma_kernel, in bytes: kDepth ring stages
// (a [kBK][DKP + 8] K tile, then a [kBK][DV + 8] V tile, raw bf16), the
// [16][DKP + 8] query tile, the [16][kBK + 8] bf16 probabilities, each
// warp's row maxima and row sums ([4][16] f32 each), then the slab index of
// each row of kDepth + 1 tiles (size_t).  ``pipelined_smem`` in
// kernels/decode_attention/ops.py computes the same sizes (its bf16
// layout); decode_attention_fwd_pipelined_smem reports these.
template <int DK, int DV, int kDepth>
struct DecodeMmaSmem {
  using M = DecodeMmaTile<DK, DV>;
  static constexpr size_t kQs =
      sizeof(bf16) * static_cast<size_t>(kDepth) * M::kElems;
  static constexpr size_t kPs = kQs + sizeof(bf16) * kGMax * M::kKS;
  static constexpr size_t kMax = kPs + sizeof(bf16) * kGMax * M::kPS;
  static constexpr size_t kSum = kMax + sizeof(float) * kWarps * kGMax;
  static constexpr size_t kRowAt = kSum + sizeof(float) * kWarps * kGMax;
  static constexpr size_t kBytes =
      kRowAt + sizeof(size_t) * static_cast<size_t>(kDepth + 1) * M::kBK;
};

// The block's g_count query rows (q rows q_row ..) as the 16 rows of an A
// tile into qs (rows past g_count and Dk's padding as zeros), by cp.async,
// not committed.
template <int DK, int DV>
__device__ __forceinline__ void fetch_decode_q(const bf16* __restrict__ q,
                                               bf16* qs, size_t q_row,
                                               int g_count) {
  using M = DecodeMmaTile<DK, DV>;
  for (int i = threadIdx.x; i < kGMax * M::kKC; i += kThreads) {
    const int r = i / M::kKC, c = i % M::kKC;
    const bool live = r < g_count && c * 8 < DK;
    const size_t row = q_row + (live ? r : 0);
    cp_async16(qs + r * M::kKS + c * 8, q + row * DK + (live ? c * 8 : 0),
               live);
  }
}

// One KV tile of the tensor-core split kernels, rows k0 .. k0 + kBK - 1
// (those at or past s1 masked), for the whole block: every thread calls
// it, and it holds two barriers (the warps' row maxima; their columns of
// P).  kt and vt are the tile's bf16 K and V rows (strides kKS and kVS),
// qs the query tile.  kScaled (K7-K9): each score column is multiplied by
// its row's k-scale (ksc) after Q K^T and before 1/sqrt(Dk), and p by its
// v-scale (vsc) only where it is rounded into P for P V; l sums the
// unscaled p (the Pallas _decode_quant_kernel's order).
template <int DK, int DV, bool kScaled>
__device__ __forceinline__ void decode_mma_tile(
    const bf16* __restrict__ qs, const bf16* __restrict__ kt,
    const bf16* __restrict__ vt, bf16* ps, float (*tmax)[kGMax],
    const float* __restrict__ ksc, const float* __restrict__ vsc, int k0,
    int s1, float scale, float scale_l2, float (&m)[2], float (&l)[2],
    float (&o)[DecodeMmaTile<DK, DV>::kON][4]) {
  using M = DecodeMmaTile<DK, DV>;
  constexpr int kBK = M::kBK;
  constexpr int kKSteps = M::kDKP / 16;   // score mma steps over Dk
  constexpr int kRW = kBK / kWarps;       // tile rows a warp scores
  constexpr int kSN = kRW / 8;            // its 8-column score tiles
  constexpr int kON = M::kON;
  static_assert(kSN == 1 || kSN == 2, "a warp scores 8 or 16 rows a tile");
  static_assert(M::kSingles || M::kNT % 2 == 0, "O tiles a warp: 1 or pairs");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t2 = (lane % 4) * 2;
  const int fr = frag_row(lane), fc = frag_col(lane);
  const int br = brow(lane), bc = bcol(lane);
  const int c0 = warp * kRW;              // the warp's first row of a tile

  // S = Q K^T over the warp's rows, the k-steps in two chains
  float s[2][kSN][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int n = 0; n < kSN; ++n) s[h][n][0] = s[h][n][1] = s[h][n][2] =
        s[h][n][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
    uint32_t qa[4];
    ldmatrix_x4(qa, qs + fr * M::kKS + ks * 16 + fc);
    if constexpr (kSN == 2) {
      uint32_t kb[4];
      ldmatrix_x4(kb, kt + (c0 + br) * M::kKS + ks * 16 + bc);
      mma_bf16(s[ks % 2][0], qa, kb[0], kb[1]);
      mma_bf16(s[ks % 2][1], qa, kb[2], kb[3]);
    } else {
      uint32_t kb[2];
      ldmatrix_x2(kb, kt + (c0 + br) * M::kKS + ks * 16 + bc);
      mma_bf16(s[ks % 2][0], qa, kb[0], kb[1]);
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < kSN; ++n) {
    float2 kc = make_float2(1.f, 1.f);
    if constexpr (kScaled)
      kc = *reinterpret_cast<const float2*>(ksc + c0 + 8 * n + t2);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[0][n][e] += s[1][n][e];
      if constexpr (kScaled) s[0][n][e] *= (e & 1) ? kc.y : kc.x;
      if (k0 + c0 + 8 * n + t2 + (e & 1) >= s1) s[0][n][e] = -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[0][n][e]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    if (lane % 4 == 0) tmax[warp][g + 8 * i] = mx[i];
  }
  __syncthreads();             // every warp's row maxima
  float corr[2], ml[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = g + 8 * i;
    const float tile_max = fmaxf(fmaxf(tmax[0][r], tmax[1][r]),
                                 fmaxf(tmax[2][r], tmax[3][r]));
    const float m_new = fmaxf(m[i], tile_max * scale);
    corr[i] = exp2f((m[i] - m_new) * kLog2e);
    m[i] = m_new;
    ml[i] = m_new * kLog2e;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < kSN; ++n) {
    const float p0 = exp2f(s[0][n][0] * scale_l2 - ml[0]);
    const float p1 = exp2f(s[0][n][1] * scale_l2 - ml[0]);
    const float p2 = exp2f(s[0][n][2] * scale_l2 - ml[1]);
    const float p3 = exp2f(s[0][n][3] * scale_l2 - ml[1]);
    rs[0] += p0 + p1;
    rs[1] += p2 + p3;
    const int col = c0 + 8 * n + t2;
    uint32_t* lo = reinterpret_cast<uint32_t*>(ps + g * M::kPS + col);
    uint32_t* hi = reinterpret_cast<uint32_t*>(ps + (g + 8) * M::kPS + col);
    if constexpr (kScaled) {
      const float2 vc = *reinterpret_cast<const float2*>(vsc + col);
      *lo = pack_bf16(p0 * vc.x, p1 * vc.y);
      *hi = pack_bf16(p2 * vc.x, p3 * vc.y);
    } else {
      *lo = pack_bf16(p0, p1);
      *hi = pack_bf16(p2, p3);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];
#pragma unroll
  for (int j = 0; j < kON; ++j) {
    o[j][0] *= corr[0];
    o[j][1] *= corr[0];
    o[j][2] *= corr[1];
    o[j][3] *= corr[1];
  }
  __syncthreads();             // every warp's columns of P
  // O += P V over the warp's 8-column tiles of O
  const int o0 = M::first_tile(warp), on = M::tiles(warp);
  if (on > 0) {
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
      ldmatrix_x4(pa, ps + fr * M::kPS + kk * 16 + fc);
      if constexpr (M::kSingles) {
        uint32_t vb[2];
        ldmatrix_x2_trans(vb, vt + (kk * 16 + fr) * M::kVS + o0 * 8);
        mma_bf16(o[0], pa, vb[0], vb[1]);
      } else {
#pragma unroll
        for (int j = 0; j < kON; j += 2) {
          if (M::kEvenPairs || j < on) {
            uint32_t vb[4];
            ldmatrix_x4_trans(vb, vt + (kk * 16 + fr) * M::kVS +
                                      (o0 + j) * 8 + fc);
            mma_bf16(o[j], pa, vb[0], vb[1]);
            mma_bf16(o[j + 1], pa, vb[2], vb[3]);
          }
        }
      }
    }
  }
}

// The partials of a tensor-core split block: l as each quad's partial
// sums, then the warps' in warp order (through lsum, after a barrier); o
// unnormalized; m.  Rows at or past g_count are not written.
template <int DK, int DV>
__device__ __forceinline__ void decode_mma_finish(
    float (*lsum)[kGMax], const float (&m)[2], const float (&l)[2],
    const float (&o)[DecodeMmaTile<DK, DV>::kON][4],
    float* __restrict__ o_part, float* __restrict__ m_part,
    float* __restrict__ l_part, size_t part, int g_count) {
  using M = DecodeMmaTile<DK, DV>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t2 = (lane % 4) * 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    if (lane % 4 == 0) lsum[warp][g + 8 * i] = li;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = g + 8 * i;
    if (r >= g_count) continue;
    float* orow = o_part + (part + r) * DV;
#pragma unroll
    for (int j = 0; j < M::kON; ++j) {
      const int n = M::first_tile(warp) + j;
      if (j < M::tiles(warp))
        *reinterpret_cast<float2*>(orow + n * 8 + t2) =
            make_float2(o[j][2 * i], o[j][2 * i + 1]);
    }
    if (warp == 0 && lane % 4 == 0) {
      m_part[part + r] = m[i];
      l_part[part + r] =
          ((lsum[0][r] + lsum[1][r]) + lsum[2][r]) + lsum[3][r];
    }
  }
}

// The partials of a split that lies wholly past kv_len: m = NEG_INF,
// l = 0, o = 0 (the Pallas kernels' m > NEG_INF/2 guard).
template <int DV>
__device__ __forceinline__ void empty_split(float* __restrict__ o_part,
                                            float* __restrict__ m_part,
                                            float* __restrict__ l_part,
                                            size_t part, int g_count) {
  for (int i = threadIdx.x; i < g_count * DV; i += kThreads)
    o_part[part * DV + i] = 0.f;
  for (int r = threadIdx.x; r < g_count; r += kThreads) {
    m_part[part + r] = kNegInf;
    l_part[part + r] = 0.f;
  }
}

template <int DK, int DV, int kDepth, typename Rows>
__global__ void __launch_bounds__(kThreads)
decode_split_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const int* __restrict__ kv_len,
                        float* __restrict__ o_part, float* __restrict__ m_part,
                        float* __restrict__ l_part, Rows rows, int s_len,
                        int hq, int hkv, int num_splits, int split_size) {
  using M = DecodeMmaTile<DK, DV>;
  using L = DecodeMmaSmem<DK, DV, kDepth>;
  constexpr int kBK = M::kBK;
  constexpr int kSlots = kDepth + 1;      // tiles of row_at
  extern __shared__ __align__(16) unsigned char dmma_smem[];
  bf16* ring = reinterpret_cast<bf16*>(dmma_smem);
  bf16* qs = reinterpret_cast<bf16*>(dmma_smem + L::kQs);
  bf16* ps = reinterpret_cast<bf16*>(dmma_smem + L::kPs);
  float (*tmax)[kGMax] = reinterpret_cast<float (*)[kGMax]>(dmma_smem + L::kMax);
  float (*lsum)[kGMax] = reinterpret_cast<float (*)[kGMax]>(dmma_smem + L::kSum);
  size_t (*row_at)[kBK] =
      reinterpret_cast<size_t (*)[kBK]>(dmma_smem + L::kRowAt);

  const int split = blockIdx.x;
  const int b = blockIdx.z;
  const QueryGroup grp = query_group(hq, hkv);
  const int hk = grp.hk;
  const int g_count = grp.count;
  const int tid = threadIdx.x;

  const int kvl = max(0, min(kv_len[b], s_len));
  const int s0 = split * split_size;
  const int s1 = min(s0 + split_size, kvl);
  if (s1 <= s0) {
    empty_split<DV>(o_part, m_part, l_part,
                    group_part(grp, hq, hkv, num_splits), g_count);
    return;
  }
  const int n_tiles = (s1 - s0 + kBK - 1) / kBK;

  fetch_decode_q<DK, DV>(q, qs, group_q_row(grp, hq, hkv), g_count);
  cp_async_commit();
  // rows of tiles 0 .. kDepth - 1; a row at or past s1 is never loaded,
  // and its table entry (which may lie outside the table) is never read
  if (tid < kBK) {
#pragma unroll
    for (int i = 0; i < kDepth; ++i) {
      const int kr = s0 + i * kBK + tid;
      row_at[i][tid] = kr < s1 ? rows.row(b, kr) : 0;
    }
  }
  __syncthreads();

  // tile `tile` into its stage, then a commit (an empty group past the
  // last tile, so that every iteration waits for the same count)
  const auto fetch = [&](int tile) {
    if (tile < n_tiles) {
      const int k0 = s0 + tile * kBK;
      const size_t* at = row_at[tile % kSlots];
      bf16* st = ring + (tile % kDepth) * M::kElems;
      for (int i = tid; i < kBK * (M::kKC + M::kVC); i += kThreads) {
        const int r = i / (M::kKC + M::kVC), c = i % (M::kKC + M::kVC);
        const bool live = k0 + r < s1;
        const size_t slab = live ? at[r] * hkv + hk : 0;
        if (c < M::kKC) {
          const bool in = live && c * 8 < DK;
          cp_async16(st + r * M::kKS + c * 8, k + slab * DK + (in ? c * 8 : 0),
                     in);
        } else {
          const int cv = (c - M::kKC) * 8;
          cp_async16(st + M::kVOff + r * M::kVS + cv, v + slab * DV + cv,
                     live);
        }
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < kDepth - 1; ++i) fetch(i);

  const float scale = 1.f / sqrtf(static_cast<float>(DK));
  const float scale_l2 = scale * kLog2e;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[M::kON][4];
#pragma unroll
  for (int j = 0; j < M::kON; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if constexpr (kDepth == 1) {
      __syncthreads();           // the previous tile, ps and tmax consumed
      fetch(t);
      cp_async_wait<0>();
    } else {
      cp_async_wait<kDepth - 2>();   // this thread's copies of tile t
    }
    __syncthreads();             // every thread's; row_at of tile t + 1 ..
    if constexpr (kDepth > 1) fetch(t + kDepth - 1);   // the stage t - 1 left
    if (tid < kBK) {   // rows of tile t + kDepth, in the slot tile t - 1 left
      const int kr = s0 + (t + kDepth) * kBK + tid;
      row_at[(t + kDepth) % kSlots][tid] = kr < s1 ? rows.row(b, kr) : 0;
    }
    const bf16* kt = ring + (t % kDepth) * M::kElems;
    decode_mma_tile<DK, DV, false>(qs, kt, kt + M::kVOff, ps, tmax, nullptr,
                                   nullptr, s0 + t * kBK, s1, scale,
                                   scale_l2, m, l, o);
  }
  cp_async_wait<0>();   // only empty groups remain
  decode_mma_finish<DK, DV>(lsum, m, l, o, o_part, m_part, l_part,
                            group_part(grp, hq, hkv, num_splits), g_count);
}

// ---------------------------------------- K7, K8 and K9 on the tensor cores
//
// bf16 K7 (ContiguousRows, kDepth 1), K8 (PagedRows, kDepth 1) and K9
// (PagedRows, kDepth 2, 4) are decode_split_quant_mma_kernel<S, D, kDepth,
// Rows>: decode_split_mma_kernel's grid, split plan, 16-row query operand,
// warp split of the products and partials (decode_mma_tile<.., kScaled>,
// decode_mma_finish) over int8 or e4m3 K/V with one f16 scale per (cache
// row, KV head).  What bounds it is what bounds K2, at half the bytes: a
// tick reads 1 byte a value and 2 a scale and row.
//
// A tile's raw bytes come through a kDepth-stage cp.async ring (16-byte
// copies; rows past s1 zero-filled without a read, their table entries
// never read).  After the ring's barrier the block converts the whole tile
// once into a bf16 K and V tile (int8 and e4m3 values are exact in bf16):
// ldmatrix.trans takes no 8-bit elements, so V needs a bf16 copy in any
// case, and with K converted in the same pass the raw stage is free before
// the products start, so the next tile's copy is issued into it right
// away: even at kDepth 1 (K7, K8) one tile is in flight while the block
// computes on the last, and a ring of kDepth stages holds kDepth.  The
// tile's f16 scales (2 bytes at a stride of Hkv x 2: too narrow for
// cp.async at Hkv = 1) come through registers a tile ahead and are stored
// beside the bf16 tile.  The arithmetic and its order do not depend on the
// depth or the row address: K9 == K8 at every depth and K8 on a pool ==
// K7 on the gathered rows and scales, bit for bit.

// Shared memory of decode_split_quant_mma_kernel<D, kDepth>, in bytes:
// kDepth ring stages of raw bytes ([kBK][D + 16] of K, then of V; rows
// padded by 16 bytes), the bf16 K and V tile they become (DecodeMmaTile's
// strides), the [16][D + 8] query tile, the [16][kBK + 8] bf16
// probabilities, each warp's row maxima and row sums, the tile's k- and
// v-scales (f32), then the slab index of each row of kDepth + 1 tiles.
// ``pipelined_smem`` in kernels/decode_attention/ops.py computes the same
// sizes (its 1-byte tensor-core layout).
template <int D, int kDepth>
struct QuantDecodeMmaSmem {
  using M = DecodeMmaTile<D, D>;
  static constexpr int kRow = D + 16;                   // bytes a raw row
  static constexpr size_t kStage = 2 * M::kBK * kRow;
  static constexpr size_t kTile = kDepth * kStage;
  static constexpr size_t kQs = kTile + sizeof(bf16) * M::kElems;
  static constexpr size_t kPs = kQs + sizeof(bf16) * kGMax * M::kKS;
  static constexpr size_t kMax = kPs + sizeof(bf16) * kGMax * M::kPS;
  static constexpr size_t kSum = kMax + sizeof(float) * kWarps * kGMax;
  static constexpr size_t kScale = kSum + sizeof(float) * kWarps * kGMax;
  static constexpr size_t kRowAt = kScale + 2 * sizeof(float) * M::kBK;
  static constexpr size_t kBytes =
      kRowAt + sizeof(size_t) * static_cast<size_t>(kDepth + 1) * M::kBK;
};

template <typename S, int D, int kDepth, typename Rows>
__global__ void __launch_bounds__(kThreads)
decode_split_quant_mma_kernel(const bf16* __restrict__ q,
                              const S* __restrict__ k,
                              const S* __restrict__ v,
                              const __half* __restrict__ k_scale,
                              const __half* __restrict__ v_scale,
                              const int* __restrict__ kv_len,
                              float* __restrict__ o_part,
                              float* __restrict__ m_part,
                              float* __restrict__ l_part, Rows rows,
                              int s_len, int hq, int hkv, int num_splits,
                              int split_size) {
  using M = DecodeMmaTile<D, D>;
  using L = QuantDecodeMmaSmem<D, kDepth>;
  constexpr int kBK = M::kBK;
  constexpr int kC = D / 16;             // 16-byte chunks of a raw row
  constexpr int kCopies = kBK * 2 * kC / kThreads;   // a thread's, a tile
  constexpr int kSlots = kDepth + 1;     // tiles of row_at
  static_assert(kBK * 2 * kC % kThreads == 0, "whole rounds of copies");
  extern __shared__ __align__(16) unsigned char dqmma_smem[];
  unsigned char* ring = dqmma_smem;
  bf16* kt = reinterpret_cast<bf16*>(dqmma_smem + L::kTile);
  bf16* vt = kt + M::kVOff;
  bf16* qs = reinterpret_cast<bf16*>(dqmma_smem + L::kQs);
  bf16* ps = reinterpret_cast<bf16*>(dqmma_smem + L::kPs);
  float (*tmax)[kGMax] =
      reinterpret_cast<float (*)[kGMax]>(dqmma_smem + L::kMax);
  float (*lsum)[kGMax] =
      reinterpret_cast<float (*)[kGMax]>(dqmma_smem + L::kSum);
  float* ksc = reinterpret_cast<float*>(dqmma_smem + L::kScale);
  float* vsc = ksc + kBK;
  size_t (*row_at)[kBK] =
      reinterpret_cast<size_t (*)[kBK]>(dqmma_smem + L::kRowAt);

  const int split = blockIdx.x;
  const int b = blockIdx.z;
  const QueryGroup grp = query_group(hq, hkv);
  const int hk = grp.hk;
  const int g_count = grp.count;
  const int tid = threadIdx.x;

  const int kvl = max(0, min(kv_len[b], s_len));
  const int s0 = split * split_size;
  const int s1 = min(s0 + split_size, kvl);
  if (s1 <= s0) {
    empty_split<D>(o_part, m_part, l_part,
                   group_part(grp, hq, hkv, num_splits), g_count);
    return;
  }
  const int n_tiles = (s1 - s0 + kBK - 1) / kBK;

  fetch_decode_q<D, D>(q, qs, group_q_row(grp, hq, hkv), g_count);
  cp_async_commit();
  // rows of tiles 0 .. kDepth - 1; a row at or past s1 is never loaded,
  // and its table entry (which may lie outside the table) is never read
  if (tid < kBK) {
#pragma unroll
    for (int i = 0; i < kDepth; ++i) {
      const int kr = s0 + i * kBK + tid;
      row_at[i][tid] = kr < s1 ? rows.row(b, kr) : 0;
    }
  }
  __syncthreads();

  // tile `tile`'s K and V bytes into stage tile % kDepth, then a commit
  // (an empty group past the last tile)
  const auto fetch = [&](int tile) {
    if (tile < n_tiles) {
      const int k0 = s0 + tile * kBK;
      const size_t* at = row_at[tile % kSlots];
      unsigned char* st = ring + (tile % kDepth) * L::kStage;
#pragma unroll
      for (int u = 0; u < kCopies; ++u) {
        const int i = tid + u * kThreads;
        const int r = i / (2 * kC), c = i % (2 * kC);
        const bool live = k0 + r < s1;
        const size_t slab = live ? at[r] * hkv + hk : 0;
        const bool is_v = c >= kC;
        const int cc = is_v ? c - kC : c;
        cp_async16(st + (is_v ? kBK * L::kRow : 0) + r * L::kRow + cc * 16,
                   reinterpret_cast<const unsigned char*>(
                       (is_v ? v : k) + slab * D) + cc * 16,
                   live);
      }
    }
    cp_async_commit();
  };
  // thread r < kBK: the k- and v-scale of row r of a tile (0 past s1)
  const auto scales_of = [&](int tile) -> float2 {
    const int kr = s0 + tile * kBK + tid;
    if (tid >= kBK || kr >= s1) return make_float2(0.f, 0.f);
    const size_t off = row_at[tile % kSlots][tid] * hkv + hk;
    return make_float2(to_float(k_scale[off]), to_float(v_scale[off]));
  };
  for (int i = 0; i < kDepth; ++i) fetch(i);
  float2 sc = scales_of(0);

  const float scale = 1.f / sqrtf(static_cast<float>(D));
  const float scale_l2 = scale * kLog2e;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[M::kON][4];
#pragma unroll
  for (int j = 0; j < M::kON; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kDepth - 1>();   // this thread's copies of tile t
    // every thread's; the previous tile's bf16 K / V, P, maxima and scales
    // consumed
    __syncthreads();
    if (tid < kBK) {
      ksc[tid] = sc.x;
      vsc[tid] = sc.y;
      // rows of tile t + kDepth, in the slot tile t - 1 left
      const int kr = s0 + (t + kDepth) * kBK + tid;
      row_at[(t + kDepth) % kSlots][tid] = kr < s1 ? rows.row(b, kr) : 0;
    }
    sc = scales_of(t + 1);         // this thread's own row_at entry
    const unsigned char* st = ring + (t % kDepth) * L::kStage;
#pragma unroll
    for (int u = 0; u < kCopies; ++u) {
      const int i = tid + u * kThreads;
      const int r = i / (2 * kC), c = i % (2 * kC);
      const bool is_v = c >= kC;
      const int cc = is_v ? c - kC : c;
      store_bf16<S>(
          *reinterpret_cast<const uint4*>(st + (is_v ? kBK * L::kRow : 0) +
                                          r * L::kRow + cc * 16),
          reinterpret_cast<uint4*>((is_v ? vt + r * M::kVS
                                         : kt + r * M::kKS) + cc * 16));
    }
    __syncthreads();   // the bf16 tile, its scales, row_at of t + kDepth
    fetch(t + kDepth);             // into the stage just converted
    decode_mma_tile<D, D, true>(qs, kt, vt, ps, tmax, ksc, vsc,
                                s0 + t * kBK, s1, scale, scale_l2, m, l, o);
  }
  cp_async_wait<0>();   // only empty groups remain
  decode_mma_finish<D, D>(lsum, m, l, o, o_part, m_part, l_part,
                          group_part(grp, hq, hkv, num_splits), g_count);
}

// The shared memory of a tensor-core split block over storage type S
// (bf16: decode_split_mma_kernel; 1-byte: its quantized sibling).
template <typename S, int DK, int DV, int kDepth>
constexpr size_t mma_smem_bytes() {
  if constexpr (std::is_same<S, bf16>::value) {
    return DecodeMmaSmem<DK, DV, kDepth>::kBytes;
  } else {
    static_assert(DK == DV, "the quantized kernel is square");
    return QuantDecodeMmaSmem<DK, kDepth>::kBytes;
  }
}

// A launch of the tensor-core split kernel over storage type S at this
// depth and its combine; `a` is a DecodeLaunch or DecodePipelinedLaunch.
template <typename S, int DK, int DV, int kDepth, typename Rows,
          typename Launch>
int launch_split_mma(const Launch& a) {
  constexpr size_t smem = mma_smem_bytes<S, DK, DV, kDepth>();
  constexpr bool kBf16 = std::is_same<S, bf16>::value;
  cudaError_t err;
  if constexpr (kBf16) {
    err = allow_dynamic_smem(decode_split_mma_kernel<DK, DV, kDepth, Rows>,
                             smem);
  } else {
    err = allow_dynamic_smem(
        decode_split_quant_mma_kernel<S, DK, kDepth, Rows>, smem);
  }
  if (err != cudaSuccess) {   // a ring too deep for this block
    cudaGetLastError();       // not left for the next launch's check
    return static_cast<int>(err);
  }
  const dim3 grid(a.num_splits, a.hkv * group_blocks(a.hq, a.hkv), a.b);
  if constexpr (kBf16) {
    decode_split_mma_kernel<DK, DV, kDepth, Rows>
        <<<grid, kThreads, smem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), a.kv_len,
        static_cast<float*>(a.o_part), static_cast<float*>(a.m_part),
        static_cast<float*>(a.l_part), a.rows, a.s_len, a.hq, a.hkv,
        a.num_splits, a.split_size);
  } else {
    decode_split_quant_mma_kernel<S, DK, kDepth, Rows>
        <<<grid, kThreads, smem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const S*>(a.k),
        static_cast<const S*>(a.v), static_cast<const __half*>(a.k_scale),
        static_cast<const __half*>(a.v_scale), a.kv_len,
        static_cast<float*>(a.o_part), static_cast<float*>(a.m_part),
        static_cast<float*>(a.l_part), a.rows, a.s_len, a.hq, a.hkv,
        a.num_splits, a.split_size);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return a.out ? launch_combine<bf16>(a, DV) : 0;   // null: partials only
}

// bf16 queries run the tensor-core kernels, over a bf16 or a 1-byte
// cache; f32 (the parity dtype) the CUDA-core kernels.
template <typename T>
constexpr bool kMmaPath = std::is_same<T, __nv_bfloat16>::value;

// The (Dk, Dv) pairs K2 and K3 are built for: the dense decoder's square
// head dims, the hybrid family's 80 (zamba2's shared attention block),
// MLA's absorbed decode (kv_lora + qk_rope = 576 against kv_lora 512, one
// latent KV head) and the reduced MLA config's (32 + 8 against 32).
using SplitDims = DimList<Dims<16, 16>, Dims<32, 32>, Dims<64, 64>,
                          Dims<80, 80>, Dims<128, 128>, Dims<576, 512>,
                          Dims<40, 32>>;

template <typename Rows>
struct DecodeLaunch {
  const void *q, *k, *v, *k_scale, *v_scale;   // scales null for float K/V
  const int* kv_len;
  void *o_part, *m_part, *l_part, *out;
  Rows rows;
  int b, s_len, hq, hkv, num_splits, split_size;
  cudaStream_t stream;

  template <typename T, typename S, int DK, int DV>
  int run() const {
    if constexpr (kMmaPath<T>) {
      return launch_split_mma<S, DK, DV, 1, Rows>(*this);
    } else {
      const size_t smem = SplitSmem<kQuantized<T, S>, DK, DV>::kBytes;
      cudaError_t err =
          allow_dynamic_smem(decode_split_kernel<T, S, DK, DV, Rows>, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      decode_split_kernel<T, S, DK, DV, Rows>
          <<<dim3(num_splits, hkv * group_blocks(hq, hkv), b), kThreads,
             smem, stream>>>(
          static_cast<const T*>(q), static_cast<const S*>(k),
          static_cast<const S*>(v), static_cast<const __half*>(k_scale),
          static_cast<const __half*>(v_scale), kv_len,
          static_cast<float*>(o_part), static_cast<float*>(m_part),
          static_cast<float*>(l_part), rows, s_len, hq, hkv, num_splits,
          split_size);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      return out ? launch_combine<T>(*this, DV) : 0;   // null: partials only
    }
  }
};

// The arguments of a combine launched alone (decode_attention_combine).
struct CombineLaunch {
  const void *o_part, *m_part, *l_part;
  void* out;
  int b, hq, hkv, num_splits;
  cudaStream_t stream;
};

// ------------------------------------------------------ K5, K6 and K9

// Shared memory of decode_split_pipelined_kernel, in bytes: the ring of
// kDepth stages (RingTile: a tile's raw K and V rows), then in f32 the
// [kGMax][DK] query tile, the [kGMax][kBK] probabilities, the per-head
// rescale and the tile's k- and v-scales; then the slab index of each row
// of kDepth + 1 tiles (size_t).  ``pipelined_smem`` in
// kernels/decode_attention/ops.py computes the same sizes;
// decode_attention_fwd_pipelined_smem reports these, and the card tests
// hold the two equal.
template <typename S, int DK, int DV, int kDepth>
struct SplitRingSmem {
  using R = RingTile<S, DK, DV>;
  static constexpr size_t kQs = static_cast<size_t>(kDepth) * R::kBytes;
  static constexpr size_t kPs = kQs + kGMax * DK * sizeof(float);
  static constexpr size_t kCs = kPs + kGMax * kBK * sizeof(float);
  static constexpr size_t kKsc = kCs + kGMax * sizeof(float);
  static constexpr size_t kVsc = kKsc + kBK * sizeof(float);
  static constexpr size_t kRowAt = (kVsc + kBK * sizeof(float) + 7) / 8 * 8;
  static constexpr size_t kBytes =
      kRowAt + static_cast<size_t>(kDepth + 1) * kBK * sizeof(size_t);
};

// decode_split_kernel with its KV tiles staged through a kDepth-stage
// cp.async ring: K5 (ContiguousRows), K6 (PagedRows) and K9 (PagedRows,
// quantized S).  Grid, split plan, scores, online softmax, scale
// placement and P.V are decode_split_kernel's, in its order (k rows read
// through ring_dot, v widened where read), so the partials (and, through
// the shared combine kernel, the output) equal K2's, K3's and K8's bit for
// bit.  The slab indices of kDepth + 1 tiles are held (a tile's addresses
// are needed when its copy starts, kDepth - 1 tiles ahead); a row at or
// past s1 is never loaded and its table entry never read.  The f16 scales
// (2 bytes at a stride of Hkv * 2 bytes: too narrow for cp.async) are
// loaded into registers one tile ahead, as decode_split_kernel loads them
// ahead of its values.
template <typename T, typename S, int DK, int DV, int kDepth, typename Rows>
__global__ void __launch_bounds__(kThreads)
decode_split_pipelined_kernel(const T* __restrict__ q,
                              const S* __restrict__ k,
                              const S* __restrict__ v,
                              const __half* __restrict__ k_scale,
                              const __half* __restrict__ v_scale,
                              const int* __restrict__ kv_len,
                              float* __restrict__ o_part,
                              float* __restrict__ m_part,
                              float* __restrict__ l_part, Rows rows,
                              int s_len, int hq, int hkv, int num_splits,
                              int split_size) {
  constexpr bool kQuant = kQuantized<T, S>;
  static_assert(kDepth >= 2, "depth 1 is decode_split_kernel");
  static_assert(!kQuant || DK == DV, "the quantized kernel is square");
  static_assert(kGMax * DV % kThreads == 0, "heads x DV split evenly");
  constexpr int kAcc = kGMax * DV / kThreads;  // accumulator slots per thread
  constexpr int kSlots = kDepth + 1;           // tiles of row_at
  using R = RingTile<S, DK, DV>;
  using L = SplitRingSmem<S, DK, DV, kDepth>;
  extern __shared__ __align__(16) float smem[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem);
  float (*qs)[DK] = reinterpret_cast<float (*)[DK]>(ring + L::kQs);
  float (*ps)[kBK] = reinterpret_cast<float (*)[kBK]>(ring + L::kPs);
  float* cs = reinterpret_cast<float*>(ring + L::kCs);
  float* ksc = reinterpret_cast<float*>(ring + L::kKsc);
  float* vsc = reinterpret_cast<float*>(ring + L::kVsc);
  size_t (*row_at)[kBK] = reinterpret_cast<size_t (*)[kBK]>(ring + L::kRowAt);

  const int split = blockIdx.x;
  const int b = blockIdx.z;
  const QueryGroup grp = query_group(hq, hkv);
  const int hk = grp.hk;
  const int g_count = grp.count;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t part = group_part(grp, hq, hkv, num_splits);

  const int kvl = max(0, min(kv_len[b], s_len));
  const int s0 = split * split_size;
  const int s1 = min(s0 + split_size, kvl);
  if (s1 <= s0) {
    for (int i = tid; i < g_count * DV; i += kThreads) o_part[part * DV + i] = 0.f;
    for (int g = tid; g < g_count; g += kThreads) {
      m_part[part + g] = kNegInf;
      l_part[part + g] = 0.f;
    }
    return;
  }
  const int n_tiles = (s1 - s0 + kBK - 1) / kBK;

  // rows of tiles 0 .. kDepth - 1
  if (tid < kBK) {
#pragma unroll
    for (int i = 0; i < kDepth; ++i) {
      const int kr = s0 + i * kBK + tid;
      row_at[i][tid] = kr < s1 ? rows.row(b, kr) : 0;
    }
  }
  const float sqrt_d = sqrtf(static_cast<float>(DK));
  {
    constexpr int kV = 16 / sizeof(T), kQW = DK / kV;
    for (int i = tid; i < g_count * kQW; i += kThreads) {
      const int g = i / kQW, c = (i % kQW) * kV;
      float qx[kV];
      unpack16<T>(__ldg(reinterpret_cast<const uint4*>(
                      q + (group_q_row(grp, hq, hkv) + g) * DK + c)),
                  qx);
#pragma unroll
      for (int u = 0; u < kV; ++u)   // quantized: 1/sqrt(D) after ks
        qs[g][c + u] = kQuant ? qx[u] : qx[u] / sqrt_d;
    }
  }
  __syncthreads();   // row_at of the first kDepth tiles

  // tile `tile` into its stage, then a commit: a tile past the last
  // commits an empty group, so that every iteration waits for the same
  // number of pending groups
  const auto fetch = [&](int tile) {
    if (tile < n_tiles) {
      const int k0 = s0 + tile * kBK;
      const size_t* at = row_at[tile % kSlots];
      fetch_kv_tile<S, DK, DV, kThreads>(
          k, v, ring + (tile % kDepth) * R::kBytes, [&](int r) -> long long {
            return k0 + r < s1 ? static_cast<long long>(at[r] * hkv + hk)
                               : -1;
          });
    }
    cp_async_commit();
  };
  for (int i = 0; i < kDepth - 1; ++i) fetch(i);

  // the scales of tile 0, in registers until its iteration
  float k_sc = 0.f, v_sc = 0.f;
  if constexpr (kQuant) {
    if (tid < kBK && s0 + tid < s1) {
      const size_t off = row_at[0][tid] * hkv + hk;
      k_sc = to_float(k_scale[off]);
      v_sc = to_float(v_scale[off]);
    }
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kAcc];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = s0 + t * kBK;
    cp_async_wait<kDepth - 2>();   // this thread's copies of tile t landed
    // every thread's; tile t - 1, ps, cs and the scales consumed; row_at
    // of tile t + kDepth - 1 written
    __syncthreads();
    fetch(t + kDepth - 1);         // into the stage tile t - 1 left
    if (tid < kBK) {
      if constexpr (kQuant) {
        ksc[tid] = k_sc;
        vsc[tid] = v_sc;
        // the next tile's scales, one tile ahead
        const int kr = k0 + kBK + tid;
        k_sc = v_sc = 0.f;
        if (kr < s1) {
          const size_t off = row_at[(t + 1) % kSlots][tid] * hkv + hk;
          k_sc = to_float(k_scale[off]);
          v_sc = to_float(v_scale[off]);
        }
      }
      // rows of tile t + kDepth (fetched next iteration), in the slot tile
      // t - 1 left
      const int kr = k0 + kDepth * kBK + tid;
      row_at[(t + kDepth) % kSlots][tid] = kr < s1 ? rows.row(b, kr) : 0;
    }
    __syncthreads();   // the tile's scales
    const unsigned char* stage = ring + (t % kDepth) * R::kBytes;
    const S* vt = reinterpret_cast<const S*>(stage + R::kVOff);

    const bool ok = k0 + lane < s1;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int g = warp + kWarps * rr;
      if (g < g_count) {               // uniform across the warp
        float s = ring_dot<S, DK>(qs[g], stage + lane * R::kKRow);
        if constexpr (kQuant) s = s * ksc[lane] / sqrt_d;
        s = ok ? s : kNegInf;
        const float m_new = fmaxf(m[rr], warp_max(s));
        const float p = ok ? expf(s - m_new) : 0.f;
        const float corr = expf(m[rr] - m_new);
        l[rr] = l[rr] * corr + warp_sum(p);   // l sums the unscaled p
        m[rr] = m_new;
        ps[g][lane] = kQuant ? p * vsc[lane] : p;
        if (lane == 0) cs[g] = corr;
      }
    }
    __syncthreads();   // ps and cs rows come from every warp

#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int idx = tid + kThreads * j;
      const int g = idx / DV, c = idx % DV;
      if (g < g_count) {
        float a = acc[j] * cs[g];
#pragma unroll 8
        for (int u = 0; u < kBK; ++u) a += ps[g][u] * to_float(vt[u * DV + c]);
        acc[j] = a;
      }
    }
  }
  cp_async_wait<0>();   // only empty groups remain

#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int idx = tid + kThreads * j;
    if (idx / DV < g_count) o_part[part * DV + idx] = acc[j];
  }
  if (lane == 0) {
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int g = warp + kWarps * rr;
      if (g < g_count) {
        m_part[part + g] = m[rr];
        l_part[part + g] = l[rr];
      }
    }
  }
}

template <typename Rows>
struct DecodePipelinedLaunch {
  const void *q, *k, *v, *k_scale, *v_scale;   // scales null for float K/V
  const int* kv_len;
  void *o_part, *m_part, *l_part, *out;
  Rows rows;
  int b, s_len, hq, hkv, num_splits, split_size, depth;
  cudaStream_t stream;

  template <typename T, typename S, int DK, int DV, int kDepth>
  int launch() const {
    if constexpr (kMmaPath<T>) {
      return launch_split_mma<S, DK, DV, kDepth, Rows>(*this);
    } else {
      return launch_cuda_cores<T, S, DK, DV, kDepth>();
    }
  }

  template <typename T, typename S, int DK, int DV, int kDepth>
  int launch_cuda_cores() const {
    const size_t smem = SplitRingSmem<S, DK, DV, kDepth>::kBytes;
    cudaError_t err = allow_dynamic_smem(
        decode_split_pipelined_kernel<T, S, DK, DV, kDepth, Rows>, smem);
    if (err != cudaSuccess) {   // a ring too deep for this block
      cudaGetLastError();       // not left for the next launch's check
      return static_cast<int>(err);
    }
    decode_split_pipelined_kernel<T, S, DK, DV, kDepth, Rows>
        <<<dim3(num_splits, hkv * group_blocks(hq, hkv), b), kThreads, smem,
           stream>>>(
        static_cast<const T*>(q), static_cast<const S*>(k),
        static_cast<const S*>(v), static_cast<const __half*>(k_scale),
        static_cast<const __half*>(v_scale), kv_len,
        static_cast<float*>(o_part), static_cast<float*>(m_part),
        static_cast<float*>(l_part), rows, s_len, hq, hkv, num_splits,
        split_size);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    return launch_combine<T>(*this, DV);
  }

  template <typename T, typename S, int DK, int DV>
  int run() const {
    if (depth == 2) return launch<T, S, DK, DV, 2>();
    if (depth == 4) return launch<T, S, DK, DV, 4>();
    return kUnsupported;
  }
};

// The bytes of shared memory a K5 / K6 / K9 block of this depth takes.
struct SplitRingBytes {
  int depth;
  long long* bytes;

  template <typename T, typename S, int DK, int DV, int kDepth>
  static constexpr size_t of() {
    if constexpr (kMmaPath<T>) {
      return mma_smem_bytes<S, DK, DV, kDepth>();
    } else {
      return SplitRingSmem<S, DK, DV, kDepth>::kBytes;
    }
  }

  template <typename T, typename S, int DK, int DV>
  int run() const {
    if (depth == 2) {
      *bytes = of<T, S, DK, DV, 2>();
    } else if (depth == 4) {
      *bytes = of<T, S, DK, DV, 4>();
    } else {
      return kUnsupported;
    }
    return 0;
  }
};

}  // namespace
}  // namespace repro

// q [B, Hq, Dk], k [B, S, Hkv, Dk], v [B, S, Hkv, Dv], out [B, Hq, Dv]
// (all of dtype `dtype`, contiguous); (dk, dv) a pair of SplitDims; kv_len
// device int32 [B].  Scratch: o_part [B, Hkv, splits, G, Dv], m_part and
// l_part [B, Hkv, splits, G], all f32.
// Split j covers cache rows [j * split_size, (j + 1) * split_size).
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* kv_len, void* o_part,
                                    void* m_part, void* l_part, void* out,
                                    int b, int s_len, int hq, int hkv, int dk,
                                    int dv, int num_splits, int split_size,
                                    int dtype, void* stream) {
  if (hkv <= 0 || hq % hkv != 0)
    return repro::kUnsupported;
  const repro::DecodeLaunch<repro::ContiguousRows> launch{
      q, k, v, nullptr, nullptr, static_cast<const int*>(kv_len), o_part,
      m_part, l_part, out, repro::ContiguousRows{s_len}, b, s_len, hq, hkv,
      num_splits, split_size, static_cast<cudaStream_t>(stream)};
  return repro::dispatch_dtype_dims<repro::SplitDims>(dtype, dk, dv, launch);
}

// K2's split kernel alone (depth 1, contiguous rows): the arguments of
// decode_attention_fwd without `out`.  It writes the partials o_part
// [B, Hkv, splits, G, Dv] (unnormalized), m_part and l_part [B, Hkv,
// splits, G] (f32) and launches no combine, so that the partials of
// several row blocks (the blocks of a sequence-sharded cache, one per
// rank) can be combined as more splits by decode_attention_combine.
extern "C" int decode_attention_fwd_partials(
    const void* q, const void* k, const void* v, const void* kv_len,
    void* o_part, void* m_part, void* l_part, int b, int s_len, int hq,
    int hkv, int dk, int dv, int num_splits, int split_size, int dtype,
    void* stream) {
  return decode_attention_fwd(q, k, v, kv_len, o_part, m_part, l_part,
                              nullptr, b, s_len, hq, hkv, dk, dv, num_splits,
                              split_size, dtype, stream);
}

// K2's combine kernel alone over partials laid out as the split kernel
// writes them, with any split count: out [B, Hq, dv] of dtype `dtype`
// (f32 or bf16) = sum_s w_s o_s / max(sum_s w_s l_s, 1e-30), w_s =
// exp(m_s - max_s m_s), summed in split order.
extern "C" int decode_attention_combine(const void* o_part,
                                        const void* m_part,
                                        const void* l_part, void* out, int b,
                                        int hq, int hkv, int num_splits,
                                        int dv, int dtype, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || num_splits <= 0 || dv <= 0)
    return repro::kUnsupported;
  const repro::CombineLaunch launch{o_part, m_part, l_part, out, b, hq, hkv,
                                    num_splits,
                                    static_cast<cudaStream_t>(stream)};
  if (dtype == repro::kFloat32)
    return repro::launch_combine<float>(launch, dv);
  if (dtype == repro::kBFloat16)
    return repro::launch_combine<__nv_bfloat16>(launch, dv);
  return repro::kUnsupported;
}

// K3.  q [B, Hq, Dk], k_pool [Np, ps, Hkv, Dk], v_pool [Np, ps, Hkv, Dv],
// out [B, Hq, Dv]
// (all of dtype `dtype`, contiguous); page_table device int32 [B, P] with
// entries in [0, Np); kv_len device int32 [B], clamped to P * ps.  Scratch
// as for K2.  Split j covers logical rows [j * split_size,
// (j + 1) * split_size) of the P * ps rows a page table row maps.
extern "C" int paged_decode_attention_fwd(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* kv_len, void* o_part, void* m_part,
    void* l_part, void* out, int b, int pages, int page_size, int hq, int hkv,
    int dk, int dv, int num_splits, int split_size, int dtype, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || page_size <= 0)
    return repro::kUnsupported;
  const repro::DecodeLaunch<repro::PagedRows> launch{
      q, k_pool, v_pool, nullptr, nullptr, static_cast<const int*>(kv_len),
      o_part, m_part, l_part, out,
      repro::PagedRows{static_cast<const int*>(page_table), pages, page_size},
      b, pages * page_size, hq, hkv, num_splits, split_size,
      static_cast<cudaStream_t>(stream)};
  return repro::dispatch_dtype_dims<repro::SplitDims>(dtype, dk, dv, launch);
}

// K7.  K2 over a quantized cache: k and v [B, S, Hkv, D] of storage dtype
// `store` (int8 or fp8 e4m3), k_scale and v_scale [B, S, Hkv, 1] f16; q
// and out [B, Hq, D] of dtype `dtype`.  Everything else as for K2.
extern "C" int decode_attention_fwd_quantized(
    const void* q, const void* k, const void* k_scale, const void* v,
    const void* v_scale, const void* kv_len, void* o_part, void* m_part,
    void* l_part, void* out, int b, int s_len, int hq, int hkv, int d,
    int num_splits, int split_size, int dtype, int store, void* stream) {
  if (hkv <= 0 || hq % hkv != 0)
    return repro::kUnsupported;
  const repro::DecodeLaunch<repro::ContiguousRows> launch{
      q, k, v, k_scale, v_scale, static_cast<const int*>(kv_len), o_part,
      m_part, l_part, out, repro::ContiguousRows{s_len}, b, s_len, hq, hkv,
      num_splits, split_size, static_cast<cudaStream_t>(stream)};
  return repro::dispatch_quant(dtype, store, d, launch);
}

// K8.  K3 over quantized pages: k_pool and v_pool [Np, ps, Hkv, D] of
// storage dtype `store`, k_scale and v_scale [Np, ps, Hkv, 1] f16 scale
// pages named by the same page table.  Everything else as for K3.
extern "C" int paged_decode_attention_fwd_quantized(
    const void* q, const void* k_pool, const void* k_scale,
    const void* v_pool, const void* v_scale, const void* page_table,
    const void* kv_len, void* o_part, void* m_part, void* l_part, void* out,
    int b, int pages, int page_size, int hq, int hkv, int d, int num_splits,
    int split_size, int dtype, int store, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || page_size <= 0)
    return repro::kUnsupported;
  const repro::DecodeLaunch<repro::PagedRows> launch{
      q, k_pool, v_pool, k_scale, v_scale, static_cast<const int*>(kv_len),
      o_part, m_part, l_part, out,
      repro::PagedRows{static_cast<const int*>(page_table), pages, page_size},
      b, pages * page_size, hq, hkv, num_splits, split_size,
      static_cast<cudaStream_t>(stream)};
  return repro::dispatch_quant(dtype, store, d, launch);
}

// K5.  K2 with a `num_buffers`-stage KV ring inside each split (2 or 4;
// anything else is unsupported, and a depth whose ring does not fit the
// block's shared memory fails to launch).  Arguments as for K2; at the
// same split plan the output equals K2's bit for bit.
extern "C" int decode_attention_fwd_pipelined(
    const void* q, const void* k, const void* v, const void* kv_len,
    void* o_part, void* m_part, void* l_part, void* out, int b, int s_len,
    int hq, int hkv, int dk, int dv, int num_splits, int split_size,
    int num_buffers, int dtype, void* stream) {
  if (hkv <= 0 || hq % hkv != 0)
    return repro::kUnsupported;
  const repro::DecodePipelinedLaunch<repro::ContiguousRows> launch{
      q, k, v, nullptr, nullptr, static_cast<const int*>(kv_len), o_part,
      m_part, l_part, out, repro::ContiguousRows{s_len}, b, s_len, hq, hkv,
      num_splits, split_size, num_buffers, static_cast<cudaStream_t>(stream)};
  return repro::dispatch_dtype_dims<repro::SplitDims>(dtype, dk, dv, launch);
}

// K6.  K3 with the ring (depths as for K5).  Arguments as for K3; the
// output equals K3's bit for bit, whatever the page placement.
extern "C" int paged_decode_attention_fwd_pipelined(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* kv_len, void* o_part, void* m_part,
    void* l_part, void* out, int b, int pages, int page_size, int hq, int hkv,
    int dk, int dv, int num_splits, int split_size, int num_buffers,
    int dtype, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || page_size <= 0)
    return repro::kUnsupported;
  const repro::DecodePipelinedLaunch<repro::PagedRows> launch{
      q, k_pool, v_pool, nullptr, nullptr, static_cast<const int*>(kv_len),
      o_part, m_part, l_part, out,
      repro::PagedRows{static_cast<const int*>(page_table), pages, page_size},
      b, pages * page_size, hq, hkv, num_splits, split_size, num_buffers,
      static_cast<cudaStream_t>(stream)};
  return repro::dispatch_dtype_dims<repro::SplitDims>(dtype, dk, dv, launch);
}

// K9.  K8 with the ring (depths as for K5): the values through cp.async
// (k_pool and v_pool 16-byte aligned), the f16 scales into registers one
// tile ahead.  Arguments as for K8; the output equals K8's bit for bit.
extern "C" int paged_decode_attention_fwd_quantized_pipelined(
    const void* q, const void* k_pool, const void* k_scale,
    const void* v_pool, const void* v_scale, const void* page_table,
    const void* kv_len, void* o_part, void* m_part, void* l_part, void* out,
    int b, int pages, int page_size, int hq, int hkv, int d, int num_splits,
    int split_size, int num_buffers, int dtype, int store, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || page_size <= 0)
    return repro::kUnsupported;
  const repro::DecodePipelinedLaunch<repro::PagedRows> launch{
      q, k_pool, v_pool, k_scale, v_scale, static_cast<const int*>(kv_len),
      o_part, m_part, l_part, out,
      repro::PagedRows{static_cast<const int*>(page_table), pages, page_size},
      b, pages * page_size, hq, hkv, num_splits, split_size, num_buffers,
      static_cast<cudaStream_t>(stream)};
  return repro::dispatch_quant(dtype, store, d, launch);
}

// The shared memory of one K5 / K6 block (store < 0: a float cache of
// `dtype`) or K9 block (int8 or fp8 `store`, square) at this (dk, dv) and
// depth (SplitRingSmem), into *bytes: what ``pipelined_smem`` in
// kernels/decode_attention/ops.py fits the depth against.
extern "C" int decode_attention_fwd_pipelined_smem(int dk, int dv,
                                                   int num_buffers, int dtype,
                                                   int store,
                                                   long long* bytes) {
  const repro::SplitRingBytes query{num_buffers, bytes};
  if (store < 0)
    return repro::dispatch_dtype_dims<repro::SplitDims>(dtype, dk, dv, query);
  if (dk != dv) return repro::kUnsupported;
  return repro::dispatch_quant(dtype, store, dk, query);
}

extern "C" const char* repro_error_string(int code) {
  return repro::error_string(code);
}
