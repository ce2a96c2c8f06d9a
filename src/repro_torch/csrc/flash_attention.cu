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
// that is bound by bytes.  Two paths, picked by the dtype: bf16 (the
// model's serve and train dtype) runs both products on the tensor cores,
// fa_fwd_mma_kernel ("bf16 on the tensor cores" below); f32, the parity
// dtype the card-vs-CPU checks hold to 1e-4, keeps the first version,
// fa_fwd_kernel, whose products run on the CUDA cores in f32, so that
// arithmetic and shared-memory traffic bound it.
//
// Design of the f32 kernel: one block of 128 threads per (16-query tile,
// query head, batch row).  The TPU's sequential KV grid axis becomes a loop
// inside the block over 32-row KV tiles staged in shared memory as f32; m, l
// and the [16, D] accumulator stay on chip for the whole loop, so only O and
// lse are written to device memory.  The loop ends at the last KV row any
// query of the tile can see (causal diagonal and kv_len), so the max_len
// cache behind a short prefill is never read.  Each warp owns 4 query rows:
// lane j scores KV row j of the tile, row max and row sum are warp shuffles,
// and in the P.V product lanes walk consecutive head-dim columns.  Unlike the
// Pallas kernel, the query alignment (q_offset) and the valid KV length
// (kv_len, scalar or per row) are arguments.
//
// K1 is templated on (Dk, Dv): q and k have Dk columns, v and the output
// Dv (FwdDims: the dense decoder's square head dims, MLA's prefill with
// qk_nope + qk_rope = 192 against v_head_dim 128, and the reduced MLA
// config's 24 / 16).  The score loop runs over Dk columns per lane (one
// KV row a lane), so Dk need not be a multiple of 32; the accumulator
// spreads a warp's 4 rows x Dv over its lanes (Dv % 8 == 0).  The tiles
// live in dynamic shared memory (FwdSmem): 43 KB at 128 / 128 and 56 KB at
// 192 / 128, past the 48 KB a block gets without opting in.
//
// K10 replaces flash_attention_fwd_quantized / _fa_quant_kernel (same
// file): K1 over int8 or fp8 e4m3 K/V with one f16 scale per (cache row,
// KV head).  The k-scale multiplies each score column after q.k and
// before 1/sqrt(D), the v-scale multiplies p only inside the p.v product,
// and l sums the unscaled p.  It keeps K1's kv_len and q_offset, which
// the Pallas K10 lacks (it aligns the queries at Skv - Sq).  Two paths,
// by the query's dtype, as K1's: bf16 runs fa_fwd_quant_mma_kernel (below,
// "bf16 on the tensor cores"): K1's tensor-core block and per-tile
// arithmetic on a bf16 tile that the block converts from the 1-byte tile
// a 2-stage cp.async ring brought.  f32 keeps K1's CUDA-core kernel with
// the other value format (kQuantized<T, S>, common.cuh): the tile's values
// are read four to a 32-bit load and converted to f32 in shared memory,
// its 32 k- and v-scales loaded once beside them (requested before the
// values).
//
// K11 replaces flash_attention_bwd (same file; _fa_bwd_dq_kernel and
// _fa_bwd_dkv_kernel): the flash backward with recompute from lse, for
// every KV row valid and the suffix alignment Skv - Sq (causal or not),
// templated on K1's (Dk, Dv) pairs (MLA's prefill trains at 192 / 128).
// With qs = q / sqrt(Dk): dd = rowsum(do * out) over Dv, p = exp(qs.k -
// lse) (exactly 0 where masked, so a row that sees no KV row adds
// nothing), ds = p * (do.v - dd); dv = p^T do, dk = ds^T qs, dq = ds k /
// sqrt(Dk).  q, k, dq and dk are Dk wide (24 is zero-padded to 32 in the
// bf16 tiles), v, do, out and dv Dv wide.
//
// What bounds it on the H100: five products of 2 * S^2 * D / 2 flops per
// head under the causal mask (about 21.5 GFLOP at B=2, S=1024, Hq=16,
// D=128) against about 40 MB of inputs and outputs: operations, by far,
// even at the tensor cores' rate.  In bf16 both passes run their products
// on the tensor cores (fa_bwd_dq_mma_kernel, fa_bwd_dkv_mma_kernel below:
// 64-row tiles, seven products in all, since each pass recomputes S and
// dP); f32 keeps the first version below, on the CUDA cores.
//
// Design of the f32 kernels.  The TPU kernels carry their sums across a
// sequential grid axis in VMEM scratch; here each sum is a loop inside one
// block and nothing crosses blocks, so the gradients are the same from run
// to run (no atomics):
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
//
// K4 replaces flash_attention_fwd_pipelined / _fa_pipelined_kernel (same
// file), which leaves K/V in HBM and walks the KV blocks of a query block
// through an explicit `num_buffers`-slot DMA ring.  K1 and K4 are one bf16
// kernel, fa_fwd_mma_kernel, templated on the ring depth (1 for K1; 2 and
// 4 for K4), so every depth gives the same bits: at (128, 128) a block
// takes 17 KB of query tile and 34 KB a stage, at (192, 128) depth 4 193
// KB.  The wrapper fits the depth to the 227 KB a block may use.  f32, the
// parity dtype, has no ring: its K1 (fa_fwd_kernel) runs at depth 1, and
// an f32 K4 call is unsupported.  The bf16 forward's tile (query rows BQ,
// KV rows BK) is a template argument too, the caller's choice among the
// built tiles (fwd_tile_built; the analytic pick is 64 x 64).

#include "common.cuh"

#include <algorithm>
#include <cmath>

namespace repro {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 16;                    // query rows per block
constexpr int kBK = 32;                    // KV rows per tile: one per lane
constexpr int kRowsPerWarp = kBQ / kWarps;

// Shared memory of fa_fwd_kernel, in floats: the [kBQ][DK] query tile,
// the [kBK][kKStride] K tile (rows padded so that lane j's reads of row j
// are conflict-free: +1 for the float kernels' column reads; +4 keeps the
// quantized kernels' float4 reads conflict-free and 16-byte aligned), the
// [kBK][DV] V tile, the [kBQ][kBK] probabilities, the per-row rescale and
// denominators, and the tile's k- and v-scales (quantized).
template <bool kQuant, int DK, int DV>
struct FwdSmem {
  static constexpr int kKStride = kQuant ? DK + 4 : DK + 1;
  static constexpr int kQs = 0;
  static constexpr int kKs = kQs + kBQ * DK;
  static constexpr int kVs = kKs + kBK * kKStride;
  static constexpr int kPs = kVs + kBK * DV;
  static constexpr int kCs = kPs + kBQ * kBK;
  static constexpr int kLs = kCs + kBQ;
  static constexpr int kKsc = kLs + kBQ;
  static constexpr int kVsc = kKsc + kBK;
  static constexpr size_t kBytes = (kVsc + kBK) * sizeof(float);
};

// T: the query's dtype; S: the K/V storage dtype (T itself, or int8_t /
// __nv_fp8_e4m3 with the f16 scales k_scale / v_scale, null otherwise).
// DK: the width of q and k; DV: that of v and of the output.
template <typename T, typename S, int DK, int DV>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const T* __restrict__ q, const S* __restrict__ k,
              const S* __restrict__ v, const __half* __restrict__ k_scale,
              const __half* __restrict__ v_scale, T* __restrict__ out,
              float* __restrict__ lse, const int* __restrict__ kv_len_rows,
              int kv_len_all, int sq, int skv, int hq, int hkv, int q_offset,
              int causal) {
  constexpr bool kQuant = kQuantized<T, S>;
  static_assert(!kQuant || DK == DV, "the quantized kernel is square");
  static_assert(DV % 8 == 0, "a warp's rows x DV split evenly over lanes");
  constexpr int kAcc = kRowsPerWarp * DV / 32;  // accumulator slots per lane
  using L = FwdSmem<kQuant, DK, DV>;
  constexpr int kKStride = L::kKStride;
  extern __shared__ __align__(16) float smem[];
  float (*qs)[DK] = reinterpret_cast<float (*)[DK]>(smem + L::kQs);
  float (*ks)[kKStride] = reinterpret_cast<float (*)[kKStride]>(smem + L::kKs);
  float (*vs)[DV] = reinterpret_cast<float (*)[DV]>(smem + L::kVs);
  float (*ps)[kBK] = reinterpret_cast<float (*)[kBK]>(smem + L::kPs);
  float* cs = smem + L::kCs;      // per-row rescale of the accumulator
  float* ls = smem + L::kLs;      // final per-row softmax denominators
  float* ksc = smem + L::kKsc;    // the tile's scales (quantized)
  float* vsc = smem + L::kVsc;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const float sqrt_d = sqrtf(static_cast<float>(DK));

  int kvl = kv_len_rows != nullptr ? kv_len_rows[b] : kv_len_all;
  kvl = max(0, min(kvl, skv));
  // exclusive end of the KV rows any query of this tile can see
  int kv_end = kvl;
  if (causal) kv_end = min(kv_end, max(0, q_offset + min(q0 + kBQ, sq)));

  {
    // the query tile, 16 bytes a load (DK * sizeof(T) is a multiple of 16)
    constexpr int kV = 16 / sizeof(T), kQW = DK / kV;
    for (int i = tid; i < kBQ * kQW; i += kThreads) {
      const int r = i / kQW, c = (i % kQW) * kV, qi = q0 + r;
      float qx[kV] = {};
      if (qi < sq)
        unpack16<T>(__ldg(reinterpret_cast<const uint4*>(
                        q + (static_cast<size_t>(b) * sq + qi) * hq * DK +
                        static_cast<size_t>(h) * DK + c)),
                    qx);
#pragma unroll
      for (int u = 0; u < kV; ++u)   // quantized: 1/sqrt(D) after ks
        qs[r][c + u] = kQuant ? qx[u] : qx[u] / sqrt_d;
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
      constexpr int kWords = DK / 4;
      for (int i = tid; i < kBK * kWords; i += kThreads) {
        const int r = i / kWords, c = (i % kWords) * 4, kr = k0 + r;
        float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
        if (kr < kv_end) {
          const size_t off = (static_cast<size_t>(b) * skv + kr) * hkv * DK +
                             static_cast<size_t>(hk) * DK + c;
          kx = word_to_float4<S>(*reinterpret_cast<const uint32_t*>(k + off));
          vx = word_to_float4<S>(*reinterpret_cast<const uint32_t*>(v + off));
        }
        *reinterpret_cast<float4*>(&ks[r][c]) = kx;
        *reinterpret_cast<float4*>(&vs[r][c]) = vx;
      }
    } else {
      stage_kv_rows<S, DK, DV, kThreads>(
          k, v, &ks[0][0], kKStride, &vs[0][0], [&](int r) -> long long {
            const int kr = k0 + r;
            return kr < kv_end
                       ? (static_cast<long long>(b) * skv + kr) * hkv + hk
                       : -1;
          });
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
        s = dot4<DK>(qs[r], ks[lane]) * ksc[lane] / sqrt_d;
      } else {
#pragma unroll 8
        for (int c = 0; c < DK; ++c) s += qs[r][c] * ks[lane][c];
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
      const int r = warp * kRowsPerWarp + idx / DV;
      const int c = idx % DV;
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
    const int r = warp * kRowsPerWarp + idx / DV;
    const int c = idx % DV;
    const int qi = q0 + r;
    if (qi < sq)
      out[(static_cast<size_t>(b) * sq + qi) * hq * DV +
          static_cast<size_t>(h) * DV + c] = from_float<T>(acc[j] / ls[r]);
  }
}

// ------------------------------------------------- bf16 on the tensor cores
//
// K1 / K4 (one kernel, templated on the ring depth) and K11 in bf16.  The
// products run as mma.sync m16n8k16, bf16 x bf16 -> f32, fed by ldmatrix
// from raw bf16 tiles that cp.async brings into shared memory.  With the
// fragment layouts of common.cuh ("tensor cores"), the accumulators of two
// neighbouring 8-column tiles, rounded to bf16 in pairs, are the A operand
// of the next product over those 16 columns: P (and dS) never leave
// registers.  A row-major
// tile in shared memory is the B operand of a product that contracts over
// its columns through ldmatrix (K in S = Q K^T), and of one that contracts
// over its rows through ldmatrix.trans (V in O += P V).  Every tile row is
// padded by 16 bytes, so that the 8 row addresses of each ldmatrix fall in
// distinct banks.

constexpr int kMBQ = 64;     // query rows of a tensor-core block, 16 a warp
constexpr int kMBK = 64;     // KV rows of a tensor-core tile

// One ring stage of the bf16 forward: a [BK][DKP + 8] K tile, then a
// [BK][DV + 8] V tile, raw bf16 (DKP: Dk rounded up to the 16 of an mma
// step; Dk = 24 is zero-padded to 32, which adds nothing to a score).
// BK: the tile's KV rows (kMBK but for the forward's tuned tiles).
template <int DK, int DV, int BK = kMBK>
struct MmaTile {
  static_assert(DV % 16 == 0, "P.V takes 16 columns of v a step");
  static constexpr int kDKP = (DK + 15) / 16 * 16;
  static constexpr int kKS = kDKP + 8, kVS = DV + 8;   // row strides
  static constexpr int kKC = kDKP / 8, kVC = DV / 8;   // 16-byte chunks a row
  static constexpr int kVOff = BK * kKS;               // elements
  static constexpr int kElems = kVOff + BK * kVS;
};

// Shared memory of fa_fwd_mma_kernel, in bytes: the [BQ][DKP + 8] query
// tile, then kDepth stages of BK rows.  ``pipelined_smem`` in
// kernels/flash_attention/ops.py computes the same sizes;
// flash_attention_fwd_pipelined_smem reports these.
template <int DK, int DV, int kDepth, int BQ = kMBQ, int BK = kMBK>
struct MmaFwdSmem {
  using M = MmaTile<DK, DV, BK>;
  static constexpr size_t kQBytes = sizeof(bf16) * BQ * M::kKS;
  static constexpr size_t kBytes =
      kQBytes + sizeof(bf16) * static_cast<size_t>(kDepth) * M::kElems;
};

// The forward's tiles (query rows BQ, KV rows BK) the library builds at a
// (Dk, Dv) pair: 64 x 64 at every pair (the analytic pick, the tiles K10
// and K11 keep); at the dense decoder's (128, 128) also BQ in {16, 64,
// 128} by BK in {32, 64}.  ops.tile_options mirrors this.  BQ changes no
// sum: a warp owns 16 query rows and walks the same KV tiles in the same
// order at every BQ (a block of more rows also walks tiles past a row's
// causal diagonal, whose scores are masked to exp(-inf) = 0: they add 0
// and rescale by exp(0) = 1), so out and lse keep their bits.  BK moves
// the online softmax's rescale points and which products meet in one f32
// sum: out agrees within its bf16 rounding, lse within f32 rounding.
constexpr bool fwd_tile_built(int dk, int dv, int bq, int bk) {
  return (bq == kMBQ && bk == kMBK) ||
         (dk == 128 && dv == 128 && (bq == 16 || bq == 64 || bq == 128) &&
          (bk == 32 || bk == 64));
}

// One 64-row KV tile of the bf16 forward for a warp's 16 query rows (K1,
// K4 and K10): S = Q K^T (8 accumulator tiles of 8 KV columns), the masks
// where the tile crosses the causal diagonal or kv_len (-inf scores), the
// row max over the quad's lanes (two shuffles), m, l and the rescale in
// registers, P = exp(S / sqrt(Dk) - m) rounded to bf16 as the A operand of
// O += P V, one 16-column step at a time (its A operand is 4 registers),
// each step's products right after its exponentials; l sums the f32 p.
// kScaled (K10): each score column is multiplied by its row's k-scale
// (ksc) after Q K^T, and p by its v-scale (vsc) only where it is rounded
// for P V; l sums the unscaled p.
template <int DK, int DV, bool kScaled, int BK = kMBK>
__device__ __forceinline__ void mma_fwd_tile(
    const uint32_t (&qf)[MmaTile<DK, DV>::kDKP / 16][4],
    const bf16* __restrict__ kt, const bf16* __restrict__ vt,
    const float* __restrict__ ksc, const float* __restrict__ vsc, int k0,
    int kvl, int causal, int q_offset, int row0, float scale, float scale_l2,
    float (&m)[2], float (&l)[2], float (&o)[DV / 8][4]) {
  using M = MmaTile<DK, DV, BK>;
  constexpr int kKSteps = M::kDKP / 16;   // score mma steps over Dk
  constexpr int kON = DV / 8;             // 8-column tiles of O
  constexpr int kSN = BK / 8;             // 8-column tiles of S
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t2 = (lane % 4) * 2;
  const int fr = frag_row(lane), fc = frag_col(lane);
  const int br = brow(lane), bc = bcol(lane);

  float s[kSN][4];
#pragma unroll
  for (int n = 0; n < kSN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
    for (int nb = 0; nb < BK / 16; ++nb) {
      uint32_t kb[4];
      ldmatrix_x4(kb, kt + (nb * 16 + br) * M::kKS + ks * 16 + bc);
      mma_bf16(s[2 * nb], qf[ks], kb[0], kb[1]);
      mma_bf16(s[2 * nb + 1], qf[ks], kb[2], kb[3]);
    }
  }
  if constexpr (kScaled) {
#pragma unroll
    for (int n = 0; n < kSN; ++n) {
      const float2 kc = *reinterpret_cast<const float2*>(ksc + 8 * n + t2);
      s[n][0] *= kc.x;
      s[n][1] *= kc.y;
      s[n][2] *= kc.x;
      s[n][3] *= kc.y;
    }
  }
  // masks, only on a tile that crosses kv_len or the warp's diagonal
  if (k0 + BK > kvl || (causal && k0 + BK - 1 > q_offset + row0)) {
#pragma unroll
    for (int n = 0; n < kSN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kv = k0 + 8 * n + t2 + (e & 1);
        const int qi = row0 + g + 8 * (e >> 1);
        if (kv >= kvl || (causal && kv > q_offset + qi)) s[n][e] = -INFINITY;
      }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < kSN; ++n) {
    mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
  }
  float corr[2], ml[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i] * scale);
    corr[i] = exp2f((m[i] - m_new) * kLog2e);
    m[i] = m_new;
    ml[i] = m_new * kLog2e;
  }
#pragma unroll
  for (int n = 0; n < kON; ++n) {
    o[n][0] *= corr[0];
    o[n][1] *= corr[0];
    o[n][2] *= corr[1];
    o[n][3] *= corr[1];
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t pa[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = 2 * kk + h;
      const float p0 = exp2f(s[n][0] * scale_l2 - ml[0]);
      const float p1 = exp2f(s[n][1] * scale_l2 - ml[0]);
      const float p2 = exp2f(s[n][2] * scale_l2 - ml[1]);
      const float p3 = exp2f(s[n][3] * scale_l2 - ml[1]);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      if constexpr (kScaled) {
        const float2 vc = *reinterpret_cast<const float2*>(vsc + 8 * n + t2);
        pa[2 * h] = pack_bf16(p0 * vc.x, p1 * vc.y);
        pa[2 * h + 1] = pack_bf16(p2 * vc.x, p3 * vc.y);
      } else {
        pa[2 * h] = pack_bf16(p0, p1);
        pa[2 * h + 1] = pack_bf16(p2, p3);
      }
    }
#pragma unroll
    for (int nd = 0; nd < DV / 16; ++nd) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, vt + (kk * 16 + fr) * M::kVS + nd * 16 + fc);
      mma_bf16(o[2 * nd], pa, vb[0], vb[1]);
      mma_bf16(o[2 * nd + 1], pa, vb[2], vb[3]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];
}

// out = O / l and lse = m + log(l) for a warp's 16 query rows, written
// once (rows past sq are not written).
template <int DV>
__device__ __forceinline__ void mma_fwd_store(
    bf16* __restrict__ out, float* __restrict__ lse, const float (&m)[2],
    const float (&l)[2], const float (&o)[DV / 8][4], int b, int h, int sq,
    int hq, int row0) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t2 = (lane % 4) * 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    li = fmaxf(li, 1e-30f);
    const int qi = row0 + g + 8 * i;
    if (qi < sq) {
      if (lane % 4 == 0)
        lse[(static_cast<size_t>(b) * hq + h) * sq + qi] = m[i] + logf(li);
      bf16* orow = out + ((static_cast<size_t>(b) * sq + qi) * hq + h) * DV;
#pragma unroll
      for (int n = 0; n < DV / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + t2) =
            __floats2bfloat162_rn(o[n][2 * i] / li, o[n][2 * i + 1] / li);
    }
  }
}

// The query tile (BQ rows) of a bf16 forward block of kT threads into qs
// (rows past sq and Dk's padding as zeros), by cp.async, not committed.
template <int DK, int DV, int BQ = kMBQ, int kT = kThreads>
__device__ __forceinline__ void fetch_q_tile(const bf16* __restrict__ q,
                                             bf16* qs, int b, int q0, int h,
                                             int sq, int hq) {
  using M = MmaTile<DK, DV>;
  for (int i = threadIdx.x; i < BQ * M::kKC; i += kT) {
    const int r = i / M::kKC, c = i % M::kKC, qi = q0 + r;
    const bool live = qi < sq && c * 8 < DK;
    const size_t row =
        (static_cast<size_t>(b) * sq + min(qi, sq - 1)) * hq + h;
    cp_async16(qs + r * M::kKS + c * 8, q + row * DK + (live ? c * 8 : 0),
               live);
  }
}

// K1 (kDepth 1) and K4 (kDepth 2, 4) in bf16.  One block of BQ / 16 warps
// per (BQ-query tile, query head, batch row), the longest (last) query
// tiles first; warp w owns query rows 16 w .. 16 w + 15 and keeps their q
// fragments in registers for the whole loop.  The block walks BK-row KV
// tiles up to the last row any of its queries can see; depth 1 loads a
// tile and computes on it in turn, depth d keeps tiles t + 1 .. t + d - 1
// in flight while tile t is computed.  The arithmetic and its order are the
// same at every depth, so every depth gives the same bits; per tile and
// warp, mma_fwd_tile.  BQ and BK are the caller's choice among the built
// tiles (fwd_tile_built; 64 x 64 is the analytic pick): BQ keeps the bits,
// BK moves the rescale points.
template <int DK, int DV, int kDepth, int BQ, int BK>
__global__ void __launch_bounds__(2 * BQ)
fa_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ out,
                  float* __restrict__ lse, const int* __restrict__ kv_len_rows,
                  int kv_len_all, int sq, int skv, int hq, int hkv,
                  int q_offset, int causal) {
  using M = MmaTile<DK, DV, BK>;
  constexpr int kT = 2 * BQ;              // BQ / 16 warps
  constexpr int kKSteps = M::kDKP / 16;   // score mma steps over Dk
  constexpr int kON = DV / 8;             // 8-column tiles of O
  extern __shared__ __align__(16) unsigned char fwd_mma_smem[];
  bf16* qs = reinterpret_cast<bf16*>(fwd_mma_smem);
  bf16* ring = qs + BQ * M::kKS;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = q0 + warp * 16;        // the warp's first query row
  const float scale = 1.f / sqrtf(static_cast<float>(DK));
  const float scale_l2 = scale * kLog2e;

  int kvl = kv_len_rows != nullptr ? kv_len_rows[b] : kv_len_all;
  kvl = max(0, min(kvl, skv));
  // exclusive end of the KV rows any query of this tile can see
  int kv_end = kvl;
  if (causal) kv_end = min(kv_end, max(0, q_offset + min(q0 + BQ, sq)));
  const int n_tiles = (kv_end + BK - 1) / BK;

  fetch_q_tile<DK, DV, BQ, kT>(q, qs, b, q0, h, sq, hq);
  cp_async_commit();

  // tile `tile` into its stage, then a commit (an empty group past the
  // last tile, so that every iteration waits for the same count); rows past
  // kv_end land as zeros without a read
  const auto fetch = [&](int tile) {
    if (tile < n_tiles) {
      bf16* st = ring + (tile % kDepth) * M::kElems;
      for (int i = tid; i < BK * (M::kKC + M::kVC); i += kT) {
        const int r = i / (M::kKC + M::kVC), c = i % (M::kKC + M::kVC);
        const int kr = tile * BK + r;
        const bool live = kr < kv_end;
        const size_t row =
            (static_cast<size_t>(b) * skv + (live ? kr : 0)) * hkv + hk;
        if (c < M::kKC) {
          const bool in = live && c * 8 < DK;
          cp_async16(st + r * M::kKS + c * 8, k + row * DK + (in ? c * 8 : 0),
                     in);
        } else {
          const int cv = (c - M::kKC) * 8;
          cp_async16(st + M::kVOff + r * M::kVS + cv, v + row * DV + cv, live);
        }
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < kDepth - 1; ++i) fetch(i);

  cp_async_wait<kDepth - 1>();   // the query tile landed
  __syncthreads();
  const int fr = frag_row(lane), fc = frag_col(lane);
  uint32_t qf[kKSteps][4];
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks)
    ldmatrix_x4(qf[ks], qs + (warp * 16 + fr) * M::kKS + ks * 16 + fc);

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[kON][4];
#pragma unroll
  for (int n = 0; n < kON; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if constexpr (kDepth == 1) {
      __syncthreads();           // the previous tile is consumed
      fetch(t);
      cp_async_wait<0>();
    } else {
      cp_async_wait<kDepth - 2>();   // this thread's copies of tile t
    }
    __syncthreads();             // every thread's
    if constexpr (kDepth > 1) fetch(t + kDepth - 1);   // the stage t - 1 left
    const bf16* kt = ring + (t % kDepth) * M::kElems;
    mma_fwd_tile<DK, DV, false, BK>(qf, kt, kt + M::kVOff, nullptr, nullptr,
                                    t * BK, kvl, causal, q_offset, row0,
                                    scale, scale_l2, m, l, o);
  }
  cp_async_wait<0>();   // only empty groups remain
  mma_fwd_store<DV>(out, lse, m, l, o, b, h, sq, hq, row0);
}

// Shared memory of fa_fwd_quant_mma_kernel<D>, in bytes: the [kMBQ][D + 8]
// bf16 query tile, the bf16 K and V tile the bytes become (MmaTile<D, D>,
// K1's stage), two ring stages of raw bytes ([kMBK][D + 16] of K, then of
// V; each row padded by 16 bytes) and the tile's k- and v-scales (f32).
template <int D>
struct QuantMmaSmem {
  using M = MmaTile<D, D>;
  static constexpr int kRow = D + 16;                  // bytes a staged row
  static constexpr size_t kTileOff = sizeof(bf16) * kMBQ * M::kKS;
  static constexpr size_t kRingOff = kTileOff + sizeof(bf16) * M::kElems;
  static constexpr size_t kStage = 2 * kMBK * kRow;
  static constexpr size_t kScaleOff = kRingOff + 2 * kStage;
  static constexpr size_t kBytes = kScaleOff + 2 * kMBK * sizeof(float);
};

// K10 in bf16: K1's block over 1-byte K/V.  The tiles arrive as their
// int8 / e4m3 bytes through a 2-stage cp.async ring (tile t + 1 in flight
// while tile t is computed; half of bf16's bytes a stage), the tile's f16
// scales through registers a tile ahead.  After the ring's barrier the
// block converts the tile once into a bf16 K and V tile (int8 and e4m3
// values are exact in bf16), one more barrier, then K1's per-tile
// arithmetic with the scales where the Pallas kernel puts them
// (mma_fwd_tile<.., kScaled>): converting once per block costs a
// quarter of what each warp converting the fragments it reads would, and
// V's n8 fragments pair two KV rows of a column, which ldmatrix.trans
// does not take as 8-bit elements.
template <typename S, int D>
__global__ void __launch_bounds__(kThreads, 1)
fa_fwd_quant_mma_kernel(const bf16* __restrict__ q, const S* __restrict__ k,
                        const S* __restrict__ v,
                        const __half* __restrict__ k_scale,
                        const __half* __restrict__ v_scale,
                        bf16* __restrict__ out, float* __restrict__ lse,
                        const int* __restrict__ kv_len_rows, int kv_len_all,
                        int sq, int skv, int hq, int hkv, int q_offset,
                        int causal) {
  using M = MmaTile<D, D>;
  using L = QuantMmaSmem<D>;
  constexpr int kKSteps = D / 16;
  constexpr int kC = D / 16;        // 16-byte chunks of a K or V row
  constexpr int kON = D / 8;
  extern __shared__ __align__(16) unsigned char quant_mma_smem[];
  bf16* qs = reinterpret_cast<bf16*>(quant_mma_smem);
  bf16* kt = reinterpret_cast<bf16*>(quant_mma_smem + L::kTileOff);
  bf16* vt = kt + M::kVOff;
  unsigned char* ring = quant_mma_smem + L::kRingOff;
  float* ksc = reinterpret_cast<float*>(quant_mma_smem + L::kScaleOff);
  float* vsc = ksc + kMBK;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kMBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = q0 + warp * 16;
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  const float scale_l2 = scale * kLog2e;

  int kvl = kv_len_rows != nullptr ? kv_len_rows[b] : kv_len_all;
  kvl = max(0, min(kvl, skv));
  int kv_end = kvl;
  if (causal) kv_end = min(kv_end, max(0, q_offset + min(q0 + kMBQ, sq)));
  const int n_tiles = (kv_end + kMBK - 1) / kMBK;

  fetch_q_tile<D, D>(q, qs, b, q0, h, sq, hq);
  cp_async_commit();

  // tile `tile`'s K and V bytes into stage tile % 2, then a commit (an
  // empty group past the last tile); rows past kv_end land as zeros
  const auto fetch = [&](int tile) {
    if (tile < n_tiles) {
      unsigned char* st = ring + (tile % 2) * L::kStage;
      static_assert(kMBK * 2 * kC % kThreads == 0, "whole rounds of copies");
#pragma unroll
      for (int u = 0; u < kMBK * 2 * kC / kThreads; ++u) {
        const int i = tid + u * kThreads;
        const int r = i / (2 * kC), c = i % (2 * kC);
        const int kr = tile * kMBK + r;
        const bool live = kr < kv_end;
        const size_t row =
            (static_cast<size_t>(b) * skv + (live ? kr : 0)) * hkv + hk;
        const bool is_v = c >= kC;
        const int cc = is_v ? c - kC : c;
        cp_async16(st + (is_v ? kMBK * L::kRow : 0) + r * L::kRow + cc * 16,
                   reinterpret_cast<const unsigned char*>(
                       (is_v ? v : k) + row * D) + cc * 16,
                   live);
      }
    }
    cp_async_commit();
  };
  // thread r < 64 holds the scales of row r of the next tile (0 past
  // kv_end), loaded a tile ahead so that their latency hides behind a tile
  const auto scales_of = [&](int tile) -> float2 {
    const int kr = tile * kMBK + tid;
    if (tid >= kMBK || tile >= n_tiles || kr >= kv_end)
      return make_float2(0.f, 0.f);
    const size_t off = (static_cast<size_t>(b) * skv + kr) * hkv + hk;
    return make_float2(to_float(k_scale[off]), to_float(v_scale[off]));
  };
  fetch(0);
  float2 sc = scales_of(0);

  cp_async_wait<1>();   // the query tile landed
  __syncthreads();
  const int fr = frag_row(lane), fc = frag_col(lane);
  uint32_t qf[kKSteps][4];
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks)
    ldmatrix_x4(qf[ks], qs + (warp * 16 + fr) * M::kKS + ks * 16 + fc);

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[kON][4];
#pragma unroll
  for (int n = 0; n < kON; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();   // tile t's bytes landed; tile t - 1 is consumed
    if (tid < kMBK) {
      ksc[tid] = sc.x;
      vsc[tid] = sc.y;
    }
    fetch(t + 1);
    sc = scales_of(t + 1);
    const unsigned char* st = ring + (t % 2) * L::kStage;
#pragma unroll
    for (int u = 0; u < kMBK * 2 * kC / kThreads; ++u) {
      const int i = tid + u * kThreads;
      const int r = i / (2 * kC), c = i % (2 * kC);
      const bool is_v = c >= kC;
      const int cc = is_v ? c - kC : c;
      store_bf16<S>(
          *reinterpret_cast<const uint4*>(
              st + (is_v ? kMBK * L::kRow : 0) + r * L::kRow + cc * 16),
          reinterpret_cast<uint4*>(is_v ? vt + r * M::kVS + cc * 16
                                        : kt + r * M::kKS + cc * 16));
    }
    __syncthreads();   // the bf16 tile and its scales are whole
    mma_fwd_tile<D, D, true>(qf, kt, vt, ksc, vsc, t * kMBK, kvl, causal,
                             q_offset, row0, scale, scale_l2, m, l, o);
  }
  cp_async_wait<0>();   // only empty groups remain
  mma_fwd_store<D>(out, lse, m, l, o, b, h, sq, hq, row0);
}

template <typename S, int D>
int launch_fwd_quant_mma(const void* q, const void* k, const void* v,
                         const void* k_scale, const void* v_scale, void* out,
                         void* lse, const int* kv_len_rows, int kv_len_all,
                         int b, int sq, int skv, int hq, int hkv,
                         int q_offset, int causal, cudaStream_t stream) {
  const dim3 grid((sq + kMBQ - 1) / kMBQ, hq, b);
  const size_t smem = QuantMmaSmem<D>::kBytes;
  const cudaError_t err =
      allow_dynamic_smem(fa_fwd_quant_mma_kernel<S, D>, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();       // not left for the next launch's check
    return static_cast<int>(err);
  }
  fa_fwd_quant_mma_kernel<S, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const S*>(k),
      static_cast<const S*>(v), static_cast<const __half*>(k_scale),
      static_cast<const __half*>(v_scale), static_cast<bf16*>(out),
      static_cast<float*>(lse), kv_len_rows, kv_len_all, sq, skv, hq, hkv,
      q_offset, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int DK, int DV, int kDepth, int BQ, int BK>
int launch_fwd_mma(const void* q, const void* k, const void* v, void* out,
                   void* lse, const int* kv_len_rows, int kv_len_all, int b,
                   int sq, int skv, int hq, int hkv, int q_offset, int causal,
                   cudaStream_t stream) {
  const dim3 grid((sq + BQ - 1) / BQ, hq, b);
  const size_t smem = MmaFwdSmem<DK, DV, kDepth, BQ, BK>::kBytes;
  const auto kernel = fa_fwd_mma_kernel<DK, DV, kDepth, BQ, BK>;
  const cudaError_t err = allow_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();       // not left for the next launch's check
    return static_cast<int>(err);
  }
  kernel<<<grid, 2 * BQ, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), kv_len_rows, kv_len_all, sq, skv, hq, hkv,
      q_offset, causal);
  return static_cast<int>(cudaGetLastError());
}

// go(BQ, BK) at the tile (block_q, block_k), as std::integral_constants,
// where the library builds it at (DK, DV) (fwd_tile_built), else
// unsupported.
template <int DK, int DV, typename Go>
int with_fwd_tile(int block_q, int block_k, Go&& go) {
  using std::integral_constant;
  if (!fwd_tile_built(DK, DV, block_q, block_k)) return kUnsupported;
  if constexpr (fwd_tile_built(DK, DV, 16, 32)) {
    if (block_q == 16)
      return block_k == 32 ? go(integral_constant<int, 16>{},
                                integral_constant<int, 32>{})
                           : go(integral_constant<int, 16>{},
                                integral_constant<int, 64>{});
    if (block_q == 128)
      return block_k == 32 ? go(integral_constant<int, 128>{},
                                integral_constant<int, 32>{})
                           : go(integral_constant<int, 128>{},
                                integral_constant<int, 64>{});
    if (block_k == 32)
      return go(integral_constant<int, 64>{}, integral_constant<int, 32>{});
  }
  return go(integral_constant<int, kMBQ>{}, integral_constant<int, kMBK>{});
}

// The bf16 forward at ring depth kDepth and the caller's tile.
template <int DK, int DV, int kDepth>
int launch_fwd_tile(int block_q, int block_k, const void* q, const void* k,
                    const void* v, void* out, void* lse,
                    const int* kv_len_rows, int kv_len_all, int b, int sq,
                    int skv, int hq, int hkv, int q_offset, int causal,
                    cudaStream_t stream) {
  return with_fwd_tile<DK, DV>(block_q, block_k, [&](auto bq, auto bk) {
    return launch_fwd_mma<DK, DV, kDepth, decltype(bq)::value,
                          decltype(bk)::value>(
        q, k, v, out, lse, kv_len_rows, kv_len_all, b, sq, skv, hq, hkv,
        q_offset, causal, stream);
  });
}

// Shared memory of the two bf16 backward kernels, in bytes.  q and k
// tiles are [64][DKP + 8] (DKP: Dk rounded up to the 16 of an mma step,
// the padding columns zero), v and do tiles [64][Dv + 8].
template <int DK, int DV>
struct MmaBwdSmem {
  using M = MmaTile<DK, DV>;
  static constexpr int kKS = M::kKS, kVS = M::kVS;   // row strides
  static constexpr int kKT = kMBK * kKS;             // a q or k tile
  static constexpr int kVT = kMBK * kVS;             // a v or do tile
  static constexpr int kPair = kKT + kVT;            // (k, v) or (q, do)
  // q, do, 2 stages of (k, v); lse and dd of the query tile
  static constexpr size_t kDqBytes =
      sizeof(bf16) * 3 * kPair + sizeof(float) * 2 * kMBQ;
  // k, v, 2 stages of (q, do); 2 stages of (lse, dd)
  static constexpr size_t kDkvBytes =
      sizeof(bf16) * 3 * kPair + sizeof(float) * 4 * kMBQ;
};

// cp.async of one 64-row tile of a [B, S, H, W] tensor, rows r0 .. r0 +
// 63 of head `head`, into a [64][stride] tile (not committed): rows at or
// past `end` and the columns from W up to ``chunks`` * 8 land as zeros.
template <int W>
__device__ __forceinline__ void fetch_rows(const bf16* __restrict__ src,
                                           bf16* dst, int stride, int chunks,
                                           int b, int r0, int end, int s,
                                           int heads, int head) {
  for (int i = threadIdx.x; i < kMBK * chunks; i += kThreads) {
    const int r = i / chunks, c = i % chunks, row = r0 + r;
    const bool live = row < end && c * 8 < W;
    const size_t off =
        ((static_cast<size_t>(b) * s + min(row, end - 1)) * heads + head) *
            W + (live ? c * 8 : 0);
    cp_async16(dst + r * stride + c * 8, src + off, live);
  }
}

// K11 in bf16.  The dq pass: one block of 4 warps per (64-query tile,
// q-head, batch row), the longest tiles first.  It fuses dd = rowsum(do *
// out) (written to f32 scratch for the dk/dv pass), keeps each warp's do
// fragments and, up to Dk = 128, its q fragments in registers (at Dk =
// 192 beside the 192-column dq sums they would spill: q is read from the
// staged tile instead), and walks 64-row K/V tiles up to the causal
// limit through a two-stage cp.async ring.  Per 16 KV rows and warp: S = Q
// K^T over Dk and dP = dO V^T over Dv (2 accumulator tiles each), P =
// exp(S / sqrt(Dk) - lse) (0 where masked), dS = P (dP - dd) rounded to
// bf16 as the A operand of dQ += dS K.  A 16-row chunk no query of the
// warp sees is skipped.
template <int DK, int DV>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ out,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse, float* __restrict__ dd,
                     bf16* __restrict__ dq, int sq, int skv, int hq, int hkv,
                     int causal) {
  using L = MmaBwdSmem<DK, DV>;
  using M = MmaTile<DK, DV>;
  constexpr int kKS = L::kKS, kVS = L::kVS;
  constexpr int kKSteps = M::kDKP / 16, kVSteps = DV / 16;
  constexpr int kN = DK / 8;                      // 8-column tiles of dq
  constexpr bool kQRegs = M::kDKP <= 128;         // q fragments held
  extern __shared__ __align__(16) unsigned char dq_mma_smem[];
  bf16* qs = reinterpret_cast<bf16*>(dq_mma_smem);
  bf16* dos = qs + L::kKT;
  bf16* ring = dos + L::kVT;                      // 2 x [k tile, v tile]
  float* lse_s = reinterpret_cast<float*>(ring + 2 * L::kPair);
  float* dd_s = lse_s + kMBQ;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kMBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t2 = (lane % 4) * 2;
  const int row0 = q0 + warp * 16;
  const int offset = skv - sq;                    // suffix alignment
  const float scale = 1.f / sqrtf(static_cast<float>(DK));
  const float scale_l2 = scale * kLog2e;

  fetch_rows<DK>(q, qs, kKS, M::kKC, b, q0, sq, sq, hq, h);
  fetch_rows<DV>(dout, dos, kVS, M::kVC, b, q0, sq, sq, hq, h);
  cp_async_commit();

  int kv_end = skv;
  if (causal) kv_end = min(skv, max(0, offset + min(q0 + kMBQ, sq)));
  const int n_tiles = (kv_end + kMBK - 1) / kMBK;
  const auto fetch = [&](int tile) {
    if (tile < n_tiles) {
      bf16* st = ring + (tile % 2) * L::kPair;
      fetch_rows<DK>(k, st, kKS, M::kKC, b, tile * kMBK, kv_end, skv, hkv,
                     hk);
      fetch_rows<DV>(v, st + L::kKT, kVS, M::kVC, b, tile * kMBK, kv_end,
                     skv, hkv, hk);
    }
    cp_async_commit();
  };
  fetch(0);

  {
    // dd = rowsum(do * out) over Dv: two threads a row, 16-byte loads
    const int r = tid / 2, half = tid % 2, qi = q0 + r;
    float part = 0.f;
    if (qi < sq) {
      const size_t base = ((static_cast<size_t>(b) * sq + qi) * hq + h) * DV;
      for (int c = half * 8; c < DV; c += 16) {
        float ox[8], dx[8];
        unpack16<bf16>(__ldg(reinterpret_cast<const uint4*>(out + base + c)),
                       ox);
        unpack16<bf16>(__ldg(reinterpret_cast<const uint4*>(dout + base + c)),
                       dx);
#pragma unroll
        for (int u = 0; u < 8; ++u) part += dx[u] * ox[u];
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (half == 0) {
      const size_t row = (static_cast<size_t>(b) * hq + h) * sq + qi;
      dd_s[r] = part;
      lse_s[r] = qi < sq ? lse[row] : 0.f;
      if (qi < sq) dd[row] = part;
    }
  }
  cp_async_wait<1>();   // q and do landed (tile 0 may be in flight)
  __syncthreads();
  const int fr = frag_row(lane), fc = frag_col(lane);
  const int br = brow(lane), bc = bcol(lane);
  uint32_t qf[kQRegs ? kKSteps : 1][4], df[kVSteps][4];
  const bf16* qrow = qs + (warp * 16 + fr) * kKS + fc;
  if constexpr (kQRegs) {
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) ldmatrix_x4(qf[ks], qrow + ks * 16);
  }
#pragma unroll
  for (int ks = 0; ks < kVSteps; ++ks)
    ldmatrix_x4(df[ks], dos + (warp * 16 + fr) * kVS + ks * 16 + fc);
  float lse_l2[2], ddr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse_l2[i] = lse_s[warp * 16 + g + 8 * i] * kLog2e;
    ddr[i] = dd_s[warp * 16 + g + 8 * i];
  }
  float acc[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();   // tile t landed everywhere; tile t - 1 is consumed
    fetch(t + 1);
    const bf16* kt = ring + (t % 2) * L::kPair;
    const bf16* vt = kt + L::kKT;
#pragma unroll
    for (int j = 0; j < kMBK / 16; ++j) {
      const int c0 = t * kMBK + 16 * j;   // the chunk's first KV row
      if (c0 >= kv_end || (causal && c0 > offset + row0 + 15)) continue;
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        uint32_t kb[4];
        ldmatrix_x4(kb, kt + (16 * j + br) * kKS + ks * 16 + bc);
        if constexpr (kQRegs) {
          mma_bf16(s[0], qf[ks], kb[0], kb[1]);
          mma_bf16(s[1], qf[ks], kb[2], kb[3]);
        } else {
          uint32_t qa[4];
          ldmatrix_x4(qa, qrow + ks * 16);
          mma_bf16(s[0], qa, kb[0], kb[1]);
          mma_bf16(s[1], qa, kb[2], kb[3]);
        }
      }
#pragma unroll
      for (int ks = 0; ks < kVSteps; ++ks) {
        uint32_t vb[4];
        ldmatrix_x4(vb, vt + (16 * j + br) * kVS + ks * 16 + bc);
        mma_bf16(dp[0], df[ks], vb[0], vb[1]);
        mma_bf16(dp[1], df[ks], vb[2], vb[3]);
      }
      const bool edge =
          c0 + 16 > skv || (causal && c0 + 15 > offset + row0);
      uint32_t a[4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(s[n][e] * scale_l2 - lse_l2[e >> 1]);
          if (edge) {
            const int kv = c0 + 8 * n + t2 + (e & 1);
            const int qi = row0 + g + 8 * (e >> 1);
            if (kv >= skv || (causal && kv > offset + qi)) p = 0.f;
          }
          ds[e] = p * (dp[n][e] - ddr[e >> 1]);
        }
        a[2 * n] = pack_bf16(ds[0], ds[1]);
        a[2 * n + 1] = pack_bf16(ds[2], ds[3]);
      }
#pragma unroll
      for (int nd = 0; nd < kKSteps; ++nd) {
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, kt + (16 * j + fr) * kKS + nd * 16 + fc);
        mma_bf16(acc[2 * nd], a, kb[0], kb[1]);
        if (2 * nd + 1 < kN)            // not Dk's zero padding (24 of 32)
          mma_bf16(acc[2 * nd + 1], a, kb[2], kb[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = row0 + g + 8 * i;
    if (qi >= sq) continue;
    bf16* drow = dq + ((static_cast<size_t>(b) * sq + qi) * hq + h) * DK;
#pragma unroll
    for (int n = 0; n < kN; ++n)
      *reinterpret_cast<__nv_bfloat162*>(drow + 8 * n + t2) =
          __floats2bfloat162_rn(acc[n][2 * i] * scale,
                                acc[n][2 * i + 1] * scale);
  }
}

// The dk/dv pass: one block of 4 warps per (64-row KV tile, q-head, batch
// row) holding the K and V tile in shared memory; warp w owns KV rows 16 w
// .. 16 w + 15 and their dk and dv sums in registers.  It walks 64-query
// tiles of q and do (with their lse and dd) from the first one the causal
// mask lets see the tile, through a two-stage cp.async ring.  Per 16 queries
// and warp: S^T = K Q^T over Dk and dP^T = V dO^T over Dv, P^T and dS^T as
// in the dq pass, then dV += P^T dO and dK += dS^T Q with P^T and dS^T
// rounded to bf16 as A operands.  The per-q-head f32 partials go to the
// group-sum kernel.
template <int DK, int DV>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dd,
                      float* __restrict__ dk_part,
                      float* __restrict__ dv_part, int sq, int skv, int hq,
                      int hkv, int causal) {
  using L = MmaBwdSmem<DK, DV>;
  using M = MmaTile<DK, DV>;
  constexpr int kKS = L::kKS, kVS = L::kVS;
  constexpr int kKSteps = M::kDKP / 16, kVSteps = DV / 16;
  constexpr int kNK = DK / 8, kNV = DV / 8;       // 8-column tiles
  extern __shared__ __align__(16) unsigned char dkv_mma_smem[];
  bf16* ks = reinterpret_cast<bf16*>(dkv_mma_smem);
  bf16* vs = ks + L::kKT;
  bf16* ring = vs + L::kVT;                       // 2 x [q tile, do tile]
  float* stats = reinterpret_cast<float*>(ring + 2 * L::kPair);  // lse, dd

  const int k0 = blockIdx.x * kMBK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t2 = (lane % 4) * 2;
  const int kr0 = k0 + warp * 16;                 // the warp's first KV row
  const int offset = skv - sq;
  const float scale = 1.f / sqrtf(static_cast<float>(DK));
  const float scale_l2 = scale * kLog2e;

  fetch_rows<DK>(k, ks, kKS, M::kKC, b, k0, skv, skv, hkv, hk);
  fetch_rows<DV>(v, vs, kVS, M::kVC, b, k0, skv, skv, hkv, hk);
  cp_async_commit();

  // the first query that sees KV row k0 is k0 - offset
  const int q_begin = causal ? max(0, k0 - offset) / kMBQ * kMBQ : 0;
  const int n_tiles = q_begin < sq ? (sq - q_begin + kMBQ - 1) / kMBQ : 0;
  const auto fetch = [&](int tile) {
    if (tile < n_tiles) {
      const int q0 = q_begin + tile * kMBQ;
      bf16* st = ring + (tile % 2) * L::kPair;
      fetch_rows<DK>(q, st, kKS, M::kKC, b, q0, sq, sq, hq, h);
      fetch_rows<DV>(dout, st + L::kKT, kVS, M::kVC, b, q0, sq, sq, hq, h);
      float* sst = stats + (tile % 2) * 2 * kMBQ;
      for (int i = tid; i < 2 * kMBQ; i += kThreads) {
        const int r = i % kMBQ, qi = q0 + r;
        const size_t row =
            (static_cast<size_t>(b) * hq + h) * sq + min(qi, sq - 1);
        cp_async4(sst + i, (i < kMBQ ? lse : dd) + row, qi < sq);
      }
    }
    cp_async_commit();
  };
  fetch(0);

  const int fr = frag_row(lane), fc = frag_col(lane);
  const int br = brow(lane), bc = bcol(lane);
  float dka[kNK][4], dva[kNV][4];
#pragma unroll
  for (int n = 0; n < kNK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < kNV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dva[n][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();   // tile t (and the K/V tile) landed; t - 1 consumed
    fetch(t + 1);
    const int q0 = q_begin + t * kMBQ;
    const bf16* qt = ring + (t % 2) * L::kPair;
    const bf16* dot = qt + L::kKT;
    const float* lse_s = stats + (t % 2) * 2 * kMBQ;
    const float* dd_s = lse_s + kMBQ;
#pragma unroll
    for (int j = 0; j < kMBQ / 16; ++j) {
      const int c0 = q0 + 16 * j;   // the chunk's first query
      if (c0 >= sq || (causal && kr0 > offset + c0 + 15)) continue;
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        uint32_t ka[4], qb[4];
        ldmatrix_x4(ka, ks + (warp * 16 + fr) * kKS + kk * 16 + fc);
        ldmatrix_x4(qb, qt + (16 * j + br) * kKS + kk * 16 + bc);
        mma_bf16(s[0], ka, qb[0], qb[1]);
        mma_bf16(s[1], ka, qb[2], qb[3]);
      }
#pragma unroll
      for (int kk = 0; kk < kVSteps; ++kk) {
        uint32_t va[4], db[4];
        ldmatrix_x4(va, vs + (warp * 16 + fr) * kVS + kk * 16 + fc);
        ldmatrix_x4(db, dot + (16 * j + br) * kVS + kk * 16 + bc);
        mma_bf16(dp[0], va, db[0], db[1]);
        mma_bf16(dp[1], va, db[2], db[3]);
      }
      const bool edge =
          c0 + 16 > sq || (causal && kr0 + 15 > offset + c0);
      uint32_t pa[4], da[4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 16 * j + 8 * n + t2 + (e & 1);   // in the tile
          p[e] = exp2f(s[n][e] * scale_l2 - lse_s[qc] * kLog2e);
          if (edge) {
            const int kv = kr0 + g + 8 * (e >> 1), qi = q0 + qc;
            if (qi >= sq || (causal && kv > offset + qi)) p[e] = 0.f;
          }
          ds[e] = p[e] * (dp[n][e] - dd_s[qc]);
        }
        pa[2 * n] = pack_bf16(p[0], p[1]);
        pa[2 * n + 1] = pack_bf16(p[2], p[3]);
        da[2 * n] = pack_bf16(ds[0], ds[1]);
        da[2 * n + 1] = pack_bf16(ds[2], ds[3]);
      }
#pragma unroll
      for (int nd = 0; nd < kVSteps; ++nd) {
        uint32_t ob[4];
        ldmatrix_x4_trans(ob, dot + (16 * j + fr) * kVS + nd * 16 + fc);
        mma_bf16(dva[2 * nd], pa, ob[0], ob[1]);
        mma_bf16(dva[2 * nd + 1], pa, ob[2], ob[3]);
      }
#pragma unroll
      for (int nd = 0; nd < kKSteps; ++nd) {
        uint32_t qb[4];
        ldmatrix_x4_trans(qb, qt + (16 * j + fr) * kKS + nd * 16 + fc);
        mma_bf16(dka[2 * nd], da, qb[0], qb[1]);
        if (2 * nd + 1 < kNK)           // not Dk's zero padding (24 of 32)
          mma_bf16(dka[2 * nd + 1], da, qb[2], qb[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kv = kr0 + g + 8 * i;
    if (kv >= skv) continue;
    const size_t row = (static_cast<size_t>(b) * skv + kv) * hq + h;
#pragma unroll
    for (int n = 0; n < kNK; ++n)
      *reinterpret_cast<float2*>(dk_part + row * DK + 8 * n + t2) =
          make_float2(dka[n][2 * i] * scale, dka[n][2 * i + 1] * scale);
#pragma unroll
    for (int n = 0; n < kNV; ++n)
      *reinterpret_cast<float2*>(dv_part + row * DV + 8 * n + t2) =
          make_float2(dva[n][2 * i], dva[n][2 * i + 1]);
  }
}

// The (Dk, Dv) pairs K1 is built for: the dense decoder's square head
// dims, the hybrid family's 80 (zamba2's shared attention block), MLA's
// prefill (qk_nope + qk_rope = 192 against v_head_dim 128), and the
// reduced MLA config's (16 + 8 against 16).  K11 takes the same pairs.
using FwdDims = DimList<Dims<16, 16>, Dims<32, 32>, Dims<64, 64>,
                        Dims<80, 80>, Dims<128, 128>, Dims<192, 128>,
                        Dims<24, 16>>;

// block_q, block_k: K1's tile (bf16: one fwd_tile_built; f32: the CUDA
// cores' kBQ x kBK); K10 keeps its one tile and takes none.
struct FaLaunch {
  const void *q, *k, *v, *k_scale, *v_scale;   // scales null for float K/V
  void *out, *lse;
  const int* kv_len_rows;
  int kv_len_all, b, sq, skv, hq, hkv, q_offset, causal, block_q, block_k;
  cudaStream_t stream;

  // bf16 K1 on the tensor cores (depth 1 of fa_fwd_mma_kernel), bf16 K10
  // too (fa_fwd_quant_mma_kernel); f32 K1 and K10 on the CUDA cores
  template <typename T, typename S, int DK, int DV>
  int run() const {
    if constexpr (std::is_same<T, bf16>::value && std::is_same<S, T>::value) {
      return launch_fwd_tile<DK, DV, 1>(block_q, block_k, q, k, v, out, lse,
                                        kv_len_rows, kv_len_all, b, sq, skv,
                                        hq, hkv, q_offset, causal, stream);
    } else if constexpr (std::is_same<T, bf16>::value) {
      static_assert(DK == DV, "the quantized kernel is square");
      return launch_fwd_quant_mma<S, DK>(q, k, v, k_scale, v_scale, out, lse,
                                         kv_len_rows, kv_len_all, b, sq, skv,
                                         hq, hkv, q_offset, causal, stream);
    } else {
      if (!kQuantized<T, S> && (block_q != kBQ || block_k != kBK))
        return kUnsupported;
      return cuda_cores<T, S, DK, DV>();
    }
  }

  template <typename T, typename S, int DK, int DV>
  int cuda_cores() const {
    const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
    const size_t smem = FwdSmem<kQuantized<T, S>, DK, DV>::kBytes;
    const cudaError_t err =
        allow_dynamic_smem(fa_fwd_kernel<T, S, DK, DV>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fa_fwd_kernel<T, S, DK, DV><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const S*>(k),
        static_cast<const S*>(v), static_cast<const __half*>(k_scale),
        static_cast<const __half*>(v_scale), static_cast<T*>(out),
        static_cast<float*>(lse), kv_len_rows, kv_len_all, sq, skv, hq, hkv,
        q_offset, causal);
    return static_cast<int>(cudaGetLastError());
  }
};

// ---------------------------------------------------------------- K11

// Shared memory of the two backward kernels, in floats: the [kBQ][DK]
// query tile (q / sqrt(DK)) and the [kBQ][DV] do tile, the [kBK][DK + 1]
// k and [kBK][DV + 1] v tiles (+1 keeps lane j's reads of row j
// conflict-free), two [kBQ][kBK] score tiles and the query tile's lse and
// dd.
template <int DK, int DV>
constexpr size_t bwd_smem_floats() {
  return kBQ * (DK + DV) + kBK * (DK + DV + 2) + 2 * kBQ * kBK + 2 * kBQ;
}

// Stage a [kBQ][DK] tile of q / sqrt(DK) and a [kBQ][DV] tile of do (zero
// past sq), one column of each a step (the wider's columns alone past the
// narrower's width).
template <typename T, int DK, int DV>
__device__ __forceinline__ void stage_q_tile(const T* __restrict__ q,
                                             const T* __restrict__ dout,
                                             float* qs, float* dos, int b,
                                             int q0, int h, int sq, int hq) {
  constexpr int W = DK > DV ? DK : DV;
  const float sqrt_d = sqrtf(static_cast<float>(DK));
  for (int i = threadIdx.x; i < kBQ * W; i += kThreads) {
    const int r = i / W, c = i % W, qi = q0 + r;
    float qx = 0.f, dx = 0.f;
    if (qi < sq) {
      const size_t row = (static_cast<size_t>(b) * sq + qi) * hq + h;
      if (c < DK) qx = to_float(q[row * DK + c]) / sqrt_d;
      if (c < DV) dx = to_float(dout[row * DV + c]);
    }
    if (c < DK) qs[r * DK + c] = qx;
    if (c < DV) dos[r * DV + c] = dx;
  }
}

// Stage a [kBK][DK + 1] tile of k and a [kBK][DV + 1] tile of v, rows k0..
// of KV head hk (zero from row `end` on).
template <typename T, int DK, int DV>
__device__ __forceinline__ void stage_kv_tile(const T* __restrict__ k,
                                              const T* __restrict__ v,
                                              float* ks, float* vs, int b,
                                              int k0, int hk, int end,
                                              int skv, int hkv) {
  constexpr int W = DK > DV ? DK : DV;
  for (int i = threadIdx.x; i < kBK * W; i += kThreads) {
    const int r = i / W, c = i % W, kr = k0 + r;
    float kx = 0.f, vx = 0.f;
    if (kr < end) {
      const size_t row = (static_cast<size_t>(b) * skv + kr) * hkv + hk;
      if (c < DK) kx = to_float(k[row * DK + c]);
      if (c < DV) vx = to_float(v[row * DV + c]);
    }
    if (c < DK) ks[r * (DK + 1) + c] = kx;
    if (c < DV) vs[r * (DV + 1) + c] = vx;
  }
}

// Lane `lane` scores KV row `lane` of the staged tile against the warp's
// kRowsPerWarp query rows r0.. of the staged query tile: s = qs.k over DK
// columns and dp = do.v over DV, each KV value read once for all the rows.
template <int DK, int DV>
__device__ __forceinline__ void score_rows(const float* qs, const float* dos,
                                           const float* ks, const float* vs,
                                           int r0, int lane,
                                           float (&s)[kRowsPerWarp],
                                           float (&dp)[kRowsPerWarp]) {
  constexpr int W = DK > DV ? DK : DV;
  const float* kr = ks + lane * (DK + 1);
  const float* vr = vs + lane * (DV + 1);
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) s[rr] = dp[rr] = 0.f;
#pragma unroll 4
  for (int c = 0; c < W; ++c) {
    const float kc = c < DK ? kr[c] : 0.f, vc = c < DV ? vr[c] : 0.f;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      if (c < DK) s[rr] += qs[(r0 + rr) * DK + c] * kc;
      if (c < DV) dp[rr] += dos[(r0 + rr) * DV + c] * vc;
    }
  }
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ out,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 float* __restrict__ dd, T* __restrict__ dq, int sq, int skv,
                 int hq, int hkv, int causal) {
  // lane `lane` accumulates columns lane + 32 cc of the warp's rows (at
  // DK = 16 or 24 part of the warp has no column)
  constexpr int kCols = (DK + 31) / 32;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kBQ * DK;
  float* ks = dos + kBQ * DV;
  float* vs = ks + kBK * (DK + 1);
  float* dss = vs + kBK * (DV + 1);             // [kBQ][kBK]: p (dp - dd)
  float* lse_s = dss + 2 * kBQ * kBK;
  float* dd_s = lse_s + kBQ;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int offset = skv - sq;                  // suffix alignment

  stage_q_tile<T, DK, DV>(q, dout, qs, dos, b, q0, h, sq, hq);
  __syncthreads();
  // dd = rowsum(do * out) over DV for the warp's own rows, kept for step 2
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr, qi = q0 + r;
    float part = 0.f;
    if (qi < sq) {
      const size_t base = ((static_cast<size_t>(b) * sq + qi) * hq + h) * DV;
      for (int c = lane; c < DV; c += 32)
        part += dos[r * DV + c] * to_float(out[base + c]);
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
    stage_kv_tile<T, DK, DV>(k, v, ks, vs, b, k0, hk, kv_end, skv, hkv);
    __syncthreads();
    const int kpos = k0 + lane;
    float s[kRowsPerWarp], dp[kRowsPerWarp];
    score_rows<DK, DV>(qs, dos, ks, vs, r0, lane, s, dp);
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
        kx[cc] = ks[t * (DK + 1) + min(lane + 32 * cc, DK - 1)];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float d = dss[(r0 + rr) * kBK + t];
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) acc[rr][cc] += d * kx[cc];
      }
    }
  }

  const float sqrt_d = sqrtf(static_cast<float>(DK));
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int qi = q0 + r0 + rr;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      const int c = lane + 32 * cc;
      if (qi < sq && c < DK)
        dq[(static_cast<size_t>(b) * sq + qi) * hq * DK +
           static_cast<size_t>(h) * DK + c] = from_float<T>(acc[rr][cc] / sqrt_d);
    }
  }
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ dd, float* __restrict__ dk_part,
                  float* __restrict__ dv_part, int sq, int skv, int hq,
                  int hkv, int causal) {
  // (row, column) slots per thread of the [kBK][DK] dk and [kBK][DV] dv
  static_assert(kBK * DK % kThreads == 0 && kBK * DV % kThreads == 0,
                "whole slots");
  constexpr int kAccK = kBK * DK / kThreads, kAccV = kBK * DV / kThreads;
  constexpr int kAcc = kAccK > kAccV ? kAccK : kAccV;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kBQ * DK;
  float* ks = dos + kBQ * DV;
  float* vs = ks + kBK * (DK + 1);
  float* ps = vs + kBK * (DV + 1);              // [kBQ][kBK]: p
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

  stage_kv_tile<T, DK, DV>(k, v, ks, vs, b, k0, hk, skv, skv, hkv);
  // the first query that sees KV row k0 is k0 - offset
  int q_begin = 0;
  if (causal) q_begin = max(0, k0 - offset) / kBQ * kBQ;

  float dk_acc[kAcc], dv_acc[kAcc];   // slots past kAccK / kAccV unused
#pragma unroll
  for (int m = 0; m < kAcc; ++m) {
    dk_acc[m] = 0.f;
    dv_acc[m] = 0.f;
  }

  const int kpos = k0 + lane;
  // slot m of a thread holds (KV row, column) number tid + 128 m of the
  // tile, row-major over W columns: where W divides 128 that is column
  // tid % W of rows tid / W + m * 128 / W (80 or 24 does not: the column
  // moves with m)
  const auto slot_row = [&](int m, int w) { return (tid + m * kThreads) / w; };
  const auto slot_col = [&](int m, int w) { return (tid + m * kThreads) % w; };
  for (int q0 = q_begin; q0 < sq; q0 += kBQ) {
    __syncthreads();   // the previous query tile is consumed
    stage_q_tile<T, DK, DV>(q, dout, qs, dos, b, q0, h, sq, hq);
    if (tid < kBQ) {
      const int qi = q0 + tid;
      const size_t row = (static_cast<size_t>(b) * hq + h) * sq + qi;
      lse_s[tid] = qi < sq ? lse[row] : 0.f;
      dd_s[tid] = qi < sq ? dd[row] : 0.f;
    }
    __syncthreads();
    float s[kRowsPerWarp], dp[kRowsPerWarp];
    score_rows<DK, DV>(qs, dos, ks, vs, warp * kRowsPerWarp, lane, s, dp);
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
#pragma unroll
      for (int m = 0; m < kAcc; ++m) {
        if (m < kAccV)
          dv_acc[m] += ps[i * kBK + slot_row(m, DV)] *
                       dos[i * DV + slot_col(m, DV)];
        if (m < kAccK)
          dk_acc[m] += dss[i * kBK + slot_row(m, DK)] *
                       qs[i * DK + slot_col(m, DK)];
      }
    }
  }

#pragma unroll
  for (int m = 0; m < kAcc; ++m) {
    if (m < kAccK && k0 + slot_row(m, DK) < skv)
      dk_part[(static_cast<size_t>(b) * skv + k0 + slot_row(m, DK)) * hq *
                  DK + static_cast<size_t>(h) * DK + slot_col(m, DK)] =
          dk_acc[m];
    if (m < kAccV && k0 + slot_row(m, DV) < skv)
      dv_part[(static_cast<size_t>(b) * skv + k0 + slot_row(m, DV)) * hq *
                  DV + static_cast<size_t>(h) * DV + slot_col(m, DV)] =
          dv_acc[m];
  }
}

// dk[b, s, hk, c] = sum over the group's q-heads of the f32 partials
// [b, s, hk * g + i, c], in order i = 0 .. g - 1, rounded once; dv alike.
// Index i runs over (row, KV head) x (dk's DK columns, then dv's DV).
template <typename T>
__global__ void fa_bwd_group_sum_kernel(const float* __restrict__ dk_part,
                                        const float* __restrict__ dv_part,
                                        T* __restrict__ dk,
                                        T* __restrict__ dv, size_t n,
                                        int hkv, int g, int dkw, int dvw) {
  const int w = dkw + dvw;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int col = static_cast<int>(i % w);
    const size_t rest = i / w;
    const size_t hk = rest % hkv, row = rest / hkv;
    const bool is_k = col < dkw;
    const int d = is_k ? dkw : dvw, c = is_k ? col : col - dkw;
    const float* part = is_k ? dk_part : dv_part;
    const size_t base = (row * hkv * g + hk * g) * d + c;
    float sum = 0.f;
    for (int j = 0; j < g; ++j) sum += part[base + static_cast<size_t>(j) * d];
    (is_k ? dk : dv)[rest * d + c] = from_float<T>(sum);
  }
}

struct FaBwdLaunch {
  const void *q, *k, *v, *out, *dout, *lse;
  void *dq, *dk, *dv, *dd, *dk_part, *dv_part;
  int b, sq, skv, hq, hkv, causal;
  cudaStream_t stream;

  template <typename T, typename S, int DK, int DV>
  int run() const {
    static_assert(std::is_same<T, S>::value, "K11 takes float K/V only");
    const T* qt = static_cast<const T*>(q);
    const T* kt = static_cast<const T*>(k);
    const T* vt = static_cast<const T*>(v);
    const T* dot = static_cast<const T*>(dout);
    cudaError_t err;
    if constexpr (std::is_same<T, bf16>::value) {   // the tensor cores
      using L = MmaBwdSmem<DK, DV>;
      err = allow_dynamic_smem(fa_bwd_dq_mma_kernel<DK, DV>, L::kDqBytes);
      if (err == cudaSuccess)
        err = allow_dynamic_smem(fa_bwd_dkv_mma_kernel<DK, DV>, L::kDkvBytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      fa_bwd_dq_mma_kernel<DK, DV><<<dim3((sq + kMBQ - 1) / kMBQ, hq, b),
                                     kThreads, L::kDqBytes, stream>>>(
          qt, kt, vt, static_cast<const T*>(out), dot,
          static_cast<const float*>(lse), static_cast<float*>(dd),
          static_cast<T*>(dq), sq, skv, hq, hkv, causal);
      if ((err = cudaGetLastError()) != cudaSuccess)
        return static_cast<int>(err);
      fa_bwd_dkv_mma_kernel<DK, DV><<<dim3((skv + kMBK - 1) / kMBK, hq, b),
                                      kThreads, L::kDkvBytes, stream>>>(
          qt, kt, vt, dot, static_cast<const float*>(lse),
          static_cast<const float*>(dd), static_cast<float*>(dk_part),
          static_cast<float*>(dv_part), sq, skv, hq, hkv, causal);
    } else {
      const int smem =
          static_cast<int>(bwd_smem_floats<DK, DV>() * sizeof(float));
      err = allow_dynamic_smem(fa_bwd_dq_kernel<T, DK, DV>, smem);
      if (err == cudaSuccess)
        err = allow_dynamic_smem(fa_bwd_dkv_kernel<T, DK, DV>, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      fa_bwd_dq_kernel<T, DK, DV>
          <<<dim3((sq + kBQ - 1) / kBQ, hq, b), kThreads, smem, stream>>>(
              qt, kt, vt, static_cast<const T*>(out), dot,
              static_cast<const float*>(lse), static_cast<float*>(dd),
              static_cast<T*>(dq), sq, skv, hq, hkv, causal);
      if ((err = cudaGetLastError()) != cudaSuccess)
        return static_cast<int>(err);
      fa_bwd_dkv_kernel<T, DK, DV>
          <<<dim3((skv + kBK - 1) / kBK, hq, b), kThreads, smem, stream>>>(
              qt, kt, vt, dot, static_cast<const float*>(lse),
              static_cast<const float*>(dd), static_cast<float*>(dk_part),
              static_cast<float*>(dv_part), sq, skv, hq, hkv, causal);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const size_t n = static_cast<size_t>(b) * skv * hkv * (DK + DV);
    const int blocks = static_cast<int>(
        std::min<size_t>((n + 255) / 256, 132 * 16));
    fa_bwd_group_sum_kernel<T><<<blocks, 256, 0, stream>>>(
        static_cast<const float*>(dk_part), static_cast<const float*>(dv_part),
        static_cast<T*>(dk), static_cast<T*>(dv), n, hkv, hq / hkv, DK, DV);
    return static_cast<int>(cudaGetLastError());
  }
};

// ----------------------------------------------------------------- K4

// K4: K1's bf16 kernel at ring depth 2 or 4 and the caller's tile.  f32
// has no ring (its K1, fa_fwd_kernel, runs at depth 1): unsupported.
struct FaPipelinedLaunch {
  const void *q, *k, *v;
  void *out, *lse;
  const int* kv_len_rows;
  int kv_len_all, b, sq, skv, hq, hkv, q_offset, causal, depth, block_q,
      block_k;
  cudaStream_t stream;

  template <typename T, int DK, int DV, int kDepth>
  int launch() const {
    if constexpr (std::is_same<T, bf16>::value)
      return launch_fwd_tile<DK, DV, kDepth>(
          block_q, block_k, q, k, v, out, lse, kv_len_rows, kv_len_all, b,
          sq, skv, hq, hkv, q_offset, causal, stream);
    else
      return kUnsupported;
  }

  template <typename T, typename S, int DK, int DV>
  int run() const {
    if (depth == 2) return launch<T, DK, DV, 2>();
    if (depth == 4) return launch<T, DK, DV, 4>();
    return kUnsupported;
  }
};

// The bytes of shared memory a bf16 K4 block of this depth and tile takes.
struct FaRingBytes {
  int depth, block_q, block_k;
  long long* bytes;

  template <int DK, int DV, int kDepth>
  int of() const {
    return with_fwd_tile<DK, DV>(block_q, block_k, [&](auto bq, auto bk) {
      *bytes = MmaFwdSmem<DK, DV, kDepth, decltype(bq)::value,
                          decltype(bk)::value>::kBytes;
      return 0;
    });
  }

  template <typename T, typename S, int DK, int DV>
  int run() const {
    if constexpr (!std::is_same<T, bf16>::value) return kUnsupported;
    if (depth == 2) return of<DK, DV, 2>();
    if (depth == 4) return of<DK, DV, 4>();
    return kUnsupported;
  }
};

}  // namespace
}  // namespace repro

// q [B, Sq, Hq, Dk], k [B, Skv, Hkv, Dk], v [B, Skv, Hkv, Dv], out
// [B, Sq, Hq, Dv] (all of dtype `dtype`, contiguous); lse [B, Hq, Sq] f32.
// (dk, dv) must be a pair of FwdDims.  kv_len_rows is a device int32 [B]
// or null, in which case kv_len_all applies to every row.  Query i sits at
// absolute position q_offset + i.
// (block_q, block_k) is the tile: bf16 one of fwd_tile_built at (dk, dv),
// f32 the CUDA cores' (16, 32); another is unsupported.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, void* lse,
                                   const void* kv_len_rows, int kv_len_all,
                                   int b, int sq, int skv, int hq, int hkv,
                                   int dk, int dv, int q_offset, int causal,
                                   int block_q, int block_k, int dtype,
                                   void* stream) {
  if (hkv <= 0 || hq % hkv != 0) return repro::kUnsupported;
  const repro::FaLaunch launch{
      q, k, v, nullptr, nullptr, out, lse,
      static_cast<const int*>(kv_len_rows), kv_len_all, b, sq, skv, hq, hkv,
      q_offset, causal, block_q, block_k, static_cast<cudaStream_t>(stream)};
  return repro::dispatch_dtype_dims<repro::FwdDims>(dtype, dk, dv, launch);
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
      q_offset, causal, repro::kMBQ, repro::kMBK,
      static_cast<cudaStream_t>(stream)};
  return repro::dispatch_quant(dtype, store, d, launch);
}

// K11.  q and dq [B, Sq, Hq, Dk], out and dout [B, Sq, Hq, Dv]; k and dk
// [B, Skv, Hkv, Dk], v and dv [B, Skv, Hkv, Dv] (all of dtype `dtype`,
// contiguous; (dk, dv) a pair of FwdDims); lse [B, Hq, Sq] f32 from K1
// with every KV row valid and query i at position Skv - Sq + i.  Scratch
// the caller allocates: dd [B, Hq, Sq] f32, dk_part [B, Skv, Hq, Dk] and
// dv_part [B, Skv, Hq, Dv] f32.  Three launches on `stream`: dq (and dd),
// dk/dv partials, the GQA group sum.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* dout, const void* lse,
                                   void* dq, void* dk, void* dv, void* dd,
                                   void* dk_part, void* dv_part, int b,
                                   int sq, int skv, int hq, int hkv, int dk_,
                                   int dv_, int causal, int dtype,
                                   void* stream) {
  if (hkv <= 0 || hq % hkv != 0) return repro::kUnsupported;
  const repro::FaBwdLaunch launch{
      q, k, v, out, dout, lse, dq, dk, dv, dd, dk_part, dv_part,
      b, sq, skv, hq, hkv, causal, static_cast<cudaStream_t>(stream)};
  return repro::dispatch_dtype_dims<repro::FwdDims>(dtype, dk_, dv_, launch);
}

// K4.  bf16 K1 with a `num_buffers`-stage KV ring (2 or 4; anything else
// is unsupported, as is f32, and a depth whose ring does not fit the
// block's shared memory fails to launch).  Arguments as for K1; out and
// lse equal K1's at the same tile bit for bit.
extern "C" int flash_attention_fwd_pipelined(
    const void* q, const void* k, const void* v, void* out, void* lse,
    const void* kv_len_rows, int kv_len_all, int b, int sq, int skv, int hq,
    int hkv, int dk, int dv, int q_offset, int causal, int block_q,
    int block_k, int num_buffers, int dtype, void* stream) {
  if (hkv <= 0 || hq % hkv != 0) return repro::kUnsupported;
  const repro::FaPipelinedLaunch launch{
      q, k, v, out, lse, static_cast<const int*>(kv_len_rows), kv_len_all,
      b, sq, skv, hq, hkv, q_offset, causal, num_buffers, block_q, block_k,
      static_cast<cudaStream_t>(stream)};
  return repro::dispatch_dtype_dims<repro::FwdDims>(dtype, dk, dv, launch);
}

// The shared memory of one bf16 K4 block (MmaFwdSmem) at this (dk, dv),
// tile and depth, into *bytes: what ``pipelined_smem`` in
// kernels/flash_attention/ops.py fits the depth against.
extern "C" int flash_attention_fwd_pipelined_smem(int dk, int dv,
                                                  int block_q, int block_k,
                                                  int num_buffers,
                                                  long long* bytes) {
  const repro::FaRingBytes query{num_buffers, block_q, block_k, bytes};
  return repro::dispatch_dtype_dims<repro::FwdDims>(repro::kBFloat16, dk, dv,
                                                    query);
}

// The bf16 forward's tiles at (dk, dv) as (block_q, block_k) pairs into
// out (at most `max` pairs); returns their count.
extern "C" int flash_attention_fwd_tiles(int dk, int dv, int* out, int max) {
  int n = 0;
  for (int bq : {16, 64, 128})
    for (int bk : {32, 64}) {
      if (!repro::fwd_tile_built(dk, dv, bq, bk)) continue;
      if (n < max) {
        out[2 * n] = bq;
        out[2 * n + 1] = bk;
      }
      ++n;
    }
  return n;
}

extern "C" const char* repro_error_string(int code) {
  return repro::error_string(code);
}
