"""K2 and K3: split-K flash-decode over a contiguous cache (K2) and over a
shared page pool (K3), and K7 and K8, the same over a quantized cache —
the CUDA kernels' wrappers and their plain PyTorch versions.

Port of ``repro.kernels.decode_attention`` (Pallas ``decode_attention_fwd``
and ``paged_decode_attention_fwd``, each with its partial-softmax
combine).  One query token per row, each row with its own valid length
``kv_len`` (clamped to the rows the cache holds: an idle serve slot's
length keeps growing past it).

K2 layout: q [B, Hq, Dk]; k [B, S, Hkv, Dk]; v [B, S, Hkv, Dv]; kv_len
[B] int; Hq = G * Hkv.  K3 layout: k_pool [Np, ps, Hkv, Dk], v_pool
[Np, ps, Hkv, Dv]; page_table [B, P] int, logical page j of row b is pool
page ``page_table[b, j]``, so row b sees the P * ps logical rows of
``k_pool[page_table[b]]``.  Both return [B, Hq, Dv] in q's dtype; a row
with kv_len = 0 gets zeros.  They take the (Dk, Dv) pairs of
``HEAD_DIM_PAIRS``: the square head dims of the dense decoder and of the
hybrid family's shared attention block (80), and MLA's absorbed decode,
where one latent KV head of kv_lora + qk_rope columns (576 at full
width, 40 reduced) serves as K and its first kv_lora columns (512, 32)
as V.  The two kernels are one split kernel with two row addresses (see
``csrc/decode_attention.cu``), so K3 on a pool equals K2 on the gathered
cache bit for bit.  They take any group size G = Hq / Hkv: a split block
holds ``QUERY_ROWS`` query heads of one KV head, and a larger group (the
128 query heads deepseek-v2-236b decodes on its one latent head) is split
over ``group_blocks(G)`` blocks, each writing its heads' partials; a
head's sums never meet another's, so K2 on G heads equals K2 on each
16-head slice of them, bit for bit, at the same split count.

K7 and K8 (port of ``decode_attention_fwd_quantized`` and
``paged_decode_attention_fwd_quantized``) take the cache as int8 or fp8
e4m3 values plus f16 scales [.., Hkv, 1] laid out like them (pools of
scale pages for K8, named by the same page table): q, k_q, k_scale, v_q,
v_scale, [page_table,] kv_len.  They are the split kernel with the
quantized value format, so K8 on a pool equals K7 on the gathered cache
bit for bit.  They take square head dims only (``HEAD_DIMS``).

K5, K6 and K9 (ports of ``decode_attention_fwd_pipelined``,
``paged_decode_attention_fwd_pipelined`` and
``paged_decode_attention_fwd_quantized_pipelined``) are K2, K3 and K8
with each split's KV tiles staged through a ``num_buffers``-stage ring (2
or 4).  At the same split plan they give K2's, K3's and K8's output bit
for bit, so their plain versions are :func:`decode_attention_plain`,
:func:`paged_decode_attention_plain` and
:func:`paged_decode_attention_quantized_plain`.  The ops resolve their
knobs per call (:func:`route`): the caller's, else the tuning db's pick
for the shape bucket (``core/autotune_search``: the split count of K2 and
K7 and the ring depth of K2, K3 and K8; on a miss or under
``REPRO_TUNING=off`` the analytic pick, depth 1 and :func:`num_splits`),
the depth fitted to the 227 KB of shared memory a block may use; depth 1
launches the classic kernel, a deeper ring the pipelined one.

The query's dtype picks the kernel inside the library (:func:`path`):
bf16 calls of K2, K3, K5 and K6 run one tensor-core split kernel
(``mma.sync`` on raw bf16 tiles brought by ``cp.async``; K2 and K3 are its
depth-1 instances, K3 and K6 its paged row address), and bf16 calls of K7,
K8 and K9 its 1-byte sibling (the tile's int8 / e4m3 bytes through the
same kind of ring, made into bf16 once per block, the scales where the
Pallas body puts them), so those equalities hold in bf16 too; f32 calls
(the parity dtype), over an f32 or a 1-byte cache, run on the CUDA cores.
The paths lay out shared memory differently, and :func:`pipelined_smem`
mirrors each.

K2's two kernels are also entry points of their own, for the
sequence-sharded decode (``models/attention.py``
``distributed_decode_attention``): :func:`decode_attention_partials`
launches the split kernel alone and returns the partials in the Pallas
kernel's layout (o_part [B, Hkv, ns, G, Dv], m_part and l_part [B, Hkv,
ns, G, 1], f32), and :func:`decode_combine` launches the combine kernel
alone over partials of any split count, such as several ranks' blocks
laid side by side.  Their plain versions work split by split on the same
plan (:func:`split_plan`).

Every wrapper reports its work to the active count once per call
(``kernels/work.py``).  On a meta tensor (the dry run) a wrapper runs
nothing and returns outputs of the right shapes and dtypes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from collections import Counter
from typing import Callable, Optional

import torch

from repro_torch.core import autotune, autotune_search
from repro_torch.kernels import _build
from repro_torch.kernels import quant
from repro_torch.kernels import work
from repro_torch.kernels.flash_attention import ops as fa_ops

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 80, 128)      # K7 and K8: Dk == Dv
# (Dk, Dv) pairs K2 and K3 are built for (``SplitDims`` in
# csrc/decode_attention.cu)
HEAD_DIM_PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((576, 512), (40, 32))
QUERY_ROWS = 16         # query heads a split block holds (kGMax)
MIN_SPLIT_ROWS = autotune.MIN_SPLIT_ROWS   # fewest cache rows of a split
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ENTRY_POINTS = {
    "decode_attention_fwd": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                             + [ctypes.c_void_p]),
    "paged_decode_attention_fwd": ([ctypes.c_void_p] * 9
                                   + [ctypes.c_int] * 10
                                   + [ctypes.c_void_p]),
    "decode_attention_fwd_quantized": ([ctypes.c_void_p] * 10
                                       + [ctypes.c_int] * 9
                                       + [ctypes.c_void_p]),
    "paged_decode_attention_fwd_quantized": ([ctypes.c_void_p] * 11
                                             + [ctypes.c_int] * 10
                                             + [ctypes.c_void_p]),
    "decode_attention_fwd_pipelined": ([ctypes.c_void_p] * 8
                                       + [ctypes.c_int] * 10
                                       + [ctypes.c_void_p]),
    "paged_decode_attention_fwd_pipelined": ([ctypes.c_void_p] * 9
                                             + [ctypes.c_int] * 11
                                             + [ctypes.c_void_p]),
    "paged_decode_attention_fwd_quantized_pipelined": (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 11 + [ctypes.c_void_p]),
    "decode_attention_fwd_pipelined_smem": ([ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_longlong)]),
    "decode_attention_fwd_partials": ([ctypes.c_void_p] * 7
                                      + [ctypes.c_int] * 9
                                      + [ctypes.c_void_p]),
    "decode_attention_combine": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                                 + [ctypes.c_void_p]),
}


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_len: torch.Tensor) -> torch.Tensor:
    """The plain version: one masked softmax over the cache in f32; v may
    be narrower than q and k (Dv != Dk), the scale is 1 / sqrt(Dk)."""
    b, hq, d = q.shape
    s, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = hq // hkv
    qf = q.float().reshape(b, hkv, g, d)
    sc = torch.einsum("bhgd,bkhd->bhgk", qf, k.float()) / math.sqrt(d)
    kl = torch.as_tensor(kv_len, device=q.device).to(torch.int64)
    mask = torch.arange(s, device=q.device)[None, :] < kl.clamp(0, s)[:, None]
    mask = mask[:, None, None, :]
    sc = torch.where(mask, sc, NEG_INF)
    p = torch.where(mask, torch.exp(sc - sc.amax(-1, keepdim=True)), 0.0)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    o = o / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return o.reshape(b, hq, dv).to(q.dtype)


def paged_decode_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 page_table: torch.Tensor,
                                 kv_len: torch.Tensor) -> torch.Tensor:
    """The plain version of K3: gather each row's pages back to a
    contiguous [B, P * ps, Hkv, D] cache and run the plain K2.  A table
    entry outside the pool raises (torch indexing)."""
    b, pages = page_table.shape
    ps = k_pool.shape[1]
    pt = page_table.to(torch.long)
    k = k_pool[pt].reshape(b, pages * ps, *k_pool.shape[2:])
    v = v_pool[pt].reshape(b, pages * ps, *v_pool.shape[2:])
    return decode_attention_plain(q, k, v, kv_len)


def decode_attention_quantized_plain(q, k_q, k_scale, v_q, v_scale,
                                    kv_len) -> torch.Tensor:
    """The plain version of K7: dequantize, then K2's plain version (the
    reference oracle ``decode_attention_quant_ref``)."""
    return decode_attention_plain(q, quant.dequantize(k_q, k_scale),
                                  quant.dequantize(v_q, v_scale), kv_len)


def paged_decode_attention_quantized_plain(q, k_pool, k_scale, v_pool,
                                           v_scale, page_table,
                                           kv_len) -> torch.Tensor:
    """The plain version of K8: gather values and scale pages through the
    page table, dequantize, run K2's plain version."""
    b, pages = page_table.shape
    pt = page_table.to(torch.long)

    def rows(pool):   # fp8 pools are gathered as bytes
        got = quant.as_bytes(pool)[pt].view(pool.dtype)
        return got.reshape(b, pages * pool.shape[1], *pool.shape[2:])

    return decode_attention_quantized_plain(
        q, rows(k_pool), rows(k_scale), rows(v_pool), rows(v_scale), kv_len)


def group_blocks(g: int) -> int:
    """The split blocks a KV head's group of ``g`` query heads takes (one
    block each ``QUERY_ROWS`` heads; one at g <= 16)."""
    return -(-g // QUERY_ROWS)


def split_plan(s: int, num_splits: int) -> tuple:
    """(splits, split size) of K2's plan over ``s`` cache rows at a
    requested ``num_splits``: splits of ``ceil(s / num_splits)`` rows, the
    last one short (the plan :func:`route` hands the kernel)."""
    ns = max(1, min(int(num_splits), s))
    size = -(-s // ns)
    return -(-s // size), size


def partials_plan(q: torch.Tensor, k: torch.Tensor,
                  num_splits: Optional[int] = None) -> tuple:
    """(splits, split size) of the plain split kernel's plan over k's S
    rows: :func:`split_plan` at ``num_splits``, or at the analytic pick
    counting every split block (the group's blocks too) where it is
    None."""
    b, hq, _ = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if num_splits is None:
        num_splits = autotune.decode_split_k(
            s, rows=b * hkv * group_blocks(hq // hkv))
    return split_plan(s, num_splits)


def decode_attention_partials_plain(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor, kv_len: torch.Tensor, *,
                                    num_splits: Optional[int] = None
                                    ) -> tuple:
    """The plain version of K2's split kernel, split by split on
    :func:`split_plan`'s plan (``num_splits`` None: the analytic pick,
    counting every split block, the group's blocks too):
    (o_part [B, Hkv, ns, G, Dv] unnormalized, m_part and l_part [B, Hkv,
    ns, G, 1]), all f32, the Pallas kernel's layout.  A split with no row
    below ``kv_len`` (clamped to [0, S]) gives m = NEG_INF, l = 0, o = 0."""
    b, hq, d = q.shape
    s, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = hq // hkv
    ns, size = partials_plan(q, k, num_splits)
    qf = q.float().reshape(b, hkv, g, d)
    kl = torch.as_tensor(kv_len, device=q.device).to(torch.int64)
    kl = torch.broadcast_to(kl, (b,)).clamp(0, s)
    outs = []
    for j in range(ns):
        rows = slice(j * size, min((j + 1) * size, s))
        sc = torch.einsum("bhgd,bkhd->bhgk", qf,
                          k[:, rows].float()) / math.sqrt(d)
        pos = torch.arange(rows.start, rows.stop, device=q.device)
        mask = (pos[None, :] < kl[:, None])[:, None, None, :]
        sc = torch.where(mask, sc, NEG_INF)
        m = sc.amax(-1, keepdim=True)
        p = torch.where(mask, torch.exp(sc - m), 0.0)
        outs.append((torch.einsum("bhgk,bkhd->bhgd", p, v[:, rows].float()),
                     m, p.sum(-1, keepdim=True)))
    return tuple(torch.stack(t, dim=2) for t in zip(*outs))


def decode_combine_plain(o_part: torch.Tensor, m_part: torch.Tensor,
                         l_part: torch.Tensor, dtype) -> torch.Tensor:
    """The plain version of K2's combine (the reference's
    ``kernel.py:117-122``) over partials of any split count: [B, Hq, Dv]
    in ``dtype``; a row whose splits are all empty gets zeros."""
    b, hkv, _, g, dv = o_part.shape
    m_part, l_part = (t.reshape(b, hkv, -1, g, 1) for t in (m_part, l_part))
    w = torch.exp(m_part - m_part.amax(2, keepdim=True))
    o = (o_part * w).sum(2) / (l_part * w).sum(2).clamp_min(1e-30)
    return o.reshape(b, hkv * g, dv).to(dtype)


def num_splits(b: int, hkv: int, s: int, sm_count: int, g: int = 1) -> int:
    """Splits per (row, KV head): enough blocks (B * Hkv *
    :func:`group_blocks` of the group of ``g`` query heads, each split) to
    cover every SM, but no split shorter than ``MIN_SPLIT_ROWS`` cache rows
    (the analytic pick, :func:`repro_torch.core.autotune.decode_split_k`).
    At g <= 16 the blocks are B * Hkv."""
    return autotune.decode_split_k(s, rows=b * hkv * group_blocks(g),
                                   sms=sm_count)


def path(q: torch.Tensor, k: torch.Tensor) -> str:
    """The kernel a CUDA call with this query and K/V storage dtype runs
    inside the library: ``"mma"`` (bf16 q over a bf16 cache or a 1-byte
    one: the tensor-core split kernels, every depth and row address) or
    ``"cuda_cores"`` (f32 q, over an f32 or a 1-byte cache)."""
    return "mma" if q.dtype == torch.bfloat16 else "cuda_cores"


def pipelined_smem(itemsize: int, dk: int, dv: int,
                   path: Optional[str] = None) -> tuple:
    """(base, stage): a K2 / K3 / K7 / K8 (depth 1), K5 / K6 or K9 block
    over a cache of ``itemsize``-byte values holds ``base + depth * stage``
    bytes of shared memory on ``path`` (None: the one served queries take,
    ``"mma"`` over a bf16 or a 1-byte cache, ``"cuda_cores"`` over f32).

    On the tensor cores (csrc/decode_attention.cu) a tile is
    ``autotune.decode_mma_block_k`` rows and the base holds the [16, Dk]
    bf16 query tile (Dk rounded up to 16, rows padded by 16 bytes), the
    [16, block_k] bf16 probabilities padded alike, the 4 warps' 16 row
    maxima and row sums and one more tile of slab indices.  bf16
    (``DecodeMmaSmem``): a stage is one tile's raw K and V rows, each
    padded by 16 bytes, plus its rows' slab indices.  1-byte
    (``QuantDecodeMmaSmem``, K7-K9): a stage is the tile's raw K and V
    bytes (rows of Dk + 16) plus its slab indices, and the base adds the
    bf16 K and V tile they become and the tile's f32 k- and v-scales.
    On the CUDA cores (``SplitRingSmem``, for K5 / K6 / K9): a stage is
    one 32-row tile's raw K rows (each padded by 16 bytes) and V rows plus
    its rows' slab indices; the base the f32 [16, Dk] query tile, [16, 32]
    probabilities, 16 rescales, 32 k- and v-scales and one more tile of
    slab indices."""
    g = QUERY_ROWS
    if path is None:
        path = "cuda_cores" if itemsize == 4 else "mma"
    if path == "mma":
        bk = autotune.decode_mma_block_k(dk, dv)
        k_row, v_row = 2 * (-(-dk // 16) * 16 + 8), 2 * (dv + 8)
        base = g * k_row + 2 * g * (bk + 8) + 2 * 4 * 4 * g + 8 * bk
        if itemsize == 2:
            return base, bk * (k_row + v_row) + 8 * bk
        # the 1-byte kernels are square: raw rows of dk + 16 bytes
        return (base + bk * (k_row + v_row) + 2 * 4 * bk,
                2 * bk * (dk + 16) + 8 * bk)
    bk = autotune.BLOCK_K
    stage = bk * (dk * itemsize + 16 + dv * itemsize) + 8 * bk
    base = 4 * (g * dk + g * bk + g + 2 * bk) + 8 * bk
    return base, stage


def ring_smem_bytes(dk: int, dv: int, depth: int, dtype,
                    store=None) -> int:
    """The shared memory of one K5 / K6 block (a ``dtype`` cache) or K9
    block (``store`` int8 or fp8 values) as the CUDA library lays it out
    (``DecodeMmaSmem`` for bf16, else ``SplitRingSmem``), built on first
    use: the card tests hold :func:`pipelined_smem` to it."""
    got = ctypes.c_longlong()
    lib = _build.load("decode_attention", _ENTRY_POINTS)
    rc = lib.decode_attention_fwd_pipelined_smem(
        dk, dv, depth, _DTYPE_CODES[dtype],
        -1 if store is None else quant.STORE_CODES[store], ctypes.byref(got))
    _build.check(lib, rc, "decode_attention_fwd_pipelined_smem")
    return got.value


@dataclasses.dataclass(frozen=True)
class Route:
    """What a CUDA call of a decode op launches: the kernel's wrapper,
    the split plan over ``rows`` logical cache rows, the ring depth (1:
    the classic kernel) and the library's path for the dtypes
    (:func:`path`)."""
    wrapper: Callable
    num_splits: int
    split_size: int
    num_buffers: int
    path: str


_ROUTES: dict = {}     # memoized resolutions (see :func:`route`)
_MAX_ROUTES = 4096


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
          page_table: Optional[torch.Tensor] = None, quantized: bool = False,
          num_splits: Optional[int] = None,
          num_buffers: Optional[int] = None) -> Route:
    """Resolve a CUDA call of :func:`decode_attention` (``k``, ``v`` a
    cache), :func:`paged_decode_attention` (with ``page_table``; ``k``,
    ``v`` pools) or their quantized forms (``quantized``; ``k`` holds the
    storage dtype).  A knob the caller leaves None comes from the tuning
    db's bucket (the analytic pick on a miss): the split count of the
    contiguous ops (the paged ones keep :func:`num_splits`) and the ring
    depth (the quantized contiguous op has none).  The depth is halved
    until the ring fits the block's shared memory.  Memoized per shapes,
    dtypes, device, knobs and :func:`autotune_search.state`: a serve's
    steady state resolves each call with one dict lookup."""
    key = (q.shape, k.shape, v.shape, q.dtype, k.dtype, q.device,
           None if page_table is None else page_table.shape[1], quantized,
           num_splits, num_buffers, autotune_search.state())
    plan = _ROUTES.get(key)
    if plan is None:
        if len(_ROUTES) >= _MAX_ROUTES:
            _ROUTES.clear()
        plan = _ROUTES[key] = _resolve(q, k, v, page_table, quantized,
                                       num_splits, num_buffers)
    return plan


def _resolve(q, k, v, page_table, quantized, num_splits,
             num_buffers) -> Route:
    b, hq, d = q.shape
    hkv, dv = k.shape[2], v.shape[3]
    store = autotune_search.dtype_name(k.dtype)
    rows = b * hkv         # the tuning buckets' rows (the reference's rule)
    blocks = rows * group_blocks(hq // hkv)   # the analytic pick's
    if page_table is not None:
        ps = k.shape[1]
        s = page_table.shape[1] * ps
        cfg = {}
        if num_buffers is None:
            cfg = autotune_search.lookup_or_search(
                "paged_decode_attention", device=q.device, s=s,
                page_size=ps, d=d, dv=dv, dtype=store, rows=rows)
        ns = autotune.decode_split_k(s, rows=blocks)
        wrappers = ((paged_decode_attention_quantized,
                     paged_decode_attention_quantized_pipelined)
                    if quantized else
                    (paged_decode_attention, paged_decode_attention_pipelined))
    else:
        s = k.shape[1]
        cfg = {}
        if num_splits is None or (num_buffers is None and not quantized):
            cfg = autotune_search.lookup_or_search(
                "decode_attention", device=q.device, s=s, d=d, dv=dv,
                dtype=store, rows=rows)
        # an entry without a split count (a db pinning the depth alone)
        # keeps the analytic one; so does the bucket's own analytic
        # config (a miss, ``REPRO_TUNING=off``), whose count knows only
        # B * Hkv: the analytic pick counts the group's blocks too
        picked = cfg.get("num_splits")
        if picked and cfg == autotune_search.analytic_config(
                "decode_attention", s=s, d=d, dv=dv, dtype=store, rows=rows):
            picked = None
        ns = num_splits if num_splits is not None else (
            picked or autotune.decode_split_k(s, rows=blocks))
        wrappers = ((decode_attention_quantized, None) if quantized else
                    (decode_attention, decode_attention_pipelined))
    depth = 1
    if wrappers[1] is not None:
        depth = int(cfg.get("num_buffers", 1)) if num_buffers is None \
            else num_buffers
        base, stage = pipelined_smem(k.element_size(), d, dv, path(q, k))
        depth = autotune.fit_buffer_depth(depth, stage, base_bytes=base)
    return Route(wrappers[depth > 1], *split_plan(s, ns), depth, path(q, k))


def _check_cuda_inputs(q, k, v, kv_len, *, what="decode_attention",
                       pool=False, scales=None):
    """Checks shared by K2, K3, K7 and K8; ``k``/``v`` are [B, S, Hkv, Dk]
    / [B, S, Hkv, Dv] caches, or [Np, ps, Hkv, Dk] / [.., Dv] pools with no
    batch axis (``pool=True``), (Dk, Dv) in ``HEAD_DIM_PAIRS``; ``scales``
    is (k_scale, v_scale) for a quantized cache (Dk == Dv)."""
    pairs = HEAD_DIM_PAIRS if scales is None else tuple(
        (d, d) for d in HEAD_DIMS)
    if not (k.is_cuda and v.is_cuda and k.device == q.device == v.device):
        raise ValueError(f"{what}: q, k, v must be on one CUDA device")
    if scales is None:
        if q.dtype not in _DTYPE_CODES or not (q.dtype == k.dtype == v.dtype):
            raise ValueError(f"{what}: q, k, v must share a dtype in "
                             f"{list(_DTYPE_CODES)}, got {q.dtype}, "
                             f"{k.dtype}, {v.dtype}")
    else:
        quant.check_cache_inputs(q, k, v, *scales, what=what,
                                 q_dtypes=_DTYPE_CODES)
    if (q.dim() != 3 or k.dim() != 4 or v.dim() != 4
            or k.shape[:3] != v.shape[:3]):
        raise ValueError(f"{what}: q [B,Hq,Dk], k [..,Hkv,Dk] and v "
                         f"[..,Hkv,Dv] of one leading shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, d = q.shape
    hkv = k.shape[2]
    if (not pool and k.shape[0] != b) or k.shape[3] != d or hq % hkv:
        raise ValueError(f"{what}: incompatible shapes "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    if (d, v.shape[3]) not in pairs:
        raise ValueError(f"{what}: head_dim pair (Dk, Dv) = "
                         f"{(d, v.shape[3])} not in {pairs}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{what}: q, k, v must be contiguous")
    # the float kernels and the tensor-core 1-byte kernels read k and v 16
    # bytes a copy; f32 K7 / K8 read a 1-byte cache a word at a time
    # (4-byte aligned; K9's ring is checked where its depth is known)
    if scales is None or path(q, k) == "mma":
        fa_ops.check_aligned(what, q, k, v)
    else:
        fa_ops.check_aligned(what, q, names="q")
    if (kv_len.dtype != torch.int32 or kv_len.device != q.device
            or kv_len.shape != (b,) or not kv_len.is_contiguous()):
        raise ValueError(f"{what}: kv_len must be a contiguous int32 [B] "
                         f"tensor on q's device")


def _check_page_table(page_table, q, what: str) -> None:
    if (page_table.dtype != torch.int32 or page_table.device != q.device
            or page_table.dim() != 2 or page_table.shape[0] != q.shape[0]
            or not page_table.is_contiguous()):
        raise ValueError(f"{what}: page_table must be a contiguous int32 "
                         f"[B, P] tensor on q's device")


def _split_scratch(q, hkv: int, ns: int, dv: int):
    """The f32 scratch of ``ns`` splits: (o_part, m_part, l_part)."""
    b, hq, _ = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    return (torch.empty((b, hkv, ns, hq // hkv, dv), **f32),
            torch.empty((b, hkv, ns, hq // hkv), **f32),
            torch.empty((b, hkv, ns, hq // hkv), **f32))


def _launch(wrapper, q, k, v, kv_len, *, scales=None, page_table=None,
            num_splits=None, num_buffers=None):
    """Check the CUDA inputs of K2 (``wrapper`` = decode_attention), K3
    (with ``page_table``), K7 (with ``scales`` = (k_scale, v_scale)) or K8
    (with both), or of their pipelined forms K5, K6 and K9, resolve the
    call (:func:`route`; the caller's ``wrapper`` launches at its own
    depth), launch the split and combine kernels on the current stream
    and count the launch on the wrapper that ran; returns out.  For
    ``wrapper`` = decode_attention_partials, K2's split kernel alone at
    depth 1: returns (o_part, m_part, l_part), m and l [.., G, 1]."""
    what = wrapper.__name__
    partials = wrapper is decode_attention_partials
    if not q.is_cuda:
        raise ValueError(f"{what}: unsupported device {q.device}")
    paged = page_table is not None
    _check_cuda_inputs(q, k, v, kv_len, what=what, pool=paged, scales=scales)
    pipelined = wrapper.__name__.endswith("_pipelined")
    if pipelined and num_buffers < 2:
        raise ValueError(f"{what}: num_buffers {num_buffers} < 2 (depth 1 "
                         f"is the classic kernel)")
    b, hq, d = q.shape
    hkv = k.shape[2]
    if paged:
        _check_page_table(page_table, q, what)
        shape = (page_table.shape[1], k.shape[1])   # pages, page size
    else:
        shape = (k.shape[1],)                       # cache rows
    rows = math.prod(shape)
    dv = v.shape[3]
    out = q.new_empty((b, hq, dv))
    if partials and out.numel() * rows == 0:
        raise ValueError(f"{what}: no cache rows or no query rows")
    if out.numel() == 0 or rows == 0:
        return out.zero_()
    plan = route(q, k, v, page_table=page_table, quantized=scales is not None,
                 num_splits=num_splits, num_buffers=num_buffers)
    if pipelined or partials:        # the caller's depth, as given
        plan = dataclasses.replace(plan, wrapper=wrapper,
                                   num_buffers=num_buffers)
    if plan.num_buffers > 1 and scales is not None:
        # f32 K9's cp.async reads the 1-byte pools 16 bytes at a time,
        # whether the caller or the tuning db chose the ring
        fa_ops.check_aligned(what, k, v, names="k, v")
    wrapper = plan.wrapper
    o_part, m_part, l_part = _split_scratch(q, hkv, plan.num_splits, dv)
    values = [k, v] if scales is None else [k, scales[0], v, scales[1]]
    tables = [page_table] if paged else []
    store = [] if scales is None else [quant.STORE_CODES[k.dtype]]
    dims = [d] if store else [d, dv]     # K7, K8 and K9 are square
    ring = [plan.num_buffers] if plan.num_buffers > 1 else []
    entry = ("paged_" if paged else "") + "decode_attention_fwd" + (
        "_quantized" if store else "") + ("_pipelined" if ring else "") + (
        "_partials" if partials else "")
    lib = _build.load("decode_attention", _ENTRY_POINTS)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, entry)(
            *(t.data_ptr() for t in (q, *values, *tables, kv_len, o_part,
                                     m_part, l_part,
                                     *([] if partials else [out]))),
            b, *shape, hq, hkv, *dims, plan.num_splits, plan.split_size,
            *ring, _DTYPE_CODES[q.dtype], *store, stream)
    _build.check(lib, rc, entry)
    wrapper.launches += 1
    wrapper.path_launches[plan.path] += 1    # and by the library's path
    if partials:
        return o_part, m_part[..., None], l_part[..., None]
    return out


def _meta_out(q, v) -> torch.Tensor:
    """out [B, Hq, Dv] of a decode on meta tensors."""
    return q.new_empty((*q.shape[:2], v.shape[-1]))


def _meta_partials(q, k, v, num_splits) -> tuple:
    """(o_part, m_part, l_part) of K2's split kernel on meta tensors, at
    the plain version's split plan."""
    b, hq, _ = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    g = hq // hkv
    ns, _ = partials_plan(q, k, num_splits)
    f32 = dict(dtype=torch.float32)
    return (q.new_empty((b, hkv, ns, g, dv), **f32),
            q.new_empty((b, hkv, ns, g, 1), **f32),
            q.new_empty((b, hkv, ns, g, 1), **f32))


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, *,
                     num_splits: Optional[int] = None,
                     num_buffers: Optional[int] = None) -> torch.Tensor:
    """K2 (split kernel + combine kernel), or K5 at the depth
    :func:`route` resolves, on a CUDA tensor; the plain version on a CPU
    tensor."""
    with work.call("decode_attention", work.decode, q, k, v, kv_len):
        if q.device.type == "meta":
            return _meta_out(q, v)
        if q.device.type == "cpu":
            return decode_attention_plain(q, k, v, kv_len)
        return _launch(decode_attention, q, k, v, kv_len,
                       num_splits=num_splits, num_buffers=num_buffers)


decode_attention.launches = 0   # kernel launches since the last reset
decode_attention.path_launches = Counter()


def decode_attention_partials(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, kv_len: torch.Tensor, *,
                              num_splits: Optional[int] = None) -> tuple:
    """K2's split kernel alone (depth 1, the classic plan or the caller's
    ``num_splits``) on a CUDA tensor; the plain version,
    :func:`decode_attention_partials_plain`, on a CPU tensor.  Returns
    (o_part [B, Hkv, ns, G, Dv], m_part, l_part [B, Hkv, ns, G, 1]), f32:
    what :func:`decode_combine` sums, alone or beside other row blocks'
    partials.  At the split plan :func:`decode_attention` resolves, the
    combine of these partials is its output bit for bit."""
    with work.call("decode_attention_partials", work.partials, q, k, v,
                   kv_len, num_splits=num_splits):
        if q.device.type == "meta":
            return _meta_partials(q, k, v, num_splits)
        if q.device.type == "cpu":
            return decode_attention_partials_plain(q, k, v, kv_len,
                                                   num_splits=num_splits)
        return _launch(decode_attention_partials, q, k, v, kv_len,
                       num_splits=num_splits, num_buffers=1)


decode_attention_partials.launches = 0   # launches since the last reset
decode_attention_partials.path_launches = Counter()


def decode_combine(o_part: torch.Tensor, m_part: torch.Tensor,
                   l_part: torch.Tensor, dtype) -> torch.Tensor:
    """K2's combine kernel alone on CUDA partials (any split count, laid
    out as :func:`decode_attention_partials` returns them), out [B, Hq,
    Dv] in ``dtype`` (f32 or bf16); the plain version,
    :func:`decode_combine_plain`, on CPU tensors."""
    with work.call("decode_combine", work.combine, o_part, m_part, l_part,
                   dtype):
        if o_part.device.type == "meta":
            b, hkv, _, g, dv = o_part.shape
            return o_part.new_empty((b, hkv * g, dv), dtype=dtype)
        if o_part.device.type == "cpu":
            return decode_combine_plain(o_part, m_part, l_part, dtype)
        return _launch_combine(o_part, m_part, l_part, dtype)


def _launch_combine(o_part, m_part, l_part, dtype) -> torch.Tensor:
    """Check the combine's CUDA inputs, launch it, count the launch."""
    what = "decode_combine"
    if o_part.dim() != 5:
        raise ValueError(f"{what}: o_part must be [B, Hkv, ns, G, Dv], got "
                         f"{tuple(o_part.shape)}")
    b, hkv, ns, g, dv = o_part.shape
    for name, t in (("o_part", o_part), ("m_part", m_part),
                    ("l_part", l_part)):
        if (t.dtype != torch.float32 or t.device != o_part.device
                or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be contiguous f32 on "
                             f"o_part's device")
    if m_part.shape != (b, hkv, ns, g, 1) or l_part.shape != m_part.shape:
        raise ValueError(f"{what}: m_part and l_part must be "
                         f"{(b, hkv, ns, g, 1)}, got {tuple(m_part.shape)}, "
                         f"{tuple(l_part.shape)}")
    if dtype not in _DTYPE_CODES or ns == 0:
        raise ValueError(f"{what}: out dtype {dtype} not in "
                         f"{list(_DTYPE_CODES)}, or no splits")
    out = o_part.new_empty((b, hkv * g, dv), dtype=dtype)
    if out.numel() == 0:
        return out
    lib = _build.load("decode_attention", _ENTRY_POINTS)
    with torch.cuda.device(o_part.device):
        stream = torch.cuda.current_stream(o_part.device).cuda_stream
        rc = lib.decode_attention_combine(
            *(t.data_ptr() for t in (o_part, m_part, l_part, out)),
            b, hkv * g, hkv, ns, dv, _DTYPE_CODES[dtype], stream)
    _build.check(lib, rc, "decode_attention_combine")
    decode_combine.launches += 1
    return out


decode_combine.launches = 0   # kernel launches since the last reset


def decode_attention_pipelined(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, kv_len: torch.Tensor, *,
                               num_splits: Optional[int] = None,
                               num_buffers: int = 2) -> torch.Tensor:
    """K5 with a ``num_buffers``-stage ring on a CUDA tensor (a depth the
    library is not built for, or whose ring does not fit, raises); the
    plain version, :func:`decode_attention_plain`, on a CPU tensor.  At
    K2's split plan (``num_splits`` None: the one :func:`route` resolves)
    it returns K2's output bit for bit."""
    with work.call("decode_attention_pipelined", work.decode, q, k, v, kv_len):
        if q.device.type == "meta":
            return _meta_out(q, v)
        if q.device.type == "cpu":
            return decode_attention_plain(q, k, v, kv_len)
        return _launch(decode_attention_pipelined, q, k, v, kv_len,
                       num_splits=num_splits, num_buffers=num_buffers)


decode_attention_pipelined.launches = 0   # launches since the last reset
decode_attention_pipelined.path_launches = Counter()


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           kv_len: torch.Tensor, *,
                           num_buffers: Optional[int] = None) -> torch.Tensor:
    """K3 (K2's split kernel over the page table + K2's combine kernel),
    or K6 at the depth :func:`route` resolves, on a CUDA tensor; the plain
    version on a CPU tensor.  Splits are planned over the P * ps logical
    rows exactly as K2 plans them over S rows.  Table entries must lie in
    [0, Np): the kernel reads them unchecked (checking would cost a
    device-to-host sync per call)."""
    with work.call("paged_decode_attention", work.paged, q, k_pool, v_pool,
                   page_table, kv_len):
        if q.device.type == "meta":
            return _meta_out(q, v_pool)
        if q.device.type == "cpu":
            return paged_decode_attention_plain(q, k_pool, v_pool, page_table,
                                                kv_len)
        return _launch(paged_decode_attention, q, k_pool, v_pool, kv_len,
                       page_table=page_table, num_buffers=num_buffers)


paged_decode_attention.launches = 0   # kernel launches since the last reset
paged_decode_attention.path_launches = Counter()


def paged_decode_attention_pipelined(q: torch.Tensor, k_pool: torch.Tensor,
                                     v_pool: torch.Tensor,
                                     page_table: torch.Tensor,
                                     kv_len: torch.Tensor, *,
                                     num_buffers: int = 2) -> torch.Tensor:
    """K6 with a ``num_buffers``-stage ring on a CUDA tensor (raises as
    :func:`decode_attention_pipelined` does); the plain version,
    :func:`paged_decode_attention_plain`, on a CPU tensor.  Returns K3's
    output bit for bit, whatever the page placement."""
    with work.call("paged_decode_attention_pipelined", work.paged, q, k_pool,
                   v_pool, page_table, kv_len):
        if q.device.type == "meta":
            return _meta_out(q, v_pool)
        if q.device.type == "cpu":
            return paged_decode_attention_plain(q, k_pool, v_pool, page_table,
                                                kv_len)
        return _launch(paged_decode_attention_pipelined, q, k_pool, v_pool,
                       kv_len, page_table=page_table, num_buffers=num_buffers)


paged_decode_attention_pipelined.launches = 0   # launches since last reset
paged_decode_attention_pipelined.path_launches = Counter()


def decode_attention_quantized(q: torch.Tensor, k_q: torch.Tensor,
                               k_scale: torch.Tensor, v_q: torch.Tensor,
                               v_scale: torch.Tensor,
                               kv_len: torch.Tensor, *,
                               num_splits: Optional[int] = None
                               ) -> torch.Tensor:
    """K7 (the split kernel of :func:`path` over int8 / fp8 values and f16
    scales + K2's combine kernel) on a CUDA tensor, the plain version on a
    CPU tensor.  bf16 q needs k_q and v_q 16-byte aligned.  The split count
    resolves under the storage dtype's bucket; K7 has no staging ring (as
    in the reference)."""
    with work.call("decode_attention_quantized", work.decode_quantized, q, k_q,
                   k_scale, v_q, v_scale, kv_len):
        if q.device.type == "meta":
            return _meta_out(q, v_q)
        if q.device.type == "cpu":
            return decode_attention_quantized_plain(q, k_q, k_scale, v_q,
                                                    v_scale, kv_len)
        return _launch(decode_attention_quantized, q, k_q, v_q, kv_len,
                       scales=(k_scale, v_scale), num_splits=num_splits)


decode_attention_quantized.launches = 0   # launches since the last reset
decode_attention_quantized.path_launches = Counter()


def paged_decode_attention_quantized(q: torch.Tensor, k_pool: torch.Tensor,
                                     k_scale: torch.Tensor,
                                     v_pool: torch.Tensor,
                                     v_scale: torch.Tensor,
                                     page_table: torch.Tensor,
                                     kv_len: torch.Tensor, *,
                                     num_buffers: Optional[int] = None
                                     ) -> torch.Tensor:
    """K8 (K3 over quantized value pages and f16 scale pages, named by the
    same page table), or K9 at the depth :func:`route` resolves, on a
    CUDA tensor; the plain version on a CPU tensor.  Table entries must
    lie in [0, Np), unchecked as for K3."""
    with work.call("paged_decode_attention_quantized", work.paged_quantized, q,
                   k_pool, k_scale, v_pool, v_scale, page_table, kv_len):
        if q.device.type == "meta":
            return _meta_out(q, v_pool)
        if q.device.type == "cpu":
            return paged_decode_attention_quantized_plain(
                q, k_pool, k_scale, v_pool, v_scale, page_table, kv_len)
        return _launch(paged_decode_attention_quantized, q, k_pool, v_pool,
                       kv_len, scales=(k_scale, v_scale),
                       page_table=page_table, num_buffers=num_buffers)


paged_decode_attention_quantized.launches = 0   # launches since last reset
paged_decode_attention_quantized.path_launches = Counter()


def paged_decode_attention_quantized_pipelined(
        q: torch.Tensor, k_pool: torch.Tensor, k_scale: torch.Tensor,
        v_pool: torch.Tensor, v_scale: torch.Tensor,
        page_table: torch.Tensor, kv_len: torch.Tensor, *,
        num_buffers: int = 2) -> torch.Tensor:
    """K9 with a ``num_buffers``-stage ring on a CUDA tensor (raises as
    :func:`decode_attention_pipelined` does; the pools must start 16-byte
    aligned, as for bf16 K7 and K8); the plain version,
    :func:`paged_decode_attention_quantized_plain`, on a CPU tensor.
    Returns K8's output bit for bit."""
    with work.call("paged_decode_attention_quantized_pipelined",
                   work.paged_quantized, q, k_pool, k_scale, v_pool, v_scale,
                   page_table, kv_len):
        if q.device.type == "meta":
            return _meta_out(q, v_pool)
        if q.device.type == "cpu":
            return paged_decode_attention_quantized_plain(
                q, k_pool, k_scale, v_pool, v_scale, page_table, kv_len)
        return _launch(paged_decode_attention_quantized_pipelined, q, k_pool,
                       v_pool, kv_len, scales=(k_scale, v_scale),
                       page_table=page_table, num_buffers=num_buffers)


paged_decode_attention_quantized_pipelined.launches = 0   # since last reset
paged_decode_attention_quantized_pipelined.path_launches = Counter()
