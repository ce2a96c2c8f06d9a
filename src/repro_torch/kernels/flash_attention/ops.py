"""K1: flash-attention forward, and K10, the same over a quantized KV
cache — the CUDA kernels' wrappers and their plain PyTorch versions.

Port of ``repro.kernels.flash_attention`` (Pallas ``flash_attention_fwd``).
Unlike the Pallas op, both versions take the valid KV length ``kv_len``
(an int or a [B] int tensor) and the absolute position ``q_offset`` of
query 0; ``None``/``None`` mean every KV row is valid and the suffix
alignment ``Skv - Sq`` the Pallas kernel computes.  With those two
arguments one call is what the model's prefill needs: causal attention of
the new tokens against the whole ``max_len`` cache, of which only the
first ``kv_len`` rows are live.

Layout: q [B, Sq, Hq, Dk]; k [B, Skv, Hkv, Dk]; v [B, Skv, Hkv, Dv];
Hq = G * Hkv.  Returns (out [B, Sq, Hq, Dv] in q's dtype, lse [B, Hq, Sq]
f32).  A query row that sees no KV row at all gets out = 0 and lse ~
NEG_INF in both versions.  K1 takes the (Dk, Dv) pairs of
``HEAD_DIM_PAIRS``: the square head dims of the dense decoder and of the
hybrid family's shared attention block (80), and MLA's prefill shapes,
where the query/key width (qk_nope + qk_rope) exceeds v's (192 / 128 at
full width, 24 / 16 in the reduced config).

K10 (port of ``flash_attention_fwd_quantized``) takes k and v as int8 or
fp8 e4m3 values with f16 scales [B, Skv, Hkv, 1] beside them, and keeps
K1's ``kv_len`` and ``q_offset``; it takes square head dims only
(``HEAD_DIMS``; 80 for the hybrid family's shared block).

K4 (port of ``flash_attention_fwd_pipelined``) is bf16 K1 with its KV
tiles staged through a ``num_buffers``-stage ring (2 or 4) and gives K1's
out and lse bit for bit, so its plain version is K1's,
:func:`flash_attention_plain`.  f32 has no ring: f32 K1 runs at depth 1
and an f32 K4 call on the card raises.  :func:`flash_attention` resolves
the depth and the bf16 tile ``(block_q, block_k)`` per call
(:func:`route`): the caller's, else the depth and block_q the tuning db
picked for this shape bucket (``core/autotune_search``; depth 1 and 64
rows on a miss or under ``REPRO_TUNING=off``) and block_k
``autotune.MMA_BLOCK_K`` (64), the depth fitted to the 227 KB of shared
memory a block may use; depth 1 launches K1, a deeper ring K4.  The tiles
are the library's instances (:func:`tile_options`): 64 x 64 at every (Dk,
Dv), at (128, 128) also 16 or 128 query rows by 32 or 64 KV rows; block_q
and the depth keep the bits, block_k moves the online softmax's rescale
points (out within its bf16 rounding).  So a db may move no served bit:
the search still times block_k, but only a caller's ``block_k=`` runs
it.  A tile the library has not built raises.

The query's dtype picks the kernels inside the library (:func:`path`):
bf16 calls of K1, K4, K10 and K11 run their products on the tensor cores
(``mma.sync`` on raw bf16 tiles; K1 is the depth-1 instance of K4's
kernel; K10 converts each 1-byte tile to bf16 once per block and runs
K1's per-tile arithmetic with the scales), f32 calls on the CUDA cores
(the parity dtype, held to 1e-4).  A call neither path takes raises:
nothing falls back to the other path or to a plain version.  Each wrapper
counts its launches, and by path in ``path_launches``; K11's also by
(Sq, Skv, Hq, Hkv, Dk, Dv, causal) in ``shape_launches``.

K11 (port of ``flash_attention_bwd``) is the backward of K1 at K1's
``HEAD_DIM_PAIRS`` (MLA's Dk != Dv included) with every KV row valid and
the suffix alignment ``Skv - Sq``: from q, k, v, out, lse
and the incoming gradient ``do`` it recomputes the probabilities and
returns (dq, dk, dv) in the dtypes of q, k, v.  ``FlashAttentionFunction``
puts K1 (or K4, where the db says so) and K11 under autograd (the
reference's ``custom_vjp``); on a CPU tensor both run their plain versions.

Every wrapper reports its work to the active count once per call
(``kernels/work.py``).  On a meta tensor (the dry run) a wrapper runs
nothing and returns outputs of the right shapes and dtypes.
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter
from typing import Callable, NamedTuple, Optional, Union

import torch

from repro_torch.core import autotune, autotune_search
from repro_torch.kernels import _build
from repro_torch.kernels import quant
from repro_torch.kernels import work

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 80, 128)      # K10: Dk == Dv
# (Dk, Dv) pairs K1 and K11 are built for (``FwdDims`` in
# csrc/flash_attention.cu): the square head dims and MLA's prefill pairs
HEAD_DIM_PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128), (24, 16))
# the (Dk, Dv) pairs whose bf16 forward is built at every tile of
# TUNED_TILES (``fwd_tile_built``): the dense decoder's
TUNED_TILE_PAIRS = ((128, 128),)
TUNED_TILES = tuple((bq, bk) for bq in (16, 64, 128) for bk in (32, 64))
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class FlashPlan(NamedTuple):
    """What :func:`route` resolves for a K1 / K4 call: the wrapper that
    launches (K1 at depth 1, else K4), the ring depth and the tile."""

    wrapper: Callable
    num_buffers: int
    block_q: int
    block_k: int


def tile_options(dk: int, dv: int, dtype=torch.bfloat16) -> tuple:
    """The (block_q, block_k) tiles K1 / K4 are built for at (Dk, Dv) and
    the query's dtype: bf16 (the tensor cores) 64 x 64, and at
    ``TUNED_TILE_PAIRS`` every tile of ``TUNED_TILES``; f32 (the CUDA
    cores) its one 16 x 32 tile."""
    if dtype != torch.bfloat16:
        return ((autotune.BLOCK_Q, autotune.BLOCK_K),)
    if (dk, dv) in TUNED_TILE_PAIRS:
        return TUNED_TILES
    return ((autotune.MMA_BLOCK_Q, autotune.MMA_BLOCK_K),)


def library_tiles(dk: int, dv: int) -> tuple:
    """The bf16 tiles the CUDA library reports it builds at (Dk, Dv)
    (``flash_attention_fwd_tiles``), built on first use: the card tests
    hold :func:`tile_options` to them."""
    lib = _build.load("flash_attention", _ENTRY_POINTS)
    out = (ctypes.c_int * 32)()
    n = lib.flash_attention_fwd_tiles(dk, dv, out, 16)
    return tuple((out[2 * i], out[2 * i + 1]) for i in range(n))

KvLen = Union[None, int, torch.Tensor]


def path(q: torch.Tensor) -> str:
    """The kernel a CUDA call of K1, K4, K10 or K11 with this query runs
    inside the library: ``"mma"`` (bf16: the tensor-core kernels, K10 over
    its 1-byte tiles converted to bf16) or ``"cuda_cores"`` (f32)."""
    return "mma" if q.dtype == torch.bfloat16 else "cuda_cores"


def _kv_len_rows(kv_len: KvLen, b: int, skv: int,
                 device: torch.device) -> torch.Tensor:
    if kv_len is None:
        return torch.full((b,), skv, dtype=torch.int64, device=device)
    kl = torch.as_tensor(kv_len, device=device).to(torch.int64)
    return torch.broadcast_to(kl, (b,)).clamp(0, skv)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, kv_len: KvLen = None,
                          q_offset: Optional[int] = None,
                          block_k: int = 128):
    """The plain version: online softmax over KV blocks of ``block_k``
    rows in f32 (the reference's ``chunked_attention`` with ``lse``).
    Masked scores contribute exactly zero.  v may be narrower than q and
    k (Dv != Dk); the scale is 1 / sqrt(Dk)."""
    b, sq, hq, d = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = hq // hkv
    dev = q.device
    offset = skv - sq if q_offset is None else int(q_offset)
    qpos = torch.arange(sq, device=dev) + offset
    kl = _kv_len_rows(kv_len, b, skv, dev)
    qf = (q.float() / math.sqrt(d)).reshape(b, sq, hkv, g, d)
    m = torch.full((b, sq, hkv, g), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, sq, hkv, g), dtype=torch.float32, device=dev)
    o = torch.zeros((b, sq, hkv, g, dv), dtype=torch.float32, device=dev)
    for k0 in range(0, skv, block_k):
        kb = k[:, k0:k0 + block_k].float()
        vb = v[:, k0:k0 + block_k].float()
        kpos = torch.arange(k0, k0 + kb.shape[1], device=dev)
        mask = (kpos[None, None, :] < kl[:, None, None]).expand(
            b, sq, kb.shape[1])
        if causal:
            mask = mask & (kpos[None, None, :] <= qpos[None, :, None])
        mask = mask[:, :, None, None, :]                  # [B,Sq,1,1,bk]
        s = torch.einsum("bqhgd,bkhd->bqhgk", qf, kb)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + torch.einsum("bqhgk,bkhd->bqhgd", p, vb)
        m = m_new
    l = l.clamp_min(1e-30)
    out = (o / l[..., None]).reshape(b, sq, hq, dv).to(q.dtype)
    lse = (m + torch.log(l)).reshape(b, sq, hq).permute(0, 2, 1).contiguous()
    return out, lse


def flash_attention_quantized_plain(q, k_q, k_scale, v_q, v_scale, *,
                                    causal: bool = True,
                                    kv_len: KvLen = None,
                                    q_offset: Optional[int] = None,
                                    block_k: int = 128):
    """The plain version of K10: dequantize, then K1's plain version (the
    reference oracle ``flash_attention_quant_ref``, with K1's ``kv_len``
    and ``q_offset``)."""
    return flash_attention_plain(
        q, quant.dequantize(k_q, k_scale), quant.dequantize(v_q, v_scale),
        causal=causal, kv_len=kv_len, q_offset=q_offset, block_k=block_k)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor, *,
                              causal: bool = True, block_k: int = 128):
    """The plain version of K11: the flash backward's recompute in f32
    over KV blocks of ``block_k`` rows, as the kernel computes it.

    q and k have Dk columns, v, out and do Dv (Dv may differ from Dk, as
    in MLA's prefill).  With ``qs = q / sqrt(Dk)``: ``dd = rowsum(do *
    out)`` over Dv, ``p = exp(qs.k - lse)`` (exactly 0 where masked, so a
    row that sees no KV row contributes nothing), ``ds = p * (do.v -
    dd)``; ``dv = p^T do``, ``dk = ds^T qs``, ``dq = ds k / sqrt(Dk)``.
    GQA sums each group's q-head contributions in f32 and rounds once."""
    b, sq, hq, d = q.shape
    skv, hkv, dv_ = k.shape[1], k.shape[2], v.shape[-1]
    g = hq // hkv
    dev = q.device
    qs = (q.float() / math.sqrt(d)).reshape(b, sq, hkv, g, d)
    dof = do.float().reshape(b, sq, hkv, g, dv_)
    dd = (dof * out.float().reshape(b, sq, hkv, g, dv_)).sum(-1)
    lse_r = lse.float().permute(0, 2, 1).reshape(b, sq, hkv, g)
    qpos = torch.arange(sq, device=dev) + (skv - sq)
    dq = torch.zeros((b, sq, hkv, g, d), dtype=torch.float32, device=dev)
    dk = torch.zeros((b, skv, hkv, d), dtype=torch.float32, device=dev)
    dv = torch.zeros((b, skv, hkv, dv_), dtype=torch.float32, device=dev)
    for k0 in range(0, skv, block_k):
        kb = k[:, k0:k0 + block_k].float()
        vb = v[:, k0:k0 + block_k].float()
        n = kb.shape[1]
        s = torch.einsum("bqhgd,bkhd->bqhgk", qs, kb)
        p = torch.exp(s - lse_r[..., None])
        if causal:
            kpos = torch.arange(k0, k0 + n, device=dev)
            mask = kpos[None, :] <= qpos[:, None]               # [Sq, n]
            p = torch.where(mask[None, :, None, None, :], p, 0.0)
        dp = torch.einsum("bqhgd,bkhd->bqhgk", dof, vb)
        ds = p * (dp - dd[..., None])
        dv[:, k0:k0 + n] = torch.einsum("bqhgk,bqhgd->bkhd", p, dof)
        dk[:, k0:k0 + n] = torch.einsum("bqhgk,bqhgd->bkhd", ds, qs)
        dq += torch.einsum("bqhgk,bkhd->bqhgd", ds, kb)
    dq = (dq / math.sqrt(d)).reshape(b, sq, hq, d)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_ENTRY_POINTS = {
    "flash_attention_fwd": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 13
                            + [ctypes.c_void_p]),
    "flash_attention_fwd_quantized": ([ctypes.c_void_p] * 8
                                      + [ctypes.c_int] * 11
                                      + [ctypes.c_void_p]),
    "flash_attention_bwd": ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 9
                            + [ctypes.c_void_p]),
    "flash_attention_fwd_pipelined": ([ctypes.c_void_p] * 6
                                      + [ctypes.c_int] * 14
                                      + [ctypes.c_void_p]),
    "flash_attention_fwd_pipelined_smem": ([ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_longlong)]),
    "flash_attention_fwd_tiles": [ctypes.c_int] * 2 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int],
}


def pipelined_smem(itemsize: int, dk: int, dv: int, *,
                   block_q: int = autotune.MMA_BLOCK_Q,
                   block_k: int = autotune.MMA_BLOCK_K) -> tuple:
    """(base, stage): a bf16 K4 block at this tile holds ``base + depth *
    stage`` bytes of shared memory (``MmaFwdSmem`` in
    csrc/flash_attention.cu): a stage is one ``block_k``-row tile's raw K
    rows (Dk rounded up to 16) and V rows, each row padded by 16 bytes;
    the base the [block_q, Dk] query tile, padded alike.  Only bf16
    (``itemsize`` 2) has a ring."""
    if itemsize != 2:
        raise ValueError(f"pipelined_smem: only the bf16 forward has a "
                         f"ring (itemsize 2), got itemsize {itemsize}")
    k_row = 2 * (-(-dk // 16) * 16 + 8)
    return block_q * k_row, block_k * (k_row + 2 * (dv + 8))


_ROUTES: dict = {}     # memoized resolutions (see :func:`route`)
_MAX_ROUTES = 4096


def ring_smem_bytes(dk: int, dv: int, depth: int, dtype, *,
                    block_q: int = autotune.MMA_BLOCK_Q,
                    block_k: int = autotune.MMA_BLOCK_K) -> int:
    """The shared memory of one bf16 K4 block at this tile as the CUDA
    library lays it out (``MmaFwdSmem``), built on first use: the card
    tests hold :func:`pipelined_smem` to it."""
    if dtype != torch.bfloat16:
        raise ValueError(f"ring_smem_bytes: only the bf16 forward has a "
                         f"ring, got {dtype}")
    got = ctypes.c_longlong()
    lib = _build.load("flash_attention", _ENTRY_POINTS)
    rc = lib.flash_attention_fwd_pipelined_smem(
        dk, dv, block_q, block_k, depth, ctypes.byref(got))
    _build.check(lib, rc, "flash_attention_fwd_pipelined_smem")
    return got.value


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
          causal: bool = True, num_buffers: Optional[int] = None,
          block_q: Optional[int] = None,
          block_k: Optional[int] = None) -> FlashPlan:
    """What a CUDA call of :func:`flash_attention` launches
    (:class:`FlashPlan`): ``flash_attention`` (K1) at depth 1, else
    ``flash_attention_pipelined`` (K4), at a bf16 tile.  A depth or
    block_q left None is the tuning db's for this bucket (depth 1 and 64
    rows on a miss), a block_k left None ``autotune.MMA_BLOCK_K``: the
    db's block_k would move the bits; the depth is then halved until the
    ring fits the block's shared memory.  f32 runs K1 at depth 1 and its
    one tile (it has no ring).  A tile not in :func:`tile_options`
    raises.  Memoized per shapes, dtype,
    device, knobs and :func:`autotune_search.state`."""
    key = (q.shape, k.shape[1], v.shape[-1], q.dtype, q.device, causal,
           num_buffers, block_q, block_k, autotune_search.state())
    got = _ROUTES.get(key)
    if got is None:
        if len(_ROUTES) >= _MAX_ROUTES:
            _ROUTES.clear()
        got = _ROUTES[key] = _resolve(q, k, v, causal, num_buffers,
                                      block_q, block_k)
    return got


def _resolve(q, k, v, causal, num_buffers, block_q, block_k) -> FlashPlan:
    b, sq, hq, d = q.shape
    dv = v.shape[-1]
    options = tile_options(d, dv, q.dtype)
    if q.dtype != torch.bfloat16:
        tile = (options[0] if block_q is None and block_k is None
                else (block_q, block_k))
        if tile not in options:
            raise ValueError(f"flash_attention: tile {tile} is not built for "
                             f"{q.dtype}; built: {options}")
        return FlashPlan(flash_attention, 1, *tile)
    cfg = {}
    if None in (num_buffers, block_q):
        cfg = autotune_search.lookup_or_search(
            "flash_attention", device=q.device, sq=sq, skv=k.shape[1], d=d,
            dv=dv, dtype=autotune_search.dtype_name(q.dtype), causal=causal)
    if num_buffers is None:
        num_buffers = int(cfg.get("num_buffers", 1))
    tile = (int(cfg.get("block_q", autotune.MMA_BLOCK_Q))
            if block_q is None else block_q,
            autotune.MMA_BLOCK_K if block_k is None else block_k)
    if tile not in options:
        raise ValueError(f"flash_attention: tile {tile} is not built at "
                         f"(Dk, Dv) = {(d, dv)}; built: {options}")
    base, stage = pipelined_smem(2, d, dv, block_q=tile[0],
                                 block_k=tile[1])
    depth = autotune.fit_buffer_depth(num_buffers, stage, base_bytes=base)
    return FlashPlan(flash_attention_pipelined if depth > 1
                     else flash_attention, depth, *tile)


def _check_cuda_inputs(q, k, v, scales=None):
    """Checks of K1 and K11 (over ``HEAD_DIM_PAIRS``) and K10 (with
    ``scales``, over the square ``HEAD_DIMS``): q [B, Sq, Hq, Dk], k [B,
    Skv, Hkv, Dk], v [B, Skv, Hkv, Dv] with (Dk, Dv) in the pairs."""
    pairs = HEAD_DIM_PAIRS
    if scales is not None:
        pairs = tuple((d, d) for d in HEAD_DIMS)
    if not (k.is_cuda and v.is_cuda and k.device == q.device == v.device):
        raise ValueError("flash_attention: q, k, v must be on one CUDA device")
    if scales is not None:
        quant.check_cache_inputs(q, k, v, *scales,
                                 what="flash_attention_quantized",
                                 q_dtypes=_DTYPE_CODES)
    elif q.dtype not in _DTYPE_CODES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention: q, k, v must share a dtype in "
                         f"{list(_DTYPE_CODES)}, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if (q.dim() != 4 or k.dim() != 4 or v.dim() != 4
            or k.shape[:3] != v.shape[:3]):
        raise ValueError(f"flash_attention: q [B,Sq,Hq,Dk], k [B,Skv,Hkv,Dk]"
                         f", v [B,Skv,Hkv,Dv], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[2]:
        raise ValueError(f"flash_attention: incompatible shapes "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    if (d, v.shape[3]) not in pairs:
        raise ValueError(f"flash_attention: head_dim pair (Dk, Dv) = "
                         f"{(d, v.shape[3])} not in {pairs}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    # the float kernels and bf16 K10's ring read k and v 16 bytes a load;
    # f32 K10 reads its 1-byte k and v a word at a time (4-byte aligned)
    if scales is None or path(q) == "mma":
        check_aligned("flash_attention", q, k, v)
    else:
        check_aligned("flash_attention", q, names="q")


def check_aligned(what: str, *tensors, names: str = "q, k, v") -> None:
    """The kernels read q (and a float or bf16 K10's cache) 16 bytes at a
    time."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: {names} must start 16-byte aligned (the "
                         f"kernels read them 16 bytes a load)")


def _launch(wrapper, q, k, v, *, scales=None, causal, kv_len, q_offset,
            num_buffers: Optional[int] = None, block_q: Optional[int] = None,
            block_k: Optional[int] = None):
    """Check the CUDA inputs of K1 (``wrapper`` = flash_attention, at the
    depth and tile :func:`route` resolves: K4 above depth 1), K4
    (flash_attention_pipelined, at ``num_buffers`` as given and the tile
    given or 64 x 64) or K10 (with ``scales`` = (k_scale, v_scale), its
    one tile), launch the kernel on the current stream and count the
    launch on the wrapper that ran, by path and by tile too; returns
    (out, lse)."""
    if not q.is_cuda:
        raise ValueError(f"{wrapper.__name__}: unsupported device "
                         f"{q.device}")
    _check_cuda_inputs(q, k, v, scales)
    depth, tile = 1, ()
    if wrapper is flash_attention:
        wrapper, depth, *tile = route(q, k, v, causal=causal,
                                      num_buffers=num_buffers,
                                      block_q=block_q, block_k=block_k)
    elif wrapper is flash_attention_pipelined:
        if q.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention_pipelined: {q.dtype} has no "
                             f"ring (f32 K1 runs at depth 1: "
                             f"flash_attention)")
        depth = num_buffers
        tile = (autotune.MMA_BLOCK_Q if block_q is None else block_q,
                autotune.MMA_BLOCK_K if block_k is None else block_k)
        if tile not in tile_options(q.shape[3], v.shape[3]):
            raise ValueError(f"flash_attention_pipelined: tile {tile} is "
                             f"not built at (Dk, Dv) = "
                             f"{(q.shape[3], v.shape[3])}")
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    rows, all_len = None, skv
    if isinstance(kv_len, torch.Tensor) and kv_len.dim() == 1:
        if (kv_len.dtype != torch.int32 or kv_len.device != q.device
                or kv_len.shape != (b,) or not kv_len.is_contiguous()):
            raise ValueError("flash_attention: a per-row kv_len must be a "
                             "contiguous int32 [B] tensor on q's device")
        rows = kv_len
    elif kv_len is not None:
        all_len = int(kv_len)
    offset = skv - sq if q_offset is None else int(q_offset)
    dv = v.shape[3]
    out = q.new_empty((b, sq, hq, dv))
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    values = [k, v] if scales is None else [k, scales[0], v, scales[1]]
    store = [] if scales is None else [quant.STORE_CODES[k.dtype]]
    dims = [d] if store else [d, dv]     # K10 is square
    ring = [depth] if depth > 1 else []
    entry = "flash_attention_fwd" + ("_quantized" if store else "") + (
        "_pipelined" if ring else "")
    lib = _build.load("flash_attention", _ENTRY_POINTS)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, entry)(
            *(t.data_ptr() for t in (q, *values, out, lse)),
            rows.data_ptr() if rows is not None else None, all_len, b, sq,
            skv, hq, hkv, *dims, offset, int(causal), *tile, *ring,
            _DTYPE_CODES[q.dtype], *store, stream)
    _build.check(lib, rc, entry)
    wrapper.launches += 1
    wrapper.path_launches[path(q)] += 1
    if tile:
        wrapper.tile_launches[(*tile, depth)] += 1
    return out, lse


def _meta_out(q, v) -> tuple:
    """(out, lse) of a forward on meta tensors: shapes and dtypes only."""
    b, sq, hq, _ = q.shape
    return (q.new_empty((b, sq, hq, v.shape[-1])),
            q.new_empty((b, hq, sq), dtype=torch.float32))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, kv_len: KvLen = None,
                    q_offset: Optional[int] = None,
                    num_buffers: Optional[int] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None):
    """K1, or K4, at the depth and tile :func:`route` resolves, on a CUDA
    tensor; the plain version on a CPU tensor.  Returns (out [B, Sq, Hq,
    Dv], lse [B, Hq, Sq] f32)."""
    with work.call("flash_attention", work.flash, q, k, v, causal=causal,
                   kv_len=kv_len, q_offset=q_offset):
        if q.device.type == "meta":
            return _meta_out(q, v)
        if q.device.type == "cpu":
            return flash_attention_plain(q, k, v, causal=causal,
                                         kv_len=kv_len, q_offset=q_offset)
        return _launch(flash_attention, q, k, v, causal=causal,
                       kv_len=kv_len, q_offset=q_offset,
                       num_buffers=num_buffers, block_q=block_q,
                       block_k=block_k)


flash_attention.launches = 0   # kernel launches since the last reset
flash_attention.path_launches = Counter()   # the same by path
# the same by (block_q, block_k, depth)
flash_attention.tile_launches = Counter()


def flash_attention_pipelined(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              kv_len: KvLen = None,
                              q_offset: Optional[int] = None,
                              num_buffers: int = 2,
                              block_q: Optional[int] = None,
                              block_k: Optional[int] = None):
    """bf16 K4 with a ``num_buffers``-stage ring at the tile (block_q,
    block_k) (None: 64 x 64) on a CUDA tensor (f32, a depth or tile the
    library is not built for, or a ring that does not fit, raises); the
    plain version, :func:`flash_attention_plain`, on a CPU tensor.
    Returns K1's (out, lse) at the same tile bit for bit."""
    with work.call("flash_attention_pipelined", work.flash, q, k, v,
                   causal=causal, kv_len=kv_len, q_offset=q_offset):
        if q.device.type == "meta":
            return _meta_out(q, v)
        if q.device.type == "cpu":
            return flash_attention_plain(q, k, v, causal=causal,
                                         kv_len=kv_len, q_offset=q_offset)
        if num_buffers < 2:
            raise ValueError(f"flash_attention_pipelined: num_buffers "
                             f"{num_buffers} < 2 (depth 1 is "
                             f"flash_attention)")
        return _launch(flash_attention_pipelined, q, k, v, causal=causal,
                       kv_len=kv_len, q_offset=q_offset,
                       num_buffers=num_buffers, block_q=block_q,
                       block_k=block_k)


flash_attention_pipelined.launches = 0   # launches since the last reset
flash_attention_pipelined.path_launches = Counter()   # the same by path
# the same by (block_q, block_k, depth)
flash_attention_pipelined.tile_launches = Counter()


def flash_attention_quantized(q: torch.Tensor, k_q: torch.Tensor,
                              k_scale: torch.Tensor, v_q: torch.Tensor,
                              v_scale: torch.Tensor, *, causal: bool = True,
                              kv_len: KvLen = None,
                              q_offset: Optional[int] = None):
    """K10 on a CUDA tensor, the plain version on a CPU tensor.  Returns
    (out [B, Sq, Hq, D] in q's dtype, lse [B, Hq, Sq] f32)."""
    with work.call("flash_attention_quantized", work.flash_quantized, q,
                   k_q, k_scale, v_q, v_scale, causal=causal, kv_len=kv_len,
                   q_offset=q_offset):
        if q.device.type == "meta":
            return _meta_out(q, v_q)
        if q.device.type == "cpu":
            return flash_attention_quantized_plain(
                q, k_q, k_scale, v_q, v_scale, causal=causal,
                kv_len=kv_len, q_offset=q_offset)
        return _launch(flash_attention_quantized, q, k_q, v_q,
                       scales=(k_scale, v_scale), causal=causal,
                       kv_len=kv_len, q_offset=q_offset)


flash_attention_quantized.launches = 0   # launches since the last reset
flash_attention_quantized.path_launches = Counter()   # the same by path


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True):
    """K11 on CUDA tensors, the plain version on CPU tensors.  ``out`` and
    ``lse`` are K1's for (q, k, v) with every KV row valid; ``do`` is the
    gradient of ``out`` [B, Sq, Hq, Dv].  (Dk, Dv) is one of
    ``HEAD_DIM_PAIRS``.  Returns (dq, dk, dv) in q's, k's and v's dtype.

    The kernel writes per-q-head dk/dv partials into f32 scratch that
    this wrapper allocates ([B, Skv, Hq, Dk] and [B, Skv, Hq, Dv]) and
    sums each GQA group in f32 before rounding once; ``dd`` = rowsum(do *
    out) goes through a [B, Hq, Sq] f32 scratch from the dq kernel to the
    dk/dv kernel."""
    with work.call("flash_attention_bwd", work.flash_bwd, q, k, v, out, lse,
                   do, causal=causal):
        if q.device.type == "meta":
            return tuple(torch.empty_like(t) for t in (q, k, v))
        if q.device.type == "cpu":
            return flash_attention_bwd_plain(q, k, v, out, lse, do,
                                             causal=causal)
        return _launch_bwd(q, k, v, out, lse, do, causal)


def _launch_bwd(q, k, v, out, lse, do, causal):
    """Check K11's CUDA inputs, launch it, count the launch."""
    if not q.is_cuda:
        raise ValueError(f"flash_attention_bwd: unsupported device "
                         f"{q.device}")
    _check_cuda_inputs(q, k, v)
    b, sq, hq, d = q.shape
    skv, hkv, dv_ = k.shape[1], k.shape[2], v.shape[3]
    for name, t in (("out", out), ("do", do)):
        if (t.device != q.device or t.dtype != q.dtype
                or t.shape != (b, sq, hq, dv_) or not t.is_contiguous()):
            raise ValueError(f"flash_attention_bwd: {name} must be a "
                             f"contiguous tensor of q's device and dtype "
                             f"and shape {(b, sq, hq, dv_)}")
    # the tensor-core passes read out and do 16 bytes a load, as q, k, v
    check_aligned("flash_attention_bwd", out, do, names="out, do")
    if (lse.device != q.device or lse.dtype != torch.float32
            or lse.shape != (b, hq, sq) or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: lse must be a contiguous "
                         f"float32 [B, Hq, Sq] = {(b, hq, sq)} tensor on "
                         f"q's device")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    f32 = dict(dtype=torch.float32, device=q.device)
    dd = torch.empty((b, hq, sq), **f32)
    dk_part = torch.empty((b, skv, hq, d), **f32)
    dv_part = torch.empty((b, skv, hq, dv_), **f32)
    lib = _build.load("flash_attention", _ENTRY_POINTS)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_bwd(
            *(t.data_ptr() for t in (q, k, v, out, do, lse, dq, dk, dv, dd,
                                     dk_part, dv_part)),
            b, sq, skv, hq, hkv, d, dv_, int(causal),
            _DTYPE_CODES[q.dtype], stream)
    _build.check(lib, rc, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.path_launches[path(q)] += 1
    flash_attention_bwd.shape_launches[
        (sq, skv, hq, hkv, d, dv_, bool(causal))] += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0   # launches since the last reset
flash_attention_bwd.path_launches = Counter()   # the same by path
# the same by (Sq, Skv, Hq, Hkv, Dk, Dv, causal)
flash_attention_bwd.shape_launches = Counter()


class FlashAttentionFunction(torch.autograd.Function):
    """K1 (or K4, at the depth the tuning db gives) forward and K11
    backward under autograd: the port's counterpart of the reference's
    ``custom_vjp`` (``flash_attention/ops.py``), whose backward also stays
    on the classic kernel.  The forward attends with every KV row valid
    and the suffix alignment ``Skv - Sq`` and saves q, k, v, out and lse
    (K4's equal K1's bit for bit); the backward recomputes from them.  On
    CPU tensors both run their plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        # autograd may hand in strided views; K1 and K11 take dense rows
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_attention(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention_autograd(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True):
    """Differentiable attention out [B, Sq, Hq, Dv] through
    :class:`FlashAttentionFunction` (K1 or K4 forward, K11 backward)."""
    return FlashAttentionFunction.apply(q, k, v, causal)
