"""K14: the grouped expert matmul, and K15, the same over int8/fp8 expert
weights — the CUDA kernels' wrappers and their plain PyTorch versions,
and the gated expert FFN composed of them.

Port of ``repro.kernels.moe_gmm`` (Pallas ``gmm`` and ``gmm_quantized``).
Layout: x [E, C, d] (each expert's capacity buffer), w [E, d, f]; both
return out [E, C, f] in x's dtype, ``out[e] = x[e] @ w[e]`` summed in f32
and rounded once (the reference oracle ``gmm_ref``).  K15 takes the
weights as int8 or fp8 e4m3 values ``w_q`` with one f32 scale per
(expert, output column), ``w_scale`` [E, 1, f], from
:func:`quantize_expert_weights`; the scale is constant along d, so both
versions multiply the finished f32 sum by it (the Pallas body's order,
not the oracle ``gmm_quant_ref``'s, which dequantizes first: the two
differ by f32 rounding).

Which kernel a K14 or K15 call runs is one explicit shape rule
(:func:`path`): bf16 x at C <= 32 (every decode
product) streams the weights through the tensor cores when d is a
multiple of 8, f fills whole 16-byte copies of weights (a multiple of 8
bf16 or 16 one-byte weights) and x and w start 16-byte aligned; bf16 K14
at C > 32 (a prefill, a training step) runs the ``wgmma`` kernel (TMA
and wgmma) when TMA can address x and w (d and f multiples of 8, both
16-byte aligned), else, and for K15's 1-byte weights, the ``mma``
tensor-core tile kernel; f32 and the other bf16 shapes the CUDA cores.

The tile is a template choice on the two paths that have one, resolved
per call (:func:`resolve_tiles`, memoized per shape and
``autotune_search.state()``) through the tuning db's ``moe_gmm`` spec, as
the reference resolves its ``(block_c, block_f, block_d)``: ``"wgmma"``
takes the tile height and the ring's stage count (:data:`WGMMA_TILES`),
``"stream"`` the tile width (:data:`STREAM_COLUMNS`); a db miss and
``REPRO_TUNING=off`` run today's rule (``autotune.gmm_tiles``).  K15 at C
> 32 (``"mma"``) and the CUDA cores have one tile each.  No tile moves a
sum: every choice gives the same bits.  A tile the library has not built
raises; nothing falls back.

K17 is K14's backward, a kernel the reference does not have (it
differentiates the einsum): from x, w and the gradient dy [E, C, f] of
out it returns ``dx[e] = dy[e] @ w[e]^T`` [E, C, d] and ``dw[e] = x[e]^T
@ dy[e]`` [E, d, f], each summed in f32 and rounded once, two launches a
call.  Its shape rule (:func:`bwd_path`) is bf16 -> ``"wgmma"`` where
TMA can address every operand, else ``"mma"`` (both read w and x in
place: no transposed copy), f32 -> ``"cuda_cores"``.
:class:`GroupedMatmulFunction` puts K14 and K17 under autograd; on CPU
tensors both run their plain versions.

Every wrapper reports its work to the active count once per call
(``kernels/work.py``).  On a meta tensor (the dry run) a wrapper runs
nothing and returns outputs of the right shapes and dtypes.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch
import torch.nn.functional as F

from repro_torch.core import autotune, autotune_search
from repro_torch.kernels import _build
from repro_torch.kernels import quant
from repro_torch.kernels import work

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the library's GmmPath codes (csrc/moe_gmm.cu)
PATHS = {"cuda_cores": 0, "mma": 1, "stream": 2, "wgmma": 3}
STREAM_MAX_ROWS = 32     # capacity rows the weight-stream kernel takes
# the built instances (csrc/moe_gmm.cu: wgmma_forward, stream_width;
# moe_gmm_tiles lists them): gmm_wgmma_kernel's K14 tile heights with
# their ring stages, and gmm_stream_kernel's tile widths
WGMMA_TILES = ((64, 4), (64, 6), (64, 8), (128, 4), (128, 6), (256, 4))
STREAM_COLUMNS = (64, 128, 256)
_ENTRY_POINTS = {
    "moe_gmm": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
    "moe_gmm_quantized": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                          + [ctypes.c_void_p]),
    "moe_gmm_bwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p],
    "moe_gmm_tiles": [ctypes.POINTER(ctypes.c_int), ctypes.c_int],
}


def grouped_matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version of K14: ``einsum("ecd,edf->ecf")`` in f32,
    rounded once to x's dtype (the reference oracle ``gmm_ref``)."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def grouped_matmul_bwd_plain(x: torch.Tensor, w: torch.Tensor,
                             dy: torch.Tensor):
    """The plain version of K17: (dx, dw) = (dy @ w^T, x^T @ dy) per
    expert, each einsum in f32 rounded once to x's and w's dtype."""
    dyf = dy.float()
    dx = torch.einsum("ecf,edf->ecd", dyf, w.float()).to(x.dtype)
    dw = torch.einsum("ecd,ecf->edf", x.float(), dyf).to(w.dtype)
    return dx, dw


def grouped_matmul_quantized_plain(x: torch.Tensor, w_q: torch.Tensor,
                                   w_scale: torch.Tensor) -> torch.Tensor:
    """The plain version of K15: the f32 product with the quantized values,
    then the per-column scale, rounded once to x's dtype."""
    acc = torch.einsum("ecd,edf->ecf", x.float(), w_q.float())
    return (acc * w_scale.float()).to(x.dtype)


def quantize_expert_weights(w: torch.Tensor, *, dtype=torch.int8):
    """[E, d, f] expert weights -> (w_q, w_scale [E, 1, f] f32): one scale
    per (expert, output column), constant along the contraction axis d.
    The reference's bytes (``quant.quantize(..., axis=1)``)."""
    return quant.quantize(w, dtype=dtype, axis=1)


def _tma_ok(*operands: torch.Tensor) -> bool:
    """Whether TMA can address each bf16 operand: rows (the last
    dimension) of whole 16-byte units from a 16-byte aligned base."""
    return all(t.shape[-1] % 8 == 0 and t.data_ptr() % 16 == 0
               for t in operands)


def path(x: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel a K14 call (bf16 or f32 ``w``) or K15 call (int8 or
    e4m3 ``w``) on these operands runs: ``"stream"`` (bf16 x, C <=
    ``STREAM_MAX_ROWS``, d a multiple of 8, f a multiple of the weights
    in 16 bytes, x and w 16-byte aligned: its ring copies whole 16-byte
    chunks of rows), ``"wgmma"`` (bf16 x and w, C > 32, d and f multiples
    of 8, x and w 16-byte aligned: TMA's boxes), ``"mma"`` (the other bf16
    x at C > 32, K15's 1-byte weights there) or ``"cuda_cores"`` (f32,
    and the bf16 decode shapes the stream kernel cannot take)."""
    if x.dtype != torch.bfloat16:
        return "cuda_cores"
    c, d = x.shape[1:]
    if c > STREAM_MAX_ROWS:
        return ("wgmma" if w.dtype == torch.bfloat16 and _tma_ok(x, w)
                else "mma")
    f = w.shape[2]
    per_copy = 16 // w.element_size()     # weights in one 16-byte copy
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    return "stream" if d % 8 == 0 and f % per_copy == 0 and aligned \
        else "cuda_cores"


def tile_options(kernel: str, c: int) -> list[dict]:
    """The tiles the library builds for a call of C capacity rows on
    ``kernel`` (a :func:`path` name), as tuning configs: the candidates of
    the ``moe_gmm`` spec."""
    if kernel == "wgmma":
        return [autotune.GmmTiles(bc, 128, 64, st).config()
                for bc, st in WGMMA_TILES]
    if kernel == "stream":
        rows = autotune.gmm_tiles(c, path="stream").block_c
        return [autotune.GmmTiles(rows, bf, 64, 4).config()
                for bf in STREAM_COLUMNS]
    return [autotune.gmm_tiles(c, path=kernel).config()]


def library_tiles() -> list[tuple]:
    """The (path, block_c, block_f, block_d, stages) rows the CUDA
    library reports it builds (``moe_gmm_tiles``), built on first use: the
    card tests hold :func:`tile_options` to them."""
    lib = _build.load("moe_gmm", _ENTRY_POINTS)
    out = (ctypes.c_int * (5 * 64))()
    n = lib.moe_gmm_tiles(out, 64)
    names = {code: name for name, code in PATHS.items()}
    return [(names[out[5 * i]], *out[5 * i + 1:5 * i + 5])
            for i in range(n)]


_TILES: dict = {}     # memoized resolutions (see :func:`resolve_tiles`)
_MAX_TILES = 4096


def resolve_tiles(x: torch.Tensor, w: torch.Tensor, kernel: str) -> dict:
    """The tile a K14 / K15 call on x [E, C, d], w [E, d, f] runs on
    ``kernel``: on ``"wgmma"`` and ``"stream"`` the tuning db's pick for
    the ``moe_gmm`` bucket (the analytic rule on a miss or under
    ``REPRO_TUNING=off``), elsewhere the kernel's one tile.  A db entry
    measured for another path (a call TMA cannot address runs ``"mma"``)
    does not apply.  Memoized per shapes, dtypes, device, path and
    :func:`autotune_search.state`."""
    c = x.shape[1]
    if kernel not in ("wgmma", "stream"):
        return autotune.gmm_tiles(c, path=kernel).config()
    key = (x.shape, w.shape, w.dtype, x.device, kernel,
           autotune_search.state())
    got = _TILES.get(key)
    if got is None:
        if len(_TILES) >= _MAX_TILES:
            _TILES.clear()
        cfg = autotune_search.lookup_or_search(
            "moe_gmm", device=x.device, c=c, d=x.shape[2], f=w.shape[2],
            dtype=autotune_search.dtype_name(w.dtype))
        # a key the entry lacks keeps the analytic pick's value
        rule = autotune.gmm_tiles(c, path=kernel).config()
        got = _TILES[key] = {k: cfg.get(k, v) for k, v in rule.items()}
    return dict(got)


def _check_cuda_inputs(what, x, w, w_scale=None) -> None:
    if not (x.is_cuda and w.is_cuda and x.device == w.device):
        raise ValueError(f"{what}: x and w must be on one CUDA device")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{what}: x dtype must be one of "
                         f"{list(_DTYPE_CODES)}, got {x.dtype}")
    if w_scale is None and w.dtype != x.dtype:
        raise ValueError(f"{what}: w must have x's dtype {x.dtype}, got "
                         f"{w.dtype}")
    if w_scale is not None and w.dtype not in quant.STORE_CODES:
        raise ValueError(f"{what}: w_q storage dtype must be one of "
                         f"{list(quant.STORE_CODES)}, got {w.dtype}")
    if (x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0]
            or w.shape[1] != x.shape[2]):
        raise ValueError(f"{what}: x [E, C, d] and w [E, d, f], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{what}: x and w must be contiguous")
    if w_scale is not None:
        want = (w.shape[0], 1, w.shape[2])
        if (w_scale.dtype != torch.float32 or w_scale.device != x.device
                or tuple(w_scale.shape) != want
                or not w_scale.is_contiguous()):
            raise ValueError(f"{what}: w_scale must be a contiguous float32 "
                             f"{want} tensor on x's device")


def _launch(wrapper, x, w, w_scale=None, tiles=None) -> torch.Tensor:
    """Check the CUDA inputs of K14 (``wrapper`` = grouped_matmul) or K15
    (with ``w_scale``), launch the kernel on the current stream at
    ``tiles`` (None: :func:`resolve_tiles`) and count the launch on
    ``wrapper``, by path and by tile too; returns out [E, C, f]."""
    what = wrapper.__name__
    if not x.is_cuda:
        raise ValueError(f"{what}: unsupported device {x.device}")
    _check_cuda_inputs(what, x, w, w_scale)
    e, c, d = x.shape
    f = w.shape[2]
    kernel = path(x, w)
    cfg = resolve_tiles(x, w, kernel) if tiles is None else dict(tiles)
    if cfg not in tile_options(kernel, c):
        raise ValueError(f"{what}: tile {cfg} is not built for the "
                         f"{kernel!r} path at C={c}; built: "
                         f"{tile_options(kernel, c)}")
    out = x.new_empty((e, c, f))
    if out.numel() == 0:
        return out
    if d == 0:
        return out.zero_()
    quantized = w_scale is not None
    entry = "moe_gmm" + ("_quantized" if quantized else "")
    lib = _build.load("moe_gmm", _ENTRY_POINTS)
    scale = [w_scale] if quantized else []
    tail = [quant.STORE_CODES[w.dtype]] if quantized else []
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, entry)(
            *(t.data_ptr() for t in (x, w, *scale, out)), e, c, d, f,
            _DTYPE_CODES[x.dtype], *tail, PATHS[kernel], cfg["block_c"],
            cfg["block_f"], cfg.get("stages", 0), stream)
    _build.check(lib, rc, entry)
    wrapper.launches += 1
    wrapper.path_launches[kernel] += 1
    wrapper.tile_launches[(kernel, cfg["block_c"], cfg["block_f"],
                           cfg.get("stages", 0))] += 1
    return out


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, *,
                   tiles: dict | None = None) -> torch.Tensor:
    """K14 on a CUDA tensor (the kernel :func:`path` names, at ``tiles``,
    one of :func:`tile_options`; None resolves them), the plain version on
    a CPU tensor: x [E, C, d] @ w [E, d, f] -> [E, C, f] in x's dtype."""
    with work.call("grouped_matmul", work.gmm, x, w):
        if x.device.type == "meta":
            return x.new_empty((*x.shape[:2], w.shape[2]))
        if x.device.type == "cpu":
            return grouped_matmul_plain(x, w)
        return _launch(grouped_matmul, x, w, tiles=tiles)


grouped_matmul.launches = 0   # kernel launches since the last reset
grouped_matmul.path_launches = Counter()
# the same by (path, block_c, block_f, stages)
grouped_matmul.tile_launches = Counter()


def grouped_matmul_quantized(x: torch.Tensor, w_q: torch.Tensor,
                             w_scale: torch.Tensor, *,
                             tiles: dict | None = None) -> torch.Tensor:
    """K15 on a CUDA tensor (the kernel :func:`path` names, at ``tiles``
    as for K14), the plain version on a CPU tensor: x [E, C, d] @ (w_q
    [E, d, f] * w_scale [E, 1, f]) -> [E, C, f] in x's dtype, the scale
    applied to the finished f32 sum."""
    with work.call("grouped_matmul_quantized", work.gmm_quantized, x, w_q,
                   w_scale):
        if x.device.type == "meta":
            return x.new_empty((*x.shape[:2], w_q.shape[2]))
        if x.device.type == "cpu":
            return grouped_matmul_quantized_plain(x, w_q, w_scale)
        return _launch(grouped_matmul_quantized, x, w_q, w_scale,
                       tiles=tiles)


grouped_matmul_quantized.launches = 0   # kernel launches since the last reset
grouped_matmul_quantized.path_launches = Counter()
grouped_matmul_quantized.tile_launches = Counter()


def bwd_path(x: torch.Tensor, w: torch.Tensor,
             dy: torch.Tensor | None = None) -> str:
    """The kernels a K17 call on x [E, C, d], w [E, d, f] (and dy [E, C,
    f], where given) runs: ``"wgmma"`` (bf16 with d and f multiples of 8
    and every operand 16-byte aligned: TMA's boxes; dx and dw are fresh
    allocations), ``"mma"`` (the other bf16 shapes) or ``"cuda_cores"``
    (f32)."""
    if x.dtype != torch.bfloat16:
        return "cuda_cores"
    operands = (x, w) if dy is None else (x, w, dy)
    return "wgmma" if _tma_ok(*operands) else "mma"


def grouped_matmul_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor):
    """K17 on CUDA tensors (two launches: dx, then dw), the plain version
    on CPU tensors: x [E, C, d], w [E, d, f] and dy [E, C, f] of one dtype
    -> (dx [E, C, d], dw [E, d, f])."""
    with work.call("grouped_matmul_bwd", work.gmm_bwd, x, w, dy):
        if x.device.type == "meta":
            return torch.empty_like(x), torch.empty_like(w)
        if x.device.type == "cpu":
            return grouped_matmul_bwd_plain(x, w, dy)
        return _launch_bwd(x, w, dy)


def _launch_bwd(x, w, dy) -> tuple:
    """Check K17's CUDA inputs, launch its two kernels, count them."""
    what = "grouped_matmul_bwd"
    if not x.is_cuda:
        raise ValueError(f"{what}: unsupported device {x.device}")
    _check_cuda_inputs(what, x, w)
    e, c, d = x.shape
    f = w.shape[2]
    if (dy.device != x.device or dy.dtype != x.dtype
            or dy.shape != (e, c, f) or not dy.is_contiguous()):
        raise ValueError(f"{what}: dy must be a contiguous {(e, c, f)} "
                         f"tensor of x's device and dtype")
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    if x.numel() == 0 or w.numel() == 0:
        return dx.zero_(), dw.zero_()
    kernel = bwd_path(x, w, dy)
    lib = _build.load("moe_gmm", _ENTRY_POINTS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.moe_gmm_bwd(*(t.data_ptr() for t in (x, w, dy, dx, dw)),
                             e, c, d, f, _DTYPE_CODES[x.dtype],
                             PATHS[kernel], stream)
    _build.check(lib, rc, what)
    grouped_matmul_bwd.launches += 2
    grouped_matmul_bwd.path_launches[kernel] += 2
    return dx, dw


grouped_matmul_bwd.launches = 0   # kernel launches since the last reset
grouped_matmul_bwd.path_launches = Counter()   # the same by path


class GroupedMatmulFunction(torch.autograd.Function):
    """K14 forward and K17 backward under autograd.  The forward saves x
    and w, not the output; the backward returns (dx, dw).  On CPU tensors
    both run their plain versions."""

    @staticmethod
    def forward(ctx, x, w):
        x, w = x.contiguous(), w.contiguous()
        ctx.save_for_backward(x, w)
        return grouped_matmul(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        return grouped_matmul_bwd(x, w, dy.contiguous())


def grouped_matmul_autograd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Differentiable x [E, C, d] @ w [E, d, f] through
    :class:`GroupedMatmulFunction` (K14 forward, K17 backward)."""
    return GroupedMatmulFunction.apply(x, w)


def expert_ffn(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
               down: torch.Tensor) -> torch.Tensor:
    """The gated expert FFN on capacity buffers, ``silu(x @ gate) * (x @
    up) @ down``, as the reference's op composes it: the two products in
    f32, the gated hidden rounded to x's dtype before the down product.
    Three K14 launches on CUDA."""
    h = grouped_matmul(x, gate).float()
    h = F.silu(h) * grouped_matmul(x, up).float()
    return grouped_matmul(h.to(x.dtype), down)
