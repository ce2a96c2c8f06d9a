"""K12: the Mamba2 SSD chunked scan, and K13, the same over an int8/fp8
activation stream — the CUDA kernels' wrappers and their plain PyTorch
versions.

Port of ``repro.kernels.mamba_ssd`` (Pallas ``ssd_fwd`` and
``ssd_fwd_quantized``).  Layout: x [B, S, H, P]; dt [B, S, H] f32 (after
softplus); a [H] f32 (negative); b_in, c_in [B, S, G, N], group
``h // (H / G)`` feeding head h.  Both return (y [B, S, H, P], final
state [B, H, P, N] f32).  Per chunk of Q rows, with ``cum = cumsum(dt *
a)`` and ``L[i, j] = exp(cum_i - cum_j)`` for i >= j (0 otherwise):

    y      = ((C B^T) o L) (x dt) + (C o exp(cum)) state^T
    state <- state exp(cum_last) + x^T (B o exp(cum_last - cum) o dt)

Unlike the reference's chunked forms, both versions take an optional
``initial_state`` (None = zeros) and ANY sequence length: the last chunk
is ragged, its rows past S write no y and enter no state, and its decay
is taken at its last valid row (the reference's ``models/ssm.py`` asserts
``S % chunk == 0``, which an exact-length prefill does not meet).  The
result does not depend on the chunk beyond rounding.  The chunk is a
template choice of the bf16 kernel (:func:`chunks`: 32, 64 and 128 at the
served (P, N) pairs, 64 elsewhere and in f32), which the measured search
times (the ``mamba_ssd`` spec); ``chunk=None`` runs ``autotune.SSD_CHUNK``
(64) whatever the tuning db holds (:func:`resolve_chunk`), since another
chunk moves the served bits.  A chunk the library has not built raises.
The plain versions take ``chunk=None`` as 64.

K13 takes x as int8 or fp8 e4m3 values with one f16 scale per (token,
head), ``x_scale`` [B, S, H, 1], and returns y in b_in's dtype; it
dequantizes x at load and rounds it to b_in's dtype, as the reference
oracle ``ssd_quant_ref`` does before its scan.

B's dtype picks the kernel inside the library (:func:`path`): bf16 calls
of K12 and K13 run the four products of a chunk on the tensor cores
(``mma.sync``, 32 head-dim columns a block, or the whole head where it is
narrower; bf16 K13 equals bf16 K12 on ``dequantize(x_q,
x_scale).bfloat16()`` bit for bit), f32 calls on the CUDA cores (the
parity dtype, held to 1e-5).  A call neither path takes raises: nothing
falls back to the other path or to a plain version.  Each wrapper counts its launches, and by path in
``path_launches``.

K16 (:func:`ssd_bwd`) is the scan's backward, which the reference leaves
to autodiff of its jnp scan (no Pallas kernel): from K12's inputs and
the gradients of y and of the final state it returns those of x, dt, a,
B, C and the initial state: bf16 calls on the tensor cores, f32 calls on
the CUDA cores (the parity dtype, held to 1e-5 of the f64 gradient), counted
by path as K12's.  It takes CUDA tensors only and runs chunks of
``SSD_CHUNK`` rows.  :class:`SSDFunction` puts K12 and K16 under autograd,
both at ``SSD_CHUNK``; its plain
version is ``torch.autograd.grad`` of :func:`ssd_plain`
(:func:`ssd_bwd_plain`).

Every wrapper reports its work to the active count once per call
(``kernels/work.py``); on the CPU :func:`ssd_autograd`'s forward and
backward report as K12 and K16 too.  On a meta tensor (the dry run) a
wrapper runs nothing and returns outputs of the right shapes and dtypes.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional

import torch

from repro_torch.core.autotune import SSD_CHUNK
from repro_torch.kernels import _build
from repro_torch.kernels import quant
from repro_torch.kernels import work

HEAD_DIMS = (16, 32, 64)        # P the kernel is built for
STATE_DIMS = (16, 64, 128)      # N the kernel is built for
CHUNKS = (32, 64, 128)          # the bf16 kernel's chunks (see chunks())
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ENTRY_POINTS = {
    "ssd_fwd": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    "ssd_fwd_quantized": ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                          + [ctypes.c_void_p]),
    "ssd_bwd": [ctypes.c_void_p] * 15 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    "ssd_fwd_chunks": [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int),
                                            ctypes.c_int],
}


def chunks(p: int, n: int, dtype=torch.bfloat16) -> tuple:
    """The chunks K12 / K13 are built for at head dim ``p``, state dim
    ``n`` and B's ``dtype`` (``mma_chunk_built`` in csrc/mamba_ssd.cu):
    bf16 32, 64 and 128 where a block takes 32 head-dim columns of a
    served state (P 32 or 64, N 64 or 128: mamba2-780m, zamba2-2.7b), else
    64; f32 64."""
    if dtype == torch.bfloat16 and p in (32, 64) and n in (64, 128):
        return CHUNKS
    return (SSD_CHUNK,)


def library_chunks(p: int, n: int, dtype) -> tuple:
    """The chunks the CUDA library reports it builds (``ssd_fwd_chunks``),
    built on first use: the card tests hold :func:`chunks` to them."""
    lib = _build.load("mamba_ssd", _ENTRY_POINTS)
    out = (ctypes.c_int * 8)()
    n_out = lib.ssd_fwd_chunks(p, n, _DTYPE_CODES[dtype], out, 8)
    return tuple(out[:n_out])


def resolve_chunk(x: torch.Tensor, b_in: torch.Tensor,
                  chunk: Optional[int] = None) -> int:
    """The chunk a K12 (x in B's dtype) or K13 (1-byte x) call runs:
    ``chunk`` where the caller gives one, else ``SSD_CHUNK``, the chunk the
    model runs under ``REPRO_TUNING=off``.  The chunk moves the scan's sums
    (y within its rounding), so no tuning db picks it for a call: the
    search still times the built chunks (the ``mamba_ssd`` spec), and only
    a caller's ``chunk=`` runs another.  A chunk the library has not built
    for this (P, N, B's dtype) raises."""
    if chunk is None:
        return SSD_CHUNK
    p, n = x.shape[3], b_in.shape[3]
    built = chunks(p, n, b_in.dtype)
    if chunk not in built:
        raise ValueError(f"ssd: the kernel runs chunks of "
                         f"{' or '.join(map(str, built))} rows at P={p}, "
                         f"N={n} for {b_in.dtype}, got chunk={chunk}")
    return chunk


def path(x: torch.Tensor, b_in: torch.Tensor) -> str:
    """The kernel a CUDA call of K12 (x in B's dtype), K13 (1-byte x) or
    K16 on these operands runs inside the library: ``"mma"`` (B and C
    bf16: the tensor-core scan or its backward) or ``"cuda_cores"``
    (f32)."""
    return "mma" if b_in.dtype == torch.bfloat16 else "cuda_cores"


def ssd_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
              b_in: torch.Tensor, c_in: torch.Tensor, *,
              chunk: Optional[int] = None,
              initial_state: Optional[torch.Tensor] = None):
    """The plain version: the reference's chunked algorithm
    (``models/ssm.py``) in f32 (f64 for f64 x: the exact reference the
    card checks hold f32 K16 to), with ``initial_state`` and a ragged last
    chunk.  The sequence is padded to whole chunks with zero x, dt, B and
    C: a pad row's ``dt * a`` is 0, so the cumulative decay stays at the
    last valid row's, and its contributions vanish.  The decay matrix is
    masked before ``exp`` (``cum_i - cum_j`` for i < j is positive and may
    overflow)."""
    bsz, s, h, p = x.shape
    g, n = b_in.shape[2], b_in.shape[3]
    rep = h // g
    q = max(1, min(chunk or SSD_CHUNK, s))
    nc = -(-s // q)
    pad = nc * q - s
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32

    def chunked(t: torch.Tensor) -> torch.Tensor:
        t = t.to(ct)
        if pad:
            t = torch.cat([t, t.new_zeros((bsz, pad) + t.shape[2:])], 1)
        return t.reshape((bsz, nc, q) + t.shape[2:])

    xf = chunked(x)                                          # [B,NC,Q,H,P]
    dtf = chunked(dt)                                        # [B,NC,Q,H]
    bh = chunked(b_in).repeat_interleave(rep, dim=3)         # [B,NC,Q,H,N]
    ch = chunked(c_in).repeat_interleave(rep, dim=3)
    da = dtf * a.to(ct)[None, None, None, :]
    cum = torch.cumsum(da, dim=2)                            # [B,NC,Q,H]
    cum_t = cum.permute(0, 1, 3, 2)                          # [B,NC,H,Q]
    lower = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    diff = cum_t[..., :, None] - cum_t[..., None, :]
    l_mat = torch.exp(torch.where(lower, diff, float("-inf")))
    cb = torch.einsum("bcihn,bcjhn->bchij", ch, bh)
    y = torch.einsum("bchij,bcjhp->bcihp", cb * l_mat,
                     xf * dtf[..., None])
    decay_states = torch.exp(cum[:, :, -1:, :] - cum)        # [B,NC,Q,H]
    states = torch.einsum("bcjhn,bcjhp->bchpn",
                          bh * (decay_states * dtf)[..., None], xf)
    chunk_decay = torch.exp(cum[:, :, -1, :])                # [B,NC,H]
    state = (initial_state.to(ct) if initial_state is not None else
             torch.zeros((bsz, h, p, n), dtype=ct, device=x.device))
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    prev = torch.stack(entering, 1)                          # [B,NC,H,P,N]
    y = y + torch.einsum("bcihn,bchpn->bcihp",
                         ch * torch.exp(cum)[..., None], prev)
    y = y.reshape(bsz, nc * q, h, p)[:, :s]
    return y.to(x.dtype), state


def ssd_quantized_plain(x_q: torch.Tensor, x_scale: torch.Tensor,
                        dt: torch.Tensor, a: torch.Tensor,
                        b_in: torch.Tensor, c_in: torch.Tensor, *,
                        chunk: Optional[int] = None):
    """The plain version of K13: dequantize x, round it to b_in's dtype,
    then the plain scan (the reference oracle ``ssd_quant_ref``); y comes
    back in b_in's dtype."""
    x = quant.dequantize(x_q, x_scale).to(b_in.dtype)
    return ssd_plain(x, dt, a, b_in, c_in, chunk=chunk)


def _check_cuda_inputs(what, x, dt, a, b_in, c_in, initial_state,
                       x_scale=None):
    tensors = [x, dt, a, b_in, c_in] + [t for t in (initial_state, x_scale)
                                        if t is not None]
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError(f"{what}: every tensor must be on x's CUDA device")
    if x.dim() != 4 or b_in.dim() != 4:
        raise ValueError(f"{what}: x [B,S,H,P], b_in/c_in [B,S,G,N], got "
                         f"{tuple(x.shape)}, {tuple(b_in.shape)}")
    bsz, s, h, p = x.shape
    g, n = b_in.shape[2], b_in.shape[3]
    if (b_in.shape[:2] != (bsz, s) or c_in.shape != b_in.shape or g < 1
            or h % g):
        raise ValueError(f"{what}: b_in/c_in must be [B,S,G,N] with G "
                         f"dividing H, got {tuple(b_in.shape)}, "
                         f"{tuple(c_in.shape)} for x {tuple(x.shape)}")
    if x_scale is None:
        if x.dtype not in _DTYPE_CODES or not (
                x.dtype == b_in.dtype == c_in.dtype):
            raise ValueError(f"{what}: x, b_in, c_in must share a dtype in "
                             f"{list(_DTYPE_CODES)}, got {x.dtype}, "
                             f"{b_in.dtype}, {c_in.dtype}")
    else:
        if x.dtype not in quant.STORE_CODES:
            raise ValueError(f"{what}: x must be one of "
                             f"{list(quant.STORE_CODES)}, got {x.dtype}")
        if b_in.dtype not in _DTYPE_CODES or b_in.dtype != c_in.dtype:
            raise ValueError(f"{what}: b_in, c_in must share a dtype in "
                             f"{list(_DTYPE_CODES)}, got {b_in.dtype}, "
                             f"{c_in.dtype}")
        if (x_scale.dtype != quant.SCALE_DTYPE
                or tuple(x_scale.shape) != (bsz, s, h, 1)):
            raise ValueError(f"{what}: x_scale must be {quant.SCALE_DTYPE} "
                             f"{(bsz, s, h, 1)}, got {x_scale.dtype} "
                             f"{tuple(x_scale.shape)}")
    if (dt.dtype != torch.float32 or tuple(dt.shape) != (bsz, s, h)
            or a.dtype != torch.float32 or tuple(a.shape) != (h,)):
        raise ValueError(f"{what}: dt must be float32 {(bsz, s, h)} and a "
                         f"float32 {(h,)}, got {dt.dtype} {tuple(dt.shape)}"
                         f", {a.dtype} {tuple(a.shape)}")
    if initial_state is not None and (
            initial_state.dtype != torch.float32
            or tuple(initial_state.shape) != (bsz, h, p, n)):
        raise ValueError(f"{what}: initial_state must be float32 "
                         f"{(bsz, h, p, n)}, got {initial_state.dtype} "
                         f"{tuple(initial_state.shape)}")
    if p not in HEAD_DIMS or n not in STATE_DIMS:
        raise ValueError(f"{what}: head dim P={p} must be in {HEAD_DIMS} "
                         f"and state dim N={n} in {STATE_DIMS}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: every tensor must be contiguous")
    if any(t.data_ptr() % 16 for t in (x, b_in, c_in)):
        raise ValueError(f"{what}: x, b_in and c_in must start 16-byte "
                         f"aligned (the kernel loads 16 bytes a row at once)")


def _launch(wrapper, x, dt, a, b_in, c_in, *, chunk, initial_state=None,
            x_scale=None):
    """Check the CUDA inputs of K12 (``wrapper`` = ssd) or K13 (with
    ``x_scale``), launch the kernel on the current stream at ``chunk``
    (:func:`resolve_chunk`) and count the launch on ``wrapper``, by
    path and by chunk too; returns (y, final_state)."""
    what = wrapper.__name__
    if not x.is_cuda:
        raise ValueError(f"{what}: unsupported device {x.device}")
    _check_cuda_inputs(what, x, dt, a, b_in, c_in, initial_state, x_scale)
    bsz, s, h, p = x.shape
    g, n = b_in.shape[2], b_in.shape[3]
    chunk = resolve_chunk(x, b_in, chunk)
    y = torch.empty(x.shape, dtype=b_in.dtype if x_scale is not None
                    else x.dtype, device=x.device)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    if s == 0 or bsz * h == 0:
        if initial_state is not None:
            state.copy_(initial_state)
        else:
            state.zero_()
        return y, state
    init = initial_state.data_ptr() if initial_state is not None else None
    kind = path(x, b_in)
    lib = _build.load("mamba_ssd", _ENTRY_POINTS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if x_scale is None:
            entry = "ssd_fwd"
            rc = lib.ssd_fwd(
                *(t.data_ptr() for t in (x, dt, a, b_in, c_in, y, state)),
                init, bsz, s, h, p, g, n, chunk, _DTYPE_CODES[x.dtype],
                stream)
        else:
            entry = "ssd_fwd_quantized"
            rc = lib.ssd_fwd_quantized(
                *(t.data_ptr() for t in (x, x_scale, dt, a, b_in, c_in, y,
                                         state)),
                init, bsz, s, h, p, g, n, chunk,
                _DTYPE_CODES[b_in.dtype], quant.STORE_CODES[x.dtype], stream)
    _build.check(lib, rc, entry)
    wrapper.launches += 1
    wrapper.path_launches[kind] += 1
    wrapper.chunk_launches[chunk] += 1
    return y, state


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
        b_in: torch.Tensor, c_in: torch.Tensor, *,
        chunk: Optional[int] = None,
        initial_state: Optional[torch.Tensor] = None):
    """K12 on a CUDA tensor, the plain version on a CPU tensor.  Returns
    (y [B, S, H, P] in x's dtype, final state [B, H, P, N] f32)."""
    with work.call("ssd", work.ssd, x, dt, a, b_in, c_in, chunk=chunk,
                   initial_state=initial_state):
        if x.device.type == "meta":
            return _meta_out(x, b_in, x.dtype)
        if x.device.type == "cpu":
            return ssd_plain(x, dt, a, b_in, c_in, chunk=chunk,
                             initial_state=initial_state)
        return _launch(ssd, x, dt, a, b_in, c_in, chunk=chunk,
                       initial_state=initial_state)


def _meta_out(x, b_in, dtype) -> tuple:
    """(y [B, S, H, P] in ``dtype``, the f32 final state) on meta."""
    bsz, s, h, p = x.shape
    return (x.new_empty((bsz, s, h, p), dtype=dtype),
            x.new_empty((bsz, h, p, b_in.shape[3]), dtype=torch.float32))


ssd.launches = 0   # kernel launches since the last reset
ssd.path_launches = Counter()   # the same by path (:func:`path`)
ssd.chunk_launches = Counter()   # the same by chunk


def ssd_quantized(x_q: torch.Tensor, x_scale: torch.Tensor,
                  dt: torch.Tensor, a: torch.Tensor, b_in: torch.Tensor,
                  c_in: torch.Tensor, *, chunk: Optional[int] = None):
    """K13 on a CUDA tensor, the plain version on a CPU tensor.  Returns
    (y [B, S, H, P] in b_in's dtype, final state [B, H, P, N] f32)."""
    with work.call("ssd_quantized", work.ssd_quantized, x_q, x_scale, dt,
                   a, b_in, c_in, chunk=chunk):
        if x_q.device.type == "meta":
            return _meta_out(x_q, b_in, b_in.dtype)
        if x_q.device.type == "cpu":
            return ssd_quantized_plain(x_q, x_scale, dt, a, b_in, c_in,
                                       chunk=chunk)
        return _launch(ssd_quantized, x_q, dt, a, b_in, c_in, chunk=chunk,
                       x_scale=x_scale)


ssd_quantized.launches = 0   # kernel launches since the last reset
ssd_quantized.path_launches = Counter()   # the same by path
ssd_quantized.chunk_launches = Counter()   # the same by chunk


# ---------------------------------------------------------------- K16

def ssd_bwd_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  b_in: torch.Tensor, c_in: torch.Tensor, dy: torch.Tensor,
                  *, initial_state: Optional[torch.Tensor] = None,
                  d_final: Optional[torch.Tensor] = None,
                  chunk: Optional[int] = None):
    """The plain version of K16: ``torch.autograd.grad`` of
    :func:`ssd_plain` for the cotangents ``dy`` (of y) and ``d_final`` (of
    the final state; None = zeros).  Returns (dx, ddt, da, db, dc,
    d_initial), each in its input's dtype; d_initial is None without an
    ``initial_state``."""
    leaves = [t.detach().requires_grad_() for t in (x, dt, a, b_in, c_in)]
    init = (None if initial_state is None
            else initial_state.detach().requires_grad_())
    with torch.enable_grad():
        y, state = ssd_plain(*leaves, chunk=chunk, initial_state=init)
        outs, cots = [y], [dy]
        if d_final is not None:
            outs.append(state)
            cots.append(d_final)
        wrt = leaves + ([init] if init is not None else [])
        grads = torch.autograd.grad(outs, wrt, cots, allow_unused=True)
    grads = [torch.zeros_like(t) if gr is None else gr
             for t, gr in zip(wrt, grads)]
    return (*grads[:5], grads[5] if init is not None else None)


def ssd_bwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            b_in: torch.Tensor, c_in: torch.Tensor, dy: torch.Tensor, *,
            initial_state: Optional[torch.Tensor] = None,
            d_final: Optional[torch.Tensor] = None,
            chunk: Optional[int] = None):
    """K16 on CUDA tensors (a CPU tensor raises: :func:`ssd_bwd_plain` is
    the plain version): the gradients of K12's (y, final state) for the
    cotangents ``dy`` [B, S, H, P] (x's dtype) and ``d_final`` [B, H, P,
    N] f32 (None = zeros).  Returns (dx, ddt, da, db, dc, d_initial): dx,
    db, dc in x's / B's dtype, ddt, da and d_initial f32; d_initial is
    None without an ``initial_state``.

    The kernel writes f32 partials that this wrapper adds up in a fixed
    order: dB and dC per head ([B, S, H, N], summed over each group's
    heads: the backward of the plain version's ``repeat_interleave``) and
    da per batch row ([B, H]); it also takes a scratch [B, H, ceil(S / 64),
    P, N] (x's dtype) for the state entering each chunk."""
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssd_bwd: unsupported device {x.device} (the "
                         f"plain version is ssd_bwd_plain)")
    with work.call("ssd_bwd", work.ssd_bwd, x, dt, a, b_in, c_in, dy,
                   initial_state=initial_state, d_final=d_final,
                   chunk=chunk):
        if x.is_meta:
            f32 = dict(dtype=torch.float32)
            bsz, s, h, _ = x.shape
            return (torch.empty_like(x), x.new_empty((bsz, s, h), **f32),
                    x.new_empty((h,), **f32), torch.empty_like(b_in),
                    torch.empty_like(c_in),
                    None if initial_state is None
                    else torch.empty_like(initial_state, **f32))
        return _launch_bwd(x, dt, a, b_in, c_in, dy, initial_state, d_final,
                           chunk)


def _launch_bwd(x, dt, a, b_in, c_in, dy, initial_state, d_final, chunk):
    """Check K16's CUDA inputs, launch it, count the launch and add up its
    partials (see :func:`ssd_bwd`)."""
    _check_cuda_inputs("ssd_bwd", x, dt, a, b_in, c_in, initial_state)
    if chunk not in (None, SSD_CHUNK):
        raise ValueError(f"ssd_bwd: the kernel runs chunks of {SSD_CHUNK} "
                         f"rows, got chunk={chunk}")
    bsz, s, h, p = x.shape
    g, n = b_in.shape[2], b_in.shape[3]
    if (dy.device != x.device or dy.dtype != x.dtype or dy.shape != x.shape
            or not dy.is_contiguous() or dy.data_ptr() % 16):
        raise ValueError(f"ssd_bwd: dy must be a contiguous, 16-byte aligned "
                         f"tensor of x's device, dtype and shape "
                         f"{tuple(x.shape)}")
    if d_final is not None and (
            d_final.device != x.device or d_final.dtype != torch.float32
            or tuple(d_final.shape) != (bsz, h, p, n)
            or not d_final.is_contiguous()):
        raise ValueError(f"ssd_bwd: d_final must be a contiguous float32 "
                         f"{(bsz, h, p, n)} tensor on x's device")
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    ddt = torch.empty((bsz, s, h), **f32)
    d_init = (torch.empty((bsz, h, p, n), **f32)
              if initial_state is not None else None)
    if s == 0 or bsz * h == 0:
        da = torch.zeros((h,), **f32)
        zeros = torch.zeros_like(b_in)
        if d_init is not None:
            d_init.copy_(d_final if d_final is not None else 0.0)
        return dx, ddt, da, zeros, zeros.clone(), d_init
    nc = -(-s // SSD_CHUNK)
    da_part = torch.empty((bsz, h), **f32)
    db_part = torch.empty((bsz, s, h, n), **f32)
    dc_part = torch.empty((bsz, s, h, n), **f32)
    states = torch.empty((bsz, h, nc, p, n), dtype=x.dtype, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _build.load("mamba_ssd", _ENTRY_POINTS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ssd_bwd(
            *(ptr(t) for t in (x, dt, a, b_in, c_in, initial_state, dy,
                               d_final, dx, ddt, da_part, db_part, dc_part,
                               d_init, states)),
            bsz, s, h, p, g, n, SSD_CHUNK, _DTYPE_CODES[x.dtype], stream)
    _build.check(lib, rc, "ssd_bwd")
    ssd_bwd.launches += 1
    ssd_bwd.path_launches[path(x, b_in)] += 1
    rep = h // g
    group = lambda t: t.view(bsz, s, g, rep, n).sum(3).to(b_in.dtype)
    return dx, ddt, da_part.sum(0), group(db_part), group(dc_part), d_init


ssd_bwd.launches = 0   # kernel launches since the last reset
ssd_bwd.path_launches = Counter()   # the same by path (:func:`path`)


class SSDFunction(torch.autograd.Function):
    """K12 forward and K16 backward under autograd.  The forward saves
    its inputs (not the per-chunk states: K16 recomputes them); the
    backward takes the gradients of y and of the final state (zeros where
    autograd has none).  On CPU tensors the two run their plain versions,
    reported as K12 and K16 (:func:`ssd_bwd` takes CUDA and meta tensors
    only); on CUDA nothing falls back to a plain version."""

    @staticmethod
    def forward(ctx, x, dt, a, b_in, c_in, initial_state):
        ctx.set_materialize_grads(False)   # an unused state's gradient: None
        # K16 recomputes the chunk states at SSD_CHUNK: the forward runs it
        if x.device.type == "cpu":
            with work.call("ssd", work.ssd, x, dt, a, b_in, c_in,
                           chunk=SSD_CHUNK, initial_state=initial_state):
                y, state = ssd_plain(x, dt, a, b_in, c_in, chunk=SSD_CHUNK,
                                     initial_state=initial_state)
        else:
            y, state = ssd(x, dt, a, b_in, c_in, chunk=SSD_CHUNK,
                           initial_state=initial_state)
        ctx.save_for_backward(x, dt, a, b_in, c_in, initial_state)
        return y, state

    @staticmethod
    def backward(ctx, dy, d_final):
        x, dt, a, b_in, c_in, init = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        args = (x, dt, a, b_in, c_in, dy.contiguous())
        kw = dict(initial_state=init,
                  d_final=None if d_final is None else d_final.contiguous())
        if x.device.type == "cpu":
            with work.call("ssd_bwd", work.ssd_bwd, *args, **kw):
                return ssd_bwd_plain(*args, **kw)
        return ssd_bwd(*args, **kw)


def ssd_autograd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b_in: torch.Tensor, c_in: torch.Tensor, *,
                 chunk: Optional[int] = None,
                 initial_state: Optional[torch.Tensor] = None):
    """The differentiable scan: (y, final state) through
    :class:`SSDFunction`: K12 forward and K16 backward on CUDA tensors,
    their plain versions on CPU tensors (the gradients of autograd of
    :func:`ssd_plain`)."""
    if chunk not in (None, SSD_CHUNK):
        raise ValueError(f"ssd_autograd: the kernels run chunks of "
                         f"{SSD_CHUNK} rows, got chunk={chunk}")
    return SSDFunction.apply(x, dt, a, b_in, c_in, initial_state)
