"""The work of each kernel entry point, and the hook through which every
entry reports a call to the active count.

For each entry (K1-K17 and K2's partials and combine) a function of the
call's arguments returns :class:`Work`: the operations (2 per
multiply-add), the bytes the call must move and the dtype its operations
run in (a key of ``launch/roofline.py``'s ``PEAK_FLOPS``).  Bytes follow
one rule: each input byte is read once and each output byte written once;
a kernel's scratch is its own.  Where the work depends on the data (the
rows' ``kv_len``, the pages a page table names) the count takes what
these inputs need: on the card and on the CPU it reads the lengths once
(a host sync on the card, made only while a count is active); a meta
tensor has no values, so there each row counts at the cache's full
length (the reference's decode convention, ``launch/roofline.py``
``model_flops_for``), unless the count was handed the rows' lengths
(``count_step(meta_kv_len=...)``).

Every wrapper reports its call once, whether it launches its kernel,
runs its plain version (a CPU tensor) or only makes outputs of the right
shapes (a meta tensor): ``with work.call(name, work_fn, *args):`` around
its body.  While a call reports, the count ignores the aten ops run
inside it (the plain version's, the outputs' allocation), so a step
counts the same on the card, on the CPU and on meta.  Without an active
count ``call`` costs one lookup.

The kernel table's bounds (``chip_smoke.py`` phase 6, ``PERF.md`` §6) are
reckoned by the helpers at the end: :func:`prefill_work`,
:func:`decode_work`, :func:`flash_work`, :func:`flash_bwd_work`,
:func:`seq_work`, :func:`combine_work`, :func:`ssd_flops`,
:func:`ssd_bwd_flops`, :func:`gmm_work` and :func:`gmm_bwd_work`.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch

DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float16: "f16",
               torch.float32: "f32", torch.float64: "f64",
               torch.int8: "int8", torch.float8_e4m3fn: "fp8",
               torch.float8_e5m2: "fp8"}
DEFAULT_CHUNK = 64        # the SSD chunk a call given none runs
PAGE_SIZE = 16            # chip_smoke's paged rows (decode_work)


class Work(NamedTuple):
    ops: float        # operations, 2 per multiply-add
    nbytes: float     # inputs read once, outputs written once
    dtype: str        # the dtype the operations run in


def dtype_name(dtype: torch.dtype) -> str:
    try:
        return DTYPE_NAMES[dtype]
    except KeyError:
        raise ValueError(f"no peak rate for dtype {dtype}") from None


# ------------------------------------------------------------ the hook

_ACTIVE: list = [None]    # the count calls report to (process-wide, as
                          # the sharding settings: a CUDA backward runs on
                          # the autograd engine's own threads)
_NULL = contextlib.nullcontext()


class _Call:
    """One reported call: on entry the work goes to the count (computed
    with the count blind, as is everything until exit); a call inside
    another reports nothing."""

    __slots__ = ("count", "name", "fn", "args", "kwargs")

    def __init__(self, count, name, fn, args, kwargs):
        self.count, self.name, self.fn = count, name, fn
        self.args, self.kwargs = args, kwargs

    def __enter__(self):
        self.count.depth += 1
        if self.count.depth == 1:
            self.count.kernel(self.name, self.fn(*self.args, **self.kwargs))
        return self

    def __exit__(self, *exc):
        self.count.depth -= 1
        return False


def call(name: str, fn, *args, **kwargs):
    """The context a wrapper named ``name`` runs its body in: reports
    ``fn(*args, **kwargs)`` (a :class:`Work`) to the active count, if
    any."""
    count = _ACTIVE[0]
    return _NULL if count is None else _Call(count, name, fn, args, kwargs)


@contextlib.contextmanager
def reporting_to(count):
    """Make ``count`` the active count within the block.  It has a
    ``depth`` (how many reported calls are open), ``kernel(name, work)``
    and ``meta_kv_len`` (the rows' lengths a meta ``kv_len`` stands for,
    or None)."""
    if _ACTIVE[0] is not None:
        raise RuntimeError("a count is active already")
    _ACTIVE[0] = count
    try:
        yield count
    finally:
        _ACTIVE[0] = None


def row_lengths(kv_len, b: int, s: int) -> list:
    """Each of the ``b`` rows' live cache rows, clamped to [0, s]:
    ``kv_len`` None (every row), an int, or a scalar or [B] tensor (its
    values read once; a meta tensor's stand for the active count's
    ``meta_kv_len``, else for the full ``s``)."""
    if kv_len is None:
        return [s] * b
    if isinstance(kv_len, torch.Tensor):
        if kv_len.is_meta:
            count = _ACTIVE[0]
            given = None if count is None else count.meta_kv_len
            vals = [s] if given is None else given
        else:
            vals = kv_len.reshape(-1).tolist()
    else:
        vals = [int(kv_len)]
    if len(vals) == 1:
        vals = vals * b
    if len(vals) != b:
        raise ValueError(f"kv_len of {len(vals)} rows for {b} rows")
    return [min(max(int(x), 0), s) for x in vals]


def _elt(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.element_size()


def _nbytes(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.numel() * t.element_size()


# ------------------------------------------------------------ attention

def _clamped_sum(lo: int, hi: int, cap: int) -> int:
    """sum of min(max(j, 0), cap) for j in [lo, hi]."""
    if hi < lo or cap <= 0:
        return 0
    a, z = max(lo, 1), min(hi, cap)
    total = (a + z) * (z - a + 1) // 2 if z >= a else 0
    return total + cap * max(0, hi - max(lo, cap + 1) + 1)


def attention_counts(b, sq, hq, hkv, dk, dv, lens, offset, causal, *,
                     q_elt, kv_elt, scale_elt=0, lse=True) -> tuple:
    """(operations, bytes) of a flash forward: the (query, key) pairs the
    masks let through, each row's ``lens`` live rows of which query i at
    position ``offset + i`` sees those at or before it (``causal``); the
    two products over the pairs; q and out in ``q_elt``, the live K and V
    rows (and their scales) read, the f32 lse written."""
    pairs = read = 0
    for live in lens:
        if causal:
            pairs += _clamped_sum(offset + 1, offset + sq, live)
            read += min(live, max(offset + sq, 0))
        else:
            pairs += sq * live
            read += live
    nbytes = (q_elt * b * sq * hq * (dk + dv) + read * hkv * (
        kv_elt * (dk + dv) + 2 * scale_elt) + (4 * b * hq * sq if lse else 0))
    return 2 * hq * pairs * (dk + dv), nbytes


def flash(q, k, v, *, causal=True, kv_len=None, q_offset=None,
          k_scale=None, v_scale=None, **_) -> Work:
    """K1, K4 and K10 (with the scales): q [B, Sq, Hq, Dk], k [B, Skv,
    Hkv, Dk], v [B, Skv, Hkv, Dv]; a [B] ``kv_len`` is read too."""
    b, sq, hq, dk = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    offset = skv - sq if q_offset is None else int(q_offset)
    ops, nbytes = attention_counts(
        b, sq, hq, hkv, dk, dv, row_lengths(kv_len, b, skv), offset, causal,
        q_elt=q.element_size(), kv_elt=k.element_size(),
        scale_elt=_elt(k_scale))
    if isinstance(kv_len, torch.Tensor) and kv_len.dim() == 1:
        nbytes += 4 * b
    return Work(ops, nbytes, dtype_name(q.dtype))


def flash_quantized(q, k_q, k_scale, v_q, v_scale, **kw) -> Work:
    return flash(q, k_q, v_q, k_scale=k_scale, v_scale=v_scale, **kw)


def flash_bwd(q, k, v, out, lse, do, *, causal=True) -> Work:
    """K11: every KV row valid, the suffix alignment; reads q, k, v, out,
    do and lse, writes dq, dk and dv."""
    b, sq, hq, dk = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    ops, nbytes = flash_bwd_work(b, sq, skv, hq, hkv, dk, dv, causal,
                                 elt=q.element_size())
    return Work(ops, nbytes, dtype_name(q.dtype))


def decode_counts(b, hq, hkv, dk, dv, lens, *, q_elt, kv_elt, scale_elt=0,
                  pages=0) -> tuple:
    """(operations, bytes) of a one-query decode over each row's ``lens``
    live cache rows: the two products; the live K and V rows (and their
    scales) read, q read and out written in ``q_elt``, the [B] kv_len,
    and ``pages`` page-table entries."""
    live = sum(lens)
    nbytes = (live * hkv * (kv_elt * (dk + dv) + 2 * scale_elt)
              + q_elt * b * hq * (dk + dv) + 4 * b + 4 * pages)
    return 2 * hq * (dk + dv) * live, nbytes


def decode(q, k, v, kv_len, *, page_table=None, k_scale=None, v_scale=None,
           **_) -> Work:
    """K2, K5, K7 (with the scales) on a contiguous cache k [B, S, Hkv,
    Dk]; K3, K6, K8 and K9 with a ``page_table`` [B, P] over pools [Np,
    ps, Hkv, Dk], of which each row reads its live pages' entries."""
    b, hq, dk = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    if page_table is not None:
        ps = k.shape[1]
        s = page_table.shape[1] * ps
    else:
        s = k.shape[1]
    lens = row_lengths(kv_len, b, s)
    pages = 0 if page_table is None else sum(-(-n // ps) for n in lens)
    ops, nbytes = decode_counts(b, hq, hkv, dk, dv, lens,
                                q_elt=q.element_size(),
                                kv_elt=k.element_size(),
                                scale_elt=_elt(k_scale), pages=pages)
    return Work(ops, nbytes, dtype_name(q.dtype))


def decode_quantized(q, k_q, k_scale, v_q, v_scale, kv_len, **kw) -> Work:
    return decode(q, k_q, v_q, kv_len, k_scale=k_scale, v_scale=v_scale,
                  **kw)


def paged(q, k_pool, v_pool, page_table, kv_len, **kw) -> Work:
    return decode(q, k_pool, v_pool, kv_len, page_table=page_table, **kw)


def paged_quantized(q, k_pool, k_scale, v_pool, v_scale, page_table, kv_len,
                    **kw) -> Work:
    return decode(q, k_pool, v_pool, kv_len, page_table=page_table,
                  k_scale=k_scale, v_scale=v_scale, **kw)


def partials(q, k, v, kv_len, *, num_splits=None) -> Work:
    """K2's split kernel alone: the live rows' products, q and the live K
    and V rows read, the f32 partials of the plan's splits written."""
    from repro_torch.kernels.decode_attention import ops as da
    b, s = q.shape[0], k.shape[1]
    ns, _ = da.partials_plan(q, k, num_splits)
    ops, nbytes = seq_work(q, k, sum(row_lengths(kv_len, b, s)), ns,
                           v.shape[-1])
    return Work(ops, nbytes, dtype_name(q.dtype))


def combine(o_part, m_part, l_part, dtype) -> Work:
    """K2's combine alone over [B, Hkv, ns, G, Dv] partials."""
    b, hkv, ns, g, dv = o_part.shape
    ops, nbytes = combine_work(b, hkv * g, ns, dv,
                               torch.finfo(dtype).bits // 8)
    return Work(ops, nbytes, "f32")


# ------------------------------------------------------------------ SSD

def ssd(x, dt, a, b_in, c_in, *, chunk=None, initial_state=None,
        x_scale=None) -> Work:
    """K12 (K13 with ``x_scale``): x [B, S, H, P] (and its scale) and dt
    [B, S, H], a [H], B and C [B, S, G, N] and the initial state read; y
    in B's dtype and the f32 final state written."""
    bsz, s, h, p = x.shape
    g, n = b_in.shape[2], b_in.shape[3]
    ops = ssd_flops(bsz, s, h, p, g, n, chunk or DEFAULT_CHUNK)
    nbytes = (_nbytes(x) + _nbytes(x_scale) + b_in.element_size() * bsz * s
              * h * p + _nbytes(dt) + _nbytes(a) + _nbytes(b_in)
              + _nbytes(c_in) + 4 * bsz * h * p * n + _nbytes(initial_state))
    return Work(ops, nbytes, dtype_name(b_in.dtype))


def ssd_quantized(x_q, x_scale, dt, a, b_in, c_in, *, chunk=None) -> Work:
    return ssd(x_q, dt, a, b_in, c_in, chunk=chunk, x_scale=x_scale)


def ssd_bwd(x, dt, a, b_in, c_in, dy, *, initial_state=None, d_final=None,
            chunk=None) -> Work:
    """K16: x, dt, a, B, C, dy, the initial state and d_final read; dx,
    ddt, da, dB, dC and d_initial written."""
    bsz, s, h, p = x.shape
    g, n = b_in.shape[2], b_in.shape[3]
    ops = ssd_bwd_flops(bsz, s, h, p, g, n, chunk or DEFAULT_CHUNK)
    nbytes = (2 * (_nbytes(x) + _nbytes(dt) + _nbytes(a) + _nbytes(b_in)
                   + _nbytes(c_in) + _nbytes(initial_state))
              + _nbytes(dy) + _nbytes(d_final))
    return Work(ops, nbytes, dtype_name(x.dtype))


# --------------------------------------------------------- expert matmul

def gmm(x, w, *, tiles=None, w_scale=None) -> Work:
    """K14 (K15 with ``w_scale``): x [E, C, d] and w [E, d, f] (and its
    scale) read, out [E, C, f] in x's dtype written."""
    e, c, d = x.shape
    f = w.shape[2]
    ops, nbytes = gmm_work(e, c, d, f, x.element_size(), w.element_size())
    return Work(ops, nbytes + _nbytes(w_scale), dtype_name(x.dtype))


def gmm_quantized(x, w_q, w_scale, *, tiles=None) -> Work:
    return gmm(x, w_q, w_scale=w_scale)


def gmm_bwd(x, w, dy) -> Work:
    """K17: x, w and dy read; dx and dw written."""
    e, c, d = x.shape
    ops, nbytes = gmm_bwd_work(e, c, d, w.shape[2], x.element_size())
    return Work(ops, nbytes, dtype_name(x.dtype))


# ------------------------------------- the kernel table's bound helpers

def prefill_work(sq: int, hq: int, hkv: int, d: int, quantized: bool,
                 b: int = 1) -> tuple:
    """(operations, bytes) of a causal prefill of ``sq`` tokens into an
    empty cache (kv_len = sq): the causal pairs' two products; q and out
    in bf16, the live K and V rows (1-byte ones with a 2-byte scale), the
    f32 lse."""
    return attention_counts(b, sq, hq, hkv, d, d, [sq] * b, 0, True,
                            q_elt=2, kv_elt=1 if quantized else 2,
                            scale_elt=2 if quantized else 0)


def decode_work(kv_len, hq: int, hkv: int, d: int, quantized: bool,
                paged: bool, page_size: int = PAGE_SIZE) -> tuple:
    """(operations, bytes) of a decode tick over rows of ``kv_len`` (a
    [B] tensor): the live rows' two products; the live K and V rows
    (1-byte ones with a 2-byte scale), q and out in bf16, kv_len, and the
    page-table entries read."""
    lens = [int(x) for x in kv_len.reshape(-1).tolist()]
    pages = sum(-(-n // page_size) for n in lens) if paged else 0
    return decode_counts(len(lens), hq, hkv, d, d, lens, q_elt=2,
                         kv_elt=1 if quantized else 2,
                         scale_elt=2 if quantized else 0, pages=pages)


def flash_work(b, sq, skv, hq, hkv, dk, dv) -> tuple:
    """(operations, bytes) of causal K1 at the suffix alignment: the
    pairs' two products; q, k, v and out in bf16, lse in f32."""
    return attention_counts(b, sq, hq, hkv, dk, dv, [skv] * b, skv - sq,
                            True, q_elt=2, kv_elt=2)


def flash_bwd_work(b, sq, skv, hq, hkv, dk, dv, causal=True,
                   elt=2) -> tuple:
    """(operations, bytes) of K11 at the suffix alignment: s, dk and dq
    contract or produce Dk columns, dp and dv Dv; q, dq, k, dk (Dk wide),
    out, do, v, dv (Dv wide) and the f32 lse moved once."""
    pairs = b * (_clamped_sum(skv - sq + 1, skv, skv) if causal
                 else sq * skv)
    return (2 * hq * pairs * (3 * dk + 2 * dv),
            2 * elt * (b * sq * hq + b * skv * hkv) * (dk + dv)
            + 4 * b * hq * sq)


def seq_work(q, k_rows, live: int, parts: int, dv: int) -> tuple:
    """(operations, bytes) of K2's split kernel over ``live`` cache rows
    (the rows below each batch row's length, summed): the two products;
    q read, the live K and V rows read, ``parts`` splits' f32 partials
    (o, m, l) written."""
    b, hq, dk = q.shape
    hkv = k_rows.shape[2]
    elt = q.element_size()
    nbytes = (b * hq * dk * elt + live * hkv * (dk + dv) * elt
              + 4 * b * hq * parts * (dv + 2))
    return 2 * hq * (dk + dv) * live, nbytes


def combine_work(b, hq, parts, dv, elt) -> tuple:
    """(operations, bytes) of K2's combine over ``parts`` splits: read the
    f32 partials once, write out; a max, two exps and a multiply-add per
    (split, column)."""
    return b * hq * parts * (2 * dv + 4), (4 * b * hq * parts * (dv + 2)
                                           + b * hq * dv * elt)


def ssd_flops(b, s, h, p, g, n, chunk=DEFAULT_CHUNK) -> int:
    """Operations (2 per multiply-add) of the chunked scan on these shapes,
    counting what the data needs: per chunk of q valid rows, C B^T once
    per group over the q (q + 1) / 2 causal pairs, and per head the masked
    product with x over those pairs, C state^T and the state update over
    q x P x N."""
    total = 0
    for c0 in range(0, s, chunk):
        q = min(chunk, s - c0)
        pairs = q * (q + 1) // 2
        total += g * 2 * pairs * n + h * (2 * pairs * p + 2 * 2 * q * p * n)
    return b * total


def ssd_bwd_flops(b, s, h, p, g, n, chunk=DEFAULT_CHUNK) -> int:
    """Operations (2 per multiply-add) of the scan's backward on these
    shapes, counting what the data needs: per chunk of q valid rows, the
    state entering it (q x P x N a head, for every chunk but the last), C
    B^T once per group over the q (q + 1) / 2 causal pairs, and per head
    dy u^T, M^T dy, (G o L) B and (G o L)^T C over those pairs, and B dh^T,
    dy h_in, x dh and dh_in over q x P x N."""
    total = 0
    for c0 in range(0, s, chunk):
        q = min(chunk, s - c0)
        pairs = q * (q + 1) // 2
        recompute = q * p * n if c0 + chunk < s else 0
        total += g * 2 * pairs * n + h * (
            2 * recompute + 2 * pairs * (2 * p + 2 * n) + 4 * 2 * q * p * n)
    return b * total


def gmm_work(e, c, d, f, elt=2, w_elt=2) -> tuple:
    """(operations, bytes) of x [E, C, d] @ w [E, d, f]: x and w read,
    out (x's element size) written."""
    return 2 * e * c * d * f, elt * (e * c * d + e * c * f) + w_elt * e * d * f


def gmm_bwd_work(e, c, d, f, elt=2) -> tuple:
    """(operations, bytes) of K17: x, w and dy read, dx and dw written."""
    return (2 * 2 * e * c * d * f,
            elt * (2 * e * c * d + 2 * e * d * f + e * c * f))
