"""KernelSpecs: how each kernel with a template knob plugs into the
search.

Port of ``repro.core.autotune_search.kernels``: ``flash_attention`` (K1
/ K4's tile and ring depth; K10 at its one tile and depth 1),
``decode_attention`` (K2 / K5, and K7 at depth 1),
``paged_decode_attention`` (K3 / K6, K8 / K9), ``moe_gmm`` (K14 / K15's
tile, in the reference's ``block_c`` / ``block_f`` / ``block_d`` and the
port's ``stages``) and ``mamba_ssd`` (K12 / K13's chunk).  Every
candidate is an instance the CUDA library builds.  A spec answers four
questions:

* **bucket** — which shapes share one tuning-db entry.  Sequence-like
  extents round up to the next power of two; head dims (``d`` and ``dv``,
  for MLA's pairs) and the storage dtype stay exact.  The decode buckets
  also carry ``rows``, B * Hkv rounded up to a power of two: a split
  exists to cover the SMs, so the best split count moves with how many
  (row, KV head) pairs share the card (the reference's bucket has none: a
  TPU split is per core).  ``moe_gmm`` and ``mamba_ssd`` keep the
  reference's buckets (c, d and f as powers of two; s as one with floor
  16, p and n exact).
* **candidates** — the model-pruned search space: the ranked lists of
  :mod:`repro_torch.core.autotune`, fitted against each kernel's real
  shared-memory layout, with the classic pick guaranteed a slot no later
  than second.
* **runner** — a thunk executing the kernel once on synthetic inputs at
  the bucket shape.  On the card it cycles through input sets together
  larger than the 50 MB L2 (``on_cuda``, ``calls``: see ``search``); on
  the CPU it runs the op's plain version, which exercises the machinery
  (as the reference's interpret mode does) and whose winner means nothing.
* **analytic** — the classic closed-form pick (cache miss,
  ``REPRO_TUNING=off``): depth 1 and the 64 x 64 tile, the split count of
  :func:`repro_torch.core.autotune.decode_split_k`, page size
  ``min(16, s)`` in the open bucket, K14 / K15's tile rule
  (:func:`repro_torch.core.autotune.gmm_tiles`), the 64-row SSD chunk —
  exactly what the kernels ran before the search existed.

The runner factories and the shared-memory layouts import the kernel
modules lazily: every ``ops.py`` imports this package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core import autotune

__all__ = ["BUFFER_DEPTHS", "KernelSpec", "PAGE_SIZE_OPTIONS",
           "QUICK_SHAPES", "REPRESENTATIVE_SHAPES", "SPECS",
           "backend_name", "dma_compute_breakdown", "dtype_name",
           "fmt_items"]

BUFFER_DEPTHS = (1, 2, 4)   # KV staging-ring depths the search sweeps
PAGE_SIZE_OPTIONS = (8, 16, 32, 64, 128)  # swept by the page_size=0 bucket
L2_BYTES = 50 * 2 ** 20     # the H100's L2: a runner's input sets exceed it
MAX_SETS = 64


def backend_name(device=None) -> str:
    """The card's name (``torch.cuda.get_device_name``) for a CUDA device,
    else ``"cpu"``: a db measured on another card misses."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name(dev)


def dtype_name(dtype) -> str:
    """A torch dtype as the buckets spell it ("bfloat16", "int8", ...)."""
    return str(dtype).removeprefix("torch.")


def _pow2_bucket(x: int, floor: int = 8) -> int:
    b = floor
    while b < x:
        b *= 2
    return b


def fmt_items(d: dict) -> str:
    """Canonical one-cell serialization of a shape bucket or config:
    ";"-separated sorted k=v pairs (a "," would split a CSV cell).  Used
    for db bucket keys and the tune table's config columns — one
    implementation so the two can never silently diverge."""
    return ";".join(f"{k}={v}" for k, v in sorted(d.items()))


def _dedupe(configs: list[dict]) -> list[dict]:
    seen, out = set(), []
    for cfg in configs:
        sig = tuple(sorted(cfg.items()))
        if sig not in seen:
            seen.add(sig)
            out.append(cfg)
    return out


def _with_classic(cands: list[dict], classic: dict) -> list[dict]:
    """Prior's pick stays first, but the classic closed-form fallback is
    guaranteed a slot no later than second — so every search measures the
    config a cache miss would actually run, and the recorded winner can
    never be slower than the fallback."""
    if not cands:
        return [classic]
    if cands[0] == classic:
        return cands
    return [cands[0], classic] + [c for c in cands[1:] if c != classic]


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    name: str
    bucket: Callable[..., dict]             # shape kwargs -> bucket shape
    candidates: Callable[[dict], list[dict]]  # ranked, analytic pick first
    # (bucket shape, device) -> config -> runner
    runner_factory: Callable[[dict, torch.device],
                             Callable[[dict], Callable[[], None]]]
    analytic: Callable[[dict], dict]        # classic closed-form fallback

    def bucket_key(self, shape: dict) -> str:
        if "dtype" not in shape:
            # every bucket carries the storage dtype: an int8 pool and a
            # bf16 pool at the same extents are different kernels, and a
            # key without the dtype would alias their winners
            raise ValueError(
                f"tuning bucket for {self.name!r} is missing 'dtype': "
                f"{shape!r}")
        return fmt_items(shape)

    def analytic_config(self, **shape) -> dict:
        """The closed-form pick for the *actual* shape — the fallback used
        on cache miss and under ``REPRO_TUNING=off``: what the kernels ran
        before the search existed."""
        return self.analytic(dict(shape))


def _dtype_bytes(shape: dict) -> int:
    from repro_torch.configs.base import torch_dtype

    return torch_dtype(shape.get("dtype", "float32")).itemsize


def _quantized(shape: dict) -> bool:
    """Whether this bucket's storage dtype routes to the quantized kernel
    variants (int8 / fp8 values + per-vector scale sidecars)."""
    from repro_torch.kernels import quant

    return quant.is_quant_dtype(shape.get("dtype"))


class _Runner:
    """One kernel call per invocation, cycling through ``sets`` of inputs;
    ``on_cuda`` and ``calls`` tell ``search.time_runner`` how to time it."""

    def __init__(self, fn, sets, on_cuda: bool):
        self.fn, self.sets, self.on_cuda = fn, sets, on_cuda
        self.calls = len(sets)
        self._i = 0

    def __call__(self) -> None:
        self.fn(*self.sets[self._i % len(self.sets)])
        self._i += 1


def _input_sets(make, device: torch.device, bytes_per_set: int) -> list:
    """Enough input sets from ``make(gen)`` to exceed the L2 on the card
    (each call then finds its inputs cold, as a layer of the model does);
    one on the CPU."""
    gen = torch.Generator(device=device).manual_seed(0)
    n = 1
    if device.type == "cuda":
        n = min(MAX_SETS, max(2, -(-2 * L2_BYTES // max(1, bytes_per_set))))
    return [make(gen) for _ in range(n)]


def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


# ---------------------------------------------------------------------------
# flash_attention: (block_q, block_k, num_buffers) (K1 at depth 1, K4
# above; K10 its one tile at depth 1 only; f32 its one tile at depth 1)
# ---------------------------------------------------------------------------

def _flash_bucket(*, sq: int, skv: int, d: int, dv: Optional[int] = None,
                  dtype: str = "float32", causal: bool = True) -> dict:
    return {"sq": _pow2_bucket(sq), "skv": _pow2_bucket(skv), "d": int(d),
            "dv": int(d if dv is None else dv), "dtype": str(dtype),
            "causal": int(bool(causal))}


def _flash_candidates(shape: dict) -> list[dict]:
    classic = _flash_analytic(shape)
    if _quantized(shape) or _dtype_bytes(shape) != 2:
        # K10 has no staging ring (its scale sidecars would need streams
        # of their own, as in the reference) and one tile; the f32 forward
        # (the CUDA cores) neither ring nor a tile choice
        return [classic]
    from repro_torch.kernels.flash_attention import ops as fa

    d, dv = shape["d"], shape["dv"]
    blocks = autotune.attention_block_candidates(
        shape["sq"], shape["skv"], d, dv=dv, tiles=fa.tile_options(d, dv),
        ring_smem=lambda bq, bk: fa.pipelined_smem(2, d, dv, block_q=bq,
                                                   block_k=bk),
        buffer_depths=BUFFER_DEPTHS)
    return _with_classic(
        _dedupe([{"block_q": b.block_q, "block_k": b.block_k,
                  "num_buffers": b.num_buffers} for b in blocks]), classic)


def _flash_analytic(shape: dict) -> dict:
    # depth 1 and the tile the dtype's kernel always ran: 64 x 64 on the
    # tensor cores (bf16 K1; K10's bf16 queries), 16 x 32 on the CUDA cores
    if _dtype_bytes(shape) == 4:
        return {"block_q": autotune.BLOCK_Q, "block_k": autotune.BLOCK_K,
                "num_buffers": 1}
    return {"block_q": autotune.MMA_BLOCK_Q, "block_k": autotune.MMA_BLOCK_K,
            "num_buffers": 1}


# The runners' head layout: the flash bucket has no heads, and the one
# timed is the dense decoder's (16 query heads over 2 KV heads, one
# request); the decode buckets' rows are B * Hkv with Hkv = 1 and the
# dense decoder's 8 query heads per KV head.
_FLASH_HEADS = (16, 2)
_DECODE_GROUP = 8


def _flash_runner_factory(shape: dict, device: torch.device):
    from repro_torch.configs.base import torch_dtype
    from repro_torch.kernels import quant
    from repro_torch.kernels.flash_attention import ops as fa

    sq, skv, d, dv = shape["sq"], shape["skv"], shape["d"], shape["dv"]
    hq, hkv = _FLASH_HEADS
    store = torch_dtype(shape["dtype"])
    quantized = _quantized(shape)
    qdt = torch.bfloat16 if quantized else store
    # a prefill of sq tokens into an skv-row cache, as the model calls it
    causal = bool(shape["causal"])
    kv_len, q_offset = (min(sq, skv), 0) if causal else (None, None)

    def make(gen):
        q = _randn(gen, (1, sq, hq, d), qdt, device)
        k = _randn(gen, (1, skv, hkv, d), qdt, device)
        v = _randn(gen, (1, skv, hkv, dv), qdt, device)
        if quantized:
            kq, ks = quant.quantize(k, dtype=store,
                                    scale_dtype=quant.SCALE_DTYPE)
            vq, vs = quant.quantize(v, dtype=store,
                                    scale_dtype=quant.SCALE_DTYPE)
            return q, kq, ks, vq, vs
        return q, k, v

    sets = _input_sets(make, device, qdt.itemsize * sq * hq * d
                       + store.itemsize * skv * hkv * (d + dv))
    on_cuda = device.type == "cuda"

    def runner(config: dict) -> Callable[[], None]:
        nb = int(config.get("num_buffers", 1))
        tile = dict(block_q=config["block_q"], block_k=config["block_k"])
        if quantized:
            return _Runner(lambda *a: fa.flash_attention_quantized(
                *a, causal=causal, kv_len=kv_len, q_offset=q_offset),
                sets, on_cuda)
        if nb > 1:
            return _Runner(lambda *a: fa.flash_attention_pipelined(
                *a, causal=causal, kv_len=kv_len, q_offset=q_offset,
                num_buffers=nb, **tile), sets, on_cuda)
        return _Runner(lambda *a: fa.flash_attention(
            *a, causal=causal, kv_len=kv_len, q_offset=q_offset,
            num_buffers=1, **tile), sets, on_cuda)

    return runner


# ---------------------------------------------------------------------------
# decode_attention: (num_splits, num_buffers) (K2 / K5; K7 depth 1 only)
# ---------------------------------------------------------------------------

def _decode_bucket(*, s: int, d: int, dv: Optional[int] = None,
                   dtype: str = "float32", rows: int = 1) -> dict:
    return {"s": _pow2_bucket(s), "d": int(d),
            "dv": int(d if dv is None else dv), "dtype": str(dtype),
            "rows": _pow2_bucket(rows, floor=1)}


def _decode_candidates(shape: dict) -> list[dict]:
    from repro_torch.kernels.decode_attention import ops as da

    base, stage = da.pipelined_smem(_dtype_bytes(shape), shape["d"],
                                    shape["dv"])
    # the quantized contiguous decode (K7) has no staging ring, as in the
    # reference: its search sweeps the split count alone
    depths = (1,) if _quantized(shape) else BUFFER_DEPTHS
    pairs = autotune.decode_split_buffer_candidates(
        shape["s"], rows=shape["rows"], head_dim=shape["d"], dv=shape["dv"],
        dtype_bytes=_dtype_bytes(shape), base_bytes=base, stage_bytes=stage,
        buffer_depths=depths)
    return _with_classic(
        _dedupe([{"num_splits": ns, "num_buffers": nb} for ns, nb in pairs]),
        _decode_analytic(shape))


def _decode_analytic(shape: dict) -> dict:
    return {"num_splits": autotune.decode_split_k(
        shape["s"], rows=shape.get("rows", 1)), "num_buffers": 1}


def _decode_runner_factory(shape: dict, device: torch.device):
    from repro_torch.configs.base import torch_dtype
    from repro_torch.kernels import quant
    from repro_torch.kernels.decode_attention import ops as da

    s, d, dv, b = shape["s"], shape["d"], shape["dv"], shape["rows"]
    store = torch_dtype(shape["dtype"])
    quantized = _quantized(shape)
    qdt = torch.bfloat16 if quantized else store
    kv_len = torch.full((b,), s, dtype=torch.int32, device=device)

    def make(gen):
        q = _randn(gen, (b, _DECODE_GROUP, d), qdt, device)
        k = _randn(gen, (b, s, 1, d), qdt, device)
        v = _randn(gen, (b, s, 1, dv), qdt, device)
        if quantized:
            kq, ks = quant.quantize(k, dtype=store,
                                    scale_dtype=quant.SCALE_DTYPE)
            vq, vs = quant.quantize(v, dtype=store,
                                    scale_dtype=quant.SCALE_DTYPE)
            return q, kq, ks, vq, vs, kv_len
        return q, k, v, kv_len

    sets = _input_sets(make, device, store.itemsize * b * s * (d + dv))
    on_cuda = device.type == "cuda"

    def runner(config: dict) -> Callable[[], None]:
        ns, nb = int(config["num_splits"]), int(config.get("num_buffers", 1))
        if quantized:
            return _Runner(lambda *a: da.decode_attention_quantized(
                *a, num_splits=ns), sets, on_cuda)
        if nb > 1:
            return _Runner(lambda *a: da.decode_attention_pipelined(
                *a, num_splits=ns, num_buffers=nb), sets, on_cuda)
        return _Runner(lambda *a: da.decode_attention(
            *a, num_splits=ns, num_buffers=1), sets, on_cuda)

    return runner


# ---------------------------------------------------------------------------
# paged_decode_attention: num_buffers (K3 / K6, K8 / K9), and page_size in
# the open bucket
# ---------------------------------------------------------------------------

def _paged_decode_bucket(*, s: int, page_size: int, d: int,
                         dv: Optional[int] = None, dtype: str = "float32",
                         rows: int = 1) -> dict:
    # page_size is IN the bucket: two pools with equal total rows but
    # different page sizes are different kernels (their tiles span other
    # pages), so a bucket without it would alias their winners.
    # page_size=0 is the *open* sentinel bucket: the caller has not fixed
    # a pool layout yet, so the search sweeps page_size itself and the
    # winning config carries the picked value (ServeConfig(page_size=None)
    # resolves through this bucket).
    return {"s": _pow2_bucket(s), "page_size": int(page_size), "d": int(d),
            "dv": int(d if dv is None else dv), "dtype": str(dtype),
            "rows": _pow2_bucket(rows, floor=1)}


def _paged_decode_candidates(shape: dict) -> list[dict]:
    from repro_torch.kernels.decode_attention import ops as da

    sweep_ps = not shape["page_size"]
    ps_options = ([p for p in PAGE_SIZE_OPTIONS if p <= shape["s"]]
                  if sweep_ps else [shape["page_size"]])
    base, stage = da.pipelined_smem(_dtype_bytes(shape), shape["d"],
                                    shape["dv"])
    out = []
    for ps in ps_options:
        for nb in BUFFER_DEPTHS:
            if autotune.fit_buffer_depth(nb, stage, base_bytes=base) != nb:
                continue
            cfg = {"num_buffers": nb}
            if sweep_ps:
                cfg["page_size"] = ps
            out.append(cfg)
    return _with_classic(_dedupe(out), _paged_decode_analytic(shape))


def _paged_decode_analytic(shape: dict) -> dict:
    # the classic paged kernel at depth 1; the open bucket's fallback also
    # pins the page size the serve engine has always defaulted to
    if not shape["page_size"]:
        return {"page_size": min(16, shape["s"]), "num_buffers": 1}
    return {"num_buffers": 1}


def _paged_decode_runner_factory(shape: dict, device: torch.device):
    from repro_torch.configs.base import torch_dtype
    from repro_torch.kernels import quant
    from repro_torch.kernels.decode_attention import ops as da

    s, d, dv, b = shape["s"], shape["d"], shape["dv"], shape["rows"]
    store = torch_dtype(shape["dtype"])
    quantized = _quantized(shape)
    qdt = torch.bfloat16 if quantized else store
    kv_len = torch.full((b,), s, dtype=torch.int32, device=device)
    on_cuda = device.type == "cuda"

    def build(ps: int) -> list:
        pages = max(1, s // ps)
        n_pool = b * pages + 1    # pool page 0: the serve's scratch page

        def make(gen):
            perm = torch.randperm(n_pool - 1, generator=torch.Generator()
                                  .manual_seed(ps)) + 1
            pt = perm.reshape(b, pages).to(torch.int32).to(device)
            q = _randn(gen, (b, _DECODE_GROUP, d), qdt, device)
            kp = _randn(gen, (n_pool, ps, 1, d), qdt, device)
            vp = _randn(gen, (n_pool, ps, 1, dv), qdt, device)
            if quantized:
                kq, ks = quant.quantize(kp, dtype=store,
                                        scale_dtype=quant.SCALE_DTYPE)
                vq, vs = quant.quantize(vp, dtype=store,
                                        scale_dtype=quant.SCALE_DTYPE)
                return q, kq, ks, vq, vs, pt, kv_len
            return q, kp, vp, pt, kv_len

        return _input_sets(make, device,
                           store.itemsize * n_pool * ps * (d + dv))

    # the open (page_size=0) bucket rebuilds the pools per page size — the
    # page size under test IS part of the input layout
    pools: dict[int, list] = {}

    def runner(config: dict) -> Callable[[], None]:
        ps = int(config.get("page_size") or shape["page_size"])
        if ps not in pools:
            pools[ps] = build(ps)
        nb = int(config.get("num_buffers", 1))
        if quantized:
            fn = (da.paged_decode_attention_quantized_pipelined if nb > 1
                  else da.paged_decode_attention_quantized)
        else:
            fn = (da.paged_decode_attention_pipelined if nb > 1
                  else da.paged_decode_attention)
        return _Runner(lambda *a: fn(*a, num_buffers=nb), pools[ps], on_cuda)

    return runner


# ---------------------------------------------------------------------------
# moe_gmm: (block_c, block_f, block_d, stages) of the path the bucket runs
# ---------------------------------------------------------------------------

def _gmm_bucket(*, c: int, d: int, f: int, dtype: str = "float32") -> dict:
    return {"c": _pow2_bucket(c), "d": _pow2_bucket(d),
            "f": _pow2_bucket(f), "dtype": str(dtype)}


def _gmm_path(shape: dict) -> str:
    """The kernel (``kernels.moe_gmm.ops.path``) a call in this bucket
    runs: its d and f are powers of two >= 8, so the stream and TMA's
    boxes take them; the dtype is the weights' (int8 / fp8 e4m3: K15 with
    bf16 x).  K15 at C > 32 (``"mma"``) and f32 (the CUDA cores) keep one
    tile each: their only candidate is it."""
    if shape["dtype"] == "float32":
        return "cuda_cores"
    if shape["c"] <= 32:
        return "stream"
    return "mma" if _quantized(shape) else "wgmma"


# The runners' expert count: the bucket has none, and the one timed is
# the MoE decoder's (deepseek-v2-lite-16b: 64 experts).
_GMM_EXPERTS = 64


def _gmm_candidates(shape: dict) -> list[dict]:
    from repro_torch.kernels.moe_gmm import ops as mg

    kernel = _gmm_path(shape)
    c = shape["c"]
    # a tile taller than the bucket's capacity rows computes only padding
    options = [autotune.GmmTiles(**cfg) for cfg in mg.tile_options(kernel, c)
               if cfg["block_c"] <= max(64, c)]
    tiles = autotune.gmm_tile_candidates(
        c, shape["d"], shape["f"], dtype_bytes=2,
        weight_bytes=_dtype_bytes(shape), experts=_GMM_EXPERTS,
        options=options)
    return _with_classic(_dedupe([t.config() for t in tiles]),
                         _gmm_analytic(shape))


def _gmm_analytic(shape: dict) -> dict:
    return autotune.gmm_tiles(shape["c"], path=_gmm_path(shape)).config()


def _gmm_runner_factory(shape: dict, device: torch.device):
    from repro_torch.configs.base import torch_dtype
    from repro_torch.kernels.moe_gmm import ops as mg

    c, d, f, e = shape["c"], shape["d"], shape["f"], _GMM_EXPERTS
    store = torch_dtype(shape["dtype"])
    quantized = _quantized(shape)
    xdt = torch.bfloat16 if quantized else store

    def make(gen):
        x = _randn(gen, (e, c, d), xdt, device)
        w = _randn(gen, (e, d, f), torch.float32, device)
        if quantized:
            return (x, *mg.quantize_expert_weights(w, dtype=store))
        return x, w.to(store)

    sets = _input_sets(make, device, xdt.itemsize * e * c * d
                       + store.itemsize * e * d * f)
    on_cuda = device.type == "cuda"

    def runner(config: dict) -> Callable[[], None]:
        fn = mg.grouped_matmul_quantized if quantized else mg.grouped_matmul
        return _Runner(lambda *a: fn(*a, tiles=config), sets, on_cuda)

    return runner


# ---------------------------------------------------------------------------
# mamba_ssd: chunk (K12; K13 for a 1-byte x)
# ---------------------------------------------------------------------------

def _ssd_bucket(*, s: int, p: int, n: int, dtype: str = "float32") -> dict:
    return {"s": _pow2_bucket(s, floor=16), "p": int(p), "n": int(n),
            "dtype": str(dtype)}


# The runners' head layout: the bucket has none, and the one timed is
# mamba2-780m's (48 heads, one group), one request.
_SSD_HEADS = 48


def _ssd_candidates(shape: dict) -> list[dict]:
    from repro_torch.kernels.mamba_ssd import ops as ss

    bdt = torch.float32 if shape["dtype"] == "float32" else torch.bfloat16
    built = ss.chunks(shape["p"], shape["n"], bdt)
    chunks = autotune.ssd_chunk_candidates(
        shape["s"], shape["p"], shape["n"], dtype_bytes=_dtype_bytes(shape),
        heads=_SSD_HEADS, options=built)
    return _with_classic(_dedupe([{"chunk": q} for q in chunks]),
                         _ssd_analytic(shape))


def _ssd_analytic(shape: dict) -> dict:
    return {"chunk": autotune.ssd_chunk_size(
        shape["s"], headdim=shape["p"], d_state=shape["n"])}


def _ssd_runner_factory(shape: dict, device: torch.device):
    from repro_torch.configs.base import torch_dtype
    from repro_torch.kernels import quant
    from repro_torch.kernels.mamba_ssd import ops as ss

    s, p, n, h = shape["s"], shape["p"], shape["n"], _SSD_HEADS
    store = torch_dtype(shape["dtype"])
    quantized = _quantized(shape)
    bdt = torch.bfloat16 if quantized else store

    def make(gen):
        x = _randn(gen, (1, s, h, p), bdt, device)
        dt = torch.nn.functional.softplus(
            torch.randn((1, s, h), generator=gen, device=device))
        a = -torch.exp(torch.randn((h,), generator=gen, device=device))
        b_in = _randn(gen, (1, s, 1, n), bdt, device)
        c_in = _randn(gen, (1, s, 1, n), bdt, device)
        if quantized:
            xq, xs = quant.quantize(x, dtype=store,
                                    scale_dtype=quant.SCALE_DTYPE)
            return xq, xs, dt, a, b_in, c_in
        return x, dt, a, b_in, c_in

    sets = _input_sets(make, device, s * h * p * (store.itemsize + 2)
                       + 2 * 2 * s * n + 4 * s * h)
    on_cuda = device.type == "cuda"

    def runner(config: dict) -> Callable[[], None]:
        q = int(config["chunk"])
        fn = ss.ssd_quantized if quantized else ss.ssd
        return _Runner(lambda *a: fn(*a, chunk=q), sets, on_cuda)

    return runner


# ---------------------------------------------------------------------------
# DMA-vs-compute breakdown (attention kernels)
# ---------------------------------------------------------------------------

def dma_compute_breakdown(kernel: str, shape: dict,
                          config: dict) -> Optional[dict]:
    """Modeled copy vs product seconds for one candidate of an attention
    kernel on the card — the column that shows *why* a staging depth wins
    (the reference's, on the H100's terms).

    ``dma_s`` is the K/V bytes the call reads over the HBM rate (3.35
    TB/s), ``compute_s`` its products over the path's rate (989 TFLOP/s
    bf16, 67 f32 on the CUDA cores), with the flash forward's tiles
    (``block_q`` / ``block_k``: each query tile reads every KV tile, as
    the kernel walks them); ``stall_s`` is the modeled *exposed* copy
    wait: the stream's excess over the products divided by the ring depth
    (depth 1 = the classic kernel, whose next tile is fetched after the
    products).  None for kernels without a staged KV stream (gmm, ssd)."""
    dtype_bytes = _dtype_bytes(shape)
    nb = max(1, int(config.get("num_buffers", 1)))
    flops = autotune.PEAK_FLOPS if dtype_bytes <= 2 else autotune.F32_FLOPS
    if kernel == "flash_attention":
        d, dv = shape["d"], shape.get("dv", shape["d"])
        bq = int(config.get("block_q", autotune.MMA_BLOCK_Q))
        bk = int(config.get("block_k", autotune.MMA_BLOCK_K))
        steps = -(-shape["sq"] // bq) * -(-shape["skv"] // bk)
        compute_s = steps * 2.0 * bq * bk * (d + dv) / flops
        dma_s = steps * bk * (d + dv) * dtype_bytes / autotune.HBM_BYTES_PER_S
    elif kernel in ("decode_attention", "paged_decode_attention"):
        rows = shape["s"] * shape.get("rows", 1)
        d, dv = shape["d"], shape.get("dv", shape["d"])
        compute_s = 2.0 * rows * (d + dv) / flops
        dma_s = rows * (d + dv) * dtype_bytes / autotune.HBM_BYTES_PER_S
    else:
        return None
    stall_s = max(0.0, dma_s - compute_s) / nb
    return {"dma_s": dma_s, "compute_s": compute_s, "stall_s": stall_s}


# ---------------------------------------------------------------------------
# registry + CLI shape sets
# ---------------------------------------------------------------------------

SPECS: dict[str, KernelSpec] = {
    "flash_attention": KernelSpec(
        "flash_attention", _flash_bucket, _flash_candidates,
        _flash_runner_factory, _flash_analytic),
    "decode_attention": KernelSpec(
        "decode_attention", _decode_bucket, _decode_candidates,
        _decode_runner_factory, _decode_analytic),
    "paged_decode_attention": KernelSpec(
        "paged_decode_attention", _paged_decode_bucket,
        _paged_decode_candidates, _paged_decode_runner_factory,
        _paged_decode_analytic),
    "moe_gmm": KernelSpec(
        "moe_gmm", _gmm_bucket, _gmm_candidates, _gmm_runner_factory,
        _gmm_analytic),
    "mamba_ssd": KernelSpec(
        "mamba_ssd", _ssd_bucket, _ssd_candidates, _ssd_runner_factory,
        _ssd_analytic),
}

# The card's main-path buckets: full-width qwen2.5-3b's 512-wide prefill
# into the 1024-row cache, and its decode tick of 8 slots x 2 KV heads
# against that cache, contiguous and paged (page size 16, bf16 and int8),
# and the open bucket ServeConfig(page_size=None) resolves; the vision
# family's cross tick (one query over 1,601 patch rows); deepseek-v2-lite's
# expert products (the decode's gate/up and down share one bucket, f
# rounding up to 2048 as the reference rounds it), its 488-token prefill
# (C = 64), its training forward (C = 240) and K15 at the decode shape;
# mamba2-780m's 488-token prefill (bf16 and int8 x) and zamba2-2.7b's scan.
REPRESENTATIVE_SHAPES: dict[str, list[dict]] = {
    "flash_attention": [
        dict(sq=512, skv=1024, d=128, dtype="bfloat16", causal=True),
        dict(sq=1, skv=1601, d=128, dtype="bfloat16", causal=False)],
    "decode_attention": [dict(s=1024, d=128, dtype="bfloat16", rows=16)],
    "paged_decode_attention": [
        dict(s=1024, page_size=16, d=128, dtype="bfloat16", rows=16),
        dict(s=1024, page_size=16, d=128, dtype="int8", rows=16),
        dict(s=1024, page_size=0, d=128, dtype="bfloat16", rows=16)],
    "moe_gmm": [
        dict(c=8, d=2048, f=1408, dtype="bfloat16"),
        dict(c=8, d=1408, f=2048, dtype="bfloat16"),
        dict(c=64, d=2048, f=1408, dtype="bfloat16"),
        dict(c=240, d=2048, f=1408, dtype="bfloat16"),
        dict(c=8, d=2048, f=1408, dtype="int8")],
    "mamba_ssd": [
        dict(s=488, p=64, n=128, dtype="bfloat16"),
        dict(s=488, p=64, n=128, dtype="int8"),
        dict(s=488, p=64, n=64, dtype="bfloat16")],
}

# CPU-sized sweeps (the plain versions): the machinery, not a winner.
QUICK_SHAPES: dict[str, list[dict]] = {
    "flash_attention": [dict(sq=16, skv=64, d=128, dtype="bfloat16",
                             causal=True)],
    "decode_attention": [dict(s=128, d=16, dtype="float32", rows=2)],
    "paged_decode_attention": [dict(s=128, page_size=0, d=16,
                                    dtype="float32", rows=2)],
    "moe_gmm": [dict(c=8, d=64, f=64, dtype="bfloat16")],
    "mamba_ssd": [dict(s=64, p=32, n=64, dtype="bfloat16")],
}
