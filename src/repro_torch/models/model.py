"""Top-level Model: init / prefill / decode_step and the serve hooks, for
the dense family.

Public API (used by serve/):

    model = Model(cfg, device="cuda")
    params = model.init(seed=0)
    loss, metrics = model.loss(params, {"tokens": toks})
    logits, cache = model.prefill(params, {"tokens": toks}, max_len)
    logits, cache = model.decode_step(params, tokens, cache)

Params and caches are nested dicts of tensors shaped as in the reference
(layer-stacked leaves with a leading [n_layers] axis).  The KV cache is
one layer-stacked tensor per leaf, ``k``/``v`` [L, B, max_len, Hkv, D],
and unlike the reference's it is UPDATED IN PLACE: ``decode_step`` and
``prefill`` write the new tokens' K/V into the tensors they were given
and return the same tensors beside a new ``len`` entry.  The paged serve
cache (``init_paged_cache`` and the hooks after it) is updated in place
too.  Other families (moe, ssm, hybrid, vlm, encdec) are not ported yet
and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.kernels import quant
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers, transformer as tfm

LOSS_CHUNK = 512


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: str = "cuda"

    def __post_init__(self):
        if self.cfg.family != "dense" or self.cfg.use_mla:
            raise NotImplementedError(
                f"{self.cfg.name}: family {self.cfg.family!r} is not ported "
                f"yet — only the dense family is (ROADMAP: the SSM family, "
                f"MoE/MLA, encoder-decoder and vision)")

    # ------------------------------------------------------------------ init

    def init(self, seed: int = 0) -> dict:
        """Random params with the reference's distributions, drawn on
        ``self.device`` from a ``torch.Generator`` seeded with ``seed``."""
        cfg = self.cfg
        dtype = cfg.dtype
        gen = torch.Generator(device=self.device).manual_seed(seed)
        p: dict[str, Any] = {
            "embed": layers.embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                           dtype),
            "ln_f": layers.rmsnorm_init(cfg.d_model, dtype=dtype,
                                        device=self.device),
        }
        if not cfg.tie_embeddings:
            p["head"] = layers.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                          stddev=0.02, dtype=dtype)
        p["blocks"] = tfm.dense_block_init(gen, cfg, cfg.n_layers,
                                           dtype=dtype)
        return p

    # ------------------------------------------------------------- backbone

    def _backbone(self, params, x, caches=None, *, train=False):
        """x: [B, S, d] embedded tokens; returns (x, new_caches).  A
        training pass (``train``) rematerialises each layer under
        ``cfg.remat_policy``."""
        cfg = self.cfg
        return tfm.scan_layers(
            lambda p, xc, c: tfm.dense_block_apply(p, cfg, xc, cache=c),
            params["blocks"], x, caches, remat=train,
            remat_policy=cfg.remat_policy)

    def _logits(self, params, x):
        if self.cfg.tie_embeddings:
            return layers.unembed(params["embed"], x)
        return layers.dense(params["head"], x)

    def _tokens(self, tokens) -> torch.Tensor:
        """Token ids (numpy, a list, or a tensor on any device) as int64
        on ``self.device``."""
        if isinstance(tokens, torch.Tensor):
            return tokens.to(device=self.device, dtype=torch.long)
        return torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                               device=self.device)

    # ----------------------------------------------------------------- loss

    def loss(self, params, batch):
        """Next-token cross-entropy over ``batch["tokens"]`` [B, S]; returns
        (loss, {"ce", "aux"}), scalars in f32.

        Position i predicts token i + 1 and the last position is masked.
        The head is applied in sequence chunks of ``LOSS_CHUNK`` so that
        no [B, S, V] logits tensor exists at once; the per-chunk sums add
        up in order, as the reference's scan does.  ``aux`` (the MoE
        balance loss) is 0 for the dense family."""
        cfg = self.cfg
        tokens = self._tokens(batch["tokens"])
        x = layers.embed(params["embed"], tokens).to(cfg.dtype)
        x, _ = self._backbone(params, x, train=True)
        x = layers.rmsnorm(params["ln_f"], x, cfg.norm_eps)
        b, s, _ = x.shape
        targets = torch.cat([tokens[:, 1:], tokens.new_zeros((b, 1))], 1)
        mask = torch.ones((b, s), dtype=torch.float32, device=x.device)
        mask[:, -1] = 0.0
        chunk = min(LOSS_CHUNK, s)
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for c0 in range(0, s, chunk):
            logits = self._logits(params, x[:, c0:c0 + chunk]).float()
            logz = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(-1, targets[:, c0:c0 + chunk, None])[..., 0]
            total = total + ((logz - gold) * mask[:, c0:c0 + chunk]).sum()
        ce = total / mask.sum().clamp_min(1.0)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return ce + aux, {"ce": ce, "aux": aux}

    # ------------------------------------------------------------ inference

    def init_cache(self, batch_size: int, max_len: int,
                   dtype=torch.bfloat16, *, device=None) -> dict:
        """Layer-stacked KV cache with scalar-form ``len`` [L]."""
        ac = tfm.attn_cfg(self.cfg)
        one = attn_mod.init_kv_cache(ac, batch_size, max_len,
                                     torch_dtype(dtype),
                                     device=device or self.device)
        n = self.cfg.n_layers
        return {key: leaf[None].expand((n,) + leaf.shape).contiguous()
                for key, leaf in one.items()}

    def prefill(self, params, batch, max_len: int,
                cache_dtype=torch.bfloat16):
        """Run the prompt; returns (last-token logits [B,V] f32, cache)."""
        cfg = self.cfg
        tokens = self._tokens(batch["tokens"])
        cache = self.init_cache(tokens.shape[0], max_len, cache_dtype)
        x = layers.embed(params["embed"], tokens).to(cfg.dtype)
        x, cache = self._backbone(params, x, cache)
        x = layers.rmsnorm(params["ln_f"], x[:, -1:], cfg.norm_eps)
        return self._logits(params, x)[:, 0].float(), cache

    def decode_step(self, params, tokens, cache):
        """tokens: [B,1] -> (logits [B,V] f32, cache advanced in place)."""
        cfg = self.cfg
        x = layers.embed(params["embed"], self._tokens(tokens)).to(cfg.dtype)
        x, cache = self._backbone(params, x, cache)
        x = layers.rmsnorm(params["ln_f"], x, cfg.norm_eps)
        return self._logits(params, x)[:, 0].float(), cache

    # ------------------------------------------- continuous-serving hooks

    @property
    def pad_safe_prefill(self) -> bool:
        """Right-padded prompts batch safely: every cross-position op of
        the dense family is causal attention."""
        return self.cfg.family == "dense"

    def prefill_padded(self, params, batch, max_len: int,
                       cache_dtype=torch.bfloat16):
        """Pad-masked prefill of right-padded mixed-length prompts.

        ``batch["tokens"]`` [B, W] right-padded, ``batch["lengths"]`` [B]
        true lengths (1 <= L <= W).  Returns (logits at each row's last
        real token [B, V], cache whose ``len`` entries are per-row [B]
        vectors set to the true lengths): the pad positions' K/V stay
        masked behind ``kv_len`` until overwritten.
        """
        cfg = self.cfg
        tokens = self._tokens(batch["tokens"])
        lengths = torch.as_tensor(np.asarray(batch["lengths"]),
                                  dtype=torch.long, device=self.device)
        b = tokens.shape[0]
        cache = self.init_cache(b, max_len, cache_dtype)
        x = layers.embed(params["embed"], tokens).to(cfg.dtype)
        x, cache = self._backbone(params, x, cache)
        idx = torch.clamp(lengths - 1, 0, tokens.shape[1] - 1)
        x_last = x[torch.arange(b, device=self.device), idx][:, None]
        x_last = layers.rmsnorm(params["ln_f"], x_last, cfg.norm_eps)
        logits = self._logits(params, x_last)[:, 0].float()
        return logits, self.set_cache_lengths(cache, lengths)

    @staticmethod
    def set_cache_lengths(cache, lengths) -> dict:
        """Rewrite every ``len`` entry of a cache tree to per-row lengths.

        A ``len`` leaf's existing shape is pure stack dims; the row vector
        is broadcast behind them, ``[*stack] -> [*stack, B]``, as int32 on
        the leaf's device (a fresh tensor, so the serve path may splice
        rows into it in place)."""

        if not isinstance(lengths, torch.Tensor):
            lengths = torch.from_numpy(np.asarray(lengths))

        def walk(node):
            out = {}
            for key, leaf in node.items():
                if isinstance(leaf, dict):
                    out[key] = walk(leaf)
                elif key == "len":
                    rows = lengths.to(device=leaf.device, dtype=torch.int32)
                    out[key] = rows.expand(leaf.shape + rows.shape).clone()
                else:
                    out[key] = leaf
            return out

        return walk(cache)

    def cache_batch_axes(self, *, per_row_len: bool = True,
                         dtype=torch.bfloat16) -> dict:
        """Tree of ints: the batch-axis index of every cache leaf, or -1
        for a batch-independent leaf (scalar-form ``len``).  Found by
        probing two batch sizes on the meta device (nothing allocated)."""

        def make(bsz):
            cache = self.init_cache(bsz, 8, dtype, device="meta")
            if per_row_len:
                cache = self.set_cache_lengths(
                    cache, torch.zeros(bsz, dtype=torch.int32))
            return cache

        return _differing_axis(make(2), make(3), "batch")

    @staticmethod
    def splice_cache(cache, prefill_cache, slot: int, *, axes, row: int = 0):
        """Copy row ``row`` of a prefill cache into batch slot ``slot`` of
        a (larger) serve cache, in place; returns ``cache``.  Both caches
        share every non-batch dim.  Leaves whose axis is -1 keep the
        destination's value."""

        def walk(dst, src, ax):
            for key in dst:
                if isinstance(dst[key], dict):
                    walk(dst[key], src[key], ax[key])
                elif ax[key] >= 0:
                    dst[key].select(ax[key], slot).copy_(
                        src[key].select(ax[key], row))

        walk(cache, prefill_cache, axes)
        return cache

    # ----------------------------------------------- paged-KV serving hooks

    @property
    def supports_paged_kv(self) -> bool:
        """Whether this family can decode against a paged KV pool: every
        growing cache leaf is an ``attn_apply`` KV cache (dense; hybrid's
        shared attention blocks), or nothing grows at all (ssm)."""
        return (self.cfg.family in ("dense", "ssm", "hybrid")
                and not self.cfg.use_mla)

    @property
    def prefix_shareable(self) -> bool:
        """Whether a token prefix's cache state is rebuilt from KV pages
        alone — the precondition for shared-prefix reuse (dense only)."""
        return self.cfg.family == "dense" and not self.cfg.use_mla

    def cache_page_spec(self, *, max_len: int = 8,
                        dtype=torch.bfloat16) -> dict:
        """Tree of ints over the contiguous cache: each leaf's token-axis
        index (the axis that scales with ``max_len``), or -1 for leaves
        that do not grow with sequence length (``len``).  Found by probing
        two ``max_len`` values on the meta device (nothing allocated)."""
        return _differing_axis(
            self.init_cache(2, max_len, dtype, device="meta"),
            self.init_cache(2, 2 * max_len, dtype, device="meta"), "token")

    def init_paged_cache(self, n_slots: int, max_len: int, num_pages: int,
                         page_size: int, dtype=torch.bfloat16) -> dict:
        """Paged serve cache: every token-axis KV leaf becomes a shared page
        pool, everything else stays per slot.

        A contiguous leaf ``[*stack, B, max_len, ...]`` becomes a pool
        ``[*stack, num_pages + 1, page_size, ...]``; pool page 0 is the
        reserved scratch page (idle slots' decode writes land there; never
        allocated, never unmasked).  Each dict that holds pool leaves gains
        a ``"pt"`` page table ``[*stack, B, max_len // page_size]`` int32,
        and its ``len`` takes the per-row ``[*stack, B]`` form.  Allocated
        on ``self.device``."""
        if max_len % page_size:
            raise ValueError(f"max_len {max_len} must be a multiple of "
                             f"page_size {page_size}")
        if not self.supports_paged_kv:
            raise ValueError(
                f"family {self.cfg.family!r} has no paged decode path — "
                f"see Model.supports_paged_kv")
        pages_per_seq = max_len // page_size
        template = self.init_cache(n_slots, max_len, dtype, device="meta")
        spec = self.cache_page_spec(dtype=dtype)
        dev = self.device

        def walk(tpl, sp):
            if isinstance(tpl, dict):
                out = {}
                paged_stack = None
                for key, sub in tpl.items():
                    if key == "len":
                        out["len"] = torch.zeros(
                            tuple(sub.shape) + (n_slots,), dtype=torch.int32,
                            device=dev)
                        continue
                    out[key] = walk(sub, sp[key])
                    if not isinstance(sub, dict) and sp[key] >= 0:
                        paged_stack = tuple(sub.shape[: sp[key] - 1])
                if paged_stack is not None:
                    out["pt"] = torch.zeros(
                        paged_stack + (n_slots, pages_per_seq),
                        dtype=torch.int32, device=dev)
                return out
            t = sp
            if t < 0:
                return torch.zeros(tpl.shape, dtype=tpl.dtype, device=dev)
            return torch.zeros(
                tuple(tpl.shape[: t - 1]) + (num_pages + 1, page_size)
                + tuple(tpl.shape[t + 1:]), dtype=tpl.dtype, device=dev)

        return walk(template, spec)

    def write_page(self, paged_cache, prefill_cache, phys: Sequence[int],
                   src_pages: Sequence[int], *, spec,
                   page_size: int) -> dict:
        """Copy pages ``src_pages`` of row 0 of a contiguous prefill cache
        (page j: tokens ``[j * page_size, (j + 1) * page_size)``) into the
        physical pages ``phys`` of every pool leaf, in place, one indexed
        copy per leaf; returns ``paged_cache``.  Leaves without a token
        axis (and ``len``/``pt``) are untouched."""
        if len(phys) != len(src_pages):
            raise ValueError(f"{len(phys)} pages to write from "
                             f"{len(src_pages)} source pages")
        tok = [t for j in src_pages
               for t in range(j * page_size, (j + 1) * page_size)]

        def walk(pg, pre, sp):
            for key in pg:
                if key in ("len", "pt") or key not in pre:
                    continue
                if isinstance(pg[key], dict):
                    walk(pg[key], pre[key], sp[key])
                    continue
                t = sp[key]
                if t < 0:
                    continue
                dst = pg[key]
                # [*stack, S, ...]; fp8 leaves are copied as bytes
                row = quant.as_bytes(pre[key].to(dst.dtype).select(t - 1, 0))
                piece = row.index_select(t - 1, torch.tensor(
                    tok, dtype=torch.long, device=row.device)).unflatten(
                    t - 1, (len(src_pages), page_size))
                quant.as_bytes(dst).index_copy_(t - 1, torch.tensor(
                    phys, dtype=torch.long, device=dst.device), piece)

        walk(paged_cache, prefill_cache, spec)
        return paged_cache

    def admit_paged_slot(self, paged_cache, prefill_cache, slot: int,
                         length: int, pt_row, *, spec, axes) -> dict:
        """Point batch slot ``slot`` of a paged cache at its pages, in
        place: its page-table row becomes ``pt_row``, its ``len``
        ``length``, and row 0 of the prefill cache is spliced into every
        per-slot (non-pool) leaf — the paged twin of :meth:`splice_cache`.
        Pool leaves are untouched (:meth:`write_page` fills them)."""
        row = torch.as_tensor(np.asarray(pt_row), dtype=torch.int32)

        def walk(pg, pre, sp, ax):
            for key in pg:
                leaf = pg[key]
                if key == "pt":
                    leaf.select(leaf.dim() - 2, slot).copy_(
                        row.to(leaf.device).expand(
                            leaf.shape[:-2] + row.shape))
                elif key == "len":
                    leaf.select(leaf.dim() - 1, slot).fill_(int(length))
                elif isinstance(leaf, dict):
                    walk(leaf, pre[key], sp[key], ax[key])
                elif sp[key] < 0:
                    leaf.select(ax[key], slot).copy_(
                        pre[key].select(ax[key], 0))

        walk(paged_cache, prefill_cache, spec, axes)
        return paged_cache

    def gather_prefix_cache(self, paged_cache, pt_row, length: int, *,
                            spec, page_size: int) -> dict:
        """A batch-of-1, scalar-``len`` contiguous cache gathered from the
        pages named by ``pt_row`` — the view :meth:`prefill_continue`
        extends when a prefix-cache hit skips recomputation.  Only for
        fully paged families (:attr:`prefix_shareable`)."""
        row = torch.as_tensor(np.asarray(pt_row), dtype=torch.long)

        def walk(pg, sp):
            out = {}
            for key, sub in pg.items():
                if key == "pt":
                    continue
                if key == "len":
                    out[key] = torch.full(sub.shape[:-1], int(length),
                                          dtype=torch.int32,
                                          device=sub.device)
                    continue
                if isinstance(sub, dict):
                    out[key] = walk(sub, sp[key])
                    continue
                t = sp[key]
                if t < 0:
                    raise ValueError(
                        "gather_prefix_cache needs a fully paged cache "
                        "(Model.prefix_shareable families only)")
                got = quant.as_bytes(sub).index_select(
                    t - 1, row.to(sub.device)).view(sub.dtype)
                got = got.flatten(t - 1, t)           # [*stack, P*ps, ...]
                out[key] = got.unsqueeze(t - 1)       # [*stack, 1, S, ...]
            return out

        return walk(paged_cache, spec)

    def prefill_continue(self, params, tokens, cache):
        """Extend a scalar-``len`` cache by ``tokens`` [B, S] (S >= 1), in
        place: the continuation prefill a prefix-cache hit runs over just
        the uncached suffix (on CUDA through K1 with ``q_offset`` = the
        cached length).  Returns (logits at the last new token [B, V] f32,
        cache)."""
        cfg = self.cfg
        x = layers.embed(params["embed"], self._tokens(tokens)).to(cfg.dtype)
        x, cache = self._backbone(params, x, cache)
        x = layers.rmsnorm(params["ln_f"], x[:, -1:], cfg.norm_eps)
        return self._logits(params, x)[:, 0].float(), cache


def _differing_axis(a: dict, b: dict, what: str) -> dict:
    """Tree of ints over two caches of one structure: the one axis where
    each leaf's shapes differ, or -1 where they agree."""
    out = {}
    for key in a:
        if isinstance(a[key], dict):
            out[key] = _differing_axis(a[key], b[key], what)
            continue
        diffs = [i for i, (x, y) in enumerate(zip(a[key].shape,
                                                  b[key].shape)) if x != y]
        if len(diffs) > 1:
            raise ValueError(
                f"cannot identify {what} axis: shapes "
                f"{tuple(a[key].shape)} vs {tuple(b[key].shape)}")
        out[key] = diffs[0] if diffs else -1
    return out
