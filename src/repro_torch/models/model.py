"""Top-level Model: init / prefill / decode_step and the serve hooks, for
the dense family.

Public API (used by serve/):

    model = Model(cfg, device="cuda")
    params = model.init(seed=0)
    logits, cache = model.prefill(params, {"tokens": toks}, max_len)
    logits, cache = model.decode_step(params, tokens, cache)

Params and caches are nested dicts of tensors shaped as in the reference
(layer-stacked leaves with a leading [n_layers] axis).  The KV cache is
one layer-stacked tensor per leaf, ``k``/``v`` [L, B, max_len, Hkv, D],
and unlike the reference's it is UPDATED IN PLACE: ``decode_step`` and
``prefill`` write the new tokens' K/V into the tensors they were given
and return the same tensors beside a new ``len`` entry.  Other families
(moe, ssm, hybrid, vlm, encdec) are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers, transformer as tfm


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

    def _backbone(self, params, x, caches=None):
        cfg = self.cfg
        return tfm.scan_layers(
            lambda p, xc, c: tfm.dense_block_apply(p, cfg, xc, cache=c),
            params["blocks"], x, caches)

    def _logits(self, params, x):
        if self.cfg.tie_embeddings:
            return layers.unembed(params["embed"], x)
        return layers.dense(params["head"], x)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                               device=self.device)

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

        def axes(a, b):
            out = {}
            for key in a:
                if isinstance(a[key], dict):
                    out[key] = axes(a[key], b[key])
                    continue
                diffs = [i for i, (x, y) in enumerate(
                    zip(a[key].shape, b[key].shape)) if x != y]
                if len(diffs) > 1:
                    raise ValueError(
                        f"cannot identify batch axis: shapes "
                        f"{tuple(a[key].shape)} vs {tuple(b[key].shape)}")
                out[key] = diffs[0] if diffs else -1
            return out

        return axes(make(2), make(3))

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
