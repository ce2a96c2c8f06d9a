"""Top-level Model: init / prefill / decode_step and the serve hooks, for
the dense, MoE (with MLA attention), SSM (Mamba2), hybrid (Zamba2),
vision (gated cross-attention) and encoder-decoder families.

Public API (used by serve/):

    model = Model(cfg, device="cuda")
    params = model.init(seed=0)
    loss, metrics = model.loss(params, {"tokens": toks})
    logits, cache = model.prefill(params, {"tokens": toks}, max_len)
    logits, cache = model.decode_step(params, tokens, cache)
    logits, cache = model.verify_step(params, tokens, cache)  # [B, S, V]

Params and caches are nested dicts of tensors shaped as in the reference
(layer-stacked leaves with a leading [n_layers] axis).  The KV cache is
one layer-stacked tensor per leaf, ``k``/``v`` [L, B, max_len, Hkv, D],
and unlike the reference's it is UPDATED IN PLACE: ``decode_step``,
``verify_step`` and ``prefill`` write the new tokens' K/V into the
tensors they were given and return the same tensors beside a new
``len`` entry.  The SSM
family's cache, {"conv": [L, B, K-1, C], "state": [L, B, H, P, N]} (both
f32 whatever the serve dtype, as in the reference; no ``len``), is
advanced in place the same way, and has no token axis: its paged form
holds no page pool.  The MoE family's MLA cache, {"dense0", "blocks"},
each {"ckv": [L, B, max_len, kv_lora], "kr": [L, B, max_len, qk_rope],
"len"}, is written in place the same way; it has no paged or quantized
form, as in the reference.  The hybrid family's cache is a stack over
its groups of {"ssm": the group's [attn_every]-stacked SSM cache, "attn":
the shared attention block's KV cache}: leaves [G, attn_every, B, ...]
and [G, B, max_len, Hkv, D]; its paged form pages the "attn" leaves only.
The paged serve cache (``init_paged_cache`` and the hooks after it) is
updated in place too.  The vision family's cache is a stack over its
groups of {"self": the group's [self_per_group]-stacked KV caches,
"cross": {"ck", "cv"}}: leaves [G, spg, B, max_len, Hkv, D] and [G, B,
vision_seq, Hkv, D]; the encoder-decoder family's, over its decoder
layers, {"self": KV cache, "ck", "cv": [L, B, enc_len, Hkv, D]}.  Both
take their modal input at prefill (``batch["patches"]`` [B, vision_seq,
d], ``batch["frames"]`` [B, S_enc, d]), write the cross K/V once, and
decode against them; they serve through ``Engine.generate`` only, with
no paged, quantized or pad-masked form, as in the reference.  Every
family but MoE trains (``loss``); the vision and encoder-decoder families
take their modal input in the training batch too.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.core.tree import flatten
from repro_torch.distributed import sharding
from repro_torch.kernels import quant
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers, mla, ssm, transformer as tfm

LOSS_CHUNK = 512
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "encdec")
# the families whose prefill takes a modal input, by its batch key
MODAL_INPUTS = {"vlm": "patches", "encdec": "frames"}


def next_token_targets(tokens: torch.Tensor) -> tuple:
    """(targets, mask) of token rows [B, S]: position i predicts token
    i + 1, and each row's last position, which predicts nothing, is
    masked (f32 [B, S])."""
    b = tokens.shape[0]
    targets = torch.cat([tokens[:, 1:], tokens.new_zeros((b, 1))], 1)
    mask = torch.ones(tuple(tokens.shape), dtype=torch.float32,
                      device=tokens.device)
    mask[:, -1] = 0.0
    return targets, mask


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: str = "cuda"

    def __post_init__(self):
        fam = self.cfg.family
        if fam not in FAMILIES:
            raise ValueError(f"unknown family {fam!r}")
        if self.cfg.use_mla and fam != "moe":
            raise NotImplementedError(
                f"{self.cfg.name}: MLA attention in the {fam} family is not "
                f"ported (no configuration of the reference uses it; the "
                f"moe family carries MLA)")

    # ------------------------------------------------------------------ init

    def init(self, seed: int = 0) -> dict:
        """Random params with the reference's distributions, drawn on
        ``self.device`` from a ``torch.Generator`` seeded with ``seed``.  On
        ``"meta"`` the same tree of meta tensors, nothing drawn (the dry
        run's parameters)."""
        cfg = self.cfg
        dtype = cfg.dtype
        gen = (layers.MetaGenerator() if torch.device(self.device).type
               == "meta" else torch.Generator(device=self.device))
        gen.manual_seed(seed)
        p: dict[str, Any] = {
            "embed": layers.embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                           dtype),
            "ln_f": layers.rmsnorm_init(cfg.d_model, dtype=dtype,
                                        device=self.device),
        }
        if not cfg.tie_embeddings:
            p["head"] = layers.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                          stddev=0.02, dtype=dtype)
        if cfg.family == "ssm":
            p["blocks"] = tfm.ssm_block_init(gen, cfg, cfg.n_layers,
                                             dtype=dtype)
        elif cfg.family == "hybrid":
            # attn_every SSD blocks in each of n_layers // attn_every
            # groups, then one shared dense block on concat([x, x0])
            g = cfg.n_layers // cfg.attn_every
            p["groups"] = tfm.ssm_block_init(gen, cfg, (g, cfg.attn_every),
                                             dtype=dtype)
            p["shared_proj"] = layers.dense_init(gen, 2 * cfg.d_model,
                                                 cfg.d_model, dtype=dtype)
            p["shared"] = tfm.dense_block_init(gen, cfg, (), dtype=dtype)
        elif cfg.family == "moe":
            nd = cfg.first_dense_layers
            if nd:
                p["dense0"] = tfm.dense_block_init(
                    gen, cfg, nd, d_ff=cfg.dense_d_ff, dtype=dtype)
            p["blocks"] = tfm.moe_block_init(gen, cfg, cfg.n_layers - nd,
                                             dtype=dtype)
        elif cfg.family == "vlm":
            # self_per_group dense blocks, then one gated cross block, in
            # each of cross_attn_groups groups
            g = cfg.cross_attn_groups
            p["groups"] = {
                "self": tfm.dense_block_init(gen, cfg,
                                             (g, cfg.self_per_group),
                                             dtype=dtype),
                "cross": tfm.cross_block_init(gen, cfg, g, gated=True,
                                              dtype=dtype),
            }
        elif cfg.family == "encdec":
            p["enc_blocks"] = self._enc_block_init(gen, cfg,
                                                   cfg.n_encoder_layers,
                                                   dtype)
            p["dec_blocks"] = self._encdec_block_init(gen, cfg, cfg.n_layers,
                                                      dtype)
            p["enc_ln"] = layers.rmsnorm_init(cfg.d_model, dtype=dtype,
                                              device=self.device)
        else:
            p["blocks"] = tfm.dense_block_init(gen, cfg, cfg.n_layers,
                                               dtype=dtype)
        return p

    # ---------------------------------------------------------- enc-dec bits

    @staticmethod
    def _enc_block_init(gen, cfg: ModelConfig, n_layers, dtype):
        """``n_layers`` stacked encoder blocks: non-causal self-attention
        with RoPE, then the MLP."""
        lead = (n_layers,)
        return {
            "ln1": layers.rmsnorm_init(cfg.d_model, lead=lead, dtype=dtype,
                                       device=gen.device),
            "attn": attn_mod.attn_init(gen, tfm.attn_cfg(cfg, causal=False),
                                       lead=lead, dtype=dtype),
            "ln2": layers.rmsnorm_init(cfg.d_model, lead=lead, dtype=dtype,
                                       device=gen.device),
            "mlp": layers.mlp_init(gen, cfg.d_model, cfg.d_ff, lead=lead,
                                   act=cfg.act, dtype=dtype),
        }

    @staticmethod
    def _enc_block_apply(p, cfg: ModelConfig, x):
        h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
        a, _ = attn_mod.attn_apply(p["attn"], tfm.attn_cfg(cfg, causal=False),
                                   h)
        x = x + a
        h = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
        return x + layers.mlp(p["mlp"], h, act=cfg.act)

    @staticmethod
    def _encdec_block_init(gen, cfg: ModelConfig, n_layers, dtype):
        """``n_layers`` stacked decoder blocks: causal self-attention, then
        cross-attention (no RoPE) over the encoder output, then the
        MLP."""
        lead = (n_layers,)
        norm = lambda: layers.rmsnorm_init(cfg.d_model, lead=lead,
                                           dtype=dtype, device=gen.device)
        return {
            "ln1": norm(),
            "self": attn_mod.attn_init(gen, tfm.attn_cfg(cfg), lead=lead,
                                       dtype=dtype),
            "ln2": norm(),
            "xattn": attn_mod.attn_init(
                gen, tfm.attn_cfg(cfg, causal=False, use_rope=False),
                lead=lead, dtype=dtype),
            "ln3": norm(),
            "mlp": layers.mlp_init(gen, cfg.d_model, cfg.d_ff, lead=lead,
                                   act=cfg.act, dtype=dtype),
        }

    def _encdec_block_apply(self, p, x, enc, cache=None):
        """One decoder layer; ``cache`` is {"self": KV cache, "ck", "cv"}
        or None, ``enc`` the encoder output (prefill) or None (decode: the
        cross K/V come from the cache).  Returns (x, new_cache or
        None)."""
        cfg = self.cfg
        h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
        a, new_self = attn_mod.attn_apply(
            p["self"], tfm.attn_cfg(cfg), h,
            cache=None if cache is None else cache["self"])
        x = x + a
        h = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
        a, ck, cv = tfm.cross_attention(p["xattn"], cfg, h, enc, cache)
        x = x + a
        h = layers.rmsnorm(p["ln3"], x, cfg.norm_eps)
        x = x + layers.mlp(p["mlp"], h, act=cfg.act)
        return x, (None if cache is None
                   else {"self": new_self, "ck": ck, "cv": cv})

    def _modal(self, batch, dtype):
        """The family's modal input (``MODAL_INPUTS``) of ``batch`` as a
        tensor of ``dtype`` on ``self.device``, or None when absent."""
        key = MODAL_INPUTS.get(self.cfg.family)
        got = None if batch is None or key is None else batch.get(key)
        if got is None:
            return None
        return got.to(device=self.device, dtype=dtype)

    # ------------------------------------------------------------- backbone

    def _backbone(self, params, x, caches=None, *, batch=None, train=False):
        """x: [B, S, d] embedded tokens; returns (x, new_caches, aux), aux
        the MoE layers' summed balance loss (0 elsewhere).  A training
        pass (``train``) rematerialises each layer under
        ``cfg.remat_policy``, as the reference does, except the hybrid
        and vision families' groups, rematerialised whole (``"full"``,
        their inner stacks not again), and the encoder stack, which is not
        rematerialised.  The moe family runs its dense first layers
        (``dense0``) and then its MoE blocks, each stack over its own
        cache.  The hybrid family runs each group's SSD blocks and then the
        shared dense block on ``shared_proj(concat([x, x0]))`` (x0 the
        embeddings), whose output is added to x; its weights are shared,
        and each of its applications has the group's own KV cache.  The
        vision family runs each group's self blocks, then its gated cross
        block over ``batch["patches"]`` (or over the cache, at decode or
        without patches).  The encoder-decoder family runs the encoder
        stack and ``enc_ln`` over ``batch["frames"]`` when they are there
        (a prefill), then the decoder layers over its output (or over the
        cross K/V in the cache, at decode)."""
        cfg = self.cfg
        if caches is not None and sharding.policy_seq_blocks() > 1:
            raise NotImplementedError(
                f"a prefill or decode under ShardingPolicy(seq_parallel="
                f"True) at a {sharding.SEQ_AXIS!r} axis of "
                f"{sharding.policy_seq_blocks()}: the serve path keeps whole "
                f"sequences (ROADMAP: distributed and launch)")
        if (sharding.seq_split() is not None
                and cfg.family not in ("dense", "moe")):
            raise NotImplementedError(
                f"sequence-parallel training of the {cfg.family} family: "
                f"its SSD state, encoder or cross K/V cross the sequence "
                f"blocks (ROADMAP: distributed and launch)")
        if (caches is not None and cfg.family not in ("dense", "moe")
                and any(sharding.block_of(t) is not None
                        for t in flatten(caches).values())):
            raise NotImplementedError(
                f"the {cfg.family} family on a block of a sequence-sharded "
                f"cache: its SSM state or cross K/V are split over heads "
                f"there (ROADMAP: distributed and launch)")
        aux = torch.zeros((), dtype=torch.float32, device=x.device)

        def scan(block, p, xc, c, remat=train, policy=cfg.remat_policy):
            return tfm.scan_layers(
                lambda pi, xi, ci: block(pi, cfg, xi, cache=ci), p, xc, c,
                remat=remat, remat_policy=policy)

        modal = self._modal(batch, x.dtype)
        if cfg.family == "vlm":

            def group(gp, cfg_, xc, cache=None):
                xc, new_self = scan(tfm.dense_block_apply, gp["self"], xc,
                                    None if cache is None else cache["self"],
                                    remat=False)
                xc, new_cross = tfm.cross_block_apply(
                    gp["cross"], cfg_, xc, modal,
                    cache=None if cache is None else cache["cross"])
                return xc, (None if cache is None
                            else {"self": new_self, "cross": new_cross})

            x, caches = scan(group, params["groups"], x, caches,
                             policy="full")
            return x, caches, aux
        if cfg.family == "encdec":
            enc = None
            if modal is not None:
                enc, _ = tfm.scan_layers(
                    lambda pi, xi, ci: (self._enc_block_apply(pi, cfg, xi),
                                        None),
                    params["enc_blocks"], modal)
                enc = layers.rmsnorm(params["enc_ln"], enc, cfg.norm_eps)
            x, caches = scan(
                lambda p, cfg_, xc, cache=None: self._encdec_block_apply(
                    p, xc, enc, cache), params["dec_blocks"], x, caches)
            return x, caches, aux
        if cfg.family == "hybrid":
            x0 = x

            def group(gp, cfg_, xc, cache=None):
                xc, new_ssm = scan(tfm.ssm_block_apply, gp, xc,
                                   None if cache is None else cache["ssm"],
                                   remat=False)
                h = layers.dense(params["shared_proj"],
                                 torch.cat([xc, x0], dim=-1))
                h, new_attn = tfm.dense_block_apply(
                    params["shared"], cfg_, h,
                    cache=None if cache is None else cache["attn"])
                return xc + h, (None if cache is None
                                else {"ssm": new_ssm, "attn": new_attn})

            x, caches = scan(group, params["groups"], x, caches,
                             policy="full")
            return x, caches, aux
        if cfg.family != "moe":
            block = (tfm.ssm_block_apply if cfg.family == "ssm"
                     else tfm.dense_block_apply)
            x, caches = scan(block, params["blocks"], x, caches)
            return x, caches, aux
        auxes = []

        def moe_block(p, cfg_, xc, cache=None):
            y, new_c, a = tfm.moe_block_apply(p, cfg_, xc, cache=cache)
            auxes.append(a)
            return y, new_c

        new_caches = {}
        if "dense0" in params:
            x, new_caches["dense0"] = scan(
                tfm.dense_block_apply, params["dense0"], x,
                None if caches is None else caches["dense0"])
        x, new_caches["blocks"] = scan(
            moe_block, params["blocks"], x,
            None if caches is None else caches["blocks"])
        return (x, None if caches is None else new_caches,
                aux + sum(auxes))

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
        up in order, as the reference's scan does.  ``aux`` is the MoE
        layers' summed balance and router z-losses (0 for the other
        families) and is added to the loss.  Every family trains; the
        vision and encoder-decoder families take their modal input from
        ``batch`` (``MODAL_INPUTS``) and raise a ``ValueError`` without
        it: they do not train on tokens alone.  On CUDA every attention
        backward is K11 (MLA's at Dk != Dv), every SSD backward K16 and
        every expert product's backward K17.

        Inside the sharded step under ``ShardingPolicy(seq_parallel=True)``
        (``sharding.seq_split``) the tokens are this rank's block of its
        rows' sequences and ``batch`` carries the block's ``targets`` and
        ``mask``, made from the whole rows; the loss is the rows' whole
        cross-entropy on every rank of the "model" axis (the blocks' sums
        over the rows' live count, added over the axis), and the dense and
        moe families alone train so.  Under that policy at a "model" axis
        above 1 the loss outside the sharded step raises."""
        cfg = self.cfg
        key = MODAL_INPUTS.get(cfg.family)
        if key is not None and batch.get(key) is None:
            raise ValueError(f"{cfg.name}: training the {cfg.family} family "
                             f"needs batch[{key!r}] beside the tokens")
        split = sharding.seq_split()
        if split is None and sharding.policy_seq_blocks() > 1:
            raise ValueError(
                "Model.loss under ShardingPolicy(seq_parallel=True) runs in "
                "the sharded step, which cuts the sequence "
                "(make_train_step(grad_shardings=...))")
        tokens = self._tokens(batch["tokens"])
        x = layers.embed(params["embed"], tokens).to(cfg.dtype)
        x, _, aux = self._backbone(params, x, batch=batch, train=True)
        x = layers.rmsnorm(params["ln_f"], x, cfg.norm_eps)
        b, s, _ = x.shape
        if split is None:
            targets, mask = next_token_targets(tokens)
        else:
            targets = self._tokens(batch["targets"])
            mask = batch["mask"].to(device=x.device, dtype=torch.float32)
        chunk = min(LOSS_CHUNK, s)
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for c0 in range(0, s, chunk):
            logits = self._logits(params, x[:, c0:c0 + chunk]).float()
            logz = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(-1, targets[:, c0:c0 + chunk, None])[..., 0]
            total = total + ((logz - gold) * mask[:, c0:c0 + chunk]).sum()
        if split is None:
            ce = total / mask.sum().clamp_min(1.0)
        else:
            # this block's share of its rows' mean, m times over: the
            # mean over "model" is then the rows' cross-entropy on every
            # rank, and its backward gives each block the gradient the
            # step's average over the ranks needs
            live = mask.sum()
            if split.blocks > 1:
                dist.all_reduce(live, group=sharding.group_of(
                    split.mesh, (split.axis,)))
            ce = sharding.mean_over(
                total * split.blocks / live.clamp_min(1.0), split.mesh,
                (split.axis,))
        return ce + aux, {"ce": ce, "aux": aux}

    # ------------------------------------------------------------ inference

    def init_cache(self, batch_size: int, max_len: int,
                   dtype=torch.bfloat16, *, device=None,
                   enc_len: Optional[int] = None) -> dict:
        """Layer-stacked KV cache with scalar-form ``len`` [L]; for the SSM
        family the layer-stacked conv window and state, f32 whatever
        ``dtype`` is (``max_len`` does not size them); for the moe family
        {"dense0", "blocks"}, each a stack of MLA latent caches over its
        layers; for the hybrid family a stack over its groups of {"ssm":
        the group's SSM caches, "attn": one KV cache}; for the vision
        family a stack over its groups of {"self": the group's KV caches,
        "cross": {"ck", "cv"} over ``vision_seq`` rows}; for the
        encoder-decoder family a stack over its decoder layers of {"self":
        KV cache, "ck", "cv"} over ``enc_len`` rows (default ``max_len //
        encoder_downsample``).  MLA and the vision and encoder-decoder
        families refuse a quantized ``dtype``, as the reference does.  On
        meta each ``len`` leaf carries its value 0 (``layers.host_int``), so
        that a prefill into it reads its start without a value."""
        cache = self._init_cache(batch_size, max_len, dtype,
                                 device=device or self.device,
                                 enc_len=enc_len)
        for path, leaf in flatten(cache).items():
            if leaf.is_meta and path.rpartition("/")[2] == "len":
                (leaf if leaf._base is None else leaf._base).known_value = 0
        return cache

    def _init_cache(self, batch_size, max_len, dtype, *, device,
                    enc_len) -> dict:
        cfg = self.cfg
        dev = device

        def stack(one, *lead):
            return {key: leaf.expand(lead + leaf.shape).contiguous()
                    for key, leaf in one.items()}

        if quant.is_quant_dtype(dtype) and (cfg.use_mla
                                            or cfg.family in MODAL_INPUTS):
            name = str(torch_dtype(dtype)).split(".")[-1]
            raise ValueError(
                f"quantized KV cache ({name}) requires every attention cache "
                f"to be a standard attn_apply KV cache; family "
                f"{cfg.family!r}{' (MLA)' if cfg.use_mla else ''} keeps "
                f"latent/cross caches with their own access paths")
        if cfg.family in MODAL_INPUTS:
            ac = tfm.attn_cfg(cfg)
            kv = attn_mod.init_kv_cache(ac, batch_size, max_len,
                                        torch_dtype(dtype), device=dev)
            if cfg.family == "vlm":
                lead, rows = (cfg.cross_attn_groups,), cfg.vision_seq
                self_kv = stack(kv, *lead, cfg.self_per_group)
            else:
                lead = (cfg.n_layers,)
                rows = enc_len or max_len // cfg.encoder_downsample
                self_kv = stack(kv, *lead)
            cross = {key: torch.zeros(
                lead + (batch_size, rows, ac.n_kv_heads, ac.head_dim),
                dtype=torch_dtype(dtype), device=dev) for key in ("ck", "cv")}
            if cfg.family == "vlm":
                return {"self": self_kv, "cross": cross}
            return {"self": self_kv, **cross}
        if cfg.family in ("ssm", "hybrid"):
            one = ssm.init_ssm_cache(tfm.ssm_cfg(cfg), batch_size,
                                     device=dev)
        elif cfg.use_mla:
            one = mla.init_mla_cache(tfm.mla_cfg(cfg), batch_size, max_len,
                                     torch_dtype(dtype), device=dev)
        else:
            one = attn_mod.init_kv_cache(tfm.attn_cfg(cfg), batch_size,
                                         max_len, torch_dtype(dtype),
                                         device=dev)
        if cfg.family == "hybrid":
            g = cfg.n_layers // cfg.attn_every
            kv = attn_mod.init_kv_cache(tfm.attn_cfg(cfg), batch_size,
                                        max_len, torch_dtype(dtype),
                                        device=dev)
            return {"ssm": stack(one, g, cfg.attn_every), "attn": stack(kv, g)}
        if cfg.family != "moe":
            return stack(one, cfg.n_layers)
        out = {"blocks": stack(one, cfg.n_layers - cfg.first_dense_layers)}
        if cfg.first_dense_layers:
            out["dense0"] = stack(one, cfg.first_dense_layers)
        return out

    def prefill(self, params, batch, max_len: int,
                cache_dtype=torch.bfloat16):
        """Run the prompt; returns (last-token logits [B,V] f32, cache).
        The encoder-decoder family needs ``batch["frames"]``, which size
        its cross cache; the vision family takes ``batch["patches"]`` (it
        attends over an all-zero cross cache without them, as the
        reference does)."""
        cfg = self.cfg
        tokens = self._tokens(batch["tokens"])
        enc_len = None
        if cfg.family == "encdec":
            if batch.get("frames") is None:
                raise ValueError(f"{cfg.name}: an encoder-decoder prefill "
                                 f"needs batch['frames']")
            enc_len = batch["frames"].shape[1]
        cache = self.init_cache(tokens.shape[0], max_len, cache_dtype,
                                enc_len=enc_len)
        x = layers.embed(params["embed"], tokens).to(cfg.dtype)
        x, cache, _ = self._backbone(params, x, cache, batch=batch)
        x = layers.rmsnorm(params["ln_f"], x[:, -1:], cfg.norm_eps)
        return self._logits(params, x)[:, 0].float(), cache

    def decode_step(self, params, tokens, cache):
        """tokens: [B,1] -> (logits [B,V] f32, cache advanced in place)."""
        cfg = self.cfg
        x = layers.embed(params["embed"], self._tokens(tokens)).to(cfg.dtype)
        x, cache, _ = self._backbone(params, x, cache)
        x = layers.rmsnorm(params["ln_f"], x, cfg.norm_eps)
        return self._logits(params, x)[:, 0].float(), cache

    def verify_step(self, params, tokens, cache):
        """tokens: [B, S] -> (logits [B, S, V] f32, cache advanced by S
        per row, in place).

        The multi-token sibling of :meth:`decode_step` for speculative
        verification, against a per-row (serve-form) cache: position j is
        computed as a decode tick at row length ``len + j`` computes it —
        its row-wise products at the tick's shape, its attention one
        single-query call with ``kv_len = len + j + 1`` (see
        ``attention._verify``) — so its logits equal, bit for bit, those
        of the tick that consumes ``tokens[:, :j + 1]``.  The caller rolls
        back to the accepted lengths with :meth:`override_cache_lengths`.
        """
        if not self.supports_speculation:
            raise ValueError(
                f"{self.cfg.name}: family={self.cfg.family}"
                f"{' (MLA)' if self.cfg.use_mla else ''} cannot verify "
                "speculatively — rollback requires every cache leaf to be "
                "a length-masked KV cache (dense, non-MLA)")
        cfg = self.cfg
        x = layers.embed(params["embed"], self._tokens(tokens)).to(cfg.dtype)
        x, cache, _ = self._backbone(params, x, cache)
        logits = layers.per_position(
            lambda t: self._logits(
                params, layers.rmsnorm(params["ln_f"], t, cfg.norm_eps)), x)
        return logits.float(), cache

    @property
    def supports_speculation(self) -> bool:
        """Whether this model can act as speculative target or drafter:
        rollback after partial acceptance is a pure length truncation, so
        every growing cache leaf must be a length-masked KV cache (dense,
        non-MLA).  An SSM state advances irreversibly, and MoE's
        batch-coupled expert capacity would let one slot's rejected drafts
        perturb other slots' routing during the verify."""
        return self.cfg.family == "dense" and not self.cfg.use_mla

    # ------------------------------------------- continuous-serving hooks

    @property
    def pad_safe_prefill(self) -> bool:
        """Right-padded prompts batch safely: every cross-position op of
        the dense family is causal attention.  The SSM family carries its
        state straight through pads, and the MoE router lets pads compete
        with real tokens for expert capacity, so the engine prefills both
        at the exact prompt length."""
        return self.cfg.family == "dense"

    def prefill_padded(self, params, batch, max_len: int,
                       cache_dtype=torch.bfloat16):
        """Pad-masked prefill of right-padded mixed-length prompts.

        ``batch["tokens"]`` [B, W] right-padded, ``batch["lengths"]`` [B]
        true lengths (1 <= L <= W).  Returns (logits at each row's last
        real token [B, V], cache whose ``len`` entries are per-row [B]
        vectors set to the true lengths): the pad positions' K/V stay
        masked behind ``kv_len`` until overwritten.

        The vision and encoder-decoder families refuse: the reference's
        pad-masked prefill passes only the tokens and lengths, so it
        raises a ``KeyError`` for the frames and drops the patches
        (ROADMAP R8), and the port does not copy that.
        """
        cfg = self.cfg
        if cfg.family in MODAL_INPUTS:
            raise ValueError(
                f"{cfg.name}: a pad-masked prefill (generate(lengths=...)) "
                f"cannot carry the {MODAL_INPUTS[cfg.family]} the "
                f"{cfg.family} family needs; the reference drops them "
                f"(ROADMAP R8).  Prefill at one width, without lengths")
        tokens = self._tokens(batch["tokens"])
        lengths = torch.as_tensor(np.asarray(batch["lengths"]),
                                  dtype=torch.long, device=self.device)
        b = tokens.shape[0]
        cache = self.init_cache(b, max_len, cache_dtype)
        x = layers.embed(params["embed"], tokens).to(cfg.dtype)
        x, cache, _ = self._backbone(params, x, cache)
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

    @staticmethod
    def override_cache_lengths(cache, lengths) -> dict:
        """Rewrite the per-row ``len`` entries of a serve-form cache in
        place to ``lengths`` [B]; returns ``cache``.

        The speculative rollback: a verify advanced every row by the whole
        draft span, and truncating ``len`` to the accepted length masks
        the rejected positions (their K/V stay behind ``kv_len`` until
        overwritten).  Unlike :meth:`set_cache_lengths`, which adds the
        row axis to scalar-form leaves, this expects ``[*stack, B]``
        leaves and broadcasts over the stack dims only."""
        if not isinstance(lengths, torch.Tensor):
            lengths = torch.from_numpy(np.asarray(lengths, np.int32))

        def walk(node):
            for key, leaf in node.items():
                if isinstance(leaf, dict):
                    walk(leaf)
                elif key == "len":
                    leaf.copy_(lengths.to(device=leaf.device,
                                          dtype=torch.int32).expand(
                                              leaf.shape))

        walk(cache)
        return cache

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
                f"family {self.cfg.family!r}"
                f"{' (MLA)' if self.cfg.use_mla else ''} has no paged "
                f"decode path — see Model.supports_paged_kv")
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
        x, cache, _ = self._backbone(params, x, cache)
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
