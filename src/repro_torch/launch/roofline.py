"""Roofline terms of one step of the port, counted on the H100's terms.

compute term    = sum over dtypes of FLOPs / (peak FLOP/s of that dtype)
memory term     = bytes / HBM bandwidth
collective term = collective bytes / link bandwidth

Port of ``repro.launch.roofline``.  The reference parses XLA's optimized
HLO (``parse_hlo``, ``Instr``); torch has no HLO, so they are not ported:
:func:`count_step` runs the step under a ``TorchDispatchMode`` and counts
what it dispatches, into a :class:`StepCount` (the fields of the
reference's ``HloStats``):

* FLOPs — every product (``aten.mm``, ``addmm``, ``bmm``, ``baddbmm``,
  ``mv``, ``dot``; einsum and matmul reach them): 2 x its result's
  elements x the contracted length, kept by the dtype of its operands;
  plus the operations each kernel entry reports (``kernels/work.py``), by
  the dtype they run in.  The aten ops inside a reported call (a plain
  version on the CPU, a meta output's allocation) are not counted: the
  call's report stands for them.
* HBM bytes — ``hbm_bytes``, the every-op bound: each op's tensor
  operands and results (views and allocations move nothing), each
  kernel's reported bytes.  ``ideal_bytes``: each product's operands and
  result once, each kernel's reported bytes, the collectives' wire bytes
  (in and out of HBM, as the reference counts them) and the step's
  arguments and outputs once.
* collective bytes — each ``c10d`` op's result bytes, twice for an
  all-reduce (a ring's reduce-scatter and all-gather), by kind.  Shapes
  are a rank's, so these are one rank's wire bytes.

A count on meta tensors is exact: it is reckoned from shapes and holds no
time.  On the card or the CPU the same step counts the same, except where
the work depends on the data (``kernels/work.py``).  The count also keeps
the peak of the tensor bytes alive at once (every storage an op made or
the step was handed, until its last tensor goes).

Hardware constants: the H100's table (``core/topology.py``, the NVIDIA
H100 SXM data sheet's dense rates): 989 TFLOP/s in bf16 (and f16) on the
tensor cores, 67 TFLOP/s in f32 outside them, 1,979 TOP/s in int8 and
fp8; 3.35 TB/s of HBM3; NVLink, 900 GB/s a card.  The collective term
prices every mesh axis at NVLink's rate: for an axis that crosses nodes
(their network is slower) it is a floor.
"""

from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict
from typing import Optional

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.topology import (H100_HBM_BW, H100_LINK_BW,
                                      H100_PEAK_FLOPS)
from repro_torch.kernels import work

PEAK_FLOPS = H100_PEAK_FLOPS
HBM_BW = H100_HBM_BW
LINK_BW = H100_LINK_BW

_aten = torch.ops.aten
# product -> the index of its left operand (K is its last dim)
_PRODUCTS = {_aten.mm.default: 0, _aten.bmm.default: 0,
             _aten.addmm.default: 1, _aten.baddbmm.default: 1,
             _aten.mv.default: 0, _aten.addmv.default: 1,
             _aten.dot.default: 0}
# ops that make or name a tensor and move no bytes
_NO_BYTES = {_aten.empty.memory_format, _aten.empty_strided.default,
             _aten.new_empty.default, _aten.new_empty_strided.default,
             _aten.empty_like.default, _aten.detach.default,
             _aten.lift_fresh.default, _aten._local_scalar_dense.default}
_COLLECTIVES = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "all_to_all_single": "all-to-all", "broadcast_": "broadcast",
}


def _tensors(tree) -> list:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


@dataclasses.dataclass
class StepCount:
    flops: float = 0.0
    hbm_bytes: float = 0.0        # every-op traffic (the pessimistic bound)
    ideal_bytes: float = 0.0      # products, kernels, collectives, args, outs
    coll_bytes_by_kind: dict = dataclasses.field(default_factory=dict)
    coll_count_by_kind: dict = dataclasses.field(default_factory=dict)
    ideal_collective_bytes: float = 0.0
    top_collectives: list = dataclasses.field(default_factory=list)
    top_dots: list = dataclasses.field(default_factory=list)
    flops_by_dtype: dict = dataclasses.field(default_factory=dict)
    # kernel entry -> {"calls", "ops", "bytes", "dtype"}
    kernels: dict = dataclasses.field(default_factory=dict)
    argument_bytes: float = 0.0
    output_bytes: float = 0.0
    peak_live_bytes: float = 0.0

    @property
    def collective_bytes(self) -> float:
        return float(sum(self.coll_bytes_by_kind.values()))


class _Counting(TorchDispatchMode):
    """The dispatch mode of :func:`count_step`; also the active count the
    kernel entries report to (``kernels/work.py``)."""

    def __init__(self, meta_kv_len):
        super().__init__()
        self.stats = StepCount()
        self.depth = 0                  # open reported calls
        self.meta_kv_len = meta_kv_len
        self.dots = defaultdict(lambda: [0.0, 0])
        self.colls = defaultdict(lambda: [0.0, 0])
        self.live = {}                  # storage -> [bytes, tensors]
        self.live_bytes = 0

    # ----------------------------------------------------- live tensors

    def track(self, tensors) -> None:
        for t in tensors:
            storage = t.untyped_storage()
            key = storage._cdata
            entry = self.live.get(key)
            if entry is None:
                entry = self.live[key] = [storage.nbytes(), 0]
                self.live_bytes += entry[0]
                self.stats.peak_live_bytes = max(self.stats.peak_live_bytes,
                                                 self.live_bytes)
            entry[1] += 1
            weakref.finalize(t, self._drop, key)

    def _drop(self, key) -> None:
        entry = self.live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live_bytes -= entry[0]
            del self.live[key]

    # ----------------------------------------------------------- counts

    def kernel(self, name: str, w: work.Work) -> None:
        st = self.stats
        st.flops += w.ops
        st.flops_by_dtype[w.dtype] = st.flops_by_dtype.get(w.dtype, 0) + w.ops
        st.hbm_bytes += w.nbytes
        st.ideal_bytes += w.nbytes
        k = st.kernels.setdefault(name, {"calls": 0, "ops": 0.0, "bytes": 0.0,
                                         "dtype": w.dtype})
        k["calls"] += 1
        k["ops"] += w.ops
        k["bytes"] += w.nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.track(_tensors(out))
        if self.depth == 0:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        st = self.stats
        ns, _, name = func._schema.name.partition("::")
        if ns in ("c10d", "_c10d_functional") and name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            result = args[0] if ns == "c10d" else out
            wire = _nbytes(result) * (2 if kind == "all-reduce" else 1)
            st.coll_bytes_by_kind[kind] = st.coll_bytes_by_kind.get(
                kind, 0.0) + wire
            st.coll_count_by_kind[kind] = st.coll_count_by_kind.get(
                kind, 0) + 1
            st.ideal_collective_bytes += wire
            st.ideal_bytes += wire
            shapes = [list(t.shape) for t in _tensors(result)]
            c = self.colls[(kind, str(shapes))]
            c[0] += wire
            c[1] += 1
        if func in _PRODUCTS:
            lhs = args[_PRODUCTS[func]]
            f = 2.0 * _tensors(out)[0].numel() * lhs.shape[-1]
            dt = work.dtype_name(lhs.dtype)
            st.flops += f
            st.flops_by_dtype[dt] = st.flops_by_dtype.get(dt, 0) + f
            operands = [a for a in args if isinstance(a, torch.Tensor)]
            st.ideal_bytes += _nbytes(operands) + _nbytes(out)
            d = self.dots[f"{func._schema.name} {dt} " + " x ".join(
                str(list(a.shape)) for a in operands)]
            d[0] += f
            d[1] += 1
        if not func.is_view and func not in _NO_BYTES:
            st.hbm_bytes += _nbytes((args, kwargs)) + _nbytes(out)

    def finish(self) -> StepCount:
        st = self.stats
        st.top_dots = [(f, f"{desc} (x{n})") for desc, (f, n) in sorted(
            self.dots.items(), key=lambda kv: -kv[1][0])[:8]]
        st.top_collectives = [(kind, b, f"{shapes} (x{n})")
                              for (kind, shapes), (b, n) in sorted(
                                  self.colls.items(),
                                  key=lambda kv: -kv[1][0])[:8]]
        return st


def count_step(fn, *args, meta_kv_len: Optional[list] = None,
               **kwargs) -> StepCount:
    """Run ``fn(*args, **kwargs)`` once and count its products, kernels,
    bytes and collectives (module docstring).  ``meta_kv_len``: the rows'
    lengths a meta ``kv_len`` stands for (default: the cache's full
    length).  Nothing else is changed: on the card the kernels launch, on
    the CPU the plain versions run, on meta nothing runs."""
    mode = _Counting(meta_kv_len)
    inputs = _tensors((args, kwargs))
    mode.stats.argument_bytes = _nbytes(list({id(t): t
                                              for t in inputs}.values()))
    mode.track(inputs)
    with work.reporting_to(mode), mode:
        out = fn(*args, **kwargs)
    st = mode.finish()
    st.output_bytes = _nbytes(out)
    st.ideal_bytes += st.argument_bytes + st.output_bytes
    del out
    return st


@dataclasses.dataclass
class Roofline:
    flops: float               # per-rank FLOPs (counted)
    hbm_bytes: float           # per-rank ideal bytes
    collective_bytes: float    # per-rank wire bytes
    chips: int
    model_flops: float         # analytic (global)
    hbm_bytes_pessimistic: float = 0.0   # every-op bound
    flops_by_dtype: Optional[dict] = None   # None: all at the bf16 rate

    @property
    def t_compute(self) -> float:
        if not self.flops_by_dtype:
            return self.flops / PEAK_FLOPS["bf16"]
        return sum(f / PEAK_FLOPS[dt] for dt, f in self.flops_by_dtype.items())

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        t_useful = (self.model_flops / self.chips) / PEAK_FLOPS["bf16"]
        t = max(self.t_compute, self.t_memory, self.t_collective)
        return t_useful / t if t else 0.0

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "hbm_bytes_pessimistic": self.hbm_bytes_pessimistic,
            "collective_bytes_per_device": self.collective_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def roofline_of(count: StepCount, chips: int,
                model_flops: float) -> Roofline:
    """The :class:`Roofline` of a rank's :class:`StepCount`."""
    return Roofline(flops=count.flops, hbm_bytes=count.ideal_bytes,
                    collective_bytes=count.ideal_collective_bytes,
                    chips=chips, model_flops=model_flops,
                    hbm_bytes_pessimistic=count.hbm_bytes,
                    flops_by_dtype=dict(count.flops_by_dtype))


def _attn_layer_count(cfg) -> tuple[int, float]:
    """(# self-attention layers, effective head_dim) for score/value mms."""
    if cfg.family == "ssm":
        return 0, 0.0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every, float(cfg.resolved_head_dim)
    if cfg.use_mla:
        return cfg.n_layers, (cfg.qk_nope_dim + cfg.qk_rope_dim
                              + cfg.v_head_dim) / 2.0
    if cfg.family == "vlm":
        return cfg.n_layers - cfg.cross_attn_groups, float(
            cfg.resolved_head_dim)
    if cfg.family == "encdec":
        return cfg.n_layers, float(cfg.resolved_head_dim)  # decoder self
    return cfg.n_layers, float(cfg.resolved_head_dim)


def attention_flops(cfg, batch: int, seq: int, *, causal=True) -> float:
    """Score+value matmul FLOPs for one forward pass (standard MFU
    accounting — at 32k context these dominate the 2ND term)."""
    layers, hd = _attn_layer_count(cfg)
    if not layers:
        return 0.0
    f = 2.0 * 2.0 * batch * seq * seq * cfg.n_heads * hd * layers
    return f / 2.0 if causal else f


def model_flops_for(cfg, shape) -> float:
    """MFU-style useful FLOPs: 6*N*D (train) / 2*N*D (inference) with
    N = active params, plus attention score/value FLOPs.

    enc-dec: the encoder stack sees seq/downsample tokens, so its params are
    weighted accordingly (otherwise useful_flops_ratio > 1)."""
    n = cfg.active_param_count()
    if cfg.family == "encdec":
        # split params into encoder vs decoder+embed shares
        d_model, ff = cfg.d_model, cfg.d_ff
        hd = cfg.resolved_head_dim
        attn = (d_model * cfg.n_heads * hd + 2 * d_model * cfg.n_kv_heads * hd
                + cfg.n_heads * hd * d_model)
        enc = cfg.n_encoder_layers * (attn + 3 * d_model * ff)
        n_eff = (n - enc) + enc / cfg.encoder_downsample
    else:
        n_eff = n
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_eff * b * s + 3.0 * attention_flops(cfg, b, s)
    if shape.kind == "prefill":
        return 2.0 * n_eff * b * s + attention_flops(cfg, b, s)
    # decode: one token per sequence; attention reads the full cache
    layers, hd = _attn_layer_count(cfg)
    dec_attn = 2.0 * 2.0 * b * s * cfg.n_heads * hd * layers
    return 2.0 * n_eff * b + dec_attn
