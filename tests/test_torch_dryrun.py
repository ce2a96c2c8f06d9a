"""The port's dry run and roofline (``repro_torch.launch.dryrun``,
``roofline``, ``report``, ``hillclimb``, ``rederive``,
``configs/inputs.py`` ``input_specs``, ``kernels/work.py``) on the CPU,
against the JAX package where it has a counterpart.

* ``input_specs`` shapes and dtypes equal the reference's for every arch
  and applicable shape; ``model_flops_for`` and ``attention_flops`` equal
  the reference's exactly, and ``Roofline``'s FLOPs, bytes and ratio
  fields too, each time being the count over the port's H100 rate.
* ``count_step`` counts the reference's scanned-dot case
  (``tests/test_system.py::test_roofline_parser_counts_scanned_dots``) at
  exactly 3 k 2 8 m^2.
* A reduced qwen, deepseek and mamba2 prefill, decode tick and train step
  count the same FLOPs and ideal bytes on the CPU (the kernels' plain
  versions) and on meta (a tick's meta rows at the CPU rows' lengths),
  with every kernel call reported once.
* ``kernels/work.py`` gives ``PERF.md`` §6's bounds.
* ``static_bytes_per_device``'s parameter and optimizer-state bytes equal
  the reference's ``_local_bytes`` on a (2, 2) mesh of Auto axes, under
  "tp" and "fsdp" (the reference in a subprocess with 4 host devices).
* End to end in a fake world of 4 at (2, 2): reduced train, prefill and
  decode records are ``ok``; ``sp_moeshard`` records the port's refusal;
  ``report`` renders both tables; ``rederive`` changes nothing the second
  time; the full-width CLI cell of qwen2.5-3b x train_4k at 16 x 16.
* The full-width deepseek train_4k cells at 16 x 16 whose one claim group
  spans the ranks (lite and 236b, lite's "fsdp" variant) count through
  the FAA ticket, K14's operations a rank those of the expert rows it
  owns (under "tp" the moegrp16 variant's), the all-to-all bytes a
  rank's rows; moegrp16's rank-local groups run on their ranks with no
  exchange.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.configs.inputs import input_specs as ref_input_specs
from repro.launch import roofline as ref_roofline
from repro_torch.configs import REGISTRY, SHAPES, applicable_shapes, get_config
from repro_torch.configs.inputs import input_specs, make_dummy_batch
from repro_torch.distributed import params as psh
from repro_torch.kernels import work
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.launch import dryrun, hillclimb, rederive, report, roofline
from repro_torch.models import Model
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.train_step import (make_decode_step, make_prefill_step,
                                          make_train_step)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CELLS = [(arch, shape) for arch in REGISTRY
         for shape in applicable_shapes(get_config(arch))]
COUNT_ARCHS = ("qwen2.5-3b", "deepseek-v2-lite-16b", "mamba2-780m")
STATIC_ARCHS = ("qwen2.5-3b", "deepseek-v2-lite-16b")
LAYOUTS = ("tp", "fsdp")
JAX_DTYPES = {"int32": torch.int32, "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_reference(arch, shape):
    ref = ref_input_specs(ref_config(arch), REF_SHAPES[shape])
    got = input_specs(get_config(arch), SHAPES[shape])
    assert sorted(got) == sorted(ref)
    for key, spec in ref.items():
        assert got[key].is_meta
        assert tuple(got[key].shape) == tuple(spec.shape), key
        assert got[key].dtype == JAX_DTYPES[str(spec.dtype)], key


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_match_reference(arch, shape):
    cfg, ref_cfg = get_config(arch), ref_config(arch)
    sh, ref_sh = SHAPES[shape], REF_SHAPES[shape]
    assert roofline.model_flops_for(cfg, sh) == \
        ref_roofline.model_flops_for(ref_cfg, ref_sh)
    assert roofline.attention_flops(cfg, sh.global_batch, sh.seq_len) == \
        ref_roofline.attention_flops(ref_cfg, ref_sh.global_batch,
                                     ref_sh.seq_len)
    assert roofline._attn_layer_count(cfg) == \
        ref_roofline._attn_layer_count(ref_cfg)


@pytest.mark.parametrize("by_dtype", [None, {"bf16": 3.0e14, "f32": 2.0e12}])
def test_roofline_fields_match_reference(by_dtype):
    kw = dict(flops=3.02e14, hbm_bytes=7.5e11, collective_bytes=4.0e10,
              chips=256, model_flops=5.0e16, hbm_bytes_pessimistic=2.0e12)
    got = roofline.Roofline(**kw, flops_by_dtype=by_dtype).to_dict()
    want = ref_roofline.Roofline(**kw).to_dict()
    assert list(got) == list(want)
    for key in ("flops_per_device", "hbm_bytes_per_device",
                "hbm_bytes_pessimistic", "collective_bytes_per_device",
                "model_flops", "useful_flops_ratio"):
        assert got[key] == want[key], key
    t_compute = (kw["flops"] / 989e12 if by_dtype is None else
                 by_dtype["bf16"] / 989e12 + by_dtype["f32"] / 67e12)
    assert got["t_compute_s"] == t_compute
    assert got["t_memory_s"] == kw["hbm_bytes"] / 3.35e12
    assert got["t_collective_s"] == kw["collective_bytes"] / 900e9
    terms = {"compute": got["t_compute_s"], "memory": got["t_memory_s"],
             "collective": got["t_collective_s"]}
    assert got["bottleneck"] == max(terms, key=terms.get)
    assert got["roofline_fraction"] == pytest.approx(
        kw["model_flops"] / kw["chips"] / 989e12 / max(terms.values()))


def test_count_step_counts_scanned_dots():
    """The reference's case: a k-layer product loop and its gradient count
    3 products a layer, exactly."""
    k, m = 5, 32

    def f(x, ws):
        c = x
        for w in ws.unbind(0):
            c = torch.tanh(c @ w)
        return torch.autograd.grad(c.sum(), (x, ws))

    x = torch.ones(8, m, requires_grad=True)
    ws = torch.ones(k, m, m, requires_grad=True)
    stats = roofline.count_step(f, x, ws)
    assert stats.flops == 3 * k * 2 * 8 * m * m
    assert stats.flops_by_dtype == {"f32": stats.flops}
    assert stats.top_dots and not stats.kernels


def _meta(tree):
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    return torch.empty_like(tree, device="meta")


def _step_args(arch, dev, kind):
    """(step, args, meta_kv_len) of a reduced f32 model's ``kind`` step on
    ``dev``, its inputs from numpy seeds (meta copies on meta)."""
    cfg = get_config(arch).reduced()
    model = Model(cfg, device=dev)
    params = model.init(0)
    batch = make_dummy_batch(cfg, 2, 16, device="cpu")
    if dev == "meta":
        batch = _meta(batch)
    if kind == "prefill":
        return make_prefill_step(model, 32), (params, batch), None
    if kind == "decode":
        cache = model.init_cache(2, 32, torch.float32, device=dev)
        lens = torch.tensor([5, 9], dtype=torch.int32)
        cache = Model.set_cache_lengths(cache, lens.to(dev))
        return (make_decode_step(model), (params, batch["tokens"][:, :1],
                                          cache), [6, 10])
    ocfg = opt_mod.AdamWConfig()
    return (make_train_step(model, ocfg),
            (params, opt_mod.init_state(params, ocfg), batch), None)


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", COUNT_ARCHS)
def test_counts_equal_on_cpu_and_meta(arch, kind):
    step, args, _ = _step_args(arch, "cpu", kind)
    cpu = roofline.count_step(step, *args)
    step, args, kv = _step_args(arch, "meta", kind)
    meta = roofline.count_step(step, *args, meta_kv_len=kv)
    assert cpu.flops == meta.flops > 0
    assert cpu.ideal_bytes == meta.ideal_bytes > 0
    assert cpu.flops_by_dtype == meta.flops_by_dtype
    assert cpu.kernels == meta.kernels
    cfg = get_config(arch).reduced()
    n_attn = 0 if cfg.family == "ssm" else cfg.n_layers
    calls = {n: k["calls"] for n, k in cpu.kernels.items()}
    if kind == "prefill":
        assert calls.get("flash_attention", 0) == n_attn
        assert calls.get("ssd", 0) == (cfg.n_layers if not n_attn else 0)
    elif kind == "decode":
        assert calls.get("decode_attention", 0) == n_attn
    else:   # full remat: the forward twice, the backward once a layer
        assert calls.get("flash_attention", 0) == 2 * n_attn
        assert calls.get("flash_attention_bwd", 0) == n_attn
        assert calls.get("ssd_bwd", 0) == (cfg.n_layers if not n_attn
                                           else 0)


def test_counts_read_the_rows_lengths():
    """A decode call's work follows its rows' lengths: on the CPU their
    values, on meta ``meta_kv_len`` or else the cache's full length."""
    q, k = torch.zeros(2, 4, 16), torch.zeros(2, 32, 2, 16)
    kv = torch.tensor([6, 40], dtype=torch.int32)
    cpu = work.decode(q, k, k, kv)
    assert cpu.ops == 2 * 4 * 32 * (6 + 32)
    mq, mk, mkv = _meta(q), _meta(k), kv.to("meta")
    full = roofline.count_step(da.decode_attention, mq, mk, mk, mkv)
    assert full.kernels["decode_attention"]["ops"] == 2 * 4 * 32 * 64
    given = roofline.count_step(da.decode_attention, mq, mk, mk, mkv,
                                meta_kv_len=[6, 40])
    assert given.kernels["decode_attention"]["ops"] == cpu.ops


def _bound_ms(ops, nbytes, dtype="bf16"):
    return max(ops / roofline.PEAK_FLOPS[dtype],
               nbytes / roofline.HBM_BW) * 1e3


def _meta_t(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _tick_lens(s=1024):
    """chip_smoke's tick: phase 5's 16 prompt lengths (seed 0), the first
    8 of them + 16."""
    lens = np.random.RandomState(0).randint(16, 513, 16)
    return torch.tensor(np.minimum(lens[:8] + 16, s), dtype=torch.int32)


def _ssd_ins(b, s, h, p, g, n):
    f32 = torch.float32
    return (_meta_t(b, s, h, p), _meta_t(b, s, h, dtype=f32),
            _meta_t(h, dtype=f32), _meta_t(b, s, g, n), _meta_t(b, s, g, n))


BOUNDS = {   # PERF.md §6's bound ms, as printed there
    "K1": (lambda: work.prefill_work(512, 16, 2, 128, False), "0.00142"),
    "K2": (lambda: work.decode_work(_tick_lens(), 16, 2, 128, False, False),
           "0.00060"),
    "K11": (lambda: work.flash_bwd_work(2, 1024, 1024, 16, 2, 128, 128),
            "0.02173"),
    "K12": (lambda: work.ssd(*_ssd_ins(1, 512, 48, 64, 1, 128))[:2],
            "0.002455"),
    "K14": (lambda: work.gmm_work(64, 8, 2048, 1408), "0.1112"),
    "K16": (lambda: work.ssd_bwd(*_ssd_ins(2, 1024, 48, 64, 1, 128),
                                 _meta_t(2, 1024, 48, 64))[:2], "0.01213"),
    "K17": (lambda: work.gmm_bwd_work(64, 240, 2048, 1408), "0.2708"),
    "K2@G128": (lambda: work.decode(_meta_t(8, 128, 576),
                                    _meta_t(8, 1024, 1, 576),
                                    _meta_t(8, 1024, 1, 512),
                                    _tick_lens())[:2], "0.001907"),
}


@pytest.mark.parametrize("kernel", list(BOUNDS))
def test_work_gives_perf_bounds(kernel):
    fn, printed = BOUNDS[kernel]
    digits = len(printed.split(".")[1])
    assert f"{round(_bound_ms(*fn()), digits):.{digits}f}" == printed


REFERENCE_STATIC = textwrap.dedent("""
    import json, sys
    import jax
    from jax.sharding import AxisType
    assert len(jax.devices()) == 4
    from repro.configs import get_config
    from repro.distributed import params as psh
    from repro.launch.dryrun import _local_bytes
    from repro.models import Model
    from repro.train import optimizer as opt_mod

    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    out = {}
    for arch in sys.argv[1].split(","):
        cfg = get_config(arch).with_dtype("bfloat16").reduced()
        params = jax.eval_shape(Model(cfg).init, jax.random.PRNGKey(0))
        state = jax.eval_shape(
            lambda p: opt_mod.init_state(p, opt_mod.AdamWConfig()), params)
        for layout in ("tp", "fsdp"):
            p_sh = psh.param_shardings(params, mesh, layout=layout)
            o_sh = psh.tree_shardings(state, mesh, psh.RULESETS[layout])
            out[f"{arch}/{layout}"] = [_local_bytes(params, p_sh),
                                       _local_bytes(state, o_sh)]
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_static():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    got = subprocess.run([sys.executable, "-c", REFERENCE_STATIC,
                          ",".join(STATIC_ARCHS)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert got.returncode == 0, got.stderr[-3000:]
    return json.loads(got.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", STATIC_ARCHS)
def test_static_bytes_match_reference(reference_static, arch, layout):
    mesh = {"data": 2, "model": 2}
    cfg = get_config(arch).with_dtype("bfloat16").reduced()
    params = Model(cfg, device="meta").init(0)
    state = opt_mod.init_state(params, opt_mod.AdamWConfig())
    p_lays = psh.param_shardings(params, mesh, layout=layout)
    o_lays = psh.tree_shardings(state, mesh, psh.RULESETS[layout])
    assert [dryrun._local_bytes(params, p_lays),
            dryrun._local_bytes(state, o_lays)] == \
        reference_static[f"{arch}/{layout}"]


@pytest.fixture(scope="module")
def fake_records(tmp_path_factory):
    """Reduced cells and a refused variant in a fake world of 4 at (2, 2),
    written where ``report`` and ``rederive`` read them."""
    root = tmp_path_factory.mktemp("dryrun_torch")
    recs = {}
    with dryrun.fake_world(4):
        for arch, shape in (("qwen2.5-3b", "train_4k"),
                            ("qwen2.5-3b", "prefill_32k"),
                            ("deepseek-v2-lite-16b", "decode_32k"),
                            ("qwen2.5-3b", "decode_32k")):
            recs[arch, shape, ""] = dryrun.run_cell(
                arch, shape, False, reduced=True, mesh_shape=(2, 2),
                verbose=False)
        recs["qwen2.5-3b", "decode_32k", "kvseq"] = hillclimb.run_variant(
            "qwen2.5-3b", "decode_32k", "kvseq", reduced=True,
            mesh_shape=(2, 2))
        recs["qwen2.5-3b", "train_4k", "fsdp"] = hillclimb.run_variant(
            "qwen2.5-3b", "train_4k", "fsdp", reduced=True,
            mesh_shape=(2, 2))
    recs["deepseek-v2-lite-16b", "train_4k", "sp_moeshard"] = \
        hillclimb.run_variant("deepseek-v2-lite-16b", "train_4k",
                              "sp_moeshard", reduced=True, mesh_shape=(2, 2))
    for (arch, shape, tag), rec in recs.items():
        (root / f"{arch}__{shape}__2x2{'__' + tag if tag else ''}.json"
         ).write_text(json.dumps(rec, indent=1, default=float))
    return root, recs


def test_fake_world_records(fake_records):
    _, recs = fake_records
    for key, rec in recs.items():
        if key[2] == "sp_moeshard":
            continue
        assert rec["ok"] and rec["mesh"] == "2x2" and rec["chips"] == 4, key
        rl = rec["roofline"]
        assert rl["flops_per_device"] > 0 and rl["hbm_bytes_per_device"] > 0
        assert rec["static_bytes_per_device"] > 0
        # the sharded step gathers the parameters over the world
        assert rec["collectives"]["count_by_kind"].get("all-gather", 0) > 0
    train = recs["qwen2.5-3b", "train_4k", ""]
    assert train["kernels"]["flash_attention_bwd"]["calls"] == 4
    kvseq = recs["qwen2.5-3b", "decode_32k", "kvseq"]["kernels"]
    assert {n: k["calls"] for n, k in kvseq.items()} == {
        "decode_attention_partials": 4, "decode_combine": 4}
    # under "tp" the ranks of a "model" pair compute the same rows on the
    # whole parameters: each rank's FLOPs are about twice "fsdp"'s
    fsdp = recs["qwen2.5-3b", "train_4k", "fsdp"]
    assert train["roofline"]["useful_flops_ratio"] < \
        0.6 * fsdp["roofline"]["useful_flops_ratio"]


def test_refused_variant_is_recorded(fake_records):
    _, recs = fake_records
    rec = recs["deepseek-v2-lite-16b", "train_4k", "sp_moeshard"]
    assert rec["ok"] is False and rec["tag"] == "sp_moeshard"
    assert rec["error"].startswith("NotImplementedError: moe_impl='sharded'")


def test_report_renders_both_tables(fake_records, capsys):
    root, _ = fake_records
    report.roofline_md(root)
    table = capsys.readouterr().out
    assert "| arch | shape | mesh |" in table and "count (s)" in table
    assert table.count("(reduced) |") == 4
    report.perf_md(root)
    perf = capsys.readouterr().out
    assert "| qwen2.5-3b (reduced)×train_4k×2x2 | fsdp |" in perf
    assert "sp_moeshard | FAILED NotImplementedError" in perf


def test_rederive_is_idempotent(fake_records, tmp_path):
    root, _ = fake_records
    for f in root.glob("*.json"):
        (tmp_path / f.name).write_text(f.read_text())
    assert rederive.main(tmp_path) == 6
    once = {f.name: f.read_text() for f in tmp_path.glob("*.json")}
    assert rederive.main(tmp_path) == 6
    assert once == {f.name: f.read_text() for f in tmp_path.glob("*.json")}
    for name, text in once.items():
        rec, orig = json.loads(text), json.loads((root / name).read_text())
        if rec["ok"]:
            assert rec["roofline"] == pytest.approx(orig["roofline"])


# the full-width MoE train cells at 16 x 16 whose claim groups span the
# ranks: (arch, variant, the token ranks, the claim groups): one group
# over every rank of the batch ("tp": 16 token ranks, "fsdp": 256), and
# the moegrp16 variant's 16, each on one rank (no ticket)
TICKET_CELLS = [("deepseek-v2-lite-16b", "", 16, 1),
                ("deepseek-v2-236b", "", 16, 1),
                ("deepseek-v2-lite-16b", "fsdp", 256, 1),
                ("deepseek-v2-lite-16b", "moegrp16", 16, 16)]


@pytest.mark.parametrize("arch,variant,ranks,groups", TICKET_CELLS)
def test_moe_train_cells_count_through_the_ticket(arch, variant, ranks,
                                                  groups):
    """deepseek-v2-lite-16b and -236b x train_4k at 16 x 16 and lite's
    "fsdp" variant count (``ok``): one claim group over the batch's
    1,048,576 tokens, its E x C buffer rows split over the token ranks.
    K14's operations a rank are the expert rows it owns (E C g / R)
    through three products, forward and recompute, on each MoE layer:
    under "tp" the moegrp16 variant's (E x its groups' capacity), 4.422e14
    for lite and 2.737e15 for 236b.  Each all-to-all counts a rank's rows
    at meta's even split (the record says so), its own share too; the
    moegrp16 variant, whose groups each lie on one rank, runs its groups
    on their ranks with no all-to-all."""
    from repro_torch.models import moe

    cfg = get_config(arch)
    with dryrun.fake_world(256):
        if variant:
            rec = hillclimb.run_variant(arch, "train_4k", variant)
        else:
            rec = dryrun.run_cell(arch, "train_4k", False, verbose=False)
    assert rec["ok"] and rec["chips"] == 256, rec.get("error")
    shape = SHAPES["train_4k"]
    tokens = shape.global_batch * shape.seq_len
    mcfg = moe.MoEConfig(d_model=cfg.d_model, n_experts=cfg.n_experts,
                         top_k=cfg.top_k, d_ff=cfg.moe_d_ff)
    rows = (cfg.n_experts * moe.capacity_of(mcfg, tokens // groups)
            * groups // ranks)
    n_moe = cfg.n_layers - cfg.first_dense_layers
    ops = 3 * 2 * rows * cfg.d_model * cfg.moe_d_ff * 2 * n_moe
    assert rec["kernels"]["grouped_matmul"]["ops"] == ops
    if ranks == 16:
        grp16 = cfg.n_experts * moe.capacity_of(mcfg, tokens // 16)
        assert rows == grp16
        assert ops == pytest.approx({"deepseek-v2-lite-16b": 4.422e14,
                                     "deepseek-v2-236b": 2.737e15}[arch],
                                    rel=1e-3)
    kinds = rec["collectives"]["count_by_kind"]
    if groups == ranks:
        assert "all-to-all" not in kinds
        assert "moe_exchange" not in rec
        return
    # each exchange (forward, recompute, backward: 6 a MoE layer) moves a
    # rank's tokens x top_k rows of d bf16 values
    calls = kinds["all-to-all"]
    assert calls == 6 * n_moe
    assert rec["collectives"]["bytes_by_kind"]["all-to-all"] == (
        calls * tokens // ranks * cfg.top_k * cfg.d_model * 2)
    assert rec["moe_exchange"] == dryrun.MOE_EXCHANGE_NOTE


def test_cli_full_width_cell(tmp_path, monkeypatch):
    """``python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape
    train_4k --mesh single`` on a host without a card: an ``ok`` record at
    16 x 16, its roofline at the H100's rates."""
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)
    dryrun.main(["--arch", "qwen2.5-3b", "--shape", "train_4k",
                 "--mesh", "single"])
    rec = json.loads((tmp_path / "qwen2.5-3b__train_4k__16x16.json")
                     .read_text())
    assert rec["ok"] and rec["chips"] == 256 and rec["mesh"] == "16x16"
    rl = rec["roofline"]
    assert rl["t_compute_s"] == pytest.approx(
        rec["flops_by_dtype"]["bf16"] / 989e12)
    assert rl["t_memory_s"] == rl["hbm_bytes_per_device"] / 3.35e12
    assert rl["t_collective_s"] == rl["collective_bytes_per_device"] / 900e9
    # rank 0 holds 1/256 of the parameters and the AdamW moments (the
    # norms, replicated, add 1 %)
    n = get_config("qwen2.5-3b").param_count()
    assert rec["static_bytes_per_device"] == pytest.approx(
        n * (2 + 4 + 4) / 256, rel=0.02)
