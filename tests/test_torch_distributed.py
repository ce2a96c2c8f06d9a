"""The port's sharding layer and sharded training, against the JAX package
and against the port's own unsharded step, on the CPU.

* Rule tables: for every leaf of five reduced configs (the leaf paths
  ``jax.eval_shape(Model(cfg).init, ...)`` gives, which the port's
  ``Model.init`` must give too), under "tp" and "fsdp", the port's fitted
  spec equals the reference's ``params._fit_spec(params._match(...))``,
  on the reference tests' ``FakeMesh`` shapes {pod 2, data 16, model 16}
  and {data 16, model 16} and on the (2, 2) mesh the multi-rank cases
  use; so do the cache rules (tp / fsdp / seq) over the reference's cache
  trees and ``batch_shardings``; ``_specs`` equals the reference's table
  under every setting, and ``ShardingPolicy.spec`` the reference
  policy's (``seq_parallel`` too: ``test_torch_seq_parallel.py`` trains
  under it).
* Blocks: each rank's ``Layout.block`` equals the block JAX's
  ``NamedSharding.devices_indices_map`` gives the same mesh position
  (a subprocess with 4 host devices), multi-axis entries such as
  ``("model", "data")`` included.
* Multi-rank cases: 4 gloo ranks spawned with ``mp.spawn(join=False)``,
  rendezvous through a ``file://`` in ``tmp_path`` (never a port), each
  spawn joined within ``SPAWN_S`` seconds and its children killed after,
  so that a hung collective fails one test.  Every rank computes the
  unsharded step as well, and the parent compares:

  - ``Layout.gather`` / ``reduce`` over the spec's axes on (2, 2) and
    two 3-axis meshes, exact;
  - the "tp" and "fsdp" sharded steps on the (2, 2) mesh against the
    unsharded step (2 steps, reduced qwen2.5-3b and the einsum
    deepseek-v2-lite-16b at 4 claim groups, f32): losses rtol 1e-5, every
    gathered leaf ``STEP_TOL`` (atol 1e-4, a tenth of the lr: Adam
    amplifies the last bits of near-zero gradients), the gradient norms
    and first moments too (they see a gradient's scale); the fsdp step's
    loss finite and equal to the unsharded loss is ``FSDP_LAYOUT_OK``;
  - ``moe_impl="sharded"`` deepseek (4 experts), 3 steps under the tp
    policy: losses finite and falling, the all_to_all exchanges counted
    (``MOE_SHARDED_TRAIN_OK``); at a capacity that drops nothing, 2
    expert-parallel steps under the tp and the fsdp policy equal the
    unsharded einsum steps (losses, norms, leaves and moments);
  - a save under (2, 2) restored under (4, 1) and (1, 4), every gathered
    leaf bit for bit (``ELASTIC_REMESH_OK``), and the sharded ``Trainer``
    against the unsharded one, each restoring the other's checkpoint bit
    for bit;
  - ``moe_apply_sharded`` against the JAX package: at capacity factor 8.0
    (nothing dropped) each token shard's output equals the reference's
    ``moe_apply`` on that shard's tokens (f32, atol 1e-5); at 0.5 each
    shard's claims (``slot``, ``keep``) equal the reference's
    ``prefix_sum_slots`` bit for bit; ``aux_loss`` equals numpy's from
    the fractions of the whole batch (rtol 1e-5).

* One rank (a gloo group in the test process, torn down after): 2 "tp"
  and "fsdp" steps equal the unsharded steps bit for bit, the
  expert-parallel deepseek's losses the einsum one's where their
  capacities agree, and a decode under ``decode_seq_shard`` the plain
  decode; without a group the mesh, policy and sharded calls raise, the
  sequence-sharded decode too (``test_torch_seq_decode.py`` holds it).
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.core.tree import flatten
from repro_torch.distributed import params as psh
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import P, ShardingPolicy, policy
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import Model
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
SPAWN_S = 120
STEP_TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ("granite-3-2b", "deepseek-v2-lite-16b", "mamba2-780m",
         "zamba2-2.7b", "seamless-m4t-large-v2")
MESHES = {"pod2_data16_model16": {"pod": 2, "data": 16, "model": 16},
          "data16_model16": {"data": 16, "model": 16},
          "data2_model2": {"data": 2, "model": 2}}


class FakeMesh:
    """The reference tests' stand-in: ``shape`` {axis: size}."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def _jax_path(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _jax_specs(tree, mesh: dict, rules) -> dict:
    import jax
    from repro.distributed import params as jpsh
    from jax.sharding import PartitionSpec as JP

    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = _jax_path(path)
        spec = jpsh._fit_spec(jpsh._match(rules, key) or JP(),
                              tuple(leaf.shape), FakeMesh(mesh))
        out[key] = tuple(spec)
    return out


# ------------------------------------------------------------ rule tables

@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("layout", ["tp", "fsdp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_rules_match_the_reference(arch, layout, mesh_name):
    import jax
    from repro.distributed import params as jpsh
    from repro.models import Model as JaxModel

    from repro.configs import get_config as jax_config

    mesh = MESHES[mesh_name]
    abstract = jax.eval_shape(JaxModel(jax_config(arch).reduced()).init,
                              jax.random.PRNGKey(0))
    want = _jax_specs(abstract, mesh, jpsh.RULESETS[layout])
    params = Model(get_config(arch).reduced(), device="cpu").init(0)
    got = {k: tuple(lay.spec) for k, lay in flatten(
        psh.param_shardings(params, mesh, layout)).items()}
    assert got == want
    # the optimizer state's layouts are its params' (the trainer checks)
    state = opt.init_state(params, opt.AdamWConfig())
    st = flatten(psh.tree_shardings(state, mesh, psh.RULESETS[layout]))
    assert all(st[f"m/{k}"].spec == lay for k, lay in got.items())
    assert st["step"].spec == P()


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("layout", ["tp", "fsdp", "seq"])
def test_cache_and_batch_rules_match_the_reference(layout, mesh_name):
    import jax
    import jax.numpy as jnp
    from repro.distributed import params as jpsh
    from repro.models import Model as JaxModel

    from repro.configs import get_config as jax_config

    mesh = MESHES[mesh_name]
    rules = {"tp": jpsh.CACHE_RULES, "fsdp": jpsh.CACHE_RULES_FSDP,
             "seq": jpsh.CACHE_RULES_SEQ}[layout]
    for arch in ARCHS:
        jm = JaxModel(jax_config(arch).reduced())
        for batch in (1, 4, 32):
            cache = jax.eval_shape(lambda: jm.init_cache(batch, 64,
                                                         jnp.float32))
            want = _jax_specs(cache, mesh, rules)
            got = {k: tuple(lay.spec) for k, lay in flatten(
                psh.cache_shardings(cache, mesh, layout)).items()}
            assert got == want, (arch, batch)
    if layout == "seq":
        return
    # the reference's batch_shardings: one spec over the batch axes the
    # mesh has, fitted per leaf (its NamedSharding needs real devices)
    axes = ("pod", "data", "model") if layout == "fsdp" else ("pod", "data")
    spec = jax.sharding.PartitionSpec(tuple(a for a in axes if a in mesh))
    for shape in ((8, 32), (3, 5), (32, 1024), (512, 7), (2, 16, 64)):
        want = tuple(jpsh._fit_spec(spec, shape, FakeMesh(mesh)))
        got = psh.batch_shardings({"tokens": torch.empty(shape)}, mesh,
                                  layout)["tokens"].spec
        assert tuple(got) == want, shape


@pytest.mark.parametrize("fsdp_pure", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("seq_parallel", [False, True], ids=["", "seq"])
@pytest.mark.parametrize("multi_pod", [False, True], ids=["", "pod"])
def test_policy_specs_match_the_reference(multi_pod, seq_parallel,
                                          fsdp_pure):
    """``_specs`` is the reference's table under every setting, and
    ``ShardingPolicy.spec`` (multi-pod where the mesh has a "pod" axis)
    the reference policy's, ``seq_parallel`` included; the sharded step
    splits the rows over the policy's batch axes: ("pod", "data"), and
    "model" too under fsdp without ``seq_parallel`` (with it, "model"
    carries the sequence)."""
    from repro.distributed import sharding as jsh

    want = jsh._specs(multi_pod, seq_parallel, fsdp_pure)
    got = sharding._specs(multi_pod, seq_parallel, fsdp_pure)
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in want.items()}
    mesh = MESHES["pod2_data16_model16" if multi_pod else "data16_model16"]
    pol = ShardingPolicy(mesh, seq_parallel=seq_parallel,
                         fsdp_pure=fsdp_pure)
    for name, spec in want.items():
        assert tuple(pol.spec(name)) == tuple(spec), name
    assert pol.spec("no such name") is None
    rows_over_model = fsdp_pure and not seq_parallel
    assert pol.batch_axes() == tuple(a for a in (
        "pod", "data", "model" if rows_over_model else None) if a in mesh)


# ------------------------------------------------------------------ blocks

BLOCK_SPECS = [P(("model", "data"), None), P(("data", "model"), None),
               P("model", "data"), P("data", "model"), P(None, "model"),
               P("data", None), P(None, ("model", "data")), P(), P(None,)]
BLOCK_SHAPE = (8, 12)

JAX_BLOCKS = textwrap.dedent("""
    import json, sys
    import jax, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    devs = np.array(jax.devices()[:4]).reshape(2, 2)
    mesh = Mesh(devs, ("data", "model"))
    out = []
    for spec in json.loads(sys.argv[1]):
        spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
        idx = NamedSharding(mesh, spec).devices_indices_map(
            tuple(json.loads(sys.argv[2])))
        out.append({f"{i},{j}": [[s.start or 0, s.stop] for s in idx[
            devs[i, j]]] for i in range(2) for j in range(2)})
    print(json.dumps(out))
""")


def test_blocks_follow_jax_row_major_order():
    """Each (data, model) position's block under ``Layout`` is the one JAX
    hands the device at that position of a (2, 2) mesh, for every spec
    (a dim over ("model", "data") puts "model" outermost)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, "-c", JAX_BLOCKS,
                        json.dumps([list(s) for s in BLOCK_SPECS]),
                        json.dumps(BLOCK_SHAPE)],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    want = json.loads(r.stdout.strip().splitlines()[-1])
    sizes = {"data": 2, "model": 2}
    full = torch.arange(math.prod(BLOCK_SHAPE)).reshape(BLOCK_SHAPE)
    for spec, blocks in zip(BLOCK_SPECS, want):
        lay = psh.Layout(sizes, psh._fit_spec(spec, BLOCK_SHAPE, sizes),
                         BLOCK_SHAPE)
        for pos, bounds in blocks.items():
            coord = dict(zip(("data", "model"), map(int, pos.split(","))))
            got = lay.block(full, coord)
            assert torch.equal(got, full[tuple(slice(a, b) for a, b in
                                               bounds)]), (spec, pos)
            assert tuple(got.shape) == lay.block_shape


# ------------------------------------------------------ spawned gloo ranks

def _spawn(fn, tmp_path, *args):
    """Run ``fn(rank, path, *args)`` on ``WORLD`` gloo ranks (rendezvous:
    a file in ``tmp_path``), each returning a picklable result saved to
    ``tmp_path``; returns the ranks' results.  The ranks are joined within
    ``SPAWN_S`` seconds, then killed: a hung collective fails the test."""
    ctx = mp.spawn(_run_rank, args=(fn, str(tmp_path), args), nprocs=WORLD,
                   join=False)
    deadline = time.monotonic() + SPAWN_S
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                pytest.fail(f"{fn.__name__}: ranks still running after "
                            f"{SPAWN_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _run_rank(rank, fn, path, args):
    torch.set_num_threads(1)
    os.environ["REPRO_TUNING"] = "off"
    dist.init_process_group("gloo", init_method=f"file://{path}/rdv",
                            rank=rank, world_size=WORLD)
    try:
        out = fn(rank, Path(path), *args)
        torch.save(out, Path(path) / f"rank{rank}.pt")
        # no rank tears its groups down while a peer still uses them (a
        # gloo pair closed under a peer's pending op aborts that peer)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _mesh(shape):
    return mesh_mod.make_mesh(shape, ("data", "model"), device="cpu")


def _batches(cfg, n, rows=8, seq=16):
    gen = np.random.RandomState(1)
    return [{"tokens": torch.from_numpy(gen.randint(
        0, cfg.vocab_size, (rows, seq)).astype(np.int64))} for _ in range(n)]


def _train(model, ocfg, batches, *, layouts=None, state=None, params=None,
           microbatches=2):
    """Steps of ``make_train_step`` over ``batches`` from ``params`` (the
    model's seed-0 init) or, with ``layouts``, from this rank's blocks of
    it; returns (losses, full params, full state, gradient norms)."""
    params = model.init(0) if params is None else params
    if layouts is not None:
        params = psh.shard_tree(params, layouts)
    state = opt.init_state(params, ocfg)
    step = make_train_step(model, ocfg, microbatches=microbatches,
                           grad_shardings=layouts)
    losses, norms = [], []
    for b in batches:
        params, state, met = step(params, state, b)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    if layouts is not None:
        params = psh.gather_tree(params, layouts)
        state = dict(state, m=psh.gather_tree(state["m"], layouts),
                     v=psh.gather_tree(state["v"], layouts))
    return losses, params, state, norms


LAYOUT_MESHES = [((2, 2), ("data", "model")),
                 ((2, 2, 1), ("pod", "data", "model")),
                 ((1, 2, 2), ("pod", "data", "model"))]
LAYOUT_SPECS = [P(("model", "data"), None), P(("pod", "data"), None),
                P("data", "model"), P(None, "model"), P("pod", None),
                P("data", None), P()]


def _layouts_rank(rank, path):
    """For each mesh and spec: gather(shard(full)) is ``full``, and
    reduce of every rank's (rank + 1) * full is this rank's block of
    10 * full (the sum over the 4 ranks), both exact."""
    full = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    out = {}
    for shape, axes in LAYOUT_MESHES:
        mesh = mesh_mod.make_mesh(shape, axes, device="cpu")
        for spec in LAYOUT_SPECS:
            lay = psh.Layout(mesh, psh._fit_spec(spec, (8, 12), mesh),
                             (8, 12))
            block = lay.shard(full)
            red = lay.reduce(full * (rank + 1))
            out[(shape, spec)] = (
                torch.equal(lay.gather(block), full)
                and torch.equal(red, lay.shard(full * 10)))
    return out


def test_layout_gather_and_reduce_over_their_axes(tmp_path):
    """``Layout.gather`` / ``reduce`` go over the ranks of the spec's axes
    (and the reduction then over the replicas): on (2, 2) and two 3-axis
    meshes, splits over one axis, two axes in either order, and none,
    every rank's result exact."""
    results = _spawn(_layouts_rank, tmp_path)
    for res in results:
        assert len(res) == len(LAYOUT_MESHES) * len(LAYOUT_SPECS)
        assert all(res.values()), [k for k, v in res.items() if not v]


def _steps_rank(rank, path, arch, overrides):
    cfg = dataclasses.replace(get_config(arch).reduced(), **overrides)
    model = Model(cfg, device="cpu")
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    batches = _batches(cfg, 2)
    out = {"plain": _train(model, ocfg, batches)}
    mesh = _mesh((2, 2))
    for layout in ("tp", "fsdp"):
        lays = psh.param_shardings(model.init(0), mesh, layout)
        with policy(ShardingPolicy(mesh, fsdp_pure=layout == "fsdp")):
            out[layout] = _train(model, ocfg, batches, layouts=lays)
    return out


@pytest.mark.parametrize("arch,overrides", [
    ("qwen2.5-3b", {}),
    ("deepseek-v2-lite-16b", {"moe_dispatch_groups": 4}),
], ids=["qwen2.5-3b", "deepseek-einsum"])
def test_sharded_steps_match_the_unsharded_step(tmp_path, arch, overrides):
    """FSDP_LAYOUT_OK, and the tp step: 2 steps on the (2, 2) mesh, the
    gathered params and moments held to the unsharded step's on every
    rank."""
    results = _spawn(_steps_rank, tmp_path, arch, overrides)
    plain = results[0]["plain"]
    for res in results:
        for layout in ("tp", "fsdp"):
            assert np.isfinite(res[layout][0]).all()
            _assert_steps_equal(res[layout], plain)
            assert int(res[layout][2]["step"]) == 2


def _assert_steps_equal(got, want):
    """Two ``_train`` runs agree: losses and gradient norms (rtol 1e-5),
    every gathered leaf (``STEP_TOL``) and every first moment (atol 1e-6,
    rtol 1e-4).  The moments and the norm see a gradient's scale, which
    AdamW's update nearly cancels: a gradient off by a constant factor
    passes the params but not these."""
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5)
    for key, leaf in flatten(want[1]).items():
        torch.testing.assert_close(flatten(got[1])[key], leaf, **STEP_TOL,
                                   msg=key)
    for key, leaf in flatten(want[2]["m"]).items():
        torch.testing.assert_close(flatten(got[2]["m"])[key], leaf,
                                   atol=1e-6, rtol=1e-4, msg=key)


def _moe_sharded_rank(rank, path):
    from repro_torch.models import moe_sharded

    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b").reduced(),
                              moe_impl="sharded", n_experts=4)
    model = Model(cfg, device="cpu")
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    batch = _batches(cfg, 1, rows=4, seq=32)[0]
    mesh = _mesh((2, 2))
    lays = psh.param_shardings(model.init(0), mesh, "tp")
    moe_sharded.moe_apply_sharded.all_to_all_calls = 0
    with policy(ShardingPolicy(mesh)):
        losses = _train(model, ocfg, [batch] * 3, layouts=lays,
                        microbatches=1)[0]
    calls = moe_sharded.moe_apply_sharded.all_to_all_calls
    # at a capacity that drops nothing the per-shard claims change no
    # output: the expert-parallel steps are the einsum steps
    wide = dataclasses.replace(cfg, capacity_factor=8.0)
    batches = _batches(cfg, 2, rows=8, seq=16)
    plain = _train(Model(dataclasses.replace(wide, moe_impl="einsum"),
                         device="cpu"), ocfg, batches)
    # one global claim counter (dispatch_groups 0) across the two batch
    # ranks of the einsum path: the FAA ticket, equal to the unsharded step
    einsum = Model(dataclasses.replace(cfg, moe_impl="einsum"), device="cpu")
    one_counter = (_train(einsum, ocfg, batches[:1], layouts=lays),
                   _train(einsum, ocfg, batches[:1]))
    ep = []
    for layout in ("tp", "fsdp"):
        lays = psh.param_shardings(model.init(0), mesh, layout)
        with policy(ShardingPolicy(mesh, fsdp_pure=layout == "fsdp")):
            ep.append(_train(Model(wide, device="cpu"), ocfg, batches,
                             layouts=lays))
    return losses, calls, plain, ep, one_counter


def test_moe_sharded_trains(tmp_path):
    """MOE_SHARDED_TRAIN_OK: the expert-parallel dispatch under the tp
    policy on (2, 2), 3 sharded steps on one batch: losses finite, equal on
    every rank, and falling; two all_to_alls a MoE layer's forward, which
    full remat runs twice a step (the recompute).  At capacity factor 8.0
    (nothing dropped) 2 expert-parallel steps of 2 microbatches, under the
    tp policy (rows over "data", tokens over "model" inside the layer) and
    the fsdp one (rows over both), equal the unsharded einsum steps
    (``_assert_steps_equal``: losses, gradient norms, every leaf and first
    moment): the exchange's and the row gather's backwards carry every
    gradient at its scale.  The einsum path's one global claim counter
    across the two batch ranks (the FAA ticket) equals the unsharded
    step (``_assert_steps_equal``)."""
    results = _spawn(_moe_sharded_rank, tmp_path)
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    n_moe = cfg.n_layers - cfg.first_dense_layers
    losses = results[0][0]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    for got, calls, plain, eps, (ticket, unsharded) in results:
        assert got == losses
        assert calls == 2 * 2 * n_moe * 3
        for ep in eps:
            _assert_steps_equal(ep, plain)
        _assert_steps_equal(ticket, unsharded)
    print("MOE_SHARDED_TRAIN_OK", losses[0], losses[-1])


# the FAA ticket's cases on (2, 2): (layout, dispatch_groups, a step's
# rows x positions, config overrides); capacity factor 0.75 drops choices
TICKET_CASES = {
    # one group of a microbatch's 64 tokens over 2 ("tp") or 4 ranks
    "tp-one-counter": ("tp", 0, (8, 16), {}),
    "fsdp-one-counter": ("fsdp", 0, (8, 16), {}),
    # 3 groups of 16 tokens over ranks of 24 or 12: groups cut inside a
    # rank, whose buffers then come from two groups' owners
    "tp-straddling": ("tp", 3, (8, 12), {}),
    "fsdp-straddling": ("fsdp", 3, (8, 12), {}),
    # 4 ranks over 2 experts: each owns half an expert's rows
    "fsdp-more-ranks-than-experts": ("fsdp", 0, (8, 16), {"n_experts": 2}),
    # 4 ranks over 3 experts: runs of 3 C / 4 rows that end inside experts
    "fsdp-runs-inside-experts": ("fsdp", 0, (8, 16), {"n_experts": 3}),
}


def _ticket_rank(rank, path):
    """Each ``TICKET_CASES`` case: 2 sharded steps and the unsharded ones
    (2 microbatches, full remat); the first MoE call's claims (top_i, the
    ticket's slots and keep bits, the rank's pieces) and its ``dropped``."""
    from repro_torch.models import moe

    ticket, apply = moe.claim_ticket, moe.moe_apply
    seen = []

    def recorded_ticket(top_i, lay, e):
        tk = ticket(top_i, lay, e)
        if not seen:
            lay = tk.layout
            seen.append((top_i.clone(), tk.slot.clone(), tk.keep.clone(),
                         lay.pieces[lay.me], lay.groups, lay.cap,
                         lay.tokens))
        return tk

    def recorded_apply(p, cfg, x, **kw):
        out, met = apply(p, cfg, x, **kw)
        if len(seen) == 1:
            seen.append(float(met["dropped"]))
        return out, met

    moe.claim_ticket, moe.moe_apply = recorded_ticket, recorded_apply
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    mesh = _mesh((2, 2))
    out = {}
    try:
        for name, (layout, groups, (rows, seq), more) in TICKET_CASES.items():
            cfg = dataclasses.replace(
                get_config("deepseek-v2-lite-16b").reduced(),
                moe_dispatch_groups=groups, capacity_factor=0.75, **more)
            model = Model(cfg, device="cpu")
            batches = _batches(cfg, 2, rows=rows, seq=seq)
            plain = _train(model, ocfg, batches)
            lays = psh.param_shardings(model.init(0), mesh, layout)
            seen.clear()
            with policy(ShardingPolicy(mesh, fsdp_pure=layout == "fsdp")):
                out[name] = (_train(model, ocfg, batches, layouts=lays),
                             plain, list(seen))
    finally:
        moe.claim_ticket, moe.moe_apply = ticket, apply
    return out


@pytest.fixture(scope="module")
def ticket_runs(tmp_path_factory):
    return _spawn(_ticket_rank, tmp_path_factory.mktemp("ticket"))


def _global_claims(ranks, k):
    """Every rank's recorded routing put at its tokens' places in the
    batch's row-major order: (top_i [T, K], groups, capacity)."""
    groups, cap, tokens = ranks[0][4:]
    top = torch.full((tokens, k), -1, dtype=torch.long)
    for top_i, _, _, pieces, *_ in ranks:
        at = np.concatenate([np.arange(g0, g0 + n) for _, n, _, g0 in pieces])
        # ranks that hold the same rows ("model" under "tp") agree
        assert (top[at] < 0).all() or torch.equal(top[at], top_i)
        top[at] = top_i
    assert (top >= 0).all()
    return top, groups, cap


@pytest.mark.parametrize("case", sorted(TICKET_CASES))
def test_ticket_steps_match_the_unsharded_step(ticket_runs, case):
    """The einsum MoE's claim groups across 4 gloo ranks (the FAA
    ticket), at one group (``dispatch_groups`` 0) and at 3 groups that
    cut ranks' tokens, under "tp" and "fsdp" on (2, 2), with more ranks
    than experts, and with 3 experts over 4 ranks: 2 sharded steps equal
    the unsharded steps
    (``_assert_steps_equal``), and the first MoE call's slots and keep
    bits equal the one prefix sum over each group of every rank's claims
    (``prefix_sum_slots``), ``dropped`` the unsharded formula over them,
    exactly."""
    from repro_torch.models import moe

    k = get_config("deepseek-v2-lite-16b").reduced().top_k
    e = TICKET_CASES[case][3].get(
        "n_experts", get_config("deepseek-v2-lite-16b").reduced().n_experts)
    claims = [rank[case][2][0] for rank in ticket_runs]
    top, groups, cap = _global_claims(claims, k)
    slot, keep = moe.prefix_sum_slots(top.reshape(groups, -1, k), e, cap)
    slot, keep = slot.reshape(-1, k), keep.reshape(-1, k)
    want_dropped = float(1.0 - keep.sum().float() / keep.numel())
    assert 0.0 < want_dropped
    for rank in ticket_runs:
        got, plain, ((_, r_slot, r_keep, pieces, *_), dropped) = rank[case]
        _assert_steps_equal(got, plain)
        at = np.concatenate([np.arange(g0, g0 + n) for _, n, _, g0 in pieces])
        assert torch.equal(r_slot, slot[at].long())
        assert torch.equal(r_keep, keep[at])
        assert dropped == want_dropped


def _remesh_rank(rank, path):
    cfg = get_config("qwen2.5-3b").reduced()
    model = Model(cfg, device="cpu")
    params = model.init(1)
    src = psh.param_shardings(params, _mesh((2, 2)), "tp")
    ckpt.save({"p": psh.shard_tree(params, src)}, path / "ck", 1,
              shardings={"p": src})
    out = {}
    for shape in ((4, 1), (1, 4)):
        for layout in ("tp", "fsdp"):
            lays = psh.param_shardings(params, _mesh(shape), layout)
            like = {"p": psh.shard_tree(params, lays)}
            got, step = ckpt.restore(path / "ck", like=like,
                                     shardings={"p": lays})
            full = psh.gather_tree(got["p"], lays)
            out[(shape, layout)] = all(
                torch.equal(full_leaf, flatten(params)[k])
                for k, full_leaf in flatten(full).items()) and step == 1
    return out


def test_elastic_remesh(tmp_path):
    """ELASTIC_REMESH_OK: a checkpoint of tp blocks saved under (2, 2)
    restores under (4, 1) and (1, 4), tp and fsdp, every leaf gathered
    back bit for bit; rank 0 wrote the reference's format (the unsharded
    restore reads it)."""
    results = _spawn(_remesh_rank, tmp_path)
    assert all(all(r.values()) and len(r) == 4 for r in results), results
    params = Model(get_config("qwen2.5-3b").reduced(), device="cpu").init(1)
    got, _ = ckpt.restore(tmp_path / "ck", like={"p": params})
    assert all(torch.equal(flatten(got)[k], v)
               for k, v in flatten({"p": params}).items())
    print("ELASTIC_REMESH_OK")


def _trainer_rank(rank, path, first):
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_config("qwen2.5-3b").reduced()
    model = Model(cfg, device="cpu")
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=8)
    mesh = _mesh((2, 2))
    params = model.init(0)
    p_sh = psh.param_shardings(params, mesh, "fsdp")
    o_sh = psh.tree_shardings(opt.init_state(params, ocfg), mesh,
                              psh.PARAM_RULES_FSDP)

    def trainer(sharded, ckdir, steps):
        return Trainer(model, ocfg, data, TrainerConfig(
            total_steps=steps, ckpt_every=2, ckpt_dir=str(ckdir),
            microbatches=2, log_every=100),
            shardings=(p_sh, o_sh) if sharded else None,
            log_fn=lambda s: None)

    def full(out, sharded):
        if not sharded:
            return out["params"], out["opt_state"]
        return (psh.gather_tree(out["params"], p_sh),
                psh.gather_tree(out["opt_state"], o_sh))

    sharded = first == "sharded"
    # the sharded trainer's ranks share one directory (rank 0 writes); the
    # unsharded trainer knows no ranks, so each writes its own
    ck = path / ("ck" if sharded else f"ck{rank}")
    trained = full(trainer(sharded, ck, 2).run(), sharded)
    # the other kind restores the committed step 2 (and trains no more)
    restored = full(trainer(not sharded, ck, 2).run(), not sharded)
    return all(torch.equal(a, b) for t1, t2 in zip(trained, restored)
               for a, b in zip(flatten(t1).values(), flatten(t2).values()))


@pytest.mark.parametrize("first", ["sharded", "unsharded"])
def test_trainer_checkpoints_cross_the_layout(tmp_path, first):
    """The sharded Trainer (fsdp on (2, 2)) and the unsharded one restore
    each other's checkpoints bit for bit, params and AdamW state."""
    assert all(_spawn(_trainer_rank, tmp_path, first))


# ---------------------------- moe_apply_sharded against the JAX package

MOE_D, MOE_E, MOE_K, MOE_F = 16, 4, 2, 8


def _moe_inputs():
    from repro_torch.models import moe

    cfg = moe.MoEConfig(d_model=MOE_D, n_experts=MOE_E, top_k=MOE_K,
                        d_ff=MOE_F, n_shared_experts=1)
    gen = torch.Generator().manual_seed(3)
    p = moe.moe_init(gen, cfg)
    x = torch.from_numpy(np.random.RandomState(4).randn(
        4, 8, MOE_D).astype(np.float32))
    return cfg, p, x


def _moe_apply_rank(rank, path):
    from repro_torch.models import moe_sharded

    cfg, p, x = _moe_inputs()
    claims = []
    plain = moe_sharded.prefix_sum_slots

    def recorded(ti, e, cap):
        slot, keep = plain(ti, e, cap)
        claims.append((ti.clone(), cap, slot.clone(), keep.clone()))
        return slot, keep

    moe_sharded.prefix_sum_slots = recorded
    out = {}
    mesh = _mesh((2, 2))
    with policy(ShardingPolicy(mesh)):
        for cf in (8.0, 0.5):
            y, met = moe_sharded.moe_apply_sharded(
                p, dataclasses.replace(cfg, capacity_factor=cf), x)
            out[cf] = (y, met["aux_loss"], met["dropped"], claims.pop())
    return out, sharding.coordinate(mesh)


def test_moe_apply_sharded_matches_the_reference(tmp_path):
    """On (2, 2) (4 token shards of 8): at capacity factor 8.0 every
    shard's rows equal the reference's ``moe_apply`` on that shard's
    tokens (atol 1e-5); at 0.5 each shard's claims equal the reference's
    ``prefix_sum_slots`` bit for bit at the port's capacity (4: a multiple
    of 4, where ``moe_apply`` would round to 8); ``aux_loss`` equals
    numpy's from the whole batch's fractions (rtol 1e-5)."""
    import jax.numpy as jnp
    from repro.models import moe as jmoe

    results = _spawn(_moe_apply_rank, tmp_path)
    cfg, p, x = _moe_inputs()
    def as_jax(tree):
        return {k: as_jax(v) if isinstance(v, dict)
                else jnp.asarray(v.numpy()) for k, v in tree.items()}

    jp = as_jax(p)
    jcfg = jmoe.MoEConfig(d_model=MOE_D, n_experts=MOE_E, top_k=MOE_K,
                          d_ff=MOE_F, n_shared_experts=1,
                          capacity_factor=8.0)
    tokens = x.reshape(-1, MOE_D).numpy()
    # numpy's aux from the whole batch
    logits = tokens.astype(np.float64) @ p["router"]["w"].numpy()
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    top1 = probs.argmax(-1)
    assign = np.bincount(top1, minlength=MOE_E) / len(top1)
    lse = np.log(np.exp(logits).sum(-1))
    aux = (MOE_E * (assign * probs.mean(0)).sum() * cfg.aux_loss_weight
           + cfg.router_zloss * (lse ** 2).mean())
    for out, coord in results:
        shard = coord["data"] * 2 + coord["model"]
        rows = slice(8 * shard, 8 * shard + 8)
        y, got_aux, _, _ = out[8.0]
        want, _ = jmoe.moe_apply(jp, jcfg, jnp.asarray(tokens[rows])[None])
        np.testing.assert_allclose(y.reshape(-1, MOE_D)[rows].numpy(),
                                   np.asarray(want)[0], atol=1e-5)
        for cf in (8.0, 0.5):
            np.testing.assert_allclose(float(out[cf][1]), aux, rtol=1e-5)
        _, _, dropped, (ti, cap, slot, keep) = out[0.5]
        assert cap == 4 and 0.0 < float(dropped)
        jslot, jkeep = jmoe.prefix_sum_slots(jnp.asarray(ti.numpy()),
                                             MOE_E, cap)
        assert np.array_equal(np.asarray(jslot), slot.numpy())
        assert np.array_equal(np.asarray(jkeep), keep.numpy())


# ---------------------------------------------------------- one rank, here

@pytest.fixture
def one_rank(tmp_path):
    """A world of one gloo rank in this process, torn down after."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_meshes_and_refusals_without_a_group():
    """No process group is made unless asked for: a mesh, a policy and
    the sharded calls raise without one, the sequence-sharded decode
    too."""
    from repro_torch.models import attention

    assert not dist.is_initialized()
    for make in (mesh_mod.make_host_mesh, mesh_mod.make_production_mesh):
        with pytest.raises(RuntimeError, match="no torch.distributed"):
            make(device="cpu")
    with pytest.raises(RuntimeError, match="no torch.distributed"):
        with policy(ShardingPolicy({"data": 1})):
            pass
    with pytest.raises(RuntimeError, match="no torch.distributed"):
        attention.distributed_decode_attention(
            torch.zeros(1, 2, 16), torch.zeros(1, 4, 1, 16),
            torch.zeros(1, 4, 1, 16), 4, mesh={"data": 1, "model": 1})


def test_one_rank_steps_equal_the_unsharded_bits(one_rank):
    """The design at one rank (what the card's phase 7p runs): the gather
    and the reduction are identities, so 2 tp and fsdp steps of reduced
    qwen equal the unsharded steps bit for bit, and the expert-parallel
    deepseek (bf16) equals the einsum one bit for bit where their
    capacities agree (80 rows at 128 tokens a microbatch: a multiple of 4
    and of 8); the production
    mesh needs 256 ranks; a decode under ``decode_seq_shard`` (the
    sequence-sharded decode over one block, the whole cache) equals the
    plain decode bit for bit."""
    mesh = mesh_mod.make_mesh((1, 1), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="256 ranks"):
        mesh_mod.make_production_mesh(device="cpu")
    assert mesh_mod.make_host_mesh(device="cpu").mesh_dim_names == ("data",)
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    cfg = get_config("qwen2.5-3b").reduced()
    model = Model(cfg, device="cpu")
    batches = _batches(cfg, 2)
    want = _train(model, ocfg, batches)
    for layout in ("tp", "fsdp"):
        lays = psh.param_shardings(model.init(0), mesh, layout)
        with policy(ShardingPolicy(mesh, fsdp_pure=layout == "fsdp")):
            got = _train(model, ocfg, batches, layouts=lays)
        assert got[0] == want[0]
        assert all(torch.equal(a, b) for a, b in zip(
            flatten(got[1]).values(), flatten(want[1]).values()))
    # in bf16, whose rounding shows any other order of the sums
    moe_cfg = get_config("deepseek-v2-lite-16b").reduced().with_dtype(
        "bfloat16")
    einsum = Model(moe_cfg, device="cpu")
    sharded = Model(dataclasses.replace(moe_cfg, moe_impl="sharded"),
                    device="cpu")
    batches = _batches(moe_cfg, 2, rows=8, seq=32)
    want = _train(einsum, ocfg, batches)
    lays = psh.param_shardings(einsum.init(0), mesh, "tp")
    with policy(ShardingPolicy(mesh)):
        got = _train(sharded, ocfg, batches, layouts=lays)
    assert got[0] == want[0]
    assert all(torch.equal(a, b) for a, b in zip(
        flatten(got[1]).values(), flatten(want[1]).values()))
    params = model.init(0)
    logits, cache = model.prefill(params, {"tokens": batches[0][
        "tokens"][:2, :4]}, 8)
    tok = logits.argmax(-1)[:, None]
    want, _ = model.decode_step(params, tok, {
        k: v.clone() for k, v in cache.items()})
    with policy(ShardingPolicy(mesh, decode_seq_shard=True)):
        got, _ = model.decode_step(params, tok, cache)
    assert torch.equal(got, want)
