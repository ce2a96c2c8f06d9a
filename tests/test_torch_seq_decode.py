"""The sequence-sharded flash-decode and the device ParallelFor, against
the JAX package's own sharded outputs and the port's unsharded paths, on
the CPU.

* The reference once (a module fixture): a subprocess with 4 host devices
  (``--xla_force_host_platform_device_count=4``) on meshes whose axes are
  ``AxisType.Auto`` (jax 0.9.0's ``make_mesh`` makes Explicit axes, on
  which the reference's ``constrain`` and ``device_parallel_for`` raise:
  ROADMAP R2) runs ``distributed_decode_attention`` at (2, 2) and (1, 4),
  the kvseq ``decode_step`` of reduced granite-3-2b and
  deepseek-v2-lite-16b (capacity 8.0, ``max_len`` 16, f32 cache) under
  ``ShardingPolicy(decode_seq_shard=True)`` at both meshes, and
  ``device_parallel_for`` at (4,) for every schedule and both padding
  branches.  Inputs come from numpy seeds, the params cross in the
  reference checkpoint format.
* The port once (a module fixture): 4 gloo ranks spawned as in
  ``test_torch_distributed.py``.  Each rank computes on its own rows and
  its block of cache positions (``params.shard_cache``, whose blocks
  carry their cut), under the policy; the parent holds the
  gathered results to the reference's (``DIST_DECODE_OK`` at the
  reference test's atol 2e-5; ``KVSEQ_PATH_OK`` at
  ``test_torch_model.py``'s TOL, 1e-4), to ``decode_attention_ref`` and
  to the port's unsharded ``decode_step`` (logits within TOL; the new
  cache bit for bit but for the new tokens' K/V after the first layer,
  which carry the combine's rounding, for scalar and per-row lengths);
  ``max_len`` 18 at model size 4 keeps the cache whole and the plain
  path's logits bit for bit; ``device_parallel_for`` at (4,) equals the
  reference and the vmap oracle exactly for every schedule, a custom
  registered policy and the padding branches.
* In this process: the plain partials and combine over 4 blocks equal
  ``decode_attention_plain`` within 1e-6 and one call at 4 x ns splits
  bit for bit, and the Pallas K2 in interpret mode at that split count
  within 1e-6; ``_device_block_size`` equals the reference's over a grid;
  a world of one gloo rank routes the decode through the partials and the
  combine, equal to the plain decode bit for bit; the refusals on a block.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_distributed import WORLD, _mesh, _spawn, one_rank  # noqa
from repro_torch.checkpoint import bridge
from repro_torch.configs import get_config
from repro_torch.configs.inputs import make_dummy_batch
from repro_torch.core import parallel_for as pf
from repro_torch.core import schedulers as sched
from repro_torch.core.tree import flatten
from repro_torch.distributed import params as psh
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import P, ShardingPolicy, policy
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import Model
from repro_torch.models import attention

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-4                       # tests/test_torch_model.py's logits TOL
DECODE_ATOL = 2e-5               # the reference test's (test_distributed.py)
ARCHS = ("granite-3-2b", "deepseek-v2-lite-16b")
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
KV_LEN = [10, 32, 5, 20]
ROW_LENS = [8, 3, 15, 1]         # per-row lengths: new tokens at 4 blocks
SCHEDULES = tuple(sched.available_schedulers())
PAD_CASES = ((37, 5), (37, 6), (41, None))   # (n, block): both branches
CUSTOM = "_custom_dev"           # a policy registered in both packages


def decode_inputs():
    """q [4, 8, 16], k / v [4, 32, 2, 16] and kv_len, from a numpy seed."""
    rng = np.random.RandomState(5)
    return (rng.randn(4, 8, 16).astype(np.float32),
            rng.randn(4, 32, 2, 16).astype(np.float32),
            rng.randn(4, 32, 2, 16).astype(np.float32),
            np.asarray(KV_LEN, np.int32))


def pad_items(n):
    return np.arange(n, dtype=np.float32)


REFERENCE = textwrap.dedent("""
    import dataclasses, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    sys.path.insert(0, sys.argv[2])
    from test_torch_seq_decode import (ARCHS, CUSTOM, MESHES, PAD_CASES,
                                       decode_inputs, pad_items)
    from repro.checkpoint import checkpoint as ckpt
    from repro.configs import get_config
    from repro.configs.inputs import make_dummy_batch
    from repro.core import parallel_for as pf
    from repro.core import schedulers as sched
    from repro.distributed.sharding import ShardingPolicy, policy
    from repro.kernels.decode_attention.ref import decode_attention_ref
    from repro.models import Model, attention as A

    out = sys.argv[1]

    def auto_mesh(shape, names):
        return jax.make_mesh(shape, names,
                             axis_types=(AxisType.Auto,) * len(shape))

    q, k, v, kv_len = decode_inputs()
    np.save(f"{out}/decode_ref.npy",
            np.asarray(decode_attention_ref(q, k, v, kv_len)))
    for name, shape in MESHES.items():
        mesh = auto_mesh(shape, ("data", "model"))
        got = jax.jit(lambda q, k, v, kl: A.distributed_decode_attention(
            q, k, v, kl, mesh=mesh))(q, k, v, kv_len)
        np.save(f"{out}/decode_{name}.npy", np.asarray(got))
    for arch in ARCHS:
        c = get_config(arch).reduced()
        if c.family == "moe":
            c = dataclasses.replace(c, capacity_factor=8.0)
        model = Model(c)
        params = model.init(jax.random.PRNGKey(0))
        ckpt.save({"params": params}, f"{out}/{arch}", 0)
        batch = make_dummy_batch(c, 4, 8)
        logits, cache = model.prefill(params, batch, max_len=16,
                                      cache_dtype=jnp.float32)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        plain, _ = model.decode_step(params, tok, cache)
        np.save(f"{out}/{arch}_plain.npy", np.asarray(plain))
        for name, shape in MESHES.items():
            mesh = auto_mesh(shape, ("data", "model"))
            with policy(ShardingPolicy(mesh, decode_seq_shard=True)):
                got, _ = jax.jit(model.decode_step)(params, tok, cache)
            np.save(f"{out}/{arch}_{name}.npy", np.asarray(got))
    mesh = auto_mesh((4,), ("data",))
    items = jnp.asarray(pad_items(41))

    @sched.register_scheduler(name=CUSTOM)
    class Custom(sched.Scheduler):
        name = CUSTOM

        def run(self, task, n, pool, *, block_size=None, cost_inputs=None):
            raise AssertionError("the device path never runs the host claim")

    for schedule in sched.available_schedulers():
        got = pf.device_parallel_for(lambda x: x * 3 - 2, items, mesh=mesh,
                                     axis="data", schedule=schedule)
        np.save(f"{out}/pf_{schedule}.npy", np.asarray(got))
    for n, block in PAD_CASES:
        got = pf.device_parallel_for(lambda x: x * 2 + 1,
                                     jnp.asarray(pad_items(n)), mesh=mesh,
                                     axis="data", block_size=block)
        np.save(f"{out}/pf_pad_{n}_{block}.npy", np.asarray(got))
    print("REFERENCE_OK")
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's sharded outputs (.npy files) and its params (one
    checkpoint per arch), from one subprocess with 4 host devices."""
    out = tmp_path_factory.mktemp("reference")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(out),
                        str(Path(__file__).parent)],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0 and "REFERENCE_OK" in r.stdout, \
        r.stderr[-3000:]
    return out


# ------------------------------------------------------- the port's ranks

def _row_layout(mesh, shape):
    """A tensor's rows cut as a cache's rows are ("pod", "data")."""
    spec = psh._fit_spec(P(("pod", "data"), *([None] * (len(shape) - 1))),
                         shape, mesh)
    return psh.Layout(mesh, spec, tuple(shape))


def _kvseq(model, params, tok, cache, mesh):
    """One decode_step of this rank's rows on its blocks of ``cache``
    (whole on every rank), under the policy; returns (gathered logits,
    gathered new cache, the mesh axes the blocks carry as their cut, and
    whether, on blocks that carry one, the same decode without the policy
    raised)."""
    blocks, lays = psh.shard_cache(cache, mesh)
    axes = {cut[1] for cut in map(sharding.block_of,
                                  flatten(blocks).values()) if cut}
    rows = _row_layout(mesh, tuple(tok.shape))
    refused = False
    if axes:
        try:    # raises in the first layer, before it writes the cache
            model.decode_step(params, rows.shard(tok), blocks)
        except NotImplementedError as e:
            refused = "distributed and launch" in str(e)
    with policy(ShardingPolicy(mesh, decode_seq_shard=True)):
        logits, new = model.decode_step(params, rows.shard(tok), blocks)
    full = _row_layout(mesh, (tok.shape[0], logits.shape[1]))
    return (full.gather(logits), psh.gather_tree(new, lays), axes,
            refused)


def _assert_new_cache(res, lens, max_len):
    """The gathered new cache against the unsharded one: every position
    but the new token's (``min(len, max_len - 1)`` a row) bit for bit, so
    exactly one rank wrote each new token and nothing else moved; the new
    tokens' K/V bit for bit in the first layer, whose input is the
    embedding, and within TOL after it (a layer's input carries the
    attention above it, whose sum order the combine of the ranks'
    partials changes); every ``len`` bit for bit."""
    got, plain = res["got_cache"], res["plain_cache"]
    assert got.keys() == plain.keys()
    first_stack = any(p.startswith("dense0/") for p in plain)
    for path, want in plain.items():
        have = got[path]
        name = path.rpartition("/")[2]
        if name not in ("k", "v", "ckv", "kr"):
            assert torch.equal(have, want), path
            continue
        rows = torch.tensor(lens if isinstance(lens, list) else [lens] * 4)
        at = rows.clamp(max=max_len - 1)
        new = torch.arange(max_len)[None, :] == at[:, None]      # [B, S]
        new = new.reshape(new.shape + (1,) * (want.dim() - 3))
        assert torch.equal(torch.where(new, 0.0, have),
                           torch.where(new, 0.0, want)), path
        np.testing.assert_allclose(have.numpy(), want.numpy(), atol=TOL,
                                   rtol=TOL)
        if path.startswith("dense0/") or not first_stack:
            assert torch.equal(have[0], want[0]), path


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def _port_rank(rank, path, ref_dir):
    out = {}
    q, k, v, kv_len = (torch.from_numpy(a) for a in decode_inputs())
    for name, shape in MESHES.items():
        mesh = _mesh(shape)
        coord = sharding.coordinate(mesh)
        b_loc, s_loc = 4 // shape[0], 32 // shape[1]
        rows = slice(coord["data"] * b_loc, (coord["data"] + 1) * b_loc)
        pos = slice(coord["model"] * s_loc, (coord["model"] + 1) * s_loc)
        got = attention.distributed_decode_attention(
            q[rows], k[rows, pos].contiguous(), v[rows, pos].contiguous(),
            kv_len[rows], mesh=mesh)
        out[f"decode_{name}"] = _row_layout(mesh, tuple(q.shape)).gather(got)
        for arch in ARCHS:
            cfg = get_config(arch).reduced()
            if cfg.family == "moe":
                cfg = dataclasses.replace(cfg, capacity_factor=8.0)
            model = Model(cfg, device="cpu")
            params = bridge.load_reference_checkpoint(
                Path(ref_dir) / arch, device="cpu")["params"]
            batch = make_dummy_batch(cfg, 4, 8, device="cpu")
            cases = [("scalar", 16), ("rows", 16)]
            for lens, max_len in cases + [("scalar", 18)] * (name == "1x4"):
                logits, cache = model.prefill(params, batch, max_len,
                                              torch.float32)
                if lens == "rows":
                    cache = model.set_cache_lengths(cache, ROW_LENS)
                tok = logits.argmax(-1)[:, None]
                plain, plain_cache = model.decode_step(params, tok,
                                                       _clone(cache))
                got, got_cache, axes, refused = _kvseq(
                    model, params, tok, cache, mesh)
                key = f"{arch}_{name}_{lens}_{max_len}"
                out[key] = {"plain": plain, "got": got, "axes": axes,
                            "refused": refused,
                            "plain_cache": flatten(plain_cache),
                            "got_cache": flatten(got_cache)}
    mesh = mesh_mod.make_mesh((WORLD,), ("data",), device="cpu")

    @sched.register_scheduler(name=CUSTOM)
    class Custom(sched.Scheduler):
        name = CUSTOM

        def run(self, task, n, pool, *, block_size=None, cost_inputs=None):
            raise AssertionError("the device path never runs the host claim")

    items = torch.from_numpy(pad_items(41))
    for schedule in (*SCHEDULES, CUSTOM):
        out[f"pf_{schedule}"] = pf.device_parallel_for(
            lambda x: x * 3 - 2, items, mesh=mesh, schedule=schedule)
    for n, block in PAD_CASES:
        out[f"pf_pad_{n}_{block}"] = pf.device_parallel_for(
            lambda x: x * 2 + 1, torch.from_numpy(pad_items(n)), mesh=mesh,
            block_size=block)
    return out


@pytest.fixture(scope="module")
def ported(reference, tmp_path_factory):
    """Every rank's results of :func:`_port_rank` (4 gloo ranks)."""
    return _spawn(_port_rank, tmp_path_factory.mktemp("ranks"),
                  str(reference))


# -------------------------------------------------------- the multi-rank

@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_distributed_decode_matches_the_reference(reference, ported,
                                                  mesh_name):
    """DIST_DECODE_OK: the port's gathered rows equal the reference's
    sharded output and ``decode_attention_ref`` at atol 2e-5, on every
    rank."""
    want = np.load(reference / f"decode_{mesh_name}.npy")
    ref = np.load(reference / "decode_ref.npy")
    for rank in ported:
        got = rank[f"decode_{mesh_name}"].numpy()
        np.testing.assert_allclose(got, want, atol=DECODE_ATOL)
        np.testing.assert_allclose(got, ref, atol=DECODE_ATOL)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_kvseq_decode_step_matches_the_reference(reference, ported, arch,
                                                 mesh_name):
    """KVSEQ_PATH_OK: the port's sequence-sharded decode_step (GQA and
    MLA) at scalar lengths gives the reference's sharded logits and its
    own unsharded ones within TOL, and the new cache as
    :func:`_assert_new_cache` holds it; the reference's own sharded and
    plain logits agree too.  The blocks carry their cut along "model":
    the same decode without the policy raises."""
    want = np.load(reference / f"{arch}_{mesh_name}.npy")
    np.testing.assert_allclose(
        want, np.load(reference / f"{arch}_plain.npy"), atol=TOL, rtol=TOL)
    for rank in ported:
        res = rank[f"{arch}_{mesh_name}_scalar_16"]
        assert res["axes"] == {"model"} and res["refused"]
        np.testing.assert_allclose(res["got"].numpy(), want, atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(res["got"].numpy(), res["plain"].numpy(),
                                   atol=TOL, rtol=TOL)
        _assert_new_cache(res, 8, 16)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_kvseq_per_row_lengths(ported, arch, mesh_name):
    """Per-row lengths (new tokens at positions 8, 3, 15, 1: on every
    block at (1, 4), the last one clamped at Smax - 1): logits within TOL
    of the unsharded decode_step and the new cache as
    :func:`_assert_new_cache` holds it."""
    for rank in ported:
        res = rank[f"{arch}_{mesh_name}_rows_16"]
        assert res["axes"] == {"model"} and res["refused"]
        np.testing.assert_allclose(res["got"].numpy(), res["plain"].numpy(),
                                   atol=TOL, rtol=TOL)
        _assert_new_cache(res, ROW_LENS, 16)


@pytest.mark.parametrize("arch", ARCHS)
def test_kvseq_indivisible_length_keeps_the_plain_path(ported, arch):
    """``max_len`` 18 at model size 4: the cache stays whole on every rank
    (no block carries a cut) and the decode takes the plain path, so its
    logits and cache equal the unsharded ones bit for bit."""
    for rank in ported:
        res = rank[f"{arch}_1x4_scalar_18"]
        assert res["axes"] == set()
        assert torch.equal(res["got"], res["plain"])
        assert all(torch.equal(a, res["got_cache"][p])
                   for p, a in res["plain_cache"].items())


@pytest.mark.parametrize("schedule", (*SCHEDULES, CUSTOM))
def test_device_parallel_for_matches_the_reference(reference, ported,
                                                   schedule):
    """Every schedule's layout at (4,) gives the reference's output and
    the vmap oracle exactly, on every rank; so does a custom registered
    policy, laid out through the default ``device_block_size`` hook in
    both packages."""
    want = np.load(reference / f"pf_{schedule}.npy")
    oracle = torch.func.vmap(lambda x: x * 3 - 2)(
        torch.from_numpy(pad_items(41)))
    for rank in ported:
        got = rank[f"pf_{schedule}"]
        assert np.array_equal(got.numpy(), want)
        assert torch.equal(got, oracle)


@pytest.mark.parametrize("case", PAD_CASES, ids=str)
def test_device_parallel_for_padding_branches(reference, ported, case):
    """n = 37 at block 5 (a padded tail, whole rounds of blocks), at
    block 6 (a padded tail and padded blocks), n = 41 at faa's default
    block."""
    n, block = case
    want = np.load(reference / f"pf_pad_{n}_{block}.npy")
    oracle = torch.from_numpy(pad_items(n)) * 2 + 1
    for rank in ported:
        got = rank[f"pf_pad_{n}_{block}"]
        assert np.array_equal(got.numpy(), want)
        assert torch.equal(got, oracle)


# ------------------------------------------------------------ this process

SPLIT_CASES = {
    # (hq, hkv, dk, dv): the reference test's GQA shape; reduced MLA's
    # absorbed decode (one latent head of 40 columns, 32 of them V)
    "gqa": (8, 2, 16, 16),
    "mla": (16, 1, 40, 32),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_plain_partials_combine_over_blocks(case):
    """4 blocks of 8 cache rows, 2 splits each, with the local lengths
    ``clamp(kv_len - offset, 0, 8)`` (a row wholly inside block 0, one
    of length 0, one past the cache): their partials laid side by side
    equal one call's at 8 splits bit for bit, and combined they equal
    ``decode_attention_plain`` and the Pallas K2 at 8 splits (interpret
    mode) within 1e-6."""
    import jax.numpy as jnp
    from repro.kernels.decode_attention.kernel import decode_attention_fwd

    hq, hkv, dk, dv = SPLIT_CASES[case]
    rng = np.random.RandomState(7)
    q = rng.randn(4, hq, dk).astype(np.float32)
    k = rng.randn(4, 32, hkv, dk).astype(np.float32)
    v = rng.randn(4, 32, hkv, dv).astype(np.float32)
    kv_len = np.array([5, 0, 23, 40], np.int32)
    tq, tk, tv, tl = (torch.from_numpy(a) for a in (q, k, v, kv_len))
    blocks = [da.decode_attention_partials_plain(
        tq, tk[:, 8 * r:8 * r + 8], tv[:, 8 * r:8 * r + 8],
        (tl - 8 * r).clamp(0, 8).to(torch.int32), num_splits=2)
        for r in range(4)]
    parts = [torch.cat(t, dim=2) for t in zip(*blocks)]
    whole = da.decode_attention_partials_plain(tq, tk, tv, tl, num_splits=8)
    assert all(torch.equal(a, b) for a, b in zip(parts, whole))
    assert parts[0].shape == (4, hkv, 8, hq // hkv, dv)
    assert parts[1].shape == parts[2].shape == (4, hkv, 8, hq // hkv, 1)
    got = da.decode_combine_plain(*parts, torch.float32)
    want = da.decode_attention_plain(tq, tk, tv, tl)
    assert float((got - want).abs().max()) <= 1e-6
    assert float(got[1].abs().max()) == 0.0          # kv_len 0: zeros
    if dk == dv:       # the Pallas kernel's V has q's and k's head dim
        pallas = decode_attention_fwd(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(kv_len),
                                      num_splits=8, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas),
                                   atol=1e-6)


def test_device_block_size_matches_the_reference():
    """``_device_block_size`` equals the reference's for every schedule
    over a grid of (n, workers, block), and an unknown schedule raises
    the reference's ValueError."""
    from repro.core import parallel_for as jpf

    for schedule in SCHEDULES:
        for n in (1, 7, 37, 41, 1000):
            for workers in (1, 2, 4, 16):
                for block in (None, 1, 5, 64):
                    assert pf._device_block_size(
                        schedule, n, workers, block, None) == \
                        jpf._device_block_size(schedule, n, workers,
                                               block, None), \
                        (schedule, n, workers, block)
    with pytest.raises(ValueError, match="unknown scheduler"):
        pf._device_block_size("bogus", 8, 2, None, None)


def test_one_rank_decode_goes_through_partials_and_combine(one_rank):
    """At one rank ((1, 1) mesh) the policy's decode is the tick's own
    split and combine: reduced qwen's and deepseek's decode_step logits
    and caches equal the plain path's bit for bit (scalar and per-row
    lengths), and ``device_parallel_for`` at (1,) equals vmap for every
    schedule; an unknown schedule raises."""
    mesh = mesh_mod.make_mesh((1, 1), ("data", "model"), device="cpu")
    for arch in ("qwen2.5-3b", "deepseek-v2-lite-16b"):
        cfg = get_config(arch).reduced()
        model = Model(cfg, device="cpu")
        params = model.init(0)
        toks = {"tokens": torch.from_numpy(np.random.RandomState(3).randint(
            0, cfg.vocab_size, (2, 6)))}
        for per_row in (False, True):
            logits, cache = model.prefill(params, toks, 12, torch.float32)
            if per_row:
                cache = model.set_cache_lengths(cache, [6, 2])
            tok = logits.argmax(-1)[:, None]
            want, want_cache = model.decode_step(params, tok, _clone(cache))
            blocks, lays = psh.shard_cache(cache, mesh)
            assert not any(map(sharding.block_of, flatten(blocks).values()))
            with policy(ShardingPolicy(mesh, decode_seq_shard=True)):
                got, got_cache = model.decode_step(params, tok, blocks)
            assert torch.equal(got, want), (arch, per_row)
            assert all(torch.equal(a, flatten(got_cache)[p])
                       for p, a in flatten(want_cache).items())
    host = mesh_mod.make_host_mesh(device="cpu")
    items = torch.arange(23.0)
    for schedule in SCHEDULES:
        assert torch.equal(pf.device_parallel_for(
            lambda x: x + 1, items, mesh=host, schedule=schedule),
            torch.func.vmap(lambda x: x + 1)(items))
    with pytest.raises(ValueError, match="unknown scheduler"):
        pf.device_parallel_for(lambda x: x, items, mesh=host,
                               schedule="bogus")


def _as_blocks(cache, mesh):
    """A copy of ``cache`` whose leaves carry a cut along "model" of
    ``mesh`` (``sharding.mark_block``), as ``params.shard_cache`` marks
    the leaves it cuts: at one rank, blocks of one."""
    out = _clone(cache)
    for t in flatten(out).values():
        if t.dim() > 2:
            sharding.mark_block(t, mesh, "model")
    return out


def test_refusals_on_a_cache_block(one_rank):
    """On a cache whose leaves carry a cut (a block of positions), every
    call but the one-token contiguous decode under the policy raises,
    naming the ROADMAP item: a prefill into the cache, the speculative
    verify, a paged pool, a quantized cache, the hybrid family's SSM
    state, a decode without the policy; so does an Engine under a
    decode_seq_shard policy over more than one rank.  The mark stays with
    the leaves' views and leaves their copies; a view cannot be marked."""
    from repro_torch.serve import Engine, ServeConfig

    mesh = mesh_mod.make_mesh((1, 1), ("data", "model"), device="cpu")
    pol = ShardingPolicy(mesh, decode_seq_shard=True)
    cfg = get_config("qwen2.5-3b").reduced()
    model = Model(cfg, device="cpu")
    params = model.init(0)
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (2, 6)))
    logits, cache = model.prefill(params, {"tokens": toks}, 12,
                                  torch.float32)
    tok = logits.argmax(-1)[:, None]
    match = "distributed and launch"
    blocks = _as_blocks(cache, mesh)
    assert sharding.block_of(blocks["k"][0]) == (mesh, "model")
    assert sharding.block_of(blocks["k"].clone()) is None
    with pytest.raises(ValueError, match="a view"):
        sharding.mark_block(cache["k"][0], mesh, "model")
    with policy(pol):
        with pytest.raises(NotImplementedError, match=match):
            model.prefill_continue(params, toks[:, :2], blocks)
        rows = _as_blocks(model.set_cache_lengths(_clone(cache), [6, 2]),
                          mesh)
        with pytest.raises(NotImplementedError, match=match):
            model.verify_step(params, toks[:, :3], rows)
        pool = {"k": rows["k"][0], "v": rows["v"][0],
                "pt": torch.zeros((2, 2), dtype=torch.int32),
                "len": rows["len"][0]}
        with pytest.raises(NotImplementedError, match=match):
            attention.attn_apply(None, None, torch.zeros((2, 1, 8)),
                                 cache=pool)
    _, qcache = model.prefill(params, {"tokens": toks}, 12, torch.int8)
    hybrid = Model(get_config("zamba2-2.7b").reduced(), device="cpu")
    hp = hybrid.init(0)
    hl, hc = hybrid.prefill(hp, {"tokens": toks}, 12, torch.float32)
    with policy(pol):
        with pytest.raises(NotImplementedError, match=match):
            model.decode_step(params, tok, _as_blocks(qcache, mesh))
        with pytest.raises(NotImplementedError, match=match):
            hybrid.decode_step(hp, hl.argmax(-1)[:, None],
                               _as_blocks(hc, mesh))
    with pytest.raises(NotImplementedError, match=match):
        model.decode_step(params, tok, blocks)
    with policy(ShardingPolicy({"data": 2, "model": 2},
                               decode_seq_shard=True)):
        eng = Engine(model, params, ServeConfig(max_len=16))
        with pytest.raises(NotImplementedError, match=match):
            eng.serve([toks[0].numpy()], 2)
        with pytest.raises(NotImplementedError, match=match):
            eng.generate({"tokens": toks}, 2)


@pytest.mark.parametrize("arch", ("qwen2.5-3b", "deepseek-v2-lite-16b"))
def test_prompt_longer_than_the_cache_raises(arch):
    """A prefill of more tokens than ``max_len`` fails on the cache write
    (the reference's ``dynamic_update_slice`` refuses the update): the
    write a block of positions skips when another rank's block holds the
    tokens is never skipped on a whole cache."""
    cfg = get_config(arch).reduced()
    model = Model(cfg, device="cpu")
    params = model.init(0)
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (2, 14)))
    with pytest.raises(RuntimeError):
        model.prefill(params, {"tokens": toks}, 12, torch.float32)
