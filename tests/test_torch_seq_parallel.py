"""Sequence-parallel training, ``ShardingPolicy(seq_parallel=True)``,
against the port's unsharded step and the JAX package's steps, on the
CPU.

* The port once (a module fixture): 4 gloo ranks spawned as in
  ``test_torch_distributed.py``.  Reduced qwen2.5-3b and reduced
  deepseek-v2-lite-16b (f32, ``GROUPS`` claim groups: a group of 8
  tokens lies inside every rank's block), on the ("data", "model")
  meshes (2, 2) and (1, 4), under "tp" and "fsdp" and under ``"full"``
  and ``"dots"`` remat: 2 steps of [2, 32] tokens from the same params,
  each rank holding S/m positions of its rows.  The
  parent holds every case to the port's unsharded step at the same remat
  (``_assert_steps_equal``: losses and gradient norms rtol 1e-5, every
  gathered leaf atol / rtol 1e-4, every first moment atol 1e-6 / rtol
  1e-4).  The ranks also train the sharded ``Trainer`` under the policy
  (fsdp on (2, 2)) against the same Trainer without the flag, each
  restoring the other's checkpoint bit for bit, and meet the refusals:
  the ssm, hybrid, encdec and vlm families and ``moe_impl="sharded"``
  (``NotImplementedError`` naming "distributed and launch"), a sequence
  the model axis does not divide, the loss outside the sharded step
  (``ValueError``), and a prefill under the policy; and train deepseek's
  claim groups across the ranks' blocks (one group, and 2 that span
  blocks: the FAA ticket) against the unsharded step.
* The reference once (a module fixture that starts with the port's ranks
  and is waited for after them): a subprocess with 4 host devices on
  ``AxisType.Auto`` meshes (R2: jax's default Explicit axes make its
  sharded code raise) runs the reference's ``seq_parallel`` step on the
  port's initial params at one case an arch (``REF_SP``: qwen at (1, 4),
  fsdp, dots; deepseek at (2, 2), tp, full; its partitioned program
  takes seconds a step on the CPU).  Every port case, and the port's
  unsharded steps, are held to it: losses rtol 1e-5, gradient norms rtol
  1e-4, leaves atol / rtol 1e-4 (``STEP_TOL``,
  ``tests/test_torch_train_moe.py``'s).
* In this process: the plain K1 / K11 over a sequence cut into 4 blocks,
  each block's queries over K/V rows [0, offset + S_loc), against one
  whole call (out, lse and dq within 1e-6; dk and dv, the blocks'
  zero-padded sum, within 1e-5); a world of one gloo rank, where a
  sequence-parallel step cuts nothing and equals the unsharded step bit
  for bit (what the card's phase 7q (b) runs); a policy on a mesh with no
  "model" axis refused.
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

from test_torch_distributed import (WORLD, _assert_steps_equal, _mesh,  # noqa
                                    _spawn, _train, one_rank)
from repro_torch.configs import get_config
from repro_torch.configs.inputs import make_dummy_batch
from repro_torch.core.tree import flatten
from repro_torch.distributed import params as psh
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import ShardingPolicy, policy
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import Model
from repro_torch.train import optimizer as opt

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
GROUPS = 8                       # 64 tokens a step: groups of 8
ARCHS = {"qwen2.5-3b": {}, "deepseek-v2-lite-16b": {
    "moe_dispatch_groups": GROUPS}}
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
LAYOUTS = ("tp", "fsdp")
REMATS = ("full", "dots")
ROWS, SEQ, MICRO, STEPS = 2, 32, 1, 2
STEP_TOL = dict(atol=1e-4, rtol=1e-4)
# the reference's sequence-parallel step, one case an arch (mesh, layout,
# remat): its partitioned CPU program takes seconds a step
REF_SP = {"qwen2.5-3b": ("1x4", "fsdp", "dots"),
          "deepseek-v2-lite-16b": ("2x2", "tp", "full")}
OCFG = dict(lr=1e-3, warmup_steps=1, total_steps=4)
CASES = [(arch, mesh, layout, remat) for arch in ARCHS for mesh in MESHES
         for layout in LAYOUTS for remat in REMATS]


def _cfg(arch, remat="full", **more):
    return dataclasses.replace(get_config(arch).reduced(), **{
        **ARCHS[arch], "remat_policy": remat, **more})


def _batches(vocab):
    rng = np.random.RandomState(1)
    return [rng.randint(0, vocab, (ROWS, SEQ)).astype(np.int64)
            for _ in range(STEPS)]


REFERENCE = textwrap.dedent("""
    import dataclasses, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    sys.path.insert(0, sys.argv[2])
    from test_torch_seq_parallel import (ARCHS, MESHES, MICRO, OCFG, REF_SP,
                                         _batches)
    from repro.configs import get_config
    from repro.distributed.sharding import ShardingPolicy, policy
    from repro.models import Model
    from repro.train import optimizer as jopt
    from repro.train.train_step import make_train_step

    ins, out = sys.argv[1], sys.argv[3]

    def tree(flat):
        root = {}
        for key, leaf in flat.items():
            node = root
            *parents, name = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[name] = jnp.asarray(leaf)
        return root

    def flat(t, prefix=""):
        res = {}
        for k in sorted(t):
            if isinstance(t[k], dict):
                res.update(flat(t[k], f"{prefix}{k}/"))
            else:
                res[f"{prefix}{k}"] = np.asarray(t[k])
        return res

    for arch, knobs in ARCHS.items():
        mesh_name, layout, remat = REF_SP[arch]
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  remat_policy=remat, **knobs)
        ocfg = jopt.AdamWConfig(**OCFG)
        params = tree(dict(np.load(f"{ins}/{arch}.npz")))
        state = jopt.init_state(params, ocfg)
        step = jax.jit(make_train_step(Model(cfg), ocfg, microbatches=MICRO))
        mesh = jax.make_mesh(MESHES[mesh_name], ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        losses, norms = [], []
        with policy(ShardingPolicy(mesh, seq_parallel=True,
                                   fsdp_pure=layout == "fsdp")):
            for toks in _batches(cfg.vocab_size):
                params, state, met = step(
                    params, state, {"tokens": jnp.asarray(toks, jnp.int32)})
                losses.append(float(met["loss"]))
                norms.append(float(met["grad_norm"]))
        np.savez(f"{out}/{arch}.npz", losses=np.asarray(losses),
                 norms=np.asarray(norms),
                 **{f"p/{k}": v for k, v in flat(params).items()})
    print("REFERENCE_OK")
""")


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The port's initial params (one file an arch, for the ranks and the
    reference), and the reference's subprocess, started: it runs while
    the port's ranks do, and is killed at the module's end if no test
    waited for it."""
    ins = tmp_path_factory.mktemp("inputs")
    out = tmp_path_factory.mktemp("reference")
    for arch in ARCHS:
        params = Model(_cfg(arch), device="cpu").init(0)
        torch.save(params, ins / f"{arch}.pt")
        np.savez(ins / f"{arch}.npz",
                 **{k: v.numpy() for k, v in flatten(params).items()})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(ins),
         str(Path(__file__).parent), str(out)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    try:
        yield ins, out, proc
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def reference(started, ported):
    """The reference's sequence-parallel steps, {arch: (losses, norms,
    {leaf path: array})}."""
    _, out, proc = started
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0 and "REFERENCE_OK" in stdout, stderr[-3000:]
    res = {}
    for arch in ARCHS:
        z = np.load(out / f"{arch}.npz")
        res[arch] = (z["losses"], z["norms"], {
            k[2:]: z[k] for k in z.files if k.startswith("p/")})
    return res


def _assert_reference(got, want):
    """A ``_train`` run against the reference's: losses rtol 1e-5,
    gradient norms rtol 1e-4, every leaf ``STEP_TOL``."""
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[3], want[1], rtol=1e-4)
    for key, leaf in flatten(got[1]).items():
        np.testing.assert_allclose(leaf.numpy(), want[2][key], **STEP_TOL,
                                   err_msg=key)


# ------------------------------------------------------- the port's ranks

def _recording(model):
    """``model`` with its loss recording (tokens' shape, the split's
    offset) of every call."""
    seen = []
    loss_of = model.loss

    def loss(p, batch):
        split = sharding.seq_split()
        seen.append((tuple(batch["tokens"].shape),
                     None if split is None else split.offset))
        return loss_of(p, batch)

    object.__setattr__(model, "loss", loss)
    return model, seen


def _clone(tree):
    return opt.tree_map(lambda t: t.clone(), tree)


def _sp(mesh, layout):
    return policy(ShardingPolicy(mesh, seq_parallel=True,
                                 fsdp_pure=layout == "fsdp"))


def _raises(fn, kind, text) -> bool:
    """Whether ``fn()`` raises ``kind`` with ``text`` in its message."""
    try:
        fn()
    except kind as e:
        return text in str(e)
    return False


def _refusals(mesh):
    """Each unsupported case under the policy on ``mesh`` (model size
    4): {case: raised as expected}."""
    ocfg = opt.AdamWConfig(**OCFG)
    toks = {"tokens": torch.from_numpy(_batches(256)[0])}
    out = {}

    def step(cfg, batch, layout="tp"):
        model = Model(cfg, device="cpu")
        params = model.init(0)
        lays = psh.param_shardings(params, mesh, layout)
        with _sp(mesh, layout):
            return _train(model, ocfg, [batch], layouts=lays, params=params,
                          microbatches=1)

    for arch in ("mamba2-780m", "zamba2-2.7b", "seamless-m4t-large-v2",
                 "llama-3.2-vision-11b"):
        cfg = get_config(arch).reduced()
        batch = make_dummy_batch(cfg, ROWS, SEQ, device="cpu")
        out[cfg.family] = _raises(lambda: step(cfg, batch),
                                  NotImplementedError,
                                  "distributed and launch")
    out["moe_sharded"] = _raises(
        lambda: step(_cfg("deepseek-v2-lite-16b", moe_impl="sharded"), toks),
        NotImplementedError, "distributed and launch")
    odd = {"tokens": toks["tokens"][:, :30]}
    out["indivisible_sequence"] = _raises(
        lambda: step(_cfg("qwen2.5-3b"), odd), ValueError,
        "a sequence of 30 positions does not split into the 4 blocks")
    model = Model(_cfg("qwen2.5-3b"), device="cpu")
    params = model.init(0)
    with _sp(mesh, "tp"):
        out["loss_outside_the_step"] = _raises(
            lambda: model.loss(params, toks), ValueError, "sharded step")
        out["prefill"] = _raises(
            lambda: model.prefill(params, {"tokens": toks["tokens"][:, :8]},
                                  16), NotImplementedError,
            "distributed and launch")
    return out


# claim groups that lie on several ranks' blocks (the FAA ticket): one
# group of a step's 64 tokens on (2, 2), and 2 groups of 32 on (1, 4),
# each over 2 rows' 4 blocks of 8 positions
CLAIM_GROUPS = {"one_counter": ("2x2", "tp", 0),
                "straddling_groups": ("1x4", "fsdp", 2)}


def _claim_groups(ins):
    """Each ``CLAIM_GROUPS`` case: (2 sequence-parallel steps of deepseek
    at its dispatch groups, the unsharded steps at the same)."""
    ocfg = opt.AdamWConfig(**OCFG)
    params = torch.load(Path(ins) / "deepseek-v2-lite-16b.pt")
    out = {}
    for name, (mesh_name, layout, groups) in CLAIM_GROUPS.items():
        model = Model(_cfg("deepseek-v2-lite-16b",
                           moe_dispatch_groups=groups), device="cpu")
        batches = [{"tokens": torch.from_numpy(t)}
                   for t in _batches(model.cfg.vocab_size)]
        mesh = _mesh(MESHES[mesh_name])
        lays = psh.param_shardings(params, mesh, layout)
        with _sp(mesh, layout):
            got = _train(model, ocfg, batches, layouts=lays,
                         params=_clone(params), microbatches=MICRO)
        out[name] = (got, _train(model, ocfg, batches, params=_clone(params),
                                 microbatches=MICRO))
    return out


def _trainers(path, mesh):
    """The sharded Trainer (fsdp on ``mesh``, reduced qwen, 2 steps) with
    and without the flag: the gathered params of each, and whether each
    kind restores the other's checkpoint bit for bit."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    model = Model(_cfg("qwen2.5-3b"), device="cpu")
    ocfg = opt.AdamWConfig(**OCFG)
    data = DataConfig(vocab_size=256, seq_len=SEQ, global_batch=ROWS)
    params = model.init(0)
    p_sh = psh.param_shardings(params, mesh, "fsdp")
    o_sh = psh.tree_shardings(opt.init_state(params, ocfg), mesh,
                              psh.PARAM_RULES_FSDP)

    def run(seq_parallel, ckdir):
        trainer = Trainer(model, ocfg, data, TrainerConfig(
            total_steps=2, ckpt_every=2, ckpt_dir=str(ckdir),
            microbatches=MICRO, log_every=100), shardings=(p_sh, o_sh),
            log_fn=lambda s: None)
        with policy(ShardingPolicy(mesh, seq_parallel=seq_parallel,
                                   fsdp_pure=True)):
            got = trainer.run()
        return (psh.gather_tree(got["params"], p_sh),
                psh.gather_tree(got["opt_state"], o_sh))

    trained = {flag: run(flag, path / f"ck_{flag}") for flag in (True,
                                                                 False)}
    same = {}
    for flag in (True, False):      # restore the other's committed step 2
        restored = run(flag, path / f"ck_{not flag}")
        same[flag] = all(
            torch.equal(a, b) for t1, t2 in zip(restored, trained[not flag])
            for a, b in zip(flatten(t1).values(), flatten(t2).values()))
    return {flag: t[0] for flag, t in trained.items()}, same


def _port_rank(rank, path, ins):
    ocfg = opt.AdamWConfig(**OCFG)
    out = {}
    for arch in ARCHS:
        params = torch.load(Path(ins) / f"{arch}.pt")
        batches = [{"tokens": torch.from_numpy(t)}
                   for t in _batches(_cfg(arch).vocab_size)]
        for remat in REMATS:
            model = Model(_cfg(arch, remat), device="cpu")
            out[(arch, remat)] = _train(model, ocfg, batches,
                                        params=_clone(params),
                                        microbatches=MICRO)
            for mesh_name, shape in MESHES.items():
                mesh = _mesh(shape)
                for layout in LAYOUTS:
                    lays = psh.param_shardings(params, mesh, layout)
                    model, seen = _recording(Model(_cfg(arch, remat),
                                                   device="cpu"))
                    with _sp(mesh, layout):
                        res = _train(model, ocfg, batches, layouts=lays,
                                     params=_clone(params),
                                     microbatches=MICRO)
                    out[(arch, mesh_name, layout, remat)] = (
                        res, seen, sharding.coordinate(mesh))
    out["refusals"] = _refusals(_mesh(MESHES["1x4"]))
    out["claim_groups"] = _claim_groups(ins)
    out["trainers"] = _trainers(path, _mesh(MESHES["2x2"]))
    return out


@pytest.fixture(scope="module")
def ported(started, tmp_path_factory):
    """Every rank's results of :func:`_port_rank` (4 gloo ranks)."""
    return _spawn(_port_rank, tmp_path_factory.mktemp("ranks"),
                  str(started[0]))


def _case_id(case):
    return "-".join(case)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_steps_match_the_unsharded_step(ported, case):
    """Each rank's 2 sequence-parallel steps equal the unsharded steps at
    the same remat policy (``_assert_steps_equal``), and its loss saw
    its rows' block of S/m positions, starting at its "model"
    coordinate's offset, in every microbatch and step (the recompute
    reruns no loss)."""
    arch, mesh_name, layout, remat = case
    rows, m = MESHES[mesh_name]
    for rank in ported:
        res, seen, coord = rank[case]
        assert np.isfinite(res[0]).all()
        _assert_steps_equal(res, rank[(arch, remat)])
        s_loc = SEQ // m
        assert seen == [((ROWS // MICRO // rows, s_loc),
                         coord["model"] * s_loc)] * (MICRO * STEPS)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_steps_match_the_reference(reference, ported, case):
    """Each case's losses, gradient norms and gathered params against the
    reference's sequence-parallel step from the same params (at the
    arch's ``REF_SP`` case: every case computes the same function)."""
    for rank in ported:
        _assert_reference(rank[case][0], reference[case[0]])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_unsharded_step_matches_the_reference(reference, ported, arch):
    """The port's unsharded steps (both remat policies), which every case
    is held to above, against the reference's sequence-parallel step: the
    reference computes the unsharded function under the policy."""
    for remat in REMATS:
        _assert_reference(ported[0][(arch, remat)], reference[arch])


REFUSALS = ("ssm", "hybrid", "encdec", "vlm", "moe_sharded",
            "indivisible_sequence", "loss_outside_the_step", "prefill")


@pytest.mark.parametrize("case", REFUSALS)
def test_unsupported_cases_raise(ported, case):
    """Under the policy at model size 4, on every rank: the four families
    whose state, encoder or cross K/V cross the blocks, and the
    expert-parallel MoE, raise ``NotImplementedError`` naming
    "distributed and launch"; a sequence of 30 positions and the loss
    outside the sharded step raise ``ValueError`` stating the condition;
    a prefill raises (the serve path keeps whole sequences).  None falls
    back to the unsplit computation."""
    assert all(rank["refusals"][case] for rank in ported)


@pytest.mark.parametrize("case", sorted(CLAIM_GROUPS))
def test_claim_groups_across_blocks_match_the_unsharded_step(ported, case):
    """Deepseek's claim groups over several ranks' blocks of the sequence
    (the FAA ticket: pieces of each local row's block, whose counts every
    rank gathers): one group over (2, 2), and 2 groups over (1, 4) that
    each span 4 ranks' blocks of 2 rows; 2 sequence-parallel steps equal
    the unsharded steps at the same groups (``_assert_steps_equal``)."""
    for rank in ported:
        got, want = rank["claim_groups"][case]
        assert np.isfinite(got[0]).all()
        _assert_steps_equal(got, want)


def test_trainer_trains_and_restores_under_the_policy(ported):
    """The sharded Trainer (fsdp on (2, 2)) trains 2 steps under the
    policy to the params it reaches without the flag (``STEP_TOL``), and
    each kind restores the other's checkpoint bit for bit, params and
    AdamW state."""
    for rank in ported:
        trained, same = rank["trainers"]
        assert same[True] and same[False]
        for key, leaf in flatten(trained[False]).items():
            torch.testing.assert_close(flatten(trained[True])[key], leaf,
                                       **STEP_TOL, msg=key)


# ------------------------------------------------------------ this process

BLOCK_CASES = {
    # (b, s, hq, hkv, dk, dv): qwen2.5-3b's training heads at a small
    # width, MLA's (Dk, Dv) pair of the reduced config
    "gqa": (2, 64, 8, 2, 16, 16),
    "mla": (2, 64, 4, 4, 24, 16),
}
BLOCKS = 4


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_plain_blocks_equal_one_whole_call(case):
    """K1's and K11's plain versions on each of 4 blocks of queries over
    K/V rows [0, offset + S_loc) (the suffix alignment Skv - Sq is the
    offset): out and lse laid side by side equal the whole call's within
    1e-6 (the masked rows add exact zeros; only the sums' lengths
    differ), so do dq, and the blocks' dk and dv, zero-padded and summed,
    within 1e-5."""
    b, s, hq, hkv, dk, dv = BLOCK_CASES[case]
    rng = np.random.RandomState(7)
    q, k, v, do = (torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
                   for h, d in ((hq, dk), (hkv, dk), (hkv, dv), (hq, dv)))
    out, lse = fa.flash_attention_plain(q, k, v)
    dq, dk_, dv_ = fa.flash_attention_bwd_plain(q, k, v, out, lse, do)
    n = s // BLOCKS
    outs, lses, dqs = [], [], []
    dks, dvs = torch.zeros_like(k), torch.zeros_like(v)
    for c in range(BLOCKS):
        rows, prefix = slice(c * n, (c + 1) * n), slice(0, (c + 1) * n)
        o_c, l_c = fa.flash_attention_plain(q[:, rows], k[:, prefix],
                                            v[:, prefix])
        g = fa.flash_attention_bwd_plain(q[:, rows], k[:, prefix],
                                         v[:, prefix], o_c, l_c, do[:, rows])
        outs.append(o_c)
        lses.append(l_c)
        dqs.append(g[0])
        dks[:, prefix] += g[1]
        dvs[:, prefix] += g[2]
    for got, want in ((torch.cat(outs, 1), out), (torch.cat(lses, 2), lse),
                      (torch.cat(dqs, 1), dq)):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(dks, dk_, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(dvs, dv_, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_one_rank_steps_equal_the_unsharded_bits(one_rank, arch):
    """The design at one rank (what the card's phase 7q (b) runs): the
    model axis has size 1, so the block is the whole sequence, nothing is
    gathered, the loss's scale is 1, and 2 sequence-parallel steps under
    "tp" and "fsdp" equal the unsharded steps bit for bit."""
    mesh = mesh_mod.make_mesh((1, 1), ("data", "model"), device="cpu")
    ocfg = opt.AdamWConfig(**OCFG)
    model = Model(_cfg(arch), device="cpu")
    batches = [{"tokens": torch.from_numpy(t)} for t in _batches(256)]
    want = _train(model, ocfg, batches)
    for layout in LAYOUTS:
        lays = psh.param_shardings(model.init(0), mesh, layout)
        with _sp(mesh, layout):
            got = _train(model, ocfg, batches, layouts=lays)
        assert got[0] == want[0] and got[3] == want[3]
        assert all(torch.equal(a, b) for a, b in zip(
            flatten(got[1]).values(), flatten(want[1]).values()))


def test_policy_needs_a_model_axis():
    """The sequence splits over "model": a mesh without it is refused."""
    with pytest.raises(ValueError, match="splits the sequence over"):
        ShardingPolicy({"data": 4}, seq_parallel=True)
