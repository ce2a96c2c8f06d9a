"""The port's encoder-decoder (seamless-m4t-large-v2) and vision
(llama-3.2-vision-11b) families against the JAX package, on the CPU.

Reduced f32 configs (head dim 16; 2 encoder + 2 decoder layers; 2 groups
of 1 self block + 1 gated cross block over 16 patch rows), parameters
from the JAX package's ``Model.init`` carried over by
``params_from_numpy``, inputs from both packages' ``make_dummy_batch``.
The vision family's cross gates start at 0, so a fresh cross block adds
exactly nothing (tanh(0) = 0): every comparison here sets them to 0.5 in
the parameters given to both packages, and checks that the patches (and
the frames) move the logits.

Blocks (``cross_block_apply`` with and without a cache,
``_enc_block_apply``, ``_encdec_block_apply``), prefill logits, every
cache leaf and 4 decode steps' logits are held to the reference within
1e-4 (summation order only); greedy and temperature-0.8
``generate(seed, rids)`` tokens are equal.  The refusals: ``serve()``
(token-only families), ``generate(lengths=...)`` (ROADMAP R8: the
reference's pad-masked prefill drops the modal input), a quantized cache
and ``loss`` without the modal input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.inputs import make_dummy_batch as jax_dummy_batch
from repro.models import Model as JaxModel
from repro.models import transformer as jtfm
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import ServeConfig as JaxServeConfig

from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.configs import get_config
from repro_torch.configs.inputs import make_dummy_batch
from repro_torch.kernels import quant
from repro_torch.models import Model
from repro_torch.models import transformer as tfm
from repro_torch.serve import Engine, ServeConfig

# one intra-op thread: the tensors here are tiny, and the suite's parallel
# workers share the cores
torch.set_num_threads(1)

ARCHS = ["seamless-m4t-large-v2", "llama-3.2-vision-11b"]
VLM, ENCDEC = ARCHS[1], ARCHS[0]
TOL = dict(atol=1e-4, rtol=1e-4)
GATE = 0.5
MAX_LEN = 48
PROMPT = 16
TEMP = 0.8


def _np(t) -> np.ndarray:
    return t.float().numpy()


def _gated(jp):
    """The JAX params with the vision family's cross gates at ``GATE``."""
    if "groups" not in jp:
        return jp
    cross = dict(jp["groups"]["cross"])
    for name in ("gate_attn", "gate_mlp"):
        cross[name] = jnp.full_like(cross[name], GATE)
    return dict(jp, groups=dict(jp["groups"], cross=cross))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(JAX model, JAX params, port model, port params, arch)."""
    arch = request.param
    jm = JaxModel(jax_config(arch).reduced())
    jp = _gated(jm.init(jax.random.PRNGKey(0)))
    tm = Model(get_config(arch).reduced(), device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp, arch


def _batches(arch, batch=2, seq=PROMPT, seed=0):
    """The same inputs for both packages (JAX arrays, port tensors)."""
    return (jax_dummy_batch(jax_config(arch).reduced(), batch, seq, seed),
            make_dummy_batch(get_config(arch).reduced(), batch, seq, seed,
                             device="cpu"))


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# -------------------------------------------------------------- inputs

@pytest.mark.parametrize("arch", ARCHS + ["qwen2.5-3b"])
@pytest.mark.parametrize("seq", [1, 16, 23])
def test_make_dummy_batch_equals_reference(arch, seq):
    jb, tb = _batches(arch, batch=3, seq=seq, seed=7)
    assert set(tb) == set(jb)
    for key, want in jb.items():
        got = tb[key]
        assert tuple(got.shape) == want.shape, key
        assert str(got.dtype).split(".")[-1] == want.dtype.name, key
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_make_dummy_batch_defaults_to_the_card_and_casts():
    cfg = get_config(VLM).reduced().with_dtype("bfloat16")
    out = make_dummy_batch(cfg, 1, 4, device="meta")
    assert out["patches"].dtype == torch.bfloat16
    assert out["patches"].shape == (1, cfg.vision_seq, cfg.d_model)
    assert make_dummy_batch.__kwdefaults__["device"] == "cuda"


# ------------------------------------------------------- init and bridge

@pytest.mark.parametrize("arch", ARCHS)
def test_init_follows_reference_tree(arch):
    """``Model.init`` draws the reference's tree: enc_blocks [L_enc],
    dec_blocks [L], enc_ln; or groups.self [G, spg] and groups.cross [G]
    with the gates stacked to [G] and 0 at init."""
    jp = JaxModel(jax_config(arch).reduced()).init(jax.random.PRNGKey(0))
    params = Model(get_config(arch).reduced(), device="cpu").init(seed=3)
    want = flatten(jax.tree.map(np.asarray, jp))
    got = flatten(params)
    assert set(got) == set(want)
    for path, leaf in want.items():
        assert tuple(got[path].shape) == leaf.shape, path
        assert str(got[path].dtype).split(".")[-1] == leaf.dtype.name, path
    if "groups" in params:
        g = get_config(arch).reduced().cross_attn_groups
        for name in ("gate_attn", "gate_mlp"):
            assert params["groups"]["cross"][name].shape == (g,)
            assert not params["groups"]["cross"][name].any()


def test_bridge_carries_the_new_trees(pair):
    """enc_blocks, dec_blocks, enc_ln, groups.self, groups.cross and the
    [G] gates cross over leaf for leaf; a bf16 cast casts the gates
    too."""
    jm, jp, _, tp, arch = pair
    tops = {"enc_blocks", "dec_blocks", "enc_ln"} if arch == ENCDEC else {
        "groups"}
    assert tops <= set(tp)
    got = flatten(tp)
    for path, leaf in flatten(jax.tree.map(np.asarray, jp)).items():
        np.testing.assert_array_equal(got[path].numpy(), leaf)
    cast = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu",
                             dtype="bfloat16")
    assert all(t.dtype == torch.bfloat16 for t in flatten(cast).values())
    if arch == VLM:
        assert float(cast["groups"]["cross"]["gate_attn"][1]) == GATE


# --------------------------------------------------------------- blocks

def test_cross_block_apply_matches_reference_with_and_without_cache():
    """Group 0's gated cross block: no cache; a cache written from the
    patches (prefill: the cast K/V land in it in place); the same cache
    read back with no patches (a decode tick)."""
    jm = JaxModel(jax_config(VLM).reduced())
    jp = _gated(jm.init(jax.random.PRNGKey(1)))
    jcp = jax.tree.map(lambda a: a[0], jp["groups"]["cross"])
    cfg = get_config(VLM).reduced()
    tcp = params_from_numpy(jax.tree.map(np.asarray, jcp), device="cpu")
    x, enc = _rand(0, 2, 5, cfg.d_model), _rand(1, 2, cfg.vision_seq,
                                                 cfg.d_model)
    want, _, _ = jtfm.cross_block_apply(jcp, jm.cfg, jnp.asarray(x),
                                        jnp.asarray(enc))
    got, none = tfm.cross_block_apply(tcp, cfg, torch.from_numpy(x),
                                      torch.from_numpy(enc))
    assert none is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    shape = (2, cfg.vision_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
    jcache = {"ck": jnp.zeros(shape), "cv": jnp.zeros(shape)}
    cache = {"ck": torch.zeros(shape), "cv": torch.zeros(shape)}
    want, jcache, _ = jtfm.cross_block_apply(
        jcp, jm.cfg, jnp.asarray(x), jnp.asarray(enc), cache=jcache)
    got, new = tfm.cross_block_apply(tcp, cfg, torch.from_numpy(x),
                                     torch.from_numpy(enc), cache=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in ("ck", "cv"):
        assert new[name] is cache[name]
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), **TOL)
    x1 = _rand(2, 2, 1, cfg.d_model)
    want, _, _ = jtfm.cross_block_apply(jcp, jm.cfg, jnp.asarray(x1), None,
                                        cache=jcache)
    got, _ = tfm.cross_block_apply(tcp, cfg, torch.from_numpy(x1), None,
                                   cache=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="do not fit"):
        tfm.cross_block_apply(tcp, cfg, torch.from_numpy(x),
                              torch.from_numpy(enc[:, :3]), cache=cache)


def _encdec_pair():
    jm = JaxModel(jax_config(ENCDEC).reduced())
    jp = jm.init(jax.random.PRNGKey(2))
    tm = Model(get_config(ENCDEC).reduced(), device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def test_enc_block_apply_matches_reference():
    jm, jp, tm, tp = _encdec_pair()
    jb = jax.tree.map(lambda a: a[1], jp["enc_blocks"])
    tb = jax.tree.map(lambda t: t[1], tp["enc_blocks"])
    x = _rand(3, 2, 12, tm.cfg.d_model)
    want = jm._enc_block_apply(jb, jm.cfg, jnp.asarray(x))
    got = tm._enc_block_apply(tb, tm.cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_encdec_block_apply_matches_reference():
    """Decoder layer 0 without a cache, then prefilling a cache from the
    encoder output and two decode steps reading the cross K/V back."""
    jm, jp, tm, tp = _encdec_pair()
    jb = jax.tree.map(lambda a: a[0], jp["dec_blocks"])
    tb = jax.tree.map(lambda t: t[0], tp["dec_blocks"])
    d, s_enc = tm.cfg.d_model, 6
    x, enc = _rand(4, 2, 7, d), _rand(5, 2, s_enc, d)
    want, _, _ = jm._encdec_block_apply(jb, jnp.asarray(x), jnp.asarray(enc))
    got, none = tm._encdec_block_apply(tb, torch.from_numpy(x),
                                       torch.from_numpy(enc))
    assert none is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jc = jax.tree.map(lambda a: a[0], jm.init_cache(2, 16, jnp.float32,
                                                    enc_len=s_enc))
    tc = tfm.layer(tm.init_cache(2, 16, torch.float32, enc_len=s_enc), 0)
    want, jc, _ = jm._encdec_block_apply(jb, jnp.asarray(x),
                                         jnp.asarray(enc), cache=jc)
    got, tc = tm._encdec_block_apply(tb, torch.from_numpy(x),
                                     torch.from_numpy(enc), cache=tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for step in range(2):
        x1 = _rand(6 + step, 2, 1, d)
        want, jc, _ = jm._encdec_block_apply(jb, jnp.asarray(x1), None,
                                             cache=jc)
        got, tc = tm._encdec_block_apply(tb, torch.from_numpy(x1), None,
                                         cache=tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got = flatten(tc)
    for path, leaf in flatten(jax.tree.map(np.asarray, jc)).items():
        np.testing.assert_allclose(_np(got[path]),
                                   leaf.astype(np.float32), err_msg=str(path),
                                   **TOL)


# ---------------------------------------------------------------- model

def test_prefill_and_decode_match_reference(pair):
    """Prefill logits, every cache leaf after the prefill and after 4
    decode steps, and the steps' logits."""
    jm, jp, tm, tp, arch = pair
    jb, tb = _batches(arch)
    jl, jc = jm.prefill(jp, jb, MAX_LEN, jnp.float32)
    tl, tc = tm.prefill(tp, tb, MAX_LEN, torch.float32)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    for step in range(5):
        want = flatten(jax.tree.map(np.asarray, jc))
        got = flatten(tc)
        assert set(got) == set(want)
        for path, leaf in want.items():
            assert tuple(got[path].shape) == leaf.shape, path
            np.testing.assert_allclose(_np(got[path]),
                                       leaf.astype(np.float32),
                                       err_msg=f"{path} step {step}", **TOL)
        if step == 4:
            break
        nxt = np.random.RandomState(step).randint(1, 256, (2, 1)).astype(
            np.int32)
        jl, jc = jm.decode_step(jp, nxt, jc)
        tl, tc = tm.decode_step(tp, nxt, tc)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)


def test_modal_input_moves_the_logits(pair):
    """With the gates at 0.5, zeroing the patches (or the frames) moves
    the first-token logits: the cross path is live."""
    _, _, tm, tp, arch = pair
    _, tb = _batches(arch)
    key = "patches" if arch == VLM else "frames"
    logits, _ = tm.prefill(tp, tb, MAX_LEN, torch.float32)
    zeroed, _ = tm.prefill(tp, dict(tb, **{key: torch.zeros_like(tb[key])}),
                           MAX_LEN, torch.float32)
    moved = (logits - zeroed).abs().max() / logits.abs().max()
    assert moved > 1e-2


def test_vlm_prefill_without_patches_matches_reference():
    """No patches: both packages attend over the all-zero cross cache."""
    jm = JaxModel(jax_config(VLM).reduced())
    jp = _gated(jm.init(jax.random.PRNGKey(0)))
    tm = Model(get_config(VLM).reduced(), device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jb, tb = _batches(VLM)
    jl, jc = jm.prefill(jp, {"tokens": jb["tokens"]}, MAX_LEN, jnp.float32)
    tl, tc = tm.prefill(tp, {"tokens": tb["tokens"]}, MAX_LEN, torch.float32)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    assert not tc["cross"]["ck"].any() and not tc["cross"]["cv"].any()
    with_patches, _ = tm.prefill(tp, tb, MAX_LEN, torch.float32)
    assert not torch.allclose(tl, with_patches)


def test_encdec_cache_is_sized_by_the_frames():
    _, _, tm, tp = _encdec_pair()
    _, tb = _batches(ENCDEC, seq=24)
    _, cache = tm.prefill(tp, tb, MAX_LEN, torch.float32)
    assert cache["ck"].shape[2] == 24 // tm.cfg.encoder_downsample
    assert tm.init_cache(1, MAX_LEN, torch.float32)["ck"].shape[2] == (
        MAX_LEN // tm.cfg.encoder_downsample)
    with pytest.raises(ValueError, match="needs batch\\['frames'\\]"):
        tm.prefill(tp, {"tokens": tb["tokens"]}, MAX_LEN, torch.float32)


# ------------------------------------------------------------- generate

@pytest.mark.parametrize("temperature", [0.0, TEMP])
def test_generate_tokens_equal_reference(pair, temperature):
    """6 new tokens greedy, and at temperature 0.8 with request ids (the
    sampler re-creates JAX's draws); a ``live`` mask keeps its row at
    eos."""
    jm, jp, tm, tp, arch = pair
    jb, tb = _batches(arch, batch=3, seed=4)
    kw = dict(max_len=MAX_LEN, temperature=temperature, eos_id=-1)
    rids = [5, 1, 9]
    want = JaxEngine(jm, jp, JaxServeConfig(**kw)).generate(
        jb, 6, seed=2, rids=rids, live=np.array([True, False, True]))
    got = Engine(tm, tp, ServeConfig(**kw)).generate(
        tb, 6, seed=2, rids=rids, live=np.array([True, False, True]))
    np.testing.assert_array_equal(got, want)
    assert (got[1] == -1).all() and (got[[0, 2]] >= 0).all()


def test_temperature_generate_depends_on_rid_not_row(pair):
    """A row's draws follow its request id: one row alone with its rid
    gives the tokens it got in the batch."""
    _, _, tm, tp, arch = pair
    _, tb = _batches(arch, batch=2, seed=6)
    eng = Engine(tm, tp, ServeConfig(max_len=MAX_LEN, temperature=TEMP))
    both = eng.generate(tb, 5, seed=1, rids=[3, 8])
    solo = eng.generate({k: v[1:] for k, v in tb.items()}, 5, seed=1,
                        rids=[8])
    np.testing.assert_array_equal(solo[0], both[1])


# -------------------------------------------------------------- refusals

def test_serve_refuses_modal_families(pair):
    _, _, tm, tp, arch = pair
    eng = Engine(tm, tp, ServeConfig(max_len=MAX_LEN))
    with pytest.raises(ValueError, match="needs modal inputs"):
        eng.serve([np.arange(1, 5, dtype=np.int32)], 2)


def test_generate_with_lengths_refuses_r8(pair):
    """The reference's pad-masked prefill passes only tokens and lengths:
    KeyError for the frames, the patches silently dropped (R8).  The port
    raises for both."""
    jm, jp, tm, tp, arch = pair
    jb, tb = _batches(arch)
    if arch == ENCDEC:
        with pytest.raises(KeyError, match="frames"):
            JaxEngine(jm, jp, JaxServeConfig(max_len=MAX_LEN)).generate(
                jb, 2, lengths=np.array([PROMPT, 9]))
    eng = Engine(tm, tp, ServeConfig(max_len=MAX_LEN))
    with pytest.raises(ValueError, match="R8"):
        eng.generate(tb, 2, lengths=np.array([PROMPT, 9]))
    with pytest.raises(ValueError, match="R8"):
        tm.prefill_padded(tp, dict(tb, lengths=np.array([PROMPT, 9])),
                          MAX_LEN)


@pytest.mark.parametrize("kv_dtype", quant.quant_dtypes())
def test_quantized_cache_refuses(pair, kv_dtype):
    jm, _, tm, tp, arch = pair
    with pytest.raises(ValueError) as want:
        jm.init_cache(2, MAX_LEN, getattr(jnp, kv_dtype))
    with pytest.raises(ValueError) as got:
        tm.init_cache(2, MAX_LEN, kv_dtype)
    assert str(got.value) == str(want.value)
    _, tb = _batches(arch)
    eng = Engine(tm, tp, ServeConfig(max_len=MAX_LEN, kv_dtype=kv_dtype))
    with pytest.raises(ValueError, match="latent/cross caches"):
        eng.generate(tb, 2)


def test_loss_refuses(pair):
    """Without its frames or patches the family refuses to train (the
    reference dies there on a None); with them it trains
    (tests/test_torch_train_families.py holds the loss and gradients to
    the reference)."""
    _, _, tm, tp, arch = pair
    _, tb = _batches(arch)
    key = "patches" if tm.cfg.family == "vlm" else "frames"
    with pytest.raises(ValueError, match=f"needs batch\\['{key}'\\]"):
        tm.loss(tp, {"tokens": tb["tokens"]})
    loss, _ = tm.loss(tp, tb)
    assert bool(torch.isfinite(loss))


def test_serve_hooks_are_off(pair):
    """No paged cache, prefix sharing, speculation or pad-safe prefill, as
    in the reference."""
    jm, _, tm, _, _ = pair
    for hook in ("pad_safe_prefill", "supports_paged_kv", "prefix_shareable",
                 "supports_speculation"):
        assert getattr(tm, hook) is False is getattr(jm, hook), hook
    with pytest.raises(ValueError, match="no paged"):
        tm.init_paged_cache(2, MAX_LEN, 8, 8)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_configs_build(arch):
    """The full-width configurations build (their weights are drawn only
    on the card: 2.03 B and 9.77 B parameters)."""
    cfg = get_config(arch)
    model = Model(cfg, device="cpu")
    assert model.cfg.family in ("encdec", "vlm")
    cache = model.init_cache(1, 64, torch.bfloat16, device="meta")
    if arch == VLM:
        assert cache["cross"]["ck"].shape == (8, 1, 1601, 8, 128)
        assert cache["self"]["k"].shape == (8, 4, 1, 64, 8, 128)
    else:
        assert cache["ck"].shape == (24, 1, 16, 16, 64)
        assert cache["self"]["len"].shape == (24,)
