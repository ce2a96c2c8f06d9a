"""The port's dense model against the JAX package's, on the CPU.

Parameters cross over through the bridge (the JAX tree as numpy arrays,
or the reference's on-disk checkpoint); inputs are made with numpy from a
seed.  Logits are f32 and held to atol = rtol = 1e-4: both sides compute
in f32 and differ in summation order only.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jax_ckpt
from repro.configs import REGISTRY as JAX_REGISTRY
from repro.configs import get_config as jax_config
from repro.models import Model as JaxModel

from repro_torch.checkpoint.bridge import (load_reference_checkpoint,
                                           params_from_numpy)
from repro_torch.configs import REGISTRY, get_config
from repro_torch.models import Model
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as tfm

# one intra-op thread: the tensors here are tiny, and the suite's parallel
# workers share the cores
torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
MAX_LEN = 32
ARCHS = ["qwen2.5-3b", "granite-3-2b"]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(JAX model, JAX params, port model, port params) for one arch."""
    name = request.param
    jm = JaxModel(jax_config(name).reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_config(name).reduced(), device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _tokens(vocab, shape, seed=0):
    return np.random.RandomState(seed).randint(1, vocab, shape).astype(
        np.int32)


def _close(jax_logits, torch_logits):
    np.testing.assert_allclose(torch_logits.numpy(), np.asarray(jax_logits),
                               **TOL)


def test_prefill_and_decode_logits_match_jax(pair):
    jm, jp, tm, tp = pair
    toks = _tokens(jm.cfg.vocab_size, (2, 11))
    jl, jc = jm.prefill(jp, {"tokens": toks}, MAX_LEN, jnp.float32)
    tl, tc = tm.prefill(tp, {"tokens": toks}, MAX_LEN, torch.float32)
    _close(jl, tl)
    for step in range(2):           # scalar-length decode (generate())
        nxt = _tokens(jm.cfg.vocab_size, (2, 1), seed=step + 1)
        jl, jc = jm.decode_step(jp, nxt, jc)
        tl, tc = tm.decode_step(tp, nxt, tc)
        _close(jl, tl)
    assert tc["len"].tolist() == [13] * jm.cfg.n_layers


def test_prefill_padded_and_per_row_decode_match_jax(pair):
    jm, jp, tm, tp = pair
    toks = _tokens(jm.cfg.vocab_size, (3, 16))
    lens = np.array([16, 9, 3], np.int32)
    batch = {"tokens": toks, "lengths": lens}
    jl, jc = jm.prefill_padded(jp, batch, MAX_LEN, jnp.float32)
    tl, tc = tm.prefill_padded(tp, batch, MAX_LEN, torch.float32)
    _close(jl, tl)
    assert tc["len"].shape == (jm.cfg.n_layers, 3)
    for step in range(2):           # per-row decode (the serve tick)
        nxt = _tokens(jm.cfg.vocab_size, (3, 1), seed=step + 5)
        jl, jc = jm.decode_step(jp, nxt, jc)
        tl, tc = tm.decode_step(tp, nxt, tc)
        _close(jl, tl)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


def test_bridge_keeps_reference_layout(pair):
    """Every leaf keeps the JAX shape and values ([d_in, d_out] dense
    weights, no silent transpose).  The reduced configs' q projection is
    square ([64, 64]), so a transpose would pass any shape check; it shows
    in the logits, which parity catches."""
    jm, jp, tm, tp = pair
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    for path, leaf in flat:
        node = tp
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    toks = _tokens(jm.cfg.vocab_size, (1, 7))
    jl, _ = jm.prefill(jp, {"tokens": toks}, MAX_LEN, jnp.float32)
    wq = tp["blocks"]["attn"]["wq"]["w"]
    assert wq.shape[-1] == wq.shape[-2]
    transposed = {**tp, "blocks": {**tp["blocks"], "attn": {
        **tp["blocks"]["attn"],
        "wq": {**tp["blocks"]["attn"]["wq"], "w": wq.transpose(-1, -2)}}}}
    tl, _ = tm.prefill(transposed, {"tokens": toks}, MAX_LEN, torch.float32)
    assert not np.allclose(tl.numpy(), np.asarray(jl), **TOL)
    cast = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu",
                             dtype="bfloat16")
    assert cast["blocks"]["attn"]["wq"]["w"].dtype == torch.bfloat16


def test_load_reference_checkpoint(pair, tmp_path):
    jm, jp, tm, _ = pair
    jax_ckpt.save(jp, tmp_path, step=3)
    params = load_reference_checkpoint(tmp_path, device="cpu")
    toks = _tokens(jm.cfg.vocab_size, (2, 5))
    jl, _ = jm.prefill(jp, {"tokens": toks}, MAX_LEN, jnp.float32)
    tl, _ = tm.prefill(params, {"tokens": toks}, MAX_LEN, torch.float32)
    _close(jl, tl)


def test_init_follows_reference_distributions(pair):
    """Model.init draws the reference's tree: same leaves and shapes,
    zero biases, unit norms, and truncated normals at the reference's
    stddev (|x| <= 2 sigma), reproducibly from the seed."""
    jm, jp, tm, _ = pair
    params = tm.init(seed=3)
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    for path, leaf in flat:
        node = params
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == tuple(leaf.shape), path
    attn = params["blocks"]["attn"]
    if jm.cfg.qkv_bias:
        assert torch.all(attn["wq"]["b"] == 0)
    assert torch.all(params["blocks"]["ln1"]["scale"] == 1)
    for w, sigma in ((params["embed"]["table"], 0.02),
                     (attn["wq"]["w"], 1 / np.sqrt(jm.cfg.d_model)),
                     (params["blocks"]["mlp"]["down"]["w"],
                      1 / np.sqrt(jm.cfg.d_ff))):
        assert w.abs().max() <= 2 * sigma + 1e-6
        # a standard normal truncated at +-2 has std 0.8796
        assert abs(w.std().item() / (0.8796 * sigma) - 1) < 0.05
    assert torch.equal(tm.init(seed=3)["head"]["w"], params["head"]["w"])
    assert not torch.equal(tm.init(seed=4)["head"]["w"], params["head"]["w"])


# ------------------------------------------------------------- cache ops

def test_cache_batch_axes_match_reference(pair):
    jm, _, tm, _ = pair
    for per_row in (True, False):
        got = tm.cache_batch_axes(per_row_len=per_row)
        want = jm.cache_batch_axes(per_row_len=per_row)
        assert got == dict(want)


def test_splice_row_beyond_zero_matches_direct_decode(pair):
    """Splice row 2 of a batch-of-3 prefill cache into slot 1 of a serve
    cache: slot 1 equals the source's row 2, and a decode step from it
    equals decoding row 2 of the prefill cache directly."""
    jm, _, tm, tp = pair
    vocab = jm.cfg.vocab_size
    toks = _tokens(vocab, (3, 16))
    lens = np.array([7, 4, 9], np.int32)
    _, pcache = tm.prefill_padded(tp, {"tokens": toks, "lengths": lens},
                                  MAX_LEN, torch.float32)
    serve = tm.set_cache_lengths(tm.init_cache(2, MAX_LEN, torch.float32),
                                 np.zeros(2, np.int32))
    serve = tm.splice_cache(serve, pcache, 1, axes=tm.cache_batch_axes(),
                            row=2)
    for key in ("k", "v", "len"):
        assert torch.equal(serve[key][:, 1], pcache[key][:, 2])
    tok = _tokens(vocab, (3, 1), seed=9)
    ref, _ = tm.decode_step(tp, tok, pcache)
    got, _ = tm.decode_step(tp, np.array([[1], [tok[2, 0]]], np.int32),
                            serve)
    torch.testing.assert_close(got[1], ref[2], rtol=0, atol=1e-6)


def test_splice_scalar_len_leaves_destination_untouched(pair):
    jm, _, tm, tp = pair
    toks = _tokens(jm.cfg.vocab_size, (2, 6), seed=1)
    _, pcache = tm.prefill(tp, {"tokens": toks}, MAX_LEN, torch.float32)
    dst = tm.init_cache(3, MAX_LEN, torch.float32)
    before = dst["len"].clone()
    out = tm.splice_cache(dst, pcache, 2,
                          axes=tm.cache_batch_axes(per_row_len=False), row=1)
    assert torch.equal(out["len"], before)
    assert torch.equal(out["k"][:, 2], pcache["k"][:, 1])


def test_per_row_write_clamps_at_the_cache_end():
    """An idle serve slot's length runs past max_len; the write lands on
    the last row (the reference's dynamic_update_slice clamp) instead of
    indexing out of range, and attention reads the whole cache."""
    cfg = get_config("qwen2.5-3b").reduced()
    ac = tfm.attn_cfg(cfg)
    p = tfm.layer(Model(cfg, device="cpu").init(0)["blocks"], 0)["attn"]
    cache = attn_mod.init_kv_cache(ac, 2, 8, torch.float32, device="cpu")
    cache["len"] = torch.tensor([8, 30], dtype=torch.int32)
    x = torch.randn(2, 1, cfg.d_model, generator=torch.Generator().manual_seed(0))
    out, new = attn_mod.attn_apply(p, ac, x, cache=cache)
    assert torch.isfinite(out).all()
    assert new["len"].tolist() == [9, 31]
    assert torch.count_nonzero(new["k"][:, :7]) == 0
    assert torch.count_nonzero(new["k"][:, 7]) > 0


# --------------------------------------------------- configs and imports

def test_config_registry_matches_reference():
    assert list(REGISTRY) == list(JAX_REGISTRY)
    for name, cfg in REGISTRY.items():
        ref = JAX_REGISTRY[name]
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
        assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(
            ref.reduced())
        assert cfg.param_count() == ref.param_count()
        assert cfg.dtype == torch.float32
    assert get_config("qwen2.5-3b").with_dtype("bfloat16").dtype == \
        torch.bfloat16


def test_port_imports_neither_jax_nor_the_reference():
    """Every repro_torch module imports with jax and repro blocked."""
    src = Path(__file__).resolve().parents[1] / "src"
    modules = sorted(
        ".".join(p.relative_to(src).with_suffix("").parts).replace(
            ".__init__", "")
        for p in (src / "repro_torch").rglob("*.py"))
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"sys.path.insert(0, {str(src)!r})\n"
            "import importlib\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
            "               for k, v in sys.modules.items() if v is not None)\n"
            "print(len(" f"{modules!r}" "))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) == len(modules) > 20
