"""``repro_torch.launch.serve`` (the serving launcher) on the CPU.

* ``--requests 4``: the launcher's tokens equal ``Engine.serve`` on the
  same prompts (the reference launcher's draw) and weights
  (``Model.init(0)``), and the paged cache (16-row pages, and page size
  0: the tuning db's pick) gives the contiguous tokens.
* ``--ckpt-dir`` on a checkpoint the JAX package wrote of its own params
  gives the JAX engine's ``generate`` tokens on the same batch
  (``make_dummy_batch``, greedy, f32).
"""

import numpy as np
import pytest

from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import Model
from repro_torch.serve import Engine, ServeConfig

ARCH = "qwen2.5-3b"
PROMPT, TOKENS, REQUESTS = 12, 6, 4


def _cli(*extra):
    return ["--arch", ARCH, "--reduced", "--device", "cpu",
            "--prompt-len", str(PROMPT), "--tokens", str(TOKENS), *extra]


def _prompts(vocab):
    """The reference launcher's draw of ``REQUESTS`` prompts."""
    rng = np.random.RandomState(0)
    return [rng.randint(1, vocab, int(n)).astype(np.int32)
            for n in rng.randint(max(2, PROMPT // 4), PROMPT + 1, REQUESTS)]


@pytest.fixture(scope="module")
def served():
    """The launcher's contiguous serve and ``Engine.serve`` on its
    prompts, each with its own engine."""
    cfg = get_config(ARCH).reduced()
    model = Model(cfg, device="cpu")
    eng = Engine(model, model.init(0), ServeConfig(
        max_len=PROMPT + TOKENS + 1, slots=4, refill_schedule="faa"))
    want = eng.serve(_prompts(cfg.vocab_size), TOKENS)
    got = launch_serve.main(_cli("--requests", str(REQUESTS)))
    return want, got


def test_requests_equal_engine_serve(served):
    want, got = served
    assert len(got) == REQUESTS
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("page_size", ["16", "0"])
def test_paged_cache_equals_contiguous(served, page_size):
    got = launch_serve.main(_cli("--requests", str(REQUESTS), "--cache",
                                 "paged", "--page-size", page_size))
    assert all(np.array_equal(a, b) for a, b in zip(got, served[0]))


def test_ckpt_dir_reads_the_reference_params(tmp_path):
    import jax
    from repro.checkpoint import checkpoint as jckpt
    from repro.configs import get_config as jax_config
    from repro.configs.inputs import make_dummy_batch
    from repro.models import Model as JaxModel
    from repro.serve.engine import Engine as JaxEngine
    from repro.serve.engine import ServeConfig as JaxServeConfig

    cfg = jax_config(ARCH).reduced()
    model = JaxModel(cfg)
    params = model.init(jax.random.PRNGKey(0))
    jckpt.save({"params": params}, tmp_path, 3)
    eng = JaxEngine(model, params,
                    JaxServeConfig(max_len=PROMPT + TOKENS + 1))
    want = eng.generate(make_dummy_batch(cfg, 2, PROMPT), TOKENS)
    got = launch_serve.main(_cli("--batch", "2", "--ckpt-dir",
                                 str(tmp_path)))
    assert got.shape == (2, TOKENS)
    assert np.array_equal(got, np.asarray(want))
