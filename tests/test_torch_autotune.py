"""The port's measured autotuner against the JAX package's
(``repro.core.autotune`` / ``repro.core.autotune_search``).

On the same inputs: ``fit_block`` and ``fit_buffer_depth`` give the
reference's answers; the versioned artifact envelope written by either
package loads in the other; ``run_search`` fed the same fixed timings
(``time_runner`` replaced in both packages) walks to the same winner,
trials and ``n_timed``; ``fmt_items``, ``_dedupe`` and ``_with_classic``
agree.  Within the port: the db merges the buckets two instances
measured, a warm reload resolves with zero measurements,
``REPRO_TUNING=off`` ignores a warm db, a corrupt or foreign db loads
empty, the buckets key on ``page_size``, ``dv`` and ``rows``, the analytic
pick is what the kernels ran before the search existed (depth 1,
``num_splits()``, page size 16), every candidate's ring fits the 227 KB a
block may use, and ``launch.tune --quick --no-persist --device cpu`` runs.
The searches here time the plain versions on the CPU: their timings mean
nothing, and every property checked is count- and structure-based.
"""

import json

import pytest
import torch

from repro.core import autotune as jax_autotune
from repro.core import autotune_search as jax_search
from repro.core.autotune_search import kernels as jax_kernels
from repro.core.autotune_search import search as jax_search_mod
from repro.core.runtime import artifacts as jax_artifacts

from repro_torch.core import autotune, autotune_search
from repro_torch.core.autotune_search import kernels as kernels_mod
from repro_torch.core.autotune_search import search as search_mod
from repro_torch.core.runtime import artifacts
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.launch import tune

torch.set_num_threads(1)

FAST = autotune_search.SearchOptions(top_k=3, warmup=0, reps=1)
QUICK = {k: v[0] for k, v in autotune_search.QUICK_SHAPES.items()}


@pytest.fixture
def db_path(tmp_path, monkeypatch):
    """An isolated persistent db in search mode; the process view reset
    around the test."""
    path = tmp_path / "tuning_db_torch.json"
    monkeypatch.setenv("REPRO_TUNING", "search")
    monkeypatch.setenv("REPRO_TORCH_TUNING_DB", str(path))
    autotune_search.reset_db()
    yield path
    autotune_search.reset_db()


# ----------------------------------------------------- against the reference

@pytest.mark.parametrize("n,target", [
    (96, 128), (96, 64), (100, 32), (100, 128), (128, 32), (7, 4), (1, 512),
    (1024, 9), (488, 16), (48, 0), (0, 5), (360, 7),
])
def test_fit_block_equals_reference(n, target):
    assert autotune.fit_block(n, target) == jax_autotune.fit_block(n, target)


@pytest.mark.parametrize("depth,block,limit,base", [
    (4, 1024, 8192, 0), (4, 1024, 3 * 1024, 0), (4, 1024, 8192, 6 * 1024),
    (4, 1024, 1, 0), (1, 10 ** 9, 1, 0), (8, 70_400, 232_448, 39_488),
    (3, 100, 250, 0), (0, 5, 100, 0),
])
def test_fit_buffer_depth_equals_reference(depth, block, limit, base):
    assert autotune.fit_buffer_depth(
        depth, block, smem_limit=limit, base_bytes=base) == \
        jax_autotune.fit_buffer_depth(depth, block, vmem_limit=limit,
                                      base_bytes=base)


@pytest.mark.parametrize("writer,reader", [
    (artifacts, jax_artifacts), (jax_artifacts, artifacts)])
def test_artifact_envelope_loads_both_ways(tmp_path, writer, reader):
    path = tmp_path / "a.json"
    payload = {"entries": {"k": {"config": {"num_buffers": 2}}}}
    writer.save_artifact(path, kind="x", version=3, payload=payload)
    assert reader.load_artifact(path, kind="x", version=3) == payload
    assert reader.load_artifact(path, kind="x", version=2) is None
    assert reader.load_artifact(path, kind="y", version=3) is None
    assert not list(tmp_path.glob(".*.tmp"))     # the write was atomic


@pytest.mark.parametrize("times", [
    [3.0, 2.0, 1.0, 1.5, 1.6, 0.5],   # early stop before the best
    [1.0, 2.0, 3.0, 4.0, 5.0, 6.0],   # the prior's pick wins throughout
    [5.0, 4.0, 4.2, 4.3, 4.4, 4.5],   # no margin: walks everything
    [2.0, 2.0, 1.0, 1.0, 3.0, 0.1],
])
@pytest.mark.parametrize("top_k", [1, 3, 8])
def test_run_search_walks_as_the_reference(monkeypatch, times, top_k):
    """The same candidates and the same fixed timings give the reference's
    winner, trials and timed count, early stop and slot-2 floor included."""
    cands = [{"num_buffers": nb, "num_splits": ns}
             for nb, ns in ((4, 1), (1, 9), (2, 1), (4, 2), (2, 4), (1, 16))]
    table = {autotune_search.fmt_items(c): t for c, t in zip(cands, times)}
    opts = dict(top_k=top_k, warmup=0, reps=2, margin=0.1, patience=2)

    def fake(bump):
        def time_runner(cfg, *, warmup, reps):
            for _ in range(reps):
                bump()
            return table[autotune_search.fmt_items(cfg)]
        return time_runner

    monkeypatch.setattr(search_mod, "time_runner", fake(search_mod._bump))
    monkeypatch.setattr(jax_search_mod, "time_runner",
                        fake(jax_search_mod._bump))
    got = search_mod.run_search(
        kernel="k", backend="b", bucket="x", candidates=cands,
        make_runner=lambda c: c,
        options=autotune_search.SearchOptions(**opts))
    want = jax_search_mod.run_search(
        kernel="k", backend="b", bucket="x", candidates=cands,
        make_runner=lambda c: c, options=jax_search.SearchOptions(**opts))
    assert got.config == want.config
    assert (got.measured_s, got.analytic_s) == (want.measured_s,
                                                want.analytic_s)
    assert got.analytic_config == want.analytic_config
    assert got.n_timed == want.n_timed > 0
    assert [(t.config, t.median_s) for t in got.trials] == \
        [(t.config, t.median_s) for t in want.trials]


def test_candidate_helpers_equal_reference():
    cands = [{"a": 1}, {"a": 2}, {"a": 1}, {"a": 3, "b": 0}]
    classic = {"a": 3, "b": 0}
    assert kernels_mod._dedupe(cands) == jax_kernels._dedupe(cands)
    for c in (cands, cands[1:], [classic], []):
        assert kernels_mod._with_classic(c, classic) == \
            jax_kernels._with_classic(c, classic)
    d = {"s": 1024, "dtype": "int8", "page_size": 0}
    assert autotune_search.fmt_items(d) == jax_search.fmt_items(d)


# ----------------------------------------------------------- the database

def test_db_merges_buckets_two_instances_measured(tmp_path):
    path = tmp_path / "db.json"
    a = autotune_search.TuningDB.open(path)
    b = autotune_search.TuningDB.open(path)
    a.record("flash_attention", "cpu", "x=1", {"num_buffers": 2},
             measured_s=1.0)
    b.record("decode_attention", "cpu", "y=1",
             {"num_splits": 8, "num_buffers": 1}, measured_s=2.0)
    merged = autotune_search.TuningDB.open(path)
    assert len(merged) == 2
    assert merged.lookup("flash_attention", "cpu", "x=1") == {
        "num_buffers": 2}
    assert merged.lookup("decode_attention", "cpu", "y=1")["num_splits"] == 8
    raw = json.loads(path.read_text())
    assert (raw["kind"], raw["version"]) == (
        autotune_search.TUNING_DB_KIND, autotune_search.TUNING_DB_VERSION)
    # a second record by `a` keeps b's bucket (merge, not snapshot)
    a.record("flash_attention", "cpu", "x=2", {"num_buffers": 4})
    assert len(autotune_search.TuningDB.open(path)) == 3


def test_corrupt_or_foreign_db_loads_empty(tmp_path):
    path = tmp_path / "db.json"
    path.write_text("{not json")
    assert len(autotune_search.TuningDB.open(path)) == 0
    # the JAX package's db (another kind) is foreign to the port, and the
    # port's to the JAX package
    jax_db = jax_search.TuningDB(path)
    jax_db.record("flash_attention", "cpu", "x=1", {"num_buffers": 2})
    assert len(autotune_search.TuningDB.open(path)) == 0
    port_db = autotune_search.TuningDB(tmp_path / "port.json")
    port_db.record("flash_attention", "cpu", "x=1", {"num_buffers": 2})
    assert len(jax_search.TuningDB.open(tmp_path / "port.json")) == 0


def test_search_persists_and_warm_reload_measures_nothing(db_path):
    cfg = autotune_search.lookup_or_search(
        "decode_attention", options=FAST, device="cpu",
        **QUICK["decode_attention"])
    assert set(cfg) == {"num_splits", "num_buffers"}
    assert autotune_search.measurement_count() > 0
    raw = json.loads(db_path.read_text())
    (entry,) = raw["payload"]["entries"].values()
    assert entry["config"] == cfg and entry["n_timed"] > 0
    assert entry["measured_s"] <= entry["analytic_s"]
    autotune_search.reset_db()              # a "new process" over the file
    before = autotune_search.measurement_count()
    again = autotune_search.lookup_or_search(
        "decode_attention", options=FAST, device="cpu",
        **QUICK["decode_attention"])
    assert again == cfg
    assert autotune_search.measurement_count() == before


def test_warm_db_resolves_every_kernel_with_zero_measurements(db_path):
    for kernel, shape in QUICK.items():
        autotune_search.search_kernel(kernel, options=FAST, device="cpu",
                                      **shape)
    autotune_search.reset_db()
    before = autotune_search.measurement_count()
    for kernel, shape in QUICK.items():
        assert autotune_search.lookup_or_search(
            kernel, options=FAST, device="cpu", **shape)
    assert autotune_search.measurement_count() == before


def test_tuning_off_ignores_a_warm_db(db_path, monkeypatch):
    shape = dict(s=1024, d=128, dtype="bfloat16", rows=16)
    spec = autotune_search.SPECS["decode_attention"]
    autotune_search.get_db().record(
        "decode_attention", "cpu", spec.bucket_key(spec.bucket(**shape)),
        {"num_splits": 2, "num_buffers": 4})
    monkeypatch.setenv("REPRO_TUNING", "on")
    assert autotune_search.lookup_or_search(
        "decode_attention", device="cpu", **shape) == {
        "num_splits": 2, "num_buffers": 4}
    monkeypatch.setenv("REPRO_TUNING", "off")
    before = autotune_search.measurement_count()
    assert autotune_search.lookup_or_search(
        "decode_attention", device="cpu", **shape) == {
        "num_splits": da.num_splits(8, 2, 1024, autotune.sm_count()),
        "num_buffers": 1}
    assert autotune_search.measurement_count() == before


def test_buckets_key_on_page_size_dv_and_rows():
    paged = autotune_search.SPECS["paged_decode_attention"]
    decode = autotune_search.SPECS["decode_attention"]
    flash = autotune_search.SPECS["flash_attention"]
    base = dict(s=1024, page_size=16, d=128, dtype="bfloat16", rows=16)

    def key(spec, **kw):
        return spec.bucket_key(spec.bucket(**kw))

    k0 = key(paged, **base)
    assert key(paged, **dict(base, page_size=32)) != k0
    assert key(paged, **dict(base, page_size=0)) != k0     # the open bucket
    assert key(paged, **dict(base, rows=4)) != k0
    assert key(paged, **dict(base, dv=64)) != k0
    assert key(paged, **dict(base, rows=13)) == k0          # pow2 of B * Hkv
    assert key(paged, **dict(base, dtype="int8")) != k0
    d0 = key(decode, s=1024, d=576, dv=512, dtype="bfloat16", rows=8)
    assert d0 != key(decode, s=1024, d=576, dtype="bfloat16", rows=8)
    assert d0 != key(decode, s=1024, d=576, dv=512, dtype="bfloat16",
                     rows=16)
    assert key(flash, sq=488, skv=488, d=192, dv=128, dtype="bfloat16") != \
        key(flash, sq=488, skv=488, d=192, dtype="bfloat16")
    with pytest.raises(ValueError, match="dtype"):
        decode.bucket_key({"s": 8})


@pytest.mark.parametrize("b,hkv,s", [
    (8, 2, 1024), (1, 2, 1024), (3, 8, 300), (8, 1, 1024), (1, 1, 48),
    (64, 8, 4096), (5, 2, 64),
])
def test_analytic_pick_is_what_ran_before(b, hkv, s):
    """A cache miss (and REPRO_TUNING=off) runs exactly the pre-search
    kernels: depth 1, the classic split count, page size min(16, s), the
    64 x 64 bf16 flash tile."""
    sms = autotune.sm_count()
    want = max(1, min(-(-sms // (b * hkv)), s // 64))   # the classic rule
    assert da.num_splits(b, hkv, s, sms) == want
    assert autotune_search.analytic_config(
        "decode_attention", s=s, d=128, dv=128, dtype="bfloat16",
        rows=b * hkv) == {"num_splits": want, "num_buffers": 1}
    assert autotune_search.analytic_config(
        "decode_attention", s=s, d=128, dtype="int8", rows=b * hkv) == {
        "num_splits": want, "num_buffers": 1}
    assert autotune_search.analytic_config(
        "paged_decode_attention", s=s, page_size=16, d=128, dtype="int8",
        rows=b * hkv) == {"num_buffers": 1}
    assert autotune_search.analytic_config(
        "paged_decode_attention", s=s, page_size=0, d=128, dtype="bfloat16",
        rows=b * hkv) == {"num_buffers": 1, "page_size": min(16, s)}
    assert autotune_search.analytic_config(
        "flash_attention", sq=s, skv=s, d=128, dtype="bfloat16",
        causal=True) == {"block_q": 64, "block_k": 64, "num_buffers": 1}
    q = torch.zeros(b, hkv * 8, 128, dtype=torch.bfloat16)
    k = torch.zeros(b, s, hkv, 128, dtype=torch.bfloat16)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TUNING", "off")
        plan = da.route(q, k, k)
    assert (plan.wrapper, plan.num_buffers) == (da.decode_attention, 1)
    assert plan.num_splits == -(-s // -(-s // want))


@pytest.mark.parametrize("kernel,shape", [
    ("flash_attention", dict(sq=512, skv=1024, d=128, dtype="bfloat16")),
    ("flash_attention", dict(sq=512, skv=1024, d=128, dtype="float32")),
    ("flash_attention", dict(sq=488, skv=488, d=192, dv=128,
                             dtype="float32")),
    ("flash_attention", dict(sq=64, skv=64, d=128, dtype="int8")),
    ("decode_attention", dict(s=1024, d=128, dtype="bfloat16", rows=16)),
    ("decode_attention", dict(s=1024, d=576, dv=512, dtype="bfloat16",
                              rows=8)),
    ("decode_attention", dict(s=1024, d=576, dv=512, dtype="float32",
                              rows=8)),
    ("decode_attention", dict(s=4096, d=128, dtype="int8", rows=2)),
    ("paged_decode_attention", dict(s=1024, page_size=16, d=128,
                                    dtype="float32", rows=16)),
    ("paged_decode_attention", dict(s=1024, page_size=0, d=128,
                                    dtype="int8", rows=16)),
])
def test_every_candidate_fits_shared_memory(kernel, shape):
    """Each candidate's ring fits the 227 KB a block may use, the classic
    pick sits in slot 0 or 1, and the quantized flash and contiguous
    decode (K10, K7) and the f32 flash forward never get a ring; a flash
    candidate's tile is one the library builds at its (Dk, Dv)."""
    spec = autotune_search.SPECS[kernel]
    bucket = spec.bucket(**shape)
    cands = spec.candidates(bucket)
    assert cands and spec.analytic_config(**bucket) in cands[:2]
    itemsize = kernels_mod._dtype_bytes(bucket)
    for cfg in cands:
        nb = cfg["num_buffers"]
        assert nb in autotune_search.BUFFER_DEPTHS
        if kernel == "flash_attention":
            tile = (cfg["block_q"], cfg["block_k"])
            if bucket["dtype"] != "bfloat16":
                assert nb == 1 and len(cands) == 1
                continue
            assert tile in fa.tile_options(bucket["d"], bucket["dv"])
            base, stage = fa.pipelined_smem(itemsize, bucket["d"],
                                            bucket["dv"], block_q=tile[0],
                                            block_k=tile[1])
        else:
            base, stage = da.pipelined_smem(itemsize, bucket["d"],
                                            bucket["dv"])
        assert nb == 1 or base + nb * stage <= autotune.SMEM_BUDGET
        if kernel != "paged_decode_attention" and bucket["dtype"] == "int8":
            assert nb == 1
    if bucket.get("page_size") == 0:
        assert {c["page_size"] for c in cands} == set(
            autotune_search.PAGE_SIZE_OPTIONS)


def test_tune_cli_quick_runs_on_the_cpu(capsys):
    results = tune.main(["--quick", "--no-persist", "--device", "cpu"])
    assert [r.kernel for r in results] == sorted(
        autotune_search.QUICK_SHAPES)
    assert all(r.n_timed > 0 and r.measured_s <= r.analytic_s
               for r in results)
    out = capsys.readouterr().out
    assert "backend=cpu" in out and "db=memory" in out
    assert "speedup" in out and "ms(t)" in out and "ms(c)" in out
    # every row carries the classic config's time: it is always measured
    rows = [line for line in out.splitlines()
            if line.split()[0] in autotune_search.QUICK_SHAPES]
    assert len(rows) == len(results) and all(
        line.split()[-1] != "-" for line in rows)


@pytest.mark.parametrize("s,d,dv,rows,dtype,first", [
    (1024, 128, 128, 16, "bfloat16", None),   # qwen2.5-3b's decode tick
    (1024, 576, 512, 8, "bfloat16", None),    # deepseek-v2-lite's decode
    (1024, 128, 128, 2, "float32", None),
    (4096, 128, 128, 64, "bfloat16", None),
    # K7 on the tensor cores (served queries are bf16) has no ring, so a
    # tile pays its load and its products in turn: 16 splits of one
    # 64-row tile rank before the classic 9 splits of two; the classic
    # comes second
    (1024, 128, 128, 16, "int8", 16),
    (1024, 128, 128, 16, "float8_e4m3fn", 16),
])
def test_decode_prior_ranks_the_classic_split_count_first(s, d, dv, rows,
                                                          dtype, first):
    """On the card's terms (a split is a block of one launch, L paid once
    a call) the prior's first pick has the classic split count, with the
    shallowest ring it ranks: so the walk times the classic and its
    pipelined form first, whatever L is.  Where a kernel without a ring
    (K7) makes shorter splits cheaper, the prior's pick (``first``) comes
    first and the classic second."""
    classic = autotune.decode_split_k(s, rows=rows)
    spec = autotune_search.SPECS["decode_attention"]
    bucket = spec.bucket(s=s, d=d, dv=dv, dtype=dtype, rows=rows)
    cands = spec.candidates(bucket)
    assert cands[0]["num_splits"] == (classic if first is None else first)
    assert spec.analytic_config(**bucket) in cands[:2]
    if dtype in ("bfloat16", "float32"):
        assert cands[0]["num_buffers"] == 2
    with pytest.MonkeyPatch.context() as mp:   # L does not reorder a call
        mp.setattr(autotune, "_overhead", lambda: 1e-3)
        assert spec.candidates(bucket) == cands


def test_decode_prior_costs_each_path_at_its_tile_and_rate(monkeypatch):
    """The bf16 and 1-byte decode priors (K7-K9's served queries are bf16)
    charge a tile of 16 query rows by 64 KV rows (32 at MLA's 576 / 512)
    at the tensor cores' 989 TFLOP/s over the card's SMs, the f32 prior
    one head's 32-row tile at the CUDA cores' 67; each tile's K/V rows
    load at one SM's share of 3.35 TB/s."""
    calls = []
    real = autotune._tile_s

    def spy(depth, load_s, compute_s):
        calls.append((load_s, compute_s))
        return real(depth, load_s, compute_s)

    monkeypatch.setattr(autotune, "_tile_s", spy)
    sms = autotune.sm_count()
    for itemsize, dk, dv, bq, bk, flops in (
            (2, 128, 128, 16, 64, 989e12), (2, 576, 512, 16, 32, 989e12),
            (4, 128, 128, 1, 32, 67e12), (1, 128, 128, 16, 64, 989e12)):
        calls.clear()
        base, stage = da.pipelined_smem(itemsize, dk, dv)
        autotune.decode_split_buffer_candidates(
            2048, rows=sms, head_dim=dk, dv=dv, dtype_bytes=itemsize,
            base_bytes=base, stage_bytes=stage, buffer_depths=(1,))
        load_s, compute_s = calls[0]     # one split: rows = sms blocks
        assert compute_s == pytest.approx(2 * bq * bk * (dk + dv) * sms
                                          / flops)
        assert load_s == pytest.approx(itemsize * bk * (dk + dv) * sms
                                       / 3.35e12)
    assert autotune.decode_mma_block_k(128, 128) == 64
    assert autotune.decode_mma_block_k(40, 32) == 64
    assert autotune.decode_mma_block_k(576, 512) == 32


def test_flash_prior_ranks_a_ring_before_the_classic():
    """K4 overlaps a tile's load with the previous tile's products, so the
    prior ranks the shallowest ring first and K1 second; L, paid once a
    call, does not reorder them."""
    spec = autotune_search.SPECS["flash_attention"]
    bucket = spec.bucket(sq=512, skv=1024, d=128, dtype="bfloat16")
    assert [c["num_buffers"] for c in spec.candidates(bucket)][:2] == [2, 1]


@pytest.mark.parametrize("dtype,tiles", [("bfloat16", (64, 64)),
                                         ("float32", (16, 32))])
def test_flash_prior_takes_the_tiles_of_the_path_the_dtype_launches(
        dtype, tiles):
    """bf16 K1 / K4 run on the tensor cores at the library's tiles (at
    (128, 128) 16, 64 or 128 query rows by 32 or 64 KV rows; 64 x 64, the
    classic ``tiles``, elsewhere), f32 on the CUDA cores in 16 x 32 tiles
    without a ring: the spec's candidates carry those tiles (the classic
    in slot 0 or 1) and the prior the shared memory of the ring the
    kernel lays out at each tile, the shallowest ring of a tile first."""
    spec = autotune_search.SPECS["flash_attention"]
    for d in (128, 64):
        bucket = spec.bucket(sq=512, skv=1024, d=d, dtype=dtype)
        cands = spec.candidates(bucket)
        classic = {"block_q": tiles[0], "block_k": tiles[1], "num_buffers": 1}
        assert spec.analytic_config(**bucket) == classic
        assert classic in cands[:2]
        got = {(c["block_q"], c["block_k"]) for c in cands}
        if dtype == "float32":
            assert cands == [classic]
            continue
        assert got == set(fa.tile_options(d, d))
    assert set(fa.tile_options(64, 64)) == {(64, 64)}
    assert len(fa.tile_options(128, 128)) == 6
    if dtype == "float32":
        return
    blocks = autotune.attention_block_candidates(
        512, 1024, 128, dv=128, tiles=fa.tile_options(128, 128),
        ring_smem=lambda bq, bk: fa.pipelined_smem(2, 128, 128, block_q=bq,
                                                   block_k=bk),
        buffer_depths=autotune_search.BUFFER_DEPTHS)
    assert {(b.block_q, b.block_k) for b in blocks} == set(
        fa.tile_options(128, 128))
    for b in blocks:
        base, stage = fa.pipelined_smem(2, 128, 128, block_q=b.block_q,
                                        block_k=b.block_k)
        assert b.smem_bytes == base + b.num_buffers * stage
    per_tile = [b.num_buffers for b in blocks if (b.block_q, b.block_k)
                == tiles]
    assert per_tile == [2, 4, 1]


def test_flash_prior_costs_the_tensor_cores_at_the_bf16_rate(monkeypatch):
    """The prior charges each bf16 tile's products (bq x bk) at the tensor
    cores' 989 TFLOP/s over the card's SMs and its bf16 K/V rows (bk) at
    one SM's share of 3.35 TB/s, a tile at a time over ceil(Sq / bq) x
    ceil(Skv / bk) tiles."""
    calls = []
    real = autotune._tile_s

    def spy(depth, load_s, compute_s):
        calls.append((depth, load_s, compute_s))
        return real(depth, load_s, compute_s)

    monkeypatch.setattr(autotune, "_tile_s", spy)
    tiles = fa.tile_options(128, 128)
    autotune.attention_block_candidates(
        512, 1024, 128, dv=128, tiles=tiles,
        ring_smem=lambda bq, bk: fa.pipelined_smem(2, 128, 128, block_q=bq,
                                                   block_k=bk),
        buffer_depths=(1,))
    sms = autotune.sm_count()
    assert len(calls) == len(tiles)
    for (bq, bk), (_, load, comp) in zip(tiles, calls):
        assert comp == pytest.approx(2 * bq * bk * 256 * sms / 989e12)
        assert load == pytest.approx(2 * bk * 256 * sms / 3.35e12)


# ----------------------------- the moe_gmm and mamba_ssd specs, the flash
# ----------------------------- tiles and the DMA-vs-compute breakdown

@pytest.mark.parametrize("shape", [
    dict(c=8, d=2048, f=1408, dtype="bfloat16"),
    dict(c=240, d=1408, f=2048, dtype="bfloat16"),
    dict(c=64, d=2048, f=1408, dtype="int8"),
    dict(c=13, d=72, f=40, dtype="float32"),
    dict(c=1, d=7, f=9, dtype="float8_e4m3fn"),
])
def test_gmm_bucket_keys_equal_reference(shape):
    """The port's moe_gmm buckets and keys are the reference's: c, d and
    f as powers of two (floor 8), the dtype kept."""
    port = autotune_search.SPECS["moe_gmm"]
    ref = jax_search.SPECS["moe_gmm"]
    assert port.bucket(**shape) == ref.bucket(**shape)
    assert port.bucket_key(port.bucket(**shape)) == ref.bucket_key(
        ref.bucket(**shape))


@pytest.mark.parametrize("shape", [
    dict(s=488, p=64, n=128, dtype="bfloat16"),
    dict(s=488, p=64, n=128, dtype="int8"),
    dict(s=5, p=16, n=16, dtype="float32"),
    dict(s=1000, p=64, n=64, dtype="bfloat16"),
])
def test_ssd_bucket_keys_equal_reference(shape):
    """The port's mamba_ssd buckets and keys are the reference's: s as a
    power of two with floor 16, p, n and the dtype kept."""
    port = autotune_search.SPECS["mamba_ssd"]
    ref = jax_search.SPECS["mamba_ssd"]
    assert port.bucket(**shape) == ref.bucket(**shape)
    assert port.bucket_key(port.bucket(**shape)) == ref.bucket_key(
        ref.bucket(**shape))


@pytest.mark.parametrize("kernel,shapes", sorted(
    (k, v) for k, v in autotune_search.REPRESENTATIVE_SHAPES.items()
    if k in ("moe_gmm", "mamba_ssd")))
def test_gmm_and_ssd_candidates_fit_and_the_analytic_pick_is_today(kernel,
                                                                   shapes):
    """Every prior candidate of the moe_gmm and mamba_ssd specs at the
    card's buckets is a built instance whose shared memory fits the 227
    KB budget, the classic pick sits in slot 0 or 1, and the analytic
    pick is what the kernels ran before the search: K14's tile rule, the
    stream's 128 columns, the 64-row chunk."""
    from repro_torch.kernels.mamba_ssd import ops as ss
    from repro_torch.kernels.moe_gmm import ops as mg

    spec = autotune_search.SPECS[kernel]
    for shape in shapes:
        bucket = spec.bucket(**shape)
        cands = spec.candidates(bucket)
        classic = spec.analytic_config(**shape)
        assert classic in cands[:2] and len(cands) > 1
        if kernel == "mamba_ssd":
            assert classic == {"chunk": 64}
            built = ss.chunks(shape["p"], shape["n"])
            for cfg in cands:
                assert cfg["chunk"] in built
                assert autotune.ssd_mma_smem(
                    cfg["chunk"], shape["p"], shape["n"],
                    x_bytes=1 if shape["dtype"] == "int8" else 2
                ) <= autotune.SMEM_BUDGET
            continue
        kern = kernels_mod._gmm_path(bucket)
        assert classic == autotune.gmm_tiles(shape["c"], path=kern).config()
        assert classic["block_f"] == 128
        for cfg in cands:
            assert cfg in mg.tile_options(kern, shape["c"])
            t = autotune.GmmTiles(**cfg)
            assert t.stages * t.block_d * (t.block_c + t.block_f) * 2 <= \
                autotune.SMEM_BUDGET


def test_ssd_mma_smem_mirrors_the_kernel_layout():
    """``ssd_mma_smem`` gives ``SsdMmaSmem``'s bytes: 96.5 KB at the
    classic chunk at P = 64, N = 128 (the layout the kernel's comment
    states), 97.75 KB for K13's 1-byte x, and the 32- and 128-row chunks
    at the served pairs within the budget (56.5 KB and 178 KB)."""
    assert autotune.ssd_mma_smem(64, 64, 128) == 98_816
    assert autotune.ssd_mma_smem(64, 64, 128, x_bytes=1) == 100_096
    assert autotune.ssd_mma_smem(32, 64, 128) == 57_856
    assert autotune.ssd_mma_smem(128, 64, 128) == 182_272
    assert autotune.ssd_mma_smem(128, 64, 128, x_bytes=1) < \
        autotune.SMEM_BUDGET


@pytest.mark.parametrize("kernel", ["moe_gmm", "mamba_ssd"])
def test_quick_search_of_gmm_and_ssd_runs_and_reloads_warm(db_path, kernel):
    """A QUICK_SHAPES search of the new specs runs on the CPU (their plain
    versions), persists its winner, and a warm reload resolves the bucket
    with zero measurements; the winner is one of the candidates."""
    shape = QUICK[kernel]
    res = autotune_search.search_kernel(kernel, options=FAST, device="cpu",
                                        **shape)
    spec = autotune_search.SPECS[kernel]
    assert res.config in spec.candidates(spec.bucket(**shape))
    autotune_search.reset_db()
    before = autotune_search.measurement_count()
    assert autotune_search.lookup_or_search(
        kernel, options=FAST, device="cpu", **shape) == res.config
    assert autotune_search.measurement_count() == before


@pytest.mark.parametrize("kernel,won", [
    ("moe_gmm", {"block_c": 8, "block_f": 256, "block_d": 64, "stages": 4}),
    ("mamba_ssd", {"chunk": 128}),
    ("flash_attention", {"block_q": 16, "block_k": 32, "num_buffers": 4}),
])
def test_tuning_off_ignores_a_warm_db_for_the_new_knobs(db_path, monkeypatch,
                                                        kernel, won):
    """REPRO_TUNING=off resolves the tile, chunk and flash tile to the
    analytic pick however warm the db is."""
    shape = dict(REPRESENTATIVE_SHAPE[kernel])
    spec = autotune_search.SPECS[kernel]
    autotune_search.get_db().record(
        kernel, "cpu", spec.bucket_key(spec.bucket(**shape)), won)
    monkeypatch.setenv("REPRO_TUNING", "on")
    assert autotune_search.lookup_or_search(kernel, device="cpu",
                                            **shape) == won
    monkeypatch.setenv("REPRO_TUNING", "off")
    before = autotune_search.measurement_count()
    assert autotune_search.lookup_or_search(
        kernel, device="cpu", **shape) == spec.analytic_config(**shape)
    assert autotune_search.measurement_count() == before


REPRESENTATIVE_SHAPE = {k: v[0] for k, v in
                        autotune_search.REPRESENTATIVE_SHAPES.items()}


def test_flash_tiles_route_from_the_db(db_path, monkeypatch):
    """A bf16 K1 call resolves its block_q and depth from the db
    (memoized, no measurement), fitted to the ring that tile lays out, and
    keeps block_k at the classic 64 (the db's block_k would move the
    bits); an unbuilt block_q from the db raises; a caller's block_k
    reaches its instance; f32 keeps its one tile at depth 1."""
    monkeypatch.setenv("REPRO_TUNING", "on")
    spec = autotune_search.SPECS["flash_attention"]
    q = torch.zeros(8, 1, 32, 128, dtype=torch.bfloat16)
    k = torch.zeros(8, 1601, 8, 128, dtype=torch.bfloat16)
    key = spec.bucket_key(spec.bucket(sq=1, skv=1601, d=128, dv=128,
                                      dtype="bfloat16", causal=False))
    assert fa.route(q, k, k, causal=False) == (fa.flash_attention, 1, 64, 64)
    autotune_search.get_db().record(
        "flash_attention", "cpu", key,
        {"block_q": 16, "block_k": 32, "num_buffers": 4})
    before = autotune_search.measurement_count()
    base, stage = fa.pipelined_smem(2, 128, 128, block_q=16, block_k=64)
    depth = autotune.fit_buffer_depth(4, stage, base_bytes=base)
    assert fa.route(q, k, k, causal=False) == (
        fa.flash_attention_pipelined if depth > 1 else fa.flash_attention,
        depth, 16, 64)
    assert fa.route(q, k, k, causal=False, block_k=32) == (
        fa.flash_attention_pipelined, 4, 16, 32)
    assert autotune_search.measurement_count() == before
    autotune_search.get_db().record(
        "flash_attention", "cpu", key,
        {"block_q": 32, "block_k": 32, "num_buffers": 1})
    with pytest.raises(ValueError, match="not built"):
        fa.route(q, k, k, causal=False)
    assert fa.route(q.float(), k.float(), k.float(), causal=False,
                    num_buffers=4) == (fa.flash_attention, 1, 16, 32)


def test_a_searched_db_moves_no_served_bit(db_path, monkeypatch):
    """A db whose search picked block_k 32 at qwen's 512-wide prefill (as
    a search on the H100 did) and chunk 128 at mamba2's prefill: the
    model's route (knobs None) keeps block_k at 64 and the chunk at
    ``SSD_CHUNK`` (both move sums), while it takes the db's block_q and
    depth (which keep the bits); a caller's ``block_k=32`` /
    ``chunk=128`` reaches those instances, and nothing is measured."""
    from repro_torch.kernels.mamba_ssd import ops as ss

    monkeypatch.setenv("REPRO_TUNING", "on")
    db = autotune_search.get_db()
    flash = autotune_search.SPECS["flash_attention"]
    shape = dict(sq=512, skv=1024, d=128, dv=128, dtype="bfloat16",
                 causal=True)
    db.record("flash_attention", "cpu", flash.bucket_key(flash.bucket(
        **shape)), {"block_q": 16, "block_k": 32, "num_buffers": 2})
    ssd = autotune_search.SPECS["mamba_ssd"]
    db.record("mamba_ssd", "cpu", ssd.bucket_key(ssd.bucket(
        s=488, p=64, n=128, dtype="bfloat16")), {"chunk": 128})
    q = torch.zeros(1, 512, 16, 128, dtype=torch.bfloat16)
    k = torch.zeros(1, 1024, 2, 128, dtype=torch.bfloat16)
    x = torch.zeros(1, 488, 48, 64, dtype=torch.bfloat16)
    b_in = torch.zeros(1, 488, 1, 128, dtype=torch.bfloat16)
    before = autotune_search.measurement_count()
    plan = fa.route(q, k, k)
    assert (plan.block_q, plan.block_k) == (16, autotune.MMA_BLOCK_K) == (
        16, 64)
    assert plan.num_buffers == 2
    assert ss.resolve_chunk(x, b_in) == autotune.SSD_CHUNK == 64
    assert fa.route(q, k, k, block_k=32).block_k == 32
    assert ss.resolve_chunk(x, b_in, chunk=128) == 128
    assert autotune_search.measurement_count() == before


def test_dma_compute_breakdown_follows_the_reference():
    """As in the reference: None for the kernels without a staged KV
    stream (gmm, ssd); for the attention kernels the modeled copy and
    product seconds on the card's terms, the exposed wait falling with
    the ring depth."""
    for kernel, shape in (("moe_gmm", dict(c=8, d=2048, f=2048,
                                           dtype="bfloat16")),
                          ("mamba_ssd", dict(s=512, p=64, n=128,
                                             dtype="bfloat16"))):
        assert kernels_mod.dma_compute_breakdown(kernel, shape, {}) is None
        assert jax_kernels.dma_compute_breakdown(kernel, shape, {}) is None
    flash = dict(sq=8, skv=2048, d=128, dv=128, dtype="bfloat16")
    decode = dict(s=1024, d=128, dv=128, dtype="bfloat16", rows=16)
    for kernel, shape, cfg in (
            ("flash_attention", flash, {"block_q": 16, "block_k": 32}),
            ("decode_attention", decode, {"num_splits": 9}),
            ("paged_decode_attention", dict(decode, page_size=16), {})):
        stalls = [kernels_mod.dma_compute_breakdown(
            kernel, shape, dict(cfg, num_buffers=nb))["stall_s"]
            for nb in (1, 2, 4)]
        assert stalls[0] > stalls[1] > stalls[2] > 0
    got = kernels_mod.dma_compute_breakdown(
        "flash_attention", flash, {"block_q": 16, "block_k": 32,
                                   "num_buffers": 1})
    steps = 1 * 64                                 # ceil(8/16) * 2048/32
    assert got["dma_s"] == pytest.approx(steps * 32 * 256 * 2 / 3.35e12)
    assert got["compute_s"] == pytest.approx(steps * 2 * 16 * 32 * 256
                                             / 989e12)
