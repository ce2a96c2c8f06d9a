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
    kernels: depth 1, the classic split count, page size min(16, s)."""
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
        causal=True) == {"num_buffers": 1}
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
    decode (K10, K7) never get a ring."""
    spec = autotune_search.SPECS[kernel]
    bucket = spec.bucket(**shape)
    cands = spec.candidates(bucket)
    assert cands and spec.analytic_config(**bucket) in cands[:2]
    itemsize = kernels_mod._dtype_bytes(bucket)
    smem = fa.pipelined_smem if kernel == "flash_attention" else \
        da.pipelined_smem
    base, stage = smem(itemsize, bucket["d"], bucket["dv"])
    for cfg in cands:
        nb = cfg["num_buffers"]
        assert nb in autotune_search.BUFFER_DEPTHS
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
    """bf16 K1 / K4 run on the tensor cores in 64 x 64 tiles, f32 on the
    CUDA cores in 16 x 32: the prior's candidates carry those tiles and
    the shared memory of the ring the kernel lays out, and rank the
    shallowest ring first and K1 after it."""
    itemsize = 2 if dtype == "bfloat16" else 4
    base, stage = fa.pipelined_smem(itemsize, 128, 128)
    blocks = autotune.attention_block_candidates(
        512, 1024, 128, dv=128, dtype_bytes=itemsize, base_bytes=base,
        stage_bytes=stage, buffer_depths=autotune_search.BUFFER_DEPTHS)
    assert {(b.block_q, b.block_k) for b in blocks} == {tiles}
    assert [b.num_buffers for b in blocks] == [2, 4, 1]
    assert all(b.smem_bytes == base + b.num_buffers * stage for b in blocks)


def test_flash_prior_costs_the_tensor_cores_at_the_bf16_rate(monkeypatch):
    """The bf16 prior charges a 64 x 64 tile's products at the tensor
    cores' 989 TFLOP/s over the card's SMs, the f32 prior a 16 x 32
    tile's at the CUDA cores' 67; each tile's K/V rows load at one SM's
    share of 3.35 TB/s."""
    calls = []
    real = autotune._tile_s

    def spy(depth, load_s, compute_s):
        calls.append((depth, load_s, compute_s))
        return real(depth, load_s, compute_s)

    monkeypatch.setattr(autotune, "_tile_s", spy)
    for itemsize in (2, 4):
        base, stage = fa.pipelined_smem(itemsize, 128, 128)
        autotune.attention_block_candidates(
            512, 1024, 128, dv=128, dtype_bytes=itemsize, base_bytes=base,
            stage_bytes=stage, buffer_depths=(1,))
    (_, load2, comp2), (_, load4, comp4) = calls
    sms = autotune.sm_count()
    assert comp2 == pytest.approx(2 * 64 * 64 * 256 * sms / 989e12)
    assert comp4 == pytest.approx(2 * 16 * 32 * 256 * sms / 67e12)
    assert load2 == pytest.approx(2 * 64 * 256 * sms / 3.35e12)
    assert load4 == pytest.approx(4 * 32 * 256 * sms / 3.35e12)
