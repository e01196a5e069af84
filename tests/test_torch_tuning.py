"""The port's tuning subsystem against the reference's: cache keys,
persistence and atomicity, registry precedence (cache > autotune >
analytic) with a fake timer, the space's candidates, workloads and
warmup, attention resolution; and on the ``h100`` target every serve GEMM
of every reduced config resolving to the tile its K1 route runs.  The
cases follow ``tests/test_tuning.py``; comparisons are exact."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_isolation import isolated_port_state  # noqa: F401  (autouse)
from repro.configs import get_reduced as jax_reduced
from repro.core import V5E
from repro.tuning import cache as jcache
from repro.tuning import space as jspace
from repro.tuning import workload as jwork
from repro.tuning.attention import _analytic_config as jax_attn_analytic
from repro_torch.configs import get_reduced, list_archs
from repro_torch.core.hardware import H100
from repro_torch.core.io_model import (TileConfig, solve_tile_config,
                                       tile_vmem_bytes, vmem_quantum)
from repro_torch.kernels import ca_mmm as K
from repro_torch.kernels.program import program_from_tag
from repro_torch.tuning import (CacheEntry, KernelRegistry, TuningCache,
                                autotune_gemm, cache_key,
                                candidate_tile_configs, model_gemm_shapes,
                                model_gemm_workloads, quantize_workloads,
                                shape_bucket, warmup_model)
from repro_torch.tuning import attention as tattn
from repro_torch.tuning import cache as tcache
from repro_torch.tuning import registry as treg
from test_torch_io_model import TPU

JDT = {"bfloat16": jnp.bfloat16, "float32": jnp.float32, "int8": jnp.int8}
TDT = {"bfloat16": torch.bfloat16, "float32": torch.float32,
       "int8": torch.int8}


# ---------------------------------------------------------------------------
# cache.py
# ---------------------------------------------------------------------------

_KR = np.random.RandomState(3)
KEY_CASES = [(int(_KR.randint(1, 70000)), int(_KR.randint(1, 70000)),
              int(_KR.randint(1, 70000)), dt, tag, lay)
             for dt, tag, lay in (
                 ("bfloat16", "none", "nn"), ("float32", "res", "nn"),
                 ("int8w_bf16a", "rms>glu.silu(dqb|dqb)", "nn"),
                 ("int8w_int8a", "dqab+res", "nn"),
                 ("bfloat16", "dact.silu@b>none", "tn"),
                 ("bfloat16", "dact.gelu>none", "nt"))]


@pytest.mark.parametrize("m, n, k, dt, tag, lay", KEY_CASES)
def test_cache_key_is_byte_identical_to_reference(m, n, k, dt, tag, lay):
    want = jcache.cache_key(m, n, k, dt, "plus_times", V5E, tag, lay)
    assert cache_key(m, n, k, dt, "plus_times", TPU, tag, lay) == want
    assert cache_key(m, n, k, dt, "min_plus", TPU, tag, lay) == \
        jcache.cache_key(m, n, k, dt, "min_plus", V5E, tag, lay)
    # the port's own target keys under its own name
    assert cache_key(m, n, k, dt, epilogue=tag, layout=lay) == \
        want.replace(V5E.name, "h100", 1)
    assert shape_bucket(m) == jcache.shape_bucket(m)


def test_cache_round_trip(tmp_path):
    path = tmp_path / "cache.json"
    c = TuningCache(path)
    entry = CacheEntry(bm=256, bn=512, bk=128, order="k_inner",
                       measured_s=1e-3, predicted_s=9e-4, n_tried=5)
    key = cache_key(1000, 2000, 3000, "bfloat16")
    c.put(key, entry)
    got = TuningCache(path).get(key)
    assert got == entry
    assert got.to_tile() == TileConfig(bm=256, bn=512, bk=128)
    # the same JSON schema as the reference's cache file
    raw = json.loads(path.read_text())
    assert raw["schema"] == tcache.SCHEMA_VERSION == jcache.SCHEMA_VERSION
    assert jcache.CacheEntry.from_json(raw["entries"][key]).bm == 256


def test_cache_has_its_own_path_and_env(tmp_path, monkeypatch):
    assert tcache._ENV_PATH == "REPRO_TORCH_TUNING_CACHE"
    assert tcache._ENV_PATH != jcache._ENV_PATH
    monkeypatch.delenv(tcache._ENV_PATH)
    monkeypatch.setenv(jcache._ENV_PATH, str(tmp_path / "ref.json"))
    assert tcache.default_cache_path() == tcache.DEFAULT_CACHE_PATH
    assert tcache.DEFAULT_CACHE_PATH.parent.name == "build"
    monkeypatch.setenv(tcache._ENV_PATH, str(tmp_path / "port.json"))
    assert tcache.default_cache_path() == tmp_path / "port.json"


def test_cache_key_fields_are_distinct():
    base = cache_key(512, 512, 512, "float32")
    assert len({base, cache_key(512, 512, 512, "float32",
                                epilogue="bias+silu+mul"),
                cache_key(512, 512, 512, "float32", layout="nt"),
                cache_key(512, 512, 512, "float32", layout="tn")}) == 4
    assert cache_key(1000, 2000, 3000, "bfloat16") == \
        cache_key(1024, 1100, 2049, "bfloat16")
    assert cache_key(512, 512, 512, "int8w_bf16a", epilogue="dqb", hw=TPU) \
        == "tpu-v5e/int8w_bf16a/plus_times/dqb/nn/m512n512k512"


def test_cache_schema_version_invalidation(tmp_path):
    path = tmp_path / "cache.json"
    TuningCache(path).put("some/key", CacheEntry(bm=8, bn=128, bk=128))
    raw = json.loads(path.read_text())
    raw["schema"] = tcache.SCHEMA_VERSION + 1
    path.write_text(json.dumps(raw))
    assert len(TuningCache(path)) == 0


def test_cache_corrupt_file_loads_empty(tmp_path):
    path = tmp_path / "cache.json"
    path.write_text("{not json at all")
    c = TuningCache(path)
    assert len(c) == 0
    c.put("k", CacheEntry(bm=8, bn=128, bk=128))
    assert len(TuningCache(path)) == 1


def test_cache_merge_cli_round_trip(tmp_path):
    a_path, b_path = tmp_path / "a.json", tmp_path / "b.json"
    out = tmp_path / "merged.json"
    a, b = TuningCache(a_path), TuningCache(b_path)
    key_h = cache_key(512, 512, 512, "bfloat16")
    key_t = key_h.replace("h100", "tpu-v5e")
    a.put(key_h, CacheEntry(bm=128, bn=128, bk=64, updated_at=100.0))
    a.put(key_t, CacheEntry(bm=128, bn=128, bk=128, updated_at=50.0))
    b.put(key_h, CacheEntry(bm=128, bn=64, bk=64, updated_at=200.0))
    b.put(key_t, CacheEntry(bm=8, bn=128, bk=128, updated_at=10.0))
    assert tcache.main(["merge", str(a_path), str(b_path), "-o",
                        str(out)]) == 0
    merged = TuningCache(out)
    assert len(merged) == 2
    assert merged.get(key_h).bn == 64 and merged.get(key_h).updated_at == 200
    assert merged.get(key_t).bm == 128
    assert json.loads(out.read_text())["schema"] == tcache.SCHEMA_VERSION


def test_cache_lint_flags_foreign_targets_and_non_route_tiles(tmp_path):
    path = tmp_path / "cache.json"
    c = TuningCache(path)
    good = cache_key(1, 2048, 2048, "bfloat16")
    c.put(good, CacheEntry(bm=8, bn=64, bk=256))
    c.put(cache_key(128, 2048, 2048, "bfloat16", epilogue="res"),
          CacheEntry(bm=256, bn=256, bk=128))          # no route runs it
    c.put(good.replace("h100", "tpu-v5e"), CacheEntry(bm=8, bn=128, bk=128))
    c.put(tattn.attn_cache_key("paged_decode", heads=32, kv_heads=32,
                               head_dim=64, kv_dtype_str="int8",
                               seq_len=1056, hw=H100),
          tattn.AttnConfig(1, 64).to_entry())
    flagged = tcache.lint_cache(path)
    assert set(flagged) == {k for k in c.keys()
                            if k != good and "attn." not in k}
    assert any("unknown target" in m for m in
               flagged[good.replace("h100", "tpu-v5e")])
    assert tcache.main(["lint", str(path)]) == 1
    assert tcache.main(["lint", str(path), "--strip"]) == 0
    assert len(TuningCache(path)) == 2
    assert tcache.main(["lint", str(path)]) == 0


def test_cache_entries_carry_updated_at(tmp_path):
    stamped = CacheEntry.from_tile(TileConfig(bm=8, bn=128, bk=128),
                                   measured_s=1e-3)
    assert stamped.updated_at > 0
    c = TuningCache(tmp_path / "c.json")
    c.put("k2", CacheEntry(bm=8, bn=128, bk=128, updated_at=42.0))
    assert TuningCache(tmp_path / "c.json").get("k2").updated_at == 42.0


def test_cache_atomic_write_crash_safety(tmp_path, monkeypatch):
    path = tmp_path / "cache.json"
    c = TuningCache(path)
    c.put("k1", CacheEntry(bm=8, bn=128, bk=128))
    before = path.read_text()

    def boom(src, dst):
        raise OSError("simulated crash at publish")

    monkeypatch.setattr(os, "replace", boom)
    with pytest.raises(OSError):
        c.put("k2", CacheEntry(bm=16, bn=128, bk=128))
    monkeypatch.undo()
    assert path.read_text() == before
    assert list(TuningCache(path).keys()) == ["k1"]
    assert [p.name for p in tmp_path.iterdir()] == ["cache.json"]


# ---------------------------------------------------------------------------
# space.py
# ---------------------------------------------------------------------------

_SR = np.random.RandomState(11)
SPACE_CASES = [(int(_SR.randint(8, 1 << 14)), int(_SR.randint(8, 1 << 14)),
                int(_SR.randint(8, 1 << 14)), ["bfloat16", "float32",
                                               "int8"][i % 3])
               for i in range(9)]


@pytest.mark.parametrize("m, n, k, dt", SPACE_CASES)
def test_space_candidates_match_reference(m, n, k, dt):
    want = jspace.candidate_tile_configs(m, n, k, dtype_in=JDT[dt],
                                         top_n=8, hw=V5E)
    got = candidate_tile_configs(m, n, k, dtype_in=TDT[dt], top_n=8, hw=TPU)
    assert [dataclasses.asdict(c) for c in got] == \
        [dataclasses.asdict(c) for c in want]
    qm, qn = vmem_quantum(TDT[dt], TPU)
    for c in got:
        assert c.bm % qm == 0 and c.bn % qn == 0 and c.bk % 128 == 0
        assert c.vmem_bytes <= 0.75 * TPU.fast_bytes


@pytest.mark.parametrize("kw", [
    dict(epilogue="bias+silu+mul+res", dtype_in="float32"),
    dict(epilogue="dqb", dtype_b="int8"),
    dict(epilogue="dqab", dtype_b="int8", dtype_a="int8"),
    dict(epilogue="rms>glu.silu(none|none)"),
    dict(semiring="min_plus", dtype_in="float32"),
    dict(orders=("k_inner", "k_outer"), dtype_in="float32")])
def test_space_program_variants_match_reference(kw):
    def conv(table):
        return {k: (table[v] if k.startswith("dtype") else v)
                for k, v in kw.items()}
    want = jspace.candidate_tile_configs(512, 4096, 1024, top_n=6, hw=V5E,
                                         **conv(JDT))
    got = candidate_tile_configs(512, 4096, 1024, top_n=6, hw=TPU,
                                 **conv(TDT))
    assert [dataclasses.asdict(c) for c in got] == \
        [dataclasses.asdict(c) for c in want]


@pytest.mark.parametrize("tag, layout, m, dt, want", [
    ("none", "nn", 1, "bfloat16", K.DECODE_TILE),
    ("rms>glu.silu(none|none)", "nn", 8, "bfloat16", K.DECODE_TILE),
    ("res", "nn", 9, "bfloat16", K.WGMMA_TILE),
    ("rms>glu.silu(none|none)", "nn", 128, "bfloat16", (128, 64, 64)),
    ("dqab+res", "nn", 128, "int8", (128, 128, 128)),
    ("none", "nt", 4, "bfloat16", K.SIMT_TILE),
    ("none", "nn", 4, "float32", K.SIMT_DECODE_TILE),
    ("none", "nn", 40, "float32", K.SIMT_TILE)])
def test_h100_candidates_are_the_route_tile(tag, layout, m, dt, want):
    kw = {}
    if dt == "int8":
        kw = dict(dtype_b=torch.int8, dtype_a=torch.int8)
        dt = "bfloat16"
    cands = candidate_tile_configs(m, 2048, 2048, dtype_in=TDT[dt],
                                   epilogue=tag, layout=layout, **kw)
    assert [(c.bm, c.bn, c.bk) for c in cands] == [want]
    assert want in K.ROUTE_TILES
    # the k-outer ablation keeps its own tiles: never a K1 candidate
    assert candidate_tile_configs(m, 2048, 2048, dtype_in=TDT[dt],
                                  epilogue=tag, layout=layout,
                                  orders=("k_outer",), **kw) == []


# ---------------------------------------------------------------------------
# autotune.py
# ---------------------------------------------------------------------------

def _fake_timer_factory(calls, best=(256, 256, 128)):
    def timer(tile):
        calls.append((tile.bm, tile.bn, tile.bk, tile.order))
        return 0.5 if (tile.bm, tile.bn, tile.bk) == best else 1.0
    return timer


def test_autotune_picks_measured_winner():
    calls = []
    cands = [TileConfig(128, 128, 128), TileConfig(256, 256, 128),
             TileConfig(512, 512, 128)]
    res = autotune_gemm(1024, 1024, 1024, dtype=torch.float32, hw=TPU,
                        candidates=cands, timer=_fake_timer_factory(calls),
                        patience=5)
    assert (res.config.bm, res.config.bn, res.config.bk) == (256, 256, 128)
    assert res.measured_s == 0.5
    assert res.n_tried == len(calls) <= len(cands)


def test_autotune_early_stops_on_patience():
    calls = []

    def timer(tile):
        calls.append(tile)
        return float(len(calls))

    cands = [TileConfig(128 * i, 128, 128) for i in range(1, 9)]
    res = autotune_gemm(1024, 1024, 1024, dtype=torch.float32, hw=TPU,
                        candidates=cands, timer=timer, patience=2)
    assert res.early_stopped and res.n_tried == 3


def test_time_tile_refuses_the_cpu():
    """The CPU reaches the tuning loop only through a supplied timer."""
    from repro_torch.tuning.autotune import time_tile

    if torch.cuda.is_available():
        pytest.skip("a card is present: time_tile runs there")
    with pytest.raises(RuntimeError, match="CUDA card"):
        time_tile(16, 64, 128, TileConfig(*K.SIMT_TILE))


# ---------------------------------------------------------------------------
# registry.py
# ---------------------------------------------------------------------------

def _tuned_registry(tmp_path, calls, autotune_enabled=True, hw=TPU):
    cache = TuningCache(tmp_path / "reg_cache.json")

    def tuner(m, n, k, dtype=torch.bfloat16, semiring="plus_times", hw=hw,
              **kw):
        return autotune_gemm(m, n, k, dtype=dtype, semiring=semiring, hw=hw,
                             timer=_fake_timer_factory(calls), patience=2)

    return KernelRegistry(cache=cache, autotune_enabled=autotune_enabled,
                          hw=hw, tuner=tuner)


def test_registry_analytic_fallback_matches_reference_solver(tmp_path):
    calls = []
    r = _tuned_registry(tmp_path, calls, autotune_enabled=False)
    got = r.resolve_full(512, 512, 512, dtype=torch.float32)
    assert got.source == "analytic" and calls == []
    t = solve_tile_config(512, 512, 512, dtype_in=torch.float32, hw=TPU)
    assert (got.config.bm, got.config.bn, got.config.bk) == (t.bm, t.bn,
                                                             t.bk)
    from repro.core import solve_tile_config as jsolve

    j = jsolve(512, 512, 512, dtype_in=jnp.float32)
    assert (t.bm, t.bn, t.bk) == (j.bm, j.bn, j.bk)


def test_registry_autotune_then_cached_no_retiming(tmp_path):
    calls = []
    r = _tuned_registry(tmp_path, calls)
    c1 = r.resolve(512, 512, 512, dtype=torch.float32)
    n_timed = len(calls)
    assert n_timed > 0 and r.stats["autotune"] == 1
    assert r.resolve(512, 512, 512, dtype=torch.float32) == c1
    assert len(calls) == n_timed and r.stats["cache"] == 1
    c3 = r.resolve(500, 510, 512, dtype=torch.float32)
    assert len(calls) == n_timed
    assert (c3.bm, c3.bn, c3.bk) == (c1.bm, c1.bn, c1.bk)
    # the winner was written back: a new registry on the same file
    calls2 = []
    c4 = _tuned_registry(tmp_path, calls2).resolve_full(
        512, 512, 512, dtype=torch.float32)
    assert c4.source == "cache" and calls2 == []
    assert (c4.config.bm, c4.config.bn, c4.config.bk) == (c1.bm, c1.bn,
                                                          c1.bk)
    key = cache_key(512, 512, 512, "float32", hw=TPU)
    assert r.cache.get(key).updated_at > 0


def test_registry_cache_beats_autotune(tmp_path):
    cache = TuningCache(tmp_path / "reg_cache.json")
    cache.put(cache_key(512, 512, 512, "float32"),
              CacheEntry(bm=64, bn=128, bk=128, source="pinned"))

    def exploding_tuner(*a, **kw):
        raise AssertionError("tuner must not run on a cache hit")

    r = KernelRegistry(cache=cache, autotune_enabled=True,
                       tuner=exploding_tuner)
    got = r.resolve_full(512, 512, 512, dtype=torch.float32)
    assert got.source == "cache"
    assert (got.config.bm, got.config.bn, got.config.bk) == (64, 128, 128)


def test_registry_env_toggle(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "1")
    assert KernelRegistry(cache=TuningCache(tmp_path / "c.json")) \
        .autotune_enabled
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "0")
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")     # the reference's switch
    assert not KernelRegistry(cache=TuningCache(tmp_path / "c.json")) \
        .autotune_enabled


def test_registry_keys_and_composite_dtypes(tmp_path):
    r = _tuned_registry(tmp_path, [], autotune_enabled=False)
    r.resolve(512, 512, 512, dtype=torch.float32)
    r.resolve(512, 512, 512, dtype=torch.float32, epilogue="bias+silu+mul")
    r.resolve(512, 512, 512, dtype=torch.float32, layout="nt")
    assert r.stats["analytic"] == 3
    plain = r.resolve_full(37, 1024, 1024, dtype=torch.bfloat16)
    w8 = r.resolve_full(37, 1024, 1024, dtype=torch.bfloat16,
                        dtype_b=torch.int8, epilogue="dqb")
    w8a8 = r.resolve_full(37, 1024, 1024, dtype=torch.bfloat16,
                          dtype_b=torch.int8, dtype_a=torch.int8,
                          epilogue="dqab")
    assert "int8w_bf16a" in w8.key and "int8w" not in plain.key
    assert w8a8.key == "tpu-v5e/int8w_int8a/plus_times/dqab/nn/m64n1024k1024"
    assert r.resolve_full(37, 1024, 1024, dtype=torch.bfloat16,
                          dtype_b=torch.bfloat16).key == plain.key
    with pytest.raises(ValueError, match="dtype_a requires dtype_b"):
        r.resolve_full(37, 1024, 1024, dtype=torch.bfloat16,
                       dtype_a=torch.int8)


def test_registry_analytic_plans_are_exact_shape(tmp_path):
    r = _tuned_registry(tmp_path, [], autotune_enabled=False)
    t600 = r.resolve(600, 600, 600, dtype=torch.float32)
    t1024 = r.resolve(1024, 1024, 1024, dtype=torch.float32)
    want = solve_tile_config(1024, 1024, 1024, dtype_in=torch.float32,
                             hw=TPU)
    assert (t1024.bm, t1024.bn, t1024.bk) == (want.bm, want.bn, want.bk)
    assert r.resolve(600, 600, 600, dtype=torch.float32) == t600


def test_registry_min_plus_analytic_fits_broadcast(tmp_path):
    r = _tuned_registry(tmp_path, [], autotune_enabled=False)
    t = r.resolve(512, 512, 512, dtype=torch.float32, semiring="min_plus")
    assert t.bm * t.bk * t.bn * 4 <= 0.75 * TPU.fast_bytes
    h = _tuned_registry(tmp_path, [], autotune_enabled=False, hw=H100)
    t = h.resolve(512, 512, 512, dtype=torch.float32, semiring="min_plus")
    assert (t.bm, t.bn, t.bk) == K.MINPLUS_TILE


def test_plan_for_and_the_dispatch_memo_route_through_registry(tmp_path):
    from repro_torch.core.gemm import plan_for

    calls = []
    treg.set_registry(_tuned_registry(tmp_path, calls))
    t = plan_for(512, 512, 512, torch.float32, hw=TPU)
    assert calls and treg.get_registry().stats["autotune"] == 1
    assert plan_for(512, 512, 512, torch.float32, hw=TPU) == t
    assert treg.get_registry().stats["cache"] == 1
    # the dispatch memo resolves once per signature, then is a dict hit
    made = []
    key = ("k", 1)
    res, tag = treg.plan(key, 64, 64, 64, torch.float32,
                         lambda: made.append(1) or "none")
    assert tag == "none" and made == [1]
    assert treg.plan(key, 64, 64, 64, torch.float32,
                     lambda: made.append(1) or "none") == (res, tag)
    assert made == [1]


# ---------------------------------------------------------------------------
# workload.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_workloads_match_reference(arch):
    cfg, jcfg = get_reduced(arch), jax_reduced(arch)
    for rows in (1, 24):
        for train in (False, True):
            want = jwork.model_gemm_workloads(jcfg, rows, train=train)
            got = model_gemm_workloads(cfg, rows, train=train)
            assert got == want
            fwd = [w for w in got if w[4] == "nn"]
            for acts in (False, True):
                assert quantize_workloads(fwd, acts=acts) == \
                    jwork.quantize_workloads(fwd, acts=acts)
        assert model_gemm_shapes(cfg, rows) == \
            jwork.model_gemm_shapes(jcfg, rows)
    for paged in (False, True):
        assert tattn_workloads(cfg, paged) == \
            jwork.model_attention_workloads(jcfg, 48, paged=paged)


def tattn_workloads(cfg, paged):
    from repro_torch.tuning import model_attention_workloads

    return model_attention_workloads(cfg, 48, paged=paged)


def test_warmup_model_sources_and_memo(tmp_path):
    cfg = get_reduced("stablelm-1.6b")
    treg.set_registry(_tuned_registry(tmp_path, [], autotune_enabled=False))
    sources = warmup_model(cfg, [32])
    assert sources and set(sources.values()) == {"analytic"}
    assert all(k.startswith("tpu-v5e/") for k in sources)
    assert all("int8w_" in k for k in warmup_model(cfg, [32], quant=True))
    asources = warmup_model(cfg, [32], quant="w8a8")
    assert asources and all("int8w_int8a" in k for k in asources)
    before = dict(treg.get_registry().stats)
    warmup_model(cfg, [32])
    after = treg.get_registry().stats
    assert after["analytic"] >= before["analytic"] + len(sources)
    assert after["autotune"] == 0
    with pytest.raises(ValueError, match="unknown quant"):
        warmup_model(cfg, [32], quant="fp8")
    # a tensor-parallel engine's warmup plans the ring-step local shapes
    from repro_torch.tuning import shard_gemm_workloads

    sharded = warmup_model(cfg, [32], shard=(1, 2))
    assert len(sharded) == len(shard_gemm_workloads(
        model_gemm_workloads(cfg, 32), 1, 2))
    assert sharded.keys() != sources.keys()


# ---------------------------------------------------------------------------
# h100: every serve GEMM resolves to the tile its K1 route runs
# ---------------------------------------------------------------------------

def _route_tile_of_real_operands(w, dtype):
    """The route tile computed from real contiguous operands of this
    workload (their actual 16-byte alignment), independently of the
    registry's space."""
    m, n, k, tag, layout = w[:5]
    spec = program_from_tag(tag)
    a_dtype = torch.int8 if len(w) > 6 else dtype
    b_dtype = torch.int8 if len(w) > 5 else dtype
    a = torch.empty((m, k), dtype=a_dtype)
    b = torch.empty((k, n), dtype=b_dtype)
    route = K.k1_route(spec, layout, a.dtype, b.dtype, m, n, k,
                       K.tma_aligned(a, b))
    return K.route_tile(route, spec, a_dtype, m, layout), route


@pytest.mark.parametrize("arch", list_archs())
def test_every_serve_gemm_resolves_to_its_route_tile_on_h100(arch):
    cfg = get_reduced(arch, "bfloat16")
    r = treg.get_registry()
    assert r.hw is H100
    seen = set()
    for rows in (1, 5, 37, 128):
        loads = model_gemm_workloads(cfg, rows)
        for quant in (False, "w8", "w8a8"):
            ws = loads if not quant else quantize_workloads(
                loads, acts=quant == "w8a8")
            for w in ws:
                res = r.resolve_full(
                    *w[:3], dtype=torch.bfloat16, epilogue=w[3],
                    layout=w[4],
                    dtype_b=torch.int8 if len(w) > 5 else None,
                    dtype_a=torch.int8 if len(w) > 6 else None)
                want, route = _route_tile_of_real_operands(w, torch.bfloat16)
                assert (res.config.bm, res.config.bn, res.config.bk) == \
                    want, (w, route)
                assert res.source == "analytic"
                assert res.key.startswith("h100/")
                seen.add(route)
    assert {"decode", "wgmma"} <= seen


# ---------------------------------------------------------------------------
# attention.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq_len", [8, 160, 1056, 5000])
def test_attention_analytic_tiers(seq_len, tmp_path):
    r = KernelRegistry(cache=TuningCache(tmp_path / "a.json"),
                       autotune_enabled=False)
    paged = tattn.resolve_page_size(heads=32, kv_heads=8, head_dim=120,
                                    seq_len=seq_len, registry=r)
    want = jax_attn_analytic("paged_decode", heads=32, kv_heads=8,
                             head_dim=120, seq_len=seq_len,
                             kv_dtype=jnp.int8, hw=V5E)
    assert paged.source == "analytic"
    assert paged.config.kv_block == want.kv_block
    assert paged.key == ("h100/attn.paged_decode/int8/h32kv8d120/"
                         f"s{shape_bucket(seq_len)}")
    # the flash tier on the h100 resolves K3's own blocks for its route
    flash = tattn.resolve_attention("flash", heads=32, kv_heads=8,
                                    head_dim=120, seq_len=seq_len,
                                    kv_dtype=torch.bfloat16, registry=r)
    assert (flash.config.q_block, flash.config.kv_block) == (128, 64)
    wide = tattn.resolve_attention("flash", heads=16, kv_heads=16,
                                   head_dim=192, seq_len=seq_len,
                                   kv_dtype=torch.bfloat16, registry=r)
    assert (wide.config.q_block, wide.config.kv_block) == (64, 64)
    # on a solving target the flash tier is the reference's heuristic
    j = jax_attn_analytic("flash", heads=32, kv_heads=8, head_dim=128,
                          seq_len=seq_len, kv_dtype=jnp.bfloat16, hw=V5E)
    t = tattn._analytic_config("flash", heads=32, kv_heads=8, head_dim=128,
                               seq_len=seq_len, kv_dtype=torch.bfloat16,
                               hw=TPU)
    assert (t.q_block, t.kv_block) == (j.q_block, j.kv_block)


def test_attention_cache_tier_and_persistence(tmp_path):
    path = tmp_path / "a.json"
    key = tattn.attn_cache_key("paged_decode", heads=4, kv_heads=2,
                               head_dim=16, kv_dtype_str="int8",
                               seq_len=48, hw=H100)
    TuningCache(path).put(key, tattn.AttnConfig(1, 32).to_entry())
    r = KernelRegistry(cache=TuningCache(path), autotune_enabled=True)
    got = tattn.resolve_page_size(heads=4, kv_heads=2, head_dim=16,
                                  seq_len=48, registry=r)
    assert got.source == "cache" and got.config.kv_block == 32
    # memoized on the registry: the next resolution is a memory hit
    assert tattn.resolve_page_size(heads=4, kv_heads=2, head_dim=16,
                                   seq_len=48, registry=r) == got
    assert r.stats["cache"] == 2
    from repro.tuning.attention import attn_cache_key as jkey

    assert key.replace("h100", V5E.name) == jkey(
        "paged_decode", heads=4, kv_heads=2, head_dim=16,
        kv_dtype_str="int8", seq_len=48, hw=V5E)


def test_attention_autotune_needs_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the autotune runs there")
    r = KernelRegistry(cache=TuningCache(tmp_path / "a.json"),
                       autotune_enabled=True)
    with pytest.raises(RuntimeError, match="CUDA card"):
        tattn.resolve_page_size(heads=4, kv_heads=2, head_dim=16,
                                seq_len=48, registry=r)
    assert len(r.cache) == 0


def test_route_tiles_are_the_cuda_sources_tiles():
    """The tiles the tuning space offers are the ones the CUDA sources
    instantiate (read from the sources, so an edit to a tile there shows
    here)."""
    import re

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attn as FA

    def const(src, name):
        text = (_build.CSRC / src).read_text()
        return int(re.search(rf"constexpr int {name} = (\d+);", text)
                   .group(1))

    gemm = (_build.CSRC / "ca_gemm_program.cu").read_text()
    assert K.DECODE_TILE == (8, const("ca_gemm_program.cu", "DEC_BN"),
                             const("ca_gemm_program.cu", "DEC_MIN_CHUNK"))
    assert "constexpr int WG_BN = NB == 2 ? 64 : 128;" in gemm
    assert K.WGMMA_GLU_BN == 64 and K.WGMMA_TILE[1] == 128
    assert "static constexpr int BK = INT_A ? 128 : 64;" in gemm
    assert K.WGMMA_INT8_A_BK == 128
    assert (const("wgmma_mainloop.cuh", "BM"),
            const("wgmma_mainloop.cuh", "BK")) == (K.WGMMA_TILE[0],
                                                   K.WGMMA_TILE[2])
    assert "launch_tile<TA, TB, 8, 16, 128, 1, 1, NB>" in gemm
    assert "launch_tile<TA, TB, 64, 64, 32, 4, 4, NB>" in gemm
    assert (K.SIMT_DECODE_TILE, K.SIMT_TILE) == ((8, 16, 128), (64, 64, 32))
    assert K.MINPLUS_TILE == tuple(const("distance_product.cu", n)
                                   for n in ("BM", "BN", "PIECE"))
    assert FA.FWD_Q_ROWS == {"wgmma": const("flash_attn_fwd.cu", "WG_ROWS"),
                             "simt": const("flash_attn_fwd.cu", "ROWS")}
    assert FA.FWD_KV_BLOCK == const("flash_attn_fwd.cu", "KC")
    for route, tile in (("decode", K.DECODE_TILE), ("simt", K.SIMT_TILE),
                        ("simt", K.SIMT_DECODE_TILE),
                        ("wgmma", K.WGMMA_TILE),
                        ("minplus", K.MINPLUS_TILE)):
        assert K.tile_route(tile) == route


def test_ca_mmm_tile_arguments_are_ignored_on_the_cpu():
    """The plain version ignores bm/bn/bk, as the reference's XLA mode
    does; the card checks them against the route's tile."""
    a, b = torch.randn(9, 16), torch.randn(16, 8)
    want = a @ b
    for tile in ((1, 2, 3), (None, 64, None), K.SIMT_TILE):
        bm, bn, bk = tile
        torch.testing.assert_close(K.ca_mmm(a, b, bm=bm, bn=bn, bk=bk),
                                   want, rtol=1e-5, atol=1e-5)
