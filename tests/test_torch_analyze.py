"""The port's static analysis (``repro_torch.analyze``) against the
reference's ``repro.analyze``: the semantics of ``tests/test_analyze.py``
(one failing fixture per diagnostic code, with SMEM001 for VMEM001;
preflight memoization; the poisoned-cache contract; the lint rules and a
clean tree; the BENCH workloads; the report CLI), the same verdicts and
budgets as the reference under a target built from its V5E fields, and
the port's linter over the reference's tree giving the reference
linter's findings."""

import json
import math
import pathlib
import textwrap

import jax.numpy as jnp
import pytest
import torch

from _torch_isolation import isolated_port_state  # noqa: F401
from repro.analyze import validate as jvalidate
from repro.analyze.lint import lint_paths as jlint_paths
from repro.core.hardware import V5E
from repro.core.io_model import TileConfig as JTileConfig
from repro_torch.analyze import (CODES, Diagnostic, ProgramValidationError,
                                 preflight_attn, preflight_dist,
                                 preflight_stats, reset_preflight,
                                 validate_attn, validate_cache_entry,
                                 validate_dist, validate_program)
from repro_torch.analyze.lint import RULES, lint_paths, lint_source
from repro_torch.analyze.validate import (planned_smem_bytes,
                                          validate_paged_dispatch)
from repro_torch.core.hardware import H100, HopperTarget
from repro_torch.core.io_model import TileConfig
from repro_torch.kernels import ca_mmm as K
from repro_torch.kernels.program import program_from_tag
from repro_torch.obs import get_metrics

REPO = pathlib.Path(__file__).resolve().parent.parent


def tpu_target(ref=V5E) -> HopperTarget:
    """A port target holding the reference target's own fields (as
    ``tests/test_torch_io_model.py`` builds it)."""
    return HopperTarget(
        name=ref.name, card=ref.name,
        peak_flops_bf16=ref.peak_flops_bf16,
        peak_flops_fp32=ref.peak_flops_fp32,
        peak_flops_int8=ref.peak_flops_int8,
        fast_bytes=ref.vmem_bytes, hbm_bytes=ref.hbm_bytes,
        hbm_bandwidth=ref.hbm_bandwidth, quantum_m=ref.sublane,
        quantum_n=ref.lane, quantum_k=ref.lane, packed_axis="m", max_n=0,
        route_tiles=False)


TPU = tpu_target()
# The card's tiles: the wgmma route's (clean) and one no route runs.
_OK_TILE = TileConfig(bm=128, bn=128, bk=64)
_HUGE_TILE = TileConfig(bm=16384, bn=16384, bk=16384)
# The reference's own fixtures' tiles, for the TPU-fields target.
_TPU_OK = TileConfig(bm=256, bn=256, bk=512)


def _codes(diags):
    return sorted({d.code for d in diags})


# ---------------------------------------------------------------------------
# Diagnostics plumbing
# ---------------------------------------------------------------------------

def test_diagnostic_rejects_unknown_code_and_severity():
    with pytest.raises(ValueError, match="unknown diagnostic code"):
        Diagnostic(code="VMEM001", severity="error", message="x")
    with pytest.raises(ValueError, match="severity"):
        Diagnostic(code="SMEM001", severity="fatal", message="x")


def test_program_validation_error_lists_all_diagnostics():
    diags = [Diagnostic(code="SMEM001", severity="error", message="a"),
             Diagnostic(code="TAG002", severity="error", message="b")]
    err = ProgramValidationError(diags)
    assert err.fatal  # must punch through the fallback ladder
    assert err.codes == ("SMEM001", "TAG002")
    assert "SMEM001" in str(err) and "TAG002" in str(err)
    assert isinstance(err, ValueError)


def test_codes_are_the_references_with_smem001_for_vmem001():
    from repro.analyze import CODES as JCODES

    assert set(CODES) == (set(JCODES) - {"VMEM001"}) | {"SMEM001"}


# ---------------------------------------------------------------------------
# Verifier: one failing fixture per code
# ---------------------------------------------------------------------------

def test_clean_program_validates_clean():
    assert validate_program("rms>bias+gelu", _OK_TILE) == []
    assert validate_program("dqb+bias+silu", _OK_TILE,
                            dtype_b=torch.int8) == []
    assert validate_program("rms>bias+gelu", _TPU_OK, TPU) == []


def test_smem001_over_budget_tile():
    diags = validate_program("none", _HUGE_TILE, H100, dtype=torch.float32)
    assert _codes(diags) == ["SMEM001"]
    assert any(d.context.get("budget") == H100.smem_per_block
               for d in diags)
    # under the V5E fields: the reference's VMEM001 verdict and budget
    diags = validate_program("none", _HUGE_TILE, TPU, dtype=torch.float32)
    assert _codes(diags) == ["SMEM001"]
    assert diags[0].context["budget"] == int(V5E.vmem_bytes * 0.75)


def test_smem001_route_bytes_on_the_card():
    """Every route tile's shared memory (the launcher's dynamic bytes plus
    the kernel's static panels) fits a block; a tile no route runs is
    SMEM001 even when it would fit."""
    for tag, b in (("none", torch.bfloat16), ("rms>glu.silu(none|none)",
                                               torch.bfloat16),
                   ("dqb", torch.int8), ("glu.silu(dqb|dqb)", torch.int8)):
        for m in (1, 8, 128, 4096):
            res = validate_program(tag, TileConfig(*K.route_tile(
                K.k1_route(program_from_tag(tag), "nn", torch.bfloat16, b,
                           m, 2048, 2048, True), program_from_tag(tag),
                torch.bfloat16, m)), dtype=torch.bfloat16,
                dtype_b=b if b == torch.int8 else None, m=m, n=2048,
                k=2048)
            assert res == [], (tag, m, [str(d) for d in res])
    assert _codes(validate_program("none", TileConfig(64, 64, 64))) == [
        "SMEM001"]


def test_smem001_min_plus():
    """On the V5E fields the reference's broadcast-buffer verdicts; on the
    card the distance product's two staged slabs, not a broadcast."""
    tile = TileConfig(bm=1024, bn=1024, bk=1024)
    assert validate_program("none", tile, TPU) == []
    assert _codes(validate_program("none", tile, TPU,
                                   semiring="min_plus")) == ["SMEM001"]
    mp = TileConfig(*K.MINPLUS_TILE)
    assert validate_program("none", mp, H100, dtype=torch.float32,
                            semiring="min_plus") == []
    need, route = planned_smem_bytes(program_from_tag("none"), mp,
                                     dtype=torch.float32,
                                     semiring="min_plus")
    assert route == "minplus"
    assert need == 2 * 32 * (128 + 4 + 128) * 4 < H100.smem_per_block


def test_tag002_unparseable_and_noncanonical():
    assert _codes(validate_program("not-a-tag", _OK_TILE)) == ["TAG002"]
    diags = validate_program("gelu+bias", _OK_TILE)
    assert _codes(diags) == ["TAG002"]
    assert diags[0].context["canonical"] == "bias+gelu"


def test_qnt003_dtype_chain_and_alignment():
    i8 = torch.int8
    assert _codes(validate_program("bias", _OK_TILE, dtype_b=i8)) == [
        "QNT003"]
    assert _codes(validate_program("dqb", _OK_TILE, dtype_b=i8,
                                   dtype_a=i8)) == ["QNT003"]
    assert validate_program("dqab", _OK_TILE, dtype_b=i8, dtype_a=i8) == []
    # per-tile scale block off the int8 routes' k slab: 128, the lcm of
    # the k depths of the tiles the int8 programs run (the decode route
    # rounds its chunk to the block itself)
    dqb, dqab = program_from_tag("dqb"), program_from_tag("dqab")
    bks = [K.route_tile(route, spec, a, m)[2]
           for spec, a in ((dqb, torch.bfloat16), (dqab, i8))
           for route in ("wgmma", "simt") for m in (1, 128)]
    assert K.SCALE_BLOCK_QUANTUM == math.lcm(*bks) == 128
    assert _codes(validate_program("dqb", _OK_TILE, dtype_b=i8,
                                   scale_block=192)) == ["QNT003"]
    assert validate_program("dqb", _OK_TILE, dtype_b=i8,
                            scale_block=256) == []
    assert _codes(validate_program("dqab", _OK_TILE, dtype_b=i8,
                                   dtype_a=i8, scale_block=256,
                                   act_block=128)) == ["QNT003"]


def test_dist004_geometry():
    assert validate_dist("ring", (1, 2, 1), (128, 256, 512)) == []
    assert _codes(validate_dist("bogus", (1, 2, 1),
                                (128, 256, 512))) == ["DIST004"]
    assert _codes(validate_dist("ring", (1, 3, 1),
                                (128, 256, 512))) == ["DIST004"]
    assert _codes(validate_dist("ring", (1, 2, 3),
                                (128, 256, 512))) == ["DIST004"]
    assert _codes(validate_dist("ring", (1, 2, 1), (128, 256, 512),
                                b_block=512)) == ["DIST004"]
    assert validate_dist("ring", (1, 2, 1), (128, 256, 512),
                         b_block=128) == []
    assert validate_dist("ring", (4, 1, 1), (7, 256, 512)) == []


def test_kv005_page_geometry_and_admission():
    from repro_torch.tuning.attention import AttnConfig

    ok = AttnConfig(q_block=128, kv_block=128)
    assert validate_attn(ok, arch="paged_decode") == []
    bad = AttnConfig(q_block=128, kv_block=24)
    assert _codes(validate_attn(bad, arch="paged_decode")) == ["KV005"]
    # a flash kv_block off the lane grid, on the V5E fields
    assert _codes(validate_attn(AttnConfig(q_block=128, kv_block=96),
                                arch="flash", hw=TPU)) == ["KV005"]
    assert _codes(validate_attn(ok, arch="paged_decode", heads=6,
                                kv_heads=4)) == ["KV005"]
    assert validate_attn(ok, arch="paged_decode", pool_pages=32,
                         batch=4, max_context=1024) == []
    assert _codes(validate_attn(ok, arch="paged_decode", pool_pages=31,
                                batch=4, max_context=1024)) == ["KV005"]
    assert _codes(validate_attn(ok, arch="paged_decode", table_pages=7,
                                max_context=1024)) == ["KV005"]
    # K2's plan within its shared memory: a head dim whose query row
    # alone outgrows it is SMEM001
    assert validate_paged_dispatch(q_shape=(1, 1, 32, 64), page=16,
                                   n_heads=32, kv_heads=32, head_dim=64,
                                   v_head_dim=64) == []
    assert _codes(validate_paged_dispatch(
        q_shape=(1, 1, 1, 65536), page=16, n_heads=1, kv_heads=1,
        head_dim=65536, v_head_dim=16)) == ["SMEM001"]


def test_every_documented_code_has_a_trigger():
    from repro_torch.tuning.attention import AttnConfig

    triggered = set()
    triggered.update(_codes(validate_program("none", _HUGE_TILE)))
    triggered.update(_codes(validate_program("???", None)))
    triggered.update(_codes(validate_program("bias", _OK_TILE,
                                             dtype_b=torch.int8)))
    triggered.update(_codes(validate_dist("ring", (1, 3, 1),
                                          (8, 256, 512))))
    triggered.update(_codes(validate_attn(
        AttnConfig(q_block=128, kv_block=24), arch="paged_decode")))
    assert triggered == set(CODES)


# Tags and tiles whose verdicts the V5E-fields target must reproduce.
_PARITY = [("none", (16384, 16384, 16384), "float32", None, None, 0, 0),
           ("none", (256, 256, 512), "bfloat16", None, None, 0, 0),
           ("rms>glu.silu(none|none)", (2048, 2048, 1024), "bfloat16",
            None, None, 0, 0),
           ("dqb+bias+silu", (1024, 2048, 2048), "bfloat16", "int8", None,
            0, 0),
           ("dqab", (512, 512, 512), "bfloat16", "int8", "int8", 256, 256),
           ("dqb", (256, 256, 512), "bfloat16", "int8", None, 192, 0),
           ("bias+gelu+mul+res", (4096, 4096, 512), "float32", None, None,
            0, 0),
           ("dact.gelu>none", (1024, 1024, 1024), "bfloat16", None, None,
            0, 0)]


@pytest.mark.parametrize("case", _PARITY, ids=lambda c: f"{c[0]}{c[1]}")
def test_tpu_fields_target_gives_the_reference_verdicts(case):
    tag, (bm, bn, bk), dt, db, da, sb, ab = case
    got = validate_program(tag, TileConfig(bm, bn, bk), TPU, dtype=dt,
                           dtype_b=db, dtype_a=da, scale_block=sb,
                           act_block=ab)
    want = jvalidate.validate_program(
        tag, JTileConfig(bm=bm, bn=bn, bk=bk, order="k_inner"), V5E,
        dtype=jnp.dtype(dt), dtype_b=db and jnp.dtype(db),
        dtype_a=da and jnp.dtype(da), scale_block=sb, act_block=ab)
    rename = {"VMEM001": "SMEM001"}
    assert [rename.get(d.code, d.code) for d in want] == [
        d.code for d in got]
    for w, g in zip(want, got):
        for key in ("bytes", "budget"):
            assert w.context.get(key) == g.context.get(key)


# ---------------------------------------------------------------------------
# Dispatch preflight
# ---------------------------------------------------------------------------

def test_preflight_memoizes_per_key():
    from repro_torch.core.gemm import ca_matmul

    reset_preflight()
    x = torch.ones((8, 64))
    w = torch.ones((64, 64))
    ca_matmul(x, w)
    s1 = preflight_stats()
    assert s1["validated"] == 1
    ca_matmul(x, w)  # same key, tile and shape: memo hit
    s2 = preflight_stats()
    assert s2["validated"] == 1
    assert s2["hits"] == s1["hits"] + 1


def test_poisoned_cache_entry_raises_smem001_before_any_launch():
    """An over-budget tile smuggled in through the tuning cache is rejected
    by name at dispatch, before the launch (the launcher is never
    called)."""
    from repro_torch.core.gemm import ca_matmul
    from repro_torch.tuning import get_registry
    from repro_torch.tuning.cache import CacheEntry, cache_key

    reset_preflight()
    reg = get_registry()
    m = n = k = 256
    reg.cache.put(cache_key(m, n, k, "float32", hw=reg.hw),
                  CacheEntry(bm=16384, bn=16384, bk=16384,
                             measured_s=1e-3))
    launches = []
    real = K.ca_gemm_program
    K.ca_gemm_program = lambda *a, **kw: launches.append(1) or real(*a,
                                                                    **kw)
    try:
        x = torch.ones((m, k))
        w = torch.ones((k, n))
        with pytest.raises(ProgramValidationError, match="SMEM001"):
            ca_matmul(x, w)
        counts = get_metrics().snapshot()["analyze.violations_total"][
            "labels"]
        assert counts["code=SMEM001"] == 1
        with pytest.raises(ProgramValidationError, match="SMEM001"):
            ca_matmul(x, w)
    finally:
        K.ca_gemm_program = real
    assert launches == []
    assert get_metrics().snapshot()["analyze.violations_total"]["labels"][
        "code=SMEM001"] == 1


def test_preflight_dist_rejects_unknown_schedule():
    with pytest.raises(ProgramValidationError, match="DIST004"):
        preflight_dist("bogus", (1, 1, 1), (8, 8, 16))


def test_paged_attention_rejects_multi_token_q():
    from repro_torch import kvcache as kvc
    from repro_torch.kvcache.paged import paged_attention

    cache = kvc.make_paged_cache(4, 4, 2, 8, 8, 1, 4)
    q = torch.zeros((1, 2, 4, 8), dtype=torch.bfloat16)
    with pytest.raises(ProgramValidationError, match="KV005"):
        paged_attention(q, cache)
    with pytest.raises(ProgramValidationError, match="KV005"):
        preflight_attn((1, 1, 6, 8), 4, 6, 4)


# ---------------------------------------------------------------------------
# Cache entry validation + `cache lint`
# ---------------------------------------------------------------------------

def _entry(bm=128, bn=128, bk=64, order="k_inner"):
    from repro_torch.tuning.cache import CacheEntry

    return CacheEntry(bm=bm, bn=bn, bk=bk, order=order)


def test_validate_cache_entry_gemm():
    good = "h100/bfloat16/plus_times/none/nn/m256n256k512"
    assert validate_cache_entry(good, _entry()) == []
    key32 = "h100/float32/plus_times/none/nn/m16384n16384k16384"
    assert "SMEM001" in _codes(validate_cache_entry(
        key32, _entry(16384, 16384, 16384)))
    bad_tag = "h100/bfloat16/plus_times/dq+bias/nn/m256n256k512"
    assert "TAG002" in _codes(validate_cache_entry(bad_tag, _entry()))
    assert "TAG002" in _codes(validate_cache_entry("h100/only", _entry()))
    assert "TAG002" in _codes(validate_cache_entry(
        good, _entry(order="zigzag")))
    quant = "h100/int8w_bf16a/plus_times/dqb/nn/m256n256k512"
    assert validate_cache_entry(quant, _entry()) == []
    # a target this build does not know: flagged, never judged
    foreign = validate_cache_entry(good.replace("h100", "tpu-v5e"),
                                   _entry())
    assert [d.severity for d in foreign] == ["warning"]


def test_validate_cache_entry_attn():
    good = "h100/attn.paged_decode/int8/h8kv2d64/s4096"
    assert validate_cache_entry(good, _entry(128, 128, 128,
                                             order="attn")) == []
    assert "KV005" in _codes(validate_cache_entry(
        good, _entry(128, 24, 24, order="attn")))
    assert "TAG002" in _codes(validate_cache_entry(
        good, _entry(128, 128, 128, order="k_inner")))


def test_cache_lint_flags_and_strips(tmp_path):
    from repro_torch.tuning.cache import TuningCache, lint_cache

    path = tmp_path / "cache.json"
    cache = TuningCache(path, autosave=False)
    cache.put("h100/bfloat16/plus_times/none/nn/m256n256k512", _entry())
    bad = "h100/float32/plus_times/none/nn/m16384n16384k16384"
    cache.put(bad, _entry(16384, 16384, 16384))
    cache.save()
    flagged = lint_cache(path)
    assert set(flagged) == {bad}
    assert all(msg.startswith("SMEM001 (error)") for msg in flagged[bad])
    lint_cache(path, strip=True)
    assert len(TuningCache(path, autosave=False)) == 1
    assert lint_cache(path) == {}


def test_cache_lint_cli(tmp_path, capsys):
    from repro_torch.analyze.__main__ import main as analyze_main
    from repro_torch.tuning.cache import TuningCache, main

    path = tmp_path / "cache.json"
    cache = TuningCache(path, autosave=False)
    cache.put("h100/float32/plus_times/none/nn/m16384n16384k16384",
              _entry(16384, 16384, 16384))
    cache.save()
    assert main(["lint", str(path)]) == 1
    assert "SMEM001" in capsys.readouterr().out
    assert analyze_main(["cache", str(path)]) == 1
    assert "SMEM001" in capsys.readouterr().out
    assert main(["lint", str(path), "--strip"]) == 0
    assert main(["lint", str(path)]) == 0
    assert analyze_main(["cache", str(path)]) == 0


# ---------------------------------------------------------------------------
# AST lint rules: positive + noqa fixtures
# ---------------------------------------------------------------------------

def _lint(path, src):
    findings, suppressed = lint_source(pathlib.Path(path),
                                       textwrap.dedent(src))
    return [f.code for f in findings], [f.code for f in suppressed]


def test_rpr001_registry_bypass_and_noqa():
    src = """
    from repro_torch.kernels.ops import fused_matmul

    def run(a, b):
        return fused_matmul(a, b)
    """
    assert _lint("benchmarks/fix.py", src) == (["RPR001"], [])
    assert _lint("src/repro_torch/models/fix.py", src) == (["RPR001"], [])
    assert _lint("src/repro_torch/kernels/fix.py", src) == ([], [])
    src_noqa = src.replace("return fused_matmul(a, b)",
                           "return fused_matmul(a, b)  # repro: noqa RPR001")
    assert _lint("benchmarks/fix.py", src_noqa) == ([], ["RPR001"])


def test_rpr002_missing_ledger_record():
    src = """
    def dispatch(a, b):
        from repro_torch.kernels import ops as kops
        return kops.fused_matmul(a, b)
    """
    assert _lint("src/repro_torch/core/fix.py", src) == (["RPR002"], [])
    recorded = """
    def dispatch(a, b):
        from repro_torch.kernels import ops as kops
        led = _ledger()
        led.record_gemm(1, 1, 1, None)
        return kops.fused_matmul(a, b)
    """
    assert _lint("src/repro_torch/core/fix.py", recorded) == ([], [])
    assert "RPR002" not in _lint("src/repro_torch/serve/fix.py", src)[0]


def test_rpr003_assert_validation():
    src = """
    def public(x):
        assert x > 0, x
        return x

    def _private(x):
        assert x > 0
        return x

    class C:
        def __post_init__(self):
            if True:
                assert self.x
    """
    codes, _ = _lint("src/repro_torch/serve/fix.py", src)
    assert codes == ["RPR003", "RPR003"]
    noqa = src.replace("assert x > 0, x",
                       "assert x > 0, x  # repro: noqa RPR003")
    codes, supp = _lint("src/repro_torch/serve/fix.py", noqa)
    assert codes == ["RPR003"] and supp == ["RPR003"]
    mid = """
    def public(x):
        y = x + 1
        assert y > 1
        return y
    """
    assert _lint("src/repro_torch/serve/fix.py", mid) == ([], [])


def test_rpr004_overbroad_except():
    src = """
    def f():
        try:
            g()
        except:
            pass

    def h():
        try:
            g()
        except Exception:
            return None

    def ok_reraise():
        try:
            g()
        except Exception as e:
            raise RuntimeError("wrapped") from e

    def ok_guard():
        try:
            g()
        except Exception as e:
            _note_fallback("stage", e)

    def ok_narrow():
        try:
            g()
        except InjectedKernelFailure:
            return None
    """
    codes, _ = _lint("src/repro_torch/serve/fix.py", src)
    assert codes == ["RPR004", "RPR004"]


def test_rpr005_unlocked_global_mutation():
    src = """
    _flag = False

    def set_flag(v):
        global _flag
        _flag = v

    def set_flag_locked(v):
        global _flag
        with _lock:
            _flag = v
    """
    codes, _ = _lint("src/repro_torch/serve/fix.py", src)
    assert codes == ["RPR005"]


def test_lint_clean_on_the_port_tree():
    """`python -m repro_torch.analyze lint src/repro_torch` exits 0."""
    from repro_torch.analyze.__main__ import main

    findings, _supp, n_files = lint_paths([str(REPO / "src" /
                                                "repro_torch")])
    assert n_files > 60
    assert findings == [], "\n".join(str(f) for f in findings)
    assert main(["lint", str(REPO / "src" / "repro_torch")]) == 0


def test_port_linter_over_the_reference_gives_its_findings():
    paths = [str(REPO / "src" / "repro")]
    got, got_supp, n = lint_paths(paths)
    want, want_supp, jn = jlint_paths(paths)
    assert n == jn
    key = lambda f: (f.path, f.line, f.code)  # noqa: E731
    assert sorted(map(key, got)) == sorted(map(key, want))
    assert sorted(map(key, got_supp)) == sorted(map(key, want_supp))


def test_lint_cli_json_report(tmp_path):
    from repro_torch.analyze.lint import main

    bad = tmp_path / "benchmarks" / "fix.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("from repro_torch.kernels.ops import fused_matmul\n"
                   "y = fused_matmul(1, 2)\n")
    out = tmp_path / "report.json"
    rc = main([str(bad), "--format", "json", "--output", str(out)])
    assert rc == 1
    report = json.loads(out.read_text())
    assert report["rules"] == RULES
    assert [f["code"] for f in report["findings"]] == ["RPR001"]


# ---------------------------------------------------------------------------
# BENCH gate workloads validate clean (meta-test), as in the reference
# ---------------------------------------------------------------------------

def _bench_dtypes(ds):
    if "w_" in ds:
        w, a = ds.split("w_", 1)
        a = a[:-1] if a.endswith("a") else a
        return a, w, (w if a == "int8" else None)
    return ds, None, None


def test_bench_gemm_workloads_validate_clean():
    """The reference's measured TPU tiles pass on the V5E fields."""
    results = json.loads((REPO / "BENCH_gemm.json").read_text())["results"]
    assert results
    for r in results:
        c = r["config"]
        dtype, dtype_b, dtype_a = _bench_dtypes(r["dtype"])
        diags = validate_program(r.get("epilogue") or "none",
                                 TileConfig(c["bm"], c["bn"], c["bk"]), TPU,
                                 dtype=dtype, dtype_b=dtype_b,
                                 dtype_a=dtype_a)
        assert diags == [], (r["kind"], [str(d) for d in diags])


def test_bench_attn_workloads_validate_clean():
    from repro_torch.tuning.attention import _PAGE_CANDIDATES

    results = json.loads((REPO / "BENCH_attn.json").read_text())["results"]
    assert results
    for r in results:
        page = r.get("page")
        if page is None:
            continue
        if r["kind"] == "kv_bytes":
            assert page in _PAGE_CANDIDATES, r
        else:
            B, Hkv, D = r["shape"][0], r["shape"][2], r["shape"][-1]
            diags = validate_paged_dispatch(
                q_shape=(B, 1, 2 * Hkv, D), page=page, n_heads=2 * Hkv,
                kv_heads=Hkv, head_dim=D, v_head_dim=D)
            assert diags == [], [str(d) for d in diags]


# ---------------------------------------------------------------------------
# report CLI
# ---------------------------------------------------------------------------

def test_report_cli_one_arch(capsys):
    from repro_torch.analyze.__main__ import main

    rc = main(["report", "--arch", "stablelm-1.6b"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "stablelm-1.6b" in out and "0 diagnostic(s)" in out
    assert "route=wgmma" in out and "route=decode" in out
