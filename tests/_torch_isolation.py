"""Per-test isolation of the port's process-global observability and
tuning state (the port's twin of ``tests/conftest.py``'s fixtures for the
reference): a fresh kernel-config registry over a cache file in the
test's tmp dir, autotune off, a fresh metrics registry, ledger, tracer
and preflight memo, and the GEMM fallback off (as the reference's suite
sets it, so a test opts in with ``gemm_fallback(True)``).  Test files
import the fixture, which is autouse."""

import pytest


@pytest.fixture(autouse=True)
def isolated_port_state(tmp_path, monkeypatch):
    from repro_torch import obs as tobs
    from repro_torch.analyze import reset_preflight
    from repro_torch.core.gemm import set_gemm_fallback
    from repro_torch.tuning import registry as treg

    monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE",
                       str(tmp_path / "torch_tuning_cache.json"))
    for var in ("REPRO_TORCH_AUTOTUNE", "REPRO_TORCH_LEDGER",
                "REPRO_TORCH_TRACE"):
        monkeypatch.delenv(var, raising=False)
    treg.reset_registry()
    tobs.reset_metrics()
    tobs.reset_ledger()
    tobs.disable_tracing()
    reset_preflight()
    set_gemm_fallback(False)
    yield
    set_gemm_fallback(True)
    reset_preflight()
    treg.reset_registry()
    tobs.reset_metrics()
    tobs.reset_ledger()
    tobs.disable_tracing()
