"""Test session config: 1 CPU device (the dry-run forces 512 in its own
subprocess), xla gemm mode by default.

If the real ``hypothesis`` package is missing (this container doesn't ship
it and installs are not allowed), fall back to the deterministic shim in
``tests/_stubs`` so property tests still collect and run.
"""

import pathlib
import sys

try:  # pragma: no cover - depends on container contents
    import hypothesis  # noqa: F401
except ImportError:
    sys.path.insert(0, str(pathlib.Path(__file__).parent / "_stubs"))

import numpy as np
import pytest

from repro.core import set_gemm_fallback, set_gemm_mode


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips with a reason without one)")


@pytest.fixture(autouse=True)
def _default_gemm_mode():
    """xla dispatch, kernel->XLA fallback OFF (a kernel bug must fail its
    parity test, not silently serve the oracle); fault-tolerance tests
    opt back in with ``gemm_fallback(True)``."""
    set_gemm_mode("xla")
    set_gemm_fallback(False)
    yield
    set_gemm_fallback(True)


@pytest.fixture(autouse=True)
def _isolated_kernel_registry(tmp_path, monkeypatch):
    """Fresh global KernelRegistry per test, cache pointed into tmp.

    Keeps tests hermetic: no test reads or writes the developer's real
    tuning cache, and registry memoization never leaks across tests.
    """
    from repro.tuning import registry as treg

    monkeypatch.setenv("REPRO_TUNING_CACHE",
                       str(tmp_path / "tuning_cache.json"))
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    treg.reset_registry()
    yield
    treg.reset_registry()


@pytest.fixture(autouse=True)
def _isolated_obs(monkeypatch):
    """Fresh metrics registry / ledger / tracer per test.

    Observability state is global by design (hot paths hook in without
    plumbing); tests must not see each other's counters or spans."""
    from repro import obs

    monkeypatch.delenv("REPRO_LEDGER", raising=False)
    monkeypatch.delenv("REPRO_TRACE", raising=False)
    obs.reset_metrics()
    obs.reset_ledger()
    obs.disable_tracing()
    yield
    obs.reset_metrics()
    obs.reset_ledger()
    obs.disable_tracing()


@pytest.fixture
def rng():
    return np.random.RandomState(0)
