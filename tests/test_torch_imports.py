"""The port stands alone: no module of ``repro_torch``, no script of
``examples/torch_port/`` nor ``chip_smoke.py`` imports JAX or the
reference package ``repro``."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
EXAMPLES = REPO / "examples"
PORT_EXAMPLES = EXAMPLES / "torch_port"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _guarded_files():
    """Every file that must import neither JAX nor ``repro``: the
    package, ``chip_smoke.py`` and the port's examples."""
    return _port_files() + sorted(PORT_EXAMPLES.glob("*.py"))


def _module_name(path):
    rel = path.relative_to(REPO / "src").with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    return ".".join(parts)


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_or_reference_imports_in_source():
    files = _guarded_files()
    assert len(files) > 15
    assert PORT_EXAMPLES / "serve_lm.py" in files
    bad = [(str(f.relative_to(REPO)), root) for f in files
           for root in _imported_roots(ast.parse(f.read_text()))
           if root in FORBIDDEN]
    assert bad == []


_BLOCKER = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in {forbidden!r}:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
import importlib
for mod in {modules!r}:
    importlib.import_module(mod)
print("imported", len({modules!r}))
"""


def test_every_port_module_imports_with_jax_and_repro_blocked():
    modules = [_module_name(f) for f in sorted(PORT.rglob("*.py"))]
    code = _BLOCKER.format(forbidden=FORBIDDEN, modules=modules)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert f"imported {len(modules)}" in out.stdout


def test_every_port_example_imports_with_jax_and_repro_blocked():
    modules = [f"torch_port.{f.stem}"
               for f in sorted(PORT_EXAMPLES.glob("*.py"))]
    code = _BLOCKER.format(forbidden=FORBIDDEN, modules=modules)
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), str(EXAMPLES)]))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert f"imported {len(modules)}" in out.stdout


def test_every_reference_example_has_a_port():
    """Each of the reference's ``examples/*.py`` has a script of the same
    name in ``examples/torch_port/``."""
    ref = {f.name for f in EXAMPLES.glob("*.py")}
    assert len(ref) == 4
    assert ref <= {f.name for f in PORT_EXAMPLES.glob("*.py")}


def test_every_reference_config_and_the_serve_launcher_have_a_port():
    """Each of the reference's config modules and its serve launcher has a
    counterpart of the same name, covered by the import checks above."""
    ref = REPO / "src" / "repro"
    names = {_module_name(f) for f in _port_files()[:-1]}
    for f in sorted((ref / "configs").glob("*.py")) + [
            ref / "launch" / "serve.py", ref / "models" / "ssm.py"]:
        rel = f.relative_to(ref).with_suffix("")
        want = ".".join(("repro_torch",) + rel.parts)
        if rel.name != "__init__":
            assert want in names, want


# The plan and observability layer's modules, each beside its reference
# counterpart (the import checks above cover them with JAX and repro
# blocked).
OBS_SLICE = ["core.hardware", "core.io_model", "obs.metrics", "obs.trace",
             "obs.ledger", "tuning.cache", "tuning.space", "tuning.autotune",
             "tuning.registry", "tuning.workload", "tuning.attention",
             "kernels.program"]


@pytest.mark.parametrize("mod", OBS_SLICE)
def test_plan_and_observability_modules_are_ported(mod):
    names = {_module_name(f) for f in _port_files()[:-1]}
    assert f"repro_torch.{mod}" in names
    assert (REPO / "src" / "repro" / (mod.replace(".", "/") + ".py")).exists()
    tree = ast.parse((PORT / (mod.replace(".", "/") + ".py")).read_text())
    assert not set(_imported_roots(tree)) & set(FORBIDDEN)


# The guard rails' modules (fault runtime, static analysis, checkpoints),
# each beside its reference counterpart.
GUARD_SLICE = ["runtime.fault", "analyze.diagnostics", "analyze.validate",
               "analyze.preflight", "analyze.lint", "analyze.__main__",
               "checkpoint.manager"]


@pytest.mark.parametrize("mod", GUARD_SLICE)
def test_guard_rail_modules_are_ported(mod):
    names = {_module_name(f) for f in _port_files()[:-1]}
    assert f"repro_torch.{mod}" in names
    assert (REPO / "src" / "repro" / (mod.replace(".", "/") + ".py")).exists()
    tree = ast.parse((PORT / (mod.replace(".", "/") + ".py")).read_text())
    assert not set(_imported_roots(tree)) & set(FORBIDDEN)


def test_analyze_cli_lints_the_port_without_jax():
    """``python -m repro_torch.analyze lint src/repro_torch`` exits 0 with
    JAX and the reference package blocked (the GPU host has no JAX)."""
    code = _BLOCKER.format(forbidden=FORBIDDEN,
                           modules=["repro_torch.analyze.__main__"]) + (
        "\nimport sys\nfrom repro_torch.analyze.__main__ import main\n"
        f"sys.exit(main(['lint', {str(PORT)!r}]))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 finding(s)" in out.stdout


# The distributed serve path's modules, each beside its reference
# counterpart.
DIST_SLICE = ["core.distributed", "core._dist_check", "sharding.rules",
              "launch.mesh", "serve.tp", "serve._tp_check"]


@pytest.mark.parametrize("mod", DIST_SLICE)
def test_distributed_modules_are_ported(mod):
    names = {_module_name(f) for f in _port_files()[:-1]}
    assert f"repro_torch.{mod}" in names
    assert (REPO / "src" / "repro" / (mod.replace(".", "/") + ".py")).exists()
    tree = ast.parse((PORT / (mod.replace(".", "/") + ".py")).read_text())
    assert not set(_imported_roots(tree)) & set(FORBIDDEN)


# The distributed training path and the plan-only dry run, each beside
# its reference counterpart.
TRAIN_DIST_SLICE = ["launch.specs", "launch.dryrun", "optim.adamw",
                    "train.step", "checkpoint.manager"]


@pytest.mark.parametrize("mod", TRAIN_DIST_SLICE)
def test_train_dist_modules_are_ported(mod):
    names = {_module_name(f) for f in _port_files()[:-1]}
    assert f"repro_torch.{mod}" in names
    assert (REPO / "src" / "repro" / (mod.replace(".", "/") + ".py")).exists()
    tree = ast.parse((PORT / (mod.replace(".", "/") + ".py")).read_text())
    assert not set(_imported_roots(tree)) & set(FORBIDDEN)


# Reference modules with no counterpart, and why: ``kernels/_compat.py``
# holds JAX version shims; ``launch/hlo_analysis.py`` parses the XLA HLO
# text of a compiled program, and nothing in the port produces such
# text (its dry run reports from the plan, ``launch/dryrun.py``), so a
# copy would be dead code.
NO_COUNTERPART = {"kernels/_compat.py", "launch/hlo_analysis.py"}


def test_only_the_hlo_readers_and_the_jax_shims_have_no_port():
    """Every reference module has a counterpart but the two of
    ``NO_COUNTERPART``."""
    def mods(root):
        return {str(f.relative_to(root)) for f in root.rglob("*.py")
                if f.name != "__init__.py"}

    missing = mods(REPO / "src" / "repro") - mods(PORT)
    assert missing == NO_COUNTERPART


# Public top-level names of a reference module with no counterpart in the
# port's module of the same path, by decision, each with its reason.
NAME_EXCEPTIONS = {
    "core/gemm.py": {
        "set_gemm_mode": "the port dispatches by device: K1 on a card "
                         "tensor, its plain version on a CPU tensor",
        "get_gemm_mode": "as set_gemm_mode",
        "gemm_mode": "as set_gemm_mode"},
    "core/hardware.py": {
        "TpuTarget": "the port's target is the H100 (HopperTarget)",
        "V5E": "a TPU target", "V5P": "a TPU target"},
    "launch/dryrun.py": {
        "lower_cell": "XLA lowering and compiling; the port's dry run "
                      "plans each cell (plan_cell)"},
    "sharding/rules.py": {
        "log": "the reference's module logger; the port's rules log "
               "nothing"},
    "kernels/flash_attn.py": {
        "flash_attention_tpu": "the Pallas entry point; the port's "
                               "kernel is flash_attention",
        "paged_flash_attention_tpu": "the Pallas entry point; the port's "
                                     "kernel is paged_flash_attention"},
}


def _public_names(path):
    """A module's public top-level names: defs, classes and assigned
    names (imports not counted) for the reference, everything bound at
    the top for the port."""
    defined, bound = set(), set()
    for node in ast.parse(path.read_text()).body:
        names = []
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names = [node.name]
        elif isinstance(node, ast.Assign):
            names = [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names = [node.target.id]
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            bound.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
        defined.update(n for n in names if not n.startswith("_"))
    return defined, defined | bound


def test_every_reference_public_name_has_a_counterpart():
    """Every public top-level name of every reference module with a
    counterpart module is bound in the port's module, but the exceptions
    of ``NAME_EXCEPTIONS`` (which must still be missing)."""
    missing = {}
    for ref in sorted((REPO / "src" / "repro").rglob("*.py")):
        rel = str(ref.relative_to(REPO / "src" / "repro"))
        port = PORT / rel
        if not port.exists():
            continue
        want, _ = _public_names(ref)
        _, have = _public_names(port)
        gone = want - have
        if gone:
            missing[rel] = gone
    expected = {rel: set(names) for rel, names in NAME_EXCEPTIONS.items()}
    assert missing == expected
