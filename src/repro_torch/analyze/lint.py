"""Custom AST lint (port of ``repro/analyze/lint.py``): keep code on the
registry, ledger and fallback rails.

The serve stack's discipline is architectural, not syntactic: every
kernel launch goes through the dispatch funnels (which resolve a tile
from the registry, record to the GEMM ledger and preflight-validate),
library validation raises typed errors instead of ``assert`` (which
vanishes under ``python -O``), injected faults must propagate, and
process-global state mutates under its module lock.  Stock linters cannot
see that, so this pass encodes it as five rules, the reference's:

========  ============================================================
code      invariant
========  ============================================================
RPR001    kernel entrypoints (``ca_gemm_program``, ``fused_matmul``,
          ``quant_matmul``, paged attention, the distance product, ...)
          are only called from the dispatch layers (``core``,
          ``kernels``, ``tuning``, ``kvcache`` of the package)
RPR002    a function of ``core`` or ``kvcache`` that launches a kernel
          must touch the GEMM ledger (``record_gemm`` / ``_ledger`` /
          ...) or be suppressed with a comment saying who records
RPR003    no ``assert``-based validation in library code: asserts in
          ``__init__``/``__post_init__`` or in the leading check block
          of a public function must be raised errors
RPR004    no ``except:`` and no ``except Exception`` whose handler
          neither re-raises nor routes through a re-raise guard
          (``core.gemm._note_fallback``): both swallow
          ``InjectedKernelFailure`` and validator fatals
RPR005    a function that rebinds a module global (``global x; x = ..``)
          must do so inside a ``with <lock>:`` block
========  ============================================================

The entrypoints are the port's kernel wrappers (``kernels/ca_mmm.py``,
``kernels/ops.py``, ``kernels/flash_attn.py``), except K3's
``flash_attention``, whose name ``models/attention.py`` shares for the
model-level function that dispatches it.  The package directory is
``repro_torch`` or the reference's ``repro``, so the same pass lints
either tree.

Suppress a finding with an inline ``# repro: noqa`` (all codes) or
``# repro: noqa RPR001`` / ``# repro: noqa RPR001,RPR004`` on the
flagged line.  ``python -m repro_torch.analyze lint <paths> --format
json`` emits the machine-readable report.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import pathlib
import re
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

RULES: Dict[str, str] = {
    "RPR001": "kernel entrypoint called outside the dispatch layers "
              "(registry bypass)",
    "RPR002": "dispatch function launches a kernel without a ledger "
              "record",
    "RPR003": "assert-based validation in library code (vanishes under "
              "python -O)",
    "RPR004": "bare/overbroad except that can swallow "
              "InjectedKernelFailure without re-raising",
    "RPR005": "module-global rebound outside a lock",
}

# The port's kernel wrappers the dispatch funnels wrap.
KERNEL_ENTRYPOINTS = frozenset({
    "ca_gemm_program", "ca_mmm_k_outer", "ca_mmm_any",
    "ca_matmul_trainable", "fused_matmul", "glu_matmul", "quant_matmul",
    "quant_glu_matmul", "distance_product", "paged_flash_attention",
})

# Package directories the rules read subpackages under.
_PACKAGES = ("repro_torch", "repro")
# Subpackages allowed to call entrypoints directly (RPR001) ...
_DISPATCH_DIRS = frozenset({"core", "kernels", "tuning", "kvcache"})
# ... and the subset that must also record to the ledger (RPR002).
_LEDGER_DIRS = frozenset({"core", "kvcache"})
_LEDGER_NAMES = frozenset({
    "record_gemm", "record_attention", "record_dist", "_record_dist",
    "_ledger", "get_ledger",
})
# core.gemm's fallback hook: re-raises a fatal failure, or any failure
# while the fallback policy is off.
_RERAISE_GUARDS = frozenset({"_note_fallback"})

_NOQA_RE = re.compile(
    r"#\s*repro:\s*noqa(?:\s+(?P<codes>RPR[0-9]{3}(?:\s*,\s*RPR[0-9]{3})*))?")


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    code: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.code} {self.message}"

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


def _noqa_for_line(lines: Sequence[str], lineno: int) -> Optional[Set[str]]:
    """Suppression on source line ``lineno`` (1-based): ``set()`` means
    all codes, a non-empty set names specific ones, None means no noqa."""
    if not 1 <= lineno <= len(lines):
        return None
    m = _NOQA_RE.search(lines[lineno - 1])
    if not m:
        return None
    codes = m.group("codes")
    if not codes:
        return set()
    return {c.strip() for c in codes.split(",")}


def _call_name(node: ast.Call) -> Optional[str]:
    if isinstance(node.func, ast.Name):
        return node.func.id
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    return None


def _walk_own(fn: ast.AST) -> Iterable[ast.AST]:
    """Walk a function's body without descending into nested defs."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _path_parts(path: pathlib.Path) -> Tuple[str, ...]:
    return tuple(p for p in path.parts if p not in (".", ".."))


def _repro_subpackage(path: pathlib.Path) -> Optional[str]:
    """The subpackage directly under ``repro_torch/`` or ``repro/`` (or
    None outside both)."""
    parts = _path_parts(path)
    pkg = next((p for p in _PACKAGES if p in parts), None)
    if pkg is None:
        return None
    idx = parts.index(pkg)
    if idx + 1 >= len(parts):
        return None
    nxt = parts[idx + 1]
    return None if nxt.endswith(".py") else nxt


def _assert_exempt(path: pathlib.Path) -> bool:
    """RPR003 skips internal tooling modules (``_stubs/``, ``_x.py``)."""
    return any(p.startswith("_") and p != "__init__.py"
               for p in _path_parts(path))


class _Linter:
    def __init__(self, path: pathlib.Path, tree: ast.Module):
        self.path = path
        self.tree = tree
        self.findings: List[Finding] = []

    def flag(self, code: str, node: ast.AST, message: str) -> None:
        self.findings.append(Finding(path=str(self.path),
                                     line=getattr(node, "lineno", 0),
                                     code=code, message=message))

    def run(self) -> List[Finding]:
        sub = _repro_subpackage(self.path)
        self._rule_calls(sub)
        self._rule_excepts()
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if not _assert_exempt(self.path):
                    self._rule_asserts(node)
                self._rule_globals(node)
                if sub in _LEDGER_DIRS:
                    self._rule_ledger(node)
        return self.findings

    # -- RPR001 ----------------------------------------------------------
    def _rule_calls(self, sub: Optional[str]) -> None:
        if sub in _DISPATCH_DIRS:
            return
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call):
                name = _call_name(node)
                if name in KERNEL_ENTRYPOINTS:
                    self.flag("RPR001", node,
                              f"direct call to kernel entrypoint "
                              f"{name!r} bypasses the registry dispatch "
                              "funnel")

    # -- RPR002 ----------------------------------------------------------
    def _rule_ledger(self, fn: ast.AST) -> None:
        launches = None
        records = False
        for node in _walk_own(fn):
            if isinstance(node, ast.Call) and \
                    _call_name(node) in KERNEL_ENTRYPOINTS:
                launches = launches or node
            if isinstance(node, ast.Name) and node.id in _LEDGER_NAMES:
                records = True
            if isinstance(node, ast.Attribute) and \
                    node.attr in _LEDGER_NAMES:
                records = True
        if launches is not None and not records:
            self.flag("RPR002", fn,
                      f"function {fn.name!r} launches a kernel but never "
                      "touches the GEMM ledger (record_gemm/_ledger)")

    # -- RPR003 ----------------------------------------------------------
    def _rule_asserts(self, fn: ast.AST) -> None:
        if fn.name in ("__init__", "__post_init__"):
            for node in _walk_own(fn):
                if isinstance(node, ast.Assert):
                    self.flag("RPR003", node,
                              f"assert validation in {fn.name!r} — raise "
                              "ValueError/ProgramValidationError instead")
            return
        if fn.name.startswith("_"):
            return
        body = list(fn.body)
        if body and isinstance(body[0], ast.Expr) and \
                isinstance(body[0].value, ast.Constant) and \
                isinstance(body[0].value.value, str):
            body = body[1:]  # docstring
        for stmt in body:
            if not isinstance(stmt, ast.Assert):
                break
            self.flag("RPR003", stmt,
                      f"leading assert validation in public "
                      f"{fn.name!r} — raise a typed error instead")

    # -- RPR004 ----------------------------------------------------------
    def _rule_excepts(self) -> None:
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                self.flag("RPR004", node,
                          "bare 'except:' swallows everything, including "
                          "InjectedKernelFailure and validator fatals")
                continue
            if isinstance(node.type, ast.Name) and \
                    node.type.id in ("Exception", "BaseException"):
                handled = False
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Raise):
                        handled = True
                    if isinstance(sub, ast.Call) and \
                            _call_name(sub) in _RERAISE_GUARDS:
                        handled = True
                if not handled:
                    self.flag("RPR004", node,
                              f"'except {node.type.id}' neither re-raises "
                              "nor routes through a re-raise guard "
                              f"({', '.join(sorted(_RERAISE_GUARDS))})")

    # -- RPR005 ----------------------------------------------------------
    def _rule_globals(self, fn: ast.AST) -> None:
        declared: Set[str] = set()
        for stmt in fn.body:
            if isinstance(stmt, ast.Global):
                declared.update(stmt.names)
        if not declared:
            return
        self._scan_global_writes(fn.body, declared, in_with=False)

    def _scan_global_writes(self, stmts, declared: Set[str],
                            in_with: bool) -> None:
        for stmt in stmts:
            targets: List[ast.expr] = []
            if isinstance(stmt, ast.Assign):
                targets = stmt.targets
            elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
                targets = [stmt.target]
            for t in targets:
                names = [t] if isinstance(t, ast.Name) else [
                    e for e in ast.walk(t) if isinstance(e, ast.Name)]
                for nm in names:
                    if nm.id in declared and not in_with:
                        self.flag("RPR005", stmt,
                                  f"module global {nm.id!r} rebound "
                                  "outside a 'with <lock>:' block")
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                self._scan_global_writes(stmt.body, declared, in_with=True)
                continue
            for field in ("body", "orelse", "finalbody", "handlers"):
                sub = getattr(stmt, field, None)
                if sub:
                    if field == "handlers":
                        for h in sub:
                            self._scan_global_writes(h.body, declared,
                                                     in_with)
                    else:
                        self._scan_global_writes(sub, declared, in_with)


def lint_source(path, source: str) -> Tuple[List[Finding], List[Finding]]:
    """Lint one file's source; returns (findings, suppressed)."""
    path = pathlib.Path(path)
    try:
        tree = ast.parse(source, filename=str(path))
    except SyntaxError as e:
        return ([Finding(path=str(path), line=e.lineno or 0,
                         code="RPR003",
                         message=f"file does not parse: {e.msg}")], [])
    all_findings = _Linter(path, tree).run()
    lines = source.splitlines()
    kept: List[Finding] = []
    suppressed: List[Finding] = []
    for f in all_findings:
        noqa = _noqa_for_line(lines, f.line)
        if noqa is not None and (not noqa or f.code in noqa):
            suppressed.append(f)
        else:
            kept.append(f)
    kept.sort(key=lambda f: (f.path, f.line, f.code))
    return kept, suppressed


def collect_files(paths: Sequence[str]) -> List[pathlib.Path]:
    files: List[pathlib.Path] = []
    for p in paths:
        path = pathlib.Path(p)
        if path.is_dir():
            files.extend(sorted(
                f for f in path.rglob("*.py")
                if "__pycache__" not in f.parts))
        elif path.suffix == ".py":
            files.append(path)
    return files


def lint_paths(paths: Sequence[str]
               ) -> Tuple[List[Finding], List[Finding], int]:
    """Lint files/dirs; returns (findings, suppressed, n_files)."""
    findings: List[Finding] = []
    suppressed: List[Finding] = []
    files = collect_files(paths)
    for f in files:
        kept, supp = lint_source(f, f.read_text())
        findings.extend(kept)
        suppressed.extend(supp)
    return findings, suppressed, len(files)


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analyze lint",
        description="AST lint for the port's serve-stack discipline "
                    "(rules RPR001-RPR005)")
    ap.add_argument("paths", nargs="+", help="files or directories")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--output", default=None,
                    help="write the report here as well as stdout")
    args = ap.parse_args(argv)

    findings, suppressed, n_files = lint_paths(args.paths)
    if args.format == "json":
        report = {
            "rules": RULES,
            "files": n_files,
            "findings": [f.to_json() for f in findings],
            "suppressed": [f.to_json() for f in suppressed],
        }
        text = json.dumps(report, indent=2, sort_keys=True)
    else:
        out = [str(f) for f in findings]
        out.append(f"{len(findings)} finding(s), {len(suppressed)} "
                   f"suppressed, {n_files} file(s)")
        text = "\n".join(out)
    print(text)
    if args.output:
        pathlib.Path(args.output).write_text(text + "\n")
    return 1 if findings else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
