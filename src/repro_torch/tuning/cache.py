"""Persistent tuning cache (port of ``repro/tuning/cache.py``): measured
tile configs keyed by GEMM signature.

Entries are keyed by a *shape bucket* (dims rounded up to the next power
of two) so that nearby shapes share one tuned config.  Keys are
byte-identical to the reference's for a target of the same name
(``h100/bfloat16/plus_times/none/nn/m1n2048k2048``).

* **Versioned schema** — a file of another ``SCHEMA_VERSION`` is
  discarded wholesale rather than misread.
* **Atomic writes** — a same-directory temp file ``os.replace``-d into
  place, so a crash mid-save leaves the old file or the new one.
* **Corruption tolerance** — an unreadable file loads as empty.
* **Fleet merging** — the key's leading target name partitions one file
  into per-target sections; ``merge`` unions caches, newest
  ``updated_at`` winning per key:

  .. code-block:: console

     python -m repro_torch.tuning.cache merge a.json b.json -o merged.json

The cache has its own file and environment variable,
``REPRO_TORCH_TUNING_CACHE`` (default ``build/tuning_cache.json`` at the
repository root), so a cache of the reference is never read as one of the
port: the reference's validator would judge an unknown target against
its TPU's budgets.  ``lint`` judges each entry against the target its key
names with the port's verifier (``repro_torch.analyze.validate``: a tile
no K1 route runs, or over the card's shared memory, is SMEM001), and
flags keys of a target it does not know.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import sys
import tempfile
import time
from typing import Dict, Optional, Sequence

from repro_torch.core.hardware import H100, HopperTarget
from repro_torch.core.io_model import TileConfig

# The reference's schema: keys carry (program tag, layout), the tag in
# the full GemmProgram grammar (``rms>glu.silu(none|none)``).
SCHEMA_VERSION = 4

_ENV_PATH = "REPRO_TORCH_TUNING_CACHE"
DEFAULT_CACHE_PATH = (pathlib.Path(__file__).resolve().parents[3] / "build"
                      / "tuning_cache.json")


def default_cache_path() -> pathlib.Path:
    env = os.environ.get(_ENV_PATH)
    if env:
        return pathlib.Path(env)
    return DEFAULT_CACHE_PATH


def shape_bucket(d: int) -> int:
    """Round a GEMM dim up to the next power of two (min 1).

    Bucketing keeps the cache small and lets one tuned config serve the
    whole neighborhood of shapes the planner would tile identically.
    """
    if d <= 1:
        return 1
    return 1 << (d - 1).bit_length()


def cache_key(m: int, n: int, k: int, dtype_str: str,
              semiring: str = "plus_times",
              hw: HopperTarget = H100,
              epilogue: str = "none",
              layout: str = "nn") -> str:
    """Stable string key: shape-bucket + dtype + semiring + hardware +
    epilogue spec tag + operand layout.

    ``epilogue`` is the program tag (e.g. ``bias+silu+mul``); ``layout``
    is 'nn'/'nt'/'tn' for which operands stream transposed.  Both change
    the kernel's footprint and runtime, so they plan and cache
    distinctly.
    """
    return (f"{hw.name}/{dtype_str}/{semiring}/{epilogue}/{layout}/"
            f"m{shape_bucket(m)}n{shape_bucket(n)}k{shape_bucket(k)}")


@dataclasses.dataclass(frozen=True)
class CacheEntry:
    """One tuned result: the winning tile plus its provenance."""

    bm: int
    bn: int
    bk: int
    order: str = "k_inner"
    measured_s: float = 0.0
    predicted_s: float = 0.0
    n_tried: int = 0
    source: str = "autotune"
    # Unix time of the measurement — the merge CLI's newest-wins arbiter.
    # Optional (0.0 = unknown age): v2 files without it still load, and
    # from_json's unknown-field filter keeps the file forward-compatible.
    updated_at: float = 0.0

    def to_tile(self) -> TileConfig:
        return TileConfig(bm=self.bm, bn=self.bn, bk=self.bk,
                          order=self.order)

    @staticmethod
    def from_tile(tile: TileConfig, *, measured_s: float = 0.0,
                  predicted_s: float = 0.0, n_tried: int = 0,
                  source: str = "autotune",
                  updated_at: Optional[float] = None) -> "CacheEntry":
        # Measurement-derived entries are stamped (merge's newest-wins
        # arbiter) unless the caller carries an existing timestamp.
        return CacheEntry(bm=tile.bm, bn=tile.bn, bk=tile.bk,
                          order=tile.order, measured_s=measured_s,
                          predicted_s=predicted_s, n_tried=n_tried,
                          source=source,
                          updated_at=time.time() if updated_at is None
                          else updated_at)

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: Dict) -> "CacheEntry":
        fields = {f.name for f in dataclasses.fields(CacheEntry)}
        return CacheEntry(**{k: v for k, v in d.items() if k in fields})


class TuningCache:
    """Dict-like persistent store; every ``put`` saves atomically."""

    def __init__(self, path: Optional[os.PathLike] = None,
                 autosave: bool = True):
        self.path = pathlib.Path(path) if path is not None \
            else default_cache_path()
        self.autosave = autosave
        self._entries: Dict[str, CacheEntry] = {}
        self.load()

    # -- persistence --------------------------------------------------------

    def load(self) -> None:
        self._entries = {}
        try:
            raw = json.loads(self.path.read_text())
        except (OSError, ValueError):
            return  # missing or corrupt: start empty
        if not isinstance(raw, dict) or raw.get("schema") != SCHEMA_VERSION:
            return  # schema mismatch: discard rather than misread fields
        for key, d in raw.get("entries", {}).items():
            try:
                self._entries[key] = CacheEntry.from_json(d)
            except (TypeError, ValueError):
                continue  # skip individually-bad rows

    def save(self) -> None:
        payload = {
            "schema": SCHEMA_VERSION,
            "entries": {k: e.to_json() for k, e in self._entries.items()},
        }
        self.path.parent.mkdir(parents=True, exist_ok=True)
        # Atomic publish: temp file in the same directory, then rename.
        fd, tmp = tempfile.mkstemp(dir=str(self.path.parent),
                                   prefix=self.path.name + ".tmp.")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # -- dict-ish API --------------------------------------------------------

    def get(self, key: str) -> Optional[CacheEntry]:
        return self._entries.get(key)

    def put(self, key: str, entry: CacheEntry) -> None:
        self._entries[key] = entry
        if self.autosave:
            self.save()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def keys(self):
        return self._entries.keys()

    def clear(self) -> None:
        self._entries = {}
        if self.autosave:
            self.save()


# ---------------------------------------------------------------------------
# Multi-target DB merging (ROADMAP: fleet-collected caches)
# ---------------------------------------------------------------------------

def merge_caches(paths: Sequence[os.PathLike],
                 out_path: os.PathLike) -> TuningCache:
    """Union several cache files into one, newest ``updated_at`` winning
    per key (ties — e.g. two un-stamped v2-era entries — go to the later
    argument, so the command line reads oldest-to-newest).

    Keys already carry ``hw.name``, so caches collected on different
    targets merge without collisions: a serve host pointed at the result
    (``REPRO_TORCH_TUNING_CACHE``) gets hits for its own section only.
    """
    merged = TuningCache(out_path, autosave=False)
    merged.clear()
    for path in paths:
        src = TuningCache(path, autosave=False)
        for key in src.keys():
            entry = src.get(key)
            prior = merged.get(key)
            if prior is None or entry.updated_at >= prior.updated_at:
                merged._entries[key] = entry  # keep original timestamp
    merged.save()
    return merged


def lint_cache(path: Optional[os.PathLike] = None, *,
               strip: bool = False) -> Dict[str, Sequence]:
    """Validate every persisted entry
    (:func:`repro_torch.analyze.validate.validate_cache_entry`).

    Returns ``{key: [message, ...]}`` for the entries that flagged, each
    message a diagnostic's text (code, severity, message, context).
    With ``strip=True`` the flagged entries are removed and the cache
    re-saved.
    """
    from repro_torch.analyze.validate import validate_cache_entry

    cache = TuningCache(path, autosave=False)
    flagged: Dict[str, Sequence] = {}
    for key in list(cache.keys()):
        diags = validate_cache_entry(key, cache.get(key))
        if diags:
            flagged[key] = [str(d) for d in diags]
            if strip:
                del cache._entries[key]
    if strip and flagged:
        cache.save()
    return flagged


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tuning.cache",
        description="Tuning-cache maintenance tools.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    mp = sub.add_parser(
        "merge", help="union caches from several targets, newest-wins")
    mp.add_argument("inputs", nargs="+", help="cache JSON files to union")
    mp.add_argument("-o", "--output", required=True, help="merged output")
    lp = sub.add_parser(
        "lint", help="validate every entry against current schema + "
                     "budgets; non-zero exit on findings")
    lp.add_argument("path", nargs="?", default=None,
                    help="cache file (default: REPRO_TORCH_TUNING_CACHE "
                         "/ build/tuning_cache.json)")
    lp.add_argument("--strip", action="store_true",
                    help="remove flagged entries and re-save")
    args = ap.parse_args(argv)

    if args.cmd == "merge":
        merged = merge_caches([pathlib.Path(p) for p in args.inputs],
                              pathlib.Path(args.output))
        targets = sorted({k.split("/", 1)[0] for k in merged.keys()})
        print(f"merged {len(args.inputs)} caches -> {args.output}: "
              f"{len(merged)} entries across targets {targets}")
    elif args.cmd == "lint":
        path = pathlib.Path(args.path) if args.path else None
        n_total = len(TuningCache(path, autosave=False))
        flagged = lint_cache(path, strip=args.strip)
        for key, diags in sorted(flagged.items()):
            for d in diags:
                print(f"{key}: {d}")
        verb = "stripped" if args.strip else "flagged"
        print(f"{len(flagged)}/{n_total} entries {verb} "
              f"({path or default_cache_path()})")
        return 1 if (flagged and not args.strip) else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
