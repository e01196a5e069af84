"""Build and load the port's CUDA kernels.

Each kernel is one ``.cu`` file under ``repro_torch/csrc/`` with a plain C
entry point (no PyTorch headers); sources may include the shared headers
(``*.cuh``) beside them.  It is compiled with ``nvcc`` for ``sm_90a`` at
first use into ``build/`` at the repository root, one shared library per
source keyed by the hash of the source, every header and the flags, and
bound through ``ctypes``.

A source that holds a line ``// nvcc parts: N`` is compiled as N objects,
one ``nvcc -c -DNVCC_PART=i`` process each (i = 0 .. N-1), all started
together, then linked into its library: the source splits its kernel
instantiations between the parts, so that one long compile becomes N short
ones side by side.  Without ``NVCC_PART`` it is still one translation unit.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict, List

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_PARTS = re.compile(rb"^// nvcc parts: (\d+)\s*$", re.M)

_lock = threading.Lock()
_libs: Dict[pathlib.Path, ctypes.CDLL] = {}
# The seconds each part of a source's last build took, by source name
# (one entry, the whole compile, for a source without parts).
PART_SECONDS: Dict[str, List[float]] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       "/usr/local/cuda/bin): the CUDA kernel cannot be built")


def library_path(source: pathlib.Path) -> pathlib.Path:
    """Where ``source``'s library lives in ``build/``: keyed by the hash of
    the source, of every ``*.cuh`` header beside it (any of them may be
    included) and of the flags, so that editing a header rebuilds."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def parts(source: pathlib.Path) -> int:
    """The number of parts ``source`` is compiled as (its ``// nvcc parts:
    N`` line), or 0 for one translation unit."""
    found = _PARTS.search(source.read_bytes())
    return int(found.group(1)) if found else 0


def _nvcc_run(args, source: pathlib.Path) -> float:
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *args], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode})"
                           f":\n{proc.stdout}\n{proc.stderr}")
    return time.perf_counter() - t0


def build(source: pathlib.Path) -> pathlib.Path:
    """Compile ``source`` into ``build/`` (at :func:`library_path`) and
    return the shared library's path; a fresh build only when missing."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    n = parts(source)
    if not n:
        PART_SECONDS[source.name] = [
            _nvcc_run([*NVCC_FLAGS, "-o", str(tmp), str(source)], source)]
        os.replace(tmp, out)
        return out
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = [tmp.with_suffix(f".part{i}.o") for i in range(n)]
    try:
        with concurrent.futures.ThreadPoolExecutor(n) as pool:
            PART_SECONDS[source.name] = list(pool.map(
                lambda i: _nvcc_run([*compile_flags, f"-DNVCC_PART={i}", "-c",
                                     "-o", str(objs[i]), str(source)], source),
                range(n)))
        _nvcc_run([*NVCC_FLAGS, "-o", str(tmp), *map(str, objs)], source)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)
    return out


def load(source: pathlib.Path,
         bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of ``source`` (built if needed); ``bind`` sets
    its entry points' ``argtypes``/``restype`` once, at first load."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            bind(lib)
            _libs[source] = lib
    return lib
