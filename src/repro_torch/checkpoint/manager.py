"""Checkpointing with async writes and verified restore (port of
``repro/checkpoint/manager.py``), over the port's trees of tensors: flat
dicts (params), nested dicts, NamedTuples (``train.step.TrainState``,
``optim.adamw.AdamWState``) and :class:`~repro_torch.quant.QTensor`
leaves (``data``, ``scale`` and a set ``act_scale``).

On disk, the reference's layout: each step is ``step_<n>/host_<id>.npz``
plus ``MANIFEST.json`` (step, keys, shapes, dtypes, a sha256 per shard).
A leaf's key is its path joined by ``/`` (``params/embed``,
``opt/m/embed``, ``nested/b``), the reference's own spelling, so a
checkpoint of fp32 and integer leaves verifies and loads in either
package, whichever wrote it.

* Writes are atomic: a tmp directory, then ``os.replace``, so a crash
  mid-save never leaves a step that looks complete.
* ``keep_last`` garbage collection never deletes the last known-good
  step (the last written, or the last a restore fell back to).
* **Verified restore**: every restore checks the manifest and each
  shard's sha256 first; with no explicit step a corrupt newest step
  falls back to the newest that verifies (``checkpoint.corrupt_total``,
  ``checkpoint.fallback_total``); an explicit corrupt step raises
  :class:`CheckpointCorruptionError`; each verified restore counts
  ``checkpoint.verified_total``.
* ``save_async`` copies every leaf to the host *before* its writer thread
  starts (``.to("cpu", copy=True)``; from the card the copy
  synchronizes), so the next optimizer step, which updates the tensors
  in place, cannot change what is being written.
* **bf16 leaves**: numpy has no bfloat16, and the reference's npz holds
  ``ml_dtypes`` bfloat16 arrays.  The port writes a bf16 leaf as its
  uint16 bit pattern, the manifest's dtype saying ``bfloat16``, and reads
  either form back (a 2-byte void array, as an ``ml_dtypes`` array loads
  without that package, is read as the same bits).  The reference does
  not read the port's bf16 form as bfloat16; fp32 and integer leaves are
  plain arrays in both.
* **Sharded states and elastic restore.** ``save(..., shardings=...)``
  takes a tree of rank-local shards and, per leaf, its
  :class:`~repro_torch.sharding.rules.NamedSharding` (mesh and spec, as
  ``launch.specs.state_inputs`` gives them, FSDP × TP included: a leaf
  split over the batch axes and ``model`` at once): every rank of the mesh
  sends its shard of each leaf (a collective, so ``save_async`` gathers
  before its writer thread starts) to the mesh's first rank, which
  writes the reference's single-host layout.  A blocking sharded save
  ends with a barrier over the mesh; after ``save_async`` every rank
  calls :meth:`wait`, which then is one.  ``restore(like, shardings=...)``
  reads the verified step on each rank and keeps that rank's slice of
  each leaf under *its* sharding, whatever mesh wrote the step: a
  checkpoint restores on any world size, the reference's own included.
  Only the slice is read: the ``.npz`` members are stored uncompressed
  and memory-mapped.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import struct
import threading
import warnings
import zipfile
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.obs import get_metrics
from repro_torch.quant.scales import QTensor
from repro_torch.sharding.rules import ShapeDtypeStruct


class CheckpointCorruptionError(RuntimeError):
    """An explicitly requested checkpoint step failed verification."""


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 22), b""):
            h.update(chunk)
    return h.hexdigest()


def _ckpt_counter(name: str, desc: str):
    return get_metrics().counter(name, desc)


def _join(prefix: str, key) -> str:
    return f"{prefix}/{key}" if prefix else str(key)


def _children(tree):
    """(key, child) pairs of an inner node, in the reference's order
    (dict keys sorted, NamedTuple and QTensor fields in order), or None
    for a leaf."""
    if isinstance(tree, ShapeDtypeStruct):
        return None
    if isinstance(tree, dict):
        return sorted(tree.items())
    if isinstance(tree, QTensor):
        return [(f, getattr(tree, f)) for f in ("data", "scale", "act_scale")
                if getattr(tree, f) is not None]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def _flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Leaves by key, the reference's ``tree_flatten_with_path`` keys."""
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    out: Dict[str, torch.Tensor] = {}
    for key, child in kids:
        out.update(_flatten(child, _join(prefix, key)))
    return out


def _unflatten(like, flat: Dict[str, torch.Tensor], prefix: str = ""):
    """``like``'s structure with each leaf taken from ``flat``."""
    if isinstance(like, ShapeDtypeStruct):
        return flat[prefix]
    if isinstance(like, dict):
        return {k: _unflatten(v, flat, _join(prefix, k))
                for k, v in like.items()}
    if isinstance(like, QTensor):
        return dataclasses.replace(like, **{
            f: flat[_join(prefix, f)] for f, _ in _children(like)})
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(v, flat, _join(prefix, f))
                            for f, v in zip(like._fields, like)))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, flat, _join(prefix, i))
                          for i, v in enumerate(like))
    return flat[prefix]


def _to_host(t) -> np.ndarray:
    """A host copy of one leaf as numpy: a bf16 tensor as its uint16 bit
    pattern."""
    if not isinstance(t, torch.Tensor):
        return np.array(t)
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _dtype_name(t) -> str:
    if isinstance(t, torch.Tensor):
        return str(t.dtype).removeprefix("torch.")
    return str(np.asarray(t).dtype)


def _from_host(arr: np.ndarray, want: Optional[str]) -> torch.Tensor:
    """A stored array back as a tensor: a leaf the manifest calls
    ``bfloat16`` stored as uint16 bits (the port's form) or as 2-byte
    void (an ``ml_dtypes`` array read without that package) becomes
    bf16."""
    arr = np.require(arr, requirements="C")   # keeps 0-d arrays 0-d
    if want == "bfloat16" and arr.dtype.itemsize == 2 \
            and arr.dtype.kind in "uV":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class _NpzMembers:
    """The arrays of an ``.npz`` by key, each stored (uncompressed)
    member memory-mapped where it lies in the file, so a slice of it
    reads only its own bytes; 0-d and compressed members are read
    whole."""

    def __init__(self, path: str):
        self.path = path
        self._zip = zipfile.ZipFile(path)
        self.files = [n[:-4] for n in self._zip.namelist()
                      if n.endswith(".npy")]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._zip.close()

    def __getitem__(self, key: str) -> np.ndarray:
        info = self._zip.getinfo(key + ".npy")
        if info.compress_type != zipfile.ZIP_STORED:
            with self._zip.open(info) as f:
                return np.lib.format.read_array(f)
        with open(self.path, "rb") as f:
            f.seek(info.header_offset)
            local = f.read(30)           # the member's local file header
            n_name, n_extra = struct.unpack("<HH", local[26:30])
            f.seek(info.header_offset + 30 + n_name + n_extra)
            version = np.lib.format.read_magic(f)
            read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                    else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read(f)
            offset = f.tell()
        if not shape or 0 in shape:
            with self._zip.open(info) as f:
                return np.lib.format.read_array(f)
        return np.memmap(self.path, dtype=dtype, mode="r", offset=offset,
                         shape=shape, order="F" if fortran else "C")


def _writer_and_mesh(shardings):
    """The mesh of a sharded save and whether this rank writes (its
    coordinates all 0)."""
    sh = next(v for v in _flatten(shardings).values() if v is not None)
    return sh.mesh, all(c == 0 for c in sh.coords().values())


def _mesh_barrier(mesh) -> None:
    """Every rank of ``mesh`` has reached this point: a barrier over each
    of its axes in turn."""
    import torch.distributed as dist

    for name in mesh.mesh_dim_names:
        dist.barrier(group=mesh.get_group(name))


def _leaf_device(ref, device):
    if device is not None:
        return device
    dev = getattr(ref, "device", None)
    if dev is None or dev.type == "meta":
        from repro_torch.models.model import resolve_device  # lazy: heavy

        return resolve_device(None)
    return dev


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = str(directory)
        self.keep_last = keep_last
        os.makedirs(self.dir, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._pending_mesh = None     # an async sharded save's mesh
        self._last_good: Optional[int] = None  # pinned against GC

    # -- paths ------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def _steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name,
                                               "MANIFEST.json")):
                    steps.append(int(name.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return max(steps) if steps else None

    def _manifest(self, step: int) -> Dict:
        with open(os.path.join(self._step_dir(step), "MANIFEST.json")) as f:
            return json.load(f)

    # -- verification ------------------------------------------------------
    def verify_step(self, step: int) -> bool:
        """True iff ``step``'s manifest parses and every shard matches its
        recorded sha256.  A legacy manifest (no ``checksums``) falls back
        to a load-check of each shard: a truncated ``.npz`` still fails."""
        d = self._step_dir(step)
        try:
            manifest = self._manifest(step)
            if manifest.get("step") != step or "keys" not in manifest:
                return False
        except (OSError, ValueError):
            return False
        checksums = manifest.get("checksums")
        shards = sorted(n for n in os.listdir(d)
                        if n.startswith("host_") and n.endswith(".npz"))
        if not shards:
            return False
        for name in shards:
            path = os.path.join(d, name)
            if checksums is not None:
                want = checksums.get(name)
                if want is None or _sha256(path) != want:
                    return False
            else:  # legacy manifest: at least require a loadable archive
                try:
                    with np.load(path) as data:
                        data.files  # noqa: B018 - forces the zip directory read
                except Exception:  # repro: noqa RPR004 -- any unreadable legacy shard means "not verifiable", by contract
                    return False
        if checksums is not None and set(checksums) - set(shards):
            return False
        return True

    def latest_verifiable_step(self) -> Optional[int]:
        """Newest step that passes :meth:`verify_step` (None if nothing
        does), counting the corrupt steps walked over."""
        for step in reversed(self._steps()):
            if self.verify_step(step):
                return step
            _ckpt_counter(
                "checkpoint.corrupt_total",
                "Checkpoint steps that failed verification").inc()
            warnings.warn(
                f"checkpoint step {step} failed verification; "
                "falling back to an older step", RuntimeWarning)
        return None

    # -- save -------------------------------------------------------------
    def save(self, step: int, tree, *, host_id: int = 0,
             blocking: bool = True, shardings=None):
        """Write ``tree`` as step ``step``.  The host copy of every leaf is
        taken here, before any write starts; ``blocking=False`` writes on
        a background thread (:meth:`wait` joins it).  With ``shardings``
        (a tree of ``NamedSharding`` s, or None for a leaf every rank
        holds whole) ``tree`` holds this rank's shards: every rank of the
        mesh calls this, each leaf is gathered whole onto the mesh's first
        rank here, and that rank writes."""
        self.wait()   # never race an in-flight async write
        flat = _flatten(tree)
        mesh, writer = None, True
        if shardings is not None:
            flat_sh = _flatten(shardings)
            mesh, writer = _writer_and_mesh(shardings)
        host, dtypes = {}, {}
        for k, v in flat.items():
            if shardings is not None and flat_sh.get(k) is not None:
                v = flat_sh[k].gather(v, to_first=True)
            if writer:
                host[k], dtypes[k] = _to_host(v), _dtype_name(v)
        if blocking:
            if writer:
                self._write(step, host, dtypes, host_id)
            if mesh is not None:
                _mesh_barrier(mesh)
            return
        self._pending_mesh = mesh
        if writer:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, dtypes, host_id))
            self._thread.start()

    def save_async(self, step: int, tree, *, host_id: int = 0,
                   shardings=None):
        self.save(step, tree, host_id=host_id, blocking=False,
                  shardings=shardings)

    def wait(self):
        """Join an in-flight async write; after a sharded ``save_async``
        also a barrier over its mesh (every rank calls it)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending_mesh is not None:
            mesh, self._pending_mesh = self._pending_mesh, None
            _mesh_barrier(mesh)

    def _write(self, step: int, host: Dict[str, np.ndarray],
               dtypes: Dict[str, str], host_id: int):
        final = self._step_dir(step)
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        shard = f"host_{host_id:05d}.npz"
        np.savez(os.path.join(tmp, shard), **host)
        manifest = {
            "step": step,
            "keys": sorted(host),
            "shapes": {k: list(v.shape) for k, v in host.items()},
            "dtypes": dtypes,
            "checksums": {shard: _sha256(os.path.join(tmp, shard))},
        }
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._last_good = step  # written and checksummed under the rename
        self._gc()

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.dir)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[:-self.keep_last]:
            if s == self._last_good:
                continue  # never delete the only known-restorable step
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore ----------------------------------------------------------
    def _verified_step(self, step: Optional[int]) -> int:
        if step is not None:
            if not self.verify_step(step):
                _ckpt_counter(
                    "checkpoint.corrupt_total",
                    "Checkpoint steps that failed verification").inc()
                raise CheckpointCorruptionError(
                    f"checkpoint step {step} in {self.dir} failed "
                    "verification (bad manifest or shard checksum)")
        else:
            newest = self.latest_step()
            if newest is None:
                raise FileNotFoundError(f"no checkpoint in {self.dir}")
            step = self.latest_verifiable_step()
            if step is None:
                raise CheckpointCorruptionError(
                    f"no checkpoint step in {self.dir} passes "
                    "verification")
            if step != newest:
                _ckpt_counter(
                    "checkpoint.fallback_total",
                    "Restores that fell back past a corrupt newest "
                    "step").inc()
        _ckpt_counter(
            "checkpoint.verified_total",
            "Checkpoint steps restored after passing verification").inc()
        self._last_good = step
        return step

    def restore(self, like, step: Optional[int] = None, *, device=None,
                shardings=None, host_id: int = 0, subtree: str = ""):
        """Restore into the structure, shapes and dtypes of ``like``.

        Every restore verifies first (:meth:`verify_step`).  With
        ``step=None`` a corrupt newest step falls back to the newest step
        that verifies; an explicit corrupt ``step`` raises
        :class:`CheckpointCorruptionError`.  Each leaf lands on ``device``
        (default: the ``like`` leaf's device; the card for a stand-in or
        a meta leaf) in the ``like`` leaf's dtype.  ``subtree`` names the
        part of the checkpoint ``like`` mirrors (``"params"`` for a train
        state's parameters); the checkpoint's other keys are not read.

        ``shardings`` (``like``'s structure, ``NamedSharding`` leaves, or
        None for a leaf kept whole) is the elastic re-shard: ``like``
        gives each leaf's global shape, and each rank gets its own slice
        under the target sharding, whatever mesh wrote the step."""
        step = self._verified_step(step)
        try:
            dtypes = self._manifest(step).get("dtypes", {})
        except (OSError, ValueError):
            dtypes = {}
        path = os.path.join(self._step_dir(step), f"host_{host_id:05d}.npz")
        flat_like = _flatten(like)
        flat_sh = _flatten(shardings) if shardings is not None else {}
        restored = {}
        with _NpzMembers(path) as data:
            keys = {k: _join(subtree, k) for k in flat_like}
            missing = sorted(set(keys.values()) - set(data.files))
            if missing:
                raise KeyError(f"checkpoint missing keys: {missing[:5]}")
            for k, ref in flat_like.items():
                key = keys[k]
                arr = data[key]
                if list(arr.shape) != list(ref.shape):
                    raise ValueError(f"{key}: checkpoint shape {arr.shape} "
                                     f"!= model {tuple(ref.shape)}")
                if flat_sh.get(k) is not None:
                    arr = arr[flat_sh[k].local_slices(arr.shape)]
                # a copy: the mapping must not outlive this read
                restored[k] = _from_host(np.array(arr, order="C"),
                                         dtypes.get(key)).to(
                    device=_leaf_device(ref, device), dtype=ref.dtype)
        return _unflatten(like, restored)

    # -- quantized serving restore ----------------------------------------
    def restore_quantized(self, like, step: Optional[int] = None, *,
                          qconfig=None, predicate=None, device=None,
                          shardings=None, host_id: int = 0,
                          subtree: str = ""):
        """Restore a *dense* checkpoint of parameters (``like``: a flat
        params dict, e.g. the serve params, whose dtypes the restored
        leaves take) and weight-quantize it for serving through
        ``models.common.quantize_params``.  A ``like`` that already holds
        QTensor leaves restores structurally and is returned as is."""
        from repro_torch.models.common import quantize_params

        tree = self.restore(like, step, device=device, shardings=shardings,
                            host_id=host_id, subtree=subtree)
        if any(isinstance(v, QTensor) for v in tree.values()):
            return tree  # already-quantized checkpoint: nothing to do
        return quantize_params(tree, qconfig=qconfig, predicate=predicate)
