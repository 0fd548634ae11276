"""Checkpointing: async, atomic, retained, in the JAX package's format.

Layout per step:  <dir>/step_<n>.tmp/  →  (atomic rename)  →  <dir>/step_<n>/
    manifest.json       {step, per leaf: name, shape, dtype, sha256}
    arrays.npz          one entry per leaf (full logical arrays)

The on-disk format is the JAX package's (``repro/checkpoint/manager.py``),
leaf for leaf, so either package restores the other's checkpoint:

* Leaves come in JAX's pytree order: NamedTuple fields in order, dict keys
  sorted, tuple and list items in order; ``None`` and ``()`` hold none.
  A leaf's name is its path joined by '/' (``params/<key>/...``,
  ``opt/momentum``, ``gf/hg``, ``step``, ``staging``).
* Shapes are the JAX Trainer's logical ones. Each rank of the port holds
  its own row of CSC's ``hg`` and of the low-bit wires' ``residual``
  (``ROW_LEAF_NAMES``); the checkpoint stacks them, one row a data rank,
  ``[N, pool]``, or ``(1, 0)`` when unused. A Python int leaf (the
  ``TrainState.step``) is an int32 scalar.
* ``staging`` is scratch (``SCRATCH_LEAF_NAMES``): saved as an empty array
  marked ``"scratch": true`` and restored from the live state. A bf16
  placeholder is stored as numpy's 2-byte void (npz descr ``'<V2'``, as
  ``ml_dtypes`` writes it) with ``"bfloat16"`` in the manifest; no other
  leaf may have a dtype numpy cannot name.

Across ranks ``save`` is a collective: every rank calls it, the rows are
gathered to rank 0 over the default process group in the call itself
(never on the writer thread, where a collective would interleave with the
step's), and rank 0 alone writes. ``latest_step``, ``available_steps``
and ``restore`` read the directory after a barrier, so every rank calls
them too; each rank restores its own row. The ranks share the directory.
With ``logical=True`` a single process saves or restores a state that
holds the row leaves whole, stacked ``[N, pool]`` (a host state of the
JAX layout: how an elastic relaunch re-splits ``hg``, ``reshard``).

* **Async**: ``save`` copies the state to host memory before it returns
  (the next step overwrites the state's tensors in place), device leaves
  into pinned buffers the manager keeps for the next save; a daemon
  thread hashes and writes; ``wait()`` joins and re-raises its error.
  The JAX package hashes in ``save``; the bytes written are the same.
* **Atomic**: written into ``.tmp``, then ``os.rename``; a crash mid-write
  never corrupts the latest checkpoint.
* **Retention**: keeps the last ``keep`` checkpoints.
* **Integrity**: ``restore`` verifies every leaf's SHA-256 and, when no
  step is named, walks back to the newest checkpoint that is readable and
  checksum-clean (``CheckpointCorrupt`` names the first mismatch).
* **In place**: ``restore(like)`` copies into ``like``'s tensors and
  returns a state that shares their storage, so a CUDA graph captured on
  them replays on the restored values.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


class CheckpointCorrupt(Exception):
    """A checkpoint directory exists but fails integrity verification
    (unreadable archive, missing leaves, or a SHA-256 mismatch)."""


# Leaves that are per-step scratch, not state: the pack's staging pool is
# rewritten every step, and its shape follows the data degree. Saved as
# empty placeholders (marked in the manifest) and restored from the live
# ``like`` state.
SCRATCH_LEAF_NAMES = ("staging",)

# Leaves each data rank holds one row of (the JAX Trainer stacks them).
ROW_LEAF_NAMES = ("gf/hg", "gf/residual")

# numpy has no bfloat16: a bf16 scratch placeholder is the 2-byte void.
_BF16 = "bfloat16"
_BF16_DESCR = "<V2"


def is_scratch(name: str) -> bool:
    return name.split("/")[-1] in SCRATCH_LEAF_NAMES


def assert_flushed_state(state: Any, what: str = "checkpoint") -> None:
    """Reject a TrainState carrying a live cross-step pipeline lane
    (``state.inflight`` with leaves): its deferred tail-bucket updates
    exist nowhere but between a window's step bodies, so persisting (or
    restarting from) it would silently drop them. A window flushes its
    lane before it returns. Duck-typed: states without an ``inflight``
    field pass."""
    if getattr(state, "inflight", ()):
        raise ValueError(
            f"state carries an in-flight pipeline lane; {what} requires "
            "a flushed state (use the state a train window returned, not "
            "one taken between its step bodies)")


# -- the state as named leaves ------------------------------------------------


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(name, leaf) pairs in JAX's pytree order (see the module
    docstring)."""
    join = (lambda k: f"{prefix}/{k}") if prefix else str
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in flatten(tree[k], join(k))]
    if _is_namedtuple(tree):
        return [p for f in tree._fields
                for p in flatten(getattr(tree, f), join(f))]
    if isinstance(tree, (tuple, list)):
        return [p for i, x in enumerate(tree) for p in flatten(x, join(i))]
    return [(prefix or "leaf", tree)]


def rebuild(like: Any, leaves: List[Any]) -> Any:
    """``like``'s structure with its leaves replaced, in ``flatten``'s
    order."""
    it = iter(leaves)

    def walk(t):
        if t is None:
            return None
        if isinstance(t, dict):
            new = {k: walk(t[k]) for k in sorted(t)}
            return {k: new[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*(walk(x) for x in t))
        if isinstance(t, (tuple, list)):
            return type(t)(walk(x) for x in t)
        return next(it)
    out = walk(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _numpy_dtype_name(t: torch.Tensor) -> str:
    """The numpy name of ``t``'s dtype ('bfloat16' for bf16, the only
    one numpy cannot name that a placeholder may carry)."""
    if t.dtype == torch.bfloat16:
        return _BF16
    try:
        return str(torch.empty((0,), dtype=t.dtype).numpy().dtype)
    except TypeError as e:
        raise ValueError(f"numpy cannot hold a leaf of {t.dtype}") from e


def _leaf_tensor(name: str, x: Any) -> torch.Tensor:
    """A state leaf as a tensor: a Python int (the step) as int32; a
    bf16 tensor refused (numpy cannot name it without ``ml_dtypes``)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise ValueError(f"{name}: a bfloat16 leaf needs ml_dtypes to "
                             f"be saved; only a scratch placeholder may "
                             f"be bfloat16")
        _numpy_dtype_name(x)
        return x.detach()
    if isinstance(x, (bool, np.bool_)):
        raise ValueError(f"{name}: a bool leaf has no checkpoint form")
    if isinstance(x, (int, np.integer)):
        return torch.tensor(int(x), dtype=torch.int32)
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x)
    raise ValueError(f"{name}: cannot checkpoint a leaf of type "
                     f"{type(x).__name__}")


def _gather_rows(row: torch.Tensor, world: int, rank: int
                 ) -> Optional[torch.Tensor]:
    """This rank's row stacked with the others' into [world, n] on rank 0
    (None elsewhere), or (1, 0) when the rows are empty. Collective: on
    an NCCL group the rows are gathered on the device, otherwise on the
    host."""
    row = row.detach().reshape(-1)
    if row.numel() == 0:
        return row.reshape(1, 0)
    if world == 1:
        return row[None]
    if not (dist.get_backend() == "nccl" and row.is_cuda):
        row = row.cpu()
    rows = [torch.empty_like(row) for _ in range(world)] if rank == 0 \
        else None
    dist.gather(row, gather_list=rows, dst=0)
    return torch.stack(rows) if rank == 0 else None


def _sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _savez(path: str, arrays: List[Tuple[np.ndarray, str]]) -> None:
    """``np.savez(path, leaf_0=..., ...)`` for (array, dtype name) pairs,
    the bf16 placeholders written with the '<V2' descr."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for i, (a, dtype) in enumerate(arrays):
            with zf.open(f"leaf_{i}.npy", "w", force_zip64=True) as f:
                if dtype == _BF16:
                    np.lib.format.write_array_header_1_0(f, {
                        "descr": _BF16_DESCR, "fortran_order": False,
                        "shape": a.shape})
                else:
                    np.lib.format.write_array(f, a, allow_pickle=False)


class CheckpointManager:
    """``writes`` holds one record a checkpoint this rank wrote: its step,
    the writer's seconds (hash and write) and the bytes of its
    ``arrays.npz``."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.writes: List[Dict[str, float]] = []
        # Pinned host buffers the snapshots of device leaves land in,
        # reused by every save (the previous write has finished by then).
        self._pinned: Dict[str, torch.Tensor] = {}

    def _host(self, name: str, t: torch.Tensor, streams: set) -> np.ndarray:
        """A host copy of ``t``: a device tensor into this manager's
        pinned buffer for ``name``, issued on its device's current stream
        (added to ``streams``, which the caller synchronizes); a host
        tensor cloned."""
        if t.device.type != "cuda":
            return t.numpy().copy()
        buf = self._pinned.get(name)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = self._pinned[name] = torch.empty(
                t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        streams.add(torch.cuda.current_stream(t.device))
        return buf.numpy()

    # -- save ---------------------------------------------------------------

    def save(self, step: int, state: Any, blocking: bool = False,
             logical: bool = False) -> None:
        """Save ``state`` as step ``step``. Every rank calls this (with
        ``logical``, the state's row leaves are whole: see the module
        docstring)."""
        assert_flushed_state(state, what="CheckpointManager.save")
        self.wait()  # at most one in-flight save
        world, rank = _world()
        leaves, streams = [], set()
        for name, x in flatten(state):
            if is_scratch(name):
                dtype = _numpy_dtype_name(x) if isinstance(
                    x, torch.Tensor) else str(np.asarray(x).dtype)
                leaves.append((name, np.zeros(
                    (0,), np.uint16 if dtype == _BF16 else dtype), dtype,
                    True))
                continue
            t = _leaf_tensor(name, x)
            if name in ROW_LEAF_NAMES and not logical:
                t = _gather_rows(t, world, rank)
            if rank == 0:
                a = self._host(name, t, streams)
                leaves.append((name, a, str(a.dtype), False))
        if rank != 0:
            return
        for stream in streams:  # the snapshot is complete on return
            stream.synchronize()

        def _write():
            try:
                t0 = time.perf_counter()
                manifest = {"step": int(step), "leaves": [
                    {"name": n, "shape": list(a.shape), "dtype": d,
                     "sha256": _sha256(a), **({"scratch": True} if s
                                              else {})}
                    for n, a, d, s in leaves]}
                tmp = os.path.join(self.directory, f"step_{step}.tmp")
                final = os.path.join(self.directory, f"step_{step}")
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
                npz = os.path.join(tmp, "arrays.npz")
                _savez(npz, [(a, d) for _, a, d, _ in leaves])
                nbytes = os.path.getsize(npz)
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                self._gc()
                self.writes.append(dict(step=int(step), bytes=nbytes,
                                        seconds=time.perf_counter() - t0))
            except BaseException as e:  # propagated on next wait()
                self._error = e

        if blocking:
            _write()
            self._raise_pending()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    @property
    def writing(self) -> bool:
        """True while this rank's writer thread is still writing."""
        return self._thread is not None and self._thread.is_alive()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_pending()

    def _raise_pending(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self._steps_on_disk()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    def _sync(self) -> None:
        """This rank's write finished, then every rank's (a barrier)."""
        self.wait()
        if _world()[0] > 1:
            dist.barrier()

    # -- restore ------------------------------------------------------------

    def _steps_on_disk(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                path = os.path.join(self.directory, name, "manifest.json")
                if os.path.exists(path):
                    out.append(int(name[len("step_"):]))
        return sorted(out)

    def available_steps(self) -> List[int]:
        self._sync()
        return self._steps_on_disk()

    def latest_step(self) -> Optional[int]:
        steps = self.available_steps()
        return steps[-1] if steps else None

    def _load_verified(self, step: int) -> Tuple[Dict, List[np.ndarray]]:
        """Read one checkpoint and verify every leaf against its manifest
        SHA-256. Any read failure or checksum mismatch raises
        ``CheckpointCorrupt`` (a leaf without a checksum is not
        verified)."""
        path = os.path.join(self.directory, f"step_{step}")
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
            with np.load(os.path.join(path, "arrays.npz")) as data:
                leaves = [data[f"leaf_{i}"]
                          for i in range(len(manifest["leaves"]))]
        except Exception as e:
            raise CheckpointCorrupt(
                f"step {step}: unreadable ({type(e).__name__}: {e})") from e
        for a, meta in zip(leaves, manifest["leaves"]):
            want = meta.get("sha256")
            if want is not None and _sha256(a) != want:
                raise CheckpointCorrupt(
                    f"step {step}: leaf {meta['name']} SHA-256 mismatch")
        return manifest, leaves

    def restore(self, like: Any, step: Optional[int] = None,
                logical: bool = False) -> Tuple[int, Any]:
        """Restore into ``like``: every tensor leaf is overwritten in
        place (``copy_``), each rank taking its own row of the row
        leaves; scratch leaves keep the live tensor; a Python int leaf
        becomes the saved value. Returns (step, a state of ``like``'s
        structure sharing its tensors). Shapes and dtypes are strict
        (``ValueError``). Every rank calls this. With ``logical`` the row
        leaves are restored whole (see the module docstring).

        ``step=None`` walks the available checkpoints newest-first and
        loads the first one that verifies — a corrupt latest checkpoint
        (truncated archive, flipped bits) is skipped, not loaded. An
        explicit ``step`` is strict: corruption raises
        ``CheckpointCorrupt``."""
        steps = self.available_steps()
        if step is not None:
            manifest, leaves = self._load_verified(step)
        else:
            if not steps:
                raise FileNotFoundError(
                    f"no checkpoints in {self.directory}")
            last_err: Optional[CheckpointCorrupt] = None
            manifest = None
            for cand in reversed(steps):
                try:
                    manifest, leaves = self._load_verified(cand)
                    step = cand
                    break
                except CheckpointCorrupt as e:
                    last_err = e
            if manifest is None:
                raise CheckpointCorrupt(
                    f"no valid checkpoint in {self.directory} "
                    f"(last error: {last_err})")
        want = flatten(like)
        if len(want) != len(leaves):
            raise ValueError(f"checkpoint has {len(leaves)} leaves, state "
                             f"needs {len(want)}")
        world, rank = _world()
        out = []
        for (name, w), a, meta in zip(want, leaves, manifest["leaves"]):
            if meta["name"] != name:
                raise ValueError(f"checkpoint leaf {meta['name']} where the "
                                 f"state has {name}")
            if meta.get("scratch"):
                out.append(w)  # live shape wins; contents are per-step
                continue
            if meta["dtype"] == _BF16:
                raise ValueError(f"{name}: a bfloat16 leaf needs ml_dtypes "
                                 f"to be restored")
            if name in ROW_LEAF_NAMES and not logical:
                n = w.numel()
                shape = (world, n) if n else (1, 0)
                src = a[rank] if n else a.reshape(0)
                dtype = _numpy_dtype_name(w)
            elif isinstance(w, torch.Tensor):
                shape, src, dtype = tuple(w.shape), a, _numpy_dtype_name(w)
            else:
                shape, src, dtype = (), a, "int32"
            if tuple(a.shape) != shape:
                raise ValueError(f"{name}: shape {tuple(a.shape)} != "
                                 f"expected {shape}")
            if str(a.dtype) != dtype:
                raise ValueError(f"{name}: dtype {a.dtype} != expected "
                                 f"{dtype}")
            if isinstance(w, torch.Tensor):
                w.copy_(torch.from_numpy(np.ascontiguousarray(src))
                        .reshape(w.shape))
                out.append(w)
            else:
                out.append(int(src))
        return step, rebuild(like, out)
