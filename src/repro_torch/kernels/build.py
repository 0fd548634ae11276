"""Build the CUDA kernels at first use and load them with ``ctypes``.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface; all sources compile at once,
one ``nvcc`` process each. Libraries are named by a hash of their source
and flags, so an edited source rebuilds and an unchanged one loads from
the build directory (``kernels/_build/``, listed in ``.gitignore``). The
compiler's ``-Xptxas -v`` report (registers, shared memory, spills) is
kept in ``<lib>.log`` beside each library.

Nothing here runs at import time: the CPU tests import every module of
the package on machines with no ``nvcc``. The few helpers at the end are
what the wrappers share around a launch: the address alignment a plan
reads, the device and stream a launch goes to, at as little host cost as
a Python wrapper can have, and the host-to-device copy of a launch's
small inputs (a segment table, a learning rate), which a CUDA graph
capture takes from a ``HostArena``.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import torch

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
SOURCES = {"pool_pack": "pool_pack.cu", "pool_unpack": "pool_unpack.cu",
           "chunk_l1norm": "chunk_l1norm.cu", "csc_compact": "csc_compact.cu",
           "fused_update": "fused_update.cu", "ring_reduce": "ring_reduce.cu",
           "grouped_mm": "grouped_mm.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the repro_torch CUDA kernels are "
                       "built at first use and need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every source not built yet (in parallel), load every
    library, and return them by name. Raises if a build fails."""
    missing = [n for n in SOURCES if n not in _loaded]
    if not missing:
        return _loaded
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List = []
    for name in missing:
        lib = _lib_path(name)
        if lib.exists():
            continue
        tmp = lib.parent / f"{lib.stem}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        log = open(lib.with_suffix(".log"), "w")
        procs.append((name, lib, tmp, log,
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)))
    failed = []
    for name, lib, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name} (nvcc exit {rc}; see "
                          f"{lib.with_suffix('.log')})")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + ", ".join(failed))
    for name in missing:
        _loaded[name] = ctypes.CDLL(str(_lib_path(name)))
    return _loaded


def library(name: str) -> ctypes.CDLL:
    return build_all()[name]


def build_log(name: str) -> str:
    """The compiler's report for one library (empty if it was loaded from
    an earlier build in this directory)."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


# -- around a launch -----------------------------------------------------------


def base_align(*addresses: int) -> int:
    """The largest power of two up to 16 that divides every address."""
    a = 16
    for x in addresses:
        while x % a:
            a //= 2
    return a


_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def current_stream(device: int) -> int:
    """The handle of PyTorch's current stream on CUDA device ``device``."""
    if _raw_stream is not None:
        return _raw_stream(device)
    return torch.cuda.current_stream(device).cuda_stream


def call_on(device: int, fn, *args):
    """``fn(*args, stream)`` with CUDA device ``device`` current and its
    current stream last: the device is switched only when it is not the
    current one already (the common case costs one query)."""
    if device == torch.cuda.current_device():
        return fn(*args, current_stream(device))
    with torch.cuda.device(device):
        return fn(*args, current_stream(device))


def words(values) -> ctypes.Array:
    """A launch plan as the C launchers read it: int64 words, kept alive
    by the caller (the wrappers cache one per plan)."""
    return (ctypes.c_longlong * len(values))(*values)


class HostArena:
    """Pinned host memory for the host-to-device copies a CUDA graph
    captures. A captured copy reads its source again at every replay, so
    the source must outlive the graph and keep its bytes: a buffer that
    Python frees after the capture would be recycled, and a replay would
    read whatever came next. The arena is allocated before the capture,
    handed out in 8-byte aligned pieces during it, and dropped with the
    graph."""

    def __init__(self, nbytes: int):
        self.buf = torch.empty((nbytes,), dtype=torch.uint8, pin_memory=True)
        self.used = 0

    def take(self, values: torch.Tensor) -> torch.Tensor:
        """A pinned copy of the CPU tensor ``values`` in the arena."""
        n = values.numel() * values.element_size()
        start = -(-self.used // 8) * 8
        if start + n > self.buf.numel():
            raise RuntimeError(f"host arena of {self.buf.numel()} bytes is "
                               f"full ({start} used, {n} more asked)")
        self.used = start + n
        host = self.buf[start:start + n].view(values.dtype)
        return host.view(values.shape).copy_(values)


_ARENA: Optional[HostArena] = None


@contextlib.contextmanager
def capture_arena(arena: HostArena) -> Iterator[HostArena]:
    """Route ``to_device``'s copies through ``arena`` while a CUDA graph
    captures."""
    global _ARENA
    prev, _ARENA = _ARENA, arena
    try:
        yield arena
    finally:
        _ARENA = prev


def to_device(values: torch.Tensor, device) -> torch.Tensor:
    """The CPU tensor ``values`` on ``device``, copied asynchronously on
    the current stream from pinned memory, so a launch never waits for
    the device. While the current stream captures a CUDA graph the pinned
    source comes from the capture's arena (``capture_arena``); a capture
    without one raises rather than leave the graph reading freed
    memory."""
    if torch.cuda.is_current_stream_capturing():
        if _ARENA is None:
            raise RuntimeError(
                "a kernel launch with a host-to-device input was captured "
                "into a CUDA graph outside kernels.build.capture_arena: "
                "replays would read freed host memory")
        host = _ARENA.take(values)
    else:
        host = values.pin_memory()
    return host.to(device, non_blocking=True)
