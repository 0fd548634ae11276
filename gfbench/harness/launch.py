"""Processes of a cell on several chips: one a card, each the same
script with its rank, joined in one process group."""
from __future__ import annotations

import datetime
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Tuple


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(script: str, argv: List[str], chips: int,
          t0: float) -> Tuple[int, str]:
    """Run ``script argv --rank r --port p --t0 t0`` for each rank, the
    others' standard output sent to standard error. Waits for all and
    ends the others when one fails. Returns (the first failing exit
    code, or 0; rank 0's standard output), so that the caller prints it
    after every rank has ended."""
    port = _free_port()
    out = tempfile.TemporaryFile(mode="w+")
    procs = [subprocess.Popen(
        [sys.executable, script, *argv, "--rank", str(r), "--port",
         str(port), "--t0", repr(t0)],
        stdout=out if r == 0 else sys.stderr) for r in range(chips)]
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [c for c in codes if c not in (None, 0)]
            if bad:
                return bad[0], ""
            if all(c == 0 for c in codes):
                out.seek(0)
                return 0, out.read()
            time.sleep(0.2)
    finally:
        out.close()
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def join(rank: int, world: int, port: int, device) -> None:
    """This rank's place in the group: NCCL on the cards, gloo on the
    CPU."""
    import torch
    import torch.distributed as dist

    if device.type == "cuda":
        torch.cuda.set_device(device)
    if world > 1:
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=f"tcp://127.0.0.1:{port}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=300))


def leave(world: int) -> None:
    if world > 1:
        import torch.distributed as dist
        dist.destroy_process_group()
