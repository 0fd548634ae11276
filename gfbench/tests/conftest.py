"""The benchmark's own tests: the plain references, the frozen yardstick,
the files and the format they keep, the comparison that decides
``correct`` and the faults it has to catch, on the CPU at smoke sizes.
Tests that need the card are marked ``cuda`` and skip elsewhere."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

DATA = Path(__file__).resolve().parent / "data"
SMOKE_CELLS = {"olmo-smoke-train": ("olmo-smoke", "tokens-4x32", 1),
               "musicgen-smoke-train": ("musicgen-smoke", "tokens-4x32", 1),
               "olmo-smoke-dp2": ("olmo-smoke", "tokens-4x32-dp2", 2)}


def smoke_bench() -> dict:
    """BENCHMARK.json with its metrics, over the smoke configurations and
    cells of ``tests/data``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [
        {"name": n, "file": f"gfbench/tests/data/configs/{n}.json"}
        for n in ("olmo-smoke", "musicgen-smoke")]
    bench["workloads"] = [
        {"name": name, "config": c, "traffic": t, "chips": chips}
        for name, (c, t, chips) in SMOKE_CELLS.items()]
    return bench


def smoke_cell(name: str):
    from gfbench.harness import spec
    return spec.load(name, smoke_bench(), DATA)


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
