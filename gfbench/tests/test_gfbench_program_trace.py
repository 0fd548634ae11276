"""The readers of the program's own measurement: ``launch_exposed_ms`` on
made-up traces (idle gaps inside and outside the program's calls and
under a graph replay, none inside, no call at all), ``window_capture_s``, ``allreduce_mb`` and
``allreduce_calls`` on made-up counters and call records, each finding
nothing in a program without ``repro_torch.runtime.trace``; and
``allreduce_mb`` read on the smoke two-rank cell (two gloo ranks) equal
to the kept chunks' bytes (``yardstick/bytes.py``), the census sum's and
the metrics' sums'."""
import collections
import json
import sys

import pytest
import torch

from gfbench.harness import profile
from gfbench.harness.spec import reader
from gfbench.harness.training import Run
from gfbench.tests.conftest import smoke_cell
from gfbench.yardstick import bytes as ybytes

SEED = 2 ** 31 + 23


def ev(name, start, end, kind="kernel"):
    return {"ph": "X", "cat": kind, "name": name, "ts": start * 1e6,
            "dur": (end - start) * 1e6}


def run_of(raw, world=1, steps=2):
    run = Run(smoke_cell("olmo-smoke-dp2" if world > 1
                         else "olmo-smoke-train"), world)
    run.trace = profile.reduce(raw, steps=steps)
    return run


def value(name, run):
    return reader(name).read(run)


KERNELS = [ev(profile.SPAN, 0.0, 10.0, "user_annotation"),
           ev("gemm", 1.0, 3.0), ev("void pool_pack_kernel", 4.0, 6.0),
           ev("Memcpy HtoD", 8.0, 9.0, "gpu_memcpy")]


def test_launch_exposed_counts_idle_inside_the_calls_only():
    # Idle: 0-1, 3-4, 6-8, 9-10; calls 0.5-5 and 7-9.5 (a nested call
    # inside the first): inside them 0.5 + 1 + 1 + 0.5 s over 2 steps.
    raw = KERNELS + [ev("launch.call", 0.5, 5.0, "user_annotation"),
                     ev("launch.call", 2.0, 3.5, "user_annotation"),
                     ev("launch.call", 7.0, 9.5, "user_annotation"),
                     ev("launch.fill", 6.0, 8.0, "user_annotation"),
                     ev("aten::mm", 6.0, 8.0, "cpu_op")]
    assert value("launch_exposed_ms", run_of(raw)) == pytest.approx(1500.0)


def test_launch_exposed_leaves_out_the_graph_replays():
    # The same calls, the second's idle 7-8 under a replay: 0.5 + 1 + 1
    # + 0.5 - 1 s over 2 steps.
    raw = KERNELS + [ev("launch.call", 0.5, 5.0, "user_annotation"),
                     ev("launch.call", 7.0, 9.5, "user_annotation"),
                     ev("launch.replay", 6.5, 8.0, "user_annotation")]
    assert value("launch_exposed_ms", run_of(raw)) == pytest.approx(1000.0)


def test_launch_exposed_reads_zero_with_no_idle_inside_a_call():
    raw = KERNELS + [ev("launch.call", 1.5, 2.5, "user_annotation"),
                     ev("launch.call", 4.0, 6.0, "user_annotation")]
    assert value("launch_exposed_ms", run_of(raw)) == 0.0


def test_launch_exposed_finds_nothing_without_calls():
    raw = KERNELS + [ev("launch.call", 0.5, 5.0, "cpu_op")]
    assert value("launch_exposed_ms", run_of(raw)) is None
    assert value("launch_exposed_ms", Run(smoke_cell("olmo-smoke-train"),
                                          1)) is None


def _record(steps, profiled, calls, nbytes):
    return {"steps": steps, "profiled": profiled,
            "counts": {"comm": {"calls": calls, "bytes": nbytes},
                       "dispatch": {"ring_allreduce.kernel": calls}}}


@pytest.fixture
def program(monkeypatch):
    """The program's registry, emptied for the test."""
    from repro_torch.runtime import trace

    monkeypatch.setattr(trace, "records", collections.deque(maxlen=8))
    monkeypatch.setitem(trace.counters, "launch", {
        "warmup_s": 0.0, "capture_s": 0.0})
    return trace


def test_window_capture_reads_the_launch_counters(program):
    run = Run(smoke_cell("olmo-smoke-train"), 1)
    assert value("window_capture_s", run) is None
    program.counters["launch"].update(warmup_s=2.5, capture_s=4.25)
    assert value("window_capture_s", run) == 6.75


def test_allreduce_readers_take_the_profiled_calls_a_step(program):
    run = Run(smoke_cell("olmo-smoke-dp2"), 2)
    assert value("allreduce_mb", run) is None
    assert value("allreduce_calls", run) is None
    program.records.extend([_record(8, False, 1000, 9e9),
                            _record(8, True, 97, 2_825_000_000),
                            _record(1, False, 7, 1e9),
                            _record(2, True, 27, 706_000_000)])
    assert value("allreduce_mb", run) == pytest.approx(3531.0 / 10)
    assert value("allreduce_calls", run) == pytest.approx(124 / 10)
    one = Run(smoke_cell("olmo-smoke-train"), 1)
    assert value("allreduce_mb", one) is None
    assert value("allreduce_calls", one) is None


def test_a_program_without_the_module_gives_nothing(monkeypatch):
    import repro_torch.runtime

    monkeypatch.delattr(repro_torch.runtime, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.trace", None)
    run = Run(smoke_cell("olmo-smoke-dp2"), 2)
    for name in ("window_capture_s", "allreduce_mb", "allreduce_calls"):
        assert value(name, run) is None


def _dp_worker(rank, port, out):
    from gfbench.harness import launch, training

    torch.set_num_threads(1)
    device = torch.device("cpu")
    launch.join(rank, 2, port, device)
    cell = smoke_cell("olmo-smoke-dp2")
    K = cell.workload["trainer"]["window_steps"]
    trainer = training._trainer(cell, SEED, device)
    state = trainer.init_state(seed=0)
    window = trainer.build_train_window(K, trainer.gf.stages[-1])
    steps = training.batches(cell, SEED, rank, 0, 2 * K)
    state, _ = window(state, training._stack(steps[:K]))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        state, m = window(state, training._stack(steps[K:]))
    run = Run(cell, 2)
    found = {name: value(name, run)
             for name in ("allreduce_mb", "allreduce_calls")}
    found.update(metrics=len(m), pool=trainer.pool.size)
    launch.leave(2)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(found, f)


def test_allreduce_on_the_smoke_cell_is_the_kept_chunks_and_the_census(
        tmp_path):
    from gfbench.harness.launch import _free_port

    out = tmp_path / "found.json"
    torch.multiprocessing.start_processes(
        _dp_worker, args=(_free_port(), str(out)), nprocs=2,
        start_method="spawn")
    found = json.loads(out.read_text())
    cell = smoke_cell("olmo-smoke-dp2")
    gf, shapes = cell.workload["gradientflow"], cell.shapes
    K = cell.workload["trainer"]["window_steps"]
    chunk = gf["chunk_elems"]
    assert found["pool"] == ybytes.pool_elems(shapes, chunk)
    kept = ybytes.sent_elems(shapes, gf)
    census = ybytes.pool_elems(shapes, chunk) // chunk * 4
    # Each metric's K floats are summed once a window: 4 bytes a step.
    sums = found["metrics"] * 4
    assert found["allreduce_mb"] == pytest.approx(
        (kept * 2 + census + sums) / 1e6, rel=1e-12)
    per_bucket = gf["bucket_elems"] // chunk * chunk
    buckets = -(-kept // per_bucket)
    assert found["allreduce_calls"] == pytest.approx(
        buckets + 1 + found["metrics"] / K)
