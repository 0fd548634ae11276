"""The port's own measurement (``repro_torch.runtime.trace``) on the CPU:

* with no profiler recording no span enters ``record_function``, and the
  counters and call records are kept all the same;
* under a CPU ``torch.profiler`` an eager step and a window leave the
  named spans in the exported chrome trace, each nested in its parent;
* over two gloo ranks the ``comm`` counters of a step are the plan's
  collectives (each bucket, CSC's census sum, the metrics' sums) and
  their payload bytes in the wire dtype, each collective's
  ``comm.all_reduce`` span inside the stage that issued it; over a gloo
  world of one rank every algorithm counts nothing;
* a window's call record is the sum of the records of the same steps
  taken eagerly;
* the registry's parts: ``ops.dispatch_counts`` is its ``dispatch``
  group, a nested call leaves no record of its own, a replay adds its
  capture's counts, the buffer is bounded, ``timed`` adds its seconds.

The card's case (a replay's record carries the capture's counts while
``dispatch_counts`` counts the graph once) is in ``test_torch_cuda.py``.
"""
import dataclasses
import json
import os
import socket
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import base, get_smoke
from repro_torch.kernels import ops
from repro_torch.launch.trainer import Trainer
from repro_torch.runtime import trace

S = 16
PREFIXES = ("launch.", "model.", "gf.", "comm.")


def _cfg(mode, rows=2, world=1, tail=0, wire="float32", algo="flat"):
    model = dataclasses.replace(get_smoke("smollm-135m")[0],
                                compute_dtype="float32")
    return base.TrainConfig(
        model=model, seq_len=S, global_batch=rows * world, attn_chunk=0,
        gradientflow=base.GradientFlowConfig(
            mode=mode, bucket_elems=4096, chunk_elems=512, sparsity=0.5,
            warmup_steps=0, wire_dtype=wire, pipeline_tail_buckets=tail,
            collective_algo=algo, use_kernels=True),
        optimizer=base.OptimizerConfig(
            name="momentum_sgd", learning_rate=0.1, momentum=0.9,
            warmup_steps=2, total_steps=16, schedule="constant"))


def _batches(n, rows=2, seed=0):
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (n, rows, S + 1)))
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def _step_batch(batches, i):
    return {k: v[i] for k, v in batches.items()}


def _window_batch(batches, lo, hi):
    return {k: v[lo:hi] for k, v in batches.items()}


def _profiled(fn):
    """Run ``fn`` under a CPU profiler; (its result, the program's spans
    as (name, parent name or None), in trace order)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans = sorted(((float(e["ts"]), -float(e["dur"]), e["name"], e["tid"])
                    for e in events if e.get("ph") == "X"
                    and e.get("cat") == "user_annotation"
                    and e["name"].startswith(PREFIXES)))
    found, stacks = [], {}
    for ts, neg, name, tid in spans:
        end, stack = ts - neg, stacks.setdefault(tid, [])
        while stack and stack[-1][1] < end:
            stack.pop()
        found.append((name, stack[-1][0] if stack else None))
        stack.append((name, end))
    return out, found


# -- no profiler --------------------------------------------------------------


def test_no_span_enters_record_function_with_the_profiler_off(monkeypatch):
    entered = []

    class Refused:
        def __init__(self, name):
            entered.append(name)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Refused)
    trainer = Trainer(_cfg("csc"), device="cpu")
    state = trainer.init_state(seed=0)
    stage = trainer.gf.stages[-1]
    b = _batches(3)
    state, _ = trainer.build_train_step(stage)(state, _step_batch(b, 0))
    first = trace.records[-1]
    state, _ = trainer.build_train_window(2, stage)(
        state, _window_batch(b, 1, 3))
    assert entered == []
    assert not trace.recording()
    assert first["steps"] == 1 and not first["profiled"]
    assert first["counts"]["dispatch"]["pool_unpack_update.plain"] > 0
    assert trace.records[-1]["steps"] == 2


# -- spans under the profiler -------------------------------------------------


STEP_SPANS = {("launch.call", None), ("model.forward", "launch.call"),
              ("model.backward", "launch.call"), ("gf.pack", "launch.call"),
              ("gf.issue", "launch.call"), ("gf.wait", "launch.call"),
              ("gf.update", "launch.call")}
CSC_SPANS = {("gf.select", "launch.call"), ("gf.gather", "launch.call"),
             ("gf.scatter", "launch.call"), ("gf.census", "launch.call")}
TAIL_SPANS = {("gf.apply_inflight", "launch.call"),
              ("gf.update", "gf.apply_inflight")}


@pytest.mark.parametrize("mode,tail", [("lazy", 0), ("csc", 0),
                                       ("lazy", 2)])
def test_step_and_window_leave_their_spans_nested(mode, tail):
    """One eager step and one window of 2, each one ``launch.call`` with
    the model's and the backend's spans inside it; a pipelined window's
    lane applied inside ``gf.apply_inflight``."""
    trainer = Trainer(_cfg(mode, tail=tail), device="cpu")
    state = trainer.init_state(seed=0)
    step = trainer.build_train_step()
    window = trainer.build_train_window(2)
    b = _batches(3)

    def run():
        s, _ = step(state, _step_batch(b, 0))
        return window(s, _window_batch(b, 1, 3))

    _, spans = _profiled(run)
    calls = [i for i, (name, _) in enumerate(spans) if name == "launch.call"]
    assert len(calls) == 2
    want = STEP_SPANS | (CSC_SPANS if mode == "csc" else set())
    assert set(spans[:calls[1]]) == want
    assert set(spans[calls[1]:]) == want | (TAIL_SPANS if tail else set())
    # Two microbatch-free steps in the window: one forward, one backward
    # each.
    window_spans = [n for n, _ in spans[calls[1]:]]
    assert window_spans.count("model.forward") == 2
    assert window_spans.count("model.backward") == 2
    assert trace.records[-1]["profiled"]


# -- the registry -------------------------------------------------------------


def test_dispatch_counts_is_the_registry_group():
    assert ops.dispatch_counts is trace.counters["dispatch"]
    ops.reset_counts()
    assert trace.counters["dispatch"] == {}
    ops.pool_pack([torch.ones(3)], (0,), (3,), 3, 0, torch.float32)
    assert trace.counters["dispatch"] == {"pool_pack.plain": 1}
    ops.reset_counts()


def test_call_records_nest_replay_and_stay_bounded():
    graph = {"dispatch": {"pool_pack.kernel": 2},
             "comm": {"calls": 3, "bytes": 30}}
    with trace.call(4):
        with trace.call(1):      # a call inside a call: no record
            trace.counters["comm"]["calls"] += 1
        trace.replayed(graph)
    rec = trace.records[-1]
    assert rec["steps"] == 4 and rec["profiled"] == trace.recording()
    assert rec["counts"]["dispatch"] == {"pool_pack.kernel": 2}
    assert rec["counts"]["comm"] == {"calls": 4, "bytes": 30}
    with pytest.raises(ValueError):
        with trace.call(1):
            raise ValueError("no record for a call that raised")
    assert trace.records[-1] is rec
    for _ in range(trace.RECORDS + 5):
        with trace.call(1):
            pass
    assert len(trace.records) == trace.RECORDS
    was = trace.counters["launch"]["warmup_s"]
    with trace.timed("launch.warmup", "launch", "warmup_s") as t:
        pass
    assert t.seconds >= 0
    assert trace.counters["launch"]["warmup_s"] == was + t.seconds


@pytest.mark.parametrize("mode", ["dense", "lazy", "csc"])
def test_window_record_is_the_sum_of_the_eager_steps(mode):
    """A CPU window's record (its bodies run eagerly) equals the records
    of the same three steps taken one call each, from the same state on
    the same batches."""
    b = _batches(3)
    trainer = Trainer(_cfg(mode), device="cpu")
    state = trainer.init_state(seed=0)
    state, _ = trainer.build_train_window(3)(state, _window_batch(b, 0, 3))
    got = trace.records[-1]
    trainer = Trainer(_cfg(mode), device="cpu")
    state = trainer.init_state(seed=0)
    step = trainer.build_train_step()
    want = {}
    for i in range(3):
        state, _ = step(state, _step_batch(b, i))
        assert trace.records[-1]["steps"] == 1
        trace.add(want, trace.records[-1]["counts"])
    assert got["steps"] == 3
    assert got["counts"] == want
    assert got["counts"]["dispatch"]["pool_pack.plain"] == 6


# -- two gloo ranks -----------------------------------------------------------

CASES = {"lazy-flat-bf16": ("lazy", "flat", "bfloat16"),
         "lazy-ring-f32": ("lazy", "pallas_ring", "float32"),
         "csc-ring-bf16": ("csc", "pallas_ring", "bfloat16"),
         "csc-flat-f32": ("csc", "flat", "float32")}


def _dp_worker(rank, port, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    found = {}
    b = _batches(2, rows=4)
    mine = {k: v[:, 2 * rank:2 * rank + 2] for k, v in b.items()}
    for name, (mode, algo, wire) in CASES.items():
        trainer = Trainer(_cfg(mode, world=2, wire=wire, algo=algo),
                          device="cpu")
        state = trainer.init_state(seed=0)
        stage = trainer.gf.stages[-1]
        step = trainer.build_train_step(stage)
        state, _ = step(state, _step_batch(mine, 0))
        (state, metrics), spans = _profiled(
            lambda: step(state, _step_batch(mine, 1)))
        plan = trainer.engine.plan_for(stage)
        found[name] = dict(
            record=trace.records[-1],
            buckets=[t.end - t.start for t in plan.tasks],
            itemsize=torch.empty((), dtype=getattr(torch, wire))
            .element_size(),
            chunks=trainer.gf.num_chunks, metrics=len(metrics),
            spans=sorted(set(spans)))
    dist.destroy_process_group()
    if rank == 0:
        with open(out, "w") as f:
            json.dump(found, f)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("trace_dp") / "found.json"
    torch.multiprocessing.start_processes(
        _dp_worker, args=(_free_port(), str(out)), nprocs=2,
        start_method="spawn")
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("case", list(CASES))
def test_comm_counters_of_a_step_are_the_plans_collectives(two_ranks, case):
    mode = CASES[case][0]
    r = two_ranks[case]
    census = mode == "csc"
    want_calls = len(r["buckets"]) + census + r["metrics"]
    want_bytes = sum(r["buckets"]) * r["itemsize"] \
        + census * r["chunks"] * 4 + r["metrics"] * 4
    assert r["record"]["steps"] == 1 and r["record"]["profiled"]
    assert r["record"]["counts"]["comm"] == {"calls": want_calls,
                                             "bytes": want_bytes}
    spans = {tuple(s) for s in r["spans"]}
    parents = {p for n, p in spans if n == "comm.all_reduce"}
    assert parents == {"gf.issue", "launch.reduce_metrics"} | (
        {"gf.census"} if census else set())
    assert ("launch.reduce_metrics", "launch.call") in spans


ONE_RANK_ALGOS = ("flat", "pallas_ring", "tree", "two_level")


def _one_rank_worker(rank, port, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=rank)
    found = {}
    b = _batches(1)
    for algo in ONE_RANK_ALGOS:
        trainer = Trainer(_cfg("csc", algo=algo), device="cpu")
        state = trainer.init_state(seed=0)
        step = trainer.build_train_step(trainer.gf.stages[-1])
        before = trace.snapshot()
        step(state, _step_batch(b, 0))
        found[algo] = dict(record=trace.records[-1]["counts"],
                           registry=trace.delta(trace.snapshot(), before))
    dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(found, f)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    out = tmp_path_factory.mktemp("trace_one") / "found.json"
    torch.multiprocessing.start_processes(
        _one_rank_worker, args=(_free_port(), str(out)), nprocs=1,
        start_method="spawn")
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("algo", ONE_RANK_ALGOS)
def test_a_world_of_one_rank_counts_no_collective(one_rank, algo):
    r = one_rank[algo]
    assert "comm" not in r["record"] and "comm" not in r["registry"]
    assert r["record"]["dispatch"]
