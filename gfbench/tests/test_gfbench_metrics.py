"""The readers on a made-up trace whose numbers are known: kernels
classed by name, the exposed part of the collectives, the idle share,
the roofline shares from the frozen bytes, the step's FLOP share."""
import pytest

from gfbench.harness import profile
from gfbench.harness.spec import reader
from gfbench.harness.training import Run
from gfbench.tests.conftest import smoke_cell
from gfbench.yardstick import bytes as ybytes
from gfbench.yardstick import flops, peaks


def ev(name, start, end, kind="kernel"):
    return {"ph": "X", "cat": kind, "name": name, "ts": start * 1e6,
            "dur": (end - start) * 1e6}


RAW = [
    ev(profile.SPAN, 0.0, 10.0, "user_annotation"),
    ev("aten::mm", 0.5, 9.5, "cpu_op"),
    ev("cudaGraphLaunch", 4.4, 4.6, "cuda_runtime"),
    ev("sm90_xmma_gemm_bf16", 1.0, 4.0),
    ev("void pool_unpack_update_kernel<float>", 4.0, 5.0),
    ev("void pool_pack_kernel<bf16>", 5.0, 5.5),
    ev("void ring_kernel<bf16>", 5.0, 7.0),   # 0.5 s hidden
    ev("ncclDevKernel_AllReduce", 7.0, 7.5),
    ev("Memcpy DtoD", 8.0, 8.5, "gpu_memcpy"),
    ev("gpu annotation", 0.0, 10.0, "gpu_user_annotation"),
    ev("late kernel", 9.9, 11.0),                       # clipped at 10
]


def trace_run(world):
    run = Run(smoke_cell("olmo-smoke-dp2" if world > 1
                         else "olmo-smoke-train"), world)
    run.trace = profile.reduce(RAW, steps=2)
    return run


def least_unpack_s(cell):
    """The smoke pool's unpack-update at the card's bandwidth."""
    gf = cell.workload["gradientflow"]
    pad = gf["chunk_elems"] if gf["mode"] == "csc" else 1
    return ybytes.unpack_update_bytes(
        ybytes.pool_elems(cell.shapes),
        ybytes.pool_elems(cell.shapes, pad)) / peaks.HBM_BYTES_PER_S


def value(name, run):
    return reader(name).read(run)


def test_reduce_keeps_the_span_and_device_work_inside_it():
    t = profile.reduce(RAW, steps=2)
    assert t.span == (0.0, 10.0) and t.window_s == 10.0
    assert all(e.kind in profile.GPU_KINDS for e in t.device)
    assert max(e.end for e in t.device) == 10.0
    # Busy: 1-4, 4-7.5, 8-8.5, 9.9-10.
    assert t.busy_s() == pytest.approx(3 + 3.5 + 0.5 + 0.1)


def test_layer_readers():
    run = trace_run(world=4)
    assert value("model_busy_ms", run) == pytest.approx((3 + 0.1) / 2 * 1e3)
    assert value("backend_busy_ms", run) == pytest.approx(1.5 / 2 * 1e3)
    # The ring under the pack for 0.5 s: 1.5 s of the ring and NCCL's 0.5.
    assert value("allreduce_exposed_ms", run) == pytest.approx(2.0 / 2 * 1e3)
    # The unpack-update ran 1 s over the 2 steps.
    assert value("pool_unpack_roofline_pct", run) == pytest.approx(
        100 * least_unpack_s(run.cell) * 2 / 1.0)
    assert value("device_idle_pct", run) == pytest.approx(100 * (1 - 0.71))
    cell = run.cell
    step = flops.step_flops(cell.config, cell.shapes, cell.rows,
                            cell.seq_len)
    assert value("train_mfu_pct", run) == pytest.approx(
        100 * step * 2 / 10.0 / peaks.BF16_FLOPS)
    assert 0 < value("ring_allreduce_roofline_pct", run) < 100


def test_one_rank_has_no_exchange_to_read():
    run = trace_run(world=1)
    assert value("allreduce_exposed_ms", run) is None
    assert value("ring_allreduce_roofline_pct", run) is None


def test_untraced_run_reads_no_layer():
    run = Run(smoke_cell("olmo-smoke-train"), 1)
    for name in ("model_busy_ms", "backend_busy_ms", "device_idle_pct",
                 "train_mfu_pct", "pool_unpack_roofline_pct",
                 "ring_allreduce_roofline_pct", "allreduce_exposed_ms"):
        assert value(name, run) is None


def test_end_to_end_readers():
    run = Run(smoke_cell("olmo-smoke-train"), 1)
    run.tokens_per_step, run.steps, run.window_s = 128, 10, 2.0
    run.peak_bytes, run.setup_s = 3 * 2 ** 30, 12.5
    assert value("train_tokens_per_s", run) == 640.0
    assert value("peak_mem_gib", run) == 3.0
    assert value("setup_s", run) == 12.5


def test_breakdown():
    b = profile.breakdown(profile.reduce(RAW, steps=2))
    assert b["device_ops"][0][0] == "sm90_xmma_gemm_bf16"
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    # The longest idle gap, 8.5-9.9 s, has aten::mm around its middle.
    assert b["idle_gaps"][0][0] == "aten::mm"
    assert b["idle_gaps"][0][1] == pytest.approx(1.4)
