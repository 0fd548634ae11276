"""The comparison that decides ``correct``, driven through the rest of a
run on the CPU at smoke sizes (the harness's look for a chip skipped):
sound runs of the program come out correct; the timed path broken
underneath comes out not correct, once for each fault a training cell
can have; and the control, the reference one precision down, reads far
above the program. The card's own test runs the control at the cell's
size."""
import contextlib
import json
import time

import pytest
import torch

from gfbench import controls
from gfbench.harness import training
from gfbench.tests.conftest import smoke_cell

SEED = 2 ** 31 + 11


def run(name, seed=SEED):
    result, _, _ = training.run(smoke_cell(name), seed, 0.5, False, "cpu",
                                time.time())
    return result


@contextlib.contextmanager
def fault(kind):
    """The program's timed path broken underneath."""
    from repro_torch.core import engine, lazy_allreduce
    from repro_torch.launch import trainer
    from repro_torch.models import transformer

    mp = pytest.MonkeyPatch()
    if kind == "state_unchanged":
        mp.setattr(engine.OverlapEngine, "run",
                   lambda self, plan, gpool, params, opt, gf, lr,
                   census=None: (params, opt, gf))
    elif kind == "half_batch":
        grads = trainer.Trainer._grads
        mp.setattr(trainer.Trainer, "_grads",
                   lambda self, params, batch, scale=None: grads(
                       self, params, {k: v[:v.shape[0] // 2]
                                      for k, v in batch.items()}, scale))
    elif kind == "loss_altered":
        loss_fn = transformer.TransformerLM.loss_fn

        def altered(self, *a, **kw):
            total, m = loss_fn(self, *a, **kw)
            return total, dict(m, loss=m["loss"] * 1.01)
        mp.setattr(transformer.TransformerLM, "loss_fn", altered)
    elif kind == "no_exchange":
        def local(pool, start, end, wire_dtype, *, algo=None, topo=None,
                  accum_dtype=torch.float32):
            seg = pool[start:end]
            if wire_dtype is not None:
                seg = seg.to(wire_dtype)
            return lazy_allreduce.PendingBucket(seg, None, accum_dtype)
        mp.setattr(lazy_allreduce, "issue_bucket", local)
    try:
        yield
    finally:
        mp.undo()


@pytest.mark.parametrize("name", ["olmo-smoke-train",
                                  "musicgen-smoke-train"])
def test_sound_runs_are_correct(name):
    result = run(name)
    assert result["correct"], result["check"]
    assert list(result)[-1] == "check"
    assert result["metrics"]["train_tokens_per_s"]["value"] > 0


def test_a_window_cell_checks_its_first_call_of_k_steps():
    """A window cell's check follows the window's first call, all K of its
    steps, and reads the momentum after it; an eager cell's three steps
    and its first gradient."""
    window = smoke_cell("olmo-smoke-train")
    K = window.workload["trainer"]["window_steps"]
    assert K > 1
    result, prog, ref = training.run(window, SEED, 0.5, False, "cpu",
                                     time.time())
    assert len(prog.losses) == len(ref.losses) == K
    assert list(result["check"]) == ["loss_gap", "momentum_gap",
                                     "update_gap"]
    result, prog, ref = training.run(smoke_cell("musicgen-smoke-train"),
                                     SEED, 0.5, False, "cpu", time.time())
    assert len(prog.losses) == len(ref.losses) == 3
    assert list(result["check"]) == ["loss_gap", "grad_gap", "update_gap"]


@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch",
                                  "loss_altered"])
@pytest.mark.parametrize("name", ["olmo-smoke-train",
                                  "musicgen-smoke-train"])
def test_faults_are_not_correct(name, kind):
    with fault(kind):
        result = run(name)
    assert not result["correct"], result["check"]


def _dp_worker(rank, port, kind, out):
    from gfbench.harness import launch

    torch.set_num_threads(1)
    launch.join(rank, 2, port, torch.device("cpu"))
    with fault(kind) if kind else contextlib.nullcontext():
        result, _, _ = training.run(smoke_cell("olmo-smoke-dp2"), SEED, 0.5,
                                    False, "cpu", time.time(), rank, 2)
    launch.leave(2)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(result, f)


@pytest.mark.parametrize("kind", [None, "no_exchange", "half_batch"])
def test_two_ranks(kind, tmp_path):
    from gfbench.harness.launch import _free_port

    out = tmp_path / "result.json"
    torch.multiprocessing.start_processes(
        _dp_worker, args=(_free_port(), kind, str(out)), nprocs=2,
        start_method="spawn")
    result = json.loads(out.read_text())
    assert result["correct"] == (kind is None), result["check"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_reads_far_above_the_program(seed):
    """At smoke size the control's largest gap, over the program's on the
    same seed, is three times or more on at least one number."""
    cell = smoke_cell("olmo-smoke-train")
    low = run("olmo-smoke-train", seed)["check"]
    high = controls.readings(cell, seed, ["fp8"], torch.device("cpu"), 0,
                             1)["fp8"]
    assert max(high[k] / low[k]["value"] for k in high) >= 3


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["olmo1b-train", "musicgen-train"])
def test_control_fails_the_cell_at_its_size(name, cuda_device):
    """On the card, at the cell's own size: the control reads above one
    of the cell's limits."""
    from gfbench.harness import spec

    cell = spec.load(name)
    line = controls.readings(cell, 2 ** 31 + 101, ["fp8"], cuda_device, 0, 1)
    limits = cell.workload["limits"]
    assert any(line["fp8"][k] > limits[k] for k in limits)
