"""One run of a training cell on one rank: set-up, the measured window or
the traced stretch, the comparison with the plain reference.

Set-up builds one ``Trainer`` and its state from the seed's weights and
drives the checked steps through the call the window times: a window
cell's first call on K distinct steps, which captures the K-step CUDA
graph and replays it once, or an eager cell's first three steps. The
reference follows those steps. The window after set-up replays that
same graph, or calls the same eager step, on the steps after them. Every
call's losses are read on the host before the next call, as the
program's CLI reads them.

The measured window runs whole calls while the next one, as long as the
last, would end inside ``seconds``: tokens/s is the tokens of those
calls over the time from the window's start to the end of the last of
them. Under several ranks rank 0's clock decides, and every rank runs
the same calls.
"""
from __future__ import annotations

import gc
import math
import subprocess
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from gfbench.harness import check, profile, weights
from gfbench.harness.spec import Cell, reader
from gfbench.reference import gradientflow as ref_gf
from gfbench.yardstick.tokens import SyntheticLM

EAGER_TRACED_STEPS = 2


class Run:
    """What one rank's run measured; the metrics' readers take it."""

    def __init__(self, cell: Cell, world: int):
        self.cell = cell
        self.world = world
        self.setup_s = 0.0
        self.peak_bytes = 0
        self.steps = 0              # steps of the calls counted (a rank)
        self.window_s = 0.0         # measured window, start to last end
        self.tokens_per_step = 0    # a rank's tokens of one step
        self.trace: Optional[profile.Trace] = None

    @property
    def tokens(self) -> int:
        return self.steps * self.tokens_per_step * self.world


def _model_cfg(cell: Cell):
    """The program's configuration of the cell's model, held against the
    sizes of the configuration's file."""
    from repro_torch.configs import get_arch, get_smoke

    prog = cell.config["program"]
    get = get_smoke if prog.get("smoke") else get_arch
    model_cfg, _ = get(prog["arch"])
    for field, key in prog["sizes"].items():
        have = getattr(model_cfg, field)
        if have != cell.config[key]:
            raise ValueError(f"the program's {prog['arch']} has {field} = "
                             f"{have}, the configuration's {key} is "
                             f"{cell.config[key]}")
    return model_cfg


def _trainer(cell: Cell, seed: int, device):
    from repro_torch.configs.base import (GradientFlowConfig,
                                          OptimizerConfig, TrainConfig)
    from repro_torch.launch.trainer import Trainer

    wl = cell.workload
    gf = GradientFlowConfig(**wl["gradientflow"], use_kernels=True)
    cfg = TrainConfig(model=_model_cfg(cell), gradientflow=gf,
                      optimizer=OptimizerConfig(**wl["optimizer"]),
                      seq_len=cell.seq_len,
                      global_batch=cell.rows * cell.ranks,
                      microbatches=wl["trainer"]["microbatches"],
                      remat=wl["trainer"]["remat"],
                      attn_chunk=wl["trainer"]["attn_chunk"],
                      window_steps=wl["trainer"]["window_steps"], seed=seed)
    return Trainer(cfg, device=device)


def _program_params(trainer, specs, seed: int, std: float, device):
    """The seed's weights in the program's parameter tree."""
    from repro_torch.core.pool import flatten_tree, tree_def, unflatten_tree

    leaves = []
    for path, shape in flatten_tree(trainer.specs):
        name = "/".join(path)
        w = weights.draw(specs, name, seed, std, device)
        if tuple(w.shape) != tuple(shape.shape):
            raise ValueError(f"{name}: the reference's {tuple(w.shape)}, "
                             f"the program's {tuple(shape.shape)}")
        leaves.append(w)
    return unflatten_tree(tree_def(trainer.specs), leaves)


def batches(cell: Cell, seed: int, rank: int, first: int,
            count: int) -> List[Dict[str, torch.Tensor]]:
    """This rank's rows of steps ``first`` .. ``first + count - 1``."""
    gen = SyntheticLM(cell.config["vocab_size"], seed=seed,
                      num_codebooks=cell.config.get("num_codebooks", 0),
                      branching=cell.traffic["branching"])
    return [gen.batch(first + i, cell.rows, cell.seq_len, shard=rank)
            for i in range(count)]


def _program_state(trainer, state, specs, seed, std, lr0, wd, device,
                   first_call: int):
    """Each weight's norm of the optimizer's state after the first call:
    the first gradient (one step) or the momentum (a window)."""
    mom = state.opt.momentum
    out = {}
    for leaf in trainer.pool.specs:
        u = mom[leaf.offset:leaf.offset + leaf.size]
        if first_call == 1:
            w0 = weights.draw(specs, leaf.name, seed, std,
                              device).reshape(-1)
            out[leaf.name] = check.first_grad_norm(u, w0, lr0, wd)
        else:
            out[leaf.name] = check.momentum_norm(u)
    return out


def _program_change(trainer, state, specs, seed, std, device):
    from repro_torch.core.pool import flatten_tree

    return {"/".join(path): check.change_norm(
        w, weights.draw(specs, "/".join(path), seed, std, device))
        for path, w in flatten_tree(state.params)}


def _stack(batches: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([b[k] for b in batches]) for k in batches[0]}


def _agree(flag: bool, device) -> bool:
    """Rank 0's decision, on every rank."""
    if not (dist.is_initialized() and dist.get_world_size() > 1):
        return flag
    t = torch.tensor([int(flag)], device=device)
    dist.broadcast(t, 0)
    return bool(t.item())


def _max_over_ranks(x: float, device) -> float:
    if not (dist.is_initialized() and dist.get_world_size() > 1):
        return x
    t = torch.tensor([x], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def _mean_over_ranks(x: float, device) -> float:
    if not (dist.is_initialized() and dist.get_world_size() > 1):
        return x
    t = torch.tensor([x], dtype=torch.float64, device=device)
    dist.all_reduce(t)
    return float(t.item()) / dist.get_world_size()


def power_limit_w() -> Optional[float]:
    """The card's power limit, as nvidia-smi reads it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits",
             f"--id={torch.cuda.current_device()}"],
            capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t0: float, rank: int = 0, world: int = 1, window: bool = True):
    """One run on this rank. Returns (the result line's fields, on every
    rank, which rank 0 prints; the program's and the reference's
    readings). ``window`` False leaves out the measured window and the
    traced stretch: the check alone."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    wl, conf = cell.workload, cell.config
    specs = cell.reference.param_shapes(conf)
    std = conf["initializer_range"]
    K = wl["trainer"]["window_steps"]
    opt = wl["optimizer"]

    trainer = _trainer(cell, seed, device)
    state = trainer.init_state(
        params=_program_params(trainer, specs, seed, std, device))
    stage = trainer.gf.stages[-1]
    n_checked = check.checked_steps(K)
    checked = batches(cell, seed, rank, 0, n_checked)
    distinct = batches(cell, seed, rank, n_checked,
                       cell.traffic["distinct_steps"])
    # The configuration's learning rate, on both sides.
    lr0 = float(ref_gf.lr_at(opt, 0))

    # The checked steps, through the timed call: a window's K steps as
    # the graph the window replays, or the eager step three times.
    call = trainer.build_train_window(K, stage) if K > 1 else \
        trainer.build_train_step(stage)
    prog = check.Readings()
    for first in range(0, n_checked, K):
        if K > 1:
            state, m = call(state, _stack(checked[first:first + K]))
        else:
            state, m = call(state, checked[first])
        prog.losses += m["loss"].reshape(-1).tolist()
        if first == 0:
            prog.state = _program_state(trainer, state, specs, seed, std,
                                        lr0, opt["weight_decay"], device, K)
    prog.change = _program_change(trainer, state, specs, seed, std, device)

    if K > 1:
        feed = [_stack(distinct[i:i + K]) for i in range(0, len(distinct), K)]
    else:
        feed = distinct
    feed = [{k: v.to(device) for k, v in f.items()} for f in feed]
    sync()

    out = Run(cell, world)
    out.tokens_per_step = cell.rows * cell.seq_len
    if dist.is_initialized() and world > 1:
        dist.barrier()
    out.setup_s = time.time() - t0

    calls = 0

    def one_call():
        nonlocal state, calls
        state, m = call(state, feed[calls % len(feed)])
        losses = m["loss"].reshape(-1).tolist()
        calls += 1
        return losses

    failed = attempted = 0
    if window and trace:
        n = 1 if K > 1 else EAGER_TRACED_STEPS
        one_call()
        with profile.traced() as box:
            for _ in range(n):
                one_call()
        out.trace = profile.reduce(box["events"], n * K)
        out.trace.power_limit_w = power_limit_w() \
            if cuda and rank == 0 else None
        attempted = (n + 1) * K
    elif window:
        sync()
        start = time.perf_counter()
        deadline = start + seconds
        last = begun = start
        while True:
            losses = one_call()
            now = time.perf_counter()
            attempted += K
            failed += sum(1 for x in losses if not math.isfinite(x))
            if now <= deadline or out.steps == 0:
                out.steps += K
                last = now
            took, begun = now - begun, now
            # No call starts that would end after the deadline.
            if not _agree(now + took <= deadline, device):
                break
        out.window_s = last - start

    out.peak_bytes = int(_max_over_ranks(
        float(torch.cuda.max_memory_allocated(device)) if cuda else 0.0,
        device))
    busy = _mean_over_ranks(out.trace.busy_s(), device) \
        if out.trace is not None else None

    # The program's state goes before the reference runs.
    if K > 1:
        call.release()
    del call, state, trainer, feed
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ref = check.reference_readings(
        cell.reference, conf, wl["gradientflow"], opt, specs,
        lambda n: weights.draw(specs, n, seed, std, device), checked, world,
        device, wl["reference_rows"], K,
        matmul=wl.get("reference_matmul", "exact"))
    numbers = check.gaps(prog, ref, check.numbers(K))
    limits = wl["limits"]
    correct = check.verdict(numbers, limits)

    metrics = {}
    for m in cell.metrics(trace):
        value = reader(m["name"]).read(out)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else device.type,
                         "kind": torch.cuda.get_device_name(device)
                         if cuda else "cpu",
                         "count": world,
                         "memory_peak_bytes": out.peak_bytes}}
    if out.trace is not None:
        result["device"]["busy_s"] = busy
        result["device"]["window_s"] = out.trace.window_s
        result["device"]["power_limit_w"] = out.trace.power_limit_w
        result["breakdown"] = profile.breakdown(out.trace)
    result["check"] = {k: {"value": numbers[k], "limit": limits[k]}
                       for k in numbers}
    return result, prog, ref
