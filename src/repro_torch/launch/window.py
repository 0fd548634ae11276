"""The training window: up to K steps as one unit with one host read of
the stacked metrics, the port's form of the JAX package's compile-once
window (``repro/launch/trainer.py``, ``build_train_window``: a
``lax.scan`` over the step).

On a CUDA device the window's L step bodies are one CUDA graph, captured
at the first call for each L and replayed after it:

* Before the capture the bodies run once on scratch clones of the state
  (a warm-up: every kernel built, cuBLAS and the process group set up,
  the state unmoved; a ring's device-side sequence words advance by the
  same count on every rank).
* Each body reads its batch, learning rate and step from static device
  buffers, which the host fills before every replay; the learning rates
  are ``lr_at``'s, computed on the CPU as the eager step computes them.
* The graph updates the state's tensors in place. A body that returns a
  new tensor for a piece of state (CSC's chunk norms, the loss scaler)
  has it copied back into the state's own tensor at the graph's end, so
  every replay reads and writes the same tensors; a replay refuses a
  state whose tensors are not the captured ones.
* A kernel's table or learning rate copied from the host comes from a
  pinned arena that lives as long as the graph (``kernels.build``).
* The window holds one graph and its memory pool; ``release`` frees both
  (and the cuBLAS workspaces the capture allocated in that pool). A
  failed capture raises: nothing falls back to the eager loop.
* A gloo collective runs on the host and cannot be captured: a window
  whose step would sum through a gloo group (any algorithm but
  ``pallas_ring``, and the CSC and low-bit census sums) refuses to be
  built on the card (``host_collectives``); such runs take one eager
  step at a time (``--window-steps 1``).
* A restore (``checkpoint.CheckpointManager.restore``) writes into the
  state's own tensors, so the graph replays on the restored values with
  no new capture. A window built before ``Trainer.replan`` holds the old
  plan and refuses to run.

``kernels.ops`` counts launches on the host, so a graph counts its
launches once, at capture; ``stats`` keeps the warm-up's and the
capture's counts and the number of replays apart.

On the CPU (only when asked, ``device='cpu'``) the same bodies run
eagerly, the step handed to the fault hook as a 0-dim tensor as in the
graph.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.optim import lr_at


def _diff(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def host_collectives(trainer, plan) -> List[str]:
    """The sums a step of ``plan`` would run through a gloo process group
    (on the host, so a CUDA graph cannot hold them): every bucket whose
    algorithm is not ``pallas_ring`` (the device ring), and the census
    sum of CSC and the low-bit wires. Empty without a process group, or
    when the default group is NCCL."""
    if not dist.is_initialized() or dist.get_backend() == "nccl":
        return []
    found = [f"the {name} all-reduce of the buckets" for name in sorted(
        {t.algo.name for t in plan.tasks} - {"pallas_ring"})]
    if plan.mode == "csc" or trainer.gf.wire_spec is not None:
        found.append("the census sum")
    return found


class _Inputs:
    """The static device buffers the captured bodies read: the stacked
    batch, the learning rates and the steps, with pinned host staging
    for the fills."""

    def __init__(self, batches: Dict[str, torch.Tensor], length: int,
                 device: torch.device):
        self.length = length
        self.batch = {k: torch.empty(v.shape, dtype=v.dtype, device=device)
                      for k, v in batches.items()}
        self.lr = torch.empty((length,), dtype=torch.float32, device=device)
        self.step = torch.empty((length,), dtype=torch.int64, device=device)
        self.host = {k: torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     for k, t in list(self.batch.items())
                     + [("lr", self.lr), ("step", self.step)]}
        self.filled: Optional[torch.cuda.Event] = None

    def fill(self, batches: Dict[str, torch.Tensor], lrs: torch.Tensor,
             steps: torch.Tensor) -> None:
        """Copy a window's inputs in, on the current stream (the host
        staging is rewritten only once the previous fill has landed)."""
        if set(batches) != set(self.batch):
            raise ValueError(f"batch keys {sorted(batches)}, the window was "
                             f"captured with {sorted(self.batch)}")
        if self.filled is not None and not self.filled.query():
            self.filled.synchronize()
        srcs = dict(batches, lr=lrs, step=steps)
        dsts = dict(self.batch, lr=self.lr, step=self.step)
        for k, dst in dsts.items():
            src = srcs[k]
            if src.shape != dst.shape:
                raise ValueError(f"{k} of shape {tuple(src.shape)}, the "
                                 f"window was captured with "
                                 f"{tuple(dst.shape)}")
            if src.device.type == "cpu":
                src = self.host[k].copy_(src)
            dst.copy_(src, non_blocking=True)
        self.filled = torch.cuda.Event()
        self.filled.record()

    def batch_of(self, i: int) -> Dict[str, torch.Tensor]:
        return {k: v[i] for k, v in self.batch.items()}


class _Graph:
    """One captured window: the graph, what it reads and writes, and the
    host arena its table copies read."""

    def __init__(self, graph, inputs, metrics, arena, ptrs):
        self.graph, self.inputs, self.metrics = graph, inputs, metrics
        self.arena, self.ptrs = arena, ptrs


class TrainWindow:
    """``window(state, batches) -> (state, metrics)`` (see
    ``Trainer.build_train_window``). ``stats``: ``captures``,
    ``replays``, ``warmup_s`` and ``capture_s`` (host seconds of each
    capture's warm-up and of the capture itself), ``warmup_counts`` and
    ``capture_counts`` (the launches ``kernels.ops`` counted in the last
    warm-up and the last capture)."""

    def __init__(self, trainer, window_steps: int, body: Callable, plan,
                 step_plan):
        if trainer.device.type == "cuda":
            host = host_collectives(trainer, step_plan)
            if host:
                raise ValueError(
                    f"a CUDA-graph window cannot capture a step that runs "
                    f"{' and '.join(host)} through the "
                    f"{dist.get_backend()} process group (host "
                    f"collectives): use the device ring (pallas_ring) on "
                    f"a native dense or lazy wire, or one eager step at a "
                    f"time (--window-steps 1)")
        self.trainer = trainer
        self._replans = trainer.replans
        self.window_steps = window_steps
        self.body = body
        self.plan = plan  # the pipelined plan, or None
        self.device = trainer.device
        self.stats = {"captures": 0, "replays": 0, "warmup_s": [],
                      "capture_s": [], "warmup_counts": {},
                      "capture_counts": {}}
        self._graph: Optional[_Graph] = None

    def __call__(self, state, batches: Dict[str, torch.Tensor]):
        from repro_torch.launch.trainer import assert_flushed

        self.trainer.check_current(self._replans, "train window")
        assert_flushed(state, "a train window")
        lens = {v.shape[0] for v in batches.values()}
        if len(lens) != 1 or not 1 <= min(lens) <= self.window_steps:
            raise ValueError(f"stacked batch lengths {sorted(lens)} must "
                             f"agree and lie in [1, {self.window_steps}]")
        length = lens.pop()
        opt_cfg = self.trainer.cfg.optimizer
        lrs = torch.stack([lr_at(opt_cfg, state.step + i)
                           for i in range(length)])
        steps = torch.arange(state.step, state.step + length,
                             dtype=torch.int64)
        if self.device.type != "cuda":
            batches = {k: v.to(self.device) for k, v in batches.items()}
            steps = steps.to(self.device)
            state, metrics = self._run_bodies(
                state, lambda i: {k: v[i] for k, v in batches.items()},
                lambda i: lrs[i], lambda i: steps[i], length)
        else:
            metrics = self._replay(state, batches, lrs, steps, length)
            state = state._replace(step=state.step + length)
        return state, self.trainer.reduce_metrics(metrics)

    def _run_bodies(self, state, batch_of, lr_of, step_of, length: int):
        """``length`` step bodies on ``state``; pipelined, from an empty
        lane, the last lane flushed. Returns (state, stacked metrics)."""
        engine = self.trainer.engine
        if self.plan is not None:
            state = state._replace(inflight=engine.empty_inflight(
                self.plan, device=self.device))
        metrics: List[Dict[str, torch.Tensor]] = []
        for i in range(length):
            state, m = self.body(state, batch_of(i), lr_of(i), step_of(i))
            metrics.append(m)
        if self.plan is not None:
            with torch.no_grad():
                params, opt = engine.apply_inflight(
                    self.plan, state.params, state.opt, state.inflight)
            state = state._replace(params=params, opt=opt, inflight=())
        return state, {k: torch.stack([m[k] for m in metrics])
                       for k in metrics[0]}

    def release(self) -> None:
        """Free the captured graph and its memory pool. cuBLAS keeps a
        workspace a handle and stream, allocated at first use: the ones
        the capture set up live in the graph's pool and would pin part of
        it, so they are dropped too (cuBLAS allocates them anew)."""
        if self._graph is not None:
            self._graph = None
            torch.cuda.synchronize(self.device)
            clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
            if clear is not None:
                clear()
            torch.cuda.empty_cache()

    # -- the CUDA graph -------------------------------------------------------

    def _state_tensors(self, state) -> List[torch.Tensor]:
        guard = list(state.guard) if state.guard else []
        return (list(self.trainer.pool.flat_leaves(state.params))
                + list(state.opt) + list(state.gf) + guard + [state.staging])

    def _replay(self, state, batches, lrs, steps, length):
        g = self._graph
        if g is not None and g.inputs.length != length:
            self.release()
            g = None
        if g is None:
            g = self._graph = self._capture(state, batches, lrs, steps,
                                            length)
        else:
            ptrs = tuple(t.data_ptr() for t in self._state_tensors(state))
            if ptrs != g.ptrs:
                raise ValueError("this window's CUDA graph was captured on "
                                 "other state tensors: pass the state the "
                                 "window returned, or build a new window")
            g.inputs.fill(batches, lrs, steps)
        g.graph.replay()
        self.stats["replays"] += 1
        return {k: v.clone() for k, v in g.metrics.items()}

    def _capture(self, state, batches, lrs, steps, length) -> _Graph:
        from repro_torch.kernels import build, ops

        dev = self.device
        inputs = _Inputs(batches, length, dev)
        inputs.fill(batches, lrs, steps)
        reads = (inputs.batch_of, lambda i: inputs.lr[i],
                 lambda i: inputs.step[i])

        # Warm-up: one body (and the lane's apply) on scratch clones.
        t0 = time.perf_counter()
        before = dict(ops.dispatch_counts)
        scratch = _clone_state(self.trainer, state)
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._run_bodies(scratch, *reads, 1)
        cur.wait_stream(side)
        torch.cuda.synchronize(dev)
        del scratch
        torch.cuda.empty_cache()
        self.stats["warmup_counts"] = _diff(ops.dispatch_counts, before)
        t1 = time.perf_counter()

        graph = torch.cuda.CUDAGraph()
        # Each launch copies at most a table of its leaves and an lr.
        words = 16 * self.trainer.pool.num_tensors * (length + 2) + 1024
        arena = build.HostArena(8 * words)
        before = dict(ops.dispatch_counts)
        try:
            with build.capture_arena(arena), torch.cuda.graph(graph):
                out, metrics = self._run_bodies(state, *reads, length)
                for mine, new in zip(self._state_tensors(state),
                                     self._state_tensors(out)):
                    if new.data_ptr() != mine.data_ptr():
                        mine.copy_(new)
                del out
        except Exception as e:
            raise RuntimeError(f"capturing the {length}-step window as a "
                               f"CUDA graph failed: {e}") from e
        self.stats["capture_counts"] = _diff(ops.dispatch_counts, before)
        self.stats["captures"] += 1
        self.stats["warmup_s"].append(t1 - t0)
        self.stats["capture_s"].append(time.perf_counter() - t1)
        ptrs = tuple(t.data_ptr() for t in self._state_tensors(state))
        return _Graph(graph, inputs, metrics, arena, ptrs)


def _clone_state(trainer, state):
    """A copy of the state's tensors, for a warm-up that must not move
    the real ones."""
    def clone(x):
        return type(x)(*(t.clone() for t in x)) if x else x
    params = trainer.pool.unflatten(
        [p.clone() for p in trainer.pool.flat_leaves(state.params)])
    return state._replace(params=params, opt=clone(state.opt),
                          gf=clone(state.gf), guard=clone(state.guard),
                          staging=state.staging.clone())
