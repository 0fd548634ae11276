"""Training driver of the port: the JAX CLI's flag names for what the
port supports.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 20 --batch 8 --seq-len 256 --use-kernels

``--arch`` takes every id of ``configs.ARCH_IDS`` (the dense, moe,
audio, ssm and hybrid families; ``--reduced`` their smoke
configurations); a vlm
(internvl2-26b) is refused before any step, as the JAX CLI fails on it:
the synthetic stream has no vision embeddings (train it through the
``Trainer`` on ``models.registry.make_batch`` batches). An audio model's
stream tiles its tokens over the codebooks. Runs on the first CUDA card
unless ``--device cpu``. ``--gf-mode``
defaults to ``csc``, as in the JAX CLI, and ``--window-steps`` (K) to 8:
the steps run in windows of K (``Trainer.build_train_window``; on the
card one CUDA graph a window, captured once a stage and replayed), the
CSC warm-up stages snapped to the window grid
(``core.schedule.snap_stages_to_window``), so each window runs under one
stage and each stage builds one window, whose graph and memory are freed
when the schedule leaves the stage; the batches of a window are stacked
on the host and the losses read once a window. ``--window-steps 1`` runs
one eager step at a time, each under the stage ``gf.stage_for_step``
picks. The log shows each step's stage and its sparsity, and tokens/s
over the windows after the first (``ThroughputMeter``: the first window
pays the capture). ``--optimizer`` takes momentum_sgd, lars and adamw;
``--wire-format`` native (the bf16 wire cast), int8 or fp8_e4m3 (1-byte
words with per-chunk scales and error feedback, ``core.wire``;
``--no-error-feedback`` drops the residual). ``--attn-chunk`` N (default
0: full attention) runs blockwise attention beyond N tokens. Gradient
accumulation has no flag, as in the JAX CLI: set
``TrainConfig.microbatches``. Inside an
initialised ``torch.distributed`` group each rank trains on its own shard
of the global batch. ``--mesh DxM`` or ``PxDxM``, the JAX CLI's flag,
lays the ranks out as a ('data', 'model') or ('pod', 'data', 'model')
grid (``launch.mesh.make_mesh``; the product must be the world size,
default world x 1): M > 1 trains the model sharded over its model axis
(``Trainer``'s, each architecture's rule table; every family the CLI
trains, with every ``--optimizer`` and ``--wire-format``), each data
index's M ranks on the same batch shard, the data index counted across
pod x data; a pod axis makes the data reduce's topology two levels
('pod' over 'data'). Windows and checkpoints run under the mesh as
without it (on the card a window whose step sums through gloo, as a
model group's sums do, is refused when it is built: pass
``--window-steps 1`` there).

The loop runs under ``runtime.TrainSupervisor.run_windows`` with a
``checkpoint.CheckpointManager(keep=3)`` in ``--ckpt-dir`` (default: a
fresh temporary directory), as the JAX CLI does: a checkpoint every
``--ckpt-every`` steps (rounded to the window grid; saved at a window's
edge, written on a thread) and a blocking one at the end. A directory
that holds a checkpoint is resumed from: the newest valid one is
restored into the live state, in place, and the run goes on to
``--steps`` (nothing to do when it is there already). A failed window is
restarted from the newest checkpoint (at most 3 times; ``train``
returns the supervisor's ``run_stats``, which count them). In a
single-process run a SIGTERM (a scheduler's preemption notice) ends the
run at the next window edge with a blocking checkpoint there, and the
process exits with 143; launched again with the same flags, it resumes
there and gives the bits of the uninterrupted run (the learning-rate
schedule spans ``--steps``, as in the JAX CLI). A multi-rank run keeps
the default handler: its ranks would see the notice at different
windows. Batches come from a ``data.pipeline.DataPipeline`` by step
index, one shard a rank, made in the loop's thread before each window
(``prefetch=0``).
"""
from __future__ import annotations

import argparse
import math
import signal
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_arch, get_smoke
from repro_torch.configs.base import (GradientFlowConfig, OptimizerConfig,
                                      TrainConfig)
from repro_torch.core.schedule import (snap_stages_to_window, stage_at,
                                       stage_first_steps)
from repro_torch.data.pipeline import DataPipeline
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.trainer import Trainer
from repro_torch.runtime.fault_tolerance import (Preempted,
                                                 SupervisorConfig,
                                                 TrainSupervisor)


class ThroughputMeter:
    """Tokens/s over the steps of this process, the first completed window
    (the one that captures its graph) left out: the clock starts when it
    ends."""

    def __init__(self, tokens_per_step: float):
        self.tokens_per_step = tokens_per_step
        self._t0: Optional[float] = None
        self._steps = 0

    def note(self, n_steps: int, now: Optional[float] = None) -> None:
        """Record ``n_steps`` just finished."""
        now = time.perf_counter() if now is None else now
        if self._t0 is None:
            self._t0 = now  # the first window only starts the clock
        else:
            self._steps += n_steps

    def rate(self, now: Optional[float] = None) -> Optional[float]:
        """Tokens/s, or None until a step after the first window ends."""
        if self._t0 is None or self._steps == 0:
            return None
        now = time.perf_counter() if now is None else now
        return self._steps * self.tokens_per_step / (now - self._t0)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="repro_torch.launch.train")
    p.add_argument("--arch", required=True)
    p.add_argument("--reduced", action="store_true",
                   help="use the smoke-scale config")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--batch", type=int, default=8,
                   help="global batch; split evenly over the ranks")
    p.add_argument("--gf-mode", default="csc",
                   choices=["dense", "lazy", "csc"])
    p.add_argument("--sparsity", type=float, default=0.85)
    p.add_argument("--chunk-elems", type=int, default=2048)
    p.add_argument("--bucket-elems", type=int, default=1 << 22)
    p.add_argument("--csc-warmup", type=int, default=20)
    p.add_argument("--optimizer", default="momentum_sgd",
                   choices=["momentum_sgd", "lars", "adamw"])
    p.add_argument("--lr", type=float, default=0.2)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--attn-chunk", type=int, default=0,
                   help="blockwise attention beyond this many tokens; "
                        "0 = full attention")
    p.add_argument("--use-kernels", action="store_true")
    p.add_argument("--wire-format", default="native",
                   choices=["native", "int8", "fp8_e4m3"])
    p.add_argument("--no-error-feedback", action="store_true",
                   help="drop the quantization-error residual "
                        "(ablation; biased wire)")
    p.add_argument("--window-steps", type=int, default=8,
                   help="K: steps a window (one CUDA graph on the card, "
                        "one host read); 1 = one eager step at a time")
    p.add_argument("--ckpt-dir", default=None,
                   help="default: a fresh temp dir (pass a path to resume)")
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh", default=None,
                   help="DxM: data x model ranks (default: world x 1)")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default=None,
                   help="torch device; default: the first CUDA card")
    return p


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    args = _parser().parse_args(argv)
    if args.window_steps < 1:
        raise ValueError(f"--window-steps must be >= 1, got "
                         f"{args.window_steps}")
    args.mesh_shape = mesh_shape(args.mesh)
    return args


def mesh_shape(spec: Optional[str]) -> Tuple[int, ...]:
    """``--mesh`` as a mesh shape, as the JAX CLI reads it: ``D`` and
    ``DxM`` as (D, 1) and (D, M), ('data', 'model'); ``PxDxM`` as
    (P, D, M), ('pod', 'data', 'model'). None: (world size, 1)."""
    world = torch.distributed.get_world_size() \
        if torch.distributed.is_initialized() else 1
    if spec is None:
        return world, 1
    try:
        shape = tuple(int(x) for x in spec.lower().split("x"))
    except ValueError:
        shape = ()
    if not 1 <= len(shape) <= 3 or min(shape) < 1:
        raise ValueError(f"--mesh takes D, DxM or PxDxM, got {spec!r}")
    if len(shape) == 1:
        shape += (1,)
    if math.prod(shape) != world:
        raise ValueError(f"--mesh {spec}: {math.prod(shape)} ranks, the "
                         f"world has {world}")
    return shape


def build(args: argparse.Namespace) -> Tuple[Trainer, TrainConfig]:
    model_cfg, _ = (get_smoke if args.reduced else get_arch)(args.arch)
    gf = GradientFlowConfig(
        mode=args.gf_mode, bucket_elems=args.bucket_elems,
        chunk_elems=args.chunk_elems, sparsity=args.sparsity,
        momentum=args.momentum, warmup_steps=args.csc_warmup,
        warmup_stages=4, wire_format=args.wire_format,
        error_feedback=not args.no_error_feedback,
        use_kernels=args.use_kernels)
    opt = OptimizerConfig(
        name=args.optimizer, learning_rate=args.lr, momentum=args.momentum,
        warmup_steps=max(args.steps // 20, 1), total_steps=args.steps,
        schedule="warmup_cosine")
    cfg = TrainConfig(model=model_cfg, gradientflow=gf, optimizer=opt,
                      seq_len=args.seq_len, global_batch=args.batch,
                      attn_chunk=args.attn_chunk, seed=args.seed,
                      window_steps=args.window_steps)
    shape = args.mesh_shape
    mesh = make_mesh(shape) if shape[-1] > 1 or len(shape) == 3 else None
    return Trainer(cfg, device=args.device, mesh=mesh), cfg


def _ckpt_dir(args: argparse.Namespace, world: int) -> str:
    """``--ckpt-dir``, or a fresh temporary directory (rank 0's, shared
    with the other ranks)."""
    if args.ckpt_dir is not None:
        return args.ckpt_dir
    path = [tempfile.mkdtemp(prefix="repro_torch_ckpt_")
            if world == 1 or torch.distributed.get_rank() == 0 else None]
    if world > 1:
        torch.distributed.broadcast_object_list(path, src=0)
    return path[0]


def train(args: argparse.Namespace, record: Optional[List[dict]] = None
          ) -> Tuple[Trainer, List[float], List[float], Dict[str, Any]]:
    """Run to step ``args.steps`` under the supervisor, resuming from
    ``--ckpt-dir``. Returns (trainer, losses, step seconds, run stats) of
    the steps this process ran, a restart's replayed steps counted once:
    a step's time is its window's on the host clock, from a device sync
    to the read of the window's losses and another sync, over the
    window's steps (the checkpoint a window's end may start is outside
    it). The run stats are ``TrainSupervisor.run_stats()`` (restarts and
    their causes) and ``preempted``: the step a SIGTERM stopped the run
    at, else None. ``record``, if given, receives one dict a window (its
    first step, length, stage, seconds and, on a CUDA device, the device
    memory reserved after it and the window's ``stats``); a restart
    drops the failed pass's entries, as it drops its losses."""
    trainer, cfg = build(args)
    if cfg.model.family == "vlm":
        # As in the JAX CLI, whose stream lacks them too: a vlm trains
        # through the Trainer on batches that carry them
        # (models.registry.make_batch).
        raise ValueError(
            f"--arch {args.arch}: the CLI's synthetic stream has no "
            f"vision_embeds, which a vlm batch needs; train it through the "
            f"Trainer with models.registry.make_batch batches")
    n = trainer.num_data
    if cfg.global_batch % n:
        raise ValueError(f"--batch {cfg.global_batch} does not split over "
                         f"{n} ranks")
    world = torch.distributed.get_world_size() \
        if torch.distributed.is_initialized() else 1
    rank = trainer.mesh.data_index if trainer.mesh is not None else \
        (torch.distributed.get_rank() if n > 1 else 0)
    # No prefetch thread: its batch making would take the interpreter
    # lock from the host-bound step (data.pipeline).
    pipe = DataPipeline(SyntheticLM(cfg.model.vocab_size, seed=args.seed,
                                    num_codebooks=cfg.model.num_codebooks),
                        cfg.global_batch // n, cfg.seq_len, shard=rank,
                        prefetch=0)
    state = trainer.init_state(args.seed)
    cuda = trainer.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    K = args.window_steps
    stages = snap_stages_to_window(trainer.gf.stages, K)
    firsts = stage_first_steps(stages)
    meter = ThroughputMeter(cfg.global_batch * cfg.seq_len)
    losses: List[float] = []
    seconds: List[float] = []
    step_fns: Dict[int, Callable] = {}
    built = {"window": None, "stage": None}

    def window_fn(start: int, length: int, state):
        stage = stage_at(stages, start, firsts)
        batches = [pipe.next_at(start + i) for i in range(length)]
        sync()
        t0 = time.perf_counter()
        if K == 1:
            if stage.index not in step_fns:
                step_fns[stage.index] = trainer.build_train_step(stage)
            state, metrics = step_fns[stage.index](state, batches[0])
        else:
            if stage.index != built["stage"]:
                if built["window"] is not None:
                    built["window"].release()
                built["window"] = trainer.build_train_window(K, stage)
                built["stage"] = stage.index
            state, metrics = built["window"](state, {
                k: torch.stack([b[k] for b in batches]) for k in batches[0]})
        got = metrics["loss"].reshape(-1).tolist()  # waits for the window
        sync()
        dt = time.perf_counter() - t0
        seconds.extend([dt / length] * length)
        losses.extend(got)
        meter.note(length)
        if record is not None:
            record.append(dict(
                start=start, length=length, stage=stage.index, seconds=dt,
                reserved_bytes=torch.cuda.memory_reserved() if cuda
                else None,
                stats=dict(built["window"].stats) if K > 1 else None))
        rate = meter.rate()
        for s in range(start, start + length):
            if s % args.log_every == 0 or s == args.steps - 1:
                tail = f"{rate:,.0f} tok/s" if rate is not None \
                    else "first window"
                print(f"step {s:5d} stage {stage.index} "
                      f"sparsity {stage.sparsity:.2f} "
                      f"loss {got[s - start]:.4f} "
                      f"({dt / length * 1e3:.1f} ms a step; {tail})",
                      flush=True)
        return state

    ckpt = CheckpointManager(_ckpt_dir(args, world), keep=3,
                             layout=trainer.checkpoint_layout())
    sup = TrainSupervisor(ckpt, SupervisorConfig(
        checkpoint_every=args.ckpt_every))
    # `is not None`: a checkpoint saved at step 0 is a real checkpoint.
    first = ckpt.latest_step()
    if first is not None:
        first, state = ckpt.restore(state)
        print(f"resumed from checkpoint step {first}", flush=True)
    else:
        first = 0
    stats = dict(sup.run_stats(), preempted=None)
    if first >= args.steps:
        print(f"nothing to do: restored step {first} >= --steps "
              f"{args.steps}", flush=True)
        return trainer, losses, seconds, stats

    def on_restore(step: int) -> None:
        del losses[step - first:], seconds[step - first:]
        while record and record[-1]["start"] >= step:
            record.pop()
        pipe.skip_to(step)

    # A scheduler's SIGTERM: a blocking checkpoint at the next window
    # edge, then Preempted (one process only: see the module docstring).
    previous = signal.signal(
        signal.SIGTERM, lambda *_: sup.request_preemption()) \
        if world == 1 else None
    pipe.start(first)
    try:
        sup.run_windows(state, first, args.steps, window_fn, K,
                        on_restore=on_restore)
    except Preempted:
        stats["preempted"] = first + len(losses)
        print(f"preempted: checkpoint saved at step {stats['preempted']}",
              flush=True)
    finally:
        if world == 1:
            signal.signal(signal.SIGTERM, previous
                          if previous is not None else signal.SIG_DFL)
        pipe.stop()
        if built["window"] is not None:
            built["window"].release()
    stats.update(sup.run_stats())
    return trainer, losses, seconds, stats


def main(argv: Optional[List[str]] = None) -> List[float]:
    _, losses, _, stats = train(parse_args(argv))
    if stats["restarts"]:
        print(f"restarts: {stats['restart_causes']}")
    if stats["preempted"] is not None:
        sys.exit(128 + signal.SIGTERM)
    if losses:
        print(f"done: final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
