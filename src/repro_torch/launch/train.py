"""Training driver of the port: the JAX CLI's flag names for what the
port supports.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 20 --batch 8 --seq-len 256 --use-kernels

Runs on the first CUDA card unless ``--device cpu``. ``--gf-mode``
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
words with per-chunk scales and error feedback, ``core.wire``).
Checkpoints (``--ckpt-dir``) are not supported yet and raise with a
pointer to ROADMAP.md. Inside an initialised ``torch.distributed`` group
each rank trains on its own shard of the global batch.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs import get_arch, get_smoke
from repro_torch.configs.base import (GradientFlowConfig, OptimizerConfig,
                                      TrainConfig)
from repro_torch.core.schedule import (snap_stages_to_window, stage_at,
                                       stage_first_steps)
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch.trainer import Trainer
from repro_torch.parallel import collectives

_ROADMAP = "is not ported to repro_torch yet; see ROADMAP.md queue A"


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
    p.add_argument("--use-kernels", action="store_true")
    p.add_argument("--wire-format", default="native",
                   choices=["native", "int8", "fp8_e4m3"])
    p.add_argument("--window-steps", type=int, default=8,
                   help="K: steps a window (one CUDA graph on the card, "
                        "one host read); 1 = one eager step at a time")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default=None,
                   help="torch device; default: the first CUDA card")
    return p


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    args = _parser().parse_args(argv)
    if args.window_steps < 1:
        raise ValueError(f"--window-steps must be >= 1, got "
                         f"{args.window_steps}")
    if args.ckpt_dir is not None:
        raise NotImplementedError("checkpoints (--ckpt-dir) " + _ROADMAP)
    return args


def build(args: argparse.Namespace) -> Tuple[Trainer, TrainConfig]:
    model_cfg, _ = (get_smoke if args.reduced else get_arch)(args.arch)
    gf = GradientFlowConfig(
        mode=args.gf_mode, bucket_elems=args.bucket_elems,
        chunk_elems=args.chunk_elems, sparsity=args.sparsity,
        momentum=args.momentum, warmup_steps=args.csc_warmup,
        warmup_stages=4, wire_format=args.wire_format,
        use_kernels=args.use_kernels)
    opt = OptimizerConfig(
        name=args.optimizer, learning_rate=args.lr, momentum=args.momentum,
        warmup_steps=max(args.steps // 20, 1), total_steps=args.steps,
        schedule="warmup_cosine")
    cfg = TrainConfig(model=model_cfg, gradientflow=gf, optimizer=opt,
                      seq_len=args.seq_len, global_batch=args.batch,
                      attn_chunk=0, seed=args.seed,
                      window_steps=args.window_steps)
    return Trainer(cfg, device=args.device), cfg


def train(args: argparse.Namespace, record: Optional[List[dict]] = None
          ) -> Tuple[Trainer, List[float], List[float]]:
    """Run ``args.steps`` steps. Returns (trainer, losses, step seconds):
    a step's time is its window's on the host clock, from a device sync
    to the read of the window's losses and another sync, over the
    window's steps. ``record``, if given, receives one dict a window
    (its first step, length, stage, seconds and, on a CUDA device, the
    device memory reserved after it and the window's ``stats``)."""
    trainer, cfg = build(args)
    n = collectives.data_world_size()
    if cfg.global_batch % n:
        raise ValueError(f"--batch {cfg.global_batch} does not split over "
                         f"{n} ranks")
    rank = torch.distributed.get_rank() if n > 1 else 0
    local_batch = cfg.global_batch // n
    data = SyntheticLM(cfg.model.vocab_size, seed=args.seed)
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
    window, window_stage = None, None
    for start in range(0, args.steps, K):
        length = min(K, args.steps - start)
        stage = stage_at(stages, start, firsts)
        batches = [data.batch(start + i, local_batch, cfg.seq_len,
                              shard=rank) for i in range(length)]
        sync()
        t0 = time.perf_counter()
        if K == 1:
            if stage.index not in step_fns:
                step_fns[stage.index] = trainer.build_train_step(stage)
            state, metrics = step_fns[stage.index](state, batches[0])
        else:
            if stage.index != window_stage:
                if window is not None:
                    window.release()
                window = trainer.build_train_window(K, stage)
                window_stage = stage.index
            state, metrics = window(state, {
                k: torch.stack([b[k] for b in batches]) for k in batches[0]})
        got = metrics["loss"].reshape(-1).tolist()  # waits for the window
        sync()
        dt = time.perf_counter() - t0
        seconds += [dt / length] * length
        losses += got
        meter.note(length)
        if record is not None:
            record.append(dict(
                start=start, length=length, stage=stage.index, seconds=dt,
                reserved_bytes=torch.cuda.memory_reserved() if cuda
                else None,
                stats=dict(window.stats) if K > 1 else None))
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
    if window is not None:
        window.release()
    return trainer, losses, seconds


def main(argv: Optional[List[str]] = None) -> List[float]:
    _, losses, _ = train(parse_args(argv))
    print(f"done: final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
