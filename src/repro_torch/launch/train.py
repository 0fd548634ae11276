"""Training driver of the port: the JAX CLI's flag names for what the
port supports.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 20 --batch 8 --seq-len 256 --use-kernels

Runs on the first CUDA card unless ``--device cpu``. ``--gf-mode``
defaults to ``csc``, as in the JAX CLI: each step runs under the CSC
warm-up stage ``gf.stage_for_step`` picks, with one step function per
stage, and the log shows the stage and its sparsity. ``--optimizer``
takes momentum_sgd, lars and adamw; ``--wire-format`` native (the
bf16 wire cast), int8 or fp8_e4m3 (1-byte words with
per-chunk scales and error feedback, ``core.wire``). Flags the port does
not support yet — compiled windows, checkpoints — raise with a pointer
to ROADMAP.md. Inside an initialised
``torch.distributed`` group each rank trains on its own shard of the
global batch.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs import get_arch, get_smoke
from repro_torch.configs.base import (GradientFlowConfig, OptimizerConfig,
                                      TrainConfig)
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch.trainer import Trainer
from repro_torch.parallel import collectives

_ROADMAP = "is not ported to repro_torch yet; see ROADMAP.md queue A"


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
    p.add_argument("--window-steps", type=int, default=1)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default=None,
                   help="torch device; default: the first CUDA card")
    return p


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    args = _parser().parse_args(argv)
    if args.window_steps > 1:
        raise NotImplementedError("--window-steps > 1 (the compiled "
                                  "window) " + _ROADMAP)
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
                      attn_chunk=0, seed=args.seed, window_steps=1)
    return Trainer(cfg, device=args.device), cfg


def train(args: argparse.Namespace
          ) -> Tuple[Trainer, List[float], List[float]]:
    """Run ``args.steps`` steps. Returns (trainer, losses, step seconds);
    each step's time is taken on the host clock after a device sync."""
    trainer, cfg = build(args)
    n = collectives.data_world_size()
    if cfg.global_batch % n:
        raise ValueError(f"--batch {cfg.global_batch} does not split over "
                         f"{n} ranks")
    rank = torch.distributed.get_rank() if n > 1 else 0
    local_batch = cfg.global_batch // n
    data = SyntheticLM(cfg.model.vocab_size, seed=args.seed)
    state = trainer.init_state(args.seed)
    step_fns: Dict[int, Callable] = {}
    sync = (torch.cuda.synchronize if trainer.device.type == "cuda"
            else (lambda: None))
    losses: List[float] = []
    seconds: List[float] = []
    for s in range(args.steps):
        batch = data.batch(s, local_batch, cfg.seq_len, shard=rank)
        stage = trainer.gf.stage_for_step(s)
        if stage.index not in step_fns:
            step_fns[stage.index] = trainer.build_train_step(stage)
        sync()
        t0 = time.perf_counter()
        state, metrics = step_fns[stage.index](state, batch)
        loss = float(metrics["loss"])  # waits for the step
        sync()
        seconds.append(time.perf_counter() - t0)
        losses.append(loss)
        if s % args.log_every == 0 or s == args.steps - 1:
            print(f"step {s:5d} stage {stage.index} "
                  f"sparsity {stage.sparsity:.2f} loss {loss:.4f} "
                  f"({seconds[-1] * 1e3:.1f} ms)", flush=True)
    return trainer, losses, seconds


def main(argv: Optional[List[str]] = None) -> List[float]:
    _, losses, _ = train(parse_args(argv))
    print(f"done: final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
