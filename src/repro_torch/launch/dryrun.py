"""The dry run's device-free modes, in the port: the overlap engine's
analytic timeline and the elastic soak.

``--timeline`` renders the overlap engine's simulated compute/comm
timeline (per-bucket comm and update start and end, each bucket's exposed
comm, the overlap efficiency) for the paper's AlexNet-class workload on
Cluster-V: pure cost-model arithmetic, nothing allocated. ``--soak``
runs the simulated elastic soak (``runtime.soak``) and prints its
per-event table; its numeric guard lane runs on ``--device`` (the first
CUDA card unless ``--device cpu``). For the same flags the output is the
JAX package's ``python -m repro.launch.dryrun`` output.

The JAX dry run's main mode (``run_cell``: lower and compile every
architecture x shape cell on a 512-device placeholder mesh, parse the
compiled HLO's collectives, and ``make_production_mesh``'s 16x16 and
2x16x16 TPU pods) is XLA compilation and has no PyTorch counterpart
(ROADMAP.md C): without ``--timeline`` or ``--soak`` this CLI exits
non-zero and says so.

Usage:
  python -m repro_torch.launch.dryrun --timeline [--timeline-mode csc]
  python -m repro_torch.launch.dryrun --soak [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
from typing import List, Optional

from repro_torch.configs.base import GradientFlowConfig
from repro_torch.configs.shapes import ALEXNET_GRAD_SHAPES
from repro_torch.core import engine
from repro_torch.core.gradientflow import GradientFlow
from repro_torch.core.pool import GradientPool
from repro_torch.parallel.topology import Topology


def print_timeline(mode: str = "lazy", bucket_elems: int = 0,
                   nodes: int = 64, gpus: int = 8,
                   wire_dtype: str = "float16",
                   pipeline_tail: int = -1) -> None:
    """Simulate and print the overlap engine's StepPlan timeline for the
    AlexNet-class pool on the paper's Cluster-V (cost model only):
    per-bucket comm and update start and end, exposed comm, and the
    overlap-efficiency summary. ``bucket_elems=0`` tunes theta against the
    staged pipeline (the production default). A plan that can pipeline
    across steps (native dense or lazy with a deferred tail;
    ``pipeline_tail`` -1 lets the cost model pick it) also renders the
    two-row cross-step schedule, with its period and exposed comm beside
    the staged timeline's."""
    topo = Topology.cluster_v(nodes=nodes, gpus_per_node=gpus)
    chunk = 32768  # the paper's CSC chunk granularity
    pool = GradientPool({f"t{i}": tuple(s) for i, s in
                         enumerate(ALEXNET_GRAD_SHAPES)},
                        pad_to=chunk if mode == "csc" else 1)
    gf_cfg = GradientFlowConfig(
        mode=mode, wire_dtype=wire_dtype, warmup_steps=0,
        chunk_elems=chunk, sparsity=0.85,
        bucket_elems=bucket_elems or 16 * 1024 * 1024,
        auto_bucket=bucket_elems == 0, topology=topo,
        reduce_axes=("node", "gpu"), collective_algo="auto",
        pipeline_tail_buckets=0 if mode == "csc" else pipeline_tail)
    gf = GradientFlow(gf_cfg, pool, num_data_shards=topo.num_devices)
    plan = gf.plan()
    plan.validate()
    print(f"[timeline] AlexNet-class pool ({pool.size} grads) on "
          f"Cluster-V {nodes}x{gpus}, mode={mode}, "
          f"theta={gf.bucket_elems} elems")
    print(engine.render_timeline(plan, topo))
    if plan.pipeline_tail:
        print()
        print(engine.render_cross_step_timeline(plan, topo))


def print_soak(num_steps: int = 300, seed: int = 0, device=None) -> None:
    """Run the simulated elastic soak (``runtime.soak``) and print the
    per-event table: fault schedule -> checkpoint -> reshard ->
    ``GradientFlow.replan``, with the predicted step time before and
    after each elastic event, and the guard lane's summary (the lane on
    ``device``)."""
    from repro_torch.runtime.soak import SoakConfig, SoakHarness, render_trace

    cfg = dataclasses.replace(SoakConfig(), num_steps=num_steps, seed=seed)
    with tempfile.TemporaryDirectory() as d:
        trace = SoakHarness(cfg, os.path.join(d, "ckpt"),
                            device=device).run()
    print(render_trace(trace))


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="repro_torch.launch.dryrun")
    p.add_argument("--timeline", action="store_true",
                   help="print the overlap engine's simulated "
                        "compute/comm timeline for the AlexNet-class "
                        "workload on Cluster-V (no device)")
    p.add_argument("--timeline-mode", default="lazy",
                   choices=["dense", "lazy", "csc"])
    p.add_argument("--timeline-theta", type=int, default=0,
                   help="bucket elems for the timeline (0 = auto-tune)")
    p.add_argument("--timeline-tail", type=int, default=-1,
                   help="deferred tail buckets for the cross-step "
                        "schedule (-1 = cost-model auto, 0 = off)")
    p.add_argument("--soak", action="store_true",
                   help="run the simulated elastic soak (fault-injected "
                        "512-way churn with StepPlan replan) and print "
                        "the per-event table")
    p.add_argument("--soak-steps", type=int, default=300)
    p.add_argument("--soak-seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="the soak's guard lane device; default: the first "
                        "CUDA card")
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args = _parser().parse_args(argv)
    if args.soak:
        print_soak(num_steps=args.soak_steps, seed=args.soak_seed,
                   device=args.device)
        return
    if args.timeline:
        print_timeline(mode=args.timeline_mode,
                       bucket_elems=args.timeline_theta,
                       pipeline_tail=args.timeline_tail)
        return
    sys.exit("repro_torch.launch.dryrun: pass --timeline or --soak. The "
             "JAX dry run's cell compilation (run_cell, collective_stats) "
             "and its TPU pod meshes (make_production_mesh) are XLA "
             "lowering with no PyTorch counterpart; see ROADMAP.md C.")


if __name__ == "__main__":
    main()
