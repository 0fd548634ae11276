"""The comparison that decides ``correct`` for a training cell.

Set-up drives the program's checked steps through the timed path's own
call: a window cell's first call, its K steps as the very CUDA graph the
measured window replays after it; an eager cell's first three steps.
The plain reference follows the same steps from the same weights and
rows. Three numbers, each held to its limit from the cell's file:

* ``loss_gap``: the largest gap between the program's and the
  reference's loss over the checked steps (nats);
* the optimizer's state after the first call, a norm a weight: over the
  weights, the largest gap between the program's norm and the
  reference's, over the larger of the reference's norm of that weight
  and of the median weight (of the weights the first call wrote: CSC's
  first step sends a sixth of the pool). An eager cell's first call is
  one step, and its ``grad_gap`` reads the gradient as the optimizer got
  it, worked out from the momentum (g = u / lr - wd w0 where the update
  wrote, zero elsewhere). A window cell's first call is K steps, the
  state after one step is never seen, and its ``momentum_gap`` reads the
  momentum after the K steps;
* ``update_gap``: the same of each weight's change over the checked
  steps, over the weights whose first backward gradient in the
  reference is at least a thousandth of the median weight's (a weight no
  position reads moves by weight decay alone, to rounding).

Under several ranks each rank compares its own state with its own
reference and every gap is the largest over the ranks.
"""
from __future__ import annotations

import statistics
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from gfbench.reference import gradientflow as ref_gf
from gfbench.reference.common import Precision, set_matmul

EAGER_STEPS = 3


def checked_steps(window_steps: int) -> int:
    """Steps the check follows: a window's first call, or three eager
    steps."""
    return window_steps if window_steps > 1 else EAGER_STEPS


def numbers(window_steps: int) -> Tuple[str, str, str]:
    """The names of the three numbers a cell compares."""
    state = "momentum_gap" if window_steps > 1 else "grad_gap"
    return ("loss_gap", state, "update_gap")


class Readings:
    """One side's losses of the checked steps and each weight's norms."""

    def __init__(self):
        self.losses: List[float] = []
        # The optimizer's state after the first call: the first gradient
        # (one step) or the momentum (a window of K).
        self.state: Dict[str, float] = {}
        self.change: Dict[str, float] = {}
        # The reference's first backward gradient (this rank's, before
        # the wire), a norm a weight: which weights the loss reads.
        self.backward: Dict[str, float] = {}


def first_grad_norm(u: torch.Tensor, w0: torch.Tensor, lr0: float,
                    wd: float) -> float:
    g = torch.where(u != 0, u / lr0 - wd * w0, torch.zeros_like(u))
    return float(torch.linalg.vector_norm(g.double()))


def momentum_norm(u: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(u.double()))


def change_norm(w: torch.Tensor, w0: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm((w - w0).double()))


def gaps(prog: Readings, ref: Readings,
         names: Tuple[str, str, str]) -> Dict[str, float]:
    """The three numbers ``names`` (``numbers``) of ``prog`` against
    ``ref``."""
    if len(prog.losses) != len(ref.losses):
        raise ValueError(f"{len(prog.losses)} losses against the "
                         f"reference's {len(ref.losses)}")
    loss = max(abs(a - b) for a, b in zip(prog.losses, ref.losses))
    weights = sorted(ref.state)
    med_s = statistics.median(ref.state[n] for n in weights
                              if ref.state[n] > 0)
    state = max(abs(prog.state[n] - ref.state[n]) / max(ref.state[n], med_s)
                for n in weights)
    med_b = statistics.median(ref.backward.values())
    moved = [n for n in weights if ref.backward[n] >= 1e-3 * med_b]
    med_c = statistics.median(ref.change[n] for n in moved)
    update = max(abs(prog.change[n] - ref.change[n])
                 / max(ref.change[n], med_c) for n in moved)
    out = dict(zip(names, (loss, state, update)))
    if dist.is_initialized() and dist.get_world_size() > 1:
        dev = torch.device("cuda", torch.cuda.current_device()) \
            if dist.get_backend() == "nccl" else torch.device("cpu")
        t = torch.tensor([out[k] for k in names], dtype=torch.float64,
                         device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        out = dict(zip(names, t.tolist()))
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    if set(numbers) != set(limits):
        raise ValueError(f"numbers {sorted(numbers)} against limits "
                         f"{sorted(limits)}")
    return all(numbers[k] == numbers[k] and numbers[k] <= limits[k]
               for k in limits)


def reference_readings(arch, model_cfg: Dict, gf: Dict, opt: Dict,
                       specs: Dict, draw_w0: Callable[[str], torch.Tensor],
                       batches: List[Dict[str, torch.Tensor]], world: int,
                       device, block_rows: int, first_call: int,
                       matmul: str = "exact", precision: str = "exact",
                       exchange: bool = True,
                       rows: Optional[slice] = None) -> Readings:
    """The reference's steps on this rank's ``batches`` (one a step) from
    the weights ``draw_w0`` gives; the optimizer's state is read after
    the first ``first_call`` of them. ``matmul`` is the cell's reference
    precision (``exact`` or ``tf32``). ``precision``, ``exchange`` and
    ``rows`` (the rows of each batch the gradient is taken over) plant
    the control and the faults in the reference's place."""
    set_matmul(matmul)
    prec = Precision(precision)
    shapes = {n: s for n, (s, _) in specs.items()}
    pad = gf["chunk_elems"] if gf["mode"] == "csc" else 1
    pool = ref_gf.Pool(shapes, pad)
    backend = ref_gf.Backend(pool, gf, opt, world, device, exchange)
    w = pool.pack({n: draw_w0(n) for n in pool.order})
    out = Readings()

    def loss_fn(leaves, tokens, labels):
        return arch.loss(leaves, tokens, labels, model_cfg, prec)

    for step, b in enumerate(batches):
        tok, lab = b["tokens"].to(device), b["labels"].to(device)
        if rows is not None:
            tok, lab = tok[rows], lab[rows]
        loss, g = ref_gf.pool_grads(loss_fn, ref_gf.unpack(pool, w), pool,
                                    tok, lab, block_rows)
        if world > 1:
            dist.all_reduce(loss)
            loss = loss / world
        out.losses.append(float(loss))
        if step == 0:
            out.backward = {n: float(torch.linalg.vector_norm(
                pool.leaf(g, n).double())) for n in pool.order}
        g, mask = backend.reduce(g)
        lr = ref_gf.lr_at(opt, step)
        w = backend.update(w, g, mask, lr.to(device))
        del g, mask
        if step + 1 == first_call:
            for n in pool.order:
                u = pool.leaf(backend.momentum, n)
                out.state[n] = first_grad_norm(
                    u, draw_w0(n), float(lr), opt["weight_decay"]) \
                    if first_call == 1 else momentum_norm(u)
    for n in pool.order:
        out.change[n] = change_norm(pool.leaf(w, n), draw_w0(n))
    return out
