"""Data-plane fault injection for the numeric guard rail, in PyTorch:
corrupt the real gradient pool, on the bytes that would cross the wire.

Three fault classes the guard (``core.guard`` + ``optim.scaler``) must
catch:

  'nan'      — a poisoned segment: one NaN makes every parameter NaN two
               steps later if nothing stops it;
  'overflow' — a segment at 2^120, huge but finite in bf16 and f32: the
               state the loss scaler must back off from before the wire
               cast starts to emit Inf;
  'bitflip'  — the exponent MSB of each wire word flipped (a transit
               fault). A word with |x| in [2^-8, 2), where gradients live
               at working loss scales, lands at 2^119 or more (or Inf),
               above the census limit. A flip outside that envelope can
               shrink the value instead (an exponent flip is roughly a
               reciprocal): no magnitude check can see it, and it is out
               of scope, as in the JAX package.

``make_hook(events)`` builds the ``fault_hook(gpool, step)`` of
``Trainer.build_train_step`` and ``build_train_window``: it writes each
event of step ``step`` into the packed local pool, in place, right before
the reduce. A per-step step passes its host int, and choosing the events
is a plain comparison; a window passes the step as a 0-dim device tensor,
and every event is written through a ``torch.where`` select (a masked
XOR for the bit flip) on the device, with no host read, so a hook
captured in a CUDA graph fires on exactly its step at every replay.

``GuardLane`` is the small real-numeric harness of the JAX package's
``repro.runtime.faults``: a pool and the staged guarded engine
(``OverlapEngine.run_guarded``) on one rank, stepped against a fault
schedule, recording per step the verdict, the scaler's trajectory and a
bit-identity check of the skip. Its records are ints, bools and
power-of-two floats, field for field the JAX lane's. ``run(window=K)``
is the JAX package's windowed lane: the steps on the device, faults
chosen by a device step, per-step snapshots stacked and read once a
window, the same records.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs.base import GuardConfig


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One data-plane corruption: pool elements [offset, offset+width)
    at ``step``."""

    step: int
    kind: str  # 'nan' | 'overflow' | 'bitflip'
    offset: int = 0
    width: int = 4


def _flip_exponent_msb(seg: torch.Tensor,
                       fire: Optional[torch.Tensor] = None) -> torch.Tensor:
    """XOR the exponent MSB of each wire word, in place: bit 14 of 16-bit
    floats (bf16 and f16 alike), bit 30 of f32 (other dtypes round-trip
    through f32). ``fire`` (a 0-dim bool tensor) masks the XOR: where it
    is false the words keep their bits. Returns ``seg``."""
    def bit(b, dtype):
        return b if fire is None else fire.to(dtype) * b

    if seg.element_size() == 2:
        seg.view(torch.int16).bitwise_xor_(bit(1 << 14, torch.int16))
        return seg
    f = seg if seg.dtype == torch.float32 else seg.to(torch.float32)
    f.view(torch.int32).bitwise_xor_(bit(1 << 30, torch.int32))
    if f is not seg:
        seg.copy_(f)
    return seg


_FILL = {"nan": float("nan"),
         # Huge but finite in bf16 and f32 (an f16 pool saturates to Inf;
         # the nonfinite flag catches that, see guard.overflow_limit).
         "overflow": 2.0 ** 120}


def _corrupt(gpool: torch.Tensor, ev: FaultEvent,
             fire: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Write one event into ``gpool`` in place, or, given ``fire`` (a
    0-dim bool tensor), select it in where ``fire`` holds; returns
    ``gpool``."""
    seg = gpool[ev.offset:ev.offset + ev.width]
    if ev.kind in _FILL:
        if fire is None:
            seg.fill_(_FILL[ev.kind])
        else:
            seg.copy_(torch.where(fire, _FILL[ev.kind], seg))
    elif ev.kind == "bitflip":
        _flip_exponent_msb(seg, fire)
    else:
        raise ValueError(f"unknown fault kind: {ev.kind!r}")
    return gpool


def apply_faults(gpool: torch.Tensor, step: Union[int, torch.Tensor],
                 events: Sequence[FaultEvent]) -> torch.Tensor:
    """Apply, in place and in order, every event of step ``step``: a host
    int picks the events on the host; a 0-dim tensor on the pool's device
    selects each one in on the device."""
    for ev in events:
        if isinstance(step, torch.Tensor):
            _corrupt(gpool, ev, fire=step == ev.step)
        elif ev.step == step:
            _corrupt(gpool, ev)
    return gpool


def make_hook(events: Sequence[FaultEvent]) -> Callable:
    """The ``fault_hook(gpool, step)`` for
    ``Trainer.build_train_step(fault_hook=...)``."""
    events = tuple(events)

    def hook(gpool, step):
        return apply_faults(gpool, step, events)

    return hook


# -- the guard lane -----------------------------------------------------------


# Lane defaults: gradients from U[0.25, 1) and the scale capped at 2, so
# every wire word stays inside the bitflip-detectable envelope [2^-8, 2)
# while growth (1 -> 2) and backoff (2 -> 1) both happen in a short run.
LANE_GUARD = GuardConfig(init_scale=1.0, growth_interval=6,
                         growth_factor=2.0, backoff_factor=0.5,
                         min_scale=1.0, max_scale=2.0)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.reshape(-1).view(torch.uint8),
                       b.reshape(-1).view(torch.uint8))


class GuardLane:
    """A small guarded training lane over the real numeric path: a
    two-tensor pool, momentum SGD and ``OverlapEngine.run_guarded`` on one
    rank with no process group, stepped against a ``FaultEvent``
    schedule. Each step records

      fault        — the injected kind, or None;
      tripped      — did the in-band verdict reject the step?
      state_frozen — on a rejected step, that the parameters, the
                     momentum, ``hg`` and the residual kept their bits
                     (True on clean steps: nothing to check);
      scale        — the loss scale after the step (a power of two);
      skipped      — rejected steps so far.

    ``device``: the lane's device (the first CUDA card unless given). The
    packs, the updates and CSC's census and gather go through
    ``kernels.ops``: the CUDA kernels on the card, their plain versions
    on the CPU (the JAX lane runs its plain versions; the records are the
    same)."""

    POOL_SIZES = ((96,), (32,))
    CHUNK = 32

    def __init__(self, guard: Optional[GuardConfig] = None, *,
                 mode: str = "lazy", wire_dtype: str = "bfloat16",
                 wire_format: str = "native", seed: int = 0, device=None):
        from repro_torch import resolve_device
        from repro_torch.configs.base import (GradientFlowConfig,
                                              OptimizerConfig)
        from repro_torch.core.engine import OverlapEngine
        from repro_torch.core.gradientflow import GradientFlow
        from repro_torch.core.pool import GradientPool

        self.device = resolve_device(device)
        self.guard = guard or LANE_GUARD
        self.cfg = GradientFlowConfig(
            mode=mode, bucket_elems=64, chunk_elems=self.CHUNK,
            sparsity=0.5, warmup_steps=0, wire_dtype=wire_dtype,
            reduce_axes=("data",), collective_algo="flat",
            overlap="staged", wire_format=wire_format, guard=self.guard,
            use_kernels=True)
        rng = np.random.default_rng(seed)
        self.params = {
            f"t{i}": torch.from_numpy(
                rng.uniform(0.25, 1.0, s).astype(np.float32)).to(self.device)
            for i, s in enumerate(self.POOL_SIZES)}
        self.pool = GradientPool(
            self.params,
            pad_to=self.CHUNK if (mode == "csc" or self.cfg.quantized)
            else 1)
        self.gf = GradientFlow(self.cfg, self.pool, num_data_shards=1)
        self.opt_cfg = OptimizerConfig(name="momentum_sgd", momentum=0.9,
                                       weight_decay=0.0)
        self.engine = OverlapEngine(self.gf, "momentum_sgd", self.opt_cfg)
        # Base gradients in the detectable envelope (see LANE_GUARD).
        self.base_grads = torch.from_numpy(
            (rng.uniform(0.25, 1.0, self.pool.size) *
             rng.choice([-1.0, 1.0], self.pool.size)).astype(np.float32)
        ).to(self.device)

    def run(self, num_steps: int, events: Sequence[FaultEvent] = (),
            window: int = 1) -> List[dict]:
        """``num_steps`` guarded steps against ``events``, one record a
        step, in windows of ``window`` steps (the JAX package's
        ``_run_windows``; ``window`` = 1 is the per-step lane). Each
        window's steps run on the device with the step a 0-dim device
        tensor (faults selected in on the device), each step's state
        snapshot, scale, skip count and verdict stacked; the stacks are
        read once a window, and the records rebuilt from them, the
        frozen proof against the previous step's snapshot."""
        from repro_torch import optim
        from repro_torch.core import guard as guard_mod
        from repro_torch.optim import scaler as scaler_mod

        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        events = tuple(events)
        by_step = {ev.step: ev for ev in events}
        plan = self.engine.plan_for()
        # CSC and the low-bit wires consume the f32 pool (hg and the
        # residual are added before the wire cast or the quantize).
        prepack = torch.float32 \
            if (self.cfg.csc_enabled or self.cfg.quantized) \
            else getattr(torch, self.cfg.wire_dtype)
        params = {k: v.clone() for k, v in self.params.items()}
        opt = optim.init_state("momentum_sgd", self.pool.size, self.device)
        gfstate = self.gf.init_state(self.device)
        scaler = scaler_mod.init(self.guard, self.device)

        def snapshot():
            return (self.pool.pack(params, dtype=torch.float32)[0].clone(),
                    opt.momentum.clone(), gfstate.hg.clone(),
                    gfstate.residual.clone())

        prev = tuple(x.cpu() for x in snapshot())
        records: List[dict] = []
        for t in range(0, num_steps, window):
            n = min(window, num_steps - t)
            snaps = []
            for i in range(n):
                step = torch.tensor(t + i, device=self.device)
                # The lane's backward pass: the fixed gradients times the
                # live loss scale, packed to the wire dtype.
                gpool = (self.base_grads * scaler.scale).to(prepack)
                gpool = apply_faults(gpool, step, events)
                params, opt, gfstate, scaler, flags = \
                    self.engine.run_guarded(plan, gpool, params, opt,
                                            gfstate, scaler, 0.05)
                snaps.append(snapshot() + (
                    scaler.scale.clone(), scaler.skipped.clone(),
                    guard_mod.tripped(flags)))
            stacked = [torch.stack(col).cpu() for col in zip(*snaps)]
            for i in range(n):
                cur = tuple(x[i] for x in stacked[:4])
                trip = bool(stacked[6][i])
                ev = by_step.get(t + i)
                records.append({
                    "step": t + i,
                    "fault": ev.kind if ev is not None else None,
                    "tripped": trip,
                    "state_frozen": not trip or all(
                        _same_bits(a, b) for a, b in zip(prev, cur)),
                    "scale": float(stacked[4][i]),
                    "skipped": int(stacked[5][i]),
                })
                prev = cur
        return records


def truth_table(records: Sequence[dict]) -> dict:
    """Lane records folded into the detection truth table: per fault
    class, injected against caught (tripped AND bit-identical skip), and
    the false trips on clean steps."""
    table: dict = {}
    false_trips = 0
    for r in records:
        if r["fault"] is None:
            false_trips += int(r["tripped"])
            continue
        row = table.setdefault(r["fault"], {"injected": 0, "caught": 0})
        row["injected"] += 1
        row["caught"] += int(r["tripped"] and r["state_frozen"])
    return {"classes": table, "false_trips": false_trips,
            "clean_steps": sum(1 for r in records if r["fault"] is None)}
