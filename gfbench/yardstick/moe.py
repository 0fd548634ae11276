"""FLOPs of the experts' grouped products a training step, from the rows
the held experts computed (the program's ``moe`` tally ``rows``, a step,
summed over the MoE layers): three products of 2 R d f a forward (gate,
up, down), six in the backward (each one's dX and dW). Layer remat runs
the forward twice."""
from __future__ import annotations


def step_flops(rows: float, d_model: int, d_expert: int,
               remat: bool) -> float:
    forward = 3 * 2 * rows * d_model * d_expert
    return float(forward * (2 if remat else 1) + 2 * forward)
