"""The port's Trainer on falcon-mamba-smoke (ssm) and zamba2-smoke
(hybrid) against the JAX package's Trainer, on the CPU:
``test_torch_family_trainer``'s check (the same weights and numpy batches
give the same loss streams, f32 wire and compute, rtol 1e-5, and the same
final parameters) in lazy and CSC, zamba2-smoke at ``microbatches=2``,
and falcon-mamba-smoke guarded with a NaN injected at step 1 (that step
trips in both packages; the port's skip leaves parameters and momentum
bit for bit as they were)."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_family_trainer as fam  # noqa: E402

_one_torch_thread = fam._one_torch_thread

ARCHS = ("falcon-mamba-7b", "zamba2-2.7b")
SSM_CASES = [fam.Case(a, m) for a in ARCHS for m in ("lazy", "csc")] + [
    fam.Case("zamba2-2.7b", microbatches=2),
    fam.Case("falcon-mamba-7b", guarded=True)]


@pytest.mark.parametrize("case", SSM_CASES, ids=str)
def test_trainer_matches_jax(case):
    fam.test_family_trainer_matches_jax(case)
