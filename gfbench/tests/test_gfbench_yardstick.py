"""The frozen yardstick gives the figures PERF.md records, and agrees with
the program's originals it was copied from (the CPU tests may import the
program; the benchmark's run does not read it for these)."""
import json
import math

import numpy as np
import pytest

from gfbench.reference import musicgen, olmo
from gfbench.tests.conftest import ROOT
from gfbench.yardstick import bytes as ybytes
from gfbench.yardstick import flops, peaks
from gfbench.yardstick.tokens import SyntheticLM

OLMO = json.loads((ROOT / "gfbench/configs/olmo-1b.json").read_text())
MUSICGEN = json.loads(
    (ROOT / "gfbench/configs/musicgen-large.json").read_text())


def shapes(arch, conf):
    return {n: s for n, (s, _) in arch.param_shapes(conf).items()}


def test_pool_sizes():
    assert ybytes.pool_elems(shapes(olmo, OLMO)) == 1_176_764_416
    assert ybytes.pool_elems(shapes(musicgen, MUSICGEN)) == 2_454_065_152
    # olmo-1b's pool is 35,912 whole chunks of 32,768: CSC pads nothing.
    assert ybytes.pool_elems(shapes(olmo, OLMO), 32768) == 35912 * 32768


def test_elements_a_step_sends():
    """CSC keeps round(0.15 x 35,912) = 5,387 chunks of olmo-1b's pool,
    353 MB of bf16; lazy sends the whole pool."""
    sh = shapes(olmo, OLMO)
    gf = {"mode": "csc", "chunk_elems": 32768, "sparsity": 0.85}
    assert ybytes.sent_elems(sh, gf) == 5387 * 32768
    assert ybytes.sent_elems(sh, dict(gf, mode="lazy")) == 1_176_764_416


def test_kernel_bounds_as_recorded():
    """PERF.md's kernel table at olmo-1b's lazy pool (3.35 TB/s): the
    8-span unpack-update 7.377 ms, the bf16 gradient pack 2.108 ms, the
    f32 master pack 2.810 ms."""
    n = 1_176_764_416
    ms = lambda b: b / peaks.HBM_BYTES_PER_S * 1e3  # noqa: E731
    assert ms(ybytes.unpack_update_bytes(n, n)) == pytest.approx(7.377,
                                                                 abs=5e-4)
    assert ms(ybytes.pack_bytes(n, n, 2)) == pytest.approx(2.108, abs=5e-4)
    assert ms(ybytes.pack_bytes(n, n, 4)) == pytest.approx(2.810, abs=5e-4)


def test_ring_bytes():
    # One rank of 4 on 1 M bf16 elements: x and the output, and 6
    # exchange steps of a 256 K segment written and read.
    assert ybytes.ring_hbm_bytes(1 << 20, 4, 2, 2) == \
        2 * (1 << 20) * 2 + 6 * (1 << 18) * 2 * 2
    assert ybytes.ring_link_bytes(1 << 20, 4, 2) == 1.5 * (1 << 20) * 2
    assert ybytes.ring_hbm_bytes(1 << 20, 1, 2, 2) == 0


def test_flops_per_token():
    """olmo-1b: 6 x 1.07 G layer weights + 6 x the 103 M head + 6 x
    2048 x 1024 x 16 of causal attention = 7.46 GFLOP a token."""
    per_tok = flops.step_flops(OLMO, shapes(olmo, OLMO), 1, 2048) / 2048
    assert per_tok == 6 * 1_073_741_824 + 6 * 103_022_592 \
        + 6 * 2048 * 2048 * 16
    assert per_tok == pytest.approx(7.46e9, rel=1e-3)


@pytest.mark.parametrize("arch", ["olmo-1b", "musicgen-large"])
def test_flops_equal_the_programs_count(arch):
    """The frozen copy against ``chip_smoke.step_flops``'s ``model``
    count at the cells' shapes."""
    import chip_smoke
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.pool import GradientPool
    from repro_torch.models import build_model
    from repro_torch.models import params as params_mod

    model_cfg, _ = get_arch(arch)
    conf, ref = (OLMO, olmo) if arch == "olmo-1b" else (MUSICGEN, musicgen)
    rows, seq = 8, 2048 if arch == "olmo-1b" else 1500
    cfg = TrainConfig(model=model_cfg, seq_len=seq, global_batch=rows,
                      microbatches=1 if arch == "olmo-1b" else 2)
    pool = GradientPool(params_mod.param_shapes(
        build_model(model_cfg).param_specs()))
    want = chip_smoke.step_flops(cfg, pool)["model"]
    assert flops.step_flops(conf, shapes(ref, conf), rows, seq) == want


@pytest.mark.parametrize("codebooks", [0, 4])
def test_tokens_equal_the_programs_generator(codebooks):
    from repro_torch.data.synthetic import SyntheticLM as Program

    seed = 2 ** 31 + 17
    ours = SyntheticLM(512, seed=seed, num_codebooks=codebooks)
    theirs = Program(512, seed=seed, num_codebooks=codebooks)
    for step, shard in ((0, 0), (5, 3)):
        a = ours.batch_numpy(step, 4, 33, shard)
        b = theirs.batch_numpy(step, 4, 33, shard)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])


def test_tokens_rows_all_differ():
    gen = SyntheticLM(50304, seed=7)
    rows = [tuple(r) for s in range(3)
            for r in gen.batch_numpy(s, 8, 64)["tokens"].tolist()]
    assert len(set(rows)) == len(rows)
    assert math.prod(gen.batch(0, 8, 64)["tokens"].shape) == 8 * 64
