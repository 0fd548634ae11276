"""The plain references against themselves at smoke widths, on the
seed's weights: the row blocks they compute in change nothing but
rounding, the control's precision changes the numbers, and the
reference backend does what Algorithm 1 says."""
import math

import pytest
import torch

from gfbench.harness import weights
from gfbench.reference import common
from gfbench.reference import gradientflow as ref_gf
from gfbench.tests.conftest import smoke_cell
from gfbench.yardstick.tokens import SyntheticLM

CELLS = ["olmo-smoke-train", "musicgen-smoke-train"]


def setup(name, seed=2 ** 31 + 3):
    cell = smoke_cell(name)
    conf = cell.config
    specs = cell.reference.param_shapes(conf)
    w = weights.draw_all(specs, seed, conf["initializer_range"], "cpu")
    b = SyntheticLM(conf["vocab_size"], seed=seed,
                    num_codebooks=conf.get("num_codebooks", 0)).batch(
        0, 4, 32)
    return cell, specs, w, b


def grads(cell, w, b, rows, prec="exact"):
    common.set_matmul()
    shapes = {n: t.shape for n, t in w.items()}
    pool = ref_gf.Pool(shapes)
    p = common.Precision(prec)
    loss, g = ref_gf.pool_grads(
        lambda lv, t, lab: cell.reference.loss(lv, t, lab, cell.config, p),
        w, pool, b["tokens"], b["labels"], rows)
    return float(loss), g


@pytest.mark.parametrize("name", CELLS)
def test_row_blocks_change_only_rounding(name):
    cell, _, w, b = setup(name)
    l1, g1 = grads(cell, w, b, 1)
    l4, g4 = grads(cell, w, b, 4)
    assert l1 == pytest.approx(l4, rel=1e-6)
    assert torch.allclose(g1, g4, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("name", CELLS)
def test_untrained_loss_is_near_log_vocab(name):
    cell, _, w, b = setup(name)
    loss, _ = grads(cell, w, b, 4)
    assert abs(loss - math.log(cell.config["vocab_size"])) < 0.5


@pytest.mark.parametrize("name", CELLS)
def test_the_controls_precision_moves_the_numbers(name):
    cell, _, w, b = setup(name)
    exact, ge = grads(cell, w, b, 4)
    low, gl = grads(cell, w, b, 4, "fp8")
    assert 0 < abs(exact - low) < 0.05
    assert 0 < float((ge - gl).norm() / ge.norm()) < 0.5


def test_seed_draws_the_same_weights():
    cell, specs, w, _ = setup("olmo-smoke-train")
    again = weights.draw_all(specs, 2 ** 31 + 3, 0.02, "cpu")
    other = weights.draw_all(specs, 2 ** 31 + 4, 0.02, "cpu")
    assert all(torch.equal(w[n], again[n]) for n in w)
    assert not torch.equal(w["embed/tokens"], other["embed/tokens"])


def test_lr_schedule_is_the_configurations():
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.optim import lr_at

    opt = dict(learning_rate=0.1, warmup_steps=200, total_steps=10000)
    for step in (0, 1, 2, 199, 200, 5000, 9999):
        assert float(ref_gf.lr_at(opt, step)) == float(lr_at(
            OptimizerConfig(**opt, schedule="warmup_cosine"), step))


def backend(mode, n=64, chunk=8):
    pool = ref_gf.Pool({"a": (n - 24,), "b": (24,)}, chunk)
    gf = {"mode": mode, "wire_dtype": "bfloat16", "chunk_elems": chunk,
          "sparsity": 0.75, "momentum": 0.9}
    opt = {"momentum": 0.9, "weight_decay": 1e-4}
    return pool, ref_gf.Backend(pool, gf, opt, 1, "cpu")


def test_lazy_rounds_to_the_wire_and_updates_everything():
    pool, be = backend("lazy")
    g = torch.randn(pool.size)
    red, mask = be.reduce(g)
    assert mask is None
    assert torch.equal(red, g.to(torch.bfloat16).float())
    w = torch.randn(pool.size)
    lr = torch.tensor(0.5)
    new = be.update(w, red, mask, lr)
    u = 0.5 * (red + 1e-4 * w)
    assert torch.allclose(be.momentum, u) and torch.allclose(new, w - u)


def test_csc_sends_the_top_chunks_and_keeps_the_rest():
    pool, be = backend("csc")
    assert (pool.size, be.k) == (64, 2)
    g = torch.randn(64)
    red, mask = be.reduce(g)
    # Before any step the norms descend with the chunk id: chunks 0, 1.
    assert mask.tolist() == [True] * 16 + [False] * 48
    assert torch.equal(red[:16], g[:16].to(torch.bfloat16).float())
    assert torch.equal(red[16:], torch.zeros(48))
    assert torch.allclose(be.hg, torch.where(mask, 0.0, 0.9 * g))
    # Each selection reads the previous step's per-chunk L1 norms.
    g2 = torch.zeros(64)
    g2[40:48] = 100.0
    be.reduce(g2)
    _, mask3 = be.reduce(torch.zeros(64))
    assert mask3[40:48].all() and int(mask3.sum()) == 16
    w = torch.ones(64)
    new = be.update(w, red, mask, torch.tensor(1.0))
    assert torch.equal(new[16:], w[16:])
