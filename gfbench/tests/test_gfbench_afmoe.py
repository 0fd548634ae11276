"""The Trinity (afmoe) cell's files, reference, yardsticks and readers on
the CPU: a smoke configuration of the cell (``tests/data``: 6 layers at
width 64, 64 positions against a window of 16, 4 of 8 experts held)
through the harness, the reference's row blocks and the control's
precision, the attention and expert FLOP counts by hand, the two
roofline readers on a made-up trace."""
import json
import math

import pytest
import torch

from gfbench.harness import check, profile, spec, training, weights
from gfbench.harness.training import Run
from gfbench.reference import afmoe, common
from gfbench.reference import gradientflow as ref_gf
from gfbench.tests.conftest import DATA, ROOT
from gfbench.yardstick import attention as yattn
from gfbench.yardstick import flops as yflops
from gfbench.yardstick import moe as ymoe
from gfbench.yardstick import peaks
from gfbench.yardstick.tokens import SyntheticLM

SMOKE = "trinity-smoke-train"


def bench() -> dict:
    """BENCHMARK.json with its metrics over the smoke cell."""
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    b["configs"] = [{"name": "trinity-smoke",
                     "file": "gfbench/tests/data/configs/trinity-smoke.json"}]
    b["workloads"] = [{"name": SMOKE, "config": "trinity-smoke",
                       "traffic": "tokens-2x64", "chips": 1}]
    return b


@pytest.fixture(scope="module")
def cell():
    return spec.load(SMOKE, bench(), DATA)


def test_cell_files_hold_the_published_widths():
    conf = spec.load("trinity-mini-train").config
    assert (conf["hidden_size"], conf["intermediate_size"],
            conf["moe_intermediate_size"], conf["num_attention_heads"],
            conf["num_key_value_heads"], conf["head_dim"],
            conf["sliding_window"], conf["num_experts"],
            conf["num_experts_per_tok"], conf["num_shared_experts"]) == \
        (2048, 6144, 1024, 32, 4, 128, 2048, 128, 8, 1)
    assert (conf["num_hidden_layers"], conf["vocab_size"],
            conf["num_experts_held"]) == (6, 50048, 32)
    assert conf["published"] == {"num_hidden_layers": 32,
                                 "vocab_size": 200192,
                                 "num_experts_held": 128}
    assert len(conf["layer_types"]) == 32
    shapes = afmoe.param_shapes(conf)
    assert sum(math.prod(s) for s, _ in shapes.values()) == \
        conf["parameters"] == 1_275_645_440


def test_sound_smoke_run_is_correct(cell):
    result, prog, ref = training.run(cell, 2 ** 31 + 17, 0.2, False, "cpu",
                                     0.0)
    assert result["correct"], result["check"]
    assert len(prog.losses) == 2 and all(math.isfinite(x)
                                         for x in prog.losses)


def test_half_the_rows_is_not_correct(cell):
    """The fault of a gradient over half the rows reads far above the
    smoke cell's limits."""
    seed = 2 ** 31 + 19
    conf, wl = cell.config, cell.workload
    specs = afmoe.param_shapes(conf)
    std = conf["initializer_range"]
    batches = training.batches(cell, seed, 0, 0, 2)

    def side(**kw):
        return check.reference_readings(
            afmoe, conf, wl["gradientflow"], wl["optimizer"], specs,
            lambda n: weights.draw(specs, n, seed, std, "cpu"), batches, 1,
            "cpu", 1, 2, **kw)
    gaps = check.gaps(side(rows=slice(0, 1)), side(), check.numbers(2))
    assert not check.verdict(gaps, wl["limits"])
    assert max(gaps[k] / wl["limits"][k] for k in gaps) > 10


def _grads(conf, w, tok, lab, rows, prec="exact"):
    common.set_matmul()
    pool = ref_gf.Pool({n: t.shape for n, t in w.items()})
    p = common.Precision(prec)
    loss, g = ref_gf.pool_grads(
        lambda lv, t, la: afmoe.loss(lv, t, la, conf, p), w, pool, tok, lab,
        rows)
    return float(loss), g


def test_row_blocks_and_query_blocks_change_only_rounding(cell,
                                                          monkeypatch):
    conf = cell.config
    specs = afmoe.param_shapes(conf)
    w = weights.draw_all(specs, 5, 0.1, "cpu")
    b = SyntheticLM(conf["vocab_size"], seed=5).batch(0, 2, 64)
    l1, g1 = _grads(conf, w, b["tokens"], b["labels"], 1)
    l2, g2 = _grads(conf, w, b["tokens"], b["labels"], 2)
    monkeypatch.setattr(afmoe, "QUERY_BLOCK", 16)
    l3, g3 = _grads(conf, w, b["tokens"], b["labels"], 2)
    assert l1 == pytest.approx(l2, rel=1e-6) and \
        l2 == pytest.approx(l3, rel=1e-6)
    assert torch.allclose(g1, g2, rtol=1e-4, atol=1e-7)
    assert torch.allclose(g2, g3, rtol=1e-4, atol=1e-7)
    # The control's precision moves the numbers.
    l8, g8 = _grads(conf, w, b["tokens"], b["labels"], 2, "fp8")
    assert abs(l8 - l2) > 1e-4
    assert (g8 - g2).abs().max() > 1e-3 * g2.abs().max()


def test_kept_pairs_by_hand():
    # s = 8, window 3: rows 0-2 keep 1, 2, 3 keys, rows 3-7 keep 3.
    assert yattn.kept_pairs(8, 3) == 1 + 2 + 3 + 5 * 3
    assert yattn.kept_pairs(8) == yattn.kept_pairs(8, 8) == 36
    for s, w in ((37, 5), (64, 16), (100, 99)):
        assert yattn.kept_pairs(s, w) == sum(
            1 for i in range(s) for j in range(i + 1) if i - j < w)
    # The cell: the window keeps 43.75 % of the causal pairs.
    assert yattn.kept_pairs(8192, 2048) == 14_681_088
    assert yattn.kept_pairs(8192) == 33_558_528


def test_attention_and_expert_flops_by_hand():
    conf = spec.load("trinity-mini-train").config
    assert yattn.layer_windows(conf) == [2048, 2048, 2048, 0, 2048, 2048]
    per_pair = 2 * (2 * 2 + 5) * 128 * 32   # remat: the forward twice
    want = per_pair * 4 * (5 * 14_681_088 + 33_558_528)
    assert yattn.step_flops(conf, 4, 8192, True) == want
    assert yattn.step_flops(conf, 4, 8192, False) == \
        2 * (2 + 5) * 128 * 32 * 4 * (5 * 14_681_088 + 33_558_528)
    # Three products of 2 R d f a forward, twice under remat; six back.
    assert ymoe.step_flops(1000, 64, 32, True) == \
        (2 * 6 + 12) * 1000 * 64 * 32
    assert ymoe.step_flops(1000, 64, 32, False) == 18 * 1000 * 64 * 32
    # The frozen MFU count: 2 of 32 held experts' weights a token.
    shapes = {n: s for n, (s, _) in afmoe.param_shapes(conf).items()}
    per_tok = yflops.step_flops(conf, shapes, 1, 8192) / 8192
    assert per_tok == 6 * (265_340_416 + 805_306_368 * 8 // 128
                           + 50048 * 2048 + 8192 * 32 * 128 * 6)


def ev(name, start, end, kind="kernel"):
    return {"ph": "X", "cat": kind, "name": name, "ts": start * 1e6,
            "dur": (end - start) * 1e6}


def test_roofline_readers_on_a_made_up_trace(cell, monkeypatch):
    from gfbench.harness import program
    from gfbench.harness.spec import reader

    run = Run(cell, 1)
    run.trace = profile.reduce([
        ev(profile.SPAN, 0.0, 10.0, "user_annotation"),
        ev("moe_gmm_fwd", 1.0, 3.0), ev("moe_gmm_dw", 3.0, 4.0),
        ev("flash_attn_fwd", 4.0, 4.5), ev("flash_attn_bwd_dkdv", 4.5, 5.5),
        ev("sm90_gemm", 6.0, 7.0)], steps=2)
    monkeypatch.setattr(program, "per_step",
                        lambda g, n: 1000.0 if (g, n) == ("moe", "rows")
                        else None)
    conf = cell.config
    want = ymoe.step_flops(1000.0, conf["hidden_size"],
                           conf["moe_intermediate_size"], True) * 2 \
        / peaks.BF16_FLOPS / 3.0 * 100
    assert reader("moe_gmm_roofline_pct").read(run) == pytest.approx(want)
    want = yattn.step_flops(conf, cell.rows, cell.seq_len, True) * 2 \
        / peaks.BF16_FLOPS / 1.5 * 100
    assert reader("attn_roofline_pct").read(run) == pytest.approx(want)
    # A program without the tally, or a trace without the kernels.
    monkeypatch.setattr(program, "per_step", lambda g, n: None)
    assert reader("moe_gmm_roofline_pct").read(run) is None
    run.trace = profile.reduce([ev(profile.SPAN, 0.0, 1.0,
                                   "user_annotation"),
                                ev("sm90_gemm", 0.1, 0.2)], steps=2)
    assert reader("attn_roofline_pct").read(run) is None
