"""The port's afmoe (Trinity) against the benchmark's plain reference
(``gfbench/reference/afmoe.py``) on the CPU at smoke size: 6 layers (2
dense, then sliding, full, sliding, sliding), 64 positions against a
window of 16, 8 experts of which the chip holds 4.

Tolerances: the port runs here in float32 (``compute_dtype`` f32), the
reference in float32 with its router in float64, so the two differ only
by the order of f32 sums: the loss within 1e-5 relative, every gradient
within 2e-4 of its largest |value| (f32 sums over a few hundred terms,
through six layers' backward). Each mechanism taken out of the port
(the window, the shared expert, the output gate, the route scale) moves
the loss or a gradient by more than 10 x its tolerance.
"""
import dataclasses
import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from gfbench.reference import afmoe as ref  # noqa: E402
from gfbench.reference import common  # noqa: E402
from repro_torch.configs import PORT_ARCH_IDS, get_arch, get_smoke  # noqa: E402
from repro_torch.configs.base import (GradientFlowConfig,  # noqa: E402
                                      OptimizerConfig, TrainConfig)
from repro_torch.core.pool import flatten_tree  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import grouped_mm as gm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.layers import attention, moe  # noqa: E402
from repro_torch.runtime import trace  # noqa: E402

B, S = 2, 64
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-4


def ref_config(cfg):
    """The reference's config dict of a port config (the benchmark's
    keys)."""
    m = cfg.moe
    kinds = {"sliding": "sliding_attention", "full": "full_attention"}
    return {"hidden_size": cfg.d_model, "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "head_dim": cfg.head_dim, "intermediate_size": cfg.d_ff,
            "moe_intermediate_size": m.expert_d_ff,
            "num_shared_experts": 1 if m.shared_d_ff else 0,
            "num_experts": m.num_experts, "num_experts_held": m.held,
            "num_experts_per_tok": m.top_k,
            "num_hidden_layers": cfg.num_layers,
            "num_dense_layers": cfg.num_dense_layers,
            "vocab_size": cfg.vocab_size,
            "layer_types": [kinds[k] for k in cfg.layer_types],
            "sliding_window": cfg.sliding_window,
            "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.norm_eps,
            "route_scale": m.route_scale, "mup_enabled": True}


def smoke(**moe_kw):
    cfg, _ = get_smoke("trinity-mini-ep4")
    if moe_kw:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe_kw))
    return cfg


def weights(cfg, seed=3):
    """Seeded weights by the reference's names: N(0, 0.1) matrices (a
    larger spread than the cell's 0.02, so every path moves the loss),
    norm gains around 1."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, (shape, init) in sorted(ref.param_shapes(
            ref_config(cfg)).items()):
        x = torch.randn(shape, generator=gen)
        out[name] = 1.0 + 0.1 * x if init == "ones" else 0.1 * x
    return out


def port_tree(cfg, w):
    """The port's parameter tree holding the reference's weights."""
    model = build_model(cfg)

    def fill(specs, prefix):
        return {k: fill(v, f"{prefix}{k}/") if isinstance(v, dict)
                else w[f"{prefix}{k}"].clone().requires_grad_(True)
                for k, v in specs.items()}
    return model, fill(model.param_specs(), "")


def batch(cfg, seed=4):
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def port_loss(cfg, w, remat="layer", attn_chunk=0):
    model, params = port_tree(cfg, w)
    loss, _ = model.loss_fn(params, batch(cfg), remat=remat,
                            attn_chunk=attn_chunk,
                            compute_dtype=torch.float32)
    loss.backward()
    return float(loss.detach()), {"/".join(p): t.grad for p, t in
                         flatten_tree(params)}


def ref_loss(cfg, w, rows=B):
    common.set_matmul("exact")
    leaves = {n: t.clone().requires_grad_(True) for n, t in w.items()}
    b = batch(cfg)
    total = 0.0
    for s in range(0, B, rows):
        part = ref.loss(leaves, b["tokens"][s:s + rows],
                        b["labels"][s:s + rows], ref_config(cfg),
                        common.Precision("exact")) * (rows / B)
        part.backward()
        total += float(part.detach())
    return total, {n: t.grad for n, t in leaves.items()}


@pytest.fixture(scope="module")
def reference():
    cfg = smoke()
    w = weights(cfg)
    return cfg, w, ref_loss(cfg, w)


def test_full_parameter_count():
    """trinity-mini is the catalog's 26B-A3B (26.1 B within 1 %); the
    one-chip share holds 1,275,645,440, as its benchmark file says."""
    def count(cfg):
        return sum(math.prod(t) for _, t in flatten_tree(
            build_model(cfg).param_shapes()))
    full, share = get_arch("trinity-mini")[0], get_arch("trinity-mini-ep4")[0]
    assert abs(count(full) - 26.1e9) <= 0.01 * 26.1e9
    assert count(full) == 26_123_970_560
    assert count(share) == 1_275_645_440
    assert PORT_ARCH_IDS == ("trinity-mini", "trinity-mini-ep4")
    assert share.moe.held == 32 and share.moe.num_experts == 128
    assert share.layer_types == ("sliding",) * 3 + ("full", "sliding",
                                                    "sliding")


@pytest.mark.parametrize("remat,attn_chunk", [("layer", 0), ("none", 0),
                                              ("layer", 32)])
def test_loss_and_every_gradient_match_the_reference(reference, remat,
                                                     attn_chunk):
    """Full and blockwise (chunks of 32, the window masked in each block)
    attention, with and without remat."""
    cfg, w, (want, want_g) = reference
    got, got_g = port_loss(cfg, w, remat, attn_chunk)
    assert got == pytest.approx(want, rel=LOSS_RTOL)
    assert set(got_g) == set(want_g)
    for name, g in got_g.items():
        scale = want_g[name].abs().max().item()
        assert scale > 0, name
        assert (g - want_g[name]).abs().max().item() <= GRAD_TOL * scale, \
            name


def _without(cfg, w, what):
    if what == "window":
        return dataclasses.replace(cfg, sliding_window=10 ** 6), w
    if what == "gate":
        return dataclasses.replace(cfg, attn_gate=False), \
            {n: t for n, t in w.items() if n != "layers/attn/wg"}
    if what == "shared":
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, shared_d_ff=0)), \
            {n: t for n, t in w.items() if "/shared/" not in n}
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, route_scale=1.0)), w


def mismatch(got, got_g, want, want_g):
    """The comparison's reading in units of its tolerances: the loss's
    relative gap over LOSS_RTOL or the largest gradient gap over
    GRAD_TOL of its weight's largest |value|, whichever is larger (the
    comparison passes at 1 or below)."""
    return max([abs(got - want) / abs(want) / LOSS_RTOL]
               + [(got_g[n] - want_g[n]).abs().max().item()
                  / want_g[n].abs().max().item() / GRAD_TOL
                  for n in got_g if n in want_g])


@pytest.mark.parametrize("what", ["window", "shared", "gate",
                                  "route_scale"])
def test_each_mechanism_taken_out_fails_the_comparison(reference, what):
    cfg, w, (want, want_g) = reference
    got, got_g = port_loss(*_without(cfg, w, what))
    assert mismatch(got, got_g, want, want_g) > 10, what


def test_expert_shares_add_up_to_the_uncut_layer():
    """Two chips' shares of one MoE layer (experts 0-3 and 4-7), each
    with the shared expert, summed with the shared expert counted once,
    give the uncut layer (all 8 experts held): the port's layer and the
    reference's."""
    cfg = smoke(experts_held=8)
    gen = torch.Generator().manual_seed(7)
    d, f, e = cfg.d_model, cfg.moe.expert_d_ff, cfg.moe.num_experts
    p = {"router": torch.randn(d, e, generator=gen) * 0.3,
         "wi_gate": torch.randn(e, d, f, generator=gen) * 0.1,
         "wi_up": torch.randn(e, d, f, generator=gen) * 0.1,
         "wo": torch.randn(e, f, d, generator=gen) * 0.1,
         "shared": {k: torch.randn(s, generator=gen) * 0.1 for k, s in (
             ("wi_gate", (d, f)), ("wi_up", (d, f)), ("wo", (f, d)))}}
    x = torch.randn(2, 16, d, generator=gen)
    whole, _ = moe.apply_sigmoid(p, x, cfg)
    shared, _ = moe.apply_sigmoid(
        {**p, **{k: p[k][:0] for k in ("wi_gate", "wi_up", "wo")}}, x, cfg)
    parts = []
    for first in (0, 4):
        part = {**p, **{k: p[k][first:first + 4]
                        for k in ("wi_gate", "wi_up", "wo")}}
        parts.append(moe.apply_sigmoid(part, x, cfg, first=first)[0])
    torch.testing.assert_close(parts[0] + parts[1] - shared, whole,
                               rtol=1e-5, atol=1e-6)
    lw = {"ffn/router": p["router"], "ffn/wi_gate": p["wi_gate"],
          "ffn/wi_up": p["wi_up"], "ffn/wo": p["wo"],
          **{f"ffn/shared/{k}": v for k, v in p["shared"].items()}}
    common.set_matmul("exact")
    want = ref.moe(x.reshape(-1, d), lw, ref_config(cfg),
                   common.Precision("exact"))
    torch.testing.assert_close(whole.reshape(-1, d), want, rtol=1e-5,
                               atol=1e-6)


def test_dropless_with_every_slot_on_one_expert():
    """top-1 with the router pushed to expert 2: all T slots on one held
    expert, none dropped; each token's output is that expert's times the
    route scale (its gate renormed to 1), plus the shared expert."""
    cfg = smoke(top_k=1)
    gen = torch.Generator().manual_seed(8)
    d, f, held = cfg.d_model, cfg.moe.expert_d_ff, cfg.moe.held
    router = torch.randn(d, cfg.moe.num_experts, generator=gen) * 0.01
    x = torch.randn(1, 48, d, generator=gen).abs()
    router[:, 2] = 1.0
    p = {"router": router,
         "wi_gate": torch.randn(held, d, f, generator=gen) * 0.1,
         "wi_up": torch.randn(held, d, f, generator=gen) * 0.1,
         "wo": torch.randn(held, f, d, generator=gen) * 0.1,
         "shared": {k: torch.randn(s, generator=gen) * 0.1 for k, s in (
             ("wi_gate", (d, f)), ("wi_up", (d, f)), ("wo", (f, d)))}}
    gates, idx = moe.route_sigmoid(x.reshape(-1, d) @ router, 1, 2.826)
    assert (idx == 2).all()
    _, counts = moe.sort_slots(idx, held)
    assert counts.tolist() == [0, 0, 48, 0]
    y, _ = moe.apply_sigmoid(p, x, cfg)
    xt = x.reshape(-1, d)
    expert = (torch.nn.functional.silu(xt @ p["wi_gate"][2])
              * (xt @ p["wi_up"][2])) @ p["wo"][2]
    shared = (torch.nn.functional.silu(xt @ p["shared"]["wi_gate"])
              * (xt @ p["shared"]["wi_up"])) @ p["shared"]["wo"]
    torch.testing.assert_close(y.reshape(-1, d), 2.826 * expert + shared,
                               rtol=1e-5, atol=1e-6)


def test_slots_sorted_by_expert_in_token_order():
    idx = torch.tensor([[3, 1], [0, 3], [1, 5], [6, 3]])
    order, counts = moe.sort_slots(idx, held=4)
    assert counts.tolist() == [1, 2, 0, 3]
    # expert 0: slot 2; 1: slots 1, 4; 3: slots 0, 3, 7; then 5 and 6's.
    assert order.tolist() == [2, 1, 4, 0, 3, 7, 5, 6]
    order, counts = moe.sort_slots(idx, held=4, first=3)
    assert counts.tolist() == [3, 0, 1, 1]


def test_grouped_mm_plain_matches_a_loop_and_its_gradients():
    """The plain version against a per-expert loop of products, experts
    with 0 rows among them, the rows past the experts' 0; its backward
    against autograd of that loop."""
    gen = torch.Generator().manual_seed(9)
    counts = torch.tensor([3, 0, 5, 0, 1])
    x = torch.randn(12, 6, generator=gen, requires_grad=True)
    w = torch.randn(5, 6, 4, generator=gen, requires_grad=True)
    y = gm.plain_grouped_mm(x, w, counts)
    parts, o = [], 0
    for e, n in enumerate(counts.tolist()):
        parts.append(x[o:o + n] @ w[e])
        o += n
    want = torch.cat(parts + [torch.zeros(12 - o, 4)])
    torch.testing.assert_close(y, want)
    dy = torch.randn(12, 4, generator=gen)
    got = torch.autograd.grad(y, (x, w), dy)
    wanted = torch.autograd.grad(want, (x, w), dy)
    for g, h in zip(got, wanted):
        torch.testing.assert_close(g, h)
    assert gm.grid_rows(12, 5, 4) == 3 + 5 + 1
    offs, tiles = gm.layout(counts, 4)
    assert offs.tolist() == [0, 3, 3, 8, 8]
    assert tiles.tolist() == [1, 1, 3, 3, 4]


def test_windowed_plain_attention_matches_full_attention():
    """``flash_attention.plain`` with a window (not a multiple of its
    block, a sequence not a multiple either) against the masked full
    attention, forward and backward; a window at least the sequence is
    causal attention."""
    gen = torch.Generator().manual_seed(10)
    q, k, v, do = (torch.randn(2, 100, 3, 16, generator=gen)
                   for _ in range(4))
    for window in (33, 5, 100):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        got = fa.plain_attention(*leaves, window)
        gg = torch.autograd.grad(got, leaves, do)
        leaves2 = [t.clone().requires_grad_(True) for t in (q, k, v)]
        want = attention.full_attention(
            *leaves2, causal=True, window=window if window < 100 else 0)
        wg = torch.autograd.grad(want, leaves2, do)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        for a, b in zip(gg, wg):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s", [64, 100, 257, 1000])
def test_window_tile_plans_cover_the_kept_pairs(s):
    """``window_ranges`` (the kernels' loops): every tile holding a kept
    pair is visited once, the unmasked tiles hold kept pairs alone, the
    edge tiles none above the diagonal; for the forward's and dQ's tiles
    (block_m a multiple of block_n) and dK/dV's (the other way round)."""
    for window in (1, 5, 16, 33, 64, 129, 2000):
        w = window if window < s else 0
        for key, pairs in ((False, ((64, 64), (128, 64), (64, 32))),
                           (True, ((64, 64), (32, 64), (16, 64)))):
            for bm, bn in pairs:
                own, other = (bn, bm) if key else (bm, bn)
                for start in range(0, s, own):
                    mine = range(start, min(start + own, s))
                    if key:
                        need = {i // bm for j in mine
                                for i in range(j, min(s, j + window))}
                    else:
                        need = {j // bn for i in mine
                                for j in range(max(0, i - window + 1), i + 1)}
                    seen = {}
                    for lo, hi, mask in fa.window_ranges(start, s, w, bm, bn,
                                                         key_tile=key):
                        for t in range(lo, hi, other):
                            assert t % other == 0 and t // other not in seen
                            seen[t // other] = mask
                    assert need <= set(seen), (s, window, bm, bn, start)
                    for t, mask in seen.items():
                        them = range(t * other, t * other + other)
                        qk = [(i, j) for i in them for j in mine] if key \
                            else [(i, j) for i in mine for j in them]
                        if mask == "none":
                            assert all(i >= j and (not w or i - j < w)
                                       for i, j in qk)
                        if mask == "edge":
                            assert all(i >= j for i, j in qk)


def test_trainer_window_and_counters():
    """trinity-mini-ep4's smoke config through the Trainer: a window of 2
    steps gives the eager steps' bits; the moe tally counts the rows each
    MoE layer's held experts took, once a step (remat or not); each
    forward's grouped products go through ``ops.grouped_mm``."""
    from repro_torch.launch.trainer import Trainer

    cfg = TrainConfig(model=smoke(), seq_len=32, global_batch=2,
                      gradientflow=GradientFlowConfig(mode="lazy"),
                      optimizer=OptimizerConfig(), window_steps=2)
    gen = torch.Generator().manual_seed(11)
    toks = torch.randint(0, 256, (2, 2, 33), generator=gen)
    steps = [{"tokens": toks[i, :, :-1], "labels": toks[i, :, 1:]}
             for i in range(2)]

    def run(window):
        trainer = Trainer(cfg, device="cpu")
        state = trainer.init_state(seed=5)
        stage = trainer.gf.stages[-1]
        if window:
            call = trainer.build_train_window(2, stage)
            state, m = call(state, {k: torch.stack([s[k] for s in steps])
                                    for k in steps[0]})
            return m["loss"].reshape(-1).tolist(), state
        step = trainer.build_train_step(stage)
        losses = []
        for s in steps:
            state, m = step(state, s)
            losses.append(float(m["loss"]))
        return losses, state

    ops.reset_counts()
    rows0 = trace.tallies().get("moe", {}).get("rows", 0)
    eager, s1 = run(False)
    rows = trace.tallies()["moe"]["rows"] - rows0
    assert 0 < rows <= 2 * 4 * 2 * 32 * cfg.model.moe.top_k
    assert ops.dispatch_counts["grouped_mm.plain"] == 2 * 4 * 3 * 2
    windowed, s2 = run(True)
    assert eager == windowed
    assert torch.equal(s1.opt.momentum, s2.opt.momentum)
