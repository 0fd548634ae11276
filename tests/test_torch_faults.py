"""The atomic skip of the port's numeric guard, on the CPU.

* Through the port's Trainer at smoke size (f32 wire, kernels on, so the
  plain versions run behind ``ops``): mode {dense, lazy, csc} x overlap
  {staged, monolithic} with momentum SGD, and LARS CSC staged and AdamW
  lazy staged. A NaN at step 0 (CSC: a warm-up step) and an overflow at
  step 2 (CSC: a sparse step) each leave every parameter, optimizer-state
  and GradientFlow tensor bit-identical, halve the scale and count one
  skip; the clean steps 1 and 3 move the parameters.
* ``GuardConfig(init_scale=1.0)`` with no fault gives the unguarded run
  bit for bit (lazy and CSC, staged and monolithic).
* The plain ``pool_unpack_update`` (and AdamW's segment update) with
  ``ok``: false leaves the outputs untouched, true equals the call
  without ``ok``; outputs that are not the live tensors are refused.
* Two gloo ranks, a NaN on rank 0 only, under ``flat`` and
  ``pallas_ring``: both ranks trip and keep the same parameters, and the
  guarded step issues exactly the unguarded step's collectives.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import optim
from repro_torch.configs import base, get_smoke
from repro_torch.core.pool import GradientPool
from repro_torch.kernels import ops
from repro_torch.kernels import pool_unpack
from repro_torch.launch.trainer import Trainer
from repro_torch.runtime.faults import FaultEvent, make_hook
from test_torch_ring import spawn_ranks

B, S, STEPS = 2, 32, 4
LR = {"momentum_sgd": 0.1, "lars": 0.1, "adamw": 1e-3}
GUARD = base.GuardConfig(init_scale=4.0, growth_interval=1000,
                         min_scale=1.0)
FAULTS = (FaultEvent(step=0, kind="nan", offset=8, width=4),
          FaultEvent(step=2, kind="overflow", offset=64, width=4))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small steps: one intra-op thread keeps them from oversubscribing
    the cores the suite's other workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(mode, overlap, optimizer="momentum_sgd", guard=GUARD,
         wire="float32"):
    """smollm-135m at smoke size, f32 compute. CSC: 1024-element chunks,
    two dense warm-up steps, then k = 156 of 313."""
    model = dataclasses.replace(get_smoke("smollm-135m")[0],
                                compute_dtype="float32")
    return base.TrainConfig(
        model=model,
        gradientflow=base.GradientFlowConfig(
            mode=mode, bucket_elems=8192, wire_dtype=wire, chunk_elems=1024,
            sparsity=0.5, warmup_steps=2, warmup_stages=1, overlap=overlap,
            use_kernels=True, guard=guard),
        optimizer=base.OptimizerConfig(
            name=optimizer, learning_rate=LR[optimizer], momentum=0.9,
            weight_decay=1e-4, warmup_steps=1, total_steps=20,
            schedule="constant"),
        seq_len=S, global_batch=B, attn_chunk=0)


def _batches(n=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, 256, (B, S + 1))
        out.append({"tokens": torch.from_numpy(toks[:, :-1]),
                    "labels": torch.from_numpy(toks[:, 1:])})
    return out


def _tensors(trainer, state):
    """Every parameter, optimizer-state and GradientFlow tensor, cloned."""
    return [x.clone() for x in (trainer.pool.flat_leaves(state.params)
                                + list(state.opt) + list(state.gf))]


def _bits(x):
    return x.reshape(-1).view(torch.uint8)


def _run(cfg, hook=None, init_seed=3):
    """The Trainer for STEPS steps, each under its CSC stage. Returns
    (trainer, [(tensors before, tensors after, metrics, scaler)])."""
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(seed=init_seed)
    fns, log = {}, []
    for i, b in enumerate(_batches()):
        stage = trainer.gf.stage_for_step(i)
        if stage.index not in fns:
            fns[stage.index] = trainer.build_train_step(stage,
                                                        fault_hook=hook)
        before = _tensors(trainer, state)
        state, metrics = fns[stage.index](state, b)
        log.append((before, _tensors(trainer, state), metrics, state.guard))
    return trainer, log


MATRIX = [(m, o, "momentum_sgd") for m in ("dense", "lazy", "csc")
          for o in ("staged", "monolithic")] + [
    ("csc", "staged", "lars"), ("lazy", "staged", "adamw")]


@pytest.mark.parametrize("mode,overlap,optimizer", MATRIX)
def test_tripped_step_is_bit_identical(mode, overlap, optimizer):
    trainer, log = _run(_cfg(mode, overlap, optimizer),
                        hook=make_hook(FAULTS))
    if mode == "csc":
        assert [trainer.gf.plan(trainer.gf.stage_for_step(s)).warmup
                for s in range(STEPS)] == [True, True, False, False]
    scale, skips = GUARD.init_scale, 0
    for step, (before, after, metrics, scaler) in enumerate(log):
        faulted = step in (0, 2)
        assert metrics["guard_tripped"].item() == float(faulted)
        assert np.isfinite(metrics["loss"].item())
        if faulted:
            scale, skips = scale / 2, skips + 1
            for a, b in zip(before, after):
                assert torch.equal(_bits(a), _bits(b)), step
        else:
            assert any(not torch.equal(a, b) for a, b in
                       zip(before[:trainer.pool.num_tensors],
                           after[:trainer.pool.num_tensors])), step
        assert scaler.scale.item() == scale
        assert scaler.skipped.item() == skips
    assert skips == 2


@pytest.mark.parametrize("mode,overlap", [("lazy", "staged"),
                                          ("lazy", "monolithic"),
                                          ("csc", "staged"),
                                          ("csc", "monolithic")])
def test_unit_scale_guard_is_neutral(mode, overlap):
    """init_scale 1.0 and no fault: the guarded run is the unguarded one,
    losses and every tensor bit for bit, after every step."""
    runs = [_run(_cfg(mode, overlap, guard=g))[1]
            for g in (None, base.GuardConfig(init_scale=1.0))]
    for (_, a, ma, _), (_, b, mb, sc) in zip(*runs):
        assert ma["loss"].item() == mb["loss"].item()
        assert all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))
        assert sc.scale.item() == 1.0 and sc.skipped.item() == 0


# -- the update's predicate ---------------------------------------------------

SIZES = (37, 128, 5, 300, 77)


def _update_case(seed=0):
    rng = np.random.default_rng(seed)
    offsets = tuple(int(x) for x in np.cumsum((0,) + SIZES[:-1]))
    n = sum(SIZES) + 11

    def f32(scale=1.0):
        return torch.from_numpy((rng.standard_normal(n) * scale)
                                .astype(np.float32))
    master, grads, mom = f32(), f32(1e-2), f32(1e-2)
    mask = torch.from_numpy(rng.random(n) < 0.7)
    ratios = torch.from_numpy(rng.random(len(SIZES) + 1).astype(np.float32))
    return master, grads, mom, mask, offsets, ratios


@pytest.mark.parametrize("with_ratios", [False, True])
def test_plain_update_ok_predicate(with_ratios):
    master, grads, mom, mask, offsets, ratios = _update_case()
    kw = dict(lr=torch.tensor(0.05), momentum=0.9, weight_decay=1e-4,
              ratios=ratios if with_ratios else None)
    want_l, want_m = pool_unpack.plain(master, grads, mom.clone(), mask,
                                       offsets, SIZES, **kw)
    for ok, expect in ((True, "new"), (False, "old")):
        leaves = [torch.randn(s) for s in SIZES]
        old_l = [x.clone() for x in leaves]
        m = mom.clone()
        ops.reset_counts()
        got_l, got_m = ops.pool_unpack_update(
            master, grads, m, mask, offsets, SIZES, out_leaves=leaves,
            out_momentum=m, ok=torch.tensor([ok]), **kw)
        assert ops.dispatch_counts == {"pool_unpack_update.plain": 1}
        assert got_m is m and all(a is b for a, b in zip(got_l, leaves))
        ref_l, ref_m = (want_l, want_m) if expect == "new" else (old_l, mom)
        assert torch.equal(_bits(got_m), _bits(ref_m))
        for a, b in zip(got_l, ref_l):
            assert torch.equal(_bits(a), _bits(b))
    # NaN gradients on a rejected step never reach the outputs.
    leaves = [x.clone() for x in want_l]
    m = want_m.clone()
    pool_unpack.plain(master, torch.full_like(grads, float("nan")), m, mask,
                      offsets, SIZES, out_leaves=leaves, out_momentum=m,
                      ok=torch.tensor(False), **kw)
    assert torch.equal(m, want_m)
    assert all(torch.equal(a, b) for a, b in zip(leaves, want_l))


def test_update_ok_refuses_outputs_that_are_not_live():
    master, grads, mom, mask, offsets, _ = _update_case(1)
    kw = dict(lr=0.05, momentum=0.9, weight_decay=1e-4)
    leaves = [torch.zeros(s) for s in SIZES]
    ok = torch.tensor([True])
    for out in (dict(out_leaves=None, out_momentum=mom),
                dict(out_leaves=leaves, out_momentum=None),
                dict(out_leaves=leaves, out_momentum=mom.clone())):
        for fn in (pool_unpack.plain, ops.pool_unpack_update):
            with pytest.raises(ValueError, match="live parameters"):
                fn(master, grads, mom, mask, offsets, SIZES, ok=ok, **kw,
                   **out)
    with pytest.raises(ValueError, match="one bool"):
        pool_unpack.plain(master, grads, mom, mask, offsets, SIZES,
                          out_leaves=leaves, out_momentum=mom,
                          ok=torch.tensor([1.0]), **kw)
    with pytest.raises(ValueError, match="live parameters"):
        optim.update_view("adamw", GradientPool(
            {f"t{i}": (s,) for i, s in enumerate(SIZES)}),
            master, grads, optim.init_state("adamw", master.shape[0]),
            mask, base.OptimizerConfig(name="adamw"), 1e-3, ok=ok)


def test_adamw_update_ok_predicate():
    """AdamW has no kernel: its write-back is ``commit_where``."""
    master, grads, _, mask, _, _ = _update_case(2)
    pool = GradientPool({f"t{i}": (s,) for i, s in enumerate(SIZES)},
                        pad_to=8)
    n = pool.size
    assert n < master.shape[0]
    master, grads, mask = master[:n], grads[:n], mask[:n]
    cfg = base.OptimizerConfig(name="adamw", learning_rate=1e-3)
    st0 = optim.init_state("adamw", n)
    for f in st0:
        f.copy_(torch.from_numpy(np.random.default_rng(3).random(n) * 2)
                .to(f.dtype))
    outs = {}
    for ok in (None, True, False):
        st = optim.AdamWState(*(x.clone() for x in st0))
        leaves = [torch.ones(s) for s in pool.sizes]
        optim.update_view("adamw", pool, master, grads, st, mask, cfg, 1e-3,
                          out_leaves=leaves,
                          ok=None if ok is None else torch.tensor(ok))
        outs[ok] = leaves + list(st)
    assert all(torch.equal(a, b) for a, b in zip(outs[None], outs[True]))
    old = [torch.ones(s) for s in pool.sizes] + list(st0)
    assert all(torch.equal(a, b) for a, b in zip(outs[False], old))


# -- two ranks ----------------------------------------------------------------

_BODY = """
    from test_torch_faults import rank_run
    saved = {}
    for algo in ("flat", "pallas_ring"):
        for mode in ("lazy", "csc"):
            for k, v in rank_run(rank, algo, mode).items():
                saved[f"{algo}|{mode}|{k}"] = v
    np.savez(out, **saved)
"""


def rank_run(rank, algo, mode, steps=3):
    """This rank's guarded run (a NaN at step 1 on rank 0 only) and its
    unguarded twin, bf16 wire, on its own batch shard: the guard_tripped
    metrics, the parameters after each step, and the collectives each
    step issued (``dist.all_reduce`` calls and ring sends, counted by
    wrapping ``torch.distributed``)."""
    import torch.distributed as dist

    counted = {"all_reduce": 0, "isend": 0}
    originals = {k: getattr(dist, k) for k in counted}

    def counter(name):
        def call(*a, **k):
            counted[name] += 1
            return originals[name](*a, **k)
        return call

    out = {}
    for guard in (GUARD, None):
        cfg = _cfg(mode, "staged", guard=guard, wire="bfloat16")
        cfg = cfg.replace(global_batch=2 * B, gradientflow=dataclasses.replace(
            cfg.gradientflow, collective_algo=algo, warmup_steps=1))
        trainer = Trainer(cfg, device="cpu")
        state = trainer.init_state(seed=1)
        hook = make_hook([FaultEvent(step=1, kind="nan", offset=8,
                                     width=4)]) if rank == 0 else None
        batches = _batches(2 * steps, seed=7)
        tripped, params, calls = [], [], []
        for s in range(steps):
            step = trainer.build_train_step(trainer.gf.stage_for_step(s),
                                            fault_hook=hook)
            b = batches[2 * s + rank]
            for k in counted:
                counted[k] = 0
                setattr(dist, k, counter(k))
            try:
                state, metrics = step(state, b)
            finally:
                for k, f in originals.items():
                    setattr(dist, k, f)
            calls.append([counted["all_reduce"], counted["isend"]])
            tripped.append(float(metrics.get("guard_tripped", -1.0)))
            params.append(torch.cat([p.reshape(-1) for p in
                                     trainer.pool.flat_leaves(state.params)])
                          .numpy().copy())
        tag = "guarded" if guard is not None else "plain"
        out[f"{tag}|tripped"] = np.asarray(tripped)
        out[f"{tag}|params"] = np.stack(params)
        out[f"{tag}|calls"] = np.asarray(calls)
    return out


def test_one_rank_poison_trips_both_ranks(tmp_path):
    r0, r1 = spawn_ranks(tmp_path, _BODY, 2, timeout=600)
    for algo in ("flat", "pallas_ring"):
        for mode in ("lazy", "csc"):
            def get(rank, k):
                return rank[f"{algo}|{mode}|{k}"]
            for rank in (r0, r1):
                # The poison crossed the wire in-band: both ranks trip.
                np.testing.assert_array_equal(get(rank, "guarded|tripped"),
                                              [0.0, 1.0, 0.0])
                p = get(rank, "guarded|params")
                np.testing.assert_array_equal(p[0], p[1])  # the skip
                assert not np.array_equal(p[1], p[2])
                # Exactly the unguarded step's collectives, every step.
                calls = get(rank, "guarded|calls")
                np.testing.assert_array_equal(calls, get(rank,
                                                         "plain|calls"))
                assert calls[:, 0].min() > 0
                assert (calls[:, 1].min() > 0) == (algo == "pallas_ring")
            np.testing.assert_array_equal(get(r0, "guarded|params"),
                                          get(r1, "guarded|params"))
