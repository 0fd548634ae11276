"""The port's cross-step pipeline (``repro_torch.core.engine``: the tail
plans, ``InflightLane``, ``run_pipelined``, ``run_pipelined_guarded``,
``apply_inflight``) against the JAX package's, on the CPU.

* Tail plans: ``compile_step_plan`` with ``pipeline_tail_buckets`` 1, 2
  and -1 (auto, through the cost model) on the cluster_v and host_2x4
  topologies, dense and lazy, the full smollm-135m pool: the same
  ``pipeline_tail``, commit epochs and update spans, and both plans pass
  ``validate``. CSC and the low-bit wires never pipeline.
* The engine chain: K steps of ``apply_inflight`` + ``run_pipelined``
  and the flush, on an f32 wire, against JAX's chain step by step (to
  rtol 1e-6, atol 1e-6: XLA contracts the update's multiply-adds into
  FMAs under ``jit``, a rounding of the O(1) operands, which a
  cancellation leaves in a small result) and against the port's own
  unpipelined chain bit for bit; guarded, with a NaN at step 2 while
  the tail of step 1 is in the lane, the rejected lane writes nothing.
* ``assert_flushed`` rejects a state with a live lane.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import base as j_base
from repro.configs import get_arch as j_get_arch
from repro.core.engine import OverlapEngine as JEngine
from repro.core.gradientflow import GradientFlow as JGradientFlow
from repro.core.pool import GradientPool as JPool
from repro.models import build_model as j_build_model
from repro.optim import scaler as j_scaler
from repro.optim import sgd as j_sgd
from repro.parallel import topology as j_topo
from repro.parallel.collectives import (compat_make_mesh, compat_set_mesh,
                                        compat_shard_map)
from repro.parallel.sharding import abstract_params
from repro_torch.configs import base as t_base
from repro_torch.configs import get_arch
from repro_torch.core.engine import InflightLane
from repro_torch.core.engine import OverlapEngine as TEngine
from repro_torch.core.gradientflow import GradientFlow
from repro_torch.core.pool import GradientPool
from repro_torch.kernels import ops
from repro_torch.launch.trainer import TrainState, assert_flushed, is_flushed
from repro_torch.models import build_model
from repro_torch.optim import scaler as t_scaler
from repro_torch.optim import sgd as t_sgd
from repro_torch.parallel import topology as t_topo

TOPOLOGIES = {
    "cluster_v": (j_topo.Topology.cluster_v(), t_topo.Topology.cluster_v()),
    "host_2x4": (j_topo.Topology.host_mesh(("pod", "data"), (2, 4)),
                 t_topo.Topology.host_mesh(("pod", "data"), (2, 4))),
}


def _full_pools(pad=1):
    return (JPool(abstract_params(j_build_model(
                j_get_arch("smollm-135m")[0]).param_specs()), pad_to=pad),
            GradientPool(build_model(get_arch("smollm-135m")[0])
                         .param_shapes(), pad_to=pad))


@pytest.mark.parametrize("mode", ["dense", "lazy"])
@pytest.mark.parametrize("tail", [1, 2, -1])
@pytest.mark.parametrize("topo", ["cluster_v", "host_2x4"])
def test_tail_plans_match_jax(topo, tail, mode):
    jpool, tpool = _full_pools()
    jt, tt = TOPOLOGIES[topo]
    kw = dict(mode=mode, bucket_elems=4_194_304, pipeline_tail_buckets=tail)
    n = tt.num_devices
    jp = JGradientFlow(j_base.GradientFlowConfig(topology=jt, **kw), jpool,
                       n).plan()
    tp = GradientFlow(t_base.GradientFlowConfig(topology=tt, **kw), tpool,
                      n).plan()
    jp.validate()
    tp.validate()
    assert tp.pipeline_tail == jp.pipeline_tail
    assert 1 <= tp.pipeline_tail < len(tp.tasks) or tail == -1
    if tail > 0:
        assert tp.pipeline_tail == tail
    assert [(t.start, t.end, t.update_span, t.commit_epoch)
            for t in tp.tasks] == \
        [(t.start, t.end, t.update_span, t.commit_epoch) for t in jp.tasks]
    assert tp.head_tasks + tp.tail_tasks == tp.tasks
    assert [t.index for t in tp.tail_tasks] == \
        [t.index for t in jp.tail_tasks]


def test_csc_and_low_bit_wires_never_pipeline():
    """CSC's stages (the dense warm-up too) and the low-bit lazy wire
    resolve no tail, as in the JAX package; a tail larger than the plan
    keeps the first bucket in the step."""
    jpool, tpool = _full_pools(pad=32768)
    for kw in (dict(mode="csc", warmup_steps=4, warmup_stages=4),
               dict(mode="lazy", wire_format="int8")):
        kw = dict(kw, bucket_elems=4_194_304, pipeline_tail_buckets=2)
        jgf = JGradientFlow(j_base.GradientFlowConfig(**kw), jpool, 1)
        tgf = GradientFlow(t_base.GradientFlowConfig(**kw), tpool, 1)
        for ts, js in zip(tgf.stages, jgf.stages):
            tp, jp = tgf.plan(ts), jgf.plan(js)
            tp.validate()
            assert tp.pipeline_tail == jp.pipeline_tail == 0
            assert all(t.commit_epoch == 0 for t in tp.tasks)
    _, tpool = _full_pools()
    tgf = GradientFlow(t_base.GradientFlowConfig(
        mode="lazy", bucket_elems=4_194_304, pipeline_tail_buckets=100),
        tpool, 1)
    assert tgf.plan().pipeline_tail == len(tgf.plan().tasks) - 1
    with pytest.raises(ValueError, match="pipeline_tail_buckets"):
        GradientFlow(t_base.GradientFlowConfig(
            mode="lazy", bucket_elems=4_194_304, pipeline_tail_buckets=-2),
            tpool, 1).plan()


# -- the engine chain ---------------------------------------------------------

SIZES = [(7,), (33, 5), (2, 3, 4), (129,), (64, 2), (300,)]
K = 4
LRS = [0.1, 0.05, 0.2, 0.1]
# Engine-level comparisons with JAX: XLA's jit may contract the update's
# multiply-adds into FMAs, the port rounds each product: one or two ulp
# of the O(1) parameters and momenta here (2^-23 x 4 = 4.8e-7).
TOL = dict(rtol=1e-6, atol=1e-6)


def _setup(guard=False):
    rng = np.random.default_rng(0)
    params = {f"t{i}": rng.normal(size=s).astype(np.float32)
              for i, s in enumerate(SIZES)}
    pool_size = sum(int(np.prod(s)) for s in SIZES)
    mom = rng.normal(size=pool_size).astype(np.float32)
    gpools = rng.normal(size=(K, pool_size)).astype(np.float32)
    if guard:
        gpools[2, 5] = np.nan
    return params, mom, gpools


def _cfg(base, tail, guard):
    return base.GradientFlowConfig(
        mode="lazy", bucket_elems=150, chunk_elems=64, sparsity=0.5,
        warmup_steps=0, wire_dtype="float32", reduce_axes=("data",),
        collective_algo="flat", pipeline_tail_buckets=tail,
        guard=base.GuardConfig() if guard else None)


def _opt(base):
    return base.OptimizerConfig(name="momentum_sgd", momentum=0.9,
                                weight_decay=1e-4)


def _jax_chain(guard):
    """JAX's pipelined chain on one data device: per step, the lane
    apply then ``run_pipelined(_guarded)``, then the flush. Returns the
    flat params and momentum after each step (before the flush) and after
    the flush."""
    params, mom, gpools = _setup(guard)
    tree = {k: jnp.asarray(v) for k, v in params.items()}
    pool = JPool(tree, pad_to=1)
    gf = JGradientFlow(_cfg(j_base, 2, guard), pool, num_data_shards=1)
    eng = JEngine(gf, "momentum_sgd", _opt(j_base))
    plan = eng.plan_for()
    assert plan.pipeline_tail == 2
    st0 = gf.init_state()
    mesh = compat_make_mesh((1,), ("data",))

    def smap(f, ins, outs):
        return jax.jit(compat_shard_map(f, mesh=mesh, in_specs=ins,
                                        out_specs=outs, axis_names={"data"},
                                        check_vma=False))

    def flat(p, m):
        return np.concatenate([np.asarray(pool.pack(p)[0]), np.asarray(m)])

    def step(gpool, p, m, sc, lr, lane):
        p1, o1 = eng.apply_inflight(plan, p, j_sgd.SGDState(momentum=m),
                                    lane)
        if guard:
            p2, o2, _, sc2, lane2, _ = eng.run_pipelined_guarded(
                plan, gpool, p1, o1, st0, sc, lr)
        else:
            (p2, o2, _, lane2), sc2 = eng.run_pipelined(
                plan, gpool, p1, o1, st0, lr), sc
        return p2, o2.momentum, sc2, lane2

    def flush(p, m, lane):
        p1, o1 = eng.apply_inflight(plan, p, j_sgd.SGDState(momentum=m),
                                    lane)
        return p1, o1.momentum

    sc = j_scaler.init(j_base.GuardConfig()) if guard else ()
    stepped = smap(step, (P(), P(), P(), P(), P(), P()), (P(), P(), P(), P()))
    flushed = smap(flush, (P(), P(), P()), (P(), P()))
    p, m = tree, jnp.asarray(mom)
    lane = eng.empty_inflight(plan, guarded=guard)
    out = []
    with compat_set_mesh(mesh):
        for k in range(K):
            p, m, sc, lane = stepped(jnp.asarray(gpools[k]), p, m, sc,
                                     jnp.float32(LRS[k]), lane)
            out.append(flat(p, m))
        p, m = flushed(p, m, lane)
    return out, flat(p, m)


def _torch_chain(tail, guard):
    """The port's chain: with a tail, the lane apply then
    ``run_pipelined(_guarded)`` a step, then the flush; without one,
    ``run`` / ``run_guarded``. Returns what ``_jax_chain`` does, and the
    verdicts."""
    params, mom, gpools = _setup(guard)
    tree = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    pool = GradientPool(tree, pad_to=1)
    gf = GradientFlow(_cfg(t_base, tail, guard), pool, num_data_shards=1)
    eng = TEngine(gf, "momentum_sgd", _opt(t_base))
    plan = eng.plan_for()
    assert plan.pipeline_tail == tail
    opt = t_sgd.SGDState(momentum=torch.from_numpy(mom.copy()))
    st0 = gf.init_state("cpu")
    sc = t_scaler.init(t_base.GuardConfig(), "cpu") if guard else ()
    lane = eng.empty_inflight(plan)
    out, trips = [], []

    def flat():
        return torch.cat([pool.pack(tree)[0], opt.momentum]).numpy().copy()

    for k in range(K):
        gpool = torch.from_numpy(gpools[k].copy())
        lr = torch.tensor(LRS[k], dtype=torch.float32)
        if tail:
            tree, opt = eng.apply_inflight(plan, tree, opt, lane)
        if tail and guard:
            tree, opt, _, sc, lane, flags = eng.run_pipelined_guarded(
                plan, gpool, tree, opt, st0, sc, lr)
        elif tail:
            tree, opt, _, lane = eng.run_pipelined(plan, gpool, tree, opt,
                                                   st0, lr)
        elif guard:
            tree, opt, _, sc, flags = eng.run_guarded(plan, gpool, tree, opt,
                                                      st0, sc, lr)
        else:
            tree, opt, _ = eng.run(plan, gpool, tree, opt, st0, lr)
        if guard:
            trips.append(bool(flags.nonfinite | flags.overflow))
        out.append(flat())
    if tail:
        assert isinstance(lane, InflightLane) and len(lane.segs) == tail
        assert all(s.dtype == torch.float32 for s in lane.segs)
        tree, opt = eng.apply_inflight(plan, tree, opt, lane)
    return out, flat(), trips


@pytest.mark.parametrize("guard", [False, True])
def test_pipelined_chain_matches_jax_and_unpipelined(guard):
    j_steps, j_final = _jax_chain(guard)
    steps, final, trips = _torch_chain(2, guard)
    base_steps, base_final, base_trips = _torch_chain(0, guard)
    # Step by step against JAX: the tail spans lag one step in both.
    for k, (got, want) in enumerate(zip(steps, j_steps)):
        np.testing.assert_allclose(got, want, err_msg=f"step {k}", **TOL)
    np.testing.assert_allclose(final, j_final, **TOL)
    # The flushed chain is the unpipelined one, bit for bit.
    np.testing.assert_array_equal(final, base_final)
    if guard:
        assert trips == base_trips == [False, False, True, False]
        # Step 2 tripped: its head spans kept their values, and at the
        # next step's start its rejected lane wrote nothing, so step 3
        # started from step 1's state and the chain still matches.
        np.testing.assert_array_equal(base_steps[2], base_steps[1])


def test_rejected_lane_writes_nothing():
    """``apply_inflight`` with ``ok`` false leaves every tail span and
    its momentum as they were; with ``ok`` true it updates exactly the
    tail spans."""
    params, mom, _ = _setup()
    tree = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    pool = GradientPool(tree, pad_to=1)
    gf = GradientFlow(_cfg(t_base, 2, False), pool, num_data_shards=1)
    eng = TEngine(gf, "momentum_sgd", _opt(t_base))
    plan = eng.plan_for()
    opt = t_sgd.SGDState(momentum=torch.from_numpy(mom.copy()))
    segs = tuple(torch.ones(t.size) for t in plan.tail_tasks)
    before = torch.cat([pool.pack(tree)[0], opt.momentum]).clone()
    for ok in (False, True):
        lane = InflightLane(segs=segs, lr=torch.tensor(0.1),
                            ok=torch.tensor(ok))
        ops.reset_counts()
        tree, opt = eng.apply_inflight(plan, tree, opt, lane)
        after = torch.cat([pool.pack(tree)[0], opt.momentum])
        changed = (after != before).nonzero().flatten()
        if not ok:
            assert changed.numel() == 0
        else:
            lo = plan.tail_tasks[0].start
            assert changed.numel() > 0 and int(changed.min()) >= lo
            assert int((changed % pool.size).min()) >= lo
    lane = InflightLane(segs=segs, lr=torch.tensor(0.1), ok=torch.tensor(True))
    cfg = dataclasses.replace(gf.cfg, use_kernels=True)
    eng_k = TEngine(GradientFlow(cfg, pool, 1), "momentum_sgd", _opt(t_base))
    ops.reset_counts()
    eng_k.apply_inflight(plan, tree, opt, lane)
    # One master pack and one update per tail span, plain on the CPU.
    assert ops.dispatch_counts == {"pool_pack.plain": 2,
                                   "pool_unpack_update.plain": 2}


def test_assert_flushed_rejects_a_live_lane():
    empty = TrainState(params={}, opt=(), gf=(), step=0)
    assert is_flushed(empty)
    assert_flushed(empty)
    live = empty._replace(inflight=InflightLane(
        segs=(torch.zeros(3),), lr=torch.tensor(0.1),
        ok=torch.tensor(True)))
    assert not is_flushed(live)
    with pytest.raises(ValueError, match="in-flight pipeline lane"):
        assert_flushed(live, "a checkpoint")
