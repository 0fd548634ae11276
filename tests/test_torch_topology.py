"""The port's topology layer against the JAX package's, on the CPU: the
cost model function by function, the algorithms' predicted times,
``select_algorithm`` from 1 KB to 1 GB, θ auto-tuning on the smoke and
the full smollm-135m pools, ``GradientFlow(auto_bucket=True)``'s layout —
all plain arithmetic, so equal to the float — and every algorithm over 4
gloo ranks laid out as 2 × 2 (``("node", "gpu")``), held against the flat
sum."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.configs import get_arch as j_get_arch
from repro.configs import get_smoke as j_get_smoke
from repro.core.gradientflow import GradientFlow as JGradientFlow
from repro.core.pool import GradientPool as JPool
from repro.models import build_model as j_build_model
from repro.parallel import cost_model as j_cm
from repro.parallel import topology as j_topo
from repro.parallel.sharding import abstract_params
from repro_torch.configs import base as t_base
from repro_torch.configs import get_arch, get_smoke
from repro_torch.core.gradientflow import GradientFlow
from repro_torch.core.pool import GradientPool
from repro_torch.models import build_model
from repro_torch.parallel import cost_model as t_cm
from repro_torch.parallel import topology as t_topo
from test_torch_ring import spawn_ranks

FABRICS = ("NCCL_56G", "MPI_56G", "GLOO_56G", "INTRA_NODE", "HOST_LOOPBACK")
MSGS = (0.0, 1.0, 1000.0, 4096.0, 65536.0, 1e6, 8.4e6, 2.69e8, 1e9)
NS = (1, 2, 3, 8, 64, 512)


def _fab(cm, name):
    return getattr(cm, name)


def _topos(fabric_names_by_level, axes, sizes):
    """The same topology in both packages."""
    return tuple(
        mod.Topology.from_axis_sizes(axes, sizes, fabrics=[
            _fab(cm, f) for f in fabric_names_by_level])
        for mod, cm in ((j_topo, j_cm), (t_topo, t_cm)))


TOPOLOGIES = {
    "cluster_v": (j_topo.Topology.cluster_v(), t_topo.Topology.cluster_v()),
    "three_level": _topos(("NCCL_56G", "NCCL_56G", "INTRA_NODE"),
                          ("pod", "node", "gpu"), (4, 16, 8)),
    "host_2x4": (j_topo.Topology.host_mesh(("pod", "data"), (2, 4)),
                 t_topo.Topology.host_mesh(("pod", "data"), (2, 4))),
    "flat_8": (j_topo.Topology.flat("data", 8), t_topo.Topology.flat(
        "data", 8)),
}


def test_fabrics_and_constants_match_jax():
    for name in FABRICS:
        assert dataclasses.astuple(_fab(t_cm, name)) == \
            dataclasses.astuple(_fab(j_cm, name))
    assert t_cm.HBM_BW == j_cm.HBM_BW
    assert t_cm.UPDATE_BYTES_PER_ELEM == j_cm.UPDATE_BYTES_PER_ELEM


@pytest.mark.parametrize("fn", [
    "ring_allreduce_time", "reduce_scatter_time", "all_gather_time",
    "effective_throughput"])
def test_size_n_fabric_functions_match_jax(fn):
    for f in FABRICS:
        for m in MSGS:
            for n in NS:
                assert getattr(t_cm, fn)(m, n, _fab(t_cm, f)) == \
                    getattr(j_cm, fn)(m, n, _fab(j_cm, f)), (f, m, n)


def test_ring_step_functions_match_jax():
    for n in NS:
        assert t_cm.ring_exchange_steps(n) == j_cm.ring_exchange_steps(n)
        for m in MSGS:
            assert t_cm.ring_step_wire_bytes(m, n) == \
                j_cm.ring_step_wire_bytes(m, n)
    for f in FABRICS:
        for m in MSGS:
            assert t_cm.bw_eff(_fab(t_cm, f), m + 1) == \
                j_cm.bw_eff(_fab(j_cm, f), m + 1)
            levels = [(8, f), (64, "NCCL_56G"), (2, "INTRA_NODE")]
            assert t_cm.sequential_ring_time(
                m, [(n, _fab(t_cm, x)) for n, x in levels]) == \
                j_cm.sequential_ring_time(
                    m, [(n, _fab(j_cm, x)) for n, x in levels])
            if m:  # both divide by the per-step bytes
                assert t_cm.hierarchical_allreduce_time(
                    m, 64, 8, _fab(t_cm, f)) == \
                    j_cm.hierarchical_allreduce_time(m, 64, 8, _fab(j_cm, f))
        assert t_cm.allreduce_sequence_time(
            MSGS, 16, _fab(t_cm, f)) == j_cm.allreduce_sequence_time(
                MSGS, 16, _fab(j_cm, f))


def _timeline_inputs(seed, n):
    rng = np.random.default_rng(seed)
    sizes = list(rng.uniform(1e5, 5e7, n))
    comm = list(rng.uniform(1e-4, 2e-2, n))
    upd = [t_cm.update_time(s / 2) for s in sizes]
    return sizes, comm, upd


@pytest.mark.parametrize("n", [1, 4, 7])
def test_timeline_functions_match_jax(n):
    sizes, comm, upd = _timeline_inputs(n, n)
    bwd = 0.05
    for cm in (t_cm, j_cm):
        assert cm.update_time(1e6) == t_cm.update_time(1e6)
    rel_t = t_cm.bucket_release_times(sizes, bwd)
    assert rel_t == j_cm.bucket_release_times(sizes, bwd)
    assert t_cm.fwd_need_times(sizes, bwd) == j_cm.fwd_need_times(sizes, bwd)
    assert t_cm.overlapped_finish_time(comm, rel_t) == \
        j_cm.overlapped_finish_time(comm, rel_t)
    rows_t = t_cm.staged_timeline(comm, rel_t, upd)
    rows_j = j_cm.staged_timeline(comm, rel_t, upd)
    assert [dataclasses.astuple(r) for r in rows_t] == \
        [dataclasses.astuple(r) for r in rows_j]
    assert [r.exposed_comm_s(bwd) for r in rows_t] == \
        [r.exposed_comm_s(bwd) for r in rows_j]
    assert t_cm.timeline_summary(rows_t, bwd) == \
        j_cm.timeline_summary(rows_j, bwd)
    assert t_cm.staged_finish_time(comm, rel_t, upd) == \
        j_cm.staged_finish_time(comm, rel_t, upd)
    for tail in range(n):
        assert t_cm.cross_step_timeline(comm, rel_t, upd, tail, bwd) == \
            j_cm.cross_step_timeline(comm, rel_t, upd, tail, bwd)
        assert t_cm.pipelined_finish_time(comm, rel_t, upd, tail, bwd) == \
            j_cm.pipelined_finish_time(comm, rel_t, upd, tail, bwd)
    assert t_cm.select_pipeline_tail(comm, rel_t, upd, bwd) == \
        j_cm.select_pipeline_tail(comm, rel_t, upd, bwd)


@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
def test_topology_and_predicted_times_match_jax(topo):
    jt, tt = TOPOLOGIES[topo]
    assert tt.axes == jt.axes and tt.num_devices == jt.num_devices
    assert dataclasses.astuple(tt.slowest_fabric) == \
        dataclasses.astuple(jt.slowest_fabric)
    assert tt.restrict(tt.axes[1:]).axes == jt.restrict(jt.axes[1:]).axes
    for name in ("flat", "two_level", "tree", "pallas_ring"):
        ta, ja = t_topo.get_algorithm(name), j_topo.get_algorithm(name)
        assert ta.applicable(tt) == ja.applicable(jt)
        for m in MSGS:
            assert ta.predicted_time(m, tt) == ja.predicted_time(m, jt), (
                name, m)


@pytest.mark.parametrize("topo", ["cluster_v", "three_level", "host_2x4"])
def test_select_algorithm_matches_jax(topo):
    """From 1 KB to 1 GB by powers of two."""
    jt, tt = TOPOLOGIES[topo]
    picked = set()
    for p in range(10, 31):
        ta, t_time = t_topo.select_algorithm(2.0 ** p, tt)
        ja, j_time = j_topo.select_algorithm(2.0 ** p, jt)
        assert (ta.name, t_time) == (ja.name, j_time), p
        assert t_topo.resolve_algorithm("auto", tt, 2.0 ** p).name == ja.name
        picked.add(ta.name)
    assert picked  # at least one algorithm on each topology


def _pools(full, pad=1):
    j_model = (j_get_arch if full else j_get_smoke)("smollm-135m")[0]
    t_model = (get_arch if full else get_smoke)("smollm-135m")[0]
    return (JPool(abstract_params(j_build_model(j_model).param_specs()),
                  pad_to=pad),
            GradientPool(build_model(t_model).param_shapes(), pad_to=pad))


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("topo", ["cluster_v", "three_level"])
def test_auto_bucket_boundaries_match_jax(full, topo):
    jpool, tpool = _pools(full)
    jt, tt = TOPOLOGIES[topo]
    for algo in ("auto", "flat", "two_level", "pallas_ring"):
        for wire in ("bfloat16", "float32"):
            for bw in (None, t_cm.HBM_BW):
                got = t_topo.auto_bucket_boundaries(
                    tpool, wire, tt, collective_algo=algo, update_bw=bw)
                want = j_topo.auto_bucket_boundaries(
                    jpool, wire, jt, collective_algo=algo, update_bw=bw)
                assert got[0] == want[0], (algo, wire, bw)
                assert list(got[1]) == [tuple(b) for b in want[1]]


@pytest.mark.parametrize("topo", ["cluster_v", "host_2x4"])
@pytest.mark.parametrize("overlap", ["staged", "monolithic"])
@pytest.mark.parametrize("mode", ["lazy", "csc"])
@pytest.mark.parametrize("algo", ["auto", "pallas_ring", "tree"])
def test_gradientflow_auto_bucket_matches_jax(mode, algo, overlap, topo):
    """A GradientFlow with auto_bucket and a topology: the same θ, bucket
    layout, per-bucket algorithms and step plans, staged (θ priced against
    the update pipeline) and monolithic (communication only). (The JAX
    package also stamps a Pallas collective id on each ring bucket; the
    port's rings share one workspace per level group and carry no id.)"""
    pad = 32768 if mode == "csc" else 1
    jpool, tpool = _pools(True, pad)
    jt, tt = TOPOLOGIES[topo]
    kw = dict(mode=mode, auto_bucket=True, collective_algo=algo,
              warmup_steps=4, warmup_stages=4, overlap=overlap)
    n = tt.num_devices
    jgf = JGradientFlow(j_base.GradientFlowConfig(topology=jt, **kw), jpool,
                        n)
    tgf = GradientFlow(t_base.GradientFlowConfig(topology=tt, **kw), tpool,
                       n)
    assert tgf.bucket_elems == jgf.bucket_elems != kw.get("bucket_elems")
    assert tgf._lazy_bounds == tuple(tuple(b) for b in jgf._lazy_bounds)

    def algos(xs):
        return [a.name for a in xs]

    assert algos(tgf._lazy_algos) == algos(jgf._lazy_algos)
    assert algos(tgf._dense_algos) == algos(jgf._dense_algos)
    for ts, js in zip(tgf.stages, jgf.stages):
        tp, jp = tgf.plan(ts), jgf.plan(js)
        assert [(t.start, t.end, t.algo.name) for t in tp.tasks] == \
            [(t.start, t.end, t.algo.name) for t in jp.tasks]


def test_mesh_topology():
    t = t_topo.mesh_topology(4)
    assert t.axes == ("data",) and t.num_devices == 4
    assert t.levels[0].fabric == t_cm.INTRA_NODE
    two = t_topo.Topology.host_mesh(("node", "gpu"), (2, 2))
    assert t_topo.mesh_topology(4, two) is two
    with pytest.raises(ValueError, match="covers 4 ranks"):
        t_topo.mesh_topology(8, two)


# -- 4 gloo ranks as 2 x 2 ---------------------------------------------------------

_TOPO_BODY = """
    from repro_torch.core import lazy_allreduce
    from repro_torch.core.gradientflow import GradientFlow
    from repro_torch.configs import base
    from repro_torch.kernels import ops
    from repro_torch.parallel import collectives, topology
    topo = topology.Topology.from_axis_sizes(("node", "gpu"), (2, 2))
    groups = collectives.level_groups(topo)
    saved = {"node_ranks": np.asarray(groups.levels[0].ranks),
             "gpu_ranks": np.asarray(groups.levels[1].ranks),
             "outer_ranks": np.asarray(groups.outer.ranks)}
    for size in (4 * 37, 4 * 5 + 3, 1):
        x = torch.from_numpy(np.random.default_rng(rank * 10 + size)
                             .standard_normal(size).astype(np.float32))
        for name in ("flat", "two_level", "tree", "pallas_ring", "auto"):
            algo = topology.resolve_algorithm(name, topo, size * 4)
            ops.reset_counts()
            res, work = algo.reduce(x.clone(), topo)
            if work is not None:
                work.wait()
            saved[f"{size}|{name}"] = res.numpy()
            if name == "pallas_ring":
                # One ring per level, innermost first.
                assert ops.dispatch_counts == {"ring_allreduce.plain": 2}
    # The bucketed reduce of a pool, one collective per bucket.
    pool = torch.from_numpy(np.random.default_rng(rank).standard_normal(
        1000).astype(np.float32))
    bounds = [(0, 300), (300, 301), (301, 1000)]
    for name in ("two_level", "tree", "pallas_ring"):
        algos = [topology.resolve_algorithm(name, topo) for _ in range(3)]
        parts = lazy_allreduce.bucketed_reduce_parts(
            pool.clone(), bounds, None, algo=algos, topo=topo)
        saved[f"bucketed|{name}"] = torch.cat(parts).numpy()
    np.savez(out, **saved)
"""


def test_topology_2x2_over_gloo_matches_flat_sum(tmp_path):
    """Every algorithm, and 'auto', over 4 ranks as 2 nodes x 2 GPUs
    equals the flat sum within f32 rounding (rtol 1e-6, atol 1e-6: the
    algorithms add the four values in different orders)."""
    ranks = spawn_ranks(tmp_path, _TOPO_BODY, 4)
    # Row-major: rank = node * 2 + gpu.
    assert [tuple(r["gpu_ranks"]) for r in ranks] == [(0, 1), (0, 1),
                                                     (2, 3), (2, 3)]
    assert [tuple(r["node_ranks"]) for r in ranks] == [(0, 2), (1, 3),
                                                      (0, 2), (1, 3)]
    assert [tuple(r["outer_ranks"]) for r in ranks] == [(0, 2), (1, 3),
                                                       (0, 2), (1, 3)]
    for size in (4 * 37, 4 * 5 + 3, 1):
        want = sum(np.random.default_rng(r * 10 + size).standard_normal(
            size).astype(np.float32).astype(np.float64) for r in range(4))
        for name in ("flat", "two_level", "tree", "pallas_ring", "auto"):
            for r in range(4):
                np.testing.assert_allclose(ranks[r][f"{size}|{name}"], want,
                                           rtol=1e-6, atol=1e-6,
                                           err_msg=f"{name} {size} rank {r}")
    want = sum(np.random.default_rng(r).standard_normal(1000).astype(
        np.float32).astype(np.float64) for r in range(4))
    for name in ("two_level", "tree", "pallas_ring"):
        for r in range(4):
            np.testing.assert_allclose(ranks[r][f"bucketed|{name}"], want,
                                       rtol=1e-6, atol=1e-6, err_msg=name)
