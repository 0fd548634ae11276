"""The port's analytic timeline (``core.engine.simulate_plan``,
``simulate_plan_pipelined`` and their renderings) against the JAX
package's, and ``repro_torch.launch.dryrun --timeline`` and ``--soak``
against ``repro.launch.dryrun``.

The plans are the same layouts built by each package's GradientFlow:
dense, lazy, CSC's warm-up and CSC's sparse stage, at the auto-tuned θ
and at a fixed one, on Cluster-V 64x8 and on a small two-level host
(2 x 4). The simulations are cost-model arithmetic, the same formulas in
the same order: every float must be equal, not close. JAX's dry run sets
XLA_FLAGS when imported, so its CLI runs in a subprocess.
"""
import contextlib
import dataclasses
import functools
import io
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from repro.configs.base import GradientFlowConfig as JCfg
from repro.configs.shapes import ALEXNET_GRAD_SHAPES
from repro.core import engine as j_engine
from repro.core.gradientflow import GradientFlow as JFlow
from repro.core.pool import GradientPool as JPool
from repro.parallel import cost_model as j_cost
from repro.parallel.topology import Topology as JTopo
from repro_torch.configs.base import GradientFlowConfig as TCfg
from repro_torch.core import engine as t_engine
from repro_torch.core.gradientflow import GradientFlow as TFlow
from repro_torch.core.pool import GradientPool as TPool
from repro_torch.launch import dryrun as t_dryrun
from repro_torch.parallel import cost_model as t_cost
from repro_torch.parallel.topology import Topology as TTopo

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
CHUNK = 32768


def _topos(name):
    if name == "cluster_v":
        return JTopo.cluster_v(64, 8), TTopo.cluster_v(64, 8)
    axes, sizes = ("node", "gpu"), (2, 4)
    return (JTopo.from_axis_sizes(axes, sizes, fabrics=(j_cost.NCCL_56G,
                                                        j_cost.INTRA_NODE)),
            TTopo.from_axis_sizes(axes, sizes, fabrics=(t_cost.NCCL_56G,
                                                        t_cost.INTRA_NODE)))


def _plans(kind, theta, topo_name, wire="float16"):
    """(JAX plan, port plan, JAX topology, port topology) of one layout."""
    j_topo, t_topo = _topos(topo_name)
    mode = "csc" if kind.startswith("csc") else kind
    pad = CHUNK if mode == "csc" else 1
    kw = dict(mode=mode, wire_dtype=wire, chunk_elems=CHUNK, sparsity=0.85,
              warmup_steps=4 if kind == "csc_warmup" else 0,
              bucket_elems=theta or 16 * 1024 * 1024,
              auto_bucket=theta == 0, collective_algo="auto",
              reduce_axes=("node", "gpu"),
              pipeline_tail_buckets=0 if mode == "csc" else -1)
    j_pool = JPool({f"t{i}": jax.ShapeDtypeStruct(s, jnp.float32)
                    for i, s in enumerate(ALEXNET_GRAD_SHAPES)}, pad_to=pad)
    t_pool = TPool({f"t{i}": tuple(s) for i, s in
                    enumerate(ALEXNET_GRAD_SHAPES)}, pad_to=pad)
    j_gf = JFlow(JCfg(topology=j_topo, **kw), j_pool,
                 num_data_shards=j_topo.num_devices)
    t_gf = TFlow(TCfg(topology=t_topo, **kw), t_pool,
                 num_data_shards=t_topo.num_devices)
    stage = 0 if kind == "csc_warmup" else -1
    j_plan = j_gf.plan(j_gf.stages[stage])
    t_plan = t_gf.plan(t_gf.stages[stage])
    assert j_plan.warmup == t_plan.warmup == (kind == "csc_warmup")
    assert [(t.start, t.end, t.algo.name) for t in j_plan.tasks] == \
        [(t.start, t.end, t.algo.name) for t in t_plan.tasks]
    return j_plan, t_plan, j_topo, t_topo


def _rows(rows):
    return [tuple(dataclasses.astuple(r)) for r in rows]


CASES = [(k, th, tp) for k in ("dense", "lazy", "csc_warmup", "csc")
         for th in (0, 1 << 20) for tp in ("cluster_v", "host_2x4")]


@pytest.mark.parametrize("kind,theta,topo", CASES)
def test_simulate_plan_equals_jax(kind, theta, topo):
    j_plan, t_plan, j_topo, t_topo = _plans(kind, theta, topo)
    want = j_engine.simulate_plan(j_plan, j_topo)
    got = t_engine.simulate_plan(t_plan, t_topo)
    assert _rows(got["rows"]) == _rows(want["rows"])
    assert got["summary"] == want["summary"]
    assert got["backward_s"] == want["backward_s"]
    assert got["monolithic_finish_s"] == want["monolithic_finish_s"]
    assert t_engine.render_timeline(t_plan, t_topo) == \
        j_engine.render_timeline(j_plan, j_topo)
    # An explicit backward time is taken as given.
    assert t_engine.simulate_plan(t_plan, t_topo, backward_s=0.03)[
        "summary"] == j_engine.simulate_plan(j_plan, j_topo,
                                             backward_s=0.03)["summary"]


@pytest.mark.parametrize("kind,theta,topo", [
    c for c in CASES if c[0] != "csc"])
def test_simulate_plan_pipelined_equals_jax(kind, theta, topo):
    j_plan, t_plan, j_topo, t_topo = _plans(kind, theta, topo)
    for tail in (None, 1, 3):
        want = j_engine.simulate_plan_pipelined(j_plan, j_topo, tail=tail)
        got = t_engine.simulate_plan_pipelined(t_plan, t_topo, tail=tail)
        assert got == want, tail
    assert t_engine.render_cross_step_timeline(t_plan, t_topo) == \
        j_engine.render_cross_step_timeline(j_plan, j_topo)


def test_wire_width_from_the_dtype_name():
    for name in ("float16", "bfloat16", "float32", "int8"):
        assert t_engine.wire_itemsize(name) == jnp.dtype(name).itemsize
    j_plan, t_plan, j_topo, t_topo = _plans("lazy", 0, "host_2x4",
                                            wire="bfloat16")
    assert t_engine.render_timeline(t_plan, t_topo) == \
        j_engine.render_timeline(j_plan, j_topo)


_JAX_CLI = """
import contextlib, io, sys
sys.path.insert(0, {src!r})
from repro.launch import dryrun
for argv in {argvs!r}:
    sys.argv = ["dryrun"] + argv
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dryrun.main()
    sys.stdout.write(buf.getvalue() + "\\x00")
"""


def jax_dryrun(argvs):
    """JAX's ``dryrun.main`` stdout for each argv, from one subprocess."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_CLI.format(src=SRC, argvs=argvs)],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.split("\x00")[:-1]


def port_dryrun(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        t_dryrun.main(argv)
    return buf.getvalue()


DRYRUN_ARGVS = (
    ("--timeline", "--timeline-mode", "dense"),
    ("--timeline", "--timeline-mode", "lazy"),
    ("--timeline", "--timeline-mode", "csc"),
    ("--timeline", "--timeline-theta", str(1 << 20), "--timeline-tail", "2"),
    ("--soak", "--soak-steps", "60", "--soak-seed", "3"),
)


@functools.lru_cache(maxsize=1)
def jax_dryrun_outputs():
    """JAX's stdout for every argv of ``DRYRUN_ARGVS`` (one subprocess)."""
    return dict(zip(DRYRUN_ARGVS, jax_dryrun([list(a)
                                              for a in DRYRUN_ARGVS])))


@pytest.mark.parametrize("argv", DRYRUN_ARGVS, ids=lambda a: "_".join(
    x.strip("-") for x in a[:3]))
def test_dryrun_equals_jax(argv):
    """``dryrun --timeline`` in each mode and ``dryrun --soak`` (the
    guard lane on the CPU): the port prints JAX's text."""
    extra = ["--device", "cpu"] if "--soak" in argv else []
    assert port_dryrun(list(argv) + extra) == jax_dryrun_outputs()[argv]


def test_dryrun_without_a_mode_names_the_roadmap():
    with pytest.raises(SystemExit) as e:
        t_dryrun.main([])
    assert "ROADMAP.md C" in str(e.value)
