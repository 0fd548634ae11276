"""The port's Trainer against the JAX package's Trainer: the same weights
and the same numpy batches give the same loss stream and the same final
parameters, lazy (several buckets) and dense. Plus the analytics that
must agree exactly, and a 2-rank gloo run of the data-parallel path."""
import dataclasses
import functools
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs import get_smoke as j_get_smoke
from repro.configs import base as j_base
from repro.core.gradientflow import GradientFlow as JGradientFlow
from repro.core.pool import GradientPool as JPool
from repro.launch.mesh import make_host_mesh
from repro.launch.trainer import Trainer as JTrainer
from repro.models import build_model as j_build_model
from repro.parallel.collectives import compat_set_mesh
from repro.parallel.sharding import abstract_params
from repro_torch import convert
from repro_torch.configs import base as t_base
from repro_torch.configs import get_arch, get_smoke
from repro_torch.core.gradientflow import GradientFlow
from repro_torch.core.pool import GradientPool, flatten_tree
from repro_torch.kernels import ops
from repro_torch.launch.trainer import Trainer
from repro_torch.models import build_model

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
B, S, STEPS = 2, 32, 3


def _cfg(base, get_smoke_fn, mode, wire, use_kernels=False, batch=B,
         steps=STEPS, optimizer="momentum_sgd"):
    model = dataclasses.replace(get_smoke_fn("smollm-135m")[0],
                                compute_dtype="float32")
    return base.TrainConfig(
        model=model,
        gradientflow=base.GradientFlowConfig(
            mode=mode, bucket_elems=8192, wire_dtype=wire,
            use_kernels=use_kernels),
        optimizer=base.OptimizerConfig(
            name=optimizer, learning_rate=0.1, momentum=0.9,
            weight_decay=1e-4, warmup_steps=2, total_steps=steps,
            schedule="warmup_cosine"),
        seq_len=S, global_batch=batch, attn_chunk=0)


def _batches(n, batch=B, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, 256, (batch, S + 1))
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


@functools.lru_cache(maxsize=None)
def _jax_run(mode, wire):
    """(initial params, losses, final params) of the JAX Trainer."""
    trainer = JTrainer(_cfg(j_base, j_get_smoke, mode, wire),
                       make_host_mesh(), j_get_smoke("smollm-135m")[1])
    with compat_set_mesh(trainer.mesh):
        state = trainer.init_state(jax.random.PRNGKey(0))
        init = jax.tree_util.tree_map(np.asarray, state.params)
        step = trainer.build_train_step()
        losses = []
        for b in _batches(STEPS):
            jb = jax.device_put({k: jnp.asarray(v, jnp.int32)
                                 for k, v in b.items()})
            state, metrics = step(state, jb)
            losses.append(float(metrics["loss"]))
        final = jax.tree_util.tree_map(np.asarray, state.params)
    return init, losses, final


def _torch_run(cfg, init, batches):
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(params=convert.params_from_numpy(init, "cpu"))
    step = trainer.build_train_step()
    losses = []
    for b in batches:
        state, metrics = step(state, {k: torch.from_numpy(v)
                                      for k, v in b.items()})
        losses.append(float(metrics["loss"]))
    return losses, convert.params_to_numpy(state.params)


def _leaves(tree):
    return [(("/".join(p)), np.asarray(v)) for p, v in flatten_tree(tree)]


# f32 wire: the frameworks' f32 matmuls differ in the last bits, so
# rtol 1e-5 (atol 1e-6 for parameters near zero). bf16 wire: a last-ulp
# f32 difference in a gradient can flip the bf16 rounding of a few pool
# elements, which moves those parameters by lr x one bf16 ulp of the
# gradient; atol 1e-4 bounds that.
@pytest.mark.parametrize("mode,wire,use_kernels", [
    ("lazy", "float32", True), ("lazy", "float32", False),
    ("lazy", "bfloat16", True), ("dense", "float32", True)])
def test_trainer_matches_jax(mode, wire, use_kernels):
    init, j_losses, j_final = _jax_run(mode, wire)
    ops.reset_counts()
    t_losses, t_final = _torch_run(
        _cfg(t_base, get_smoke, mode, wire, use_kernels), init,
        _batches(STEPS))
    tol = dict(rtol=1e-5, atol=1e-6) if wire == "float32" \
        else dict(rtol=0, atol=1e-4)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    for (name, a), (_, b) in zip(_leaves(t_final), _leaves(j_final)):
        np.testing.assert_allclose(a, b, err_msg=name, **tol)
    if use_kernels:
        pool = GradientPool(build_model(get_smoke("smollm-135m")[0])
                            .param_shapes())
        n_buckets = len(pool.bucket_boundaries(8192)) if mode == "lazy" \
            else pool.num_tensors
        assert ops.dispatch_counts == {
            "pool_pack.plain": 2 * STEPS,
            "pool_unpack_update.plain": n_buckets * STEPS}


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("mode", ["dense", "lazy", "csc"])
@pytest.mark.parametrize("wire,theta", [("bfloat16", 4_194_304),
                                        ("float32", 8192), ("bfloat16", 0)])
def test_analytics_match_jax(full, mode, wire, theta):
    """Collectives, wire bytes and the step plan (tasks, update spans,
    warm-up flag) of every stage: CSC at the JAX CLI's 0.85 sparsity with
    4 warm-up stages, its pool padded to 32,768-element chunks."""
    j_model = (j_get_arch if full else j_get_smoke)("smollm-135m")[0]
    t_model = (get_arch if full else get_smoke)("smollm-135m")[0]
    kw = dict(mode=mode, bucket_elems=theta, wire_dtype=wire,
              warmup_steps=4, warmup_stages=4)
    pad = 32768 if mode == "csc" else 1
    jgf = JGradientFlow(j_base.GradientFlowConfig(**kw), JPool(abstract_params(
        j_build_model(j_model).param_specs()), pad_to=pad), 1)
    tgf = GradientFlow(t_base.GradientFlowConfig(**kw), GradientPool(
        build_model(t_model).param_shapes(), pad_to=pad), 1)
    assert tgf.num_chunks == jgf.num_chunks
    assert len(tgf.stages) == len(jgf.stages) == (5 if mode == "csc" else 1)
    for ts, js in zip(tgf.stages + [None], jgf.stages + [None]):
        assert tgf.num_collectives(ts) == jgf.num_collectives(js)
        assert tgf.wire_bytes_per_step(ts) == jgf.wire_bytes_per_step(js)
        tp, jp = tgf.plan(ts), jgf.plan(js)
        tp.validate()
        assert [(t.start, t.end) for t in tp.tasks] == \
            [(t.start, t.end) for t in jp.tasks]
        assert tp.update_spans == jp.update_spans
        assert (tp.warmup, tp.num_selected) == (jp.warmup, jp.num_selected)
    if mode == "csc" and full and theta == 4_194_304:
        # The chip check's CSC step: 4106 chunks; 7 update spans, the
        # last one padding only; 26/19/12/5 wire buckets after warm-up.
        assert tgf.pool.size == 134_545_408 and tgf.num_chunks == 4106
        assert len(tgf.plan().update_spans) == 7
        assert tgf.plan().update_spans[-1] == (134_515_008, 134_545_408)
        assert [tgf.num_collectives(s) - 1 for s in tgf.stages] == \
            [7, 26, 19, 12, 5]


def test_unported_settings_raise():
    """The low-bit wires build and step, guarded or not
    (tests/test_torch_wire.py holds them against JAX); a deferred tail
    (``pipeline_tail_buckets``) builds and a per-step step runs it
    unpipelined, as in the JAX package, the same bits as without it
    (tests/test_torch_pipeline.py and test_torch_window.py hold the
    pipelined window); gradient accumulation builds and steps
    (tests/test_torch_accumulate.py holds it against JAX); the dense and
    MoE and ssm architectures resolve, and an unknown one raises, naming
    ROADMAP.md."""
    base = _cfg(t_base, get_smoke, "lazy", "bfloat16")
    guard = t_base.GuardConfig()
    batch = {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()}
    for gf in (dict(wire_format="int8"),
               dict(wire_format="int8", guard=guard)):
        cfg = base.replace(gradientflow=dataclasses.replace(
            base.gradientflow, **gf))
        trainer = Trainer(cfg, device="cpu")
        state, metrics = trainer.build_train_step()(trainer.init_state(0),
                                                    batch)
        assert np.isfinite(float(metrics["loss"])) and state.step == 1
        assert state.gf.residual.shape == (trainer.pool.size,)
        assert state.gf.residual.abs().max() > 0
    for gf in (dict(), dict(guard=guard)):
        runs = []
        for tail in (0, 1):
            cfg = base.replace(gradientflow=dataclasses.replace(
                base.gradientflow, pipeline_tail_buckets=tail, **gf))
            trainer = Trainer(cfg, device="cpu")
            assert trainer.engine.plan_for().pipeline_tail == tail
            state, metrics = trainer.build_train_step()(
                trainer.init_state(0), batch)
            assert np.isfinite(float(metrics["loss"])) and state.step == 1
            assert state.inflight == ()
            runs.append(torch.cat([p.reshape(-1) for p in
                                   trainer.pool.flat_leaves(state.params)]))
        assert torch.equal(runs[0], runs[1])
    trainer = Trainer(base.replace(microbatches=2), device="cpu")
    state, metrics = trainer.build_train_step()(trainer.init_state(0), batch)
    assert np.isfinite(float(metrics["loss"])) and state.step == 1
    assert get_arch("qwen3-32b")[0].qk_norm
    assert get_arch("grok-1-314b")[0].moe.num_experts == 8
    assert get_arch("falcon-mamba-7b")[0].family == "ssm"
    with pytest.raises(KeyError, match="ROADMAP"):
        get_arch("falcon-mamba-1b")


def test_cli_accepts_the_optimizers(tmp_path):
    """``--optimizer`` takes the three optimizers and ``--wire-format``
    the low-bit wires, which reach the config and step; ``--window-steps``
    parses; ``--ckpt-dir`` gets the run's final checkpoint
    (tests/test_torch_checkpoint.py resumes from one)."""
    from repro_torch.launch import train as train_mod

    argv = ["--arch", "smollm-135m", "--reduced", "--device", "cpu"]
    for name in ("momentum_sgd", "lars", "adamw"):
        args = train_mod.parse_args(argv + ["--optimizer", name])
        assert args.optimizer == name
    args = train_mod.parse_args(argv + ["--optimizer", "lars",
                                        "--wire-format", "int8",
                                        "--gf-mode", "lazy", "--steps", "1",
                                        "--batch", "2", "--seq-len", "16",
                                        "--ckpt-dir", str(tmp_path)])
    trainer, cfg = train_mod.build(args)
    assert cfg.gradientflow.wire_format == "int8"
    assert trainer.gf.wire_spec.dtype == torch.int8
    _, losses, _, run = train_mod.train(args)
    assert run["restarts"] == 0 and run["preempted"] is None
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert sorted(os.listdir(tmp_path)) == ["step_1"]
    # Windows are ported (tests/test_torch_window.py).
    assert train_mod.parse_args(argv + ["--window-steps", "2"]) \
        .window_steps == 2
    assert train_mod.parse_args(argv + ["--ckpt-dir", "ckpt"]).ckpt_every \
        == 50


def test_resolve_algorithm():
    from repro_torch.parallel import cost_model
    from repro_torch.parallel import topology as topo

    one = topo.Topology.flat("data", 8)
    two = topo.Topology((topo.Level("pod", 2, cost_model.NCCL_56G),
                         topo.Level("data", 4, cost_model.INTRA_NODE)))
    assert topo.resolve_algorithm("flat", two) is topo.FLAT
    assert topo.resolve_algorithm("auto", None) is topo.FLAT
    assert topo.resolve_algorithm("auto", one) is topo.FLAT
    # Since the topology layer was ported, every registered name resolves
    # and 'auto' prices the candidates on a multi-level topology.
    assert topo.resolve_algorithm("two_level", one) is topo.TWO_LEVEL
    assert topo.resolve_algorithm("tree", one) is topo.TREE
    assert topo.resolve_algorithm("pallas_ring", one) is topo.PALLAS_RING
    assert topo.resolve_algorithm("auto", two, 64e6) is \
        topo.select_algorithm(64e6, two)[0]
    with pytest.raises(ValueError, match="unknown"):
        topo.resolve_algorithm("ringg", one)


_WORKER = textwrap.dedent("""
    import sys
    import numpy as np, torch, torch.distributed as dist
    sys.path[:0] = [{tests!r}, {src!r}]
    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    optimizer = sys.argv[4]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{{port}}",
                            world_size=2, rank=rank)
    from repro_torch.core import lazy_allreduce
    from test_torch_trainer import shard_run
    x = np.random.default_rng(rank).standard_normal(1000)
    pool = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    parts = lazy_allreduce.bucketed_reduce_parts(
        pool, [(0, 300), (300, 1000)], None)
    mean = (torch.cat(parts) / 2).numpy()
    from repro_torch.parallel import collectives
    assert collectives.data_world_size() == 2
    assert collectives.reduce_pool(torch.ones(3)).tolist() == [2.0] * 3
    losses, final = shard_run(rank, 2, optimizer)
    np.savez(out, mean=mean, losses=np.asarray(losses), **final)
    dist.destroy_process_group()
""")


def shard_run(rank, world, optimizer="momentum_sgd"):
    """This rank's share of a lazy-mode run on a global batch of
    ``world * B`` rows; ``world=1`` is the single-process reference.
    Returns (losses, {leaf name: final values})."""
    cfg = _cfg(t_base, get_smoke, "lazy", "float32", True, batch=world * B,
               optimizer=optimizer)
    init = convert.params_to_numpy(
        build_model(cfg.model).init_params(1, "cpu"))
    shards = [{k: v[rank * B:(rank + 1) * B] for k, v in b.items()}
              for b in _batches(STEPS, batch=2 * B)] if world > 1 \
        else _batches(STEPS, batch=2 * B)
    losses, final = _torch_run(cfg, init, shards)
    return losses, dict(_leaves(final))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("optimizer", ["momentum_sgd", "lars"])
def test_two_rank_gloo_reduce_and_step(tmp_path, optimizer):
    """Two ranks reduce the bf16 pool and train; LARS's ratios come from
    the post-reduce mean, so its ranks also end bit for bit equal."""
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(
        tests=os.path.dirname(os.path.abspath(__file__)), src=SRC))
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), port,
                               str(tmp_path / f"rank{r}.npz"), optimizer],
                              env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
    r0, r1 = (np.load(tmp_path / f"rank{r}.npz") for r in range(2))
    # The bf16 all-reduce mean against numpy: the sum of two bf16 values
    # rounds once to bf16 (2^-8 relative), then halves exactly.
    bf = [torch.from_numpy(np.random.default_rng(r).standard_normal(1000)
                           .astype(np.float32)).to(torch.bfloat16).float()
          .numpy() for r in range(2)]
    np.testing.assert_allclose(r0["mean"], (bf[0] + bf[1]) / 2,
                               rtol=2 ** -8, atol=1e-6)
    np.testing.assert_array_equal(r0["mean"], r1["mean"])
    # Both ranks end with identical parameters, equal (up to f32 sum
    # order) to one process training on the whole batch; the logged loss
    # is the mean over ranks.
    losses, final = shard_run(0, 1, optimizer)
    np.testing.assert_array_equal(r0["losses"], r1["losses"])
    np.testing.assert_allclose(r0["losses"], losses, rtol=1e-5)
    for name, want in final.items():
        np.testing.assert_array_equal(r0[name], r1[name])
        np.testing.assert_allclose(r0[name], want, rtol=1e-5, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("schedule", ["constant", "warmup_linear",
                                      "warmup_cosine"])
def test_lr_schedule_matches_jax(schedule):
    from repro.optim.schedules import lr_at as j_lr_at
    from repro_torch.optim import lr_at

    kw = dict(learning_rate=0.2, warmup_steps=3, total_steps=11,
              schedule=schedule)
    j_cfg, t_cfg = j_base.OptimizerConfig(**kw), t_base.OptimizerConfig(**kw)
    got = [float(lr_at(t_cfg, s)) for s in range(13)]
    want = [float(j_lr_at(j_cfg, s)) for s in range(13)]
    # Both compute in f32; the cosine may differ in its last ulp.
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_synthetic_stream_is_shard_invariant():
    from repro_torch.data.synthetic import SyntheticLM

    data = SyntheticLM(256, seed=3)
    full = data.batch_numpy(5, 4, 16)
    half = data.batch_numpy(5, 2, 16, shard=1)
    np.testing.assert_array_equal(half["tokens"], full["tokens"][2:])
    np.testing.assert_array_equal(full["labels"][:, :-1],
                                  full["tokens"][:, 1:])
    assert full["tokens"].max() < 256
    assert not np.array_equal(data.batch_numpy(6, 4, 16)["tokens"],
                              full["tokens"])


def test_entry_points_need_a_device_without_cuda():
    """Without a CUDA card an entry point runs only when asked for the
    CPU; it never falls back on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = _cfg(t_base, get_smoke, "lazy", "bfloat16", True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.params_from_numpy({"w": np.zeros(2, np.float32)})
    assert Trainer(cfg, device="cpu").device.type == "cpu"
