"""The port's CSC mode against the JAX package's, on the CPU: the two
CSC kernels' plain versions (against the Pallas kernels in interpret
mode), chunk selection with ties, the warm-up schedule, one monolithic
CSC reduction, the CSC Trainer over dense warm-up and sparse stages, a
2-rank gloo run, and the CLI's default mode. Inputs are made with numpy
from a seed and handed to both packages. The CUDA kernels run only on the
card: ``test_torch_cuda.py`` holds them against their plain versions
there."""
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

from repro.configs import base as j_base
from repro.configs import get_smoke as j_get_smoke
from repro.core import csc as j_csc
from repro.core import schedule as j_schedule
from repro.core.pool import GradientPool as JPool
from repro.kernels import chunk_l1norm as j_cl
from repro.kernels import csc_compact as j_cc
from repro.kernels import ref as j_ref
from repro.launch.mesh import make_host_mesh, make_mesh
from repro.launch.trainer import Trainer as JTrainer
from repro.parallel.collectives import compat_set_mesh, compat_shard_map
from repro_torch import convert
from repro_torch.configs import base as t_base
from repro_torch.configs import get_smoke
from repro_torch.core import csc as t_csc
from repro_torch.core import schedule as t_schedule
from repro_torch.core.pool import GradientPool, flatten_tree
from repro_torch.kernels import chunk_l1norm as t_cl
from repro_torch.kernels import csc_compact as t_cc
from repro_torch.kernels import ops
from repro_torch.kernels import ref as t_ref
from repro_torch.launch.trainer import Trainer

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pool(seed, n, dtype, zero_chunks=(), chunk=1):
    """A pool in both frameworks (same values), some chunks all zero."""
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    for c in zero_chunks:
        x[c * chunk:(c + 1) * chunk] = 0.0
    return jnp.asarray(x, DTYPES[dtype][0]), \
        torch.from_numpy(x).to(DTYPES[dtype][1])


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


# -- the kernels' plain versions -------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk,num_chunks", [(256, 24), (1024, 5)])
def test_chunk_l1norm_matches_jax(dtype, chunk, num_chunks):
    jp, tp = _pool(0, chunk * num_chunks, dtype, zero_chunks=(2,),
                   chunk=chunk)
    want_k = j_cl.chunk_l1norm(jp, chunk, interpret=True)
    want_r = j_ref.chunk_l1norm(jp, chunk)
    for got in (t_ref.chunk_l1norm(tp, chunk), t_cl.plain(tp, chunk),
                ops.chunk_l1norm(tp, chunk)):
        assert got.dtype == torch.float32 and got.shape == (num_chunks,)
        # The same |x| summed in another order: f32 rounding only.
        np.testing.assert_allclose(_np(got), _np(want_k), rtol=1e-6)
        np.testing.assert_allclose(_np(got), _np(want_r), rtol=1e-6)
    assert _np(got)[2] == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_csc_compact_matches_jax(dtype):
    chunk, num_chunks = 128, 40
    jp, tp = _pool(1, chunk * num_chunks, dtype)
    idx = np.sort(np.random.default_rng(2).choice(num_chunks, 13,
                                                  replace=False))
    want_k = j_cc.csc_compact(jp, jnp.asarray(idx, jnp.int32), chunk,
                              interpret=True)
    want_r = j_ref.csc_compact(jp, jnp.asarray(idx, jnp.int32), chunk)
    t_idx = torch.from_numpy(idx)  # int64, as select_chunks makes them
    for got in (t_ref.csc_compact(tp, t_idx, chunk),
                t_cc.plain(tp, t_idx, chunk),
                ops.csc_compact(tp, t_idx, chunk),
                t_csc.compact_chunks(tp, t_idx, chunk)):
        assert got.dtype == DTYPES[dtype][1]
        # Pure data movement: bit for bit.
        np.testing.assert_array_equal(_np(got), _np(want_k))
        np.testing.assert_array_equal(_np(got), _np(want_r))


def test_dispatch_counts_and_kernel_wrappers_on_cpu():
    """CPU tensors take the plain versions (counted as such); the kernel
    wrappers refuse CPU tensors rather than fall back."""
    _, tp = _pool(3, 4 * 64, "float32")
    idx = torch.tensor([0, 2])
    ops.reset_counts()
    ops.chunk_l1norm(tp, 64)
    ops.csc_compact(tp, idx, 64)
    assert ops.dispatch_counts == {"chunk_l1norm.plain": 1,
                                   "csc_compact.plain": 1}
    with pytest.raises(ValueError, match="runs on CUDA"):
        t_cl.launch(tp, 64)
    with pytest.raises(ValueError, match="runs on CUDA"):
        t_cc.launch(tp, idx, 64)


# -- selection, schedule, wire buckets ---------------------------------------


@pytest.mark.parametrize("norms,k", [
    ([0, 3, 1, 3, 0, 0, 2, 3, 0], 6),   # ties at 3 and at 0
    ([0, 0, 0, 0, 0, 0], 2),            # all zero: the lowest ids win
    ([1, 1, 2, 2, 1, 1, 2, 2], 3),
    (list(np.random.default_rng(4).integers(0, 4, 64)), 17),
])
def test_select_chunks_matches_jax(norms, k):
    norms = np.asarray(norms, np.float32)
    j_idx, j_mask = j_csc.select_chunks(jnp.asarray(norms), k)
    t_idx, t_mask = t_csc.select_chunks(torch.from_numpy(norms), k)
    assert t_idx.tolist() == np.asarray(j_idx).tolist()
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    if k == 6 and len(norms) == 9:
        assert t_idx.tolist() == [0, 1, 2, 3, 6, 7]


def test_schedule_matches_jax():
    """build_stages, stage_at, snap_stages_to_window, window_schedule,
    num_selected_chunks and wire_bucket_boundaries over a grid."""
    def fields(stages):
        return [dataclasses.astuple(s) for s in stages]

    for mode in ("csc", "lazy"):
        for sparsity in (0.0, 0.5, 0.85, 0.999):
            for warmup_steps in (0, 1, 5, 20):
                for stages_n in (1, 2, 4):
                    kw = dict(mode=mode, sparsity=sparsity,
                              warmup_steps=warmup_steps,
                              warmup_stages=stages_n)
                    for c in (1, 7, 313, 4106):
                        js = j_schedule.build_stages(
                            j_base.GradientFlowConfig(**kw), c)
                        ts = t_schedule.build_stages(
                            t_base.GradientFlowConfig(**kw), c)
                        assert fields(ts) == fields(js)
                    for window in (1, 3, 8):
                        jw = j_schedule.snap_stages_to_window(js, window)
                        tw = t_schedule.snap_stages_to_window(ts, window)
                        assert fields(tw) == fields(jw)
                        assert [(a, b, dataclasses.astuple(s)) for a, b, s in
                                t_schedule.window_schedule(1, 30, window,
                                                           tw)] == \
                            [(a, b, dataclasses.astuple(s)) for a, b, s in
                             j_schedule.window_schedule(1, 30, window, jw)]
                    firsts = t_schedule.stage_first_steps(ts)
                    for step in range(25):
                        assert dataclasses.astuple(
                            t_schedule.stage_at(ts, step, firsts)) == \
                            dataclasses.astuple(j_schedule.stage_at(js, step))
    for sparsity in np.linspace(0, 1, 41):
        for c in (1, 2, 313, 4106):
            assert t_schedule.num_selected_chunks(sparsity, c) == \
                j_schedule.num_selected_chunks(sparsity, c)
    for k in (1, 127, 128, 129, 616, 3233):
        for chunk in (1024, 32768):
            for theta in (0, 8192, 4_194_304, 1 << 40):
                assert t_csc.wire_bucket_boundaries(k, chunk, theta) == \
                    j_csc.wire_bucket_boundaries(k, chunk, theta)
    # The smollm-135m steady stage of chip_smoke: k = 616, 5 buckets.
    assert len(t_csc.wire_bucket_boundaries(616, 32768, 4_194_304)) == 5


# -- one monolithic reduction -------------------------------------------------


def _j_csc_reduce(pool_grads, hg, norms, cfg, k):
    """JAX's csc_reduce inside a size-1 data mesh (psum = identity)."""
    from jax.sharding import PartitionSpec as P

    mesh = make_mesh((1,), ("data",))

    def f(g, hg, norms):
        res = j_csc.csc_reduce(
            g, j_csc.CSCState(hg=hg, chunk_norms=norms), cfg,
            num_selected=k, bucket_boundaries=j_csc.wire_bucket_boundaries(
                k, cfg.chunk_elems, cfg.bucket_elems), num_data_shards=1)
        return res.grads, res.elem_mask, res.state.hg, res.state.chunk_norms

    sm = compat_shard_map(f, mesh=mesh, in_specs=(P(None),) * 3,
                          out_specs=(P(None),) * 4, axis_names={"data"})
    with compat_set_mesh(mesh):
        return jax.jit(sm)(pool_grads, hg, norms)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_csc_reduce_matches_jax(use_kernels):
    chunk, num_chunks, k = 64, 24, 7
    kw = dict(mode="csc", chunk_elems=chunk, bucket_elems=192, sparsity=0.7,
              momentum=0.9, wire_dtype="float32")
    rng = np.random.default_rng(5)
    g = rng.standard_normal(chunk * num_chunks).astype(np.float32)
    hg = rng.standard_normal(chunk * num_chunks).astype(np.float32) * 0.1
    norms = rng.integers(0, 5, num_chunks).astype(np.float32)  # with ties
    want = _j_csc_reduce(jnp.asarray(g), jnp.asarray(hg), jnp.asarray(norms),
                         j_base.GradientFlowConfig(**kw), k)
    cfg = t_base.GradientFlowConfig(use_kernels=use_kernels, **kw)
    res = t_csc.csc_reduce(
        torch.from_numpy(g), t_csc.CSCState(torch.from_numpy(hg),
                                            torch.from_numpy(norms)),
        cfg, num_selected=k, bucket_boundaries=t_csc.wire_bucket_boundaries(
            k, chunk, cfg.bucket_elems), num_data_shards=1)
    np.testing.assert_array_equal(res.elem_mask.numpy(), np.asarray(want[1]))
    for got, ref, name in ((res.grads, want[0], "grads"),
                           (res.state.hg, want[2], "hg"),
                           (res.state.chunk_norms, want[3], "norms")):
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-6,
                                   err_msg=name)


def test_update_on_leafless_span_matches_jax():
    """The padded pool's last update span holds no leaf: the update only
    moves the momentum there (masked), as the JAX optimizer does."""
    from repro.configs.base import OptimizerConfig as JOpt
    from repro.optim import sgd as j_sgd
    from repro_torch.optim import sgd as t_sgd

    shapes = {"a": (3, 7), "b": (40,)}
    tp = GradientPool(shapes, pad_to=64)
    jp = JPool({"a": jnp.zeros((3, 7)), "b": jnp.zeros((40,))}, pad_to=64)
    start, end = tp.unpadded_size, tp.size
    tv, jv = tp.bucket_view(start, end), jp.bucket_view(start, end)
    assert tv.num_tensors == 0 and tv.sizes == () and tv.padding == end - start
    rng = np.random.default_rng(6)
    master, grads, mom = (rng.standard_normal(end - start).astype(np.float32)
                          for _ in range(3))
    mask = np.arange(end - start) < 2  # one selected chunk edge
    kw = dict(momentum=0.9, weight_decay=1e-4)
    j_leaves, j_state = j_sgd.update_view(
        jv, jnp.asarray(master), jnp.asarray(grads),
        j_sgd.SGDState(jnp.asarray(mom)), jnp.asarray(mask), JOpt(**kw),
        jnp.float32(0.05))
    mom_buf = torch.from_numpy(mom.copy())
    t_leaves, t_state = t_sgd.update_view(
        tv, torch.from_numpy(master), torch.from_numpy(grads),
        t_sgd.SGDState(mom_buf), torch.from_numpy(mask),
        t_base.OptimizerConfig(**kw), torch.tensor(0.05), use_kernels=True,
        out_leaves=[])
    assert t_leaves == [] and list(j_leaves) == []
    assert t_state.momentum is mom_buf
    np.testing.assert_allclose(t_state.momentum.numpy(),
                               np.asarray(j_state.momentum), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(t_state.momentum.numpy()[~mask], mom[~mask])


# -- the Trainer ---------------------------------------------------------------

B, S, STEPS = 2, 32, 5
CHUNK, THETA = 1024, 8192


def _cfg(base, get_smoke_fn, wire, use_kernels=False, batch=B, steps=STEPS,
         **gf):
    model = dataclasses.replace(get_smoke_fn("smollm-135m")[0],
                                compute_dtype="float32")
    gf = dict(dict(chunk_elems=CHUNK, sparsity=0.5, warmup_steps=2,
                   warmup_stages=2), **gf)
    return base.TrainConfig(
        model=model,
        gradientflow=base.GradientFlowConfig(
            mode="csc", bucket_elems=THETA, wire_dtype=wire,
            use_kernels=use_kernels, **gf),
        optimizer=base.OptimizerConfig(
            name="momentum_sgd", learning_rate=0.1, momentum=0.9,
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
def _jax_run(wire):
    """The JAX Trainer in CSC mode, each step under the stage
    ``stage_for_step`` picks: (initial params, per-step (k, selected
    ids), losses, final params, hg row 0, final chunk norms)."""
    trainer = JTrainer(_cfg(j_base, j_get_smoke, wire), make_host_mesh(),
                       j_get_smoke("smollm-135m")[1])
    fns = {}
    with compat_set_mesh(trainer.mesh):
        state = trainer.init_state(jax.random.PRNGKey(0))
        init = jax.tree_util.tree_map(np.array, state.params)
        picks, losses = [], []
        for i, b in enumerate(_batches(STEPS)):
            stage = trainer.gf.stage_for_step(i)
            idx, _ = j_csc.select_chunks(state.gf.chunk_norms,
                                         stage.num_selected)
            picks.append((stage.num_selected, np.array(idx).tolist()))
            if stage.index not in fns:
                fns[stage.index] = trainer.build_train_step(stage)
            jb = jax.device_put({k: jnp.asarray(v, jnp.int32)
                                 for k, v in b.items()})
            state, metrics = fns[stage.index](state, jb)
            losses.append(float(metrics["loss"]))
        final = jax.tree_util.tree_map(np.array, state.params)
        hg = np.array(state.gf.hg)[0]
        norms = np.array(state.gf.chunk_norms)
    return init, picks, losses, final, hg, norms


def _torch_run(cfg, init, batches):
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(params=convert.params_from_numpy(init, "cpu"))
    fns = {}
    picks, losses = [], []
    for i, b in enumerate(batches):
        stage = trainer.gf.stage_for_step(i)
        idx, _ = t_csc.select_chunks(state.gf.chunk_norms,
                                     stage.num_selected)
        picks.append((stage.num_selected, idx.tolist()))
        if stage.index not in fns:
            fns[stage.index] = trainer.build_train_step(stage)
        state, metrics = fns[stage.index](state, {
            k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(metrics["loss"]))
    return (trainer, picks, losses, convert.params_to_numpy(state.params),
            state.gf.hg.numpy(), state.gf.chunk_norms.numpy())


def _leaves(tree):
    return [(("/".join(p)), np.asarray(v)) for p, v in flatten_tree(tree)]


# f32 wire: the frameworks' f32 matmuls differ in the last bits, so rtol
# 1e-5 (atol 1e-6 for values near zero), as for the lazy Trainer. bf16
# wire: a last-ulp f32 difference can flip the bf16 rounding of a few
# wire elements, so only the loss stream is held at rtol 1e-5 there.
@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_csc_trainer_matches_jax(wire):
    init, j_picks, j_losses, j_final, j_hg, j_norms = _jax_run(wire)
    ops.reset_counts()
    trainer, t_picks, t_losses, t_final, t_hg, t_norms = _torch_run(
        _cfg(t_base, get_smoke, wire, use_kernels=True), init,
        _batches(STEPS))
    # Dense warm-up (k = all 313 chunks), then the two sparse stages.
    assert [k for k, _ in t_picks] == [313, 235, 156, 156, 156]
    for step, (a, b) in enumerate(zip(t_picks, j_picks)):
        assert a == b, f"step {step}: the chunk selection differs"
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    # Only the plain versions ran (CPU tensors), each where the path
    # needs it: 2 packs, one update per span and one census a step, one
    # gather a sparse step.
    spans = len(trainer.pool.bucket_boundaries(THETA))
    assert ops.dispatch_counts == {
        "pool_pack.plain": 2 * STEPS,
        "pool_unpack_update.plain": spans * STEPS,
        "chunk_l1norm.plain": STEPS, "csc_compact.plain": STEPS - 1}
    if wire == "float32":
        tol = dict(rtol=1e-5, atol=1e-6)
        for (name, a), (_, b) in zip(_leaves(t_final), _leaves(j_final)):
            np.testing.assert_allclose(a, b, err_msg=name, **tol)
        np.testing.assert_allclose(t_hg, j_hg, err_msg="hg", **tol)
        np.testing.assert_allclose(t_norms, j_norms, rtol=1e-5,
                                   err_msg="chunk_norms")


def test_csc_trainer_without_kernels_matches_with():
    """use_kernels=False takes the plain functions directly and gives the
    same bits as the dispatch layer's plain path."""
    init = convert.params_to_numpy(
        Trainer(_cfg(t_base, get_smoke, "float32"), device="cpu")
        .model.init_params(2, "cpu"))
    runs = [_torch_run(_cfg(t_base, get_smoke, "float32", use_kernels=uk),
                       init, _batches(4, seed=1)) for uk in (False, True)]
    (_, pa, la, fa, ha, na), (_, pb, lb, fb, hb, nb) = runs
    assert pa == pb and la == lb
    np.testing.assert_array_equal(ha, hb)
    np.testing.assert_array_equal(na, nb)
    for (name, a), (_, b) in zip(_leaves(fa), _leaves(fb)):
        np.testing.assert_array_equal(a, b, err_msg=name)


# -- two ranks over gloo -------------------------------------------------------

_WORKER = textwrap.dedent("""
    import sys
    import numpy as np, torch.distributed as dist
    sys.path[:0] = [{tests!r}, {src!r}]
    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{{port}}",
                            world_size=2, rank=rank)
    from test_torch_csc import csc_shard_run
    picks, losses, final, hg, norms = csc_shard_run(rank, 2)
    np.savez(out, losses=np.asarray(losses), hg=hg, norms=norms,
             picks=np.asarray([i for _, ids in picks for i in ids]),
             **final)
    dist.destroy_process_group()
""")

GLOO_STEPS = 3


def csc_shard_run(rank, world):
    """This rank's share of a CSC run (dense warm-up, then two sparse
    steps at k = 156 of 313) on a global batch of ``world * B`` rows."""
    cfg = _cfg(t_base, get_smoke, "float32", use_kernels=True,
               batch=world * B, steps=GLOO_STEPS, warmup_steps=1,
               warmup_stages=1)
    init = convert.params_to_numpy(
        Trainer(cfg, device="cpu").model.init_params(1, "cpu"))
    shards = [{k: v[rank * B:(rank + 1) * B] for k, v in b.items()}
              for b in _batches(GLOO_STEPS, batch=world * B)]
    _, picks, losses, final, hg, norms = _torch_run(cfg, init, shards)
    return picks, losses, dict(_leaves(final)), hg, norms


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_rank_gloo_csc(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(
        tests=os.path.dirname(os.path.abspath(__file__)), src=SRC))
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), port,
                               str(tmp_path / f"rank{r}.npz")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
    r0, r1 = (np.load(tmp_path / f"rank{r}.npz") for r in range(2))
    # Both ranks selected the same chunks (from the summed census), hold
    # the same summed norms and the same parameters, and log the mean
    # loss; each keeps its own unsent gradients in hg.
    assert len(r0["picks"]) == 313 + 2 * 156
    np.testing.assert_array_equal(r0["picks"], r1["picks"])
    np.testing.assert_array_equal(r0["norms"], r1["norms"])
    np.testing.assert_array_equal(r0["losses"], r1["losses"])
    names = [n for n in r0.files
             if n not in ("losses", "hg", "norms", "picks")]
    assert len(names) >= 10
    for name in names:
        np.testing.assert_array_equal(r0[name], r1[name], err_msg=name)
    assert np.abs(r0["hg"]).sum() > 0 and not np.array_equal(r0["hg"],
                                                               r1["hg"])


# -- the CLI -------------------------------------------------------------------


def test_cli_defaults_to_csc(capsys):
    from repro_torch.launch import train as train_mod

    argv = ["--arch", "smollm-135m", "--reduced", "--steps", "9", "--batch",
            "4", "--seq-len", "64", "--use-kernels", "--device", "cpu"]
    args = train_mod.parse_args(argv)
    assert (args.gf_mode, args.sparsity, args.chunk_elems, args.csc_warmup,
            args.window_steps) == ("csc", 0.85, 2048, 20, 8)
    ops.reset_counts()
    losses = train_mod.main(argv)
    out = capsys.readouterr().out
    assert len(losses) == 9 and all(np.isfinite(losses))
    # The warm-up stages (first steps 0, 5, 10, 15, 20) snap to the
    # window grid of 8: steps 0-7 are the dense warm-up stage; stages 1
    # and 2 both snap to step 8, where stage 2 opens (stage 1 never runs).
    assert "step     0 stage 0 sparsity 0.00" in out
    assert "step     8 stage 2 sparsity 0.42" in out
    assert ops.dispatch_counts["csc_compact.plain"] == 1
    assert ops.dispatch_counts["chunk_l1norm.plain"] == 9
