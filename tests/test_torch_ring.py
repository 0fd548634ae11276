"""The port's owned ring (``collective_algo="pallas_ring"``) against the
JAX package, on the CPU.

* The in-process twin ``ref.ring_allreduce_ranks`` equals the JAX ring
  twin (``repro.kernels.ref.ring_allreduce`` inside a shard_map over N
  placeholder CPU devices) bit for bit on every rank, for N in {2, 4, 8},
  f32/bf16/int8/fp8-e4m3 wires, and aligned, ragged and smaller-than-N
  sizes: the two run the same schedule in the same order.
* ``ring_segment_bounds`` and ``plan``'s analytic fields equal JAX's.
* A pure-Python model of the kernel's per-lane schedule (rounds of G
  sub-tiles, S slots, full and credit counters, with G and S read from
  ``ring_reduce``) runs every rank to completion for N in {2, 4, 8} under
  lock-step and random interleavings, in place, across launches, and
  gives the plain ring's sums; with G = S it deadlocks.
* Every word a wire can carry is a fixed point of ``requant . to_f``,
  the premise of the kernel's forwarding raw bits in the all-gather.
* Over 2 and 4 gloo ranks the process-group twin (``ref.ring_allreduce``,
  also reached through the registry and ``ops``) equals the in-process
  twin bit for bit.
* The Trainer with ``collective_algo="pallas_ring"`` over 2 gloo ranks,
  lazy and CSC: an f32 wire gives the ``flat`` run's losses and
  parameters bit for bit (at N = 2 the ring's one f32 add is the
  all-reduce's); a bf16 wire leaves both ranks with the same bits after
  every step; at world size 1 the ring is the identity.

Inputs are made from seeds with numpy. The bucketed and CSC ring runs are
held against the flat run, not against the JAX ring inside those paths
(three JAX tests on those paths are red; see ROADMAP C).
"""
import os
import socket
import subprocess
import sys
import textwrap

import ml_dtypes
import numpy as np
import pytest
import torch

from conftest import run_multi_device
from repro.kernels import ring_reduce as j_ring
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ring_reduce as t_ring
from repro_torch.parallel import topology as t_topo

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
TESTS = os.path.dirname(os.path.abspath(__file__))

# (x dtype, wire dtype) pairs: the wire-cast bucket of the pool pipeline
# (x in the wire dtype), an f32 bucket on a bf16 wire, and the quantized
# wires' words.
WIRES = (("float32", "float32"), ("bfloat16", "bfloat16"),
         ("float32", "bfloat16"), ("int8", "int8"),
         ("float8_e4m3fn", "float8_e4m3fn"))
_NP = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16,
       "int8": np.int8, "float8_e4m3fn": ml_dtypes.float8_e4m3fn}
_BITS = {"float32": np.uint32, "bfloat16": np.uint16, "int8": np.uint8,
         "float8_e4m3fn": np.uint8}


def sizes_for(n):
    """Aligned, ragged and smaller-than-N per-rank sizes."""
    return (n * 37, n * 5 + 3, max(n - 3, 1))


def ring_inputs(n, size, x_name, seed):
    """N ranks' inputs as one numpy array of the x dtype. int8 words stay
    within qmax/N (127 // N), as the JAX wire format clips them, so every
    partial sum is on the grid; fp8 words within ±40, so no partial sum
    of 8 ranks leaves the format's range."""
    rng = np.random.default_rng(seed)
    if x_name == "int8":
        q = 127 // n
        return rng.integers(-q, q + 1, n * size).astype(np.int8)
    if x_name == "float8_e4m3fn":
        return rng.uniform(-40, 40, n * size).astype(ml_dtypes.float8_e4m3fn)
    return rng.standard_normal(n * size).astype(np.float32).astype(
        _NP[x_name])


def to_torch(a, name):
    """A numpy array of ``name`` -> torch tensor of the same bits."""
    dt = getattr(torch, name)
    if name in ("bfloat16",):
        return torch.from_numpy(a.view(np.int16).copy()).view(dt)
    if name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(dt)
    return torch.from_numpy(a.copy())


def bits(t):
    """Raw bytes of a tensor, for bit-for-bit comparison."""
    return t.contiguous().view(torch.uint8).numpy()


# -- in-process twin against the JAX twin ---------------------------------------

_JAX_BODY = """
    from repro.kernels import ref
    import ml_dtypes
    data = np.load({path!r})
    mesh = compat_make_mesh((N,), ("data",))
    out = {{}}
    for key in data.files:
        x_name, wire = key.split("|")[1:3]
        wire = jnp.dtype(getattr(ml_dtypes, wire, None) or wire)
        x = jnp.asarray(data[key].view(getattr(ml_dtypes, x_name, None)
                                       or x_name))
        f = lambda v, wire=wire: ref.ring_allreduce(v, "data",
                                                    wire_dtype=wire)
        sm = compat_shard_map(f, mesh=mesh, in_specs=P("data"),
                              out_specs=P("data"), axis_names={{"data"}},
                              check_vma=False)
        with compat_set_mesh(mesh):
            out[key] = np.asarray(jax.jit(sm)(x)).view(np.uint8)
    np.savez({out!r}, **out)
    print("OK", len(out))
"""


@pytest.mark.parametrize("n", [2, 4, 8])
def test_ring_twin_matches_jax_bitwise(n, tmp_path):
    cases = {}
    for i, size in enumerate(sizes_for(n)):
        for j, (x_name, wire) in enumerate(WIRES):
            cases[f"{size}|{x_name}|{wire}"] = ring_inputs(
                n, size, x_name, seed=100 * i + j)
    path, out = str(tmp_path / "in.npz"), str(tmp_path / "out.npz")
    np.savez(path, **{k: a.view(_BITS[k.split("|")[1]])
                      for k, a in cases.items()})
    run_multi_device(_JAX_BODY.format(path=path, out=out), devices=n,
                     timeout=600)
    want = np.load(out)
    for key, a in cases.items():
        size_s, x_name, wire = key.split("|")
        size = int(size_s)
        x = to_torch(a, x_name)
        xs = [x[r * size:(r + 1) * size] for r in range(n)]
        got = ref.ring_allreduce_ranks(xs, getattr(torch, wire))
        jax_ranks = want[key].reshape(n, -1)
        for r in range(n):
            assert got[r].dtype == xs[r].dtype
            np.testing.assert_array_equal(bits(got[r]), jax_ranks[r],
                                          err_msg=f"{key} rank {r}")
            np.testing.assert_array_equal(bits(got[r]), bits(got[0]))


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("wire", ["float32", "bfloat16", "int8",
                                  "float8_e4m3fn"])
def test_ring_plan_matches_jax(n, wire):
    """The segmentation and the analytic fields equal the JAX plan's at
    the port kernel's sub-tile (the tile is the Hopper kernel's own)."""
    jwire = getattr(ml_dtypes, wire, None) or wire
    for size in sizes_for(n) + (4_194_304, 134_515_008, 0):
        assert t_ring.ring_segment_bounds(size, n) == \
            j_ring.ring_segment_bounds(size, n)
        tp = t_ring.plan(size, n, wire)
        jp = j_ring.plan(size, n, jwire, tile_elems=tp["tile_elems"])
        for field in ("segment_bounds", "seg_elems", "padded_elems",
                      "exchange_steps", "tiles_per_segment", "tile_elems",
                      "wire_bytes_per_step", "total_wire_bytes"):
            assert tp[field] == jp[field], (field, size)
        assert tp["lanes"] <= t_ring.max_lanes(n)
        assert tp["seg_elems"] % (tp["lanes"] * t_ring.LANE_ELEMS) == 0
        # The kernel keeps no accumulator in device memory: its footprint
        # is the workspace, S slots of every lane, run in rounds of G.
        assert "acc_bytes" not in tp
        assert (tp["slots"], tp["round_tiles"]) == (t_ring.SLOTS,
                                                    t_ring.ROUND_TILES)
        assert tp["rounds"] == -(-tp["tiles_per_segment"] //
                                 t_ring.ROUND_TILES)
        assert tp["workspace_bytes"] >= (t_ring.SLOTS * t_ring.max_lanes(n)
                                         * t_ring.LANE_ELEMS * 4)
    # The default segmentation of the twin is JAX's ceil(n/N).
    assert ref.ring_seg_elems(1000, 8) == 125


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("x_name,wire", WIRES)
def test_ring_bound_counts_only_the_function(n, x_name, wire):
    """The bytes bound of one rank's ring: x read and the output written
    once, and each of the 2(N-1) steps' wire segments written and read
    once (the ceil(n/N) segment); nothing for the kernel's own f32
    accumulator. At N = 2 on a bf16 wire that is 8 B an element."""
    x_dt, w_dt = getattr(torch, x_name), getattr(torch, wire)
    xb, wb = (torch.empty((), dtype=d).element_size() for d in (x_dt, w_dt))
    for size in sizes_for(n) + (134_515_008,):
        seg = max(e - s for s, e in t_ring.ring_segment_bounds(size, n))
        assert t_ring.bound_bytes(size, n, w_dt, x_dt) == \
            2 * size * xb + 2 * (n - 1) * 2 * seg * wb, size
        assert t_ring.bound_bytes(size, 1, w_dt, x_dt) == 0
        assert t_ring.bound_bytes(0, n, w_dt, x_dt) == 0
    if n == 2 and x_name == wire == "bfloat16":
        assert t_ring.bound_bytes(1000, 2, w_dt, x_dt) == 8 * 1000


def test_ring_twin_fp8_overflow_follows_torch():
    """Past ±448 the fp8 wire follows PyTorch's own conversion (newer
    builds saturate to ±448, older ones give NaN; ml_dtypes, under JAX,
    gives NaN above 464): at N = 2 the ring's result is the wire rounding
    of the f32 sum."""
    a = torch.tensor([300.0, 448.0, -448.0, 200.0, 240.0, 1.5, -0.001])
    b = torch.tensor([200.0, 448.0, -30.0, 264.0, 240.0, 2.25, 0.002])
    fa, fb = a.to(torch.float8_e4m3fn), b.to(torch.float8_e4m3fn)
    got = ref.ring_allreduce_ranks([fa, fb])
    want = (fa.float() + fb.float()).to(torch.float8_e4m3fn)
    assert bits(got[0]).tolist() == bits(want).tolist()
    assert bits(got[1]).tolist() == bits(want).tolist()
    sat = t_ring.fp8_saturates()
    assert (got[0].float()[0].item() == 448.0) == sat
    assert torch.isnan(got[0].float()[0]).item() == (not sat)


def test_ring_with_seg_of_the_kernel_is_a_ring():
    """The kernel's tile-padded segment changes which rank starts each
    element's sum, not the sum: at N = 4 the padded twin is within f32
    rounding of the flat sum and the same on every rank."""
    xs = [torch.from_numpy(np.random.default_rng(r).standard_normal(5000)
                           .astype(np.float32)) for r in range(4)]
    seg = t_ring.plan(5000, 4, "float32")["seg_elems"]
    assert seg == t_ring.LANE_ELEMS
    got = ref.ring_allreduce_ranks(xs, seg_elems=seg)
    torch.testing.assert_close(got[0], sum(xs), rtol=1e-6, atol=1e-6)
    assert all(torch.equal(g, got[0]) for g in got)


def test_world_size_one_ring_is_identity():
    """One rank: the ring returns its input (``ring_reduce.py:319`` and
    ``ref.py:205`` in the JAX package) and launches nothing."""
    x = torch.arange(7.0)
    ops.reset_counts()
    out, work = t_topo.get_algorithm("pallas_ring").reduce(x.clone())
    assert work is None and torch.equal(out, x)
    assert ops.dispatch_counts == {}
    assert ref.ring_allreduce_ranks([x])[0] is x


# -- the kernel's per-lane schedule, modelled ----------------------------------


class _Blocked(Exception):
    pass


def _lane_program(d, n, tiles, g_max, slots, mem, pos0):
    """Rank d's lane of ``ring_kernel`` (csrc/ring_reduce.cu) as a
    generator: it yields a condition ``(flag list, rank, least value)`` it
    must wait for, and otherwise reads and writes ``mem`` as the kernel
    does. One value stands for a sub-tile; the wire is exact (small
    integers), so ``requant`` is the identity. x and out are one buffer
    (``mem["buf"][d][segment][sub-tile]``: the kernel run in place).
    Returns the lane's sequence number after the launch."""
    right, left = (d + 1) % n, (d - 1) % n
    steps = 2 * (n - 1)
    buf, slot, full, credit = (mem["buf"][d], mem["slots"], mem["full"],
                               mem["credit"])

    def put(q, value):
        # The slot's previous sub-tile must have been drained.
        prev = slot[right][q % slots]
        assert prev is None or credit[d] >= prev[0] + 1, (d, q, prev)
        slot[right][q % slots] = (q, value)

    def get(p):
        seq, value = slot[d][p % slots]
        assert seq == p, (d, p, seq)
        return value

    pos = pos0
    for j0 in range(0, tiles, g_max):
        g = min(g_max, tiles - j0)
        last = pos + g - 1
        if last >= slots:
            yield (credit, d, last - slots + 1)
        for i in range(g):
            put(pos + i, buf[d][j0 + i])
        full[right] = pos + g
        for t in range(steps):
            rs, send = t < n - 1, t < steps - 1
            s = (d - t - 1) % n if rs else (d - (t - (n - 1))) % n
            p0 = pos + t * g          # this step's receives p0 .. p0+g-1
            q0 = p0 + g               # the sends they feed
            xv = [buf[s][j0 + i] if rs else None  # read before the wait
                  for i in range(g)]
            yield (full, d, p0 + g)
            if send and q0 + g > slots:
                yield (credit, d, q0 + g - slots)
            for i in range(g):
                w = get(p0 + i)
                if rs:
                    w = xv[i] + w
                if send:
                    put(q0 + i, w)
                if t >= n - 2:
                    buf[s][j0 + i] = w
            if send:
                full[right] = q0 + g
            credit[left] = p0 + g
        pos += steps * g
    return pos


def _run_lanes(n, tiles, g_max, slots, xs, order, seqs, rng=None):
    """Runs the N lanes' programs of one launch, interleaved lock-step
    ("lockstep": each rank one operation a turn) or at random ("random"),
    over flags and slots that carry over between launches (``seqs``: the
    lanes' sequence words, updated). Returns the buffers (the results);
    raises _Blocked when no rank can move."""
    mem = {"buf": [[list(row) for row in x] for x in xs],
           "slots": seqs["slots"], "full": seqs["full"],
           "credit": seqs["credit"]}
    progs = [_lane_program(d, n, tiles, g_max, slots, mem, seqs["seq"][d])
             for d in range(n)]
    waiting = [None] * n
    done = [False] * n

    def step(d):
        """One operation of rank d; False if it is blocked."""
        cond = waiting[d]
        if cond is not None:
            flags, r, want = cond
            if flags[r] < want:
                return False
        try:
            waiting[d] = next(progs[d])
        except StopIteration as stop:
            done[d] = True
            seqs["seq"][d] = stop.value
        return True

    while not all(done):
        live = [d for d in range(n) if not done[d]]
        if order == "random":
            rng.shuffle(live)
            moved = False
            for d in live:
                if step(d):
                    moved = True
                    break
        else:
            moved = False
            for d in live:
                moved |= step(d)
        if not moved:
            raise _Blocked(waiting)
    return mem["buf"]


def _fresh_lanes(n, slots):
    return {"seq": [0] * n, "full": [0] * n, "credit": [0] * n,
            "slots": [[None] * slots for _ in range(n)]}


@pytest.mark.parametrize("n", [2, 4, 8])
def test_ring_lane_schedule_model(n):
    """The kernel's lane schedule with the kernel's S and G: no deadlock
    and the plain ring's sums on every rank, in place, for sub-tile
    counts below, at and past one round and ragged, over several launches
    that carry the flags and sequence words over."""
    g, s = t_ring.ROUND_TILES, t_ring.SLOTS
    assert 1 <= g and 2 * g <= s
    rng = np.random.default_rng(n)
    for order in ("lockstep", "random"):
        seqs = _fresh_lanes(n, s)
        for tiles in (1, g - 1 or 1, g, g + 1, 2 * g + 3, 3 * g):
            xs = [rng.integers(-50, 50, (n, tiles)).tolist()
                  for _ in range(n)]
            got = _run_lanes(n, tiles, g, s, xs, order, seqs, rng)
            want = np.sum(np.asarray(xs), axis=0)
            plain = ref.ring_allreduce_ranks(
                [torch.tensor(x, dtype=torch.float32).reshape(-1)
                 for x in xs])
            assert np.array_equal(plain[0].numpy().reshape(n, tiles), want)
            for d in range(n):
                assert np.array_equal(np.asarray(got[d]), want), (order,
                                                                  tiles, d)
            assert seqs["seq"] == [seqs["seq"][0]] * n


def test_ring_lane_schedule_model_needs_round_below_slots():
    """The model sees a deadlock: with 2G > S every rank's first fused
    step waits for a credit its right neighbour can only give after its
    own such step; with 2G = S, the kernel's ratio, it completes."""
    s = t_ring.SLOTS
    assert s % 2 == 0
    xs = [[[1] * s, [2] * s] for _ in range(2)]
    with pytest.raises(_Blocked):
        _run_lanes(2, s, s // 2 + 1, s, xs, "lockstep", _fresh_lanes(2, s))
    got = _run_lanes(2, s, s // 2, s, xs, "lockstep", _fresh_lanes(2, s))
    assert got[0] == got[1] == [[2] * s, [4] * s]


@pytest.mark.parametrize("wire", ["bfloat16", "int8", "float8_e4m3fn"])
def test_requant_fixes_every_wire_word(wire):
    """``requant(to_f(w)) == w`` for every word w the wire can carry, so
    forwarding a received word's bits equals re-quantising its value. The
    carried words are requant's image: every int8 and fp8-e4m3 word (the
    fp8 NaNs 0x7f and 0xff keep their sign), and every bf16 word that is
    not a NaN plus the one NaN word the conversion in use makes (c10's
    scalar rounding and the kernel make 0x7FC0; a vectorised conversion
    may make another)."""
    dt = getattr(torch, wire)
    n_bits = torch.empty((), dtype=dt).element_size() * 8
    bits_dt = torch.int16 if n_bits == 16 else torch.int8
    words = torch.arange(-2 ** (n_bits - 1), 2 ** (n_bits - 1),
                         dtype=torch.int32).to(bits_dt)
    vals = words.view(dt).to(torch.float32)
    nans = torch.tensor([float("nan"), -float("nan")])
    image = torch.unique(torch.cat([
        ref.requant(vals, dt).view(bits_dt),
        ref.requant(nans, dt).view(bits_dt)]))
    finite = words[~torch.isnan(vals)]
    made_nans = image[torch.isnan(image.view(dt).to(torch.float32))]
    assert torch.equal(torch.unique(torch.cat([finite, made_nans])), image)
    if wire == "bfloat16":
        assert made_nans.numel() == 1
    else:
        assert image.numel() == 2 ** n_bits
    back = ref.requant(image.view(dt).to(torch.float32), dt)
    assert torch.equal(back.view(bits_dt), image)


# -- gloo subprocesses -----------------------------------------------------------


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(tmp_path, body, world, timeout=300):
    """Run ``body`` in ``world`` gloo ranks (subprocesses); each rank has
    ``rank``, ``world``, ``out`` (its .npz path) and a default group.
    Returns the ranks' saved arrays."""
    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent("""
        import sys
        import numpy as np, torch, torch.distributed as dist
        sys.path[:0] = [{tests!r}, {src!r}]
        rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4])
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{{port}}",
            world_size=world, rank=rank)
    """).format(tests=TESTS, src=SRC) + textwrap.dedent(body) +
        "\ndist.destroy_process_group()\n")
    port = str(free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r),
                               str(world), port,
                               str(tmp_path / f"rank{r}.npz")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    errs = []
    for p in procs:
        _, err = p.communicate(timeout=timeout)
        errs.append((p.returncode, err))
    for rc, err in errs:
        assert rc == 0, err[-3000:]
    return [np.load(tmp_path / f"rank{r}.npz") for r in range(world)]


_PG_BODY = """
    from test_torch_ring import WIRES, ring_inputs, sizes_for, to_torch
    from repro_torch.kernels import ops, ref
    from repro_torch.parallel import collectives, topology
    lg = collectives.level_groups(None).levels[0]
    assert (lg.size, lg.index) == (world, rank)
    saved = {}
    for i, size in enumerate(sizes_for(world)):
        for j, (x_name, wire) in enumerate(WIRES):
            a = ring_inputs(world, size, x_name, seed=100 * i + j)
            x = to_torch(a, x_name)[rank * size:(rank + 1) * size]
            w = getattr(torch, wire)
            key = f"{size}|{x_name}|{wire}"
            saved[key] = ref.ring_allreduce(x, lg, w).view(
                torch.uint8).numpy()
            if x_name == wire:
                ops.reset_counts()
                got, work = topology.get_algorithm("pallas_ring").reduce(
                    x.clone())
                assert work is None
                assert ops.dispatch_counts == {"ring_allreduce.plain": 1}
                saved["registry|" + key] = got.view(torch.uint8).numpy()
    np.savez(out, **saved)
"""


@pytest.mark.parametrize("world", [2, 4])
def test_process_group_twin_matches_in_process_twin(world, tmp_path):
    ranks = spawn_ranks(tmp_path, _PG_BODY, world)
    for i, size in enumerate(sizes_for(world)):
        for j, (x_name, wire) in enumerate(WIRES):
            x = to_torch(ring_inputs(world, size, x_name, 100 * i + j),
                         x_name)
            want = ref.ring_allreduce_ranks(
                [x[r * size:(r + 1) * size] for r in range(world)],
                getattr(torch, wire))
            key = f"{size}|{x_name}|{wire}"
            for r in range(world):
                np.testing.assert_array_equal(ranks[r][key], bits(want[r]),
                                              err_msg=f"{key} rank {r}")
                if x_name == wire:
                    np.testing.assert_array_equal(ranks[r]["registry|" + key],
                                                  bits(want[r]))


# -- the Trainer through the ring --------------------------------------------------

_TRAIN_BODY = """
    import dataclasses
    from test_torch_ring import ring_trainer_run
    saved = {}
    for mode in ("lazy", "csc"):
        for algo in ("flat", "pallas_ring"):
            for wire in ("float32", "bfloat16"):
                r = ring_trainer_run(mode, algo, wire, rank, world)
                for k, v in r.items():
                    saved[f"{mode}|{algo}|{wire}|{k}"] = v
    np.savez(out, **saved)
"""


def ring_trainer_run(mode, algo, wire, rank, world, steps=4):
    """This rank's run of the smoke-size Trainer on its own batch shard:
    the losses, the parameters after every step (one flat f32 array per
    step) and the dispatch counts of the run."""
    import dataclasses

    from repro_torch.configs import base, get_smoke
    from repro_torch.launch.trainer import Trainer

    model = dataclasses.replace(get_smoke("smollm-135m")[0],
                                compute_dtype="float32")
    gf = base.GradientFlowConfig(
        mode=mode, bucket_elems=8192, wire_dtype=wire, chunk_elems=1024,
        sparsity=0.5, warmup_steps=2, warmup_stages=2, use_kernels=True,
        collective_algo=algo)
    cfg = base.TrainConfig(
        model=model, gradientflow=gf, seq_len=16, global_batch=2 * world,
        attn_chunk=0,
        optimizer=base.OptimizerConfig(learning_rate=0.1, warmup_steps=2,
                                       total_steps=steps))
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(seed=1)
    rng = np.random.default_rng(7)
    ops.reset_counts()
    losses, params = [], []
    for s in range(steps):
        toks = rng.integers(0, 256, (2 * world, 17))[2 * rank:2 * rank + 2]
        batch = {"tokens": torch.from_numpy(toks[:, :-1]),
                 "labels": torch.from_numpy(toks[:, 1:])}
        step = trainer.build_train_step(trainer.gf.stage_for_step(s))
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        params.append(torch.cat([p.reshape(-1) for p in
                                 trainer.pool.flat_leaves(state.params)])
                      .numpy().copy())
    counts = dict(ops.dispatch_counts)
    collectives = sum(len(trainer.gf.plan(trainer.gf.stage_for_step(s))
                          .tasks) for s in range(steps))
    return {"losses": np.asarray(losses), "params": np.stack(params),
            "ring_plain": np.asarray(counts.get("ring_allreduce.plain", 0)),
            "ring_kernel": np.asarray(counts.get("ring_allreduce.kernel",
                                                 0)),
            "collectives": np.asarray(collectives)}


def test_trainer_pallas_ring_two_ranks(tmp_path):
    r0, r1 = spawn_ranks(tmp_path, _TRAIN_BODY, 2, timeout=600)
    for mode in ("lazy", "csc"):
        def get(rank, algo, wire, k):
            return rank[f"{mode}|{algo}|{wire}|{k}"]

        # Every bucket went through the ring's plain twin, none through a
        # kernel; the flat runs launched no ring.
        for rank in (r0, r1):
            for wire in ("float32", "bfloat16"):
                assert get(rank, "pallas_ring", wire, "ring_plain") == \
                    get(rank, "pallas_ring", wire, "collectives") > 0
                assert get(rank, "pallas_ring", wire, "ring_kernel") == 0
                assert get(rank, "flat", wire, "ring_plain") == 0
        # f32 wire: the ring equals the flat all-reduce bit for bit.
        for rank in (r0, r1):
            for k in ("losses", "params"):
                np.testing.assert_array_equal(
                    get(rank, "pallas_ring", "float32", k),
                    get(rank, "flat", "float32", k), err_msg=f"{mode} {k}")
        # bf16 wire: both ranks hold the same bits after every step, and
        # the run stays close to the flat one.
        for k in ("losses", "params"):
            np.testing.assert_array_equal(
                get(r0, "pallas_ring", "bfloat16", k),
                get(r1, "pallas_ring", "bfloat16", k), err_msg=f"{mode} {k}")
        np.testing.assert_allclose(get(r0, "pallas_ring", "bfloat16",
                                       "losses"),
                                   get(r0, "flat", "bfloat16", "losses"),
                                   rtol=1e-3)


@pytest.mark.parametrize("mode", ["lazy", "csc"])
def test_trainer_pallas_ring_world_one_is_flat(mode):
    """At world size 1 the ring is the identity, as the flat sum is."""
    ring = ring_trainer_run(mode, "pallas_ring", "bfloat16", 0, 1)
    flat = ring_trainer_run(mode, "flat", "bfloat16", 0, 1)
    np.testing.assert_array_equal(ring["losses"], flat["losses"])
    np.testing.assert_array_equal(ring["params"], flat["params"])
    assert ring["ring_plain"] == ring["ring_kernel"] == 0
