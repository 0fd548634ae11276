"""Simulated multi-host soak: fault-injected churn with overlap-aware
replan, the JAX package's ``repro/runtime/soak.py`` in the port.

The paper's 1.5-minute ImageNet run needs 512 GPUs in lockstep for the
whole job; at that scale stragglers, preemption notices and hard node
failures are the norm. This harness drives the control plane
(``StragglerDetector`` -> ``ElasticController`` -> checkpoint/reshard ->
``GradientFlow.replan``) through a few hundred simulated steps with a
deterministic, seeded fault schedule, on a modelled 64-node x 8-GPU
cluster. The cluster is not there: step times come from the overlap
engine's analytic timeline (``engine.simulate_plan``).

What the harness checks after every remesh or preemption:

  event -> blocking checkpoint (``TrainSupervisor``'s Preempted path)
        -> evict hosts, ``ElasticController.propose`` a smaller mesh
        -> ``reshard.plan`` feasibility of the candidate's data degree
        -> ``GradientFlow.replan(topology)``: theta re-tuned, per-bucket
           algorithms re-selected, StepPlan cache invalidated
        -> the active plan's ``plan_key`` matches the new topology,
           ``plan.validate()`` holds, and the staged finish still beats
           the monolithic barrier on the smaller mesh
        -> per-shard hg re-split column-total-preserving
           (``reshard.reshard_hg``), batch re-split, detector reset.

Beside the simulated control plane the soak steps a real-numeric guard
lane (``runtime.faults.GuardLane``): guarded engine steps on one rank
against one injected fault of each data-plane class (NaN gradient,
forced overflow, bit-flipped wire segment), in the lazy and the CSC
mode, recording the verdict, the bit identity of the skip and the loss
scale in the trace's ``guard`` section. The lane runs on ``device`` (the
first CUDA card unless given): on the card it launches the pack, the
update, the census and the gather kernels, on the CPU their plain
versions.

Everything the trace records is cost-model arithmetic (floats rounded to
9 places), integers, booleans or power-of-two loss scales, so a seeded
schedule gives the same trace on any machine, and the JAX package's
trace for the same config and schedule.

Departures from the JAX package, none of which reaches the trace:

* The stand-in train state is CPU tensors, and the port's
  ``CheckpointManager`` restores into them in place. Its ``hg`` leaf is
  named ``hg``, not ``gf/hg``, so the manager saves it whole, as an
  ordinary leaf, at every data degree.
* The feasibility check is ``checkpoint.reshard.plan`` on the
  candidate's data degree, with the leaf named ``gf/hg`` as the manager
  names its row leaves; JAX checks ``P('data', None)`` on an abstract
  candidate mesh, the same divisibility condition.
* The port's supervisor writes a step once: a preemption at a step the
  cadence just saved waits for that save instead of writing it again.
  The restored step and state are the same.

Entry points: ``SoakHarness(cfg, ckpt_dir).run()`` and
``python -m repro_torch.launch.dryrun --soak`` (the per-event table).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.checkpoint import reshard
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import GradientFlowConfig
from repro_torch.configs.shapes import ALEXNET_GRAD_SHAPES
from repro_torch.core import engine
from repro_torch.core.gradientflow import GradientFlow
from repro_torch.core.pool import GradientPool
from repro_torch.parallel.cost_model import INTRA_NODE, NCCL_56G
from repro_torch.parallel.topology import Topology
from repro_torch.runtime.elastic import ElasticController, MeshCandidate
from repro_torch.runtime.fault_tolerance import (Preempted, SupervisorConfig,
                                                 TrainSupervisor)
from repro_torch.runtime.stragglers import StragglerDetector


def _rnd(x: float) -> float:
    return round(float(x), 9)


class RemeshSignal(Preempted):
    """Raised from the step function when the detector escalates to
    'remesh'. A ``Preempted``, so ``TrainSupervisor`` takes its
    blocking-checkpoint-then-reraise path: a remesh is a planned exit,
    not a failure, and burns no restart."""

    def __init__(self, hosts: Sequence[int]):
        super().__init__(f"straggler remesh: evict hosts {list(hosts)}")
        self.hosts = list(hosts)


@dataclasses.dataclass(frozen=True)
class SoakEvent:
    """One scheduled fault. ``kind``: 'straggler' (host slows down by
    ``factor`` until evicted), 'preempt' (preemption notice for ``host``),
    'fail' (hard failure: raises at ``step``, consumes a restart)."""

    step: int
    kind: str
    host: int
    factor: float = 1.0


@dataclasses.dataclass(frozen=True)
class SoakConfig:
    num_hosts: int = 64            # 64 nodes x 8 GPUs = the paper's 512
    gpus_per_node: int = 8
    model_parallel: int = 2        # data degree 4 per node
    global_batch: int = 16128      # 2^8*3^2*7: rich divisor set for churn
    num_steps: int = 300
    checkpoint_every: int = 25
    max_restarts: int = 4
    seed: int = 0
    hg_cols: int = 128             # simulated per-shard state width
    mode: str = "lazy"
    wire_dtype: str = "float16"
    # Detector policy: escalate quickly enough that a step-60 straggler
    # remeshes within ~10 steps.
    alpha: float = 0.3
    threshold: float = 1.5
    patience: int = 3
    remesh_after: int = 8
    jitter: float = 0.02           # +/- fractional per-host step noise
    # The numeric guard lane's steps (runtime.faults.GuardLane), one
    # fault of each data-plane class; 0 disables the lane.
    guard_steps: int = 24


def default_schedule(cfg: SoakConfig) -> Tuple[SoakEvent, ...]:
    """Two hard failures (the restart path), one persistent straggler
    (a detector-escalated remesh), one preemption notice; both elastic
    events shrink the mesh (256 -> 252 -> 224 data shards at the default
    global batch)."""
    s = cfg.num_steps
    return (
        SoakEvent(step=int(s * 0.13), kind="fail", host=7),
        SoakEvent(step=int(s * 0.20), kind="straggler", host=12,
                  factor=4.0),
        SoakEvent(step=int(s * 0.50), kind="preempt", host=3),
        SoakEvent(step=int(s * 0.70), kind="fail", host=1),
    )


def default_numeric_faults(num_steps: int) -> Tuple:
    """One data-plane fault a class, early enough that the trailing clean
    streak outlasts the lane's growth interval (the trace then shows the
    backoff and the regrowth)."""
    from repro_torch.runtime.faults import FaultEvent
    q = max(1, num_steps // 6)
    return (FaultEvent(step=q, kind="nan", offset=8, width=4),
            FaultEvent(step=2 * q, kind="overflow", offset=40, width=4),
            FaultEvent(step=3 * q, kind="bitflip", offset=100, width=6))


class SoakHarness:
    """Drives ``TrainSupervisor`` through the seeded fault schedule and
    checks the replan contract after every elastic event. ``run()``
    returns the trace dict (see the module docstring). ``device`` is the
    guard lane's (the first CUDA card unless given); the control plane
    runs on the host."""

    def __init__(self, cfg: SoakConfig, ckpt_dir: str,
                 schedule: Optional[Sequence[SoakEvent]] = None,
                 device: Optional[Union[str, torch.device]] = None):
        assert cfg.gpus_per_node % cfg.model_parallel == 0, cfg
        self.cfg = cfg
        self.device = device
        self.schedule = tuple(schedule if schedule is not None
                              else default_schedule(cfg))
        self.hosts: List[int] = list(range(cfg.num_hosts))
        self.slow: Dict[int, float] = {}      # node id -> slowdown factor
        self._consumed: set = set()
        self._pending_leave: Optional[int] = None
        self._last_fail: Optional[SoakEvent] = None
        self.rng = np.random.default_rng(cfg.seed)

        self.elastic = ElasticController(model_parallel=cfg.model_parallel,
                                         global_batch=cfg.global_batch)
        self.detector = StragglerDetector(
            len(self.hosts), alpha=cfg.alpha, threshold=cfg.threshold,
            patience=cfg.patience, remesh_after=cfg.remesh_after)
        self.ckpt = CheckpointManager(ckpt_dir, keep=3)
        self.sup = TrainSupervisor(self.ckpt, SupervisorConfig(
            checkpoint_every=cfg.checkpoint_every,
            max_restarts=cfg.max_restarts))

        cand = self.elastic.propose(len(self.hosts) * cfg.gpus_per_node)
        assert cand is not None, "initial cluster must be viable"
        self.num_data = cand.num_devices // cfg.model_parallel
        self.topo = self._topology_for(self.num_data)
        self.pool = GradientPool({f"t{i}": tuple(s) for i, s in
                                  enumerate(ALEXNET_GRAD_SHAPES)})
        self.gf = GradientFlow(
            GradientFlowConfig(mode=cfg.mode, wire_dtype=cfg.wire_dtype,
                               warmup_steps=0, auto_bucket=True,
                               topology=self.topo,
                               reduce_axes=self.topo.axes,
                               collective_algo="auto", overlap="staged"),
            self.pool, num_data_shards=self.num_data)
        self._base_step_s = self._predicted_step_s()
        self.events: List[Dict] = []
        self._last_event_step = 0

    # -- modelled cluster ----------------------------------------------------

    def _topology_for(self, data_total: int) -> Topology:
        """Data-reduction topology of a candidate mesh: two levels (the
        inter-node 56G ring over an intra-node level) when the data
        shards fill whole nodes, else one flat inter-node level: a change
        of level structure the replan must absorb."""
        per_node = self.cfg.gpus_per_node // self.cfg.model_parallel
        if per_node > 1 and data_total % per_node == 0:
            return Topology.from_axis_sizes(
                ("node", "gpu"), (data_total // per_node, per_node),
                fabrics=(NCCL_56G, INTRA_NODE))
        return Topology.from_axis_sizes(("data",), (data_total,),
                                        fabrics=(NCCL_56G,))

    def _predicted_step_s(self) -> float:
        return float(engine.simulate_plan(self.gf.plan(), self.topo)
                     ["summary"]["finish_s"])

    def _init_state(self) -> Dict:
        # A small stand-in train state: a replicated vector, the
        # per-data-shard hg rows (the one leaf whose shape follows the
        # mesh: what reshard_hg redistributes) and the step counter.
        return {"x": torch.zeros((4,), dtype=torch.float32),
                "hg": torch.zeros((self.num_data, self.cfg.hg_cols),
                                  dtype=torch.float32),
                "step_val": torch.tensor(0, dtype=torch.int32)}

    # -- supervisor hooks ----------------------------------------------------

    def _fault_injector(self, step: int) -> None:
        for ev in self.schedule:
            if ev.step != step or ev in self._consumed:
                continue
            if ev.kind == "straggler":
                self._consumed.add(ev)
                self.slow[ev.host] = ev.factor
            elif ev.kind == "preempt":
                self._consumed.add(ev)
                self._pending_leave = ev.host
                self.sup.request_preemption()
            elif ev.kind == "fail":
                self._consumed.add(ev)
                self._last_fail = ev
                raise RuntimeError(
                    f"injected hard failure on host {ev.host} @ {step}")
            else:
                raise ValueError(f"unknown event kind {ev.kind!r}")

    def _host_step_times(self, step: int) -> List[float]:
        # Integer draws only: PCG64's raw stream is stable across
        # platforms and numpy versions, unlike its float distributions, so
        # the detector's decisions (and the trace) are too.
        j = self.rng.integers(0, 1001, size=len(self.hosts))
        out = []
        for node, ji in zip(self.hosts, j):
            noise = 1.0 + self.cfg.jitter * (ji / 1000.0 - 0.5) * 2.0
            out.append(self._base_step_s * noise
                       * self.slow.get(node, 1.0))
        return out

    def _step_fn(self, step: int, state: Dict) -> Dict:
        rep = self.detector.observe(self._host_step_times(step))
        if rep.action == "remesh":
            # Detector indices are positions: map them back to node ids.
            raise RemeshSignal([self.hosts[i] for i in rep.slow_hosts])
        if rep.action == "rebatch" and not any(
                e.get("kind") == "rebatch_advisory"
                and e.get("episode_start", -1) == self._last_event_step
                for e in self.events):
            self.events.append({
                "kind": "rebatch_advisory", "step": int(step),
                "episode_start": int(self._last_event_step),
                "slow_hosts": [int(self.hosts[i]) for i in rep.slow_hosts],
                "lr_rescale": _rnd(rep.lr_rescale)})
        hg = state["hg"].clone()
        hg[:, step % self.cfg.hg_cols] += 1.0 / hg.shape[0]
        return {"x": state["x"] + 1.0, "hg": hg,
                "step_val": torch.tensor(step + 1, dtype=torch.int32)}

    def _on_restore(self, step: int) -> None:
        ev = self._last_fail
        self.events.append({
            "kind": "hard_failure",
            "step": int(ev.step) if ev else int(step),
            "host": int(ev.host) if ev else -1,
            "restored_to_step": int(step),
            "restarts_consumed": int(self.sup.restarts),
            "mesh_changed": False,
            "plan_key_after": repr(self.gf.plan_cache_key())})
        self._last_fail = None

    # -- the elastic transition ----------------------------------------------

    def _elastic_event(self, kind: str, leaving: List[int],
                       ev_step: int) -> Optional[MeshCandidate]:
        """Evict ``leaving``, propose and check the new mesh, replan, and
        record the before/after trace entry. Returns the accepted
        candidate, or None when no viable mesh remains (abort)."""
        cfg = self.cfg
        plan_before = self.gf.plan()
        key_before = plan_before.plan_key
        sim_before = engine.simulate_plan(plan_before, self.topo)
        wire_before = self.gf.wire_bytes_per_step()
        old_data = self.num_data

        for h in leaving:
            self.hosts.remove(h)
            self.slow.pop(h, None)
        cand = self.elastic.propose(len(self.hosts) * cfg.gpus_per_node)
        if cand is None:
            self.events.append({
                "kind": kind, "step": int(ev_step),
                "hosts_evicted": [int(h) for h in leaving],
                "aborted": "no viable mesh"})
            return None
        new_data = cand.num_devices // cfg.model_parallel
        new_topo = self._topology_for(new_data)

        # Feasibility before bytes move: the hg rows must split over the
        # candidate's data degree (the manager's row-leaf name, so the
        # check applies to it).
        problems = reshard.plan([("x", (4,)),
                                 ("gf/hg", (new_data, cfg.hg_cols))],
                                new_data)
        assert problems == [], problems

        # The replan contract: a fresh key, a valid partition, and the
        # staged pipeline still ahead of the monolithic barrier.
        self.gf.replan(new_topo, num_data_shards=new_data)
        self.topo = new_topo
        plan_after = self.gf.plan()
        plan_after.validate()
        assert plan_after.plan_key == self.gf.plan_cache_key()
        assert plan_after.plan_key != key_before, (
            "elastic event did not invalidate the StepPlan", key_before)
        sim_after = engine.simulate_plan(plan_after, new_topo)
        staged = float(sim_after["summary"]["finish_s"])
        mono = float(sim_after["monolithic_finish_s"])
        assert staged <= mono + 1e-12, (staged, mono)
        self._base_step_s = staged

        self.detector.reset(len(self.hosts))
        old_ps, new_ps = reshard.reshard_batch_split(
            cfg.global_batch, old_data, new_data)
        self.events.append({
            "kind": kind, "step": int(ev_step),
            "hosts_evicted": [int(h) for h in leaving],
            "healthy_hosts": len(self.hosts),
            "steps_survived": int(ev_step - self._last_event_step),
            "restarts_consumed": int(self.sup.restarts),
            "mesh_before": [old_data, cfg.model_parallel],
            "mesh_after": list(cand.shape),
            "devices_before": old_data * cfg.model_parallel,
            "devices_after": cand.num_devices,
            "data_shards_before": old_data,
            "data_shards_after": new_data,
            "per_shard_batch_before": old_ps,
            "per_shard_batch_after": new_ps,
            "topology_after": [[lv.axis, lv.size]
                               for lv in new_topo.levels],
            "mesh_changed": True, "replanned": True, "plan_valid": True,
            "plan_key_before": repr(key_before),
            "plan_key_after": repr(plan_after.plan_key),
            "theta_after": int(self.gf.bucket_elems),
            "num_buckets_before": len(plan_before.tasks),
            "num_buckets_after": len(plan_after.tasks),
            "algos_after": [t.algo.name for t in plan_after.tasks],
            "wire_bytes_before": int(wire_before),
            "wire_bytes_after": int(self.gf.wire_bytes_per_step()),
            "predicted_step_before_s":
                _rnd(sim_before["summary"]["finish_s"]),
            "predicted_step_after_s": _rnd(staged),
            "monolithic_after_s": _rnd(mono),
            "staged_beats_monolithic": bool(staged <= mono + 1e-12)})
        self._last_event_step = ev_step
        self.num_data = new_data
        return cand

    def _reshard_state(self, state: Dict) -> Dict:
        old = state["hg"].numpy()
        new_hg = reshard.reshard_hg(old, self.num_data)
        # Column-total conservation is the reshard's correctness contract.
        np.testing.assert_allclose(new_hg.sum(axis=0), old.sum(axis=0),
                                   rtol=1e-5)
        return {"x": state["x"],
                "hg": torch.from_numpy(new_hg.astype(np.float32)),
                "step_val": state["step_val"]}

    # -- the soak loop -------------------------------------------------------

    def run(self) -> Dict:
        cfg = self.cfg
        state = self._init_state()
        step = 0
        aborted = None
        while step < cfg.num_steps:
            try:
                state = self.sup.run(state, step, cfg.num_steps,
                                     self._step_fn,
                                     on_restore=self._on_restore,
                                     fault_injector=self._fault_injector)
                step = cfg.num_steps
            except (RemeshSignal, Preempted) as e:
                if isinstance(e, RemeshSignal):
                    kind, leaving = "straggler_remesh", e.hosts
                else:
                    kind = "preemption"
                    leaving = [self._pending_leave]
                    self._pending_leave = None
                self.sup.clear_preemption()
                # The supervisor saved a blocking checkpoint (old mesh
                # shape) before re-raising: resume from it.
                ev_step, state = self.ckpt.restore(state)
                if self._elastic_event(kind, leaving, ev_step) is None:
                    aborted = f"{kind}: no viable mesh"
                    break
                state = self._reshard_state(state)
                # Checkpoint the re-split state at the same step, so a
                # later hard failure restores arrays of the new shape.
                self.ckpt.save(ev_step, state, blocking=True)
                step = ev_step
            except RuntimeError as e:
                aborted = f"restart budget exhausted: {e}"
                break
        completed = int(state["step_val"]) if aborted is None else step
        kinds = sorted({e["kind"] for e in self.events})
        guard_section = self._guard_lane() if cfg.guard_steps else None
        trace = {
            "config": {f.name: getattr(cfg, f.name)
                       for f in dataclasses.fields(cfg)},
            "schedule": [dataclasses.asdict(e) for e in self.schedule],
            "events": self.events,
            "final": {
                "completed_steps": completed,
                "aborted": aborted,
                "restarts_consumed": int(self.sup.restarts),
                "restart_causes": list(self.sup.restart_causes),
                "final_hosts": len(self.hosts),
                "final_data_shards": int(self.num_data),
                "final_plan_key": repr(self.gf.plan_cache_key()),
                "final_predicted_step_s": _rnd(self._base_step_s),
                "elastic_events": sum(1 for e in self.events
                                      if e.get("mesh_changed")),
                "event_kinds": kinds,
            },
        }
        if guard_section is not None:
            trace["guard"] = guard_section
        return trace

    def _guard_lane(self) -> Dict:
        """The numeric lane: guarded steps on one rank under the default
        fault schedule, in the lazy and the CSC mode, on ``device``. Its
        records are ints, bools and power-of-two floats only, so the
        trace stays machine-independent."""
        from repro_torch.runtime.faults import GuardLane, truth_table
        faults = default_numeric_faults(self.cfg.guard_steps)
        section: Dict = {
            "steps": int(self.cfg.guard_steps),
            "faults": [dataclasses.asdict(f) for f in faults],
        }
        for mode in ("lazy", "csc"):
            records = GuardLane(mode=mode, device=self.device).run(
                self.cfg.guard_steps, faults)
            section[mode] = {"records": records,
                             "truth_table": truth_table(records)}
        return section


def render_trace(trace: Dict) -> str:
    """The per-event soak table (``dryrun --soak``)."""
    ms = 1e3
    cfg = trace["config"]
    lines = [
        f"soak: {cfg['num_hosts']} hosts x {cfg['gpus_per_node']} GPUs "
        f"(mp={cfg['model_parallel']}), {cfg['num_steps']} steps, "
        f"seed {cfg['seed']}",
        f"{'step':>5} {'event':>18} {'mesh':>10} {'theta':>9} "
        f"{'step_ms':>16} {'wire_MiB':>9}",
    ]
    for e in trace["events"]:
        if e.get("mesh_changed"):
            mesh = "x".join(str(s) for s in e["mesh_after"])
            lines.append(
                f"{e['step']:>5} {e['kind']:>18} {mesh:>10} "
                f"{e['theta_after']:>9} "
                f"{e['predicted_step_before_s'] * ms:>7.2f}"
                f"->{e['predicted_step_after_s'] * ms:<7.2f} "
                f"{e['wire_bytes_after'] / 2**20:>9.1f}")
        elif e["kind"] == "hard_failure":
            lines.append(
                f"{e['step']:>5} {e['kind']:>18} {'-':>10} {'-':>9} "
                f"restored to {e['restored_to_step']} "
                f"(restart {e['restarts_consumed']})")
        else:
            lines.append(
                f"{e['step']:>5} {e['kind']:>18} {'-':>10} {'-':>9} "
                f"lr_rescale {e.get('lr_rescale', 1.0)}")
    f = trace["final"]
    lines.append(
        f"final: {f['completed_steps']} steps, "
        f"{f['elastic_events']} elastic events, "
        f"{f['restarts_consumed']} restarts, "
        f"{f['final_hosts']} hosts, {f['final_data_shards']} data shards, "
        f"step {f['final_predicted_step_s'] * ms:.2f} ms"
        + (f" | ABORTED: {f['aborted']}" if f["aborted"] else ""))
    g = trace.get("guard")
    if g:
        for mode in ("lazy", "csc"):
            tt = g[mode]["truth_table"]
            caught = sum(r["caught"] for r in tt["classes"].values())
            inj = sum(r["injected"] for r in tt["classes"].values())
            scales = sorted({r["scale"] for r in g[mode]["records"]})
            lines.append(
                f"guard[{mode}]: {caught}/{inj} faults caught "
                f"({', '.join(sorted(tt['classes']))}), "
                f"{tt['false_trips']} false trips / "
                f"{tt['clean_steps']} clean steps, "
                f"scales {scales}")
    return "\n".join(lines)
