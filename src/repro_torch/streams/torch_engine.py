"""Seed-batched PyTorch twin of the JAX stream engine.

Counterpart of ``src/repro/streams/jax_engine.py`` (its ``"pallas"``
phase mode): a chaos sweep threads one `EngineState` of ``(S, ...)``
tensors — S failure seeds side by side — through a tick lowered from the
plan's `engine.CompactPhase` row tables, and each routing phase of the
tick runs as one `repro_torch.kernels.tick_phase` call: the hand-written
CUDA kernel for CUDA tensors, its plain PyTorch version for CPU tensors.

Pipeline (`run_batch`):

1. host lowering (`_Lowered`, numpy): routing plan, row tables, per-task
   failover leaves and inert drill / autoscale leaves — `_Lowered.arrays`
   has exactly the layout of the reference's ``_Lowered.arrays``;
2. host prep (`_Lowered.prepare`, numpy): one chaos timeline per seed,
   replayed draw-for-draw (`core.chaos.build_chaos_timeline`), plus the
   deterministic external-event curves — the reference's ``prepare``
   outputs, field for field;
3. `from_reference` moves params, state and per-tick event tensors onto
   the device once, packs the kernel tables of every routing phase and
   builds the row tables of the deterministic segment sums;
4. `run`: a Python loop over ticks (``lax.scan`` has no counterpart);
   every state leaf carries the leading seed axis, there is no vmap.

Determinism: every segment sum of the reference tick becomes a row-table
gather + sum (per-slot overflow, per-op backlog) or a scatter onto
indices that are unique within a phase (deposits, per-job emitted and
dropped, per-op qps), so no float atomics decide a result and a CUDA run
is bit-identical from run to run. The region max uses `scatter_reduce`
``amax``, whose result does not depend on order.

Everything is float64 (``ckpt_epoch`` int32), as the reference runs
under x64. The entry points (`TorchStreamEngine`, `run_batch`,
`chaos_sweep.sweep`) take ``device``: ``None`` means CUDA and raises
without a CUDA device; tests pass ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.chaos import (ChaosEngine, ChaosSpec, ChaosTimeline,
                                    brownout_curve, build_chaos_timeline,
                                    build_perjob_chaos_timeline,
                                    ckpt_age_curve, coordinator_gate_curve,
                                    mq_gate_curve, traffic_curve)
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.tick_phase import pack_phase_tables, tick_phase
from repro_torch.kernels.tick_phase.ref import row_sum
from repro_torch.streams.engine import (CheckpointConfig, JobSlice,
                                        PackedArena, _bucket, build_plan,
                                        inert_autoscale_leaves,
                                        inert_upgrade_leaves,
                                        lazy_ready_extra, lower_tensor_plan,
                                        per_task_failover)
from repro_torch.streams.graph import LogicalGraph, PhysicalGraph, expand

F64 = torch.float64
_XS_SEED_KEYS = ("kills", "bfac", "gate", "ckage", "rfac")


class EngineState(NamedTuple):
    """All mutable arena state of a seed batch; every leaf has a leading
    ``(S,)`` seed axis on the device (host prep builds the same tuple of
    unbatched numpy leaves per seed). Layout and meaning as in the
    reference's ``jax_engine.EngineState``: ``ckpt_epoch`` is int32, the
    other 18 leaves float64."""
    queue: torch.Tensor
    down_until: torch.Tensor
    speed: torch.Tensor
    ckpt_epoch: torch.Tensor
    emitted: torch.Tensor
    dropped: torch.Tensor
    up_until: torch.Tensor
    rb_t: torch.Tensor
    dacc: torch.Tensor
    rew: torch.Tensor
    lact: torch.Tensor
    dirp: torch.Tensor
    failcnt: torch.Tensor
    brk_until: torch.Tensor
    used: torch.Tensor
    flip_acc: torch.Tensor
    thrash_t: torch.Tensor
    nact: torch.Tensor
    rsec: torch.Tensor


# ----------------------------------------------------------------------
# device upload: reference-layout numpy → the tick's tensors
# ----------------------------------------------------------------------
def _segment_rows(seg_of, n_seg: int):
    """Row table of a segment map: row r lists the positions i with
    ``seg_of[i] == r`` in ascending order (pads: index 0, mask 0.0) —
    the deterministic replacement of ``segment_sum(x, seg_of)``."""
    seg_of = np.asarray(seg_of, np.int64)
    counts = np.bincount(seg_of, minlength=n_seg)
    L = _bucket(int(counts.max(initial=0))) or 1
    order = np.argsort(seg_of, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(len(seg_of)) - starts[seg_of[order]]
    idx = np.zeros((n_seg, L), np.int64)
    mask = np.zeros((n_seg, L))
    idx[seg_of[order], rank] = order
    mask[seg_of[order], rank] = 1.0
    return idx, mask


def _phase_to_device(eph: dict, qcap: np.ndarray, device) -> dict:
    """One phase's `CompactPhase` dict → tensors (int64 for torch
    indexing) plus its static sizes and, for a routing phase, the
    packed int32 kernel tables."""
    a = {k: np.asarray(v) for k, v in eph.items()}
    D = len(a["dst_task"])
    ph = {"consumes": bool(a["cons_mask"].any()), "D": D,
          "B": a["br_idx"].shape[0] - 1, "G": a["gr_idx"].shape[0] - 1,
          "has_e": len(a["e_jobs"]) > 0}
    for k in ("cons_mask", "q_mask", "e_mask", "dj_mask"):
        ph[k] = torch.as_tensor(a[k], dtype=F64, device=device)
    for k in ("q_idx", "q_ops", "e_idx", "e_jobs", "dj_idx", "dj_jobs",
              "slot_ops", "dst_task"):
        ph[k] = torch.as_tensor(a[k].astype(np.int64), device=device)
    if D:
        se_idx, se_mask = _segment_rows(a["slot_of_edge"],
                                        len(a["slot_ops"]))
        ph["se_idx"] = torch.as_tensor(se_idx, device=device)
        ph["se_mask"] = torch.as_tensor(se_mask, dtype=F64, device=device)
        ph["tables"] = pack_phase_tables(a, qcap, device)
    return ph


def from_reference(arrays: dict, state, xs: dict, device):
    """Move host-prepared params, state and per-tick event tensors onto
    ``device`` in the layout `run` takes.

    The inputs have the reference's layout — what the JAX package's
    ``_Lowered.arrays`` / ``_Lowered.prepare`` (or ``_prep_batch``)
    return as numpy, and what this package's own `_Lowered` returns — so
    the reference's exact inputs, drill and autoscale leaves included,
    can drive this package's tick. A single seed's state (``queue`` of
    shape ``(n_tasks,)``) and xs (``kills`` of shape ``(T, H)``) are
    lifted to a batch of one. Returns ``(pa, state, xs)``: array leaves
    become tensors, 0-d leaves become Python floats, ``pa["edges"]``
    holds one dict per phase with its packed kernel tables."""
    device = torch.device(device)
    pa: dict = {}
    for k, v in arrays.items():
        if k == "edges":
            continue
        v = np.asarray(v)
        if v.ndim == 0:
            pa[k] = float(v)
        elif v.dtype.kind in "iub":
            pa[k] = torch.as_tensor(v.astype(np.int64), device=device)
        else:
            pa[k] = torch.as_tensor(v, dtype=F64, device=device)
    qcap = np.asarray(arrays["qcap"], float)
    pa["edges"] = [_phase_to_device(e, qcap, device)
                   for e in arrays["edges"]]
    op_of_task = np.asarray(arrays["op_of_task"])
    n_ops = len(np.asarray(arrays["par_of_op"]))
    op_idx, op_mask = _segment_rows(op_of_task, n_ops)
    pa["op_idx"] = torch.as_tensor(op_idx, device=device)
    pa["op_mask"] = torch.as_tensor(op_mask, dtype=F64, device=device)
    pa["n_ops"] = n_ops
    pa["n_regions"] = int(np.max(arrays["task_region"])) + 1

    single = np.ndim(state.queue) == 1
    leaves = []
    for f in EngineState._fields:
        v = np.asarray(getattr(state, f))
        if single:
            v = v[None]
        dt = torch.int32 if f == "ckpt_epoch" else F64
        leaves.append(torch.as_tensor(v, dtype=dt, device=device))
    st = EngineState(*leaves)
    xd = {"t": np.asarray(xs["t"], float),
          "ckpt": np.asarray(xs["ckpt"]).astype(np.int64)}
    for k in _XS_SEED_KEYS:
        v = np.asarray(xs[k], float)
        xd[k] = torch.as_tensor(v[None] if single else v, dtype=F64,
                                device=device)
    return pa, st, xd


# ----------------------------------------------------------------------
# the seed-batched tick
# ----------------------------------------------------------------------
def _tick(pa: dict, state: EngineState, x: dict):
    """One tick for every seed: consumption and the routing phases
    (`_build_pallas_run`'s tick in the reference), then `_finish_tick`."""
    t = x["t"]
    q = state.queue
    S = q.shape[0]
    alive_f = ((state.down_until <= t) & (state.up_until <= t)).to(F64)
    # canary activation: upgrade wave done, rollback wave not yet begun
    act = pa["up_cmask"] * ((t >= pa["up_start"] + pa["up_down"])
                            & (t < state.rb_t[:, None] + pa["up_rstag"])
                            ).to(F64)
    free = torch.clamp(pa["qcap"] - q, min=0.0)
    shed_t = torch.where(t < state.brk_until, pa["as_shed"],
                         torch.ones_like(q))
    sel_t = (pa["sel"][pa["op_of_task"]] + act * pa["d_sel"]) * shed_t
    # the kernel's drop mask reads this per-tick row, so a canary
    # d_mode_s delta reaches it (the reference's compact semantics)
    ms_eff = pa["mode_single"] + act * pa["d_mode_s"]
    cap_t = pa["cap_base"] * state.speed * alive_f
    emitted, dropped = state.emitted.clone(), state.dropped.clone()
    produced = torch.zeros_like(q)
    qps_acc = q.new_zeros((S, pa["n_ops"]))
    take_all = torch.zeros_like(q)

    gate_t = x["gate"][:, pa["job_of_task"]]   # MQ source gate (0/1)
    rfac_t = x["rfac"][:, pa["job_of_task"]]   # traffic-rate factor
    for eph in pa["edges"]:
        if eph["consumes"]:
            take = torch.minimum(q, cap_t * eph["cons_mask"])
            q = q - take
            take_all = take_all + take
            src_emit = (pa["src_row"] * alive_f * eph["cons_mask"]
                        * gate_t * rfac_t)
            produced = produced + (src_emit + take * sel_t)
            # e_jobs / q_ops are unique: gather + add + scatter is exact
            if eph["has_e"]:
                jobs = eph["e_jobs"]
                emitted[:, jobs] = emitted[:, jobs] + row_sum(
                    src_emit, eph["e_idx"], eph["e_mask"])
            ops_ = eph["q_ops"]
            qps_acc[:, ops_] = qps_acc[:, ops_] + row_sum(
                take, eph["q_idx"], eph["q_mask"])
        if not eph["D"]:
            continue
        # the whole routing phase: one fused kernel call
        accepted, drop_d, ovf_e = tick_phase(
            produced, alive_f, free, ms_eff, eph["tables"],
            has_blk=eph["B"] > 0, has_grp=eph["G"] > 0)
        jobs = eph["dj_jobs"]
        dropped[:, jobs] = dropped[:, jobs] + row_sum(
            drop_d, eph["dj_idx"], eph["dj_mask"])
        # overflow re-queues uniformly at each source op
        ovf_op = q.new_zeros((S, pa["n_ops"]))
        ovf_op[:, eph["slot_ops"]] = row_sum(ovf_e, eph["se_idx"],
                                             eph["se_mask"])
        q = q + (ovf_op / pa["par_of_op"])[:, pa["op_of_task"]]
        # deposits: dst tasks are unique within a phase
        dst = eph["dst_task"]
        q[:, dst] = q[:, dst] + accepted
        free[:, dst] = free[:, dst] + (-accepted)
        free = torch.clamp(free, min=0.0)
    return _finish_tick(pa, state, x, q, emitted, dropped, qps_acc, act,
                        take_all)


def _finish_tick(pa, state, x, q, emitted, dropped, qps_acc, act,
                 take_all):
    """End of tick, as the reference's ``_finish_tick_batched``: host
    kills → failover (per-task mode masks + passive-restore surcharge),
    checkpoint counter, the drill controller and wave scheduler, the DS2
    autoscaler, and the per-op metric rows. These run on every tick,
    with inert leaves as exact arithmetic no-ops."""
    t, dt_ = x["t"], pa["dt"]
    jot = pa["job_of_task"]
    vict = x["kills"][:, pa["task_host"]]
    ms_eff = pa["mode_single"] + act * pa["d_mode_s"]
    mr_eff = pa["mode_region"] + act * pa["d_mode_r"]
    mh_eff = pa["mode_hot"] + act * pa["d_mode_h"]
    hit_s = (vict > 0.0).to(F64) * (ms_eff > 0.5)
    region = pa["task_region"].expand_as(q)
    reg_hit = q.new_zeros((q.shape[0], pa["n_regions"])).scatter_reduce(
        1, region, vict * (mr_eff > 0.5), "amax", include_self=False)
    hit_r = (reg_hit[:, pa["task_region"]] > 0.0).to(F64)
    hit_h = (vict > 0.0).to(F64) * (mh_eff > 0.5)
    extra = ((pa["restore_base"] + act * pa["d_restore"])
             * x["bfac"][:, jot]
             + x["ckage"][:, jot] * (1.0 + act * pa["d_ck"])
             * (pa["replay_rate"] + act * pa["d_replay"])
             + pa["lazy_extra"])
    until_s = t + (pa["detect"] + pa["restart_single"]
                   + act * pa["d_down_s"] + extra)
    until_r = t + (pa["detect"] + pa["restart_region"]
                   + act * pa["d_down_r"] + extra)
    until_h = t + (pa["detect"] + pa["standby_switch"]
                   + pa["standby_stale"] + act * pa["d_down_h"])
    down_until = torch.where(hit_r > 0.0, until_r,
                             torch.where(hit_s > 0.0, until_s,
                                         torch.where(hit_h > 0.0, until_h,
                                                     state.down_until)))
    hit_any = torch.maximum(torch.maximum(hit_r, hit_s), hit_h)
    q = torch.where(hit_any > 0.0, 0.0, q)

    ckpt_epoch = state.ckpt_epoch + x["ckpt"]

    # drill controller + wave scheduler: EWMA update → rollback decision
    # on the updated accumulator → wave triggers on the updated rb_t
    delta = q @ pa["up_wdelta"]                          # (S,)
    g = float(t >= pa["up_t0"])
    dacc = state.dacc + g * pa["up_alpha"] * (delta - state.dacc)
    fire = (dacc > pa["up_thresh"]) & torch.isinf(state.rb_t) \
        & (t >= pa["up_t0"])
    rb_t = torch.where(fire, t + dt_, state.rb_t)
    trig_up = (t <= pa["up_start"]) & (pa["up_start"] < t + dt_)
    up_until = torch.maximum(
        state.up_until,
        torch.where(trig_up, pa["up_start"] + pa["up_down"], 0.0))
    rb_start = rb_t[:, None] + pa["up_rstag"]            # (S, n_tasks)
    trig_rb = (t <= rb_start) & (rb_start < t + dt_)
    up_until = torch.maximum(
        up_until, torch.where(trig_rb, rb_start + pa["up_down"], 0.0))

    # in-trace DS2 autoscaler: utilization EWMA, breaker update on this
    # tick's failover hits, then the decision on the updated state
    cap_now = pa["cap_base"] * state.speed
    need = ((take_all + q * (dt_ / pa["as_drain"]))
            / torch.clamp(cap_now, min=1e-9))
    rew = state.rew + pa["as_alpha"] * (need - state.rew)
    recent = (t - state.lact) <= pa["as_fw"]
    failev = (hit_any > 0.0) & recent
    crossed = (((t - state.lact) > pa["as_fw"])
               & ((t - dt_ - state.lact) <= pa["as_fw"]))
    failcnt = torch.where(
        failev, state.failcnt + 1.0,
        torch.where(crossed & (hit_any <= 0.0), 0.0, state.failcnt))
    brk_fire = failcnt >= pa["as_bfail"]
    brk_until = torch.where(brk_fire, t + pa["as_brs"], state.brk_until)
    failcnt = torch.where(brk_fire, 0.0, failcnt)
    boundary = bool(np.floor((t + dt_ - pa["as_t0"]) / pa["as_int"])
                    > np.floor((t - pa["as_t0"]) / pa["as_int"]))
    want = torch.clamp(state.speed * rew / pa["as_tgt"], pa["as_lo"],
                       pa["as_hi"])
    rel = (want - state.speed).abs() / torch.clamp(state.speed, min=1e-9)
    as_fire = ((pa["as_mask"] > 0.0) & (rel >= pa["as_hyst"])
               & ((t - state.lact) >= pa["as_cool"])
               & (t >= brk_until)
               & (state.used[:, None] < pa["as_amax"])
               & torch.isinf(state.thrash_t)[:, None]
               & (boundary and pa["as_on"] > 0.0))
    fire_f = as_fire.to(F64)
    speed = torch.where(as_fire, want, state.speed)
    lact = torch.where(as_fire, t, state.lact)
    # graceful rescale: queues persist, the task pays deploy downtime +
    # state-move seconds on the up_until leaf
    downt = pa["as_down"] + pa["as_move"] * (want - state.speed).abs()
    up_until = torch.maximum(up_until, torch.where(as_fire, t + downt, 0.0))
    any_fire = (fire_f.sum(-1) > 0.0).to(F64)
    used = state.used * pa["as_adec"] + any_fire
    dirn = torch.sign(want - state.speed)
    flip = as_fire & (dirn * state.dirp < 0.0)
    dirp = torch.where(as_fire, dirn, state.dirp)
    flip_acc = state.flip_acc * pa["as_tdec"] + flip.to(F64).sum(-1)
    # thrash latch: freezes the controller from the next tick on
    thrash_t = torch.where((flip_acc >= pa["as_tflip"])
                           & torch.isinf(state.thrash_t),
                           t + dt_, state.thrash_t)
    nact = state.nact + fire_f.sum(-1)
    rsec = state.rsec + speed.sum(-1) * dt_

    backlog_row = row_sum(q, pa["op_idx"], pa["op_mask"])
    qps_row = qps_acc / dt_
    lag = backlog_row @ pa["src_mask_ops"]
    new_state = EngineState(q, down_until, speed, ckpt_epoch,
                            emitted, dropped, up_until, rb_t, dacc,
                            rew, lact, dirp, failcnt, brk_until, used,
                            flip_acc, thrash_t, nact, rsec)
    return new_state, qps_row, backlog_row, lag


def run(pa: dict, state: EngineState, xs: dict):
    """Run every tick of ``xs`` over the seed batch (a `from_reference`
    triple). Returns ``(final_state, ys)`` with ``ys["qps"]`` /
    ``ys["backlog"]`` of shape ``(S, T, n_ops)`` and ``ys["lag"]``
    ``(S, T)``, on the device."""
    S, T = state.queue.shape[0], len(xs["t"])
    qps = state.queue.new_empty((S, T, pa["n_ops"]))
    backlog = torch.empty_like(qps)
    lag = state.queue.new_empty((S, T))
    for i in range(T):
        x = {"t": float(xs["t"][i]), "ckpt": int(xs["ckpt"][i]),
             **{k: xs[k][:, i] for k in _XS_SEED_KEYS}}
        state, qps[:, i], backlog[:, i], lag[:, i] = _tick(pa, state, x)
    return state, {"qps": qps, "backlog": backlog, "lag": lag}


# ----------------------------------------------------------------------
# host lowering: LogicalGraph + configs → numpy params (reference layout)
# ----------------------------------------------------------------------
class _Lowered:
    """Host half of the reference's ``jax_engine._Lowered``: lowering,
    per-seed timelines, initial state and event curves, all numpy and in
    the reference's layout."""

    def __init__(self, graph: LogicalGraph | PackedArena, *, n_hosts: int,
                 dt: float, queue_cap: float, failover, ckpt, seed: int):
        self.arena = graph if isinstance(graph, PackedArena) else None
        if self.arena is not None:
            graph = self.arena.graph
            dt, queue_cap = self.arena.dt, self.arena.queue_cap
        self.graph = graph
        self.dt = dt
        self.failover = failover
        self.ckpt_cfg = ckpt
        self.phys: PhysicalGraph = (
            self.arena.phys if self.arena is not None
            else expand(graph, n_hosts=n_hosts, seed=seed))
        self.plan = (self.arena.plan if self.arena is not None
                     else build_plan(graph, dt, queue_cap))
        self.task_host = np.array([tk.host for tk in self.phys.tasks])
        self.task_region = np.array(
            [self.phys.task_region[tk.task_id] for tk in self.phys.tasks])
        self.n_hosts = (self.arena.n_hosts if self.arena is not None
                        else int(self.task_host.max()) + 1)
        self.n_regions = len(self.phys.regions)
        self.n_jobs = self.arena.n_jobs if self.arena is not None else 1
        self.job_of_task = (self.arena.job_of_task
                            if self.arena is not None else None)
        self.job_of_op = (self.arena.job_of_op if self.arena is not None
                          else np.zeros(len(self.plan.ops), dtype=int))
        # job-local placements (per-job ChaosSpec lists draw in these)
        self.task_local_host = (
            np.concatenate([j.local_host for j in self.arena.jobs])
            if self.arena is not None else None)

        plan = self.plan
        n_tasks = plan.n_tasks
        src_row = np.zeros(n_tasks)
        cap_base = np.zeros(n_tasks)
        sel = np.zeros(len(plan.ops))
        for oi, p in enumerate(plan.ops):
            sel[oi] = p.selectivity
            if p.is_source:
                src_row[p.lo:p.hi] = p.src_row
            else:
                cap_base[p.lo:p.hi] = p.service_rate * dt

        codes, det, rst_s, rst_r, fx = per_task_failover(
            failover, n_tasks, self.job_of_task)
        self.fo_codes = codes
        self.fo_detect, self.fo_rs, self.fo_rr = det, rst_s, rst_r
        self.fo_extras = fx
        self.fo_lazy = lazy_ready_extra(fx["stagger"], self.task_region,
                                        self.job_of_task)
        if isinstance(ckpt, (list, tuple)) and (
                self.arena is None or len(list(ckpt)) != self.n_jobs):
            raise ValueError("per-job ckpt list needs a packed arena "
                             "with one entry per job")

        self.tensor = lower_tensor_plan(plan, self.job_of_op)
        self._src_row, self._cap_base = src_row, cap_base
        self.arrays = self._params(plan.qcap, sel, det, rst_s, rst_r,
                                   codes)
        self.op_names = [p.name for p in plan.ops]

    def _params(self, qcap, sel, det, rst_s, rst_r, codes) -> dict:
        """Parameter dict of this lowering, key for key the reference's
        ``_Lowered._params``."""
        fx, lazy = self.fo_extras, self.fo_lazy
        jot = (self.job_of_task if self.job_of_task is not None
               else np.zeros(self.plan.n_tasks, dtype=int))
        return {
            "qcap": np.asarray(qcap, float),
            "src_row": self._src_row,
            "cap_base": self._cap_base,
            "sel": np.asarray(sel, float),
            "dt": np.float64(self.dt),
            "task_host": self.task_host.astype(np.int32),
            "task_region": self.task_region.astype(np.int32),
            "detect": np.asarray(det, float),
            "restart_region": np.asarray(rst_r, float),
            "restart_single": np.asarray(rst_s, float),
            "mode_single": (codes == 2).astype(np.float64),
            "mode_region": (codes == 1).astype(np.float64),
            "mode_hot": (codes == 3).astype(np.float64),
            "standby_switch": np.asarray(fx["switch"], float),
            "standby_stale": np.asarray(fx["stale"], float),
            "restore_base": np.asarray(fx["restore_base"], float),
            "replay_rate": np.asarray(fx["replay_rate"], float),
            "lazy_extra": np.asarray(lazy, float),
            "job_of_task": np.asarray(jot, np.int32),
            "op_of_task": self.tensor.op_of_task.astype(np.int32),
            "par_of_op": np.asarray(self.tensor.par_of_op, float),
            "src_mask_ops": np.asarray(self.tensor.src_mask_ops, float),
            "edges": [ph.traced() for ph in self.tensor.phases],
            # drill and autoscaler leaves: inert (exact no-ops in the
            # tick) until this package lowers real configs
            **inert_upgrade_leaves(self.plan.n_tasks),
            **inert_autoscale_leaves(self.plan.n_tasks),
        }

    # ------------------------------------------------------------------
    def _ckpt_timeline_kw(self, ckpt) -> dict:
        if ckpt is None:
            return dict(ckpt_interval_s=None)
        if isinstance(ckpt, CheckpointConfig):
            return dict(ckpt_interval_s=ckpt.interval_s,
                        ckpt_mode=ckpt.mode, ckpt_upload_s=ckpt.upload_s,
                        ckpt_retry=ckpt.retry_failed_region)
        cfgs = list(ckpt)
        return dict(
            ckpt_interval_s=[c.interval_s if c else None for c in cfgs],
            ckpt_mode=[c.mode if c else "region" for c in cfgs],
            ckpt_upload_s=[c.upload_s if c else 4.0 for c in cfgs],
            ckpt_retry=[c.retry_failed_region if c else True
                        for c in cfgs])

    def timeline(self, spec, n_ticks: int) -> ChaosTimeline:
        """Pregenerate one seed's chaos timeline. `spec` may be a per-job
        `ChaosSpec` list (packed arenas): each job then runs its own
        chaos process in its local host domain."""
        ex = self.fo_extras
        common = dict(
            n_ticks=n_ticks, dt=self.dt, n_hosts=self.n_hosts,
            task_host=self.task_host, task_region=self.task_region,
            regions=self.phys.regions, failover_mode=self.fo_codes,
            detect_s=self.fo_detect, region_restart_s=self.fo_rr,
            single_restart_s=self.fo_rs, job_of_task=self.job_of_task,
            standby_switch_s=ex["switch"], standby_staleness_s=ex["stale"],
            restore_base_s=ex["restore_base"],
            replay_rate=ex["replay_rate"], lazy_extra_s=self.fo_lazy,
            **self._ckpt_timeline_kw(self.ckpt_cfg))
        if isinstance(spec, (list, tuple)):
            if self.arena is None:
                raise ValueError("a per-job chaos list needs a packed "
                                 "arena with one entry per job")
            specs = [sp.spec if isinstance(sp, ChaosEngine)
                     else (sp or ChaosSpec()) for sp in spec]
            if len(specs) != self.n_jobs:
                raise ValueError(f"per-job chaos list must have one "
                                 f"entry per job ({len(specs)} != "
                                 f"{self.n_jobs})")
            return build_perjob_chaos_timeline(
                specs, job_hosts=[j.hosts for j in self.arena.jobs],
                task_local_host=self.task_local_host, **common)
        return build_chaos_timeline(spec, **common)

    def state0(self, tl: ChaosTimeline,
               task_speed_override: dict[int, float] | None
               ) -> EngineState:
        n_tasks = self.plan.n_tasks
        speed = np.ones(n_tasks)
        if task_speed_override:
            for tid, s in task_speed_override.items():
                speed[tid] = s
        speed *= tl.task_speed
        return EngineState(
            queue=np.zeros(n_tasks), down_until=np.zeros(n_tasks),
            speed=speed, ckpt_epoch=np.int32(0),
            emitted=np.zeros(self.n_jobs), dropped=np.zeros(self.n_jobs),
            up_until=np.zeros(n_tasks), rb_t=np.float64(np.inf),
            dacc=np.float64(0.0),
            rew=np.zeros(n_tasks), lact=np.full(n_tasks, -1e18),
            dirp=np.zeros(n_tasks), failcnt=np.zeros(n_tasks),
            brk_until=np.zeros(n_tasks), used=np.float64(0.0),
            flip_acc=np.float64(0.0), thrash_t=np.float64(np.inf),
            nact=np.float64(0.0), rsec=np.float64(0.0))

    def event_curves(self, spec, tl: ChaosTimeline) -> tuple:
        """Deterministic per-tick external-event tensors for one seed,
        each ``(n_ticks, n_jobs)``: ``bfac`` storage-brownout factor,
        ``gate`` source gate (MQ outages × coordinator leader loss),
        ``ckage`` checkpoint age and ``rfac`` traffic-rate factor."""
        ts = tl.ts
        if isinstance(spec, (list, tuple)):
            specs = [sp.spec if isinstance(sp, ChaosEngine)
                     else (sp or ChaosSpec()) for sp in spec]
            bfac = np.stack([brownout_curve(tuple(sp.brownout_at), ts)
                             for sp in specs], axis=1)
            gate = np.stack(
                [mq_gate_curve(sp.mq_down, ts)
                 * coordinator_gate_curve(sp.zk_down, sp.hdfs_down, ts)
                 for sp in specs], axis=1)
            rfac = np.stack(
                [traffic_curve(tuple(sp.diurnal), tuple(sp.flash_at), ts,
                               phase_s=sp.rate_phase_s)
                 for sp in specs], axis=1)
        else:
            bf = brownout_curve(tuple(spec.brownout_at), ts)
            gt = (mq_gate_curve(spec.mq_down, ts)
                  * coordinator_gate_curve(spec.zk_down, spec.hdfs_down,
                                           ts))
            rf = traffic_curve(tuple(spec.diurnal), tuple(spec.flash_at),
                               ts, phase_s=spec.rate_phase_s)
            bfac = np.repeat(bf[:, None], self.n_jobs, axis=1)
            gate = np.repeat(gt[:, None], self.n_jobs, axis=1)
            rfac = np.repeat(rf[:, None], self.n_jobs, axis=1)
        ok = (tl.ckpt_ok_by_job if tl.ckpt_ok_by_job is not None
              else tl.ckpt_ok)
        ckage = ckpt_age_curve(ts, ok, self.n_jobs)
        return bfac, gate, ckage, rfac

    def prepare(self, spec, n_ticks: int,
                task_speed_override: dict[int, float] | None = None
                ) -> tuple[EngineState, dict, ChaosTimeline]:
        """Pregenerate one seed's chaos timeline → (state0, xs, tl)."""
        tl = self.timeline(spec, n_ticks)
        state = self.state0(tl, task_speed_override)
        bfac, gate, ckage, rfac = self.event_curves(spec, tl)
        xs = {"t": tl.ts, "kills": tl.kills.astype(np.float64),
              "ckpt": tl.ckpt_at, "bfac": bfac, "gate": gate,
              "ckage": ckage, "rfac": rfac}
        return state, xs, tl


# ----------------------------------------------------------------------
# metrics façades (numpy, the reference's read API)
# ----------------------------------------------------------------------
class TorchEngineMetrics:
    """One scenario's metrics, field for field the reference's
    ``JaxEngineMetrics``."""

    def __init__(self, op_names, t, lag, qps, backlog, emitted, dropped,
                 timeline: ChaosTimeline, ckpt_epoch: int | None = None,
                 rollback_t: float = np.inf, thrash_t: float = np.inf,
                 n_rescale: float = 0.0, resource_s: float = 0.0):
        self.t = t
        self.source_lag = lag
        self.qps = {n: qps[:, j] for j, n in enumerate(op_names)}
        self.backlog = {n: backlog[:, j] for j, n in enumerate(op_names)}
        self.emitted_by_job = np.atleast_1d(np.asarray(emitted, float))
        self.dropped_by_job = np.atleast_1d(np.asarray(dropped, float))
        self.emitted = float(self.emitted_by_job.sum())
        self.dropped = float(self.dropped_by_job.sum())
        self.ckpt_attempts = timeline.ckpt_attempts
        self.ckpt_success = timeline.ckpt_success
        self.ckpt_failed = timeline.ckpt_failed
        self.ckpt_by_job = timeline.ckpt_by_job
        # device-side attempt counter: agrees with the host timeline
        self.ckpt_epoch = (timeline.ckpt_attempts if ckpt_epoch is None
                           else int(ckpt_epoch))
        self.recoveries = timeline.recoveries
        self.timeline = timeline
        self.rollback_t = float(rollback_t)
        self.thrash_t = float(thrash_t)
        self.n_rescale = float(n_rescale)
        self.resource_s = float(resource_s)


class TorchBatchMetrics:
    """Stacked metrics of a seed batch, field for field the reference's
    ``JaxBatchMetrics``; `row(i)` equals a standalone run of seed i."""

    def __init__(self, op_names, t, lag, qps, backlog, emitted, dropped,
                 timelines, ckpt_epoch=None, jobs=None, rollback_t=None,
                 thrash_t=None, n_rescale=None, resource_s=None):
        self.op_names = list(op_names)
        self.t = t                     # (n_ticks,)
        self.source_lag = lag          # (S, n_ticks)
        self.qps = qps                 # (S, n_ticks, n_ops)
        self.backlog = backlog         # (S, n_ticks, n_ops)
        self.emitted_by_job = np.asarray(emitted, float)   # (S, n_jobs)
        self.dropped_by_job = np.asarray(dropped, float)   # (S, n_jobs)
        self.emitted = self.emitted_by_job.sum(axis=-1)    # (S,)
        self.dropped = self.dropped_by_job.sum(axis=-1)    # (S,)
        self.ckpt_epoch = ckpt_epoch   # (S,) device-side attempt counter
        # (S,) drill rollback / thrash-latch times (+inf = never), scale
        # action counts, resource-seconds integrals
        self.rollback_t = rollback_t
        self.thrash_t = thrash_t
        self.n_rescale = n_rescale
        self.resource_s = resource_s
        self.timelines = list(timelines)
        self.jobs = list(jobs) if jobs is not None else None
        self.ckpt_attempts = np.array([tl.ckpt_attempts for tl in timelines])
        self.ckpt_success = np.array([tl.ckpt_success for tl in timelines])
        self.ckpt_failed = np.array([tl.ckpt_failed for tl in timelines])
        self.recoveries = [tl.recoveries for tl in timelines]
        self._recs_by_job = None

    def __len__(self) -> int:
        return len(self.timelines)

    def row(self, i: int) -> TorchEngineMetrics:
        return TorchEngineMetrics(
            self.op_names, self.t, self.source_lag[i], self.qps[i],
            self.backlog[i], self.emitted_by_job[i], self.dropped_by_job[i],
            self.timelines[i], ckpt_epoch=self.ckpt_epoch[i],
            rollback_t=self.rollback_t[i], thrash_t=self.thrash_t[i],
            n_rescale=self.n_rescale[i], resource_s=self.resource_s[i])

    def job_view(self, job: JobSlice) -> "TorchBatchMetrics":
        """Per-job slice of a packed-arena batch: the job's metric columns
        under their original op names, source lag summed over the job's
        own sources, per-job emitted/dropped, and the job's recovery
        events — shaped like a single-job batch, so
        `chaos_sweep.summarize` works per job. The recoveries are
        grouped by job once per batch (the reference filters every
        seed's whole list once per job)."""
        if self._recs_by_job is None:
            self._recs_by_job = []
            for tl in self.timelines:
                by_job: dict[int, list] = {}
                for r in tl.recoveries:
                    by_job.setdefault(r.get("job", 0), []).append(r)
                self._recs_by_job.append(by_job)
        cols = np.asarray(job.op_cols)
        lag = self.backlog[:, :, np.asarray(job.src_cols)].sum(axis=-1)
        j = job.index
        tls = [dataclasses.replace(tl, recoveries=by_job.get(j, []))
               for tl, by_job in zip(self.timelines, self._recs_by_job)]
        return TorchBatchMetrics(
            job.op_names, self.t, lag, self.qps[:, :, cols],
            self.backlog[:, :, cols], self.emitted_by_job[:, j:j + 1],
            self.dropped_by_job[:, j:j + 1], tls,
            ckpt_epoch=self.ckpt_epoch, rollback_t=self.rollback_t,
            thrash_t=self.thrash_t, n_rescale=self.n_rescale,
            resource_s=self.resource_s)


# ----------------------------------------------------------------------
# public API
# ----------------------------------------------------------------------
def _run_prepared(low: _Lowered, batch_state, xs, tls, device,
                  timing: dict | None) -> TorchBatchMetrics:
    """One device pass over a host-prepared seed batch → numpy metrics."""
    t0 = time.perf_counter()
    pa, st, xd = from_reference(low.arrays, batch_state, xs, device)
    final, ys = run(pa, st, xd)
    out = {k: v.cpu().numpy() for k, v in ys.items()}
    fin = {f: getattr(final, f).cpu().numpy()
           for f in ("emitted", "dropped", "ckpt_epoch", "rb_t",
                     "thrash_t", "nact", "rsec")}
    if timing is not None:
        timing["device_s"] = time.perf_counter() - t0
    return TorchBatchMetrics(
        low.op_names, tls[0].ts, out["lag"], out["qps"], out["backlog"],
        fin["emitted"], fin["dropped"], tls, ckpt_epoch=fin["ckpt_epoch"],
        jobs=low.arena.jobs if low.arena is not None else None,
        rollback_t=fin["rb_t"], thrash_t=fin["thrash_t"],
        n_rescale=fin["nact"], resource_s=fin["rsec"])


class TorchStreamEngine:
    """Single-seed engine, the counterpart of the reference's
    ``JaxStreamEngine``: `run(duration_s)` returns `TorchEngineMetrics`
    with the numpy engine's metric names and values. `failover` /
    `ckpt` may be per-job config lists for packed arenas."""

    def __init__(self, graph: LogicalGraph | PackedArena, *,
                 n_hosts: int = 8, dt: float = 0.5, queue_cap: float = 256.0,
                 chaos: ChaosEngine | ChaosSpec | None = None,
                 failover=None, ckpt=None,
                 task_speed_override: dict[int, float] | None = None,
                 seed: int = 0,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        if isinstance(chaos, ChaosEngine):
            chaos = chaos.spec
        elif isinstance(chaos, (list, tuple)):
            chaos = [c.spec if isinstance(c, ChaosEngine)
                     else (c or ChaosSpec()) for c in chaos]
        self.spec = chaos if chaos is not None else ChaosSpec()
        self.g = graph.graph if isinstance(graph, PackedArena) else graph
        self._override = task_speed_override
        self._low = _Lowered(graph, n_hosts=n_hosts, dt=dt,
                             queue_cap=queue_cap, failover=failover,
                             ckpt=ckpt, seed=seed)
        self.dt = self._low.dt
        self.metrics: TorchEngineMetrics | None = None

    @property
    def lowered(self) -> _Lowered:
        return self._low

    def run(self, duration_s: float) -> TorchEngineMetrics:
        n_ticks = int(round(duration_s / self.dt))
        state, xs, tl = self._low.prepare(self.spec, n_ticks,
                                          self._override)
        self.metrics = _run_prepared(self._low, state, xs, [tl],
                                     self.device, None).row(0)
        return self.metrics


def perjob_sweep_seed(base_seed: int, sweep_seed: int, job: int) -> int:
    """Collision-free derived seed for job `job` of sweep seed
    `sweep_seed` under a per-job base spec (SeedSequence entropy mix)."""
    return int(np.random.SeedSequence(
        (int(base_seed), int(sweep_seed), int(job))).generate_state(1)[0])


def _as_specs(seeds, base_spec) -> list:
    """Merge sweep seeds into the base spec. A per-job `base_spec` list
    (packed arenas) yields one per-job spec list per seed, job j of
    sweep seed s drawing from ``perjob_sweep_seed(base[j].seed, s, j)``.
    Entries of `seeds` that are already specs pass through untouched."""
    if isinstance(base_spec, (list, tuple)):
        base = [b or ChaosSpec() for b in base_spec]
        return [[dataclasses.replace(b, seed=perjob_sweep_seed(
                    b.seed, int(s), j)) for j, b in enumerate(base)]
                if isinstance(s, (int, np.integer)) else s
                for s in seeds]
    return [dataclasses.replace(base_spec or ChaosSpec(), seed=int(s))
            if isinstance(s, (int, np.integer)) else s for s in seeds]


def _prep_batch(low: _Lowered, specs, n_ticks: int, task_speed_override):
    """Host prep of a seed batch: per-seed timelines stacked on a leading
    seed axis (the reference's ``_prep_batch``, without pow2 padding)."""
    prepped = [low.prepare(spec, n_ticks, task_speed_override)
               for spec in specs]
    states = [p[0] for p in prepped]
    tls = [p[2] for p in prepped]
    batch_state = EngineState(*(np.stack([getattr(s, f) for s in states])
                                for f in EngineState._fields))
    xs = {"t": prepped[0][1]["t"], "ckpt": prepped[0][1]["ckpt"],
          **{k: np.stack([p[1][k] for p in prepped])
             for k in _XS_SEED_KEYS}}
    return batch_state, xs, tls


def run_batch(graph: LogicalGraph | PackedArena, seeds, *,
              duration_s: float, base_spec: ChaosSpec | None = None,
              n_hosts: int = 8, dt: float = 0.5, queue_cap: float = 256.0,
              failover=None, ckpt=None,
              task_speed_override: dict[int, float] | None = None,
              seed: int = 0, device: str | torch.device | None = None,
              timing: dict | None = None) -> TorchBatchMetrics:
    """Run a ``(S,)`` batch of chaos scenarios as one device pass.

    `seeds` is a sequence of ints (merged into `base_spec`) or of full
    `ChaosSpec`s. `graph` may be a `PackedArena`: the whole co-located
    fleet then simulates in the same pass with per-job metric segments,
    and `failover` / `ckpt` may be per-job config lists. ``timing``, if
    given a dict, receives the ``lower_s`` / ``prep_s`` / ``device_s``
    wall split (host lowering, host timeline prep, device pass with the
    upload and the copy back)."""
    device = resolve_device(device)
    specs = _as_specs(seeds, base_spec)
    if not specs:
        raise ValueError("run_batch requires at least one seed/spec")
    t0 = time.perf_counter()
    low = _Lowered(graph, n_hosts=n_hosts, dt=dt, queue_cap=queue_cap,
                   failover=failover, ckpt=ckpt, seed=seed)
    t1 = time.perf_counter()
    n_ticks = int(round(duration_s / low.dt))
    batch_state, xs, tls = _prep_batch(low, specs, n_ticks,
                                       task_speed_override)
    if timing is not None:
        timing["lower_s"] = t1 - t0
        timing["prep_s"] = time.perf_counter() - t1
    return _run_prepared(low, batch_state, xs, tls, device, timing)
