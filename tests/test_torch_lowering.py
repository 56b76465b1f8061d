"""The port's host lowering equals the reference's exactly.

``repro_torch``'s copies of the plan lowering (`build_plan`,
`lower_tensor_plan`), the parameter dict (`_Lowered._params`) and the
chaos timelines (`build_chaos_timeline`, `build_perjob_chaos_timeline`,
via `_Lowered.prepare`) are held against the JAX package's with
`np.array_equal`, key by key: the port's tick then sees the reference's
exact inputs.
"""
import dataclasses

import numpy as np
import pytest

from repro.core.chaos import ChaosSpec as RSpec
from repro.streams import engine as reng
from repro.streams import nexmark as rnx
from repro.streams.jax_engine import _Lowered as RLowered
from repro_torch.core.chaos import ChaosSpec as TSpec
from repro_torch.streams import engine as teng
from repro_torch.streams import nexmark as tnx
from repro_torch.streams.torch_engine import _Lowered as TLowered

PARTITIONERS = ("rebalance", "hash", "weakhash", "backlog", "rescale",
                "group_rescale")


def _q2(nx, part):
    return nx.q2(parallelism=16, partitioner=part, n_groups=4)


def _perjob(nx, eng, spec_cls):
    """A packed arena with per-job failover, checkpoint and chaos lists."""
    jobs =[nx.q12(parallelism=4), nx.ss(parallelism=4),
            nx.ds(parallelism=4)]
    a = eng.pack_arena(jobs, "shared", n_hosts=8)
    fo = [eng.FailoverConfig(mode="region", region_restart_s=20.0),
          eng.FailoverConfig(mode="single_task", restore_base_s=2.0,
                             replay_rate=0.1),
          eng.FailoverConfig(mode="hot_standby", lazyload_stagger_s=1.5)]
    ck = [eng.CheckpointConfig(interval_s=20.0), None,
          eng.CheckpointConfig(interval_s=15.0, mode="global")]
    specs = [spec_cls(seed=3, host_kill_prob_per_s=0.01,
                      storage_slow_prob=0.3),
             spec_cls(seed=4, straggler_frac=0.3, burst_at=((20.0, 0),)),
             spec_cls(seed=5, host_kill_at=((12.0, 1),),
                      brownout_at=((5.0, 40.0, 3.0),),
                      mq_down=((25.0, 30.0),))]
    return a, fo, ck, specs


# case → (reference graph + kwargs + spec, port graph + kwargs + spec)
def _case(name):
    kill = dict(seed=2, host_kill_prob_per_s=0.01, straggler_frac=0.2,
                storage_slow_prob=0.2)
    if name.startswith("q2/"):
        part = name[3:]
        return ((_q2(rnx, part), dict(failover=reng.FailoverConfig(
                    mode="single_task")), RSpec(**kill)),
                (_q2(tnx, part), dict(failover=teng.FailoverConfig(
                    mode="single_task")), TSpec(**kill)))
    if name == "ss":
        mk = lambda nx, eng, sp: (  # noqa: E731
            nx.ss(parallelism=8),
            dict(failover=eng.FailoverConfig(mode="region"),
                 ckpt=eng.CheckpointConfig(interval_s=10.0)),
            sp(**kill, burst_at=((30.0, 0),)))
        return mk(rnx, reng, RSpec), mk(tnx, teng, TSpec)
    if name == "ss_arena":
        mk = lambda nx, eng, sp: (  # noqa: E731
            nx.ss_arena(n_tasks=168, parallelism=4, n_hosts=8),
            dict(failover=eng.FailoverConfig(mode="region")),
            nx.ha_drill_spec(seed=1, burst_t=20.0,
                             host_kill_prob_per_s=0.01))
        return mk(rnx, reng, RSpec), mk(tnx, teng, TSpec)
    assert name == "perjob_arena"
    ra, rfo, rck, rsp = _perjob(rnx, reng, RSpec)
    ta, tfo, tck, tsp = _perjob(tnx, teng, TSpec)
    return ((ra, dict(failover=rfo, ckpt=rck), rsp),
            (ta, dict(failover=tfo, ckpt=tck), tsp))


CASES = [f"q2/{p}" for p in PARTITIONERS] + ["ss", "ss_arena",
                                             "perjob_arena"]


def _lowered(case):
    (rg, rkw, rspec), (tg, tkw, tspec) = _case(case)
    r = RLowered(rg, n_hosts=8, dt=0.5, queue_cap=256.0, seed=0,
                 phase_mode="pallas", **{"ckpt": None, **rkw})
    t = TLowered(tg, n_hosts=8, dt=0.5, queue_cap=256.0, seed=0,
                 **{"ckpt": None, **tkw})
    return r, t, rspec, tspec


def _assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)) and not isinstance(a, np.ndarray):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}[{i}]")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype, (path, x.dtype, y.dtype)
        assert np.array_equal(x, y), path


@pytest.mark.parametrize("case", CASES)
def test_plan_and_params_equal_reference(case):
    r, t, _, _ = _lowered(case)
    # routing plan
    rp, tp = r.plan, t.plan
    assert rp.n_tasks == tp.n_tasks and rp.offs == tp.offs
    assert np.array_equal(rp.qcap, tp.qcap)
    for a, b in zip(rp.ops, tp.ops):
        assert (a.name, a.lo, a.hi, a.par, a.is_source, a.service_rate,
                a.selectivity) == (b.name, b.lo, b.hi, b.par, b.is_source,
                                   b.service_rate, b.selectivity)
        for ea, eb in zip(a.out_edges, b.out_edges):
            for f in dataclasses.fields(ea):
                if f.name in ("src", "dst", "ratio_buf", "live_buf"):
                    continue
                _assert_tree_equal(getattr(ea, f.name), getattr(eb, f.name),
                                   f"{a.name}.{f.name}")
    for f in ("arena_starts", "backlog_perm", "src_cols"):
        assert np.array_equal(getattr(rp, f), getattr(tp, f)), f
    # tensor plan: the compact row tables, phase by phase
    assert r.tensor.n_phases == t.tensor.n_phases
    for f in ("op_of_task", "is_src_task", "job_of_task", "par_of_op",
              "src_mask_ops"):
        _assert_tree_equal(getattr(r.tensor, f), getattr(t.tensor, f), f)
    for i, (pr, pt) in enumerate(zip(r.tensor.phases, t.tensor.phases)):
        assert (pr.consumes, pr.D, pr.E, pr.B, pr.G) == \
            (pt.consumes, pt.D, pt.E, pt.B, pt.G), i
        assert pr.sig == pt.sig, i
        _assert_tree_equal(pr.traced(), pt.traced(), f"phase{i}")
    # the parameter dict, key by key
    _assert_tree_equal(r.arrays, t.arrays, "arrays")


@pytest.mark.parametrize("case", CASES)
def test_timelines_and_prep_equal_reference(case):
    r, t, rspec, tspec = _lowered(case)
    n_ticks = 120
    rs, rxs, rtl = r.prepare(rspec, n_ticks)
    ts, txs, ttl = t.prepare(tspec, n_ticks)
    for f in ("ts", "task_speed", "kills", "ckpt_at", "ckpt_ok",
              "ckpt_by_job", "ckpt_ok_by_job"):
        _assert_tree_equal(getattr(rtl, f), getattr(ttl, f), f)
    assert (rtl.ckpt_attempts, rtl.ckpt_success, rtl.ckpt_failed) == \
        (ttl.ckpt_attempts, ttl.ckpt_success, ttl.ckpt_failed)
    assert rtl.recoveries == ttl.recoveries
    _assert_tree_equal(rxs, txs, "xs")
    for f in rs._fields:
        _assert_tree_equal(getattr(rs, f), getattr(ts, f), f)


def test_cases_exercise_chaos():
    """The timeline cases are not vacuous: kills, recoveries and
    checkpoint attempts all occur somewhere."""
    seen = {"kills": 0, "recoveries": 0, "ckpt": 0}
    for case in ("ss", "perjob_arena"):
        _, t, _, tspec = _lowered(case)
        _, _, tl = t.prepare(tspec, 120)
        seen["kills"] += int(tl.kills.sum())
        seen["recoveries"] += len(tl.recoveries)
        seen["ckpt"] += tl.ckpt_attempts
    assert all(v > 0 for v in seen.values()), seen


def test_upgrade_and_autoscale_lowering_not_carried_yet():
    """Only the inert drill / autoscale leaves are lowered by the port;
    real configs raise instead of running silently inert."""
    kw = dict(n_tasks=4, job_of_task=None, task_region=np.zeros(4),
              dt=0.5, base_failover=None, base_ckpt=None,
              sel_task=np.ones(4))
    assert teng.lower_upgrade(None, None, **kw)["up_alpha"] == 0.0
    with pytest.raises(NotImplementedError):
        teng.lower_upgrade(teng.UpgradeConfig(), None, **kw)
    assert teng.lower_autoscale(None, n_tasks=4, dt=0.5)["as_on"] == 0.0
    with pytest.raises(NotImplementedError):
        teng.lower_autoscale(teng.AutoscaleConfig(), n_tasks=4, dt=0.5)
