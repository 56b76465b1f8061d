"""The port's seed-batched engine equals the JAX engine and the numpy one.

`TorchStreamEngine` / `run_batch` on the CPU (the plain path of the
tick-phase kernel) are held at 1e-12 against `JaxStreamEngine` /
`run_batch` in both the ``pallas`` and ``compact`` phase modes on the
`tests/test_pallas_tick.py` cases (six partitioners, a kill-heavy SS run,
a short run on the 2016-task SS arena), and at 1e-5 against the numpy
`StreamEngine`. A drill-plus-autoscale case feeds the reference's own
lowered inputs (canary failover-mode delta included) through
`from_reference` into the port's tick and compares with JAX compact.
"""
import functools

import numpy as np
import pytest
import torch

from repro.core.chaos import ChaosEngine
from repro.core.chaos import ChaosSpec as RSpec
from repro.streams import engine as reng
from repro.streams import nexmark as rnx
from repro.streams.jax_engine import JaxStreamEngine
from repro.streams.jax_engine import _Lowered as RLowered
from repro.streams.jax_engine import _enable_x64, get_cached_run_fns
from repro.streams.jax_engine import run_batch as r_run_batch
from repro_torch.core.chaos import ChaosSpec as TSpec
from repro_torch.streams import engine as teng
from repro_torch.streams import nexmark as tnx
from repro_torch.streams import torch_engine as te
from repro_torch.streams.chaos_sweep import sweep

TOL = dict(rtol=1e-12, atol=1e-9)
PARTITIONERS = ("rebalance", "hash", "weakhash", "backlog", "rescale",
                "group_rescale")


def _assert_metrics(mr, mt, tol=TOL, label=""):
    assert list(mr.qps) == list(mt.qps)
    for n in mr.qps:
        np.testing.assert_allclose(mt.qps[n], mr.qps[n],
                                   err_msg=f"{label} qps[{n}]", **tol)
        np.testing.assert_allclose(mt.backlog[n], mr.backlog[n],
                                   err_msg=f"{label} backlog[{n}]", **tol)
    np.testing.assert_allclose(mt.source_lag, mr.source_lag, **tol)
    np.testing.assert_allclose(mt.emitted, mr.emitted, **tol)
    np.testing.assert_allclose(mt.dropped, mr.dropped, **tol)
    assert (mt.ckpt_attempts, mt.ckpt_success, mt.ckpt_failed) == \
        (mr.ckpt_attempts, mr.ckpt_success, mr.ckpt_failed)
    assert mt.recoveries == mr.recoveries


# ----------------------------------------------------------------------
# single-seed runs against JaxStreamEngine (pallas and compact)
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _partitioner_run(part, side, mode="pallas"):
    if side == "torch":
        return te.TorchStreamEngine(
            tnx.q2(parallelism=16, partitioner=part, n_groups=4),
            n_hosts=8, chaos=TSpec(seed=1, host_kill_prob_per_s=0.004,
                                   straggler_frac=0.2),
            failover=teng.FailoverConfig(mode="region",
                                         region_restart_s=20.0),
            device="cpu").run(120)
    return JaxStreamEngine(
        rnx.q2(parallelism=16, partitioner=part, n_groups=4),
        n_hosts=8, chaos=RSpec(seed=1, host_kill_prob_per_s=0.004,
                               straggler_frac=0.2),
        failover=reng.FailoverConfig(mode="region", region_restart_s=20.0),
        phase_mode=mode).run(120)


@pytest.mark.parametrize("mode", ["pallas", "compact"])
@pytest.mark.parametrize("part", PARTITIONERS)
def test_partitioners_match_jax(part, mode):
    _assert_metrics(_partitioner_run(part, "jax", mode),
                    _partitioner_run(part, "torch"), label=part)


@pytest.mark.parametrize("mode", ["pallas", "compact"])
def test_kill_heavy_matches_jax(mode):
    """Whole regions die repeatedly and phases run near-empty."""
    kw = dict(seed=5, host_kill_prob_per_s=0.05, straggler_frac=0.3)
    mr = JaxStreamEngine(rnx.ss(parallelism=8), n_hosts=8,
                         chaos=RSpec(**kw),
                         failover=reng.FailoverConfig(
                             mode="region", region_restart_s=10.0),
                         phase_mode=mode).run(240)
    mt = te.TorchStreamEngine(tnx.ss(parallelism=8), n_hosts=8,
                              chaos=TSpec(**kw),
                              failover=teng.FailoverConfig(
                                  mode="region", region_restart_s=10.0),
                              device="cpu").run(240)
    assert len(mt.recoveries) > 5           # the chaos actually fired
    _assert_metrics(mr, mt, label="kill-heavy")


@pytest.mark.parametrize("mode", ["pallas", "compact"])
def test_2k_arena_matches_jax(mode):
    """36 packed SS jobs, six phases: the raw per-tick rows."""
    kw = dict(seed=0, host_kill_prob_per_s=0.01, straggler_frac=0.2)
    low = RLowered(rnx.ss_arena(n_tasks=2016, parallelism=8, n_hosts=32),
                   n_hosts=32, dt=0.5, queue_cap=256.0,
                   failover=reng.FailoverConfig(mode="region",
                                                region_restart_s=15.0),
                   ckpt=None, seed=0, phase_mode=mode)
    run_fn, _ = get_cached_run_fns(low.desc)
    with _enable_x64():
        st, xs, _ = low.prepare(RSpec(**kw), 32)
        _, ys = run_fn(low.arrays, st, xs)
        want = {k: np.asarray(v) for k, v in ys.items()}
    tlow = te._Lowered(tnx.ss_arena(n_tasks=2016, parallelism=8,
                                    n_hosts=32),
                       n_hosts=32, dt=0.5, queue_cap=256.0,
                       failover=teng.FailoverConfig(mode="region",
                                                    region_restart_s=15.0),
                       ckpt=None, seed=0)
    tst, txs, _ = tlow.prepare(TSpec(**kw), 32)
    _, tys = te.run(*te.from_reference(tlow.arrays, tst, txs, "cpu"))
    for k in want:
        np.testing.assert_allclose(tys[k][0].numpy(), want[k], err_msg=k,
                                   **TOL)


# ----------------------------------------------------------------------
# against the numpy StreamEngine (the semantic oracle), 1e-5
# ----------------------------------------------------------------------
def test_matches_numpy_engine_ckpt_under_kills():
    """Interleaved rng consumers: kill draws + checkpoint storage draws,
    the failover and checkpoint coordinator of the numpy engine."""
    kw = dict(seed=7, host_kill_prob_per_s=0.004, storage_slow_prob=0.2,
              storage_slow_factor=12)
    a = reng.StreamEngine(rnx.ds(parallelism=6), n_hosts=6,
                          chaos=ChaosEngine(RSpec(**kw)),
                          failover=reng.FailoverConfig(
                              mode="region", region_restart_s=15.0),
                          ckpt=reng.CheckpointConfig(interval_s=40,
                                                     mode="region"))
    a.run(500)
    mt = te.TorchStreamEngine(tnx.ds(parallelism=6), n_hosts=6,
                              chaos=TSpec(**kw),
                              failover=teng.FailoverConfig(
                                  mode="region", region_restart_s=15.0),
                              ckpt=teng.CheckpointConfig(interval_s=40,
                                                         mode="region"),
                              device="cpu").run(500)
    assert mt.ckpt_attempts > 0 and len(mt.recoveries) > 0
    assert mt.ckpt_epoch == mt.ckpt_attempts
    _assert_metrics(a.metrics, mt, tol=dict(rtol=1e-5, atol=1e-5),
                    label="numpy")


# ----------------------------------------------------------------------
# the seed batch
# ----------------------------------------------------------------------
def test_run_batch_matches_jax_run_batch():
    kw = dict(host_kill_prob_per_s=0.02, straggler_frac=0.2)
    br = r_run_batch(rnx.ss_arena(n_tasks=168, parallelism=4, n_hosts=8),
                     range(5), duration_s=60, base_spec=RSpec(**kw),
                     phase_mode="pallas")
    bt = te.run_batch(tnx.ss_arena(n_tasks=168, parallelism=4, n_hosts=8),
                      range(5), duration_s=60, base_spec=TSpec(**kw),
                      device="cpu")
    for f in ("source_lag", "qps", "backlog", "emitted_by_job",
              "dropped_by_job", "rollback_t", "thrash_t", "n_rescale",
              "resource_s"):
        np.testing.assert_allclose(getattr(bt, f), getattr(br, f),
                                   err_msg=f, **TOL)
    assert np.array_equal(bt.ckpt_epoch, br.ckpt_epoch)
    assert bt.recoveries == br.recoveries
    # row i of the batch is a standalone run of seed i
    m2 = te.TorchStreamEngine(tnx.ss_arena(n_tasks=168, parallelism=4,
                                           n_hosts=8),
                              chaos=TSpec(seed=2, **kw),
                              device="cpu").run(60)
    _assert_metrics(bt.row(2), m2, tol=dict(rtol=0, atol=0))


# ----------------------------------------------------------------------
# reference inputs through from_reference: drill + autoscaler
# ----------------------------------------------------------------------
def test_drill_and_autoscale_from_reference_match_jax_compact():
    """The reference lowers a canary upgrade whose failover mode differs
    from the base (a ``d_mode_s`` delta that JAX pallas cannot apply)
    plus a DS2 autoscaler; its prepared inputs run through the port's
    tick and match JAX compact, rollback and rescales included."""
    arena = rnx.drill_fleet(n_jobs=4, queue_cap=1e9)
    spec = RSpec(seed=11, host_kill_prob_per_s=0.05,
                 zk_down=((12.0, 18.0),), hdfs_down=((15.0, 22.0),),
                 brownout_at=((5.0, 40.0, 3.0),))
    up = reng.UpgradeConfig(
        t_upgrade_s=10.0, wave_stagger_s=1.0, canary_sel_scale=1.5,
        rollback_threshold=300.0, rollback_window_s=4.0, canary_frac=0.5,
        canary_failover=reng.FailoverConfig(mode="single_task",
                                            detect_s=2.0,
                                            single_restart_s=4.0))
    auto = reng.AutoscaleConfig(interval_s=3.0, cooldown_s=0.0,
                                hysteresis=0.02, ewma_alpha=0.9)
    low = RLowered(arena, n_hosts=16, dt=0.5, queue_cap=1e9,
                   failover=reng.FailoverConfig(mode="region",
                                                region_restart_s=8.0),
                   ckpt=None, seed=0, phase_mode="compact", upgrade=up,
                   upgrade_spec=spec, autoscale=auto)
    assert np.any(low.arrays["d_mode_s"] != 0.0)
    run_fn, _ = get_cached_run_fns(low.desc)
    with _enable_x64():
        st, xs, _ = low.prepare(spec, 120)
        final, ys = run_fn(low.arrays, st, xs)
        want = {k: np.asarray(v) for k, v in ys.items()}
        wfin = {f: np.asarray(getattr(final, f)) for f in final._fields}
    st, xs, _ = low.prepare(spec, 120)
    tfinal, tys = te.run(*te.from_reference(low.arrays, st, xs, "cpu"))
    for k in want:
        np.testing.assert_allclose(tys[k][0].numpy(), want[k], err_msg=k,
                                   **TOL)
    for f in tfinal._fields:
        np.testing.assert_allclose(getattr(tfinal, f)[0].numpy(), wfin[f],
                                   err_msg=f, **TOL)
    assert np.isfinite(wfin["rb_t"]), "the rollback must fire"
    assert wfin["nact"] > 0, "the autoscaler must rescale"
    assert wfin["dropped"].sum() > 0, "the canary must drop records"


# ----------------------------------------------------------------------
# device contract
# ----------------------------------------------------------------------
def test_entry_points_without_device_need_cuda(monkeypatch):
    """``device=None`` means CUDA: without a CUDA device every entry point
    raises instead of running silently on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = tnx.q2(parallelism=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.TorchStreamEngine(g)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.run_batch(g, [0], duration_s=5.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep(g, [0], base_spec=TSpec(), duration_s=5.0)


def test_from_reference_layout():
    """Tensors land on the requested device in float64 (ckpt_epoch
    int32), with a leading seed axis; 0-d params become Python floats."""
    low = te._Lowered(tnx.q2(parallelism=4), n_hosts=4, dt=0.5,
                      queue_cap=256.0, failover=None, ckpt=None, seed=0)
    st, xs, _ = low.prepare(TSpec(seed=1), 10)
    pa, tst, txs = te.from_reference(low.arrays, st, xs, "cpu")
    assert isinstance(pa["dt"], float) and pa["n_ops"] == 2
    assert pa["qcap"].dtype == torch.float64
    assert pa["task_host"].dtype == torch.int64
    assert tst.ckpt_epoch.dtype == torch.int32
    assert all(getattr(tst, f).dtype == torch.float64
               for f in tst._fields if f != "ckpt_epoch")
    assert tst.queue.shape == (1, 8) and txs["kills"].shape == (1, 10, 4)
