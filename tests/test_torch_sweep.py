"""The port's chaos sweep equals the reference's: per-scenario summaries,
per-job breakdowns of a packed arena, and the fleet aggregate."""
import dataclasses
import math

import pytest

from repro.core.chaos import ChaosSpec as RSpec
from repro.streams import engine as reng
from repro.streams import nexmark as rnx
from repro.streams.chaos_sweep import sweep as r_sweep
from repro_torch.core.chaos import ChaosSpec as TSpec
from repro_torch.streams import engine as teng
from repro_torch.streams import nexmark as tnx
from repro_torch.streams.chaos_sweep import sweep as t_sweep

REL = 1e-12
ABS = 1e-9


def _close(a, b) -> bool:
    if isinstance(a, float) or isinstance(b, float):
        if math.isinf(a) or math.isinf(b):
            return a == b
        return abs(a - b) <= ABS + REL * abs(b)
    return a == b


def _assert_summaries(rt, rr, label):
    assert rt.n_ticks == rr.n_ticks and rt.graph_name == rr.graph_name
    assert len(rt.summaries) == len(rr.summaries)
    for st, sr in zip(rt.summaries, rr.summaries):
        for f in dataclasses.fields(sr):
            a, b = getattr(st, f.name), getattr(sr, f.name)
            assert _close(a, b), (label, st.seed, f.name, a, b)


def _cases(name):
    if name == "packed_ha_drill":
        mk = lambda nx, eng: (  # noqa: E731
            nx.ss_arena(n_tasks=168, parallelism=4, n_hosts=8),
            dict(base_spec=nx.ha_drill_spec(burst_t=20.0,
                                            mq_outage=(40.0, 45.0),
                                            host_kill_prob_per_s=0.01),
                 duration_s=60.0,
                 failover=eng.FailoverConfig(mode="region",
                                             region_restart_s=15.0)))
        return mk(rnx, reng), mk(tnx, teng)
    assert name == "q12_ckpt"
    mk = lambda nx, eng, sp: (  # noqa: E731
        nx.q12(parallelism=8),
        dict(base_spec=sp(host_kill_prob_per_s=0.004, straggler_frac=0.2,
                          storage_slow_prob=0.2),
             duration_s=120.0,
             failover=eng.FailoverConfig(mode="single_task"),
             ckpt=eng.CheckpointConfig(interval_s=20.0)))
    return mk(rnx, reng, RSpec), mk(tnx, teng, TSpec)


@pytest.mark.parametrize("case", ["packed_ha_drill", "q12_ckpt"])
def test_sweep_matches_reference(case):
    (rg, rkw), (tg, tkw) = _cases(case)
    seeds = range(6)
    rr = r_sweep(rg, seeds, phase_mode="pallas", **rkw)
    rt = t_sweep(tg, seeds, device="cpu", **tkw)
    _assert_summaries(rt, rr, case)
    agg_t, agg_r = rt.aggregate(), rr.aggregate()
    for k in agg_r:
        if k != "scenarios_per_s":
            assert _close(agg_t[k], agg_r[k]), (k, agg_t[k], agg_r[k])
    assert (rt.job_results is None) == (rr.job_results is None)
    if rr.job_results is not None:
        assert list(rt.job_results) == list(rr.job_results)
        for name in rr.job_results:
            _assert_summaries(rt.job_results[name], rr.job_results[name],
                              f"{case}/{name}")
    # the cases exercise failures, recoveries and drops
    assert sum(s.n_failures for s in rt.summaries) > 0
    assert rt.prep_s > 0 and rt.device_s > 0 and rt.wall_s > 0
