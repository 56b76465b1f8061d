"""Card-only checks of the port: the CUDA tick-phase kernel against its
plain version, and the card path of `run_batch` against the CPU path.

Marked ``cuda``; each test skips without a CUDA device. This file imports
no JAX (the machine with the card has none), so it runs there with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.chaos import ChaosSpec
from repro_torch.kernels.tick_phase import ops, pack_phase_tables
from repro_torch.kernels.tick_phase.ref import tick_phase_ref
from repro_torch.streams import nexmark
from repro_torch.streams.engine import (FailoverConfig, build_plan,
                                        lower_tensor_plan)
from repro_torch.streams.torch_engine import run_batch

TOL = dict(rtol=1e-12, atol=1e-9)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _graphs():
    yield nexmark.ss_arena(n_tasks=168, parallelism=4, n_hosts=8).plan
    for part in ("weakhash", "rescale", "group_rescale", "backlog"):
        yield build_plan(nexmark.q2(parallelism=16, partitioner=part,
                                    n_groups=4), 0.5, 256.0)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    """Every routing phase, the same CUDA tensors, one counted launch
    each; the two accumulate in the same order, so they agree exactly."""
    _need_cuda()
    rng = np.random.default_rng(0)
    for plan in _graphs():
        for ph in lower_tensor_plan(plan).phases:
            if not ph.D:
                continue
            S, n = 8, plan.n_tasks
            rows = [rng.uniform(0, 1, (S, n)) * plan.qcap * 0.02,
                    (rng.uniform(size=(S, n)) > 0.15).astype(float),
                    rng.uniform(0, 1, (S, n)) * plan.qcap * 0.5,
                    (rng.uniform(size=(S, n)) > 0.5).astype(float)]
            rows[1][0, n // 2:] = 0.0
            rows = [torch.as_tensor(r, dtype=torch.float64, device="cuda")
                    for r in rows]
            tb = pack_phase_tables(ph.traced(), plan.qcap, "cuda")
            kw = dict(has_blk=ph.B > 0, has_grp=ph.G > 0)
            before = ops.launches
            got = ops.tick_phase(*rows, tb, **kw)
            assert ops.launches == before + 1
            want = tick_phase_ref(*rows, tb, **kw)
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, **TOL)
                assert torch.equal(g, w)


@pytest.mark.cuda
def test_card_path_matches_cpu_path():
    _need_cuda()
    kw = dict(duration_s=30.0, n_hosts=8,
              base_spec=ChaosSpec(host_kill_prob_per_s=0.02,
                                  straggler_frac=0.2),
              failover=FailoverConfig(mode="single_task"))
    arena = nexmark.ss_arena(n_tasks=168, parallelism=4, n_hosts=8)
    card = run_batch(arena, range(4), device="cuda", **kw)
    cpu = run_batch(arena, range(4), device="cpu", **kw)
    for f in ("source_lag", "qps", "backlog", "emitted_by_job",
              "dropped_by_job", "resource_s"):
        np.testing.assert_allclose(getattr(card, f), getattr(cpu, f),
                                   err_msg=f, **TOL)
    assert card.recoveries == cpu.recoveries
