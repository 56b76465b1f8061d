"""Plain PyTorch version of the fused tick-phase kernel (the CPU path).

Counterpart of ``src/repro/kernels/tick_phase/ref.py``: the row-table
math of the reference's compact tick routing block, batched over a
leading ``(S,)`` seed axis. Pads contribute exact +0.0 to sums and +inf
to head-of-line minima, and every epsilon and fallback select is the
reference's, including the weakhash dummy-entry 0/0 that the fallback
``where`` selects away.

One operand differs from the TPU kernel's: the single-task drop mask
reads the per-tick ``ms_eff`` rows (``mode_single + act * d_mode_s``,
shape ``(S, n_tasks)``) instead of a ``mode_single`` row packed once per
run, so a canary ``d_mode_s`` delta reaches the drop mask exactly as in
the reference's compact tick.
"""
from __future__ import annotations

import torch


def row_sum(vals, idx, mask):
    """``(vals[:, idx] * mask)`` summed along each row, accumulated in
    member order: the order of the reference's row reductions on the CPU
    and of the CUDA kernel's loops, so all three agree bit for bit."""
    g = vals[:, idx] * mask
    acc = g[..., 0]
    for l in range(1, g.shape[-1]):
        acc = acc + g[..., l]
    return acc


def _rmin(vals, idx, mask):
    return torch.where(mask > 0.5, vals[:, idx], torch.inf).amin(-1)


def tick_phase_ref(produced, alive, free, ms_eff, tb, *, has_blk: bool,
                   has_grp: bool):
    """One routing phase over a seed batch.

    ``produced`` / ``alive`` / ``free`` / ``ms_eff`` are ``(S, n_tasks)``
    float64; ``tb`` is the packed table dict from
    `ops.pack_phase_tables`. Returns ``(accepted, dropped_d,
    overflow_e)`` of shapes ``(S, D)`` / ``(S, D)`` / ``(S, E)``."""
    dst, fwd_src, edge_of, grp_of, blk_of = tb["di"]
    (m_fwd, m_blk, m_hash, m_wh, m_bk, is_norm, m_acc_s, m_acc_b,
     dinb, share, mass, qcap_d) = tb["df"]
    alive_d = alive[:, dst]
    free_d = free[:, dst]
    # per-source-op slot totals
    tot_slot = row_sum(produced, tb["s_idx"], tb["s_mask"])
    tot_e = tot_slot[:, tb["soe"]]
    tot_d = tot_e[:, edge_of]
    # forward: pointwise src task → dst task
    arr_fwd = produced[:, fwd_src] * alive_d
    # rescale family: per-block rate over alive destinations
    if has_blk:
        prod_blk = row_sum(produced, tb["bs_idx"], tb["bs_mask"])
        alive_blk = row_sum(alive_d * dinb, tb["br_idx"], tb["br_mask"])
        has = alive_blk > 0.0
        rate_blk = torch.where(
            has, prod_blk / torch.where(has, alive_blk, 1.0), 0.0)
        arr_blk = torch.where(dinb > 0.0, rate_blk[:, blk_of] * alive_d,
                              0.0)
    else:
        arr_blk = torch.zeros_like(alive_d)
    # weakhash: group mass spread ∝ free capacity (fallback to
    # alive-uniform when a whole group is down)
    if has_grp:
        wh = m_wh > 0.5
        cap_w = torch.clamp(free_d, min=1e-9) * alive_d
        alive_eps = alive_d + 1e-9
        capsum = row_sum(torch.where(wh, cap_w, 0.0), tb["gr_idx"],
                         tb["gr_mask"])
        capsum_fb = row_sum(torch.where(wh, alive_eps, 0.0), tb["gr_idx"],
                            tb["gr_mask"])
        fall = capsum <= 0.0
        cap2 = torch.where(fall[:, grp_of], alive_eps, cap_w) * alive_d
        capsum2 = torch.where(fall, capsum_fb, capsum)
        val_wh = cap2 * mass / capsum2[:, grp_of]
    else:
        val_wh = torch.zeros_like(alive_d)
    # backlog: divert away from congested channels
    open_ = (free_d > qcap_d * 0.25).to(produced.dtype)
    val_bk = (torch.clamp(free_d, min=1e-9) * alive_d
              * torch.clamp(open_, min=0.05))
    val_nrm = torch.where(m_wh > 0.5, val_wh,
                          torch.where(m_bk > 0.5, val_bk,
                                      alive_d)) * is_norm
    rs = row_sum(val_nrm, tb["er_idx"], tb["er_mask"])
    ratio_e = torch.where(rs > 0.0, tot_e / rs, 0.0)
    arr_nrm = val_nrm * ratio_e[:, edge_of]
    arriving = torch.where(m_fwd > 0.5, arr_fwd,
                           torch.where(m_blk > 0.5, arr_blk,
                                       torch.where(m_hash > 0.5,
                                                   tot_d * share, arr_nrm)))
    dead_s = (alive_d <= 0.0) & (ms_eff[:, dst] > 0.5)
    dropped_d = torch.where(dead_s, arriving, 0.0)
    arriving = torch.where(dead_s, 0.0, arriving)
    # acceptance: head-of-line / per-block / adaptive credits
    live = arriving > 1e-9
    ratio = torch.where(live, free_d / torch.clamp(arriving, min=1e-300),
                        torch.inf)
    lam_e = torch.clamp(_rmin(ratio, tb["er_idx"], tb["er_mask"]), max=1.0)
    if has_blk:
        lam_b = torch.clamp(_rmin(ratio, tb["br_idx"], tb["br_mask"]),
                            max=1.0)
        acc_blk = arriving * lam_b[:, blk_of]
    else:
        acc_blk = arriving
    accepted = torch.where(m_acc_s > 0.5, arriving * lam_e[:, edge_of],
                           torch.where(m_acc_b > 0.5, acc_blk,
                                       torch.minimum(arriving, free_d)))
    overflow_e = row_sum(arriving - accepted, tb["er_idx"], tb["er_mask"])
    return accepted, dropped_d, overflow_e
