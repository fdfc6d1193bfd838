"""QWYC calibration with the per-step candidate sweep on the device, the
counterpart of ``repro.core.qwyc_distributed``.

Algorithm 1's inner loop evaluates every remaining base model as the next
pick: T-r independent (sort + prefix-scan) problems over the active
examples.  ``sweep_candidates`` does all of them at once on the device, as
batched stable sorts along the example axis and cumulative sums, in
float32 (the reference runs without x64, so its sweep is float32 too).
``fit_qwyc_sharded`` is the greedy loop around it, with the host keeping
the running sums in float64 as the reference does.  Its choices equal the
numpy optimizer's (ties broken identically by the stable order), up to
the float32 thresholds.

With a ``mesh`` (a ``launch.mesh.ServingMesh``), the reference shards the
candidate axis over the mesh's last axis whenever its width divides the
candidate count.  The port's mesh is logical shards of one device (ROADMAP
C15), so a mesh only picks that device: each candidate's search is its own
column's, and one sweep over all of them gives the reference's model.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.qwyc import QWYCModel
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import ServingMesh

__all__ = ["sweep_candidates", "fit_qwyc_sharded"]

def _search(vals, err_flag, budget, descending: bool):
    """One side's exact threshold search for every candidate column.

    ``vals`` (n, K) float32, ``err_flag`` (n, K) bool, ``budget`` an int or
    a (K,) int32 tensor.  Returns (thr, n_exit, n_err), each (K,).
    """
    n, k = vals.shape
    key = -vals if descending else vals
    order = torch.sort(key, dim=0, stable=True).indices
    v_sorted = torch.gather(vals, 0, order)
    e_sorted = torch.gather(err_flag, 0, order)
    cum = torch.cumsum(e_sorted.to(torch.int32), dim=0, dtype=torch.int32)
    distinct = torch.cat(
        [v_sorted[1:] != v_sorted[:-1], torch.ones((1, k), dtype=torch.bool, device=vals.device)]
    )
    ok = (cum <= budget) & distinct & torch.isfinite(v_sorted)
    idx = torch.arange(n, dtype=torch.int32, device=vals.device)[:, None]
    best = torch.where(ok, idx, -1).amax(dim=0)
    any_ok = best >= 0
    safe = best.clamp(0, n - 1).long()[None]
    n_exit = torch.where(any_ok, best + 1, 0)
    n_err = torch.where(any_ok, torch.gather(cum, 0, safe)[0], 0)
    last_in = torch.gather(v_sorted, 0, safe)[0]
    first_out = torch.gather(v_sorted, 0, (best + 1).clamp(0, n - 1).long()[None])[0]
    bump = -1.0 if descending else 1.0
    thr = torch.where(
        (best == n - 1) | ~torch.isfinite(first_out),
        last_in + bump,
        0.5 * (last_in + first_out),
    )
    return torch.where(any_ok, thr, math.inf if descending else -math.inf), n_exit, n_err


def sweep_candidates(G, full_pos, budget, mode: str = "both") -> dict:
    """Vectorized Algorithm-2 threshold search for K candidates at once.

    ``G`` (n_active, K) float32 running sums per candidate, ``full_pos``
    (n_active,) bool, both on one device; ``budget`` an int.  Returns a dict
    of (K,) tensors: thr_neg, thr_pos, n_exited, n_errors.
    """
    n, k = G.shape
    fp = full_pos[:, None].expand(n, k)
    thr_neg, nex_neg, nerr_neg = _search(G, fp, int(budget), descending=False)
    if mode == "neg_only":
        thr_pos = torch.full((k,), math.inf, dtype=G.dtype, device=G.device)
        nex_pos = torch.zeros(k, dtype=torch.int32, device=G.device)
        nerr_pos = torch.zeros(k, dtype=torch.int32, device=G.device)
    else:
        exited = G < thr_neg[None, :]
        G_pos = torch.where(exited, -math.inf, G)
        err_pos = ~fp & ~exited
        thr_pos, nex_pos, nerr_pos = _pos_side_with_budgets(
            G_pos, err_pos, int(budget) - nerr_neg
        )
    return {
        "thr_neg": thr_neg,
        "thr_pos": thr_pos,
        "n_exited": nex_neg + nex_pos,
        "n_errors": nerr_neg + nerr_pos,
    }


def _pos_side_with_budgets(vals, err_flag, budgets):
    """Positive-side search with a per-candidate budget vector (exact)."""
    return _search(vals, err_flag, budgets[None, :], descending=True)


def fit_qwyc_sharded(
    scores,
    beta: float = 0.0,
    alpha: float = 0.0,
    mode: str = "both",
    mesh=None,
    device="cuda",
) -> QWYCModel:
    """QWYC Algorithm 1 with the candidate sweep on ``device`` (the card by
    default), or on ``mesh``'s device (see the module docstring).  Each step uploads the active rows' candidate sums
    as float32 and reads back the K thresholds and counts."""
    if mesh is not None and not isinstance(mesh, ServingMesh):
        raise ValueError(
            "mesh= takes a launch.mesh.ServingMesh (ROADMAP A15, C15: logical shards "
            f"of one device), got {type(mesh).__name__}"
        )
    dev = resolve_device(device) if mesh is None else mesh.device
    F = np.asarray(scores, dtype=np.float64)
    n, T = F.shape
    full_pos = F.sum(1) >= beta
    perm = np.arange(T)
    eps_pos = np.full(T, np.inf)
    eps_neg = np.full(T, -np.inf)
    budget = int(np.floor(alpha * n))
    g = np.zeros(n)
    active = np.ones(n, bool)
    exit_step = np.full(n, T, dtype=np.int64)
    exit_pos = np.zeros(n, bool)

    for r in range(T):
        act = np.nonzero(active)[0]
        if act.size == 0:
            break
        cands = perm[r:]
        G = torch.from_numpy((g[act, None] + F[np.ix_(act, cands)]).astype(np.float32)).to(dev)
        fp = torch.from_numpy(full_pos[act]).to(dev)
        res = sweep_candidates(G, fp, budget, mode=mode)
        n_exited = res["n_exited"].cpu().numpy()
        with np.errstate(divide="ignore"):
            J = np.where(n_exited > 0, act.size / np.maximum(n_exited, 1), np.inf)
        k_best = int(np.argmin(J)) if np.isfinite(J).any() else 0
        perm[r], perm[r + k_best] = perm[r + k_best], perm[r]
        t = perm[r]
        thr_neg = float(res["thr_neg"][k_best])
        thr_pos = float(res["thr_pos"][k_best])
        if np.isfinite(thr_neg) and thr_pos < thr_neg:
            thr_pos = thr_neg
        g[act] += F[act, t]
        eps_neg[r], eps_pos[r] = thr_neg, thr_pos
        ga = g[act]
        out_neg = ga < thr_neg
        out_pos = (ga > thr_pos) & ~out_neg
        budget -= int((full_pos[act][out_neg]).sum() + (~full_pos[act][out_pos]).sum())
        newly = out_neg | out_pos
        exit_step[act[newly]] = r + 1
        exit_pos[act[out_pos]] = True
        active[act[newly]] = False

    never = exit_step == T
    exit_pos[never] = full_pos[never]
    cum_cost = np.arange(1, T + 1, dtype=float)
    return QWYCModel(
        order=perm,
        eps_pos=eps_pos,
        eps_neg=eps_neg,
        beta=float(beta),
        costs=np.ones(T),
        alpha=float(alpha),
        mode=mode,
        train_mean_models=float(exit_step.mean()),
        train_mean_cost=float(cum_cost[exit_step - 1].mean()),
        train_diff_rate=float((exit_pos != full_pos).mean()),
    )
