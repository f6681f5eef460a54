"""The comparison that decides ``correct``: what a timed fit returned
against the plain reference's fit of the same inputs.

Each number has its limit in the cell's file (``workloads/<cell>.json``,
``limits``); a number above its limit, or one that is not finite, makes
the run not correct.

- ``WT_gap``: ‖WT − W_ref T_ref‖_F / ‖W_ref T_ref‖_F, the reconstruction,
  which a pair of nearly equal topics leaves well determined where it
  leaves each factor's split between them ill determined;
- ``W_gap``, ``T_gap``: ‖A − A_ref‖_F / ‖A_ref‖_F of each factor;
- ``sweeps_gap``: |sweeps run − the reference's sweeps| (the stopping
  rules, where a fit has them);
- where the reference predicts (the recommender: the clipped ratings of
  the held-out pairs), ``pred_gap``, the predictions' relative gap, and
  ``rmse_gap``, |RMSE − the reference's RMSE| / the reference's RMSE.
"""

import math

import torch


def rel_gap(a, ref):
    """‖a − ref‖_F / ‖ref‖_F in float64 on ref's device."""
    a = a.to(device=ref.device, dtype=torch.float64)
    ref = ref.to(torch.float64)
    return float((a - ref).norm() / ref.norm().clamp_min(1e-300))


def product_gap(W, T, Wr, Tr, block=4096):
    """‖WT − W_r T_r‖_F / ‖W_r T_r‖_F in float64 on W_r's device, a block
    of rows at a time."""
    dev = Wr.device
    W = W.to(device=dev, dtype=torch.float64)
    T = T.to(device=dev, dtype=torch.float64)
    Wr, Tr = Wr.to(torch.float64), Tr.to(torch.float64)
    num = den = 0.0
    for i in range(0, Wr.shape[0], block):
        P = Wr[i:i + block] @ Tr
        num += float(((W[i:i + block] @ T - P) ** 2).sum())
        den += float((P ** 2).sum())
    return math.sqrt(num / max(den, 1e-300))


def numbers(W, T, sweeps, ref):
    """The compared numbers of a fit ``(W, T, sweeps)`` against the
    reference's ``ref`` (``dict(W, T, sweeps)``)."""
    out = {'WT_gap': product_gap(W, T, ref['W'], ref['T']),
           'W_gap': rel_gap(W, ref['W']),
           'T_gap': rel_gap(T, ref['T']),
           'sweeps_gap': float(abs(int(sweeps) - int(ref['sweeps'])))}
    if 'predict' in ref:
        got, want = ref['predict'](W, T), ref['predict'](ref['W'], ref['T'])
        truth = ref['truth'].to(torch.float64)
        out['pred_gap'] = rel_gap(got, want)
        rmse = float(((got - truth) ** 2).mean().sqrt())
        rmse_ref = float(((want - truth) ** 2).mean().sqrt())
        out['rmse_gap'] = abs(rmse - rmse_ref) / rmse_ref
    return out


def judge(found, limits):
    """``(correct, [(name, value, limit)])`` over the cell's limits."""
    rows = []
    ok = True
    for name, limit in limits.items():
        value = found.get(name, math.nan)
        rows.append((name, value, limit))
        if not (math.isfinite(value) and value <= limit):
            ok = False
    return ok, rows
