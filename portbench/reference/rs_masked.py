"""Plain reference of the recommender estimator's default fit: weighted
rank-one residue iteration (Ho, 2008, the masked form) on a dense
observation mask, with 5% of the ratings held out to stop the fit when
their error rises.

What the estimator derives from the ratings, worked out again:

- the split: ``ceil(0.05·q)`` held-out ratings, the first of numpy's
  ``RandomState(0).permutation(q)`` (scikit-learn's ``train_test_split``);
- the training ratings X (n, d) and the mask M = (X ≠ 0);
- the start: NNDSVD of M⊙X, T's rows scaled to sum 1.

Each iteration first scores the held-out pairs (RMSE of the predictions
clipped to the range of all ratings); a score above the last one rolls
the fit back to the factors it was scored on and stops it. Then a sweep,
per topic t with R = X − WT (formed at the sweep's start, kept current
with rank-one updates):

- T side: ``nw = (w²)ᵀM``, ``wR = wᵀ(M⊙R) + T[t]·nw``, the row
  ``min([wR]₊ / (nw + eps), 1)`` (0 where nw = 0), W's column scaled by
  the row's sum (the scale transfer);
- W side: ``m = M t²``, ``Rt = (M⊙R) t + w·m``, the column
  ``[Rt]₊ / (m + eps)`` (0 where m = 0).

After the sweep the objective ``0.5‖M⊙(X − WT)‖²`` is recorded, and the
fit stops once its last change is at most 1e-4 of its first.
"""

import math

import numpy as np
import torch

from portbench.reference.plain import EPS, Precision, nndsvd, normalize_rows


def held_out(q, test_size=0.05):
    """How many of q ratings the split holds out."""
    return int(math.ceil(test_size * q))


def split(q, test_size=0.05):
    """``(train, test)`` positions of q ratings."""
    n_test = held_out(q, test_size)
    perm = np.random.RandomState(0).permutation(q)
    return perm[n_test:], perm[:n_test]


def training(pairs, ratings, n, d, dtype, device):
    """``(X, M, held-out (I, J, r), (lo, hi))`` on ``device``."""
    tr, te = split(len(ratings))
    I = torch.as_tensor(pairs[:, 0], device=device).long()
    J = torch.as_tensor(pairs[:, 1], device=device).long()
    r = torch.as_tensor(ratings, dtype=torch.float64, device=device)
    tr = torch.as_tensor(tr, device=device)
    te = torch.as_tensor(te, device=device)
    X = torch.zeros(n, d, dtype=torch.float64, device=device)
    X.index_put_((I[tr], J[tr]), r[tr], accumulate=True)
    M = (X != 0).to(torch.float64)
    keep = r[te] != 0
    held = (I[te][keep], J[te][keep], r[te][keep])
    return X.to(dtype), M.to(dtype), held, (float(r.min()), float(r.max()))


def sweep(X, M, W, T, p):
    """One masked interleaved sweep in place."""
    k = W.shape[1]
    R = X - p.mm(W, T)
    for t in range(k):
        w = W[:, t].clone()
        nw = p.mm(w * w, M)
        wR = p.mm(w, M * R) + T[t] * nw
        row = torch.where(nw > 0, wR.clamp_min(0) / (nw + EPS), 0.0)
        row = row.clamp_max(1.0)
        w_eff = w * row.sum()
        R += torch.outer(w, T[t]) - torch.outer(w_eff, row)
        T[t] = row
        m = p.mm(M, row * row)
        Rt = p.mm(M * R, row) + w_eff * m
        w_new = torch.where(m > 0, Rt.clamp_min(0) / (m + EPS), 0.0)
        R += torch.outer(w_eff - w_new, row)
        W[:, t] = w_new


def fit(inputs, config, preset, random_state, device, precision='float64'):
    """The fit of ``inputs = (pairs, ratings)``: ``dict(W, T, sweeps)``."""
    p = Precision(precision)
    n, d, k = int(config['n']), int(config['d']), int(config['k'])
    X, M, (Iv, Jv, rv), (lo, hi) = training(*inputs, n, d, torch.float64,
                                            device)
    W, H = nndsvd(M * X, k, random_state)
    T = normalize_rows(H).clamp_min(0)
    W = W.clamp_min(0)
    X, M, W, T = (a.to(p.dtype) for a in (X, M, W, T))

    def predict(W, T):
        """The clipped predictions of the held-out pairs (what the
        estimator's ``predict`` gives), in float64."""
        W, T = W.to(device, torch.float64), T.to(device, torch.float64)
        return (W[Iv] * T[:, Jv].T).sum(1).clamp(lo, hi)

    def rmse(W, T):
        return float(torch.sqrt(((predict(W, T) - rv) ** 2).mean()))

    eps_stop = float(preset.get('eps_stop', 1e-4))
    last = math.inf
    objs = []
    for _ in range(int(preset['max_iter'])):
        score = rmse(W, T)
        if score > last:
            W, T = W_prev, T_prev
            objs.pop()
            break
        last = score
        W_prev, T_prev = W.clone(), T.clone()
        sweep(X, M, W, T, p)
        objs.append(0.5 * float((M * (X - p.mm(W, T)) ** 2).sum()))
        if len(objs) > 1 and abs(objs[-1] - objs[-2]) <= eps_stop * abs(
                objs[0] - objs[1]):
            break
    return dict(W=W, T=T, sweeps=len(objs), predict=predict, truth=rv)


def sweep_counts(config, preset, inputs):
    """``(ops, bytes)`` a sweep needs over the training ratings of
    ``inputs = (pairs, ratings)`` (all of them less those the split
    holds out): per topic a pass
    over them (value and column index, the row pointers) and over the
    factors (read and written once); per topic the two numerators, the
    two curvatures and the two rank-one residual updates (2·nnz each),
    and once a sweep the objective (3·nnz)."""
    n, d, k = int(config['n']), int(config['d']), int(config['k'])
    q = len(inputs[1])
    nnz = q - held_out(q)
    ops = k * 12 * nnz + 3 * nnz
    nbytes = k * (nnz * 8 + (n + 1) * 4 + 2 * (n * k + k * d) * 4)
    return ops, nbytes
