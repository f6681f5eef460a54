"""Evaluation metrics (counterpart of :mod:`rri_nmf_tpu.metrics`).

The four metrics take numpy arrays or tensors and compute in torch on
the device of ``X`` (a numpy ``X`` on the CPU); each returns a float. A
sparse ``X`` is densified, as the JAX package's metrics do.
"""

import math

import torch

from rri_nmf_tpu_torch.matrixops import as_tensor, dense


def _operands(X, W, T):
    X = dense(X)
    return (X, as_tensor(W, device=X.device, dtype=X.dtype),
            as_tensor(T, device=X.device, dtype=X.dtype))


def frobenius_relative_error(X, W, T):
    """``||X - WT||_F / ||X||_F`` — the north-star convergence criterion."""
    X, W, T = _operands(X, W, T)
    return float(torch.linalg.norm(X - W @ T) / torch.linalg.norm(X))


def rmse_observed(X, W, T, min_rating=None, max_rating=None):
    """RMSE over the nonzero (observed) entries of X, with optional rating
    clipping (the RS estimator's scoring rule)."""
    X, W, T = _operands(X, W, T)
    I, J = torch.nonzero(X, as_tuple=True)
    pred = (W[I] * T[:, J].T).sum(dim=1)
    if min_rating is not None or max_rating is not None:
        pred = pred.clamp(min_rating, max_rating)
    return float(torch.sqrt(((pred - X[I, J]) ** 2).mean()))


def r2_reconstruction(X, W, T):
    """R² of reconstructing X (reference ``sklearn_interface.py:339-345``)."""
    X, W, T = _operands(X, W, T)
    SST = ((X - X.mean(dim=0)) ** 2).sum()
    SSE = ((X - W @ T) ** 2).sum()
    return float(1 - SSE / SST)


def umass_coherence(X_counts, T, top_n=10, eps=1.0):
    """Mean UMass topic coherence (Mimno et al. 2011): for each topic,
    the mean over pairs of its ``top_n`` words of
    ``log((D(w_i, w_j) + eps) / D(w_j))``, D counting the documents that
    hold the word(s)."""
    occ = dense(X_counts) > 0
    T = as_tensor(T, device=occ.device)
    scores = []
    for t in range(T.shape[0]):
        top = torch.argsort(-T[t], stable=True)[:top_n].tolist()
        pair_scores = []
        for a in range(1, len(top)):
            for b in range(a):
                wi, wj = occ[:, top[a]], occ[:, top[b]]
                d_j = int(wj.sum())
                if d_j == 0:
                    continue
                d_ij = int((wi & wj).sum())
                pair_scores.append(math.log((d_ij + eps) / d_j))
        if pair_scores:
            scores.append(sum(pair_scores) / len(pair_scores))
    return sum(scores) / len(scores) if scores else float('nan')
