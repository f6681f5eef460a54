"""Per-topic quadratic subproblem solver and stopping conditions.

Counterpart of :mod:`rri_nmf_tpu.optimization`: ``qf_min`` solves

    min_{0 <= x <= ub, sum(x) = s}  w^T x + 0.5 x^T diag(c) x

in closed form, with the reference's branch semantics
(``optimization.py:42-88``) kept branch by branch:

- scalar ``c > 0``: ``x = [-w]_+ / (c + eps)``; the returned norm is the
  pre-projection l1 norm; simplex-project only when ``s`` is given; ``ub``
  is NOT enforced on this branch;
- scalar ``c <= 0``: vertex solution — with ``s`` all mass on the first
  ``argmin(w)``; without it, coordinates with ``w + c < 0`` saturate at
  ``ub``; the returned norm is 1.0;
- vector ``c``: ``[-w]_+ / c`` on the ``c > 0`` coordinates, clip to
  ``ub``, rescale (guarded against a zero sum) to ``s``.

The scalar branches are the per-topic update the dense kernels run
(:mod:`rri_nmf_tpu_torch.ops.dense_kernels`). Both curvature branches are
computed and selected with ``torch.where``, so a device ``c`` needs no
host round trip.
"""

import numpy as np
import torch

from rri_nmf_tpu_torch.matrixops import (EPS_DIV_BY_ZERO, _proj_simplex_core,
                                         as_tensor)


def _normalize_ub(s, ub):
    """Reference ``optimization.py:43-49``: reconcile sum and upper bounds
    (static numbers or None; truthiness gates, like the reference)."""
    if s:
        if ub:
            return min(ub, s)
        return s
    return ub


def _ub_eff(s, ub, like):
    if ub is None or np.isscalar(ub):
        return _normalize_ub(s, ub)
    ub = as_tensor(ub, device=like.device, dtype=like.dtype).reshape(-1)
    return ub.clamp_max(s) if s else ub


def qf_min_scalar_free(numer, c, ub, zeros=None, norm=True):
    """``qf_min_scalar_c(-numer, c, None, ub)``: the scalar-curvature
    subproblem without a sum constraint, taking the negated linear term
    ``numer`` (what the sweeps compute) and ``c`` a 0-d tensor.

    ``[numer]₊ / (c + eps)`` where ``c > 0``; else ``ub`` (inf when None)
    on the coordinates where ``numer > c`` (that is ``w + c < 0``), 0
    elsewhere. The per-topic sweeps call it twice a topic, so it makes
    few launches: ``zeros`` (a zero vector shaped as ``numer``) may be
    passed in, and ``norm=False`` skips the norm. Returns ``(x, nx)``, or
    ``x`` without ``norm``."""
    pos = c > 0
    x_pos = numer.clamp_min(0.0).div_(c + EPS_DIV_BY_ZERO)
    if zeros is None:
        zeros = torch.zeros_like(numer)
    x = torch.where(pos, x_pos, torch.where(
        numer > c, float('inf') if ub is None else ub, zeros))
    if not norm:
        return x
    return x, torch.where(pos, x_pos.sum(), 1.0)


def qf_min_scalar_c(w, c, s, ub):
    """qf_min for a scalar curvature ``c`` (a number or 0-d tensor).

    ``s`` is a number or None; ``ub`` a number, None or a per-coordinate
    vector. Returns ``(x, nx)`` with the reference's norm contract."""
    c = torch.as_tensor(c, dtype=w.dtype, device=w.device)
    ub_eff = _ub_eff(s, ub, w)
    if s is None:
        return qf_min_scalar_free(-w, c, ub_eff)

    x_pos = (-w).clamp_min(0.0) / (c + EPS_DIV_BY_ZERO)
    nx_pos = x_pos.sum()
    x_pos = _proj_simplex_core(x_pos, s)
    # the vertex is scattered: indexing by a 0-d tensor would read it on
    # the host
    x_neg = torch.zeros_like(w).scatter_(
        0, torch.argmin(w).reshape(1), float(s))
    pos = c > 0
    return torch.where(pos, x_pos, x_neg), torch.where(pos, nx_pos, 1.0)


def qf_min_vector_c(w, c, s, ub):
    """qf_min for a per-coordinate curvature ``c`` (WRRI path, reference
    ``optimization.py:75-88``)."""
    ub_eff = _ub_eff(s, ub, w)
    pos = c > 0
    denom_safe = torch.where(pos, c, 1.0) + EPS_DIV_BY_ZERO
    x = torch.where(pos, (-w).clamp_min(0.0) / denom_safe, 0.0)
    if isinstance(ub_eff, torch.Tensor):
        x = torch.minimum(x, ub_eff)
    elif ub_eff is not None:
        # a number bounds in place: a scalar tensor made on the card would
        # be a host-to-device copy, which waits for the stream
        x = x.clamp_max(ub_eff)
    nx = x.sum()
    if s is not None:
        x = torch.where(nx > 0, s * x / torch.where(nx > 0, nx, 1.0), x)
    return x, nx


def qf_min(w, c, s=1.0, ub=1.0, x0=None):
    """Minimize ``w^T x + 0.5 x^T diag(c) x`` over ``{0 <= x <= ub,
    sum x = s}``; returns ``(x, nx)``, ``nx`` the l1 norm of ``x`` before
    the final projection/rescale (the reference's contract,
    ``optimization.py:12-88``). Raises ``ValueError`` for unbounded
    configurations and ``NotImplementedError`` for a concave objective
    whose sum constraint meets a binding upper bound, like
    :func:`rri_nmf_tpu.optimization.qf_min`."""
    w = as_tensor(w)
    d = w.numel()
    _ub_vec = ub is not None and not np.isscalar(ub)
    ub_full = (np.broadcast_to(np.asarray(ub, dtype=float).reshape(-1),
                               (d,)) if _ub_vec else None)
    if s and ub is not None:
        cap = (float(np.sum(np.minimum(ub_full, s))) if _ub_vec
               else d * min(float(ub), s))
        if cap < s:
            raise ValueError('Impossible to satisfy sum and upper bound '
                             'constraints.')

    if np.isscalar(c) or np.ndim(c) == 0:
        c = float(c)
        if c <= 0 and s is None and ub is None:
            raise ValueError(
                'Minimum objective is unbounded. w={w}, c={c}, s={s}, ub={ub}'
                .format(w=w, c=c, s=s, ub=ub))
        if c <= 0 and s is not None and ub is not None:
            ub_min = float(np.min(ub_full)) if _ub_vec else float(ub)
            if ub_min < s:
                raise NotImplementedError(
                    'qf_min: concave objective with a sum constraint and '
                    'binding upper bounds (ub < s) is not supported')
        return qf_min_scalar_c(w, c, s, ub)
    if np.shape(w) == tuple(np.shape(c)):
        c = as_tensor(c, device=w.device, dtype=w.dtype)
        if bool((c < 0).any()) and (s is None and ub is None):
            raise ValueError(
                'Minimum objective is unbounded. w={w}, c={c}, s={s}, ub={ub}'
                .format(w=w, c=c, s=s, ub=ub))
        return qf_min_vector_c(w, c, s, ub)
    raise ValueError('c must be a scalar or have the shape of w')


def universal_stopping_condition(obj_history, eps_stop=1e-4):
    """Stop when the last objective change is <= ``eps_stop`` × the first
    change (reference ``optimization.py:284-291``)."""
    if len(obj_history) < 2:
        return False
    d1 = abs(obj_history[0] - obj_history[1])
    de = abs(obj_history[-1] - obj_history[-2])
    return de <= eps_stop * d1


def first_last_stopping_condition(obj_history, eps_stop=1e-4):
    """Stop when the objective has shrunk to ``eps_stop`` × its initial
    value (reference ``optimization.py:294-297``)."""
    if len(obj_history) < 2:
        return False
    return obj_history[-1] <= obj_history[0] * eps_stop
