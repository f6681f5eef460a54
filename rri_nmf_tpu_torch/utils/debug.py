"""Runtime invariant validation (counterpart of
:mod:`rri_nmf_tpu.utils.debug`).

``nmf()`` calls :func:`validate_factors` after every iteration when
``debug_checks=True``; :class:`MeasureDelta` logs the objective change
around a block when the logger is at DEBUG.
"""

import logging

import torch

logger = logging.getLogger(__name__)


class MeasureDelta(object):
    """Log the change in objective around a block of code (reference
    ``_MeasureDelta``, ``nmf.py:580-609``); ``objective_fn`` takes no
    arguments."""

    def __init__(self, objective_fn, name=None, log=None):
        self.objective_fn = objective_fn
        self.name = name
        self.logger = log or logger

    def __enter__(self):
        self.active = self.logger.getEffectiveLevel() <= logging.DEBUG
        if self.active:
            self.obj = float(self.objective_fn())
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.active and exc_type is None:
            delta = float(self.objective_fn()) - self.obj
            name_s = '{}: '.format(self.name) if self.name else ''
            self.logger.debug('%sdelta = %.2f', name_s, delta)


class FactorValidationError(AssertionError):
    pass


def validate_factors(W, T, w_row_sum=None, t_row_sum=None,
                     project_W_each_iter=False, project_T_each_iter=False,
                     tol=None):
    """Check non-negativity, finiteness and (with per-iteration
    projection) the row sums of ``W``/``T`` tensors; ``tol`` defaults to
    1e-10 for float64 factors and 1e-5 otherwise. Raises
    :class:`FactorValidationError`."""
    if tol is None:
        tol = 1e-10 if W.dtype == torch.float64 else 1e-5
    if not bool(torch.isfinite(W).all()):
        raise FactorValidationError('W contains non-finite entries')
    if not bool(torch.isfinite(T).all()):
        raise FactorValidationError('T contains non-finite entries')
    if float(W.min()) < -tol:
        raise FactorValidationError(
            'W contains negative entries (min=%g)' % float(W.min()))
    if float(T.min()) < -tol:
        raise FactorValidationError(
            'T contains negative entries (min=%g)' % float(T.min()))
    if project_W_each_iter and w_row_sum is not None:
        target = torch.as_tensor(w_row_sum, dtype=W.dtype,
                                 device=W.device).reshape(-1)
        cv = float((W.sum(1) - target).abs().sum())
        if cv > tol * max(1, W.shape[0]):
            raise FactorValidationError(
                'W row-sum constraint violated (aggregate %g)' % cv)
    if project_T_each_iter and t_row_sum is not None:
        cv = float((T.sum(1) - t_row_sum).abs().sum())
        if cv > tol * max(1, T.shape[0]):
            raise FactorValidationError(
                'T row-sum constraint violated (aggregate %g)' % cv)
    return True
