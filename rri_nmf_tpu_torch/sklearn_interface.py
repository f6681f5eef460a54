"""The topic-modeling estimator (counterpart of
:mod:`rri_nmf_tpu.sklearn_interface`).

:class:`NMF_TM_Estimator` keeps the JAX estimator's constructor
arguments, presets and methods (``fit``, ``fit_transform``, ``one_iter``,
``transform``, ``score``, ``score_all``) on dense X. It does not subclass
scikit-learn: ``get_params``/``set_params`` are its own, over the same
constructor arguments. Fitted ``W``/``T`` are tensors on the device the
fit ran on (a numpy ``X`` fits on the CPU, a CUDA tensor on its card).

This slice runs the fast-TM recipe only: pass
``nmf_kwargs=dict(update_order='phase', reset_topic_method=None)``. The
estimator's default preset (interleaved order with resets) raises
``NotImplementedError`` until ROADMAP A.2. ``NMF_RS_Estimator`` arrives
with the masked slice (ROADMAP A.7).
"""

import numpy as np
import torch

from rri_nmf_tpu_torch.convert import factors_from_numpy
from rri_nmf_tpu_torch.matrixops import as_tensor, normalize, tfidf
from rri_nmf_tpu_torch.nmf import nmf

# nmf() kwargs dropped from the TRANSFORM presets (fixed-T sweeps over new
# data) so one nmf_kwargs dict serves fit and transform; see
# rri_nmf_tpu.sklearn_interface._TRANSFORM_DROPPED_KWARGS.
_TRANSFORM_DROPPED_KWARGS = ('accel', 'checkpoint', 'checkpoint_every',
                             'T_in', 'W_in', 'W_mat', 'fix_T', 'fix_W')


def _merged(preset, nmf_kwargs, drop=()):
    """Layer user ``nmf_kwargs`` over an estimator preset (user values
    override preset keys)."""
    merged = dict(preset)
    merged.update((k, v) for k, v in nmf_kwargs.items() if k not in drop)
    return merged


def _size(a):
    return a.numel() if isinstance(a, torch.Tensor) else int(np.size(a))


class NMF_TM_Estimator(object):
    """Topic-modeling NMF estimator (simplex-constrained RRI).

    Parameters are those of :class:`rri_nmf_tpu.sklearn_interface.
    NMF_TM_Estimator`: ``n, d, k`` (documents × dictionary, topics),
    ``wr1, wr2, tr1, tr2`` (L1/L2 regularization of W and T),
    ``handle_tfidf``/``handle_normalization`` (preprocessing),
    ``W``/``T`` (warm starts), ``nmf_kwargs`` (forwarded to
    :func:`rri_nmf_tpu_torch.nmf.nmf`, overriding the presets) and
    ``do_final_project_W``.
    """

    _PARAMS = ('n', 'd', 'k', 'wr1', 'wr2', 'tr1', 'tr2', 'random_state',
               'handle_tfidf', 'handle_normalization', 'max_iter', 'W', 'T',
               'nmf_kwargs', 'do_final_project_W')

    def __init__(self, n, d, k, wr1=0, wr2=0, tr1=0, tr2=0, random_state=0,
                 handle_tfidf=False, handle_normalization=False, max_iter=300,
                 W=np.array([]), T=np.array([]), nmf_kwargs={},
                 do_final_project_W=True):
        self.n = n
        self.d = d
        self.k = k
        self.wr1 = wr1
        self.wr2 = wr2
        self.tr1 = tr1
        self.tr2 = tr2
        self.random_state = random_state
        self.handle_tfidf = handle_tfidf
        self.handle_normalization = handle_normalization
        self.max_iter = max_iter
        self.W = W
        self.T = T
        self.nmf_kwargs = nmf_kwargs
        self.do_final_project_W = do_final_project_W

    def get_params(self, deep=True):
        """The constructor arguments, by name (scikit-learn's contract)."""
        return {p: getattr(self, p) for p in self._PARAMS}

    def set_params(self, **params):
        """Set constructor arguments by name; returns the estimator."""
        unknown = set(params) - set(self._PARAMS)
        if unknown:
            raise ValueError('unknown parameters %s (valid: %s)'
                             % (sorted(unknown), list(self._PARAMS)))
        for name, value in params.items():
            setattr(self, name, value)
        return self

    @classmethod
    def from_numpy_state(cls, state, device=None, dtype=None, **params):
        """An estimator holding fitted numpy state: ``state['W']``,
        ``state['T']`` and, when present, ``state['idf']`` (e.g. taken
        from a fitted :mod:`rri_nmf_tpu` estimator), placed on ``device``
        in ``dtype``. ``params`` are constructor arguments; ``n``, ``d``
        and ``k`` default to the factors' shapes."""
        W, T = factors_from_numpy(state['W'], state['T'], device, dtype)
        params = dict(params)
        params.setdefault('n', W.shape[0])
        params.setdefault('d', T.shape[1])
        params.setdefault('k', T.shape[0])
        params.update(W=W, T=T)
        est = cls(**params)
        if state.get('idf') is not None:
            est.idf = as_tensor(np.asarray(state['idf']), device=W.device,
                                dtype=W.dtype)
        return est

    def _preprocess(self, X):
        X = as_tensor(X)
        if self.handle_tfidf:
            X, self.idf = tfidf(X, return_idf=True)
        if self.handle_normalization:
            X = normalize(X)
        return X

    def _fit_preset(self, max_iter, max_time):
        return dict(
            max_iter=max_iter, max_time=max_time,
            project_W_each_iter=False, w_row_sum=1.0,
            project_T_each_iter=True, t_row_sum=1.0,
            do_final_project_W=self.do_final_project_W,
            W_in=self.W if _size(self.W) > 0 else [],
            T_in=self.T if _size(self.T) > 0 else [],
            reg_w_l1=self.wr1, reg_w_l2=self.wr2, reg_t_l1=self.tr1,
            reg_t_l2=self.tr2, random_state=self.random_state)

    def fit_transform(self, X, y=None):
        """Fit on an (n, d) matrix; returns W (reference
        ``sklearn_interface.py:247-282``)."""
        X = as_tensor(X)
        if bool((X < 0).any()):
            raise ValueError('X must be non-negative')
        preset = self._fit_preset(self.max_iter, 7200)
        soln = nmf(self._preprocess(X), self.k,
                   **_merged(preset, self.nmf_kwargs))
        self.W = soln.pop('W')
        self.T = soln.pop('T')
        self.nmf_outputs = soln
        return self.W

    def one_iter(self, X):
        """Advance the fit by exactly one iteration; stepped fits compose
        exactly with batch fits (reference
        ``sklearn_interface.py:284-314``)."""
        preset = self._fit_preset(1, 240)
        soln = nmf(self._preprocess(X), self.k,
                   **_merged(preset, self.nmf_kwargs))
        self.W = soln.pop('W')
        self.T = soln.pop('T')
        self.nmf_outputs = soln
        return self

    def fit(self, X, y=None):
        self.fit_transform(X, y)
        return self

    def transform(self, Xnew):
        """Express ``Xnew`` in the learned topics: a few fixed-T sweeps
        (reference ``sklearn_interface.py:320-334``), on the device of the
        learned ``T``."""
        T = as_tensor(self.T)
        Xnew = as_tensor(Xnew, device=T.device)
        if self.handle_tfidf:
            Xnew = Xnew * self.idf
        if self.handle_normalization:
            Xnew = normalize(Xnew)
        soln = nmf(Xnew, self.k, **_merged(
            dict(max_iter=4, max_time=7200,
                 project_W_each_iter=False, w_row_sum=1.0,
                 t_row_sum=1.0, T_in=T,
                 do_final_project_W=self.do_final_project_W,
                 fix_T=True, reg_w_l1=self.wr1, reg_w_l2=self.wr2,
                 reg_t_l1=self.tr1, reg_t_l2=self.tr2,
                 random_state=self.random_state),
            self.nmf_kwargs, drop=_TRANSFORM_DROPPED_KWARGS))
        return soln['W']

    def constrained_transform(self, X):
        return self.transform(X)

    def score(self, X, y=None):
        """R² of reconstructing new X (reference
        ``sklearn_interface.py:339-345``)."""
        T = as_tensor(self.T)
        X = as_tensor(X, device=T.device)
        SST = ((X - X.mean(dim=0)) ** 2).sum()
        W = self.transform(X)
        SSE = ((X - W @ T.to(W.dtype)) ** 2).sum()
        return float(1 - SSE / SST)

    def score_all(self, X, X_counts=None, top_n=10):
        """R², relative Frobenius error and (with raw term counts
        ``X_counts``) the mean UMass coherence of the learned topics."""
        from rri_nmf_tpu_torch.metrics import (
            frobenius_relative_error, r2_reconstruction, umass_coherence)
        T = as_tensor(self.T)
        X = as_tensor(X, device=T.device)
        W = self.transform(X)
        out = {'r2': r2_reconstruction(X, W, T),
               'rel_frobenius_error': frobenius_relative_error(X, W, T)}
        if X_counts is not None:
            out['umass_coherence'] = umass_coherence(X_counts, T,
                                                     top_n=top_n)
        return out
