"""The topic-modeling and recommender estimators (counterparts of
:mod:`rri_nmf_tpu.sklearn_interface`).

Both keep the JAX estimators' constructor arguments, presets and
methods. They do not subclass scikit-learn, which the card's machine
does not have: ``get_params``/``set_params`` are their own, over the
same constructor arguments, and the input checks, the validation split
and the COO scatter are plain numpy/torch code. Both take a ``device``
constructor argument: the fit runs there; with ``device=None`` a tensor
fits on its own device and numpy or scipy data on the card (without a
card that raises, naming ``device='cpu'``, how the CPU is asked for).
Fitted ``W``/``T`` are tensors on the device the fit ran on.

- :class:`NMF_TM_Estimator` (``fit``, ``fit_transform``, ``one_iter``,
  ``transform``, ``score``, ``score_all``) runs its default preset (the
  interleaved order with ``'max_resid_document'`` resets; the transform,
  with T fixed, in phase order through kernel B1) and the fast-TM recipe
  (``nmf_kwargs=dict(update_order='phase', reset_topic_method=None)``).
  A sparse X (scipy, or a torch COO/CSR tensor, which fits on its device)
  stays sparse through tf-idf, normalization, the fit
  (``nmf_kwargs['sparse']`` picks the contractions), ``transform`` and
  the scorers; with resets on and the default ``sparse='auto'`` the fit
  and the transform densify it, as in the JAX package.
- :class:`NMF_RS_Estimator` (``fit``, ``fit_from_Xtr``, ``transform``,
  ``predict``, ``score``, ``make_Xpred``, ``sparsify``, ``densify``)
  fits masked WRRI with its default preset: on a dense observation mask,
  or with ``sparse_obs`` on the observed set as scipy CSR (the O(nnz)
  sweeps); its ``transform`` always takes the sparse-mask route, as in
  the JAX estimator.
"""

import math

import numpy as np
import scipy.sparse as sp
import torch

from rri_nmf_tpu_torch.convert import factors_from_numpy
from rri_nmf_tpu_torch.matrixops import (as_tensor, default_float,
                                         fit_device, is_sparse, normalize,
                                         scale_columns,
                                         tfidf, to_torch_sparse)
from rri_nmf_tpu_torch.nmf import nmf
from rri_nmf_tpu_torch.ops.sweep_masked_sparse import host_sparse
from rri_nmf_tpu_torch.ops.sweep_sparse import sparse_cross_term

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


class _Estimator(object):
    """Constructor-argument plumbing shared by the estimators:
    ``get_params``/``set_params`` over ``_PARAMS`` and
    :meth:`from_numpy_state`."""

    _PARAMS = ()

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
        """An estimator holding fitted numpy state (e.g. taken from a
        fitted :mod:`rri_nmf_tpu` estimator with
        :func:`rri_nmf_tpu_torch.convert.numpy_state`): ``state['W']``,
        ``state['T']`` on ``device`` (the constructor argument; default:
        the card, ``'cpu'`` for the CPU) in ``dtype``, and the estimator's
        own fitted attributes (``idf``; ``min_rating``, ``max_rating``)
        where present. ``params`` are constructor arguments; ``n``, ``d``
        and ``k`` default to the factors' shapes."""
        W, T = factors_from_numpy(state['W'], state['T'], device, dtype)
        params = dict(params, device=device)
        params.setdefault('n', W.shape[0])
        params.setdefault('d', T.shape[1])
        params.setdefault('k', T.shape[0])
        params.update(W=W, T=T)
        est = cls(**params)
        est._restore(state)
        return est

    def _restore(self, state):
        """Take this estimator's fitted attributes from ``state``."""


class NMF_TM_Estimator(_Estimator):
    """Topic-modeling NMF estimator (simplex-constrained RRI).

    Parameters are those of :class:`rri_nmf_tpu.sklearn_interface.
    NMF_TM_Estimator`: ``n, d, k`` (documents × dictionary, topics),
    ``wr1, wr2, tr1, tr2`` (L1/L2 regularization of W and T),
    ``handle_tfidf``/``handle_normalization`` (preprocessing),
    ``W``/``T`` (warm starts), ``nmf_kwargs`` (forwarded to
    :func:`rri_nmf_tpu_torch.nmf.nmf`, overriding the presets) and
    ``do_final_project_W``; and the port's ``device``, where ``fit``,
    ``fit_transform`` and ``one_iter`` run (default: a tensor's own
    device, the card for numpy or scipy data).
    """

    _PARAMS = ('n', 'd', 'k', 'wr1', 'wr2', 'tr1', 'tr2', 'random_state',
               'handle_tfidf', 'handle_normalization', 'max_iter', 'W', 'T',
               'nmf_kwargs', 'do_final_project_W', 'device')

    def __init__(self, n, d, k, wr1=0, wr2=0, tr1=0, tr2=0, random_state=0,
                 handle_tfidf=False, handle_normalization=False, max_iter=300,
                 W=np.array([]), T=np.array([]), nmf_kwargs={},
                 do_final_project_W=True, device=None):
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
        self.device = device

    def _restore(self, state):
        if state.get('idf') is not None:
            self.idf = as_tensor(np.asarray(state['idf']),
                                 device=self.W.device, dtype=self.W.dtype)

    def _preprocess(self, X):
        X = X if is_sparse(X) else as_tensor(
            X, device=fit_device(X, self.device))
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
            reg_t_l2=self.tr2, random_state=self.random_state,
            device=self.device)

    def fit_transform(self, X, y=None):
        """Fit on an (n, d) matrix; returns W (reference
        ``sklearn_interface.py:247-282``). A sparse X stays sparse."""
        if is_sparse(X):
            vals = (X.data if not isinstance(X, torch.Tensor) else
                    X.values() if X.layout == torch.sparse_csr
                    else X._values())
            negative = bool((vals < 0).any())
        else:
            X = as_tensor(X, device=fit_device(X, self.device))
            negative = bool((X < 0).any())
        if negative:
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
        learned ``T``. A sparse ``Xnew`` stays sparse (a torch sparse
        tensor on T's device) through the idf and the normalization."""
        T = as_tensor(self.T)
        Xnew = as_tensor(Xnew, device=T.device)
        if self.handle_tfidf:
            Xnew = scale_columns(Xnew, self.idf.to(Xnew.device))
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

    def _sparse_sse(self, X):
        """``(SSE, Σx², SST)`` of the sparse ``X`` on T's device, never
        densified: ``||X - WT||² = Σx² − 2·Σ_nnz X_ij(W_i·T_j) +
        tr((WᵀW)(TTᵀ))`` and ``SST = Σx² − n·Σ_j μ_j²`` (reference
        ``sklearn_interface.py:405-416``)."""
        T = as_tensor(self.T)
        W = self.transform(X)
        T = T.to(W.dtype)
        Xs = to_torch_sparse(X, dtype=W.dtype, device=W.device)
        n, d = Xs.shape
        vals, cols = Xs.values(), Xs.indices()[1]
        mu = torch.zeros(d, dtype=vals.dtype, device=vals.device)
        mu = mu.index_add_(0, cols, vals) / n
        sumsq = (vals ** 2).sum()
        SSE = (sumsq - 2 * sparse_cross_term(Xs, W, T)
               + ((W.T @ W) * (T @ T.T)).sum())
        return float(SSE), float(sumsq), float(sumsq - n * (mu ** 2).sum())

    def score(self, X, y=None):
        """R² of reconstructing new X (reference
        ``sklearn_interface.py:339-345``). A sparse X is scored without
        densifying it."""
        if is_sparse(X):
            SSE, _, SST = self._sparse_sse(X)
            return 1 - SSE / SST
        T = as_tensor(self.T)
        X = as_tensor(X, device=T.device)
        SST = ((X - X.mean(dim=0)) ** 2).sum()
        W = self.transform(X)
        SSE = ((X - W @ T.to(W.dtype)) ** 2).sum()
        return float(1 - SSE / SST)

    def score_all(self, X, X_counts=None, top_n=10):
        """R², relative Frobenius error and (with raw term counts
        ``X_counts``) the mean UMass coherence of the learned topics. A
        sparse X stays sparse (reference ``sklearn_interface.py:
        502-527``)."""
        from rri_nmf_tpu_torch.metrics import (
            frobenius_relative_error, r2_reconstruction, umass_coherence)
        T = as_tensor(self.T)
        if is_sparse(X):
            SSE, sumsq, SST = self._sparse_sse(X)
            out = {'r2': 1 - SSE / SST,
                   'rel_frobenius_error': math.sqrt(max(SSE, 0.0) / sumsq)}
        else:
            X = as_tensor(X, device=T.device)
            W = self.transform(X)
            out = {'r2': r2_reconstruction(X, W, T),
                   'rel_frobenius_error': frobenius_relative_error(X, W,
                                                                   T)}
        if X_counts is not None:
            out['umass_coherence'] = umass_coherence(X_counts, T,
                                                     top_n=top_n)
        return out


# ---------------------------------------------------------------------------
# the recommender estimator
# ---------------------------------------------------------------------------

def train_test_split_indices(q, test_size=0.05, seed=0):
    """``(train, test)`` row indices of ``q`` samples, exactly those of
    ``sklearn.model_selection.train_test_split(..., test_size,
    random_state=seed)``: ``ceil(test_size·q)`` test rows, the first ones
    of ``RandomState(seed).permutation(q)``, the rest for training."""
    n_test = int(math.ceil(test_size * q))
    perm = np.random.RandomState(seed).permutation(q)
    return perm[n_test:], perm[:n_test]


def coo_to_dense_mask(rows, cols, vals, n, d):
    """COO triples (tensors or numpy arrays) as ``(X, M)``, both float32
    (n, d) on the device of ``rows``: X accumulates duplicate pairs, as
    ``np.add.at`` in float32 does, and M is ``X != 0`` — the semantics of
    :func:`rri_nmf_tpu.native.coo_to_dense_mask`."""
    rows = torch.as_tensor(rows).long()
    cols = torch.as_tensor(cols, device=rows.device).long()
    vals = torch.as_tensor(vals, device=rows.device).to(torch.float32)
    if rows.numel() and (bool(rows.min() < 0) or bool(rows.max() >= n) or
                         bool(cols.min() < 0) or bool(cols.max() >= d)):
        raise ValueError('COO indices out of range for shape (%d, %d)'
                         % (n, d))
    X = torch.zeros(n, d, dtype=torch.float32, device=rows.device)
    X.index_put_((rows, cols), vals, accumulate=True)
    return X, (X != 0).to(torch.float32)


def _check_pairs(X, y, device):
    """Plain counterpart of sklearn's ``check_X_y`` for (n_obs, 2) index
    pairs and their ratings: both as tensors on ``device``."""
    X = torch.as_tensor(X if isinstance(X, torch.Tensor) else np.asarray(X),
                        device=device)
    if y is None:
        raise ValueError('y (the ratings) is required')
    y = torch.as_tensor(y if isinstance(y, torch.Tensor) else np.asarray(y),
                        device=device)
    if X.ndim != 2 or X.shape[1] < 2 or X.shape[0] == 0:
        raise ValueError('X must be a non-empty (n_obs, 2) array of index '
                         'pairs, got shape %s' % (tuple(X.shape),))
    if y.ndim != 1 or y.shape[0] != X.shape[0]:
        raise ValueError('y must be 1-D with one rating per pair: %s vs %s'
                         % (tuple(y.shape), tuple(X.shape)))
    if X.is_floating_point() and not bool(torch.isfinite(X).all()):
        raise ValueError('X contains NaN or infinity')
    if y.is_floating_point() and not bool(torch.isfinite(y).all()):
        raise ValueError('y contains NaN or infinity')
    return X, y


def _host(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class NMF_RS_Estimator(_Estimator):
    """Recommender-system NMF estimator (masked WRRI).

    Parameters are those of :class:`rri_nmf_tpu.sklearn_interface.
    NMF_RS_Estimator`: ``n, d, k`` (users × items, topics), ``wr1, tr1``
    (L1 regularization of W and T), ``W``/``T`` (warm starts),
    ``max_iter``, ``nmf_kwargs`` (forwarded to
    :func:`rri_nmf_tpu_torch.nmf.nmf`, overriding the presets),
    ``use_validation_early_stopping`` (hold out 5% of the observations
    and stop when their RMSE rises) and ``sparse_obs`` (True, or
    ``'auto'`` once the dense float64 mask would pass ~2 GB: the
    observed set stays scipy CSR and the fit runs the sparse-mask sweeps
    — the O(nnz) interleaved one by default, the Gram-phase one with
    ``nmf_kwargs=dict(update_order='phase')``); and the port's
    ``device``, where ``fit`` and ``fit_from_Xtr`` run (default: the
    device of tensor pairs, the card for numpy data).
    """

    _PARAMS = ('n', 'd', 'k', 'wr1', 'tr1', 'random_state', 'W', 'T',
               'max_iter', 'nmf_kwargs', 'use_validation_early_stopping',
               'sparse_obs', 'device')

    def __init__(self, n, d, k, wr1=0, tr1=0, random_state=0,
                 W=np.array([]), T=np.array([]), max_iter=30, nmf_kwargs={},
                 use_validation_early_stopping=True, sparse_obs='auto',
                 device=None):
        self.n = n
        self.d = d
        self.k = k
        self.max_iter = max_iter
        self.wr1 = wr1
        self.tr1 = tr1
        self.random_state = random_state
        self.min_rating = None
        self.max_rating = None
        self.Xpred = np.array([])
        self.use_validation_early_stopping = use_validation_early_stopping
        self.W = W
        self.T = T
        self.nmf_kwargs = nmf_kwargs
        self.sparse_obs = sparse_obs
        self.device = device

    def _restore(self, state):
        for key in ('min_rating', 'max_rating'):
            if state.get(key) is not None:
                setattr(self, key, float(state[key]))

    def __getstate__(self):
        """Pickle support: the validation scorer :meth:`fit` makes is a
        closure over the held-out split and is dropped (``None`` after a
        load), as in the JAX estimator."""
        state = dict(self.__dict__)
        if callable(state.get('early_stop')):
            state['early_stop'] = None
        return state

    def sparsify(self):
        """W and T as scipy CSR matrices on the host (the JAX estimator's
        sparse factors); :meth:`densify` brings them back as tensors to
        the device they were on."""
        for name in ('W', 'T'):
            A = getattr(self, name)
            if sp.issparse(A):
                setattr(self, name, A.tocsr())
                continue
            if isinstance(A, torch.Tensor):
                self.factor_device = A.device
            setattr(self, name, sp.csr_matrix(_host(A)))

    def densify(self):
        """Sparse W and T as dense tensors again, on the device
        :meth:`sparsify` took them from (default: the CPU)."""
        device = getattr(self, 'factor_device', torch.device('cpu'))
        for name in ('W', 'T'):
            A = getattr(self, name)
            if sp.issparse(A):
                setattr(self, name, as_tensor(A.toarray(), device=device))

    def _use_sparse_obs(self):
        """``sparse_obs`` resolved: a bool as given; ``'auto'`` once the
        dense (n, d) float64 form passes ~2 GB (the JAX rule)."""
        if isinstance(self.sparse_obs, (bool, np.bool_)):
            return bool(self.sparse_obs)
        return self.n * self.d * 8 > 2e9

    def _coo_matrices(self, I, J, R):
        """``(ratings, mask)`` as scipy CSR from observation triples
        (``rri_nmf_tpu.sklearn_interface.NMF_RS_Estimator._coo_matrices``):
        duplicate pairs sum their ratings, the mask stays binary, and an
        observed rating of 0 stays observed."""
        I, J = _host(I), _host(J)
        ratings = sp.coo_matrix((_host(R).astype(np.float64), (I, J)),
                                shape=(self.n, self.d)).tocsr()
        mask = sp.coo_matrix((np.ones(len(I)), (I, J)),
                             shape=(self.n, self.d)).tocsr()
        mask.data[:] = 1.0
        return ratings, mask

    def _dense_mask(self, I, J, R):
        """``(ratings, mask)`` as dense (n, d) tensors on the pairs'
        device (:func:`coo_to_dense_mask`)."""
        return coo_to_dense_mask(I, J, R, self.n, self.d)

    def fit(self, X, y=None):
        """Fit from ``X`` = (n_obs, 2) index pairs and ``y`` = ratings
        (reference ``sklearn_interface.py:59-128``), on the estimator's
        ``device`` (default: the device of tensor pairs, the card for
        numpy pairs). With ``use_validation_early_stopping`` a
        5% split (scikit-learn's ``train_test_split(test_size=0.05,
        random_state=0)``) is held out and its RMSE, gathered on the
        fit's device, stops the fit when it rises. With ``sparse_obs``
        resolved True the observed set is scipy CSR (:meth:`_coo_matrices`)
        and no (n, d) array exists, on the host or the device."""
        X, y = _check_pairs(X, y, fit_device(X, self.device))
        masks = self._coo_matrices if self._use_sparse_obs() \
            else self._dense_mask
        device = X.device
        dtype = default_float(device)
        self.min_rating = float(y.min())
        self.max_rating = float(y.max())

        if self.use_validation_early_stopping:
            tr, te = (torch.as_tensor(i, device=device)
                      for i in train_test_split_indices(X.shape[0]))
            UItr, UIval, Rtr, Rval = X[tr], X[te], y[tr], y[te]
            Xtr, W_mat_tr = masks(UItr[:, 0], UItr[:, 1], Rtr)
            # gather-based validation RMSE, O(q·k) per check; zero ratings
            # are dropped, as the reference's Xv.nonzero() does
            vnz = Rval != 0
            Iv = UIval[vnz, 0].long()
            Jv = UIval[vnz, 1].long()
            Rv = Rval[vnz].to(dtype)
            lo, hi = self.min_rating, self.max_rating

            def RMSE_val(X_ignored, W, T):
                pred = (W[Iv] * T[:, Jv].T).sum(1).clamp(lo, hi)
                return float(torch.sqrt(((pred - Rv.to(pred.dtype)) ** 2)
                                        .mean()))

            self.early_stop = RMSE_val
        else:
            self.early_stop = False
            Xtr, W_mat_tr = masks(X[:, 0], X[:, 1], y)

        soln = nmf(Xtr, self.k, **_merged(
            dict(max_iter=self.max_iter, max_time=7200,
                 compute_obj_each_iter=True, reset_topic_method=None,
                 early_stop=self.early_stop, project_T_each_iter=False,
                 t_row_sum=1.0, project_W_each_iter=False, w_row_sum=None,
                 W_mat=W_mat_tr, device=device, dtype=dtype,
                 W_in=self.W if _size(self.W) > 0 else [],
                 T_in=self.T if _size(self.T) > 0 else [],
                 reg_w_l1=self.wr1, reg_t_l1=self.tr1,
                 random_state=self.random_state),
            self.nmf_kwargs))
        self.W = soln.pop('W')
        self.T = soln.pop('T')
        self.Xpred = np.array([])
        self.nmf_outputs = soln
        return self

    def fit_from_Xtr(self, Xtr):
        """Fit from a ratings matrix: its nonzeros, in row-major order,
        become the (pair, rating) observations (reference
        ``sklearn_interface.py:130-142``), on the estimator's ``device``
        (default: a tensor's own device, the card for numpy or scipy)."""
        if hasattr(Xtr, 'tocsr'):
            Xtr = Xtr.tocsr()
            I, J = Xtr.nonzero()
            return self.fit(np.stack([I, J], axis=1),
                            np.asarray(Xtr[I, J]).ravel())
        Xtr = as_tensor(Xtr, device=fit_device(Xtr, self.device))
        I, J = torch.nonzero(Xtr, as_tuple=True)
        return self.fit(torch.stack([I, J], dim=1), Xtr[I, J])

    def transform(self, Xnew):
        """Express the ratings ``Xnew`` (dense, scipy-sparse or a torch
        tensor) in the learned topics: four fixed-T masked sweeps with the
        JAX estimator's transform preset (``reset_topic_method='random'``
        for dead topics), on the device of the learned ``T``. As in the
        JAX estimator the indicator mask of ``Xnew``'s nonzeros is always
        scipy-sparse, so the sweep is the O(nnz) sparse-mask one and only
        the observed entries reach the device."""
        T = self._dense_T()
        X_h = host_sparse(Xnew)
        if sp.issparse(X_h):
            W_mat = X_h.tocsr().copy()
            W_mat.eliminate_zeros()      # the dense nonzero() semantics
            W_mat.data = np.ones_like(W_mat.data)
        else:
            X_h = np.asarray(X_h)
            W_mat = sp.csr_matrix(X_h != 0).astype(
                np.result_type(X_h.dtype, np.float32))
        soln = nmf(X_h, self.k, **_merged(
            dict(max_iter=4, max_time=7200,
                 project_W_each_iter=False, project_T_each_iter=False,
                 W_mat=W_mat, T_in=T, fix_T=True, device=T.device,
                 reg_w_l1=self.wr1, reg_t_l1=self.tr1, t_row_sum=1.0,
                 w_row_sum=None, reset_topic_method='random',
                 random_state=self.random_state),
            self.nmf_kwargs, drop=_TRANSFORM_DROPPED_KWARGS))
        return soln['W']

    def _factors(self):
        """W and T as dense tensors on T's device (scipy factors from
        :meth:`sparsify` densified on the device they came from)."""
        if _size(self.W) == 0 or _size(self.T) == 0:
            raise ValueError('this NMF_RS_Estimator is not fitted yet')
        T = self._dense_T()
        return as_tensor(self._dense(self.W), device=T.device,
                         dtype=T.dtype), T

    def _dense(self, A):
        if sp.issparse(A):
            return as_tensor(A.toarray(), device=getattr(
                self, 'factor_device', torch.device('cpu')))
        return A

    def _dense_T(self):
        return as_tensor(self._dense(self.T))

    def make_Xpred(self):
        """Materialize and cache the full clipped (n, d) prediction
        matrix, on the fitted factors' device. Optional: :meth:`predict`
        gathers per pair and uses this cache only when it exists."""
        if _size(self.Xpred) == 0:
            W, T = self._factors()
            self.Xpred = (W @ T).clamp(self.min_rating, self.max_rating)

    def _predict_pairs(self, I, J):
        if _size(self.Xpred) > 0:
            return self.Xpred[I, J]
        W, T = self._factors()
        return (W[I] * T[:, J].T).sum(1).clamp(self.min_rating,
                                               self.max_rating)

    def predict(self, X):
        """Predicted ratings ``clip((W·T)_ij)`` for the (i, j) index
        pairs ``X``, as a numpy array: per-pair gathers on the factors'
        device, O(q·k) for q pairs."""
        W, _ = self._factors()
        X = torch.as_tensor(
            X if isinstance(X, torch.Tensor) else np.asarray(X),
            device=W.device)
        return self._predict_pairs(X[:, 0].long(), X[:, 1].long()) \
            .cpu().numpy()

    def score(self, X, y=np.array([])):
        """RMSE of the predictions (reference
        ``sklearn_interface.py:172-182``): of the pairs ``X`` against the
        ratings ``y`` when given, else of the nonzeros of the ratings
        matrix ``X``."""
        W, _ = self._factors()
        if _size(y) > 0:
            yh = self.predict(X)
            y = y.cpu().numpy() if isinstance(y, torch.Tensor) \
                else np.asarray(y)
            return float(np.sqrt(np.mean((y - yh) ** 2)))
        if hasattr(X, 'toarray'):
            X = X.toarray()
        X = as_tensor(X, device=W.device)
        I, J = torch.nonzero(X, as_tuple=True)
        yh = self._predict_pairs(I, J)
        return float(torch.sqrt(((X[I, J].to(yh.dtype) - yh) ** 2).mean()))
