"""Leaf-layer tensor math: simplex projections, normalization, tfidf,
and the label and stacking helpers.

Counterpart of :mod:`rri_nmf_tpu.matrixops`. The JAX package projects one
row with ``_proj_simplex_core`` and ``vmap``s it over a matrix; here the
Duchi projection is written batched over rows (the last axis is the
projected vector). Functions take numpy arrays or tensors and return
tensors: numpy input lands on the CPU, a tensor stays on its device.

Sparse input stays sparse in :func:`normalize` and :func:`tfidf` (the
sparse corpora path): a scipy-sparse matrix comes back scipy-sparse,
computed as the JAX package computes it, and a torch sparse tensor comes
back a torch sparse tensor of its layout on its device. The projections
and :func:`normalize_l2` densify sparse input, as the JAX package does.
"""

import numpy as np
import torch

# Added to denominators to avoid division by zero; the reference's constant
# (np.spacing(10)), added in the working dtype like the JAX package does.
EPS_DIV_BY_ZERO = float(np.spacing(10))


def default_float(device):
    """The default working float for ``device``: float64 on the CPU (the
    parity tests hold the port against JAX with x64 there), float32 on
    CUDA — the JAX package's ``nmf._default_float`` policy."""
    return torch.float64 if torch.device(device).type == 'cpu' \
        else torch.float32


def fit_device(X, device=None):
    """The device an entry point runs on for the input ``X``: ``device``
    when given; else a tensor's own device (the caller chose it); else,
    for numpy, scipy or list data, the card. Host data with no
    ``device`` and no card raises: the port runs on the card unless asked
    for the CPU with ``device='cpu'``."""
    if device is not None:
        return torch.device(device)
    if isinstance(X, torch.Tensor):
        return X.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: rri_nmf_tpu_torch runs on the card unless "
            "asked otherwise; pass device='cpu' to run on the CPU")
    return torch.device('cuda', torch.cuda.current_device())


def is_scipy_sparse(X):
    return (not isinstance(X, torch.Tensor) and hasattr(X, 'tocoo')
            and hasattr(X, 'toarray'))


def is_torch_sparse(X):
    return isinstance(X, torch.Tensor) and X.layout in (torch.sparse_coo,
                                                        torch.sparse_csr)


def is_sparse(X):
    """Whether ``X`` is a scipy-sparse matrix or a torch sparse tensor
    (COO or CSR)."""
    return is_scipy_sparse(X) or is_torch_sparse(X)


def to_torch_sparse(X, dtype=None, device=None):
    """``X`` (scipy sparse, a torch COO/CSR tensor, or a dense array or
    tensor) as a coalesced torch COO tensor: duplicates summed (scipy COO
    semantics), coordinates in row-major order (the counterpart of
    :func:`rri_nmf_tpu.ops.sweep_sparse.to_bcoo`). A tensor keeps its
    device unless ``device`` is given; anything else lands on the CPU.
    ``dtype`` defaults to X's float dtype, else the device's default
    float."""
    if isinstance(X, torch.Tensor):
        if X.layout == torch.sparse_csr:
            X = X.to_sparse_coo()
        elif X.layout == torch.strided:
            X = X.to_sparse()
    elif is_scipy_sparse(X):
        coo = X.tocoo()
        idx = torch.as_tensor(np.stack([coo.row, coo.col]).astype(np.int64))
        X = torch.sparse_coo_tensor(idx, torch.as_tensor(coo.data),
                                    coo.shape)
    else:
        X = torch.as_tensor(np.asarray(X)).to_sparse()
    if device is not None:
        X = X.to(device)
    if dtype is None and not X.dtype.is_floating_point:
        dtype = default_float(X.device)
    if dtype is not None:
        X = X.to(dtype)
    return X.coalesce()


def as_tensor(X, device=None, dtype=None):
    """``X`` (numpy array, list, scipy-sparse matrix or tensor) as a float
    tensor.

    A tensor keeps its device unless ``device`` is given; anything else
    lands on the CPU. A scipy-sparse matrix becomes a coalesced torch
    sparse COO tensor (duplicates summed), a torch sparse tensor keeps its
    layout. Integer and bool data become the device's default float;
    ``dtype`` overrides."""
    if is_scipy_sparse(X):
        return to_torch_sparse(X, dtype=dtype, device=device)
    if not isinstance(X, torch.Tensor):
        X = np.asarray(X)
        # a read-only array (e.g. np.asarray of a JAX array) is copied:
        # torch does not support non-writable tensors
        X = torch.as_tensor(X if X.flags.writeable else X.copy())
    if device is not None:
        X = X.to(device)
    if dtype is None and not X.dtype.is_floating_point:
        dtype = default_float(X.device)
    return X if dtype is None else X.to(dtype)


def _proj_simplex_core(V, s):
    """Duchi et al. (ICML'08) projection of every row of ``V`` (last axis)
    onto ``{x : x >= 0, sum(x) = s}``; ``s`` a scalar or one per row.

    Matches :func:`rri_nmf_tpu.matrixops._proj_simplex_core` including the
    exact already-on-simplex shortcut: a feasible row is returned bit for
    bit unchanged."""
    n = V.shape[-1]
    if isinstance(s, torch.Tensor):
        s = s.to(dtype=V.dtype, device=V.device).expand(V.shape[:-1])
    else:
        # filled on the device: no host-to-device copy, which would wait
        # for the stream
        s = torch.full(V.shape[:-1], float(s), dtype=V.dtype,
                       device=V.device)
    on_simplex = (V.sum(-1) == s) & (V >= 0).all(-1)
    u = torch.sort(V, dim=-1, descending=True).values
    cssv = torch.cumsum(u, dim=-1)
    ar = torch.arange(1, n + 1, dtype=V.dtype, device=V.device)
    cond = u * ar > (cssv - s[..., None])
    # last index where cond holds; cond[0] holds since s > 0, except where
    # 16-bit rounding absorbs s into a large u[0] (then 0: the vertex)
    idx = torch.arange(n, device=V.device)
    rho = torch.where(cond, idx, 0).max(dim=-1).values
    theta = ((cssv.gather(-1, rho[..., None])[..., 0] - s)
             / (rho.to(V.dtype) + 1.0))
    w = (V - theta[..., None]).clamp_min(0.0)
    return torch.where(on_simplex[..., None], V, w)


def reproject_row_if_drifted(row, target_sum, extra_pred=None):
    """Rows of ``row`` projected onto the ``target_sum`` simplex where
    their sum drifted by more than 1e-15, unchanged elsewhere (reference
    ``nmf.py:758-761``). ``extra_pred`` (one bool per row) conjoins a
    further guard."""
    pred = (row.sum(-1) - target_sum).abs() > 1e-15
    if extra_pred is not None:
        pred = pred & extra_pred
    return torch.where(pred[..., None], _proj_simplex_core(row, target_sum),
                       row)


def dense(X):
    """``X`` as a dense tensor (sparse input densified on its device)."""
    X = as_tensor(X)
    return X.to_dense() if is_torch_sparse(X) else X


def proj_mat_to_simplex(W, s=1.0, axis=1):
    """Project the vectors of ``W`` along ``axis`` onto simplices of radius
    ``s`` (a scalar or one per vector)."""
    W = dense(W)
    if axis == 0:
        return proj_mat_to_simplex(W.T, s, axis=1).T
    if axis != 1:
        raise ValueError('axis must be 0 or 1')
    n = W.shape[0]
    if not (np.isscalar(s) or np.ndim(s) == 0):
        s = as_tensor(s, device=W.device, dtype=W.dtype).reshape(-1)
        if s.numel() != n:
            raise ValueError('proj_mat_to_simplex: expected s to have size '
                             '%d but s has size %d' % (n, s.numel()))
    elif isinstance(s, torch.Tensor):
        s = s.to(W.dtype)
    else:
        s = float(s)
    return _proj_simplex_core(W, s)


def normalize(X, dim=1, zero_sum_fix=True):
    """Normalize ``X`` so vectors along ``dim`` sum to 1; with
    ``zero_sum_fix`` vectors summing below 1e-10 become uniform
    (reference ``matrixops.py:124-163``).

    Sparse input stays sparse and skips the zero-sum fix (a uniform row
    would fill it): all-zero vectors stay zero, as in the JAX package."""
    if dim not in (0, 1):
        raise ValueError('Unknown dim=%r' % (dim,))
    if is_scipy_sparse(X):
        import scipy.sparse as sp
        X = X.tocsr() if dim == 1 else X.tocsc()
        inv = 1.0 / (np.asarray(X.sum(axis=dim)).ravel() + np.spacing(1))
        return sp.diags(inv) @ X if dim == 1 else X @ sp.diags(inv)
    if is_torch_sparse(X):
        coo = to_torch_sparse(X)
        idx, vals = coo.indices()[1 - dim], coo.values()
        sums = torch.zeros(X.shape[1 - dim], dtype=vals.dtype,
                           device=vals.device).index_add_(0, idx, vals)
        return _with_values(coo, vals * (1.0 / (sums + np.spacing(1)))[idx],
                            X.layout)
    X = as_tensor(X)
    xs = X.sum(dim=dim, keepdim=True) + np.spacing(1)
    Xn = X / xs
    if zero_sum_fix:
        Xn = torch.where(xs < 1e-10, 1.0 / X.shape[dim], Xn)
    return Xn


def normalize_l2(X, dim=1):
    """Normalize vectors of ``X`` along ``dim`` to unit l2 norm
    (reference ``matrixops.py:103-121``)."""
    X = dense(X)
    if dim == 0:
        return normalize_l2(X.T, 1).T
    if dim != 1:
        raise ValueError('dim must be 0 or 1')
    return X * (1.0 / torch.sqrt((X ** 2).sum(dim=1) + 1e-10))[:, None]


def _with_values(coo, vals, layout):
    """The coalesced COO ``coo`` with new values, in ``layout``."""
    out = torch.sparse_coo_tensor(coo.indices(), vals, coo.shape,
                                  is_coalesced=True)
    return out.to_sparse_csr() if layout == torch.sparse_csr else out


def scale_columns(X, v):
    """``X * v`` for the (d,) vector ``v``, column j scaled by ``v[j]``;
    a torch sparse X stays sparse, in its layout."""
    if is_torch_sparse(X):
        coo = to_torch_sparse(X)
        return _with_values(coo, coo.values() * v[coo.indices()[1]],
                            X.layout)
    return X * v


def tfidf(X, return_idf=False):
    """n-docs × d-features count matrix to TF-IDF:
    ``idf = log(n / df)`` with the reference's epsilon
    (``matrixops.py:166-179``); ``df`` counts the documents holding each
    feature. Sparse input stays sparse (scipy: the JAX package's
    computation; torch: its layout, on its device); ``idf`` is a tensor
    on X's device (the CPU for scipy)."""
    if is_scipy_sparse(X):
        Xc = X.tocsc()
        n = Xc.shape[0]
        df = np.asarray((Xc > 0).sum(axis=0)).ravel()
        idf = np.log(n / (df + np.spacing(1)))
        rtvx = Xc.multiply(idf[None, :]).tocsr()
        return (rtvx, torch.as_tensor(idf)) if return_idf else rtvx
    if is_torch_sparse(X):
        coo = to_torch_sparse(X)
        n, d = X.shape
        cols, vals = coo.indices()[1], coo.values()
        df = torch.zeros(d, dtype=vals.dtype, device=vals.device)
        df.index_add_(0, cols, (vals > 0).to(vals.dtype))
        idf = torch.log(n / (df + np.spacing(1)))
        rtvx = _with_values(coo, vals * idf[cols], X.layout)
        return (rtvx, idf) if return_idf else rtvx
    X = as_tensor(X)
    n = X.shape[0]
    df = (X > 0).sum(dim=0).to(X.dtype)
    idf = torch.log(n / (df + np.spacing(1)))
    rtvx = X * idf
    if return_idf:
        return rtvx, idf
    return rtvx


def _keep_dtype(x):
    """``x`` as a tensor of its own dtype (numpy on the CPU)."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.array(x))


def euclidean_proj_simplex(v_in, s=1.0):
    """Euclidean projection of ``v_in`` (any shape, flattened) onto the
    positive simplex of radius ``s``: ``min_w 0.5||w - v||²`` s.t.
    ``sum(w) = s, w >= 0`` by Duchi et al.'s sort-based algorithm
    (reference ``matrixops.py:5-69``). Sparse input is densified; the
    result has the input's shape."""
    assert s > 0, 'Radius s must be strictly positive (%s <= 0)' % s
    v = dense(v_in)
    return _proj_simplex_core(v.reshape(-1), float(s)).reshape(v.shape)


def labels_to_mat(y):
    """(n,) label vector → (n, k) one-hot rows; or row-normalize an
    existing (n, k) soft-label matrix (reference ``matrixops.py:182-200``).
    Labels are read on the host; the result is a float64 tensor on the
    CPU, or ``y``'s normalized rows on its device."""
    y_t = dense(y)
    y_np = y_t.cpu().numpy()
    if y_np.size == y_np.shape[0]:
        # (n,) and (n, 1) alike
        y_np = y_np.reshape(-1)
        k = len(np.unique(y_np))
        W = np.zeros((y_np.size, k))
        W[np.arange(y_np.size), y_np.astype(int)] = 1
        return torch.as_tensor(W)
    if abs(y_np.sum() - y_np.shape[0]) < 1e-5:      # already normalized
        return y_t
    k = len(np.unique(y_np))
    if y_np.shape[1] == k:
        return normalize(y_t)
    raise ValueError(
        'labels_to_mat: number of columns of y = {0} doesnt match number of '
        'unique elements {1}'.format(y_np.shape[1], k))


def harden_distributions(W):
    """Each row of ``W`` hardened to a one-hot row at its argmax
    (reference ``matrixops.py:203-209``), in W's dtype on its device."""
    W = dense(W)
    return torch.nn.functional.one_hot(
        torch.argmax(W, dim=1), W.shape[1]).to(W.dtype)


def col_vector(x):
    """Reshape (n,) → (n, 1) (reference ``matrixops.py:212-214``)."""
    return _keep_dtype(x).reshape(-1, 1)


def stack_matrices(L, dict_key=None, transform=None, dim='tall'):
    """Stack a list of matrices (or of dicts or objects holding them under
    ``dict_key``) vertically (``'tall'``) or horizontally (``'fat'``),
    each passed through ``transform`` first (reference
    ``matrixops.py:217-267``). Returns a tensor."""
    assert isinstance(L[0], (np.ndarray, torch.Tensor)) or (
        isinstance(L[0], dict) and dict_key), (
        'if L is a list of arrays no dict_key is needed; if L is a list of '
        'dicts, dict_key must be the key of the matrices to stack.')
    if dim == 'tall':
        stack_op = torch.vstack
    elif dim == 'fat':
        stack_op = torch.hstack
    else:
        raise AssertionError('dim must be "tall" or "fat".')
    mats = []
    for E in L:
        if dict_key:
            try:
                M = E[dict_key]
            except TypeError:
                M = getattr(E, dict_key)
        else:
            M = E
        M = _keep_dtype(M)
        if transform:
            M = transform(M)
        mats.append(M)
    return stack_op(mats)
