"""A sparse X as the gather kernel reads it: output-column layouts.

Counterpart of the host halves of :mod:`rri_nmf_tpu.ops.sparse_mxu` and
:mod:`rri_nmf_tpu.ops.sparse_dma`. The sparse sweep touches X only
through ``WᵀX`` (k×d) and ``T Xᵀ`` (k×n). One CUDA kernel computes both
(``csrc/sparse.cu``, :func:`rri_nmf_tpu_torch.ops.sparse_kernels.
gather_contract`) and reads each direction as a :class:`ColumnLayout`,
an output-column CSR of X with int32 gather indices: X's CSC for
``WᵀX``, its CSR for ``T Xᵀ``. JAX's TPU kernels read X in 128×128 tile
plans instead (B5's grouped chunks, B6's CSR-offset chunks); the layouts
hold the same nonzeros, and no tile plan is built here.

This module is the one place that makes a layout, from a row-major COO
on the COO's own device:

- :func:`coo_segments`: the row offsets, the stable column order and
  its offsets (also the segments of the sparse-mask sweeps' sums,
  :class:`~rri_nmf_tpu_torch.ops.sweep_masked_sparse.MaskedCOOPlan`);
- :func:`coo_layouts`: the two layouts of a row-major COO (the sparse X
  plan's, and the Gram-phase mask plan's,
  :mod:`rri_nmf_tpu_torch.ops.sweep_masked_gram`);
- :func:`gram_work`: the Gram kernel's work list of a layout, long
  columns cut into chunks (:meth:`ColumnLayout.gram_work` keeps it);
- :func:`plan_sparse_matrix`: a scipy or torch sparse X as its
  :class:`SparsePlan`. The COO goes to the device once (a torch X's own
  indices stay where they are), its values are rounded there once to the
  plan's dtype, entries that are then 0 are dropped, and one stable
  (row, column) sort makes it row-major.

Within a column the nonzeros lie in ascending gather index; duplicate
coordinates stay separate entries, in input order. The output columns
are padded to whole 128-wide tiles (the width of ``colptr``), as the
tile plans padded them.
"""

import numpy as np
import torch

from rri_nmf_tpu_torch.matrixops import fit_device

TILE = 128
# output-column layouts built, one per direction (a routing counter the
# tests read, as ``sparse_kernels.LAUNCHES``)
PLAN_BUILDS = {'layout': 0}


class ColumnLayout(object):
    """One contraction direction as an output-column CSR, the gather
    kernel's input (:func:`column_layout`).

    colptr: (spad+1,) int32, column ``c``'s nonzeros are
    ``colptr[c]:colptr[c+1]``; gidx: (nnz,) int32, the row of Fᵀ each
    gathers; vals: (nnz,) their values, in the plan's dtype. ``n_rows``:
    the rows of Fᵀ the gathers need (1 + the largest ``gidx``; 0 when
    there is none)."""

    _fields = ('colptr', 'gidx', 'vals')

    def __init__(self, colptr, gidx, vals, n_rows):
        self.colptr = colptr
        self.gidx = gidx
        self.vals = vals
        self.n_rows = int(n_rows)
        self._work = {}

    @property
    def n_cols(self):
        return self.colptr.shape[0] - 1

    @property
    def nbytes(self):
        return sum(getattr(self, f).nbytes for f in self._fields)

    def gram_work(self, length):
        """The :class:`GramWork` of this layout at chunk length
        ``length``, built on the layout's device at the first call and kept
        (one per length)."""
        work = self._work.get(length)
        if work is None:
            work = self._work[length] = gram_work(self.colptr, length)
        return work


class GramWork(object):
    """The Gram kernel's work list of one layout (:func:`gram_work`).

    items: (n_items, 4) int32, an item's (column, start, end, split):
    nonzeros ``start:end`` of output column ``column``, and ``split`` the
    index of its split column, or -1 for a whole column. The chunks of
    the split columns come first (ascending column, chunks in order),
    then every other column whole, ascending. split_ptr: (n_split + 1,)
    int32, split column s's chunks are items ``split_ptr[s]:split_ptr[s
    + 1]``. ``length``: the longest chunk allowed; ``n_split``,
    ``n_chunks``: the split columns and their chunks; ``longest``: the
    most nonzeros an item holds; ``last_split``: the largest split
    column (-1 when none)."""

    def __init__(self, items, split_ptr, length, n_split, n_chunks, longest,
                 last_split):
        self.items = items
        self.split_ptr = split_ptr
        self.length = int(length)
        self.n_split = int(n_split)
        self.n_chunks = int(n_chunks)
        self.longest = int(longest)
        self.last_split = int(last_split)
        self._arrivals = None

    def n_items(self, ncols):
        """The items of the first ``ncols`` output columns: every chunk,
        then the whole columns below ``ncols``."""
        return self.n_chunks + ncols - self.n_split

    def arrivals(self, count):
        """At least ``count`` int32 zeros on the list's device: the
        kernel's arrival counters, which each launch leaves at 0; kept, and
        made anew only when a launch needs more."""
        if self._arrivals is None or self._arrivals.shape[0] < count:
            self._arrivals = torch.zeros(count, dtype=torch.int32,
                                         device=self.items.device)
        return self._arrivals


class SparsePlan(object):
    """Both directions of one sparse (n, d) X: ``t_phase``, the
    :class:`ColumnLayout` of ``WᵀX`` (k, d) (X's CSC: columns out, rows
    gathered), and ``w_phase``, that of ``T Xᵀ`` (k, n) (X's CSR).
    ``split`` and ``obj_coo``: a rank's block and the objective's COO,
    where :func:`rri_nmf_tpu_torch.parallel.multihost.
    distribute_sparse_coo` sets them; else None."""

    split = None
    obj_coo = None

    def __init__(self, t_phase, w_phase, n, d):
        self.t_phase = t_phase
        self.w_phase = w_phase
        self.n = int(n)
        self.d = int(d)

    @property
    def shape(self):
        return (self.n, self.d)


# ---------------------------------------------------------------------------
# the layouts of a row-major COO
# ---------------------------------------------------------------------------

def coo_segments(rows, cols, shape):
    """``(row_ptr, col_order, col_ptr)`` of a row-major COO on its
    device: row i's entries are ``row_ptr[i]:row_ptr[i+1]`` (n+1,);
    ``col_order`` (nnz,) int64 sorts the entries stably by column, so
    each column keeps its rows ascending; ``col_ptr`` (d+1,) are its
    column offsets."""
    n, d = shape
    row_ptr = torch.searchsorted(rows, torch.arange(
        n + 1, dtype=rows.dtype, device=rows.device))
    sorted_cols, col_order = torch.sort(cols, stable=True)
    col_ptr = torch.searchsorted(sorted_cols, torch.arange(
        d + 1, dtype=cols.dtype, device=cols.device))
    return row_ptr, col_order, col_ptr


def column_layout(ptr, gidx, vals, width, nnz):
    """The :class:`ColumnLayout` of ``nnz`` nonzeros in output-column
    order whose offsets ``ptr`` (width + 1,) may count padding after
    them; ``width`` output columns padded to whole 128-column tiles."""
    colptr = torch.full((-(-width // TILE) * TILE + 1,), nnz,
                        dtype=torch.int32, device=ptr.device)
    colptr[:ptr.shape[0]] = ptr.clamp(max=nnz)
    n_rows = int(gidx.max()) + 1 if gidx.numel() else 0
    PLAN_BUILDS['layout'] += 1
    return ColumnLayout(colptr, gidx, vals, n_rows)


def coo_layouts(rows, cols, vals, shape, segments, nnz=None):
    """``(t, w)``: the output-column layouts of a row-major COO (int32
    ``rows``/``cols``) on its device, given its :func:`coo_segments`.
    ``t`` (columns out, rows gathered) is the COO in its stable column
    order, X's CSC; ``w`` (rows out, columns gathered) the COO as it
    stands, X's CSR. ``nnz``: the leading entries to keep (default all);
    padding after them must sit last in both orders."""
    row_ptr, col_order, col_ptr = segments
    n, d = shape
    nz = rows.shape[0] if nnz is None else nnz
    order = col_order[:nz]
    w = column_layout(row_ptr, cols[:nz], vals[:nz], n, nz)
    t = column_layout(col_ptr, rows[order], vals[order], d, nz)
    return t, w


def gram_work(colptr, length):
    """The :class:`GramWork` of a layout's ``colptr`` at chunk length
    ``length`` >= 1, on ``colptr``'s device: each column of more than
    ``length`` nonzeros cut into ``ceil(nnz_c / length)`` chunks of
    near-equal length (chunk j of q over nonzeros ``s:s + n`` holds
    ``s + j·n // q : s + (j + 1)·n // q``), first; then the other
    columns whole, in ascending id. With no column over ``length`` the
    items are the columns in order."""
    ptr = colptr.long()
    nnz = torch.diff(ptr)
    chunks = torch.where(nnz > length, -(-nnz // length),
                         torch.zeros_like(nnz))
    split = torch.nonzero(chunks).squeeze(1)
    whole = torch.nonzero(chunks == 0).squeeze(1)
    q = chunks[split]
    ends = torch.cumsum(q, 0)
    n_chunks = int(ends[-1]) if split.numel() else 0
    sid = torch.arange(split.numel(), device=ptr.device).repeat_interleave(
        q, output_size=n_chunks)
    col = split[sid]
    j = torch.arange(n_chunks, device=ptr.device) - (ends - q)[sid]
    n, qc = nnz[col], q[sid]
    items = torch.cat([
        torch.stack([col, ptr[col] + j * n // qc,
                     ptr[col] + (j + 1) * n // qc, sid], 1),
        torch.stack([whole, ptr[whole], ptr[whole + 1],
                     torch.full_like(whole, -1)], 1)]).int()
    split_ptr = torch.cat([ends.new_zeros(1), ends]).int()
    longest = int((items[:, 2] - items[:, 1]).max()) if items.numel() else 0
    return GramWork(items.contiguous(), split_ptr, length, split.numel(),
                    n_chunks, longest,
                    int(split[-1]) if split.numel() else -1)


# ---------------------------------------------------------------------------
# the plan of a sparse X
# ---------------------------------------------------------------------------

def host_coo(X):
    """``(rows, cols, vals, (n, d))`` of the sparse ``X`` as host numpy
    arrays, in the order X stores them (duplicates kept): ``X.tocoo()``
    for scipy, the indices of a torch COO tensor, CSR rows expanded for
    a torch CSR tensor (copied from the device when X is on one)."""
    if not isinstance(X, torch.Tensor):
        coo = X.tocoo()
        return coo.row, coo.col, coo.data, coo.shape
    return tuple(a.cpu().numpy() for a in _torch_coo(X)) + (tuple(X.shape),)


def _torch_coo(X):
    """``(rows, cols, vals)`` of a torch COO or CSR tensor on its device,
    in the order X stores them."""
    if X.layout == torch.sparse_csr:
        crow = X.crow_indices()
        rows = torch.repeat_interleave(
            torch.arange(X.shape[0], device=crow.device), torch.diff(crow))
        return rows, X.col_indices(), X.values()
    idx = X._indices()
    return idx[0], idx[1], X._values()


def numpy_dtype(dtype):
    """A torch or numpy dtype as a numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return np.dtype(torch.empty(0, dtype=dtype).numpy().dtype)
    return np.dtype(dtype)


def plan_sparse_matrix(X, dtype=None, device=None):
    """Sparse (n, d) ``X`` (scipy, or a torch COO/CSR tensor) to its
    :class:`SparsePlan` on ``device`` (default: X's device; the card for
    scipy, ``'cpu'`` for the CPU), values in ``dtype`` (a torch or numpy
    dtype; default X's, float64 for integer values). A scipy X's COO is
    copied to the device once; a torch X's indices are taken where they
    lie. The values are rounded to ``dtype`` on the device, and the
    entries that are then 0 dropped. The counterpart of the plans of
    :mod:`rri_nmf_tpu.ops.sparse_mxu` (B5) and
    :mod:`rri_nmf_tpu.ops.sparse_dma` (B6)."""
    device = fit_device(X, device)
    if isinstance(X, torch.Tensor):
        rows, cols, vals = (a.to(device) for a in _torch_coo(X))
    else:
        coo = X.tocoo()
        rows, cols, vals = (torch.from_numpy(np.ascontiguousarray(a))
                            .to(device) for a in (coo.row, coo.col,
                                                  coo.data))
    n, d = (int(s) for s in X.shape)
    if dtype is None:
        dtype = vals.dtype if vals.is_floating_point() else torch.float64
    elif not isinstance(dtype, torch.dtype):
        dtype = torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype
    vals = vals.to(dtype)
    keep = vals != 0
    # one stable sort on the (row, column) key: row-major, duplicates in
    # input order
    order = torch.sort((rows.long() * d + cols)[keep], stable=True)[1]
    rows, cols, vals = (a[keep][order] for a in (rows, cols, vals))
    rows, cols = rows.int(), cols.int()
    t, w = coo_layouts(rows, cols, vals.contiguous(), (n, d),
                       coo_segments(rows, cols, (n, d)))
    return SparsePlan(t, w, n, d)
