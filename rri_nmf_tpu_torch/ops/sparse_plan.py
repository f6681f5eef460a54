"""Host plans of a sparse X for the two contraction kernels B5 and B6.

Counterpart of the host halves of :mod:`rri_nmf_tpu.ops.sparse_mxu` and
:mod:`rri_nmf_tpu.ops.sparse_dma`. The sparse sweep touches X only
through ``WᵀX`` (k×d) and ``T Xᵀ`` (k×n); each direction is planned once
per matrix, on the host:

1. The nonzeros are bucketed by their (128, 128) tile of X,
   output-tile-major (the tile along the output axis first, then the
   tile along the contracted axis), and packed into chunks of ``C = 128``
   slots. Padding slots carry ``v = 0``; duplicate coordinates stay two
   slots, so they sum.
2. B5's plan (:func:`plan_sparse_matrix`) groups the chunks G per output
   tile (``group=8``), padding each output tile's run with dummy chunks
   (``v = 0``); ``otile`` holds one entry per group.
3. B6's plan (:func:`plan_sparse_matrix_dma`) keeps the ungrouped chunks
   with CSR offsets ``ostart`` over the used output tiles ``uotile``, and
   ``MBLK_MAX`` trailing pad chunks so a kernel may read a whole
   metadata block past the last chunk.

The plans come from the JAX package's NumPy argsort form, copied line for
line so the arrays match bit for bit (its native counting sort is not
used: importing it would import JAX). Local indices stay uint8 on the
device too, where the TPU kernel needed int32.

Plans are small classes of tensors on one device. The CUDA kernel reads
neither plan as it stands: :func:`column_layout` derives from either, on
the plan's device and once per plan (cached on it), the output-column
CSR of :class:`ColumnLayout`: the plan's slots stably sorted by output
column, zero-valued padding dropped, with int32 global gather indices.
The B5 and B6 plans of one matrix give equal layouts. The Gram-phase
sweep builds its mask's layouts straight from the observed COO, with no
plan (:mod:`rri_nmf_tpu_torch.ops.sweep_masked_gram`).
"""

import numpy as np
import torch

from rri_nmf_tpu_torch.matrixops import fit_device
from rri_nmf_tpu_torch.ops.quantized import NARROW

TILE = 128
# Chunks per metadata block B6 may read ahead (the plan's trailing pad).
MBLK_MAX = 16


def _run_starts(a):
    """First-of-run flags of the SORTED array ``a`` (boundary flags, not
    ``np.unique``)."""
    new = np.empty(a.shape[0], np.bool_)
    if new.size:
        new[0] = True
        np.not_equal(a[1:], a[:-1], out=new[1:])
    return new


def _plan_direction_np(g, s, v, n_gtiles, n_stiles, C, G, dtype,
                       extra=None):
    """Bucket nonzeros by (scatter tile, gather tile), output-tile-major,
    padded to C-slot chunks; chunks grouped G per output tile (dummy
    chunks, ``v = 0``, pad each output tile's run to a multiple of G).
    ``g`` indexes the contracted axis, ``s`` the output axis. Returns
    host arrays ``(vals, gloc, sloc, ftile, otile, mask)``
    (:func:`rri_nmf_tpu.ops.sparse_mxu._plan_direction_np`).

    ``extra``: a second value per nonzero, placed in the same slots as
    ``v`` (padding 0) and returned last, as a seventh array shaped like
    ``vals``: what JAX's ``sweep_masked_gram._vals_like`` gets from a
    second call, without sorting again."""
    if len(v) == 0:
        # degenerate: one all-padding group, all-zero mask -> zeros out
        out = (np.zeros((1, G * C), dtype), np.zeros((1, G * C), np.uint8),
               np.zeros((1, G * C), np.uint8),
               np.zeros((G,), np.int32), np.zeros((1,), np.int32),
               np.zeros((1, n_stiles * TILE), dtype))
        return out if extra is None else out + (np.zeros((1, G * C),
                                                         dtype),)
    # one argsort on the fused (scatter-tile, gather-tile) key; only the
    # per-slot arrays are permuted
    pair = (s // TILE).astype(np.int64) * n_gtiles + g // TILE
    order = np.argsort(pair)              # st-major, gt within
    pair = pair[order]
    g = g[order]
    s = s[order]
    v = v[order]
    if extra is not None:
        extra = extra[order]
    gl = (g % TILE).astype(np.uint8)
    sl = (s % TILE).astype(np.uint8)
    newrun = _run_starts(pair)
    first = np.flatnonzero(newrun)
    counts = np.diff(np.append(first, len(pair)))
    gt_first = (pair[first] % n_gtiles).astype(np.int64)
    st_first = (pair[first] // n_gtiles).astype(np.int64)
    chunks_per = -(-counts // C)
    nchunks = int(chunks_per.sum())
    choff = np.zeros(len(first) + 1, np.int64)
    choff[1:] = np.cumsum(chunks_per)
    within = np.arange(len(v)) - np.repeat(first, counts)
    dst = np.repeat(choff[:-1], counts) * C + within

    vals = np.zeros(nchunks * C, dtype)
    vals[dst] = v
    if extra is not None:
        vals2 = np.zeros(nchunks * C, dtype)
        vals2[dst] = extra
    glo = np.zeros(nchunks * C, np.uint8)
    glo[dst] = gl
    slo = np.zeros(nchunks * C, np.uint8)
    slo[dst] = sl
    ftile = np.repeat(gt_first.astype(np.int32), chunks_per)
    otile = np.repeat(st_first.astype(np.int32), chunks_per)

    if G > 1:
        # pad each otile's chunk run to a multiple of G (dummy chunks:
        # v = 0, ftile = 0) so no group straddles an output tile
        onew = _run_starts(otile)
        ofirst = np.flatnonzero(onew)
        uo = otile[ofirst]
        ocnt = np.diff(np.append(ofirst, nchunks))
        opad = -(-ocnt // G) * G
        tot = int(opad.sum())
        ooff = np.zeros(len(uo) + 1, np.int64)
        ooff[1:] = np.cumsum(opad)
        within_o = np.arange(nchunks) - np.repeat(ofirst, ocnt)
        dstc = np.repeat(ooff[:-1], ocnt) + within_o

        def scatter_chunks(a, width, dt):
            out = np.zeros((tot, width), dt)
            out[dstc] = a.reshape(nchunks, width)
            return out

        vals = scatter_chunks(vals, C, dtype)
        if extra is not None:
            vals2 = scatter_chunks(vals2, C, dtype)
        glo = scatter_chunks(glo, C, np.uint8)
        slo = scatter_chunks(slo, C, np.uint8)
        ft2 = np.zeros(tot, np.int32)
        ft2[dstc] = ftile
        ftile = ft2
        otile = np.repeat(uo, opad // G).astype(np.int32)  # per GROUP
        nchunks = tot

    mask = np.zeros((n_stiles, 1), dtype)
    mask[st_first] = 1.0
    mask = np.broadcast_to(mask, (n_stiles, TILE)).reshape(1, -1)

    out = (vals.reshape(1, nchunks * C), glo.reshape(1, nchunks * C),
           slo.reshape(1, nchunks * C), ftile, otile,
           np.ascontiguousarray(mask))
    return out if extra is None else out + (vals2.reshape(1, nchunks * C),)


def _plan_direction_dma_np(g, s, v, n_gtiles, n_stiles, C, dtype):
    """B6's layout of one direction, host arrays ``(vals, idx, ftile,
    uotile, ostart, mask)`` (:func:`rri_nmf_tpu.ops.sparse_dma.
    _plan_direction_dma`, without the device placement)."""
    vdt = np.float32 if np.dtype(dtype).itemsize < 4 else np.dtype(dtype)
    vals, glo, slo, ftile, otile, mask = _plan_direction_np(
        g, s, v, n_gtiles, n_stiles, C, 1, vdt)
    nchunks = ftile.shape[0]
    # CSR offsets over the (already output-tile-major) chunk order
    onew = _run_starts(otile)
    ofirst = np.flatnonzero(onew)
    uo = otile[ofirst]
    ostart = np.concatenate([ofirst, [nchunks]]).astype(np.int32)
    # pad so a trailing metadata block of up to MBLK_MAX chunks may
    # over-read
    npad = nchunks + MBLK_MAX
    vp = np.zeros((1, npad * C), vdt)
    vp[:, :nchunks * C] = vals
    ip = np.zeros((2, npad * C), np.uint8)
    ip[0, :nchunks * C] = glo[0]
    ip[1, :nchunks * C] = slo[0]
    fp = np.zeros((npad,), np.int32)
    fp[:nchunks] = ftile
    return vp, ip, fp, uo.astype(np.int32), ostart, mask


# ---------------------------------------------------------------------------
# plan containers
# ---------------------------------------------------------------------------

class _Tensors(object):
    """A few named tensors on one device, and ``n_gtiles``, the number of
    128-wide factor tiles the plan gathers from (the bound on ``ftile``,
    known on the host). ``columns``: the :class:`ColumnLayout` derived
    from the plan (:func:`column_layout`), None until first asked for."""

    _fields = ()
    columns = None

    def __init__(self, n_gtiles, **arrays):
        self.n_gtiles = int(n_gtiles)
        for name in self._fields:
            setattr(self, name, arrays[name])

    def to(self, device):
        """The same plan with every tensor on ``device``."""
        return type(self)(self.n_gtiles, **{f: getattr(self, f).to(device)
                                            for f in self._fields})


class ContractPlan(_Tensors):
    """One contraction direction in B5's layout
    (:class:`rri_nmf_tpu.ops.sparse_mxu.ContractPlan`).

    vals/gloc/sloc: (1, nchunks·C) values (the fit's dtype) and uint8
    local gather / scatter indices; ftile: (nchunks,) int32 factor tile
    per chunk; otile: (nchunks/G,) int32 output tile per group; mask:
    (1, n_otiles·128), 1 on output tiles that hold a nonzero."""

    _fields = ('vals', 'gloc', 'sloc', 'ftile', 'otile', 'mask')

    @property
    def group(self):
        return self.ftile.shape[0] // self.otile.shape[0]


class DMAContractPlan(_Tensors):
    """One contraction direction in B6's layout
    (:class:`rri_nmf_tpu.ops.sparse_dma.DMAContractPlan`).

    vals: (1, npad·C); idx: (2, npad·C) uint8, row 0 the local gather
    index, row 1 the local scatter index; ftile: (npad,) int32; uotile:
    (n_used,) int32 used output tiles, ascending; ostart: (n_used+1,)
    int32 chunk offsets; mask: (1, n_otiles·128). ``npad = nchunks +
    MBLK_MAX``."""

    _fields = ('vals', 'idx', 'ftile', 'uotile', 'ostart', 'mask')


class ColumnLayout(object):
    """One contraction direction as an output-column CSR, the gather
    kernel's input (:func:`column_layout`).

    colptr: (spad+1,) int32, column ``c``'s nonzeros are
    ``colptr[c]:colptr[c+1]``; gidx: (nnz,) int32, the row of Fᵀ each
    gathers (``128·ftile + gloc``); vals: (nnz,) their values, in the
    plan's dtype. ``n_rows``: the rows of Fᵀ the gathers need (1 + the
    largest ``gidx``; 0 when there is none)."""

    _fields = ('colptr', 'gidx', 'vals')

    def __init__(self, colptr, gidx, vals, n_rows):
        self.colptr = colptr
        self.gidx = gidx
        self.vals = vals
        self.n_rows = int(n_rows)

    @property
    def n_cols(self):
        return self.colptr.shape[0] - 1

    @property
    def nbytes(self):
        return sum(getattr(self, f).nbytes for f in self._fields)


class SparseMXUPlan(object):
    """Both directions of one (n, d) matrix for B5: ``t_phase`` gives
    ``WᵀX`` (k, d), ``w_phase`` gives ``T Xᵀ`` (k, n)."""

    def __init__(self, t_phase, w_phase, n, d, group=1):
        self.t_phase = t_phase
        self.w_phase = w_phase
        self.n = int(n)
        self.d = int(d)
        self.group = int(group)

    @property
    def shape(self):
        return (self.n, self.d)

    def to(self, device):
        return SparseMXUPlan(self.t_phase.to(device), self.w_phase.to(device),
                             self.n, self.d, self.group)


class SparseDMAPlan(object):
    """Both directions of one (n, d) matrix for B6."""

    def __init__(self, t_phase, w_phase, n, d):
        self.t_phase = t_phase
        self.w_phase = w_phase
        self.n = int(n)
        self.d = int(d)

    def to(self, device):
        return SparseDMAPlan(self.t_phase.to(device), self.w_phase.to(device),
                             self.n, self.d)


# ---------------------------------------------------------------------------
# building the plans
# ---------------------------------------------------------------------------

def host_coo(X):
    """``(rows, cols, vals, (n, d))`` of the sparse ``X`` as host numpy
    arrays, in the order X stores them (duplicates kept): ``X.tocoo()``
    for scipy, the indices of a torch COO tensor, CSR rows expanded for
    a torch CSR tensor (copied from the device when X is on one)."""
    if not isinstance(X, torch.Tensor):
        coo = X.tocoo()
        return coo.row, coo.col, coo.data, coo.shape
    n, d = X.shape
    if X.layout == torch.sparse_csr:
        crow = X.crow_indices().cpu().numpy()
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(crow))
        return (rows, X.col_indices().cpu().numpy(),
                X.values().cpu().numpy(), (n, d))
    idx = X._indices().cpu().numpy()
    return idx[0], idx[1], X._values().cpu().numpy(), (n, d)


def numpy_dtype(dtype):
    """A torch or numpy dtype as a numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return np.dtype(torch.empty(0, dtype=dtype).numpy().dtype)
    return np.dtype(dtype)


def _host_dtype(dtype, vals):
    """The numpy dtype a plan is built in on the host: the values' own
    for a 16-bit ``dtype`` (numpy has no bfloat16; the values are
    rounded once, on the device, by :func:`_to_device`)."""
    if dtype is None or dtype in NARROW:
        return np.dtype(vals.dtype) if np.issubdtype(vals.dtype, np.floating) \
            else np.dtype(np.float64)
    return numpy_dtype(dtype)


def _to_device(arrays, device, dtype=None):
    """The host arrays as tensors on ``device``, the values (``'vals'``)
    in the 16-bit ``dtype`` when one is asked for."""
    out = {k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
           for k, a in arrays.items()}
    if dtype in NARROW:
        out['vals'] = out['vals'].to(dtype)
    return out


def plan_sparse_matrix(X, dtype=None, C=TILE, group=8, device=None):
    """Sparse (n, d) ``X`` (scipy, or a torch COO/CSR tensor) to a
    :class:`SparseMXUPlan` on ``device`` (default: X's device; the card
    for scipy, ``'cpu'`` for the CPU), values in ``dtype`` (default X's).
    Host-side and one-off
    (:func:`rri_nmf_tpu.ops.sparse_mxu.plan_sparse_matrix`)."""
    device = fit_device(X, device)
    rows, cols, data, (n, d) = host_coo(X)
    host_dt = _host_dtype(dtype, data)
    n_rt = -(-n // TILE)
    n_ct = -(-d // TILE)
    vals = np.asarray(data, dtype=host_dt)
    plans = []
    for g, s, n_g, n_s in ((rows, cols, n_rt, n_ct), (cols, rows, n_ct, n_rt)):
        v, gl, sl, ft, ot, mask = _plan_direction_np(g, s, vals, n_g, n_s, C,
                                                     group, host_dt)
        plans.append(ContractPlan(n_g, **_to_device(dict(
            vals=v, gloc=gl, sloc=sl, ftile=ft, otile=ot, mask=mask),
            device, dtype)))
    return SparseMXUPlan(plans[0], plans[1], n, d, group)


def plan_sparse_matrix_dma(X, dtype=None, C=TILE, device=None):
    """Sparse (n, d) ``X`` to a :class:`SparseDMAPlan` on ``device``
    (:func:`rri_nmf_tpu.ops.sparse_dma.plan_sparse_matrix_dma`)."""
    device = fit_device(X, device)
    rows, cols, data, (n, d) = host_coo(X)
    host_dt = _host_dtype(dtype, data)
    n_rt = -(-n // TILE)
    n_ct = -(-d // TILE)
    vals = np.asarray(data, dtype=host_dt)
    plans = []
    for g, s, n_g, n_s in ((rows, cols, n_rt, n_ct), (cols, rows, n_ct, n_rt)):
        v, idx, ft, uo, ostart, mask = _plan_direction_dma_np(
            g, s, vals, n_g, n_s, C, host_dt)
        plans.append(DMAContractPlan(n_g, **_to_device(dict(
            vals=v, idx=idx, ftile=ft, uotile=uo, ostart=ostart, mask=mask),
            device, dtype)))
    return SparseDMAPlan(plans[0], plans[1], n, d)


# ---------------------------------------------------------------------------
# the output-column layout of a plan direction
# ---------------------------------------------------------------------------

def _plan_slots(plan):
    """``(g, s, v)`` of every slot of a plan direction, in plan order:
    the row of Fᵀ it gathers, its output column and its value (int64,
    int64, the plan's dtype). B6's trailing pad chunks are left out."""
    C = plan.vals.shape[1] // plan.ftile.shape[0]
    if isinstance(plan, ContractPlan):
        ftile, gl, sl, v = plan.ftile, plan.gloc[0], plan.sloc[0], \
            plan.vals[0]
        otile = plan.otile.long().repeat_interleave(plan.group)
    elif isinstance(plan, DMAContractPlan):
        nslots = int(plan.ostart[-1]) * C
        ftile, gl, sl, v = (plan.ftile[:nslots // C], plan.idx[0, :nslots],
                            plan.idx[1, :nslots], plan.vals[0, :nslots])
        otile = plan.uotile.long().repeat_interleave(
            torch.diff(plan.ostart.long()))
    else:
        raise TypeError('expected a ContractPlan or DMAContractPlan, got %s'
                        % type(plan).__name__)
    g = (ftile.long() * TILE).repeat_interleave(C) + gl.long()
    s = (otile * TILE).repeat_interleave(C) + sl.long()
    return g, s, v


def column_layout(plan):
    """The :class:`ColumnLayout` of a plan direction (a
    :class:`ContractPlan` or :class:`DMAContractPlan`), built with torch
    ops on the plan's device at the first call and cached on the plan.

    The slots are sorted by output column with a stable sort, so each
    column keeps its nonzeros in plan order; slots with ``v = 0`` (the
    plans' padding slots, B5's dummy chunks) add nothing and are dropped.
    The layouts from the B5 and the B6 plan of one matrix are equal. A
    :class:`ColumnLayout` (the Gram-phase sweep's, built without a plan)
    is its own layout."""
    if isinstance(plan, ColumnLayout):
        return plan
    if plan.columns is None:
        g, s, v = _plan_slots(plan)
        keep = v != 0
        g, s, v = g[keep], s[keep], v[keep]
        s, order = torch.sort(s, stable=True)
        n_cols = plan.mask.shape[1]
        colptr = torch.searchsorted(
            s, torch.arange(n_cols + 1, device=s.device)).to(torch.int32)
        gidx = g[order].to(torch.int32)
        n_rows = int(gidx.max()) + 1 if gidx.numel() else 0
        plan.columns = ColumnLayout(colptr, gidx, v[order].contiguous(),
                                    n_rows)
    return plan.columns

