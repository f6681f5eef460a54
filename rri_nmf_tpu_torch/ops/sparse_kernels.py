"""Sparse contractions ``F @ X``: kernels B5 and B6, one CUDA kernel;
and B5 on Khatri-Rao rows formed on chip, the Gram kernel.

Counterpart of the kernel halves of :mod:`rri_nmf_tpu.ops.sparse_mxu`
and :mod:`rri_nmf_tpu.ops.sparse_dma`. The sparse sweep needs ``WᵀX``
(k, d) and ``T Xᵀ`` (k, n) once per phase. X comes as a host plan
(:mod:`rri_nmf_tpu_torch.ops.sparse_plan`): B5's grouped chunk plan
(:func:`~rri_nmf_tpu_torch.ops.sparse_plan.plan_sparse_matrix`) or B6's
CSR-offset plan (:func:`~rri_nmf_tpu_torch.ops.sparse_plan.
plan_sparse_matrix_dma`). Each plan direction derives, once, an
output-column CSR (:func:`~rri_nmf_tpu_torch.ops.sparse_plan.
column_layout`); the two plans of one matrix give the same layout.

One kernel, ``csrc/sparse.cu`` ``gather_kernel``, computes ``out = F @ X``
on that layout for both plans, gathering rows of an L2-resident Fᵀ one
output column at a time. :func:`gather_contract` launches it;
``LAUNCHES`` counts its launches under the plan's kernel, ``'mxu'`` (B5)
or ``'dma'`` (B6). The B5 and B6 interfaces stay: :func:`mxu_contract`
takes F as one (k, gpad) panel, :func:`dma_contract` as (n_tiles, k, 128)
slabs. :func:`contract_wtx` and :func:`contract_xtt` hand the kernel W
itself and Tᵀ, and get (k, d) and (k, n).

Each wrapper takes a CPU tensor to :func:`gather_contract_ref`, the
kernel's plain PyTorch twin on the layout, and a CUDA tensor to the
kernel — or raises. 16-bit factors (bfloat16, float16) meet values of
their dtype, as the JAX kernels' narrow dots do: the products are exact
in float32, summed in float32, and the output is float32.
:func:`mxu_contract_ref` and :func:`dma_contract_ref` walk the plans themselves (a gather of factor columns times the values,
then ``index_add_`` into the output columns): the oracles the tests hold
against the Pallas kernels. Every twin works in slices whose gather
temporary stays under ~2 GB.

The Gram-phase sparse-mask sweep contracts the mask with the Khatri-Rao
rows ``f_a ⊙ f_b`` of a factor (Γ, Θ). JAX builds those rows and runs
B5 on them; here ``csrc/gram.cu`` ``gram_kernel`` forms them on chip
from Fᵀ's rows: :func:`gram_contract` launches it (float32 and float64,
counted under ``LAUNCHES['gram']``), and :func:`gram_contract_ref`, its
twin, builds the rows and runs :func:`gather_contract_ref`.
"""

import torch

from rri_nmf_tpu_torch.ops._build import CTYPES, launch
from rri_nmf_tpu_torch.ops.quantized import work_dtype
from rri_nmf_tpu_torch.ops.sparse_plan import (TILE, SparseDMAPlan,
                                               SparseMXUPlan, column_layout)

# Kernel launches per plan type since the last reset_launches(). A wrapper
# adds one right after the kernel launched, and nowhere else.
LAUNCHES = {'mxu': 0, 'dma': 0, 'gram': 0}

# Largest gather temporary of a twin, in bytes.
GATHER_BUDGET = 2 << 30


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------

def _gather_add(k, spad, nslots, gather, C, dtype, device):
    """``out (k, spad)`` accumulated from ``gather(c0, c1) -> (cols, idx)``
    over chunk ranges whose (k, slots) gather temporary stays under
    :data:`GATHER_BUDGET`: ``cols`` (k, m) are the factor columns times
    the values, ``idx`` (m,) their output columns."""
    out = torch.zeros(k, spad, dtype=dtype, device=device)
    nchunks = nslots // C
    size = torch.empty(0, dtype=dtype).element_size()
    step = max(1, GATHER_BUDGET // (max(k, 1) * C * size))
    for c0 in range(0, nchunks, step):
        cols, idx = gather(c0, min(c0 + step, nchunks))
        out.index_add_(1, idx, cols)
    return out


def mxu_contract_ref(plan, F):
    """Plain version of B5: ``out (k, spad) = F @ X`` for the direction
    ``plan`` (a :class:`~rri_nmf_tpu_torch.ops.sparse_plan.ContractPlan`)
    encodes; ``F`` (k, gpad) covers every factor tile. Slot i of chunk c
    adds ``v_i · F[:, 128·ftile[c] + gloc_i]`` to output column
    ``128·otile[c // G] + sloc_i``."""
    k = F.shape[0]
    nchunks = plan.ftile.shape[0]
    C = plan.vals.shape[1] // nchunks
    ochunk = plan.otile.long().repeat_interleave(plan.group)
    vals, gl, sl = plan.vals[0], plan.gloc[0], plan.sloc[0]

    def gather(c0, c1):
        a, b = c0 * C, c1 * C
        gi = plan.ftile[c0:c1].long().repeat_interleave(C) * TILE \
            + gl[a:b].long()
        si = ochunk[c0:c1].repeat_interleave(C) * TILE + sl[a:b].long()
        return F[:, gi] * vals[a:b].to(F.dtype), si

    return _gather_add(k, plan.mask.shape[1], nchunks * C, gather, C,
                       F.dtype, F.device)


def dma_contract_ref(plan, F3):
    """Plain version of B6: ``out (k, spad) = F @ X`` for the direction
    ``plan`` (a :class:`~rri_nmf_tpu_torch.ops.sparse_plan.
    DMAContractPlan`) encodes; ``F3`` (n_tiles, k, 128) holds F's tiles.
    The chunks of used output tile ``uotile[i]`` are
    ``ostart[i]:ostart[i+1]``."""
    k = F3.shape[1]
    nchunks = int(plan.ostart[-1])
    C = plan.vals.shape[1] // plan.ftile.shape[0]
    ochunk = plan.uotile.long().repeat_interleave(
        torch.diff(plan.ostart.long()))
    vals, gl, sl = plan.vals[0], plan.idx[0], plan.idx[1]

    def gather(c0, c1):
        a, b = c0 * C, c1 * C
        ft = plan.ftile[c0:c1].long().repeat_interleave(C)
        cols = F3[ft, :, gl[a:b].long()].T           # (k, slots)
        si = ochunk[c0:c1].repeat_interleave(C) * TILE + sl[a:b].long()
        return cols * vals[a:b].to(F3.dtype), si

    return _gather_add(k, plan.mask.shape[1], nchunks * C, gather, C,
                       F3.dtype, F3.device)


def gather_contract_ref(layout, Ft, k, ncols, vals=None):
    """Plain version of the gather kernel: ``out (k, ncols)``, column c
    the sum over its nonzeros i of ``v_i · Ft[g_i, :k]``, added in layout
    order (``index_add_``); 16-bit factors and values are widened and
    summed in float32. ``layout`` is a :class:`~rri_nmf_tpu_torch.
    ops.sparse_plan.ColumnLayout` whose nonzeros lie in the first
    ``ncols`` columns; ``Ft`` (m, >= k) holds Fᵀ's rows. ``vals``: other
    values for the nonzeros, in layout order, in place of the layout's
    (:meth:`~rri_nmf_tpu_torch.ops.sweep_masked_gram.MaskedGramPlan.
    mx_layout_values`)."""
    acc = work_dtype(Ft.dtype)
    out = torch.zeros(k, ncols, dtype=acc, device=Ft.device)
    nnz = layout.gidx.shape[0]
    if nnz == 0:
        return out
    v = layout.vals if vals is None else vals
    col = torch.arange(layout.n_cols, device=Ft.device).repeat_interleave(
        torch.diff(layout.colptr.long()))
    size = torch.empty(0, dtype=acc).element_size()
    step = max(1, GATHER_BUDGET // (max(k, 1) * size))
    for a in range(0, nnz, step):
        b = min(a + step, nnz)
        rows = (Ft[layout.gidx[a:b].long(), :k].to(acc)
                * v[a:b, None].to(acc))
        out.index_add_(1, col[a:b], rows.T)
    return out


def _gram_panel(k, panel):
    """``(t0, p)`` of a panel of :func:`gram_pairs`, ``(0, 0)`` for the
    unique pairs; raises on a panel outside the k topics."""
    if panel is None:
        return 0, 0
    t0, p = (int(x) for x in panel)
    if not (p >= 1 and 0 <= t0 and t0 + p <= k):
        raise ValueError('panel (t0=%d, p=%d) does not lie in the %d topics'
                         % (t0, p, k))
    return t0, p


def gram_pairs(k, panel=None):
    """``(a, b)`` (rows,) int64: the factor columns of each Khatri-Rao row
    ``f_a ⊙ f_b`` of :func:`gram_contract`. ``panel=None``: the
    k(k+1)/2 pairs a <= b in ``np.triu_indices(k)`` order (Γ/Θ's unique
    rows); ``panel=(t0, p)``: ``a = t0 + r // k``, ``b = r % k`` for
    r < p·k. Raises on a panel outside [0, k)."""
    t0, p = _gram_panel(k, panel)
    if panel is None:
        a, b = torch.triu_indices(k, k)
        return a, b
    r = torch.arange(p * k)
    return t0 + r // k, r % k


def gram_contract_ref(layout, Ft, k, panel, ncols):
    """Plain version of the Gram kernel: the Khatri-Rao rows
    ``Ft[:, a] * Ft[:, b]`` of :func:`gram_pairs` built in slices whose
    (m, rows) temporary stays under :data:`GATHER_BUDGET`, each contracted
    by :func:`gather_contract_ref` (the materialized-row path the kernel
    replaces, the same sums in the same order)."""
    a, b = (x.to(Ft.device) for x in gram_pairs(k, panel))
    rows = a.shape[0]
    out = torch.empty(rows, ncols, dtype=work_dtype(Ft.dtype),
                      device=Ft.device)
    size = torch.empty(0, dtype=out.dtype).element_size()
    step = max(1, GATHER_BUDGET // (max(Ft.shape[0], 1) * size))
    for r0 in range(0, rows, step):
        r1 = min(r0 + step, rows)
        KR = Ft[:, a[r0:r1]] * Ft[:, b[r0:r1]]
        out[r0:r1] = gather_contract_ref(layout, KR, r1 - r0, ncols)
    return out


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _rows(Ft, k):
    """``Ft`` (m, >= k) as the kernel reads Fᵀ: contiguous rows of k values
    rounded up to 16 bytes, 16-byte aligned. ``Ft`` itself when it is so
    (W for ``WᵀX`` at k % 4 == 0 in float32), else a zero-padded copy."""
    v = 16 // Ft.element_size()
    kp = -(-k // v) * v
    if (Ft.is_contiguous() and Ft.shape[1] == kp
            and Ft.data_ptr() % 16 == 0):
        return Ft
    rows = Ft.new_zeros(Ft.shape[0], kp)
    rows[:, :k] = Ft[:, :k]
    return rows


def gather_contract(plan, Ft, k, ncols, kind, vals=None):
    """``out (k, ncols) = F @ X`` for the plan direction ``plan`` (either
    type, or a :class:`~rri_nmf_tpu_torch.ops.sparse_plan.ColumnLayout`),
    ``F``'s rows given as ``Ft`` (m, >= k); ``ncols`` the output columns
    wanted (the plan's padded width, or fewer when the rest are empty).
    ``vals``: another matrix on the same nonzeros, its values in the
    layout's order (:meth:`~rri_nmf_tpu_torch.ops.sweep_masked_gram.
    MaskedGramPlan.mx_layout_values`; JAX's ``vals_override``). The
    output is Ft's dtype, float32 for 16-bit factors. A CPU ``Ft`` runs
    :func:`gather_contract_ref`; a CUDA ``Ft`` launches ``csrc/sparse.cu``
    and counts it under ``LAUNCHES[kind]``."""
    if Ft.device.type == 'cpu':
        return gather_contract_ref(column_layout(plan), Ft, k, ncols, vals)
    if Ft.device.type != 'cuda':
        raise ValueError('the kernels run on CUDA or (plain twin) CPU '
                         'tensors, got %s' % Ft.device)
    if Ft.dtype not in CTYPES:
        raise ValueError('the kernels take float32/float64 or '
                         'bfloat16/float16, got %s' % Ft.dtype)
    layout = column_layout(plan)
    for name in layout._fields:
        a = getattr(layout, name)
        if a.device != Ft.device:
            raise ValueError('the plan is on %s, the factor on %s'
                             % (a.device, Ft.device))
    v = layout.vals if vals is None else vals
    if (v.dtype != Ft.dtype or v.device != Ft.device
            or tuple(v.shape) != tuple(layout.vals.shape)
            or not v.is_contiguous()):
        raise ValueError('plan values are %s %s %s, the factor %s on %s; '
                         'the layout has %d nonzeros'
                         % (v.dtype, tuple(v.shape), v.device, Ft.dtype,
                            Ft.device, layout.vals.shape[0]))
    if Ft.shape[1] < k or Ft.shape[0] < layout.n_rows:
        raise ValueError('the factor has %d rows of %d values; the plan '
                         'gathers %d rows of %d' % (*Ft.shape, layout.n_rows,
                                                    k))
    if not 0 < ncols <= layout.n_cols or layout.gidx.shape[0] >= 2 ** 31 - 8:
        raise ValueError('%d output columns of a %d-column plan with %d '
                         'nonzeros' % (ncols, layout.n_cols,
                                       layout.gidx.shape[0]))
    rows = _rows(Ft, k)
    out = torch.empty(k, ncols, dtype=work_dtype(Ft.dtype), device=Ft.device)
    launch('rri_sparse_gather', rows, rows.data_ptr(),
           layout.colptr.data_ptr(), layout.gidx.data_ptr(), v.data_ptr(),
           out.data_ptr(), k, rows.shape[1], ncols, ncols)
    LAUNCHES[kind] += 1
    return out


def gram_contract(plan, Ft, k, panel, ncols):
    """``out (rows, ncols)``: the mask of the plan direction ``plan`` (or
    its :class:`~rri_nmf_tpu_torch.ops.sparse_plan.ColumnLayout`)
    contracted with the Khatri-Rao rows ``f_a ⊙ f_b`` of Fᵀ's rows ``Ft``
    (m, >= k), the pairs of :func:`gram_pairs` (``panel=None``: Γ/Θ's
    k(k+1)/2 unique rows; ``(t0, p)``: a p·k panel), without
    materializing them::

        out[r, c] = Σ_i v_i·Ft[g_i, a_r]·Ft[g_i, b_r]   (column c's nonzeros i)

    float32 or float64 (Γ/Θ are built in the accumulation dtype). A CPU
    ``Ft`` runs :func:`gram_contract_ref`; a CUDA ``Ft`` launches
    ``csrc/gram.cu`` and counts it under ``LAUNCHES['gram']``."""
    if Ft.dtype not in (torch.float32, torch.float64):
        raise ValueError('the Gram contraction takes float32 or float64 '
                         'factors, got %s' % Ft.dtype)
    t0, p = _gram_panel(k, panel)
    rows = p * k if p else k * (k + 1) // 2
    if Ft.dim() != 2 or Ft.shape[1] < k:
        raise ValueError('Ft must be (m, >= %d), got %s'
                         % (k, tuple(Ft.shape)))
    layout = column_layout(plan)
    for name in layout._fields:
        a = getattr(layout, name)
        if a.device != Ft.device:
            raise ValueError('the plan is on %s, the factor on %s'
                             % (a.device, Ft.device))
    if layout.vals.dtype != Ft.dtype:
        raise ValueError('plan values are %s, the factor %s'
                         % (layout.vals.dtype, Ft.dtype))
    if Ft.shape[0] < layout.n_rows:
        raise ValueError('the factor has %d rows; the plan gathers %d'
                         % (Ft.shape[0], layout.n_rows))
    if not 0 < ncols <= layout.n_cols or layout.gidx.shape[0] >= 2 ** 31 - 8:
        raise ValueError('%d output columns of a %d-column plan with %d '
                         'nonzeros' % (ncols, layout.n_cols,
                                       layout.gidx.shape[0]))
    if Ft.device.type == 'cpu':
        return gram_contract_ref(layout, Ft, k, panel, ncols)
    if Ft.device.type != 'cuda':
        raise ValueError('the kernels run on CUDA or (plain twin) CPU '
                         'tensors, got %s' % Ft.device)
    # rows of whole tiles (8 float32, 4 float64: 32 bytes)
    ti = 32 // Ft.element_size()
    kp = -(-k // ti) * ti
    Fr = Ft
    if not (Ft.is_contiguous() and Ft.shape[1] == kp
            and Ft.data_ptr() % 16 == 0):
        Fr = Ft.new_zeros(Ft.shape[0], kp)
        Fr[:, :k] = Ft[:, :k]
    out = torch.empty(rows, ncols, dtype=Ft.dtype, device=Ft.device)
    launch('rri_gram_contract', Fr, Fr.data_ptr(),
           layout.colptr.data_ptr(), layout.gidx.data_ptr(),
           layout.vals.data_ptr(), out.data_ptr(), k, kp, t0, p, ncols)
    LAUNCHES['gram'] += 1
    return out


def mxu_contract(plan, F):
    """B5's interface: ``out (k, spad) = F @ X`` for a :class:`~rri_nmf_
    tpu_torch.ops.sparse_plan.ContractPlan`, F (k, gpad) covering every
    factor tile (see :func:`mxu_contract_ref`). Runs
    :func:`gather_contract` on Fᵀ; counts under ``LAUNCHES['mxu']``."""
    nchunks = plan.ftile.shape[0]
    if nchunks % plan.otile.shape[0]:
        raise ValueError('plan chunk count %d is not a multiple of its %d '
                         'groups' % (nchunks, plan.otile.shape[0]))
    k, gpad = F.shape
    if gpad % TILE or gpad // TILE != plan.n_gtiles:
        raise ValueError('F must have %d columns (the plan\'s %d tiles of '
                         '%d), got %d' % (plan.n_gtiles * TILE, plan.n_gtiles,
                                          TILE, gpad))
    return gather_contract(plan, F.T, k, plan.mask.shape[1], 'mxu')


def dma_contract(plan, F3):
    """B6's interface: ``out (k, spad) = F @ X`` for a :class:`~rri_nmf_
    tpu_torch.ops.sparse_plan.DMAContractPlan`, ``F3`` (n_tiles, k, 128)
    holding F's tiles (see :func:`dma_contract_ref`). Runs
    :func:`gather_contract` on Fᵀ; counts under ``LAUNCHES['dma']``."""
    n_tiles, k, width = F3.shape
    if width != TILE or n_tiles != plan.n_gtiles:
        raise ValueError('F3 must be (%d, k, %d), got %s'
                         % (plan.n_gtiles, TILE, tuple(F3.shape)))
    Ft = F3.permute(0, 2, 1).reshape(n_tiles * TILE, k)
    return gather_contract(plan, Ft, k, plan.mask.shape[1], 'dma')


# ---------------------------------------------------------------------------
# the two numerator products of the sparse sweep
# ---------------------------------------------------------------------------

def _padded(F, m):
    """(k, m) -> (k, 128·ceil(m/128)), zero columns after m: the factor
    panel of B5's interface."""
    k = F.shape[0]
    Fp = F.new_zeros(k, -(-m // TILE) * TILE)
    Fp[:, :m] = F
    return Fp


def _tile_cols(F, m):
    """(k, m) factor -> (n_tiles, k, 128) contiguous tile slabs: the
    factor of B6's interface."""
    Fp = _padded(F, m)
    k = Fp.shape[0]
    return Fp.reshape(k, -1, TILE).permute(1, 0, 2).contiguous()


def _kind(plan):
    if isinstance(plan, SparseDMAPlan):
        return 'dma'
    if isinstance(plan, SparseMXUPlan):
        return 'mxu'
    raise TypeError('expected a SparseMXUPlan or SparseDMAPlan, got %s'
                    % type(plan).__name__)


def contract_wtx(plan, W):
    """``WᵀX`` (k, d) for W (n, k): the kernel gathers W's rows (W itself
    is Fᵀ), one output column of X at a time; B5 or B6 by the plan's
    type."""
    return gather_contract(plan.t_phase, W, W.shape[1], plan.d, _kind(plan))


def contract_xtt(plan, T):
    """``T Xᵀ`` (k, n) for T (k, d): the kernel gathers Tᵀ's rows, one row
    of X at a time; B5 or B6 by the plan's type."""
    return gather_contract(plan.w_phase, T.T, T.shape[0], plan.n,
                           _kind(plan))
