"""Sparse contractions ``F @ X``: kernels B5 and B6, one CUDA kernel;
and B5 on Khatri-Rao rows formed on chip, the Gram kernel.

Counterpart of the kernel halves of :mod:`rri_nmf_tpu.ops.sparse_mxu`
and :mod:`rri_nmf_tpu.ops.sparse_dma`. The sparse sweep needs ``WᵀX``
(k, d) and ``T Xᵀ`` (k, n) once per phase. X comes as the two
output-column layouts of its :class:`~rri_nmf_tpu_torch.ops.sparse_plan.
SparsePlan` (:mod:`rri_nmf_tpu_torch.ops.sparse_plan`), built from X's
COO on the card, for ``sparse='mxu'`` and ``'dma'`` alike: JAX's two
TPU kernels, B5 on grouped tile chunks and B6 on CSR-offset chunks, are
one kernel here, on one format.

That kernel, ``csrc/sparse.cu`` ``gather_kernel``, computes ``out = F @
X`` on a layout, gathering rows of an L2-resident Fᵀ one output column
at a time. :func:`gather_contract` launches it and counts the launch in
``LAUNCHES['gather']``; :func:`contract_wtx` and :func:`contract_xtt`
hand it W itself and Tᵀ, and get (k, d) and (k, n).

Each wrapper takes a CPU tensor to :func:`gather_contract_ref`, the
kernel's plain PyTorch twin on the layout, and a CUDA tensor to the
kernel — or raises. 16-bit factors (bfloat16, float16) meet values of
their dtype, as the JAX kernels' narrow dots do: the products are exact
in float32, summed in float32, and the output is float32. Every twin
works in slices whose gather temporary stays under ~2 GB.

The Gram-phase sparse-mask sweep contracts the mask with the Khatri-Rao
rows ``f_a ⊙ f_b`` of a factor (Γ, Θ). JAX builds those rows and runs
B5 on them; here ``csrc/gram.cu`` ``gram_kernel`` forms them on chip
from Fᵀ's rows: :func:`gram_contract` launches it (float32 and float64,
counted under ``LAUNCHES['gram']``), and :func:`gram_contract_ref`, its
twin, builds the rows and runs :func:`gather_contract_ref`. A team of
the kernel walks one item of the layout's work list
(:meth:`~rri_nmf_tpu_torch.ops.sparse_plan.ColumnLayout.gram_work`):
a column, or a chunk of at most :func:`chunk_length` nonzeros of a longer
one, whose sums the launch adds chunk by chunk.
"""

import functools

import torch

from rri_nmf_tpu_torch.ops._build import CTYPES, SUFFIX, launch, load
from rri_nmf_tpu_torch.ops.quantized import work_dtype

# Kernel launches per kernel since the last reset_launches(). A wrapper
# adds one right after the kernel launched, and nowhere else.
# 'gram_split': the Gram launches whose work list cut a column into chunks.
LAUNCHES = {'gather': 0, 'gram': 0, 'gram_split': 0}

# Largest gather temporary of a twin, in bytes.
GATHER_BUDGET = 2 << 30

# The Gram kernel's chunk length (:func:`chunk_length`): a balanced
# share of a launch's nonzeros over this, and at least CHUNK_FLOOR.
CHUNK_SHARE = 8
CHUNK_FLOOR = 2048


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------

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


def chunk_length(nnz, teams):
    """The Gram kernel's chunk length L for a launch over ``nnz``
    nonzeros that holds ``teams`` teams at once: ``max(CHUNK_FLOOR,
    ceil(nnz / (teams · CHUNK_SHARE)))``, a ``CHUNK_SHARE``-th of a
    balanced share, and long enough that a chunk still hides its loads'
    latency."""
    return max(CHUNK_FLOOR,
               -(-int(nnz) // (max(int(teams), 1) * CHUNK_SHARE)))


def gram_rows(Ft, k):
    """``Ft`` (m, >= k) as the Gram kernel reads Fᵀ: contiguous rows of
    whole tiles (8 float32, 4 float64: 32 bytes), 16-byte aligned;
    ``Ft`` itself when it is so, else a zero-padded copy."""
    ti = 32 // Ft.element_size()
    kp = -(-k // ti) * ti
    if (Ft.is_contiguous() and Ft.shape[1] == kp
            and Ft.data_ptr() % 16 == 0):
        return Ft
    rows = Ft.new_zeros(Ft.shape[0], kp)
    rows[:, :k] = Ft[:, :k]
    return rows


@functools.lru_cache(maxsize=None)
def resident_teams(dtype, k, t0, p, index):
    """The teams a Gram launch at ``(k, t0, p)`` in ``dtype`` holds at
    once on CUDA device ``index``, per tile group (``csrc/gram.cu``
    ``rri_gram_resident``: the SMs, the build's occupancy, the teams a
    block at the launch's tile count)."""
    got = getattr(load(), 'rri_gram_resident_' + SUFFIX[dtype])(k, t0, p,
                                                              index)
    if got < 0:
        raise RuntimeError('rri_gram_resident failed: CUDA error %d' % -got)
    return got


def gram_tiles(k, t0, p, ti):
    """The ti×ti tiles a Gram launch computes per output column: the
    triangle's a-block <= b-block tiles (``p == 0``) or the panel's
    a-blocks against every b-block."""
    nbj = -(-k // ti)
    if p == 0:
        return nbj * (nbj + 1) // 2
    return (-(-(t0 + p) // ti) - t0 // ti) * nbj


def gram_args(layout, work, Fr, k, t0, p, ncols):
    """``(out, args, part)``: the Gram kernel's output (rows, ncols), the
    C entry's arguments after ``Fr`` (Fᵀ's rows of whole tiles) for the
    work list ``work`` (a :class:`~rri_nmf_tpu_torch.ops.sparse_plan.
    GramWork`), and the chunk scratch (None where no column is cut),
    which the caller holds until the kernel is enqueued: its pointer is
    in ``args``."""
    rows = p * k if p else k * (k + 1) // 2
    out = torch.empty(rows, ncols, dtype=Fr.dtype, device=Fr.device)
    part = None
    scratch = arrivals = 0
    if work.n_split:
        if work.last_split >= ncols:
            raise ValueError('column %d has nonzeros; %d output columns '
                             'asked for' % (work.last_split, ncols))
        ti = 32 // Fr.element_size()
        ntiles = gram_tiles(k, t0, p, ti)
        part = torch.empty(work.n_chunks * ntiles * ti * ti, dtype=Fr.dtype,
                           device=Fr.device)
        scratch = part.data_ptr()
        arrivals = work.arrivals(work.n_split * ntiles).data_ptr()
    return out, (Fr.data_ptr(), layout.gidx.data_ptr(),
                 layout.vals.data_ptr(), out.data_ptr(),
                 work.items.data_ptr(), work.split_ptr.data_ptr(), scratch,
                 arrivals, k, Fr.shape[1], t0, p, ncols,
                 work.n_items(ncols)), part


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


def gather_contract(layout, Ft, k, ncols, vals=None):
    """``out (k, ncols) = F @ X`` for the direction ``layout`` encodes (a
    :class:`~rri_nmf_tpu_torch.ops.sparse_plan.ColumnLayout`), ``F``'s
    rows given as ``Ft`` (m, >= k); ``ncols`` the output columns wanted
    (the layout's padded width, or fewer when the rest are empty).
    ``vals``: another matrix on the same nonzeros, its values in the
    layout's order (:meth:`~rri_nmf_tpu_torch.ops.sweep_masked_gram.
    MaskedGramPlan.mx_layout_values`; JAX's ``vals_override``). The
    output is Ft's dtype, float32 for 16-bit factors. A CPU ``Ft`` runs
    :func:`gather_contract_ref`; a CUDA ``Ft`` launches ``csrc/sparse.cu``
    and counts it under ``LAUNCHES['gather']``."""
    if Ft.device.type == 'cpu':
        return gather_contract_ref(layout, Ft, k, ncols, vals)
    if Ft.device.type != 'cuda':
        raise ValueError('the kernels run on CUDA or (plain twin) CPU '
                         'tensors, got %s' % Ft.device)
    if Ft.dtype not in CTYPES:
        raise ValueError('the kernels take float32/float64 or '
                         'bfloat16/float16, got %s' % Ft.dtype)
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
    LAUNCHES['gather'] += 1
    return out


def gram_contract(layout, Ft, k, panel, ncols):
    """``out (rows, ncols)``: the mask of the direction ``layout`` (a
    :class:`~rri_nmf_tpu_torch.ops.sparse_plan.ColumnLayout`) contracted
    with the Khatri-Rao rows ``f_a ⊙ f_b`` of Fᵀ's rows ``Ft`` (m, >= k),
    the pairs of :func:`gram_pairs` (``panel=None``: Γ/Θ's
    k(k+1)/2 unique rows; ``(t0, p)``: a p·k panel), without
    materializing them::

        out[r, c] = Σ_i v_i·Ft[g_i, a_r]·Ft[g_i, b_r]   (column c's nonzeros i)

    float32 or float64 (Γ/Θ are built in the accumulation dtype). A CPU
    ``Ft`` runs :func:`gram_contract_ref`; a CUDA ``Ft`` launches
    ``csrc/gram.cu`` on the layout's work list at the :func:`chunk_length`
    of this launch and counts it under ``LAUNCHES['gram']`` (and
    ``'gram_split'`` where the list cut a column)."""
    if Ft.dtype not in (torch.float32, torch.float64):
        raise ValueError('the Gram contraction takes float32 or float64 '
                         'factors, got %s' % Ft.dtype)
    t0, p = _gram_panel(k, panel)
    rows = p * k if p else k * (k + 1) // 2
    if Ft.dim() != 2 or Ft.shape[1] < k:
        raise ValueError('Ft must be (m, >= %d), got %s'
                         % (k, tuple(Ft.shape)))
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
    Fr = gram_rows(Ft, k)
    teams = resident_teams(Ft.dtype, k, t0, p, Ft.get_device())
    work = layout.gram_work(chunk_length(layout.gidx.shape[0], teams))
    out, args, part = gram_args(layout, work, Fr, k, t0, p, ncols)
    launch('rri_gram_contract', Fr, *args)
    del part  # enqueued: the allocator may hand its block on
    LAUNCHES['gram'] += 1
    if work.n_split:
        LAUNCHES['gram_split'] += 1
    return out


# ---------------------------------------------------------------------------
# the two numerator products of the sparse sweep
# ---------------------------------------------------------------------------

def contract_wtx(plan, W):
    """``WᵀX`` (k, d) for W (n, k) and the :class:`~rri_nmf_tpu_torch.
    ops.sparse_plan.SparsePlan` of X: the kernel gathers W's rows (W
    itself is Fᵀ), one output column of X at a time."""
    return gather_contract(plan.t_phase, W, W.shape[1], plan.d)


def contract_xtt(plan, T):
    """``T Xᵀ`` (k, n) for T (k, d): the kernel gathers Tᵀ's rows, one row
    of X at a time."""
    return gather_contract(plan.w_phase, T.T, T.shape[0], plan.n)
