"""Sparse contractions ``F @ X`` over a chunk plan: kernels B5 and B6.

Counterpart of the kernel halves of :mod:`rri_nmf_tpu.ops.sparse_mxu`
and :mod:`rri_nmf_tpu.ops.sparse_dma`. The sparse sweep needs ``WᵀX``
(k, d) and ``T Xᵀ`` (k, n) once per phase; X comes as a host plan
(:mod:`rri_nmf_tpu_torch.ops.sparse_plan`) and the factor ``F`` (``Wᵀ``
or ``T``) as a (k, 128·n_tiles) panel:

- **B5** (``csrc/sparse.cu`` ``mxu_kernel``, wrapper :func:`mxu_contract`)
  takes the grouped plan of :func:`~rri_nmf_tpu_torch.ops.sparse_plan.
  plan_sparse_matrix` and F as one (k, gpad) panel;
- **B6** (``csrc/sparse.cu`` ``dma_kernel``, wrapper :func:`dma_contract`)
  takes the CSR-offset plan of :func:`~rri_nmf_tpu_torch.ops.sparse_plan.
  plan_sparse_matrix_dma` and F pre-cut into (n_tiles, k, 128) slabs.

Each wrapper takes a CPU tensor to its plain PyTorch twin
(:func:`mxu_contract_ref`, :func:`dma_contract_ref`: a gather of factor
columns times the values, then ``index_add_`` into the output columns,
in slices whose gather temporary stays under ~2 GB) and a CUDA tensor to
its kernel — or raises. ``LAUNCHES`` counts the kernel launches.
:func:`contract_wtx` and :func:`contract_xtt` pad or tile the factor for
either plan type and cut the padding off the result.
"""

import torch

from rri_nmf_tpu_torch.ops._build import CTYPES, device_fits, launch
from rri_nmf_tpu_torch.ops.sparse_plan import (TILE, SparseDMAPlan,
                                               SparseMXUPlan)

# Kernel launches per wrapper since the last reset_launches(). A wrapper
# adds one right after its kernel launched, and nowhere else.
LAUNCHES = {'mxu': 0, 'dma': 0}

# Largest gather temporary of a twin, in bytes.
GATHER_BUDGET = 2 << 30


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def sparse_fits(k, dtype, device, C=TILE):
    """Whether B5 and B6 can run at ``k`` on ``device``: each holds a
    (k, 128) accumulator and its chunk metadata in shared memory (the
    staged factor tiles join them when they fit too; otherwise the kernels
    read F from device memory). On an H100 that is k up to ~430 in
    float32, ~200 in float64. The answer is the launchers' own gate
    (``csrc/sparse.cu`` ``rri_sparse_fits``), which builds the kernels on
    the first call. On any other device the twins run, and they have no
    such limit."""
    return device_fits('rri_sparse_fits', dtype, device, k, C)


def _check_factor(F):
    if F.dtype in (torch.bfloat16, torch.float16):
        raise NotImplementedError(
            '%s factors (16-bit storage) are not ported to rri_nmf_tpu_torch '
            'yet; they arrive with ROADMAP A.8' % F.dtype)


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


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_cuda(F, k, n_tiles, C, plan, indices):
    """The kernels' operand checks: ``F`` a contiguous float32/float64
    CUDA tensor holding the plan's ``n_tiles`` factor tiles of ``k``
    rows; the plan's values (chunks of ``C`` slots) in F's dtype and
    ``indices`` (name -> dtype), all contiguous on F's device."""
    if F.device.type != 'cuda':
        raise ValueError('the kernels run on CUDA or (plain twin) CPU '
                         'tensors, got %s' % F.device)
    if F.dtype not in CTYPES:
        raise ValueError('the kernels take float32/float64, got %s'
                         % F.dtype)
    if not F.is_contiguous():
        raise ValueError('the factor must be contiguous')
    if n_tiles != plan.n_gtiles:
        raise ValueError('the factor holds %d tiles of %d columns; the plan '
                         'gathers from %d' % (n_tiles, TILE, plan.n_gtiles))
    for name, dtype in dict(indices, vals=F.dtype).items():
        a = getattr(plan, name)
        if a.device != F.device or a.dtype != dtype:
            raise ValueError('plan %s must be %s on %s, got %s on %s' % (
                name, dtype, F.device, a.dtype, a.device))
        if not a.is_contiguous():
            raise ValueError('plan %s must be contiguous' % name)
    if not sparse_fits(k, F.dtype, F.device, C):
        raise ValueError('k=%d exceeds the sparse kernels\' shared memory '
                         '(a (k, 128) %s accumulator)' % (k, F.dtype))


def mxu_contract(plan, F):
    """B5: ``out (k, spad) = F @ X`` (see :func:`mxu_contract_ref`).

    A CPU ``F`` runs the plain twin; a CUDA ``F`` launches
    ``csrc/sparse.cu`` (``mxu_kernel``) with the plan on F's device."""
    _check_factor(F)
    nchunks = plan.ftile.shape[0]
    if nchunks % plan.otile.shape[0]:
        raise ValueError('plan chunk count %d is not a multiple of its %d '
                         'groups' % (nchunks, plan.otile.shape[0]))
    if F.device.type == 'cpu':
        return mxu_contract_ref(plan, F)
    k, gpad = F.shape
    if gpad % TILE:
        raise ValueError('F must have a multiple of %d columns, got %d'
                         % (TILE, gpad))
    C = plan.vals.shape[1] // nchunks
    _check_cuda(F, k, gpad // TILE, C, plan,
                {'gloc': torch.uint8, 'sloc': torch.uint8,
                 'ftile': torch.int32, 'tstart': torch.int32})
    spad = plan.mask.shape[1]
    out = torch.empty(k, spad, dtype=F.dtype, device=F.device)
    launch('rri_sparse_mxu', F, F.data_ptr(), plan.vals.data_ptr(),
           plan.gloc.data_ptr(), plan.sloc.data_ptr(), plan.ftile.data_ptr(),
           plan.tstart.data_ptr(), out.data_ptr(), k, gpad, spad // TILE, C)
    LAUNCHES['mxu'] += 1
    return out


def dma_contract(plan, F3):
    """B6: ``out (k, spad) = F @ X`` (see :func:`dma_contract_ref`).

    A CPU ``F3`` runs the plain twin; a CUDA ``F3`` launches
    ``csrc/sparse.cu`` (``dma_kernel``) with the plan on F3's device."""
    _check_factor(F3)
    if F3.device.type == 'cpu':
        return dma_contract_ref(plan, F3)
    n_tiles, k, width = F3.shape
    C = plan.vals.shape[1] // plan.ftile.shape[0]
    _check_cuda(F3, k, n_tiles, C, plan,
                {'idx': torch.uint8, 'ftile': torch.int32,
                 'uotile': torch.int32, 'ostart': torch.int32})
    if width != TILE or C % 16:
        raise ValueError('F3 must be (n_tiles, k, %d) and the chunk size a '
                         'multiple of 16; got %s and C=%d'
                         % (TILE, tuple(F3.shape), C))
    if plan.idx.shape[1] >= 2 ** 31:
        raise ValueError('plan too large for 32-bit slot offsets')
    spad = plan.mask.shape[1]
    out = torch.zeros(k, spad, dtype=F3.dtype, device=F3.device)
    launch('rri_sparse_dma', F3, F3.data_ptr(), plan.vals.data_ptr(),
           plan.idx.data_ptr(), plan.ftile.data_ptr(),
           plan.uotile.data_ptr(), plan.ostart.data_ptr(), out.data_ptr(), k,
           plan.uotile.shape[0], spad, C, plan.idx.shape[1])
    LAUNCHES['dma'] += 1
    return out


# ---------------------------------------------------------------------------
# the two numerator products of the sparse sweep
# ---------------------------------------------------------------------------

def _padded(F, m):
    """(k, m) -> (k, 128·ceil(m/128)), zero columns after m."""
    k = F.shape[0]
    Fp = F.new_zeros(k, -(-m // TILE) * TILE)
    Fp[:, :m] = F
    return Fp


def _tile_cols(F, m):
    """(k, m) factor -> (n_tiles, k, 128) contiguous tile slabs."""
    Fp = _padded(F, m)
    k = Fp.shape[0]
    return Fp.reshape(k, -1, TILE).permute(1, 0, 2).contiguous()


def _contract(plan, direction, F, m, out_cols):
    if isinstance(plan, SparseDMAPlan):
        out = dma_contract(direction, _tile_cols(F, m))
    elif isinstance(plan, SparseMXUPlan):
        out = mxu_contract(direction, _padded(F, m))
    else:
        raise TypeError('expected a SparseMXUPlan or SparseDMAPlan, got %s'
                        % type(plan).__name__)
    return out[:, :out_cols].contiguous()


def contract_wtx(plan, W):
    """``WᵀX`` (k, d) for W (n, k): gather W rows, scatter into columns;
    B5 or B6 by the plan's type."""
    return _contract(plan, plan.t_phase, W.T, plan.n, plan.d)


def contract_xtt(plan, T):
    """``T Xᵀ`` (k, n) for T (k, d): gather T columns, scatter into
    rows; B5 or B6 by the plan's type."""
    return _contract(plan, plan.w_phase, T, plan.d, plan.n)
