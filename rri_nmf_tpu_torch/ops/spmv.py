"""``X @ t`` from a dense X's nonzeros: the SpMV kernel ``csrc/spmv.cu``.

The interleaved sweep (:mod:`rri_nmf_tpu_torch.ops.sweep`) forms the W
side's ``X @ T[t]`` once per topic, k times a sweep. As a GEMV on the
dense X each of those reads all of X; a TF-IDF corpus is mostly zeros
(0.67% at the 20 Newsgroups shape: 16 MB of nonzeros in a 1.19 GB X).
:func:`sparse_rows` counts X's nonzeros once and, where X's density is
at most its device's crossover (:func:`max_density`: on a card
:data:`MAX_DENSITY`, on the CPU :data:`CPU_MAX_DENSITY`), builds
:class:`Rows`, X's nonzeros in CSR, from the dense X itself, so the
values are X's own. :func:`spmv` computes ``X @ t``
from them: on a CUDA tensor it launches the kernel and counts the launch
in ``LAUNCHES['spmv']``, on a CPU tensor it runs :func:`spmv_ref`, the
kernel's plain PyTorch twin. The dense X stays for every other product.

The kernel sums in the storage type (float32, float64), as the GEMV
does; a skipped zero adds exactly 0, so only the order of the sums
differs from the dense product. It uses no atomics: a launch repeats bit
for bit.
"""

from typing import NamedTuple, Tuple

import torch

from rri_nmf_tpu_torch.ops._build import check_operands, launch

# Kernel launches. The wrapper adds one right after the kernel launched;
# a sweep replayed as a CUDA graph adds those its capture recorded, once
# a replay (ops/sweep.Sweep.replay).
LAUNCHES = {'spmv': 0}

# Largest density (nonzeros over n·d) at which the sweep reads X's
# nonzeros in place of the dense X. On the H100 at the 20 Newsgroups
# shape the kernel and the GEMV cross at ~45% (uniform X, CUDA-graph
# replays: 0.349 against 0.393 ms at 40%, 0.390 against 0.392 at 45%,
# 0.424 against 0.392 at 50%; PERF.md §6).
MAX_DENSITY = 0.4

# The same for a CPU X, where :func:`spmv_ref` stands in for the kernel
# and beats the BLAS GEMV only on sparser X. On 8 threads, at 2,000×3,000
# and 4,000×8,000: at 0.5% the twin takes 0.21 and 0.68 ms against the
# GEMV's 0.28 and 1.96 in float32 (0.20 and 0.71 against 0.64 and 4.15
# in float64); at 1% float32 crosses (0.28 against 0.21 ms at the small
# shape), at 2-5% float64 does (0.59 against 0.63, 1.31 against 0.83).
CPU_MAX_DENSITY = 0.005

# Elements of X a step of :func:`row_counts` and :func:`rows_of` reads:
# their temporaries stay under 16 bytes an element of that (256 MB).
BUILD_ELEMS = 1 << 24

# Nonzeros a block of the kernel takes (8 a thread of its 256): the
# granularity of :func:`block_rows`.
CHUNK = 2048

DTYPES = (torch.float32, torch.float64)


class Rows(NamedTuple):
    """A matrix's nonzeros in CSR, as the kernel reads them: ``rowptr``
    (n + 1,), ``cols`` (nnz,) and ``blocks`` (nb + 1,) int32, ``vals``
    (nnz,) in the matrix's dtype, all on its device; ``shape`` (n, d).
    Block b of the kernel takes rows ``blocks[b]:blocks[b + 1]``."""
    rowptr: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    blocks: torch.Tensor
    shape: Tuple[int, int]


def block_rows(rowptr, chunk=CHUNK):
    """The first row of each block of the kernel, and n last: ``(nb + 1,)``
    int32. Block b starts at the row holding nonzero ``b·chunk`` (the
    first block at row 0), so a block holds about ``chunk`` nonzeros in
    whole rows, more where a row is longer; a row is never split between
    blocks."""
    n = rowptr.shape[0] - 1
    nnz = int(rowptr[-1])
    dev = rowptr.device
    targets = torch.arange(0, nnz, chunk, device=dev, dtype=rowptr.dtype)
    starts = torch.searchsorted(rowptr, targets, right=True) - 1
    if starts.numel():
        starts[0] = 0
    else:
        starts = torch.zeros(1, dtype=starts.dtype, device=dev)
    starts = torch.unique_consecutive(starts)
    return torch.cat([starts, starts.new_full((1,), n)]).to(torch.int32)


def _steps(X):
    """X's rows in blocks of about :data:`BUILD_ELEMS` elements."""
    n, d = X.shape
    step = max(1, BUILD_ELEMS // max(d, 1))
    return (X[i:i + step] for i in range(0, n, step))


def row_counts(X):
    """(n,) int64: the nonzeros of each row of the dense 2-D ``X``,
    counted a block of rows at a time."""
    return torch.cat([(Xb != 0).sum(1) for Xb in _steps(X)])


def rows_of(X, counts=None):
    """:class:`Rows` of the dense 2-D ``X``, on its device, in its dtype:
    each value is X's own, the nonzeros in row order. Built a block of
    rows at a time; ``counts``: :func:`row_counts` of X, if known."""
    n, d = X.shape
    if counts is None:
        counts = row_counts(X)
    cols, vals = [], []
    for Xb in _steps(X):
        r, c = Xb.nonzero().unbind(1)
        cols.append(c.to(torch.int32))
        vals.append(Xb[r, c])
    rowptr = torch.zeros(n + 1, dtype=torch.int64, device=X.device)
    torch.cumsum(counts, 0, out=rowptr[1:])
    if int(rowptr[-1]) >= 2 ** 31 - CHUNK:
        raise ValueError('X has %d nonzeros; the kernel indexes them in '
                         '32 bits' % int(rowptr[-1]))
    return Rows(rowptr.to(torch.int32), torch.cat(cols), torch.cat(vals),
                block_rows(rowptr), (n, d))


def takes(X):
    """Whether :func:`sparse_rows` reads ``X`` at all: a dense strided 2-D
    float32 or float64 tensor (a 16-bit X and a ``QuantizedX`` keep the
    dense product)."""
    return (isinstance(X, torch.Tensor) and X.layout == torch.strided
            and X.dim() == 2 and X.dtype in DTYPES)


def max_density(X):
    """The largest density at which ``X`` is read through its nonzeros:
    :data:`MAX_DENSITY` on a card, :data:`CPU_MAX_DENSITY` on the CPU."""
    return MAX_DENSITY if X.is_cuda else CPU_MAX_DENSITY


def sparse_rows(X):
    """:class:`Rows` of ``X`` where its density is at most
    :func:`max_density` and, on a card, they take at most half its free
    memory; else None. One pass counts the nonzeros and a host read
    takes the count: call it outside any CUDA graph capture, once per
    X."""
    if not takes(X) or X.numel() == 0:
        return None
    counts = row_counts(X)
    nnz = int(counts.sum())
    if nnz > max_density(X) * X.numel():
        return None
    if X.is_cuda and 2 * nnz * (4 + X.element_size()) > \
            torch.cuda.mem_get_info(X.device)[0]:
        return None
    return rows_of(X, counts)


def spmv_ref(rows, t):
    """Plain version of the kernel: ``out (n,)``, row i the sum over its
    nonzeros j of ``v_j · t[col_j]`` (``segment_reduce``; an empty row
    is 0), in t's dtype."""
    return torch.segment_reduce(rows.vals.to(t.dtype) * t[rows.cols.long()],
                                'sum', offsets=rows.rowptr.long(),
                                unsafe=True)


def spmv(rows, t):
    """``X @ t`` (n,) for X's :class:`Rows` ``rows`` and ``t`` (d,) of the
    values' dtype. A CPU ``t`` runs :func:`spmv_ref`; a CUDA ``t``
    launches ``csrc/spmv.cu`` on the current stream and counts it under
    ``LAUNCHES['spmv']``."""
    if t.device.type == 'cpu':
        return spmv_ref(rows, t)
    n, d = rows.shape
    if t.dtype not in DTYPES:
        raise ValueError('the SpMV kernel takes float32 or float64, got %s'
                         % t.dtype)
    check_operands(t, dict(t=(t, (d,)), vals=(rows.vals, rows.cols.shape)))
    index = t.get_device()
    for name in ('rowptr', 'cols', 'blocks'):
        a = getattr(rows, name)
        if (a.dtype != torch.int32 or not a.is_cuda
                or a.get_device() != index or not a.is_contiguous()):
            raise ValueError('%s must be contiguous int32 on %s, got %s on '
                             '%s' % (name, t.device, a.dtype, a.device))
    if rows.rowptr.shape[0] != n + 1:
        raise ValueError('rowptr must have %d entries, got %d'
                         % (n + 1, rows.rowptr.shape[0]))
    out = torch.empty(n, dtype=t.dtype, device=t.device)
    launch('rri_spmv', t, rows.rowptr.data_ptr(), rows.cols.data_ptr(),
           rows.vals.data_ptr(), rows.blocks.data_ptr(), t.data_ptr(),
           out.data_ptr(), rows.blocks.shape[0] - 1)
    LAUNCHES['spmv'] += 1
    return out
