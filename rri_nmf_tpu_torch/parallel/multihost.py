"""Multi-host wiring of the mesh paths: joining the process group, a mesh
over the whole world laid out by host, and each rank's own slab of X.

Counterpart of :mod:`rri_nmf_tpu.parallel.multihost`. Every mesh sweep of
:mod:`rri_nmf_tpu_torch.parallel` already runs on one rank's block of X,
and every collective is an all-reduce along one mesh axis, so the sweeps
span hosts as they are. What a fit across hosts needs beside them is what
this module holds: :func:`initialize_distributed` (the process group),
:func:`make_global_mesh` (a mesh whose ``tp`` rows never span hosts) and
the slab entry points, so that no rank ever holds X whole:

    initialize_distributed -> make_global_mesh -> process_row_block ->
    distribute_dense / distribute_sparse_coo / distribute_masked_coo
    (+ distribute_factors) -> nmf(X_rank, ..., mesh=mesh)

**What torch changes.** JAX runs one process per host over that host's
devices; torch runs one process per rank, one device each. So JAX's
"process" is a rank here, its "host" a node of ranks, and its
"process-local data" the rank's own block. Blocks follow
:func:`~rri_nmf_tpu_torch.parallel.mesh.block_range` (``torch.
tensor_split``'s rule) on every path, as every mesh sweep reads them;
JAX's clamped ceil-chunks and its TILE-rounded quanta do not apply, and
no rank's slab is empty (:meth:`~rri_nmf_tpu_torch.parallel.mesh.Mesh.
split` raises when an axis has more ranks than rows or columns).

**Layout.** Per sweep a dense mesh fit all-reduces ``(k, d/tp)`` over
``dp`` (the T-phase numerator), ``(k, n/dp)`` over ``tp`` and two
``(k, k)`` Grams. With ``dp`` across hosts and ``tp`` within one, only
the first, whose size does not grow with n, crosses the slow link, as
in JAX (``make_global_mesh``'s rule).

**Slabs.** A dense slab becomes a :class:`RankBlock` (the rank's block
and its :class:`~rri_nmf_tpu_torch.parallel.mesh.Split`), which
``nmf()`` takes as X, as a dense ``W_mat`` and as ``W_in``. A sparse slab
becomes the rank's plan, the same plan the whole-X partitioners make
(:func:`~rri_nmf_tpu_torch.parallel.sparse_mesh.partition_coo`,
``partition_mxu``, ``partition_masked_coo``, ``partition_masked_gram``:
the same slicing of the rank's rows and the same planning half, so the
two agree bit for bit), carrying its ``split``; ``nmf()`` takes it as X
and runs the sweep its type names. JAX allgathers the plans' padding
width, nnz, ``Σ m x²`` and chunk-group counts so that every device runs
one program; each rank here runs its own unpadded plan, and the
sparse-mask objective already sums each block's ``Σ m x²`` in its one
scalar all-reduce, so none of those exchanges has a counterpart.
"""

import collections
import logging
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from rri_nmf_tpu_torch.matrixops import (as_tensor, default_float,
                                         fit_device, is_sparse)
from rri_nmf_tpu_torch.ops.sparse_plan import SparsePlan, plan_sparse_matrix
from rri_nmf_tpu_torch.ops.sweep_masked_gram import (MaskedGramPlan,
                                                     plan_masked_gram)
from rri_nmf_tpu_torch.ops.sweep_masked_sparse import (MaskedCOOPlan,
                                                       plan_masked_coo)
from rri_nmf_tpu_torch.ops.sweep_sparse import TorchSparseX
from rri_nmf_tpu_torch.parallel.masked_sparse_mesh import host_rows
from rri_nmf_tpu_torch.parallel.mesh import (AXES, Split, block_range,
                                             make_mesh)
from rri_nmf_tpu_torch.parallel.sparse_mesh import block_coo

logger = logging.getLogger(__name__)

# torchrun's environment: the counterpart of JAX's pod autodetection
_TORCHRUN = ('RANK', 'WORLD_SIZE', 'MASTER_ADDR')


class RankBlock(collections.namedtuple('RankBlock', 'block split host')):
    """One rank's block of a dense matrix that no rank holds whole:
    ``block``, the contiguous (rows, columns) tensor on the rank's
    device, and ``split``, where it lies in the whole problem
    (:class:`~rri_nmf_tpu_torch.parallel.mesh.Split`; ``shape`` is the
    whole matrix's). ``host`` records that the slab came as host data,
    which takes the device's default float in ``nmf()`` as host data
    does. Made by :func:`distribute_dense` and :func:`distribute_factors`."""

    __slots__ = ()

    @property
    def shape(self):
        return (self.split.n, self.split.d)

    @property
    def dtype(self):
        return self.block.dtype

    @property
    def device(self):
        return self.block.device


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, local_device_ids=None,
                           backend=None):
    """Join (or create) the default ``torch.distributed`` process group;
    returns ``(rank, world_size)``.

    - When a group exists, returns its values (idempotent).
    - ``coordinator_address`` (``'host:port'``) meets the other ranks
      through ``init_method='tcp://host:port'``; ``num_processes`` and
      ``process_id`` are the world size and this rank (default: torchrun's
      ``WORLD_SIZE`` and ``RANK``). A failure then raises.
    - With no arguments, torchrun's environment (``RANK``, ``WORLD_SIZE``,
      ``MASTER_ADDR``), the counterpart of JAX's pod autodetection, joins
      through ``env://``; a failure there is logged and the session stays
      single-process. Without that environment nothing is initialized and
      ``(0, 1)`` comes back.
    - ``local_device_ids``: the one card id of this rank (an int or a
      one-element sequence; default torchrun's ``LOCAL_RANK``), set with
      ``torch.cuda.set_device``. More than one id raises ``ValueError``:
      a rank has one device.
    - ``backend``: NCCL when this rank has a card, else gloo (JAX has no
      counterpart; ranks that share one card pass ``'gloo'``)."""
    if local_device_ids is not None:
        ids = ([local_device_ids] if np.ndim(local_device_ids) == 0
               else list(local_device_ids))
        if len(ids) != 1:
            raise ValueError('local_device_ids=%r: a rank drives one device '
                             '(one process per card)' % (local_device_ids,))
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    explicit = coordinator_address is not None or num_processes is not None
    if not explicit and not all(os.environ.get(v) for v in _TORCHRUN):
        return 0, 1
    if local_device_ids is not None:
        local = int(ids[0])
    else:
        local = os.environ.get('LOCAL_RANK')
        local = None if local is None else int(local)
    cuda = torch.cuda.is_available()
    if local is not None and cuda:
        torch.cuda.set_device(local)
    if backend is None:
        backend = 'nccl' if cuda else 'gloo'
    kwargs = {}
    if coordinator_address is not None:
        kwargs['init_method'] = 'tcp://%s' % coordinator_address
    else:
        kwargs['init_method'] = 'env://'
    world = num_processes if num_processes is not None else \
        os.environ.get('WORLD_SIZE')
    rank = process_id if process_id is not None else os.environ.get('RANK')
    if world is not None:
        kwargs['world_size'] = int(world)
    if rank is not None:
        kwargs['rank'] = int(rank)
    try:
        dist.init_process_group(backend, **kwargs)
    except (ValueError, RuntimeError) as e:
        if explicit:
            raise
        logger.info('torch.distributed from the environment declined (%s); '
                    'staying single-process', e)
        return 0, 1
    logger.info('torch.distributed initialized: rank %d/%d (%s)',
                dist.get_rank(), dist.get_world_size(), backend)
    return dist.get_rank(), dist.get_world_size()


def _host_of_ranks(world):
    """The host index of every rank: ``rank // LOCAL_WORLD_SIZE`` under
    torchrun (node-major ranks), else from one ``all_gather_object`` of
    the host names, numbered in order of first appearance."""
    local = os.environ.get('LOCAL_WORLD_SIZE')
    if local:
        return [r // int(local) for r in range(world)]
    names = [None] * world
    dist.all_gather_object(names, socket.gethostname())
    order = {}
    return [order.setdefault(h, len(order)) for h in names]


def make_global_mesh(mesh_shape=None, axis_names=AXES):
    """A ``(dp, tp)`` :class:`~rri_nmf_tpu_torch.parallel.mesh.Mesh` over
    the world, laid out by host: each ``tp`` row within one host, so only
    the ``(k, d/tp)`` T-phase all-reduce over ``dp`` crosses hosts (the
    module docstring). The ranks are ordered host by host (within a host
    by rank) and the shape fills row by row.

    ``mesh_shape`` defaults to ``(hosts, ranks_per_host)`` across more
    than one host and to :func:`~rri_nmf_tpu_torch.parallel.mesh.
    make_mesh`'s rule on one. A shape whose ``tp`` row would span hosts,
    or hosts with unequal rank counts, raise ``ValueError``. Every rank
    of the world calls it, after :func:`initialize_distributed`."""
    if not (dist.is_available() and dist.is_initialized()):
        return make_mesh(mesh_shape=mesh_shape, axis_names=axis_names)
    world = dist.get_world_size()
    hosts = _host_of_ranks(world)
    per_host = collections.Counter(hosts)
    n_hosts = len(per_host)
    if mesh_shape is None and n_hosts > 1:
        mesh_shape = (n_hosts, world // n_hosts)
    order = sorted(range(world), key=lambda r: (hosts[r], r))
    if mesh_shape is None:
        return make_mesh(mesh_shape=None, axis_names=axis_names, ranks=order)
    dp, tp = (int(s) for s in mesh_shape)
    rows = [[hosts[r] for r in order[i * tp:(i + 1) * tp]]
            for i in range(dp)]
    if len(set(per_host.values())) > 1 or any(len(set(row)) > 1
                                               for row in rows):
        raise ValueError('cannot lay out mesh_shape=%r with tp inside a '
                         'process: hosts own %s ranks'
                         % ((dp, tp), dict(sorted(per_host.items()))))
    return make_mesh(dp * tp, (dp, tp), axis_names, ranks=order[:dp * tp])


def process_row_block(n, mesh):
    """The ``[start, stop)`` rows of X this rank loads: the
    :func:`~rri_nmf_tpu_torch.parallel.mesh.block_range` of its ``dp``
    coordinate (every rank of a ``dp`` row loads the same rows). The
    range is the same for every backend: each rank plans its own unpadded
    block, so the ``'mxu'`` plans need no TILE-rounded quantum (JAX's
    ``tile``). A rank outside ``mesh``, or a ``dp`` larger than ``n``,
    raises ``ValueError``."""
    i, _ = mesh.member()
    if n < mesh.shape[0]:
        raise ValueError('%d rows cannot be split over the %r: every rank '
                         'needs a row' % (n, mesh))
    return block_range(n, mesh.shape[0], i)


def _check_slab(what, A, split):
    rows, cols = int(np.shape(A)[0]), int(np.shape(A)[1])
    if rows != split.r1 - split.r0:
        raise ValueError(
            '%s has %d rows but this rank owns rows [%d, %d) of the global '
            '(%d, %d) problem (process_row_block(n, mesh))'
            % (what, rows, split.r0, split.r1, split.n, split.d))
    if cols != split.d:
        raise ValueError('%s has %d columns, the global problem has %d'
                         % (what, cols, split.d))


def _fit_dtype(X, dtype, device):
    """``nmf()``'s dtype rule for a slab: ``dtype``; else a tensor's float
    dtype, host data's float dtype on the CPU, the device's default float
    otherwise."""
    from rri_nmf_tpu_torch.nmf import _parse_dtype
    if dtype is not None:
        return _parse_dtype(dtype)
    dt = _parse_dtype(X.dtype)
    if dt.is_floating_point and (isinstance(X, torch.Tensor)
                                 or device.type == 'cpu'):
        return dt
    return default_float(device)


def distribute_dense(X_local, global_shape, mesh, device=None):
    """This rank's :class:`RankBlock` of the dense (n, d) ``X`` from its
    row slab ``X_local`` (numpy or a tensor: :func:`process_row_block`'s
    rows, all d columns): its columns of the slab, contiguous on
    ``device`` (default: a tensor's own device, the card for numpy), in
    the slab's dtype, and its ``split`` (``mesh.split(n, d)``). ``nmf()``
    takes it as X and as a dense ``W_mat``. A slab of other rows or
    columns raises ``ValueError``."""
    if is_sparse(X_local):
        raise ValueError('distribute_dense takes a dense slab; partition a '
                         'sparse one with distribute_sparse_coo')
    n, d = (int(s) for s in global_shape)
    split = mesh.split(n, d)
    _check_slab('X_local', X_local, split)
    host = not isinstance(X_local, torch.Tensor)
    device = fit_device(X_local, device)
    block = as_tensor(X_local[:, split.c0:split.c1], device=device)
    return RankBlock(block.contiguous(), split, host)


def distribute_factors(W_local, T, n, mesh, device=None):
    """Warm starts from this rank's rows of W: ``(W_rank, T)``, where
    ``W_rank`` is a :class:`RankBlock` of W's rows of this rank
    (:func:`process_row_block`'s; whole columns) and T the whole (k, d)
    factor every rank passes, both on ``device`` (default: a tensor's
    own, the card for numpy)."""
    k = int(np.shape(W_local)[1])
    r0, r1 = process_row_block(n, mesh)
    _check_slab('W_local', W_local, Split(int(n), k, r0, r1, 0, k))
    host = not isinstance(W_local, torch.Tensor)
    device = fit_device(W_local, device)
    W = as_tensor(W_local, device=device).contiguous()
    return (RankBlock(W, Split(int(n), k, r0, r1, 0, k), host),
            as_tensor(T, device=device))


def distribute_sparse_coo(X_local, global_shape, mesh, dtype=None,
                          backend=None, with_obj_coo=True, device=None):
    """This rank's sparse-X plan from its row slab ``X_local`` (scipy
    sparse, a torch sparse tensor or dense: :func:`process_row_block`'s
    rows, all d columns), the same plan :func:`~rri_nmf_tpu_torch.
    parallel.sparse_mesh.partition_coo` / ``partition_mxu`` make of the
    whole X, bit for bit: the rank's columns in local indices.

    ``backend=None`` returns the block as a :class:`~rri_nmf_tpu_torch.
    ops.sweep_sparse.TorchSparseX` (``torch.sparse.mm``); ``'mxu'`` its
    :class:`~rri_nmf_tpu_torch.ops.sparse_plan.SparsePlan` for the
    gather kernel, with the COO block as ``plan.obj_coo`` for the
    objective unless ``with_obj_coo=False``.
    Values in ``dtype`` (default: ``nmf()``'s rule), on ``device``
    (default: a tensor's own, the card for host data). The plan carries
    the rank's ``split`` (its ``n``, ``d`` are the whole problem's);
    ``nmf()`` takes it as X with ``W_in`` and ``T_in``
    (:func:`distribute_factors`) and checks it against its mesh. Unlike
    the masked plans, a ``(dp, tp)`` mesh is allowed."""
    if backend not in (None, 'mxu'):
        raise ValueError("backend must be None or 'mxu', got %r"
                         % (backend,))
    n, d = (int(s) for s in global_shape)
    split = mesh.split(n, d)
    _check_slab('X_local', X_local, split)
    device = fit_device(X_local, device)
    dtype = _fit_dtype(X_local, dtype, device)
    rows = split.r1 - split.r0
    if backend is None:
        plan = TorchSparseX(block_coo(X_local, 0, rows, split.c0, split.c1,
                                      dtype, device))
    else:
        plan = plan_sparse_matrix(block_coo(X_local, 0, rows, split.c0,
                                            split.c1), dtype, device=device)
        plan.obj_coo = (block_coo(X_local, 0, rows, split.c0, split.c1,
                                  dtype, device) if with_obj_coo else None)
    plan.split = split
    return plan


def distribute_masked_coo(X_local, W_mat_local, global_shape, mesh,
                          dtype=None, backend=None, device=None):
    """This rank's sparse-mask plan from its row slabs of X (dense or
    sparse) and of the mask ``W_mat_local`` (scipy or torch sparse): the
    plan :func:`~rri_nmf_tpu_torch.parallel.masked_sparse_mesh.
    partition_masked_coo` / :func:`~rri_nmf_tpu_torch.parallel.
    masked_gram_mesh.partition_masked_gram` make of the whole X and mask,
    bit for bit. ``mesh`` must be ``(dp, 1)``.

    ``backend=None`` returns the rank's :class:`~rri_nmf_tpu_torch.ops.
    sweep_masked_sparse.MaskedCOOPlan` (the O(nnz) interleaved sweep);
    ``'segsum'`` or ``'mxu'`` its :class:`~rri_nmf_tpu_torch.ops.
    sweep_masked_gram.MaskedGramPlan` (the Gram-phase sweep; ``'mxu'``
    contracts through the gather kernel). Values in ``dtype`` (default:
    ``nmf()``'s rule), on ``device``. The plan carries the rank's
    ``split``; ``nmf()`` takes it as X, with ``W_mat=None`` and ``W_in``
    and ``T_in`` (:func:`distribute_factors`). The nonzeros never leave
    their rank: the plan is unpadded, and the objective sums each
    block's ``Σ m x²`` in its one scalar all-reduce (module docstring)."""
    n, d = (int(s) for s in global_shape)
    if mesh.shape[1] != 1:
        raise ValueError('masked mesh plans are row-partitioned; use an '
                         '(n_devices, 1) mesh')
    if backend not in (None, 'segsum', 'mxu'):
        raise ValueError("backend must be None, 'segsum' or 'mxu', got %r"
                         % (backend,))
    split = mesh.split(n, d)
    _check_slab('X_local', X_local, split)
    if not is_sparse(W_mat_local):
        raise ValueError('W_mat_local must be scipy-sparse or a torch '
                         'sparse tensor (the mask IS the observed set)')
    _check_slab('W_mat_local', W_mat_local, split)
    device = fit_device(X_local, device)
    dtype = _fit_dtype(X_local, dtype, device)
    X_rows, M_rows = host_rows(X_local, W_mat_local, 0, split.r1 - split.r0)
    plan = (plan_masked_coo(X_rows, M_rows, dtype, device=device)
            if backend is None else
            plan_masked_gram(X_rows, M_rows, dtype, backend=backend,
                             device=device))
    plan.split = split
    return plan


# the pre-built plans nmf() takes as X, by the sweep each names
PLAN_KINDS = ((TorchSparseX, 'coo'), (SparsePlan, 'mxu'),
              (MaskedCOOPlan, 'masked_coo'), (MaskedGramPlan, 'masked_gram'))


def plan_kind(X):
    """``'coo'``, ``'mxu'``, ``'masked_coo'`` or ``'masked_gram'`` for a
    plan made by :func:`distribute_sparse_coo` or
    :func:`distribute_masked_coo` (one that carries its ``split``), else
    None."""
    if getattr(X, 'split', None) is None:
        return None
    for cls, kind in PLAN_KINDS:
        if isinstance(X, cls):
            return kind
    return None


def plan_values(X):
    """A pre-built plan's value tensor (its dtype and device are the
    plan's)."""
    kind = plan_kind(X)
    if kind == 'coo':
        return X.coo
    if kind == 'mxu':
        return X.t_phase.vals
    return X.x_vals if kind == 'masked_coo' else X.coo.x_vals
