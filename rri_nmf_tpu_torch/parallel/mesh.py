"""Mesh distribution of the sweeps over ``torch.distributed``.

Counterpart of :mod:`rri_nmf_tpu.parallel.mesh`. The layouts are JAX's,
on a 2-D mesh ``('dp', 'tp')`` of ranks:

- ``X`` (n, d) is split over both axes: rows over ``dp``, columns over
  ``tp``;
- ``W`` (n, k) splits its rows over ``dp`` and is the same on every
  ``tp`` rank;
- ``T`` (k, d) splits its columns over ``tp`` and is the same on every
  ``dp`` rank.

Every per-topic contraction of a sweep then sums over one axis, and a
sweep all-reduces exactly where GSPMD inserts JAX's ``psum``: ``WᵀX`` and
``||W[:, t]||²`` over ``dp``, ``X @ T[t]`` and ``||T[t]||²`` over ``tp``.
A T-row simplex projection needs the whole row, so the row is gathered
over ``tp`` and each rank keeps its own columns (GSPMD gathers it too).

**One process per rank.** JAX runs one controller over many devices;
torch runs one process per rank. The caller initializes the default
process group (``torch.distributed.init_process_group``: NCCL between
cards, gloo on the CPU) and every rank calls :func:`make_mesh` and then
``nmf(X, ..., mesh=mesh)`` with the whole X; each rank keeps only its
block. A rank's collectives reach only the ranks of its mesh axis, and an
axis of one rank costs nothing: a one-rank mesh runs the single-device
computation.

**Blocks.** An axis that does not divide the mesh is split in uneven
blocks, the first ``size % parts`` of them one longer
(``torch.tensor_split``'s rule), where JAX replicates that axis and runs
its GSPMD sweep: the same numbers, each rank still holding one block.
Nothing is padded.
"""

import collections
import math

import torch
import torch.distributed as dist

from rri_nmf_tpu_torch.matrixops import as_tensor, fit_device
from rri_nmf_tpu_torch.ops.quantized import QuantizedX

AXES = ('dp', 'tp')


def block_range(size, parts, index):
    """``(start, stop)`` of block ``index`` when ``size`` is split in
    ``parts`` blocks by ``torch.tensor_split``'s rule."""
    q, r = divmod(int(size), int(parts))
    start = index * q + min(index, r)
    return start, start + q + (1 if index < r else 0)


# Where a rank's block lies in the whole problem: the global shape (n, d)
# and the rank's rows [r0, r1) and columns [c0, c1).
Split = collections.namedtuple('Split', 'n d r0 r1 c0 c1')


class Mesh(object):
    """A ``(dp, tp)`` mesh over the ranks of the default process group,
    built by :func:`make_mesh` (see the module docstring).

    ``device_mesh`` is the ``torch.distributed.device_mesh.DeviceMesh``,
    ``shape`` its ``(dp, tp)`` sizes, ``coordinate`` this rank's place in
    it (None for a rank outside the mesh) and ``backend`` the default
    group's backend. The collectives below return the reduced tensor
    (their contiguous argument, reduced in place); along an axis of one
    rank they return the argument untouched."""

    def __init__(self, device_mesh, axis_names=AXES):
        self.device_mesh = device_mesh
        self.axis_names = tuple(axis_names)
        self.shape = tuple(int(s) for s in device_mesh.mesh.shape)
        coord = device_mesh.get_coordinate()
        self.coordinate = None if coord is None else tuple(coord)
        self.backend = dist.get_backend()
        self._groups = ({} if coord is None else
                        {i: device_mesh.get_group(name)
                         for i, name in enumerate(self.axis_names)})

    def __repr__(self):
        return 'Mesh(%s=%d, %s=%d)' % (self.axis_names[0], self.shape[0],
                                       self.axis_names[1], self.shape[1])

    @property
    def size(self):
        return self.shape[0] * self.shape[1]

    @property
    def graphable(self):
        """Whether a sweep with this mesh's collectives can be captured as
        one CUDA graph: NCCL's collectives can (and a one-rank mesh makes
        none); gloo's go through the host and cannot."""
        return self.size == 1 or self.backend == 'nccl'

    def member(self):
        """This rank's coordinate; raises for a rank outside the mesh."""
        if self.coordinate is None:
            raise ValueError('rank %d is not in %r' % (dist.get_rank(), self))
        return self.coordinate

    # ---- collectives ------------------------------------------------------

    def _reduce(self, x, axis, op=dist.ReduceOp.SUM):
        if self.shape[axis] == 1:
            return x
        x = x.contiguous()
        dist.all_reduce(x.reshape(-1) if x.dim() == 0 else x, op=op,
                        group=self._groups[axis])
        return x

    def sum_dp(self, x):
        """``x`` summed over the ``dp`` axis (in place)."""
        return self._reduce(x, 0)

    def sum_tp(self, x):
        """``x`` summed over the ``tp`` axis (in place)."""
        return self._reduce(x, 1)

    def sum_all(self, x):
        """``x`` summed over the whole mesh (in place)."""
        return self._reduce(self._reduce(x, 0), 1)

    def max_dp(self, x):
        """``x``'s elementwise maximum over the ``dp`` axis (in place)."""
        return self._reduce(x, 0, dist.ReduceOp.MAX)

    def any_all(self, flag):
        """A 0-d bool tensor: whether ``flag`` holds on any rank of the
        mesh (a MAX all-reduce, so every rank takes the same branch)."""
        x = flag.to(self.control_device(flag.device), torch.int32).reshape(1)
        x = self._reduce(self._reduce(x, 0, dist.ReduceOp.MAX), 1,
                         dist.ReduceOp.MAX)
        return x[0] > 0

    def from_first(self, x):
        """The first rank's ``x`` (coordinate (0, 0)) on every rank of the
        mesh: the other ranks pass a tensor of the same shape and dtype,
        whose values are ignored (the sum of it and zeros, exact)."""
        if self.size == 1:
            return x
        if self.member() != (0, 0):
            x = torch.zeros_like(x)
        return self.sum_all(x)

    def control_device(self, device):
        """Where a small control value (a size, a flag, a seed) is
        exchanged: the host under gloo, ``device`` under NCCL (which
        reduces only device tensors)."""
        return torch.device(device) if self.backend == 'nccl' \
            else torch.device('cpu')

    def barrier(self, device):
        """Return on every rank of the mesh only once all have reached
        it (a one-element all-reduce read on the host)."""
        if self.size > 1:
            float(self.sum_all(torch.zeros(
                1, device=self.control_device(device)))[0])

    def locate(self, n_loc, d_loc, device):
        """The :class:`Split` of a local block of ``(n_loc, d_loc)``: the
        block sizes of every rank along each axis, exchanged by one
        all-reduce per axis of more than one rank (on the host under
        gloo, on ``device`` under NCCL)."""
        i, j = self.member()
        device = self.control_device(device)
        sizes = []
        for axis, (mine, at) in enumerate(((n_loc, i), (d_loc, j))):
            if self.shape[axis] == 1:
                sizes.append([int(mine)])
                continue
            s = torch.zeros(self.shape[axis], dtype=torch.int64,
                            device=device)
            s[at] = int(mine)
            sizes.append([int(v) for v in self._reduce(s, axis).tolist()])
        r0, c0 = sum(sizes[0][:i]), sum(sizes[1][:j])
        return Split(sum(sizes[0]), sum(sizes[1]), r0, r0 + int(n_loc), c0,
                     c0 + int(d_loc))

    def gather_cols(self, x, split):
        """The whole rows of ``x`` (..., c1 - c0) from every ``tp`` rank's
        columns: each rank places its columns in a zero (..., d) tensor and
        the ``tp`` sum fills the rest (exact: every entry has one nonzero
        term)."""
        if self.shape[1] == 1:
            return x
        out = x.new_zeros(x.shape[:-1] + (split.d,))
        out[..., split.c0:split.c1] = x
        return self._reduce(out, 1)

    def gather_rows(self, x, split):
        """The whole ``x`` (n, ...) from every ``dp`` rank's rows, as
        :meth:`gather_cols` gathers columns."""
        if self.shape[0] == 1:
            return x
        out = x.new_zeros((split.n,) + tuple(x.shape[1:]))
        out[split.r0:split.r1] = x
        return self._reduce(out, 0)

    @staticmethod
    def own_cols(x, split):
        """This rank's columns of whole rows ``x``."""
        return x[..., split.c0:split.c1]

    # ---- blocks of whole arrays -----------------------------------------

    def split(self, n, d):
        """The :class:`Split` of this rank's block of an (n, d) problem;
        raises when an axis has more ranks than the problem has rows or
        columns."""
        i, j = self.member()
        if n < self.shape[0] or d < self.shape[1]:
            raise ValueError('an (%d, %d) problem cannot be split over the '
                             '%r: every rank needs a row and a column'
                             % (n, d, self))
        return Split(n, d, *block_range(n, self.shape[0], i),
                     *block_range(d, self.shape[1], j))

    def block(self, A, split, rows=True, cols=True):
        """This rank's block of the whole ``A``: its rows (``rows``) and
        columns (``cols``) as a contiguous tensor. A
        :class:`~rri_nmf_tpu_torch.ops.quantized.QuantizedX` keeps the
        scales of its columns."""
        if isinstance(A, QuantizedX):
            return QuantizedX(self.block(A.q, split, rows, cols),
                              A.s[split.c0:split.c1].contiguous()
                              if cols else A.s)
        if rows:
            A = A[split.r0:split.r1]
        if cols:
            A = A[..., split.c0:split.c1]
        return A.contiguous()


def make_mesh(n_devices=None, mesh_shape=None, axis_names=AXES, ranks=None):
    """A :class:`Mesh` over the first ``n_devices`` ranks (default: the
    whole world) of the initialized default process group, one device per
    rank. ``mesh_shape`` defaults to JAX's rule: ``(n/2, 2)`` for an even
    ``n`` > 1, else ``(n, 1)``. ``ranks`` (default: ``0 .. n_devices-1``)
    lists the ranks in mesh order, row-major: the multi-host mesh
    (:func:`~rri_nmf_tpu_torch.parallel.multihost.make_global_mesh`) lays
    each host's ranks along ``tp``. Every rank of the world calls it (it
    makes the axis groups); a rank not listed gets a mesh it is not in.
    Raises ``ValueError`` when no process group is initialized or the
    shape does not fit the world."""
    from torch.distributed.device_mesh import DeviceMesh
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            'make_mesh needs the default process group: call '
            'torch.distributed.init_process_group first (nccl between '
            'cards, gloo on the CPU)')
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    n_devices = int(n_devices)
    if mesh_shape is None:
        mesh_shape = ((n_devices // 2, 2)
                      if n_devices % 2 == 0 and n_devices > 1
                      else (n_devices, 1))
    mesh_shape = tuple(int(s) for s in mesh_shape)
    if len(mesh_shape) != 2 or len(axis_names) != 2:
        raise ValueError('the mesh has two axes, got shape %r and names %r'
                         % (mesh_shape, axis_names))
    if not 1 <= n_devices <= world or math.prod(mesh_shape) != n_devices:
        raise ValueError('a %r mesh of %d ranks does not fit a world of %d'
                         % (mesh_shape, n_devices, world))
    if ranks is None:
        ranks = range(n_devices)
    ranks = torch.tensor([int(r) for r in ranks], dtype=torch.int64)
    if ranks.numel() != n_devices or len(set(ranks.tolist())) != n_devices \
            or int(ranks.min()) < 0 or int(ranks.max()) >= world:
        raise ValueError('ranks %r are not %d distinct ranks of a world of %d'
                         % (ranks.tolist(), n_devices, world))
    device_type = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
    return Mesh(DeviceMesh(device_type, ranks.reshape(mesh_shape),
                           mesh_dim_names=tuple(axis_names)),
                axis_names)


# the axes a whole array is split along, in JAX's PartitionSpec terms
Layout = collections.namedtuple('Layout', 'rows cols')


def problem_shardings(mesh, masked=False, w_row_sum_is_vector=False):
    """The layouts of ``(X, W, T[, W_mat][, w_row_sum_vec])``, each a
    :class:`Layout` naming the axis its rows and its columns split over
    (None: the same on every rank of the other axis). With the
    :class:`Split` of a problem (``mesh.split(n, d)``) they give this
    rank's row and column ranges, and :meth:`Mesh.block` its block."""
    dp, tp = mesh.axis_names
    out = [Layout(dp, tp), Layout(dp, None), Layout(None, tp)]
    if masked:
        out.append(Layout(dp, tp))
    if w_row_sum_is_vector:
        out.append(Layout(dp, None))
    return tuple(out)


def shard_problem(mesh, X, W, T, W_mat=None, w_row_sum_vec=None,
                  device=None):
    """This rank's blocks of the whole ``X``, ``W``, ``T`` (and the mask
    ``W_mat``, split like X, and ``w_row_sum_vec``), in the order given,
    as contiguous tensors on ``device`` (default: a tensor's own device,
    the card for numpy). X may be a
    :class:`~rri_nmf_tpu_torch.ops.quantized.QuantizedX`."""
    if isinstance(X, QuantizedX):
        X = X if device is None else X.to(device)
    else:
        X = as_tensor(X, device=fit_device(X, device))
    split = mesh.split(*X.shape)
    arrays = [X, W, T]
    if W_mat is not None:
        arrays.append(W_mat)
    if w_row_sum_vec is not None:
        arrays.append(as_tensor(w_row_sum_vec).reshape(-1, 1))
    out = []
    for A, layout in zip(arrays, problem_shardings(
            mesh, masked=W_mat is not None,
            w_row_sum_is_vector=w_row_sum_vec is not None)):
        if not isinstance(A, QuantizedX):
            A = as_tensor(A, device=X.device)
        out.append(mesh.block(A, split, rows=layout.rows is not None,
                              cols=layout.cols is not None))
    if w_row_sum_vec is not None:
        out[-1] = out[-1].reshape(-1)
    return tuple(out)


def make_sharded_training_step(cfg, mesh, with_objective=True):
    """One training step on this rank's blocks (from :func:`shard_problem`):
    the sweep of :func:`rri_nmf_tpu_torch.ops.sweep.make_sweep` with its
    collectives, then the distributed objective
    (:func:`rri_nmf_tpu_torch.ops.accel.make_residual_obj`)::

        step(X, W, T, draws, resets_left, *extras)
            -> (W, T, resets_left[, numer_store, denom_store][, obj])

    ``extras`` is ``(W_mat,)`` (this rank's block of the mask) when
    ``cfg.masked``, then ``(w_row_sum_vec,)`` (this rank's rows) when
    ``cfg.w_row_sum_is_vector``, as :func:`shard_problem` returns them;
    the objective takes the mask. Every rank passes the same ``draws``
    (one seed). ``cfg.mesh`` is filled in with ``mesh``; a cfg that holds
    another mesh raises ``ValueError``, as in JAX."""
    import dataclasses

    from rri_nmf_tpu_torch.ops.accel import make_residual_obj
    from rri_nmf_tpu_torch.ops.sweep import make_sweep
    if cfg.mesh is not None and cfg.mesh is not mesh:
        raise ValueError('cfg.mesh differs from the mesh argument; pass a '
                         'cfg without a mesh (it is filled in here) or the '
                         'same mesh object')
    cfg = dataclasses.replace(cfg, mesh=mesh)
    sweep = make_sweep(cfg)
    if not with_objective:
        return sweep
    obj_fn = make_residual_obj(cfg, distributed=True)

    def step(X, W, T, draws, resets_left, *extras):
        out = sweep(X, W, T, draws, resets_left, *extras)
        return tuple(out) + (obj_fn(X, out[0], out[1],
                                    *extras[:int(cfg.masked)]),)

    return step
