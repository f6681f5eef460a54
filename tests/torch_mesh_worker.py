"""Rank processes for the port's mesh tests, and the pool that feeds them.

A test module starts one :class:`MeshPool` (a module-scoped fixture): four
processes, each one rank of a gloo world on the CPU that meets through a
``FileStore`` in a temporary directory. The pool sends each case to every
rank; every rank builds its mesh (cached by shape; ranks beyond the
mesh's size sit the case out), runs the case on its blocks and answers,
and the pool returns the first rank's answer (whole factors gathered over
the mesh) or raises the first error any rank met.

This module imports only torch, numpy and the port: a rank never imports
JAX or the JAX package (the test modules, which do, run in the parent).
Run as a script, it is one rank: ``python torch_mesh_worker.py RANK WORLD
STORE_FILE [MODULE]``; cases come on stdin and answers go to stdout, each
a length-prefixed pickle. ``MODULE`` names a module of this directory
whose ``case_*`` functions the rank serves too (``MeshPool(cases=...)``).
"""

import datetime
import logging
import os
import pickle
import select
import struct
import subprocess
import sys
import time
import traceback


HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORLD = 4
# a case that takes longer than this on any rank fails its test
CASE_SECONDS = 180


def _send(stream, obj):
    blob = pickle.dumps(obj)
    stream.write(struct.pack('<Q', len(blob)) + blob)
    stream.flush()


def _recv(stream):
    head = stream.read(8)
    if len(head) < 8:
        return None
    (size,) = struct.unpack('<Q', head)
    return pickle.loads(stream.read(size))


# ---------------------------------------------------------------------------
# the rank side
# ---------------------------------------------------------------------------

class _Records(logging.Handler):
    """The warnings the port logs during a case."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _np(a):
    """A tensor as a float64 numpy array (16-bit values widen exactly)."""
    if not hasattr(a, 'detach'):
        return a
    a = a.detach().cpu()
    return (a.double() if a.is_floating_point() else a).numpy()


def _whole(mesh, split, W, T):
    return (_np(mesh.gather_rows(W, split)), _np(mesh.gather_cols(T, split)))


class _Counting(object):
    """Counts, as launches, this rank's calls of the kernels' wrappers and
    of the sparse partitions while it is entered: on the CPU the wrappers
    run their twins, which count nothing themselves. The sweeps look the
    wrappers up at call time, so wrapping the module attributes is
    enough."""

    def __init__(self):
        from rri_nmf_tpu_torch import nmf
        from rri_nmf_tpu_torch.ops import dense_kernels as dk
        from rri_nmf_tpu_torch.ops import masked_kernels as mk
        from rri_nmf_tpu_torch.ops import sparse_kernels as sk
        self.targets = [(dk, 'gs_update'), (dk, 'tm_proj_update'),
                        (mk, 'phase_a'), (mk, 'phase_b'),
                        (sk, 'gather_contract'), (sk, 'gram_contract'),
                        (nmf, 'partition_coo'),
                        (nmf, 'partition_mxu'),
                        (nmf, 'partition_masked_coo'),
                        (nmf, 'partition_masked_gram')]
        self.calls = {name: 0 for _, name in self.targets}
        self.saved = []

    def __enter__(self):
        for module, name in self.targets:
            fn = getattr(module, name)
            self.saved.append((module, name, fn))
            setattr(module, name, self._wrap(name, fn))
        return self.calls

    def _wrap(self, name, fn):
        def wrapped(*args, **kw):
            self.calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    def __exit__(self, *exc):
        for module, name, fn in self.saved:
            setattr(module, name, fn)


def _objective(calc):
    """A calculator's objective, or the error it raises."""
    try:
        return float(calc.true_objective())
    except Exception as e:          # the test checks the kind and text
        return '%s: %s' % (type(e).__name__, e)


def _pickled_objective(calc):
    """A calculator's objective after a pickle round trip, or the error
    that raises."""
    return _objective(pickle.loads(pickle.dumps(calc)))


def case_fit(mesh, X, kw, single=False, every_rank=False, pickled=False,
             gram_budget=None):
    """``nmf(X, mesh=mesh, device='cpu', **kw)``: the whole factors, the
    history, the budget left, the gradient stores, this rank's kernel
    calls (:class:`_Counting`) and the warnings logged. ``single`` adds
    the fit without the mesh in this process, ``every_rank`` every rank's
    T, ``pickled`` the objective calculator's value before and after a
    pickle round trip; ``gram_budget`` sets the Gram-phase sweep's
    memory budget for the fit."""
    from rri_nmf_tpu_torch.nmf import nmf
    from rri_nmf_tpu_torch.ops import sweep_masked_gram as mg
    budget = mg.GRAM_BUDGET_BYTES
    if gram_budget is not None:
        mg.GRAM_BUDGET_BYTES = gram_budget
    try:
        with _Counting() as calls:
            res = nmf(X, mesh=mesh, device='cpu', **kw)
        if single:
            one = nmf(X, device='cpu', **kw)
    finally:
        mg.GRAM_BUDGET_BYTES = budget
    out = {key: _np(res[key]) for key in ('W', 'T')}
    out['calls'] = dict(calls)
    if single:
        out['single'] = {key: _np(one[key]) for key in ('W', 'T')}
        out['single']['obj_history'] = list(one.get('obj_history', []))
    if every_rank:
        import torch.distributed as dist
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, out['T'])
        out['every_T'] = every[:mesh.size]
    if pickled:
        calc = res['obj_calculator']
        out['objective'] = calc.true_objective()
        out['pickled'] = _pickled_objective(calc)
    for key in ('numer_W', 'denom_W'):
        if key in res:
            out[key] = {it: _np(v) for it, v in res[key].items()}
    out['dtype'] = str(res['W'].dtype)
    out['obj_history'] = list(res.get('obj_history', []))
    out['n_resets_remaining'] = res['n_resets_remaining']
    if 'diagnostics' in res:
        out['diagnostics'] = {name: [float(v) for v in vals]
                              for name, vals in res['diagnostics'].items()}
    return out


def case_refusal(mesh, X, kw):
    """The message of the error ``nmf(X, mesh=mesh, **kw)`` raises."""
    from rri_nmf_tpu_torch.nmf import nmf
    try:
        nmf(X, mesh=mesh, device='cpu', **kw)
    except Exception as e:          # the test checks the kind and text
        return '%s: %s' % (type(e).__name__, e)
    return None


def _blocks(mesh, X, W, T, wrs=None, quantize=False, M=None):
    import torch

    from rri_nmf_tpu_torch.ops.quantized import quantize_x
    from rri_nmf_tpu_torch.parallel import shard_problem
    X = torch.as_tensor(X)
    if quantize:
        X = quantize_x(X, torch.float64)
    return shard_problem(mesh, X, W, T, W_mat=M, w_row_sum_vec=wrs,
                         device='cpu')


def case_step(mesh, X, W, T, cfg, sweeps, resets=0, seed=3, wrs=None,
              M=None):
    """``sweeps`` steps of :func:`make_sharded_training_step` from whole
    (X, W, T) (and the mask ``M``): the whole factors, the objectives and
    the budget left."""
    from rri_nmf_tpu_torch.ops.sweep import SweepConfig, make_draws
    from rri_nmf_tpu_torch.parallel import make_sharded_training_step
    step = make_sharded_training_step(SweepConfig(**cfg), mesh)
    blocks = _blocks(mesh, X, W, T, wrs, M=M)
    Xl, Wl, Tl = blocks[:3]
    draws = make_draws(seed, 'cpu')
    objs = []
    for _ in range(sweeps):
        out = step(Xl, Wl, Tl, draws, resets, *blocks[3:])
        Wl, Tl, resets = out[:3]
        objs.append(float(out[-1]))
    W, T = _whole(mesh, mesh.split(*X.shape), Wl, Tl)
    return {'W': W, 'T': T, 'obj': objs, 'resets': resets}


def case_dense_sweep(mesh, X, W, T, cfg, sweeps=1, wrs=None, quantize=False):
    """``sweeps`` sweeps of :func:`make_sharded_dense_sweep` from whole
    (X, W, T) (X int16-coded with ``quantize``): the whole factors and
    the B1/B2 calls this rank made."""
    from rri_nmf_tpu_torch.ops import dense_kernels as dk
    from rri_nmf_tpu_torch.ops.sweep import SweepConfig
    from rri_nmf_tpu_torch.parallel import make_sharded_dense_sweep
    sweep = make_sharded_dense_sweep(SweepConfig(**cfg), mesh)
    blocks = _blocks(mesh, X, W, T, wrs, quantize)
    Xl, Wl, Tl = blocks[:3]
    calls = {'gs': 0, 'tm_proj': 0}
    gs, tm = dk.gs_update, dk.tm_proj_update

    def count(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    dk.gs_update, dk.tm_proj_update = count('gs', gs), count('tm_proj', tm)
    try:
        for _ in range(sweeps):
            Wl, Tl = sweep(Xl, Wl, Tl, *blocks[3:])
    finally:
        dk.gs_update, dk.tm_proj_update = gs, tm
    W, T = _whole(mesh, mesh.split(*X.shape), Wl, Tl)
    return {'W': W, 'T': T, 'calls': calls}


def case_masked_sweep(mesh, X, M, W, T, cfg, sweeps=1):
    """``sweeps`` sweeps of :func:`make_sharded_masked_sweep` from whole
    (X, M, W, T): the whole factors and the B3/B4 calls this rank made."""
    from rri_nmf_tpu_torch.ops.sweep import SweepConfig, make_draws
    from rri_nmf_tpu_torch.parallel import make_sharded_masked_sweep
    sweep = make_sharded_masked_sweep(SweepConfig(**cfg), mesh)
    Xl, Wl, Tl, Ml = _blocks(mesh, X, W, T, M=M)
    draws = make_draws(0, 'cpu')
    with _Counting() as calls:
        for _ in range(sweeps):
            Wl, Tl, _ = sweep(Xl, Wl, Tl, Ml, draws, 0)
    W, T = _whole(mesh, mesh.split(*X.shape), Wl, Tl)
    return {'W': W, 'T': T, 'calls': dict(calls)}


def case_masked_objective(mesh, X, M, W, T, cfg):
    """The distributed masked objectives of whole (X, M, W, T): the
    residual one (HER's) and the tracked one (``make_objective``)."""
    from rri_nmf_tpu_torch.ops.accel import make_residual_obj
    from rri_nmf_tpu_torch.ops.sweep import SweepConfig, make_objective
    obj = make_residual_obj(SweepConfig(mesh=mesh, **cfg), distributed=True)
    tracked = make_objective(masked=True, mesh=mesh, reg_w_l2=cfg.get(
        'reg_w_l2', 0.0), reg_t_l1=cfg.get('reg_t_l1', 0.0))
    Xl, Wl, Tl, Ml = _blocks(mesh, X, W, T, M=M)
    return [float(obj(Xl, Wl, Tl, Ml)), float(tracked(Xl, Wl, Tl, Ml))]


def case_partition(mesh, X, mxu=False):
    """Every rank's :func:`partition_coo` block (dense, with its row and
    column ranges), and with ``mxu`` every rank's :func:`partition_mxu`
    plan's products against dense factors of ones."""
    import torch
    import torch.distributed as dist

    from rri_nmf_tpu_torch.ops import sparse_kernels as sk
    from rri_nmf_tpu_torch.parallel import partition_coo, partition_mxu
    split = mesh.split(*X.shape)
    block = partition_coo(X, mesh, torch.float64, 'cpu')
    mine = {'range': (split.r0, split.r1, split.c0, split.c1),
            'dense': _np(block.coo.to_dense()), 'nnz': int(block.coo._nnz())}
    if mxu:
        plan = partition_mxu(X, mesh, torch.float64, 'cpu')
        n_loc, d_loc = split.r1 - split.r0, split.c1 - split.c0
        mine['wtx'] = _np(sk.contract_wtx(plan, torch.ones(
            n_loc, 2, dtype=torch.float64)))
        mine['xtt'] = _np(sk.contract_xtt(plan, torch.ones(
            2, d_loc, dtype=torch.float64)))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return every[:mesh.size]


def case_sparse_sweep(mesh, X, W, T, cfg, backend, sweeps=1,
                      torch_x=False):
    """``sweeps`` sweeps of :func:`make_sharded_sparse_sweep`
    (``backend='torch'``) or :func:`make_sharded_mxu_sweep` (``'mxu'``)
    from the sparse X (with ``torch_x``, the scipy CSR X as a torch CSR
    tensor) and whole (W, T): the whole factors and this rank's kernel
    calls."""
    import torch

    from rri_nmf_tpu_torch.ops.sweep import SweepConfig
    from rri_nmf_tpu_torch.parallel import (make_sharded_mxu_sweep,
                                            make_sharded_sparse_sweep,
                                            partition_coo, partition_mxu)
    cfg = SweepConfig(**cfg)
    if torch_x:
        X = torch.sparse_csr_tensor(X.indptr, X.indices, X.data, X.shape)
    if backend == 'mxu':
        Xl = partition_mxu(X, mesh, torch.float64, 'cpu')
        sweep = make_sharded_mxu_sweep(cfg, mesh)
    else:
        Xl = partition_coo(X, mesh, torch.float64, 'cpu')
        sweep = make_sharded_sparse_sweep(cfg, mesh)
    split = mesh.split(*X.shape)
    Wl = torch.as_tensor(W)[split.r0:split.r1].contiguous()
    Tl = torch.as_tensor(T)[:, split.c0:split.c1].contiguous()
    with _Counting() as calls:
        for _ in range(sweeps):
            Wl, Tl = sweep(Xl, Wl, Tl)
    W, T = _whole(mesh, split, Wl, Tl)
    return {'W': W, 'T': T, 'calls': dict(calls)}


def case_sparse_objective(mesh, X, W, T, regs):
    """:func:`make_sharded_sparse_objective` of whole (X, W, T) on each
    rank's blocks."""
    import torch

    from rri_nmf_tpu_torch.parallel import (make_sharded_sparse_objective,
                                            partition_coo)
    split = mesh.split(*X.shape)
    Wl = torch.as_tensor(W)[split.r0:split.r1]
    Tl = torch.as_tensor(T)[:, split.c0:split.c1]
    f = make_sharded_sparse_objective(mesh, **regs)
    return float(f(partition_coo(X, mesh, torch.float64, 'cpu'), Wl, Tl))


def case_objective(mesh, X, W, T, cfg, quantize=False):
    """The distributed residual objective of whole (X, W, T)."""
    from rri_nmf_tpu_torch.ops.accel import make_residual_obj
    from rri_nmf_tpu_torch.ops.sweep import SweepConfig
    obj = make_residual_obj(SweepConfig(mesh=mesh, **cfg), distributed=True)
    Xl, Wl, Tl = _blocks(mesh, X, W, T, quantize=quantize)
    return float(obj(Xl, Wl, Tl))


def case_reset(mesh, X, W, T, cfg, t, seed=0):
    """The mesh reset of topic ``t`` on whole (X, W, T): the whole new row
    and column."""
    from rri_nmf_tpu_torch.ops.sweep import (SweepConfig, make_draws,
                                             make_reset_rowcol)
    reset = make_reset_rowcol(SweepConfig(mesh=mesh, **cfg))
    Xl, Wl, Tl = _blocks(mesh, X, W, T)
    split = mesh.split(*X.shape)
    row, col = reset(Xl, Wl, Tl, t, make_draws(seed, 'cpu'), split)
    return {'row': _np(mesh.gather_cols(row, split)),
            'col': _np(mesh.gather_rows(col, split))}


def case_made(mesh, shapes):
    """Meshes made on every rank of the world: each default shape and the
    first rank's coordinate in it, a shape's error, every rank's block of
    a (10, 7) problem on a (2, 2) mesh, and the error of a rank outside a
    (3, 1) mesh (the last rank's)."""
    import torch.distributed as dist

    from rri_nmf_tpu_torch.parallel import make_mesh
    mine = {'shapes': [], 'coordinates': []}
    for n in shapes:
        m = make_mesh(n)
        mine['shapes'].append(m.shape)
        mine['coordinates'].append(m.coordinate)
    try:
        make_mesh(4, (3, 2))
    except ValueError as e:
        mine['bad'] = str(e)
    s = make_mesh(4, (2, 2)).split(10, 7)
    mine['range'] = (s.r0, s.r1, s.c0, s.c1)
    try:
        make_mesh(3, (3, 1)).member()
        mine['outside'] = None
    except ValueError as e:
        mine['outside'] = str(e)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return dict(every[0], ranges=[e['range'] for e in every],
                outside=every[-1]['outside'])


def _masked_plan(mesh, X, M, gram, backend):
    import torch

    from rri_nmf_tpu_torch.parallel import (partition_masked_coo,
                                            partition_masked_gram)
    if gram:
        return partition_masked_gram(X, M, mesh, torch.float64,
                                     backend=backend, device='cpu')
    return partition_masked_coo(X, M, mesh, torch.float64, 'cpu')


def case_masked_partition(mesh, X, M):
    """Every rank's :func:`partition_masked_coo` plan: its row range, its
    host arrays and real observations, and its Gram plan's ``Σ m x²``."""
    import torch.distributed as dist
    split = mesh.split(*X.shape)
    coo = _masked_plan(mesh, X, M, False, None)
    gram = _masked_plan(mesh, X, M, True, 'segsum')
    mine = {'range': (split.r0, split.r1), 'shape': coo.shape,
            'nnz': coo.nnz, 'sum_mx2': float(gram.sum_mx2),
            'arrays': coo.host_arrays()}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return every[:mesh.size]


def case_masked_mesh_sweep(mesh, X, M, W, T, cfg, sweeps, gram=True,
                           backend='segsum', panel=None, seed=3,
                           single=False):
    """``sweeps`` sweeps of the sparse-mask mesh sweep (the Gram-phase
    one with ``gram``, of ``backend`` and ``panel``; else the O(nnz) one)
    on this rank's plan from whole (W, T): the whole factors after each
    sweep and this rank's gather calls; ``single`` adds the same sweeps
    without the mesh on the single-device plan, in this process."""
    import torch

    from rri_nmf_tpu_torch.ops import sweep_masked_gram as mg
    from rri_nmf_tpu_torch.ops import sweep_masked_sparse as ms
    from rri_nmf_tpu_torch.ops.sweep import SweepConfig, make_draws
    from rri_nmf_tpu_torch.parallel import (
        make_sharded_masked_gram_sweep, make_sharded_masked_sparse_sweep)
    cfg = SweepConfig(**cfg)
    split = mesh.split(*X.shape)
    plan = _masked_plan(mesh, X, M, gram, backend)
    sweep = (make_sharded_masked_gram_sweep(cfg, mesh, backend, panel)
             if gram else make_sharded_masked_sparse_sweep(cfg, mesh))
    W, T = torch.as_tensor(W), torch.as_tensor(T)
    Wl, Tl = W[split.r0:split.r1].contiguous(), T
    draws = make_draws(seed, 'cpu')
    out = {'steps': []}
    with _Counting() as calls:
        for _ in range(sweeps):
            Wl, Tl, _ = sweep(plan, Wl, Tl, draws, 0)
            out['steps'].append((_np(mesh.gather_rows(Wl, split)), _np(Tl)))
    out['calls'] = dict(calls)
    if single:
        one = (mg.plan_masked_gram(X, M, torch.float64, backend=backend,
                                   device='cpu') if gram
               else ms.plan_masked_coo(X, M, torch.float64, device='cpu'))
        sweep = (mg.make_masked_gram_sweep(cfg, backend, panel) if gram
                 else ms.make_masked_sparse_sweep(cfg))
        draws = make_draws(seed, 'cpu')
        out['single'] = []
        for _ in range(sweeps):
            W, T, _ = sweep(one, W, T, draws, 0)
            out['single'].append((_np(W), _np(T)))
    return out


def case_masked_mesh_objective(mesh, X, M, W, T, regs, gram=True,
                               backend='segsum', panel=None):
    """The sparse-mask mesh objective (the Gram form with ``gram``, of
    ``backend`` and ``panel``; else the observed-entry form) of whole
    (W, T) on this rank's plan."""
    import torch

    from rri_nmf_tpu_torch.parallel import (
        make_sharded_masked_gram_objective,
        make_sharded_masked_sparse_objective)
    split = mesh.split(*X.shape)
    plan = _masked_plan(mesh, X, M, gram, backend)
    f = (make_sharded_masked_gram_objective(mesh, backend, panel=panel,
                                            **regs) if gram
         else make_sharded_masked_sparse_objective(mesh, **regs))
    return float(f(plan, torch.as_tensor(W)[split.r0:split.r1],
                   torch.as_tensor(T)))


def case_rs_estimator(mesh, pairs, ratings, shape, kw):
    """``NMF_RS_Estimator(*shape, nmf_kwargs=dict(mesh=mesh, ...))``
    fitted on the pairs, then pickled and loaded: the fit's factors,
    history and score, and the loaded estimator's factors, score,
    ``nmf_kwargs`` and objective calculator (its value, or the error)."""
    from rri_nmf_tpu_torch.sklearn_interface import NMF_RS_Estimator
    kw = dict(kw)
    kw['nmf_kwargs'] = dict(kw.get('nmf_kwargs', {}), mesh=mesh)
    est = NMF_RS_Estimator(*shape, device='cpu', **kw).fit(pairs, ratings)
    loaded = pickle.loads(pickle.dumps(est))
    return {'W': _np(est.W), 'T': _np(est.T),
            'obj_history': list(est.nmf_outputs['obj_history']),
            'score': est.score(pairs, ratings),
            'loaded_W': _np(loaded.W), 'loaded_T': _np(loaded.T),
            'loaded_score': loaded.score(pairs, ratings),
            'loaded_nmf_kwargs': sorted(loaded.nmf_kwargs),
            'loaded_objective': _objective(
                loaded.nmf_outputs['obj_calculator'])}


def frobenius(X, W, T):
    """A callback that needs the whole factors: ``||X - WT||``."""
    import torch
    return float(torch.linalg.norm(torch.as_tensor(X) - W @ T))


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith('case_')}


def serve(rank, world, store_file, cases=None):
    """One rank: join the gloo world, then answer cases until stdin ends
    (those of this module and of the module ``cases``)."""
    import importlib

    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    if cases:
        sys.path.insert(0, HERE)
        extra = importlib.import_module(cases)
        CASES.update((name[5:], fn) for name, fn in vars(extra).items()
                     if name.startswith('case_'))
    from rri_nmf_tpu_torch.parallel import make_mesh
    dist.init_process_group(
        'gloo', store=dist.FileStore(store_file, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=CASE_SECONDS))
    records = _Records()
    logging.getLogger('rri_nmf_tpu_torch').addHandler(records)
    meshes = {}
    stdin, stdout = sys.stdin.buffer, sys.stdout.buffer
    while True:
        msg = _recv(stdin)
        if msg is None:
            break
        shape = tuple(msg['mesh'])
        records.messages = []
        try:
            if shape not in meshes:
                meshes[shape] = make_mesh(shape[0] * shape[1], shape)
            mesh = meshes[shape]
            out = None
            if mesh.coordinate is not None:
                out = CASES[msg['case']](mesh, **msg['kw'])
                if isinstance(out, dict):
                    out['warnings'] = list(records.messages)
            _send(stdout, ('ok', out))
        except BaseException:
            _send(stdout, ('error', traceback.format_exc()))
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent side
# ---------------------------------------------------------------------------

class MeshPool(object):
    """Four rank processes in one gloo world (see the module docstring).
    ``run(case, mesh=(dp, tp), **kw)`` runs ``case_<case>`` on every rank
    of a ``(dp, tp)`` mesh and returns the first rank's answer. ``env``
    adds to the ranks' environment; ``cases`` names a module of this
    directory whose cases the ranks serve too."""

    def __init__(self, workdir, world=WORLD, env=None, cases=None):
        env = dict(os.environ, OMP_NUM_THREADS='1', MKL_NUM_THREADS='1',
                   PYTHONPATH=REPO + os.pathsep + os.environ.get(
                       'PYTHONPATH', ''), **(env or {}))
        store = os.path.join(str(workdir), 'store')
        self.logs = [os.path.join(str(workdir), 'rank%d.log' % r)
                     for r in range(world)]
        self.procs = []
        self.broken = None
        for rank in range(world):
            with open(self.logs[rank], 'wb') as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), str(rank),
                     str(world), store] + ([cases] if cases else []),
                    stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                    stderr=log, cwd=REPO, env=env))

    def _read(self, proc, deadline):
        """One answer of ``proc``, or a timeout error past ``deadline``."""
        fd = proc.stdout.fileno()
        buf = b''
        need = 8
        size = None
        while len(buf) < need:
            left = deadline - time.monotonic()
            if left <= 0 or not select.select([fd], [], [], left)[0]:
                raise TimeoutError('a mesh case took over %d s'
                                   % CASE_SECONDS)
            chunk = os.read(fd, need - len(buf))
            if not chunk:
                raise RuntimeError('a rank process ended: %s'
                                   % self._tail())
            buf += chunk
            if size is None and len(buf) == 8:
                (size,) = struct.unpack('<Q', buf)
                buf, need = b'', size
        return pickle.loads(buf)

    def _tail(self):
        out = []
        for path in self.logs:
            with open(path, 'rb') as f:
                out.append(f.read()[-2000:].decode(errors='replace'))
        return '\n'.join(out)

    def run(self, case, mesh, **kw):
        if self.broken:
            raise RuntimeError('an earlier case left the ranks out of step: '
                               + self.broken)
        msg = {'case': case, 'mesh': tuple(mesh), 'kw': kw}
        self.broken = 'the %r case did not finish' % (case,)
        for proc in self.procs:
            _send(proc.stdin, msg)
        deadline = time.monotonic() + CASE_SECONDS
        answers = [self._read(proc, deadline) for proc in self.procs]
        for status, body in answers:
            if status == 'error':
                self.broken = 'the %r case failed' % (case,)
                raise RuntimeError('a rank failed the %r case:\n%s'
                                   % (case, body))
        self.broken = None
        return answers[0][1]

    def close(self):
        for proc in self.procs:
            try:
                proc.stdin.close()
            except OSError:
                pass
        for proc in self.procs:
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


if __name__ == '__main__':
    serve(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
          sys.argv[4] if len(sys.argv) > 4 else None)
