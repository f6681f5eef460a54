"""Rank-side cases of ``tests/test_torch_multihost.py``: the multi-host
layer (``rri_nmf_tpu_torch.parallel.multihost``) driven the way a fit
across hosts drives it, each rank building its inputs from its own slab.

The ranks are those of :class:`torch_mesh_worker.MeshPool`, started with
``LOCAL_WORLD_SIZE=2`` so that four ranks stand as two hosts of two ranks
on one machine, and with this module's cases. Every case runs on all four
ranks (the pool's ``(2, 2)`` mesh) and builds the meshes it needs with
``make_global_mesh``; the answers are the first rank's, with flags that
compare every rank's.

The problems and the fits' settings are JAX's ``tests/mp_worker.py``
configurations A-J (:func:`problem`, :data:`CONFIGS`); the test module
runs JAX's single-device fits of the same settings. Like the pool's own
worker, this module imports only torch, numpy, scipy and the port.
"""

import os
import warnings

import numpy as np

N, D, K = 64, 32, 5
DENSE = dict(update_order='phase', project_T_each_iter=True, t_row_sum=1.0)
# JAX's tests/mp_worker.py configurations: (X, nmf() settings); 'dense'
# X through distribute_dense, 'masked_coo'/'masked_gram' through
# distribute_masked_coo, 'coo'/'mxu' through distribute_sparse_coo
CONFIGS = {
    'A': ('dense', dict(max_iter=5, random_state=7,
                        compute_obj_each_iter=True, **DENSE)),
    'B': ('dense', dict(max_iter=5, random_state=7,
                        compute_obj_each_iter=True, early_stop=True,
                        project_T_each_iter=True, t_row_sum=1.0)),
    'C': ('dense', dict(max_iter=5, random_state=7, sweeps_per_dispatch=5,
                        **DENSE)),
    'D': ('dense', dict(max_iter=5, random_state=7,
                        compute_obj_each_iter=True, accel='her',
                        reset_topic_method=None, **DENSE)),
    'F': ('dense', dict(max_iter=4, random_state=7, init='random',
                        compute_obj_each_iter=True, **DENSE)),
    'G': ('masked_coo', dict(max_iter=4, random_state=7,
                             compute_obj_each_iter=True,
                             reset_topic_method=None, t_row_sum=1.0)),
    'H': ('masked_gram', dict(max_iter=4, random_state=7,
                              compute_obj_each_iter=True,
                              update_order='phase', reset_topic_method=None,
                              reg_t_l1=0.01)),
    'I': ('coo', dict(max_iter=4, random_state=7, compute_obj_each_iter=True,
                      early_stop=False, project_W_each_iter=True,
                      w_row_sum=1.0, reg_t_l2=0.05, reset_topic_method=None)),
    'J': ('mxu', dict(max_iter=4, random_state=7, compute_obj_each_iter=True,
                      early_stop=False, project_T_each_iter=True,
                      t_row_sum=1.0, reset_topic_method=None)),
}


def problem():
    """JAX's ``mp_worker.py`` data: X, the warm starts, the masked
    problem (``Xm``, the scipy mask ``Ms``) and the sparse X ``Xs``."""
    import scipy.sparse as sps
    X = np.random.RandomState(0).rand(N, D)
    W0 = np.abs(np.random.RandomState(1).rand(N, K))
    T0 = np.abs(np.random.RandomState(2).rand(K, D))
    rngm = np.random.RandomState(3)
    M = (rngm.rand(N, D) < 0.4).astype(np.float64)
    Xm = rngm.rand(N, D) * M
    rngs = np.random.RandomState(4)
    Xs = sps.csr_matrix(rngs.rand(N, D) * (rngs.rand(N, D) < 0.3))
    return dict(X=X, W0=W0, T0=T0, Xm=Xm, M=M, Ms=sps.csr_matrix(M), Xs=Xs)


def runs_on(name, shape):
    """Whether configuration ``name`` runs on a ``shape`` mesh: the
    sparse-mask plans need ``tp == 1``, and so does the ``'mxu'`` fit's
    T-row sum constraint."""
    return CONFIGS[name][0] in ('dense', 'coo') or shape[1] == 1


_MESHES = {}


def _global(shape=None):
    """``make_global_mesh(shape)``, made once on every rank."""
    from rri_nmf_tpu_torch.parallel import make_global_mesh
    if shape not in _MESHES:
        _MESHES[shape] = make_global_mesh(mesh_shape=shape)
    return _MESHES[shape]


def _np(a):
    if not hasattr(a, 'detach'):
        return a
    return a.detach().cpu().double().numpy()


def _every(value):
    """Every rank's ``value`` (an all-gather of Python objects)."""
    import torch.distributed as dist
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def _fit_dict(res):
    return {'W': _np(res['W']), 'T': _np(res['T']),
            'obj_history': list(res.get('obj_history', []))}


def _same_fit(a, b):
    return (np.array_equal(a['W'], b['W']) and np.array_equal(a['T'], b['T'])
            and a['obj_history'] == b['obj_history'])


def _inputs(g, P, kind):
    """This rank's X (slab-built) and the whole X for ``kind``, and the
    whole-X fit's extra settings."""
    from rri_nmf_tpu_torch.parallel import (distribute_dense,
                                            distribute_masked_coo,
                                            distribute_sparse_coo,
                                            process_row_block)
    lo, hi = process_row_block(N, g)
    if kind == 'dense':
        return distribute_dense(P['X'][lo:hi], (N, D), g, device='cpu'), \
            P['X'], {}
    if kind in ('masked_coo', 'masked_gram'):
        plan = distribute_masked_coo(
            P['Xm'][lo:hi], P['Ms'][lo:hi], (N, D), g,
            backend='segsum' if kind == 'masked_gram' else None,
            device='cpu')
        return plan, P['Xm'], {'W_mat': P['Ms']}
    plan = distribute_sparse_coo(P['Xs'][lo:hi], (N, D), g,
                                 dtype=np.float64,
                                 backend='mxu' if kind == 'mxu' else None,
                                 device='cpu')
    return plan, P['Xs'], {'sparse': 'mxu' if kind == 'mxu' else True}


def case_configs(mesh, shape, tmp):
    """Configurations A-J (those that run on ``shape``; None: the default
    global mesh) with each rank given only its slab or plan, and each
    again from the whole X on the same mesh; E is a checkpointed fit of
    A's settings, 2 sweeps, resumed to 5 with other warm starts, through
    per-rank directories under ``tmp`` (only the first rank writes).
    Returns the first rank's slab fits and, per configuration, whether
    every rank's slab fit is bit for bit the same and bit for bit the
    whole-X mesh fit."""
    from rri_nmf_tpu_torch.nmf import nmf
    from rri_nmf_tpu_torch.parallel import (distribute_factors,
                                            process_row_block)
    g = _global(None if shape is None else tuple(shape))
    P = problem()
    mine, whole = {}, {}
    if g.coordinate is not None:
        lo, hi = process_row_block(N, g)
        Wg, Tg = distribute_factors(P['W0'][lo:hi], P['T0'], N, g,
                                    device='cpu')
        for name, (kind, kw) in CONFIGS.items():
            if not runs_on(name, g.shape):
                continue
            X_rank, X_all, extra = _inputs(g, P, kind)
            warm = {} if 'init' in kw else dict(W_in=Wg, T_in=Tg)
            warm_all = {} if 'init' in kw else dict(W_in=P['W0'],
                                                    T_in=P['T0'])
            res = nmf(X_rank, K, mesh=g, **warm, **kw)
            mine[name] = _fit_dict(res)
            if 'obj_calculator' in res:
                # the calculator on the mesh, every rank calling
                mine[name]['calculator'] = float(
                    res['obj_calculator'].true_objective())
            whole[name] = _fit_dict(nmf(X_all, K, mesh=g, device='cpu',
                                        **warm_all, **extra, **kw))
        # E: resumed with different warm starts, equal to A straight
        import torch.distributed as dist
        ck = os.path.join(tmp, 'E%s' % '-'.join(map(str, g.shape)),
                          'rank%d' % dist.get_rank())
        X_rank = _inputs(g, P, 'dense')[0]
        kw = dict(CONFIGS['A'][1])
        first = nmf(X_rank, K, W_in=Wg, T_in=Tg, mesh=g, checkpoint=ck,
                    checkpoint_every=2, **dict(kw, max_iter=2))
        W2, T2 = distribute_factors(1.0 - P['W0'][lo:hi], 1.0 - P['T0'], N,
                                    g, device='cpu')
        mine['E'] = _fit_dict(nmf(X_rank, K, W_in=W2, T_in=T2, mesh=g,
                                  checkpoint=ck, checkpoint_every=100, **kw))
        mine['E']['first_history'] = list(first['obj_history'])
        whole['E'] = whole['A']
    every = _every(mine)[:g.size]
    first = every[0]
    return {'shape': g.shape, 'fits': first,
            'across_ranks': {name: all(_same_fit(e[name], first[name])
                                       for e in every) for name in first},
            'as_whole': {name: _same_fit(first[name], whole[name])
                         for name in whole}}


def case_world(mesh):
    """The process group and the global meshes as every rank sees them:
    ``initialize_distributed`` (idempotent), the default global mesh's
    shape and coordinates, explicit shapes, the layout errors (a ``tp``
    row across hosts; hosts of unequal rank counts), the host-name form
    without ``LOCAL_WORLD_SIZE``, and ``process_row_block`` on both
    meshes for several n."""
    from rri_nmf_tpu_torch.parallel import (initialize_distributed,
                                            make_global_mesh, make_mesh,
                                            process_row_block)
    from rri_nmf_tpu_torch.parallel.mesh import block_range
    out = {'init': [initialize_distributed(), initialize_distributed()]}
    g = _global(None)
    g41 = _global((4, 1))
    out['default'] = (g.shape, g.coordinate)
    out['explicit'] = (g41.shape, g41.coordinate)
    out['like_make_mesh'] = make_mesh(4).shape == g.shape
    for key, shape, local in (('tp_across', (1, 4), '2'),
                              ('unequal', (2, 2), '3')):
        saved = os.environ['LOCAL_WORLD_SIZE']
        os.environ['LOCAL_WORLD_SIZE'] = local
        try:
            make_global_mesh(mesh_shape=shape)
            out[key] = None
        except ValueError as e:
            out[key] = str(e)
        finally:
            os.environ['LOCAL_WORLD_SIZE'] = saved
    saved = os.environ.pop('LOCAL_WORLD_SIZE')
    try:
        one_host = make_global_mesh()
        out['one_host'] = (one_host.shape, one_host.coordinate)
    finally:
        os.environ['LOCAL_WORLD_SIZE'] = saved
    out['rows'] = {}
    out['rule'] = True
    for m in (g, g41):
        for n in (100, 5, 64, 17, 4):
            r = process_row_block(n, m)
            out['rows'][(m.shape, n)] = r
            out['rule'] &= r == block_range(n, m.shape[0], m.coordinate[0])
    g31 = _global((3, 1))
    try:
        process_row_block(10, g31)
        out['outside'] = None
    except ValueError as e:
        out['outside'] = str(e)
    try:
        process_row_block(3, g41)
        out['too_few'] = None
    except ValueError as e:
        out['too_few'] = str(e)
    every = _every(out)
    return dict(every[0], every=every, outside=every[-1]['outside'])


def case_roundtrip(mesh):
    """``distribute_dense`` / ``distribute_factors`` on the default
    global mesh, gathered back: the whole X, W and T, each rank's block
    range and the layout of T; then the whole-X-free fit's parity with
    the single-device fit (JAX's ``test_global_mesh_drives_a_sharded_fit``
    settings)."""
    import torch

    from rri_nmf_tpu_torch.nmf import nmf
    from rri_nmf_tpu_torch.parallel import (distribute_dense,
                                            distribute_factors,
                                            process_row_block)
    g = _global(None)
    rng = np.random.RandomState(0)
    X = rng.rand(N, D)
    W, T = rng.rand(N, 5), rng.rand(5, D)
    lo, hi = process_row_block(N, g)
    Xg = distribute_dense(X[lo:hi], X.shape, g, device='cpu')
    Wg, Tg = distribute_factors(W[lo:hi], T, N, g, device='cpu')
    s = Xg.split
    out = {'X': _np(g.gather_cols(g.gather_rows(Xg.block, s), s)),
           'W': _np(g.gather_rows(Wg.block, s)), 'T': _np(Tg),
           'block': (tuple(Xg.block.shape), Xg.shape, s),
           'W_block': (tuple(Wg.block.shape), Wg.shape),
           'contiguous': Xg.block.is_contiguous()}
    rng = np.random.RandomState(2)
    X2 = np.abs(rng.rand(96, 64))
    kw = dict(max_iter=3, random_state=0, early_stop=False,
              update_order='phase', reset_topic_method=None, eps_stop=0)
    lo, hi = process_row_block(96, g)
    W0, T0 = np.abs(rng.rand(96, 4)), np.abs(rng.rand(4, 64))
    Wq, Tq = distribute_factors(W0[lo:hi], T0, 96, g, device='cpu')
    fit = nmf(distribute_dense(X2[lo:hi], X2.shape, g, device='cpu'), 4,
              W_in=Wq, T_in=Tq, mesh=g, **kw)
    one = nmf(torch.as_tensor(X2), 4, W_in=W0, T_in=T0, **kw)
    out['fit'] = {key: _np(fit[key]) for key in ('W', 'T')}
    out['single'] = {key: _np(one[key]) for key in ('W', 'T')}
    return out


def _tensors(obj, prefix=''):
    """The tensors of a plan, by attribute path (numbers as they are)."""
    import torch
    out = {}
    if isinstance(obj, torch.Tensor):
        if obj.layout == torch.sparse_coo:
            return {prefix + 'indices': obj.indices(),
                    prefix + 'values': obj.values()}
        return {prefix: obj}
    if isinstance(obj, (int, float, str, tuple)) or obj is None:
        return {prefix: obj}
    if isinstance(obj, (list,)):
        for i, v in enumerate(obj):
            out.update(_tensors(v, '%s%d.' % (prefix, i)))
        return out
    for key, v in vars(obj).items():
        if key.startswith('_') or key in ('split', 'obj_coo') or callable(v):
            continue
        out.update(_tensors(v, prefix + key + '.'))
    return out


def _equal_plans(a, b):
    ta, tb = _tensors(a), _tensors(b)
    if ta.keys() != tb.keys():
        return False
    for key in ta:
        x, y = ta[key], tb[key]
        if hasattr(x, 'dtype') and hasattr(x, 'shape'):
            if x.dtype != y.dtype or x.shape != y.shape or (
                    x.numel() and not bool((x == y).all())):
                return False
        elif x != y:
            return False
    return True


def case_plans(mesh):
    """Every rank's slab plans against the whole-X partitioners' plans, bit
    for bit: ``distribute_sparse_coo`` (None and ``'mxu'``, its COO
    companion too) on the default mesh and on (4, 1), and
    ``distribute_masked_coo`` (None, ``'segsum'``, ``'mxu'``) on (4, 1);
    the ``'mxu'`` plan's row range (``split``) against
    ``process_row_block``'s, the plan's ``split`` against the mesh's."""
    import torch

    from rri_nmf_tpu_torch.parallel import (
        distribute_masked_coo, distribute_sparse_coo, partition_coo,
        partition_masked_coo, partition_masked_gram, partition_mxu,
        process_row_block)
    P = problem()
    out = {}
    for g in (_global(None), _global((4, 1))):
        lo, hi = process_row_block(N, g)
        tag = g.shape
        coo = distribute_sparse_coo(P['Xs'][lo:hi], (N, D), g,
                                    dtype=np.float64, device='cpu')
        mxu = distribute_sparse_coo(P['Xs'][lo:hi], (N, D), g,
                                    dtype=np.float64, backend='mxu',
                                    device='cpu')
        ref = partition_coo(P['Xs'], g, torch.float64, 'cpu')
        out[tag, 'coo'] = _equal_plans(coo, ref)
        out[tag, 'mxu'] = _equal_plans(
            mxu, partition_mxu(P['Xs'], g, torch.float64, 'cpu'))
        out[tag, 'obj_coo'] = _equal_plans(mxu.obj_coo, ref.coo)
        out[tag, 'rows'] = ((mxu.split.r0, mxu.split.r1) == (lo, hi)
                            == (coo.split.r0, coo.split.r1)
                            and mxu.split == g.split(N, D))
        if g.shape[1] != 1:
            continue
        for backend in (None, 'segsum', 'mxu'):
            plan = distribute_masked_coo(P['Xm'][lo:hi], P['Ms'][lo:hi],
                                         (N, D), g, backend=backend,
                                         device='cpu')
            ref = (partition_masked_coo(P['Xm'], P['Ms'], g, torch.float64,
                                        'cpu') if backend is None else
                   partition_masked_gram(P['Xm'], P['Ms'], g, torch.float64,
                                         backend=backend, device='cpu'))
            out[tag, 'masked', backend] = (_equal_plans(plan, ref)
                                           and plan.split == g.split(N, D))
    every = _every(out)
    return {key: all(e[key] for e in every) for key in every[0]}


def _error(fn):
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            fn()
    except Exception as e:          # the test checks the kind and text
        return '%s: %s' % (type(e).__name__, e)
    return ['%s: %s' % (w.category.__name__, w.message) for w in caught]


def case_guards(mesh):
    """The guards of JAX's ``test_distribute_sparse_coo_guards`` and
    ``test_distribute_masked_coo_guards`` on slab plans (JAX's (8, 1) is
    (4, 1) here, its (4, 2) the default (2, 2)), and of a rank-block X;
    the first rank's error messages (or warnings) by name."""
    import scipy.sparse as sp
    import torch

    from rri_nmf_tpu_torch.nmf import nmf
    from rri_nmf_tpu_torch.parallel import (RankBlock, distribute_dense,
                                            distribute_factors,
                                            distribute_masked_coo,
                                            distribute_sparse_coo,
                                            process_row_block)
    g41, g22 = _global((4, 1)), _global(None)
    n, d, k = 37, 29, 4
    rng = np.random.RandomState(2)
    X = sp.random(n, d, density=0.25, random_state=5, format='csr')
    X.data += 0.5
    W0, T0 = np.abs(rng.rand(n, k)), np.abs(rng.rand(k, d))
    lo, hi = process_row_block(n, g41)
    slab = X[lo:hi]
    out = {}
    out['dense_rows'] = _error(lambda: distribute_dense(
        X[:3].toarray(), (n, d), g41, device='cpu'))
    out['dense_columns'] = _error(lambda: distribute_dense(
        slab[:, :10].toarray(), (n, d), g41, device='cpu'))
    out['factor_rows'] = _error(lambda: distribute_factors(
        W0[:3], T0, n, g41, device='cpu'))
    out['rows'] = _error(lambda: distribute_sparse_coo(X[:3], (n, d), g41))
    out['columns'] = _error(lambda: distribute_sparse_coo(
        slab[:, :10], (n, d), g41))
    out['backend'] = _error(lambda: distribute_sparse_coo(
        slab, (n, d), g41, backend='bogus'))
    plan = distribute_sparse_coo(slab, (n, d), g41, dtype=np.float64,
                                 device='cpu')
    base = dict(W_in=W0, T_in=T0, max_iter=2)
    out['warm'] = _error(lambda: nmf(plan, k, mesh=g41, max_iter=2))
    out['no_mesh'] = _error(lambda: nmf(plan, k, **base))
    out['w_mat'] = _error(lambda: nmf(plan, k, mesh=g41, W_mat=sp.csr_matrix(
        np.ones((n, d))), **base))
    lo22, hi22 = process_row_block(n, g22)
    plan22 = distribute_sparse_coo(X[lo22:hi22], (n, d), g22,
                                   dtype=np.float64, device='cpu')
    out['other_mesh_cols'] = _error(lambda: nmf(plan22, k, mesh=g41, **base))
    out['conflicts'] = _error(lambda: nmf(plan, k, mesh=g41, sparse=False,
                                          **base))
    out['mxu_kwarg'] = _error(lambda: nmf(plan, k, mesh=g41, sparse='mxu',
                                          **base))
    out['other_mesh_rows'] = _error(lambda: nmf(plan, k, mesh=g22, **base))
    out['dtype'] = _error(lambda: nmf(plan, k, mesh=g41, dtype=np.float32,
                                      **base))
    out['diagnostics'] = _error(lambda: nmf(
        plan, k, mesh=g41, diagnostics=lambda X, W, T: float(W.sum()),
        **base))
    out['host_x'] = _error(lambda: nmf(
        plan, k, mesh=g41, early_stop=lambda X, W, T, d2: False, **base))
    plan_nc = distribute_sparse_coo(slab, (n, d), g41, dtype=np.float64,
                                    backend='mxu', with_obj_coo=False,
                                    device='cpu')
    out['no_companion'] = plan_nc.obj_coo is None
    out['with_obj_coo'] = _error(lambda: nmf(
        plan_nc, k, mesh=g41, compute_obj_each_iter=True, early_stop=False,
        **base))
    r = nmf(plan_nc, k, mesh=g41, compute_obj_each_iter=False,
            early_stop=False, **base)
    out['untracked_finite'] = bool(torch.isfinite(r['W']).all())
    # the masked plans (JAX's test_distribute_masked_coo_guards)
    n, d = 32, 24
    rng = np.random.RandomState(2)
    M = (rng.rand(n, d) < 0.4).astype(float)
    Xm = rng.rand(n, d) * M
    Ms = sp.csr_matrix(M)
    lo, hi = process_row_block(n, g41)
    out['row_partitioned'] = _error(lambda: distribute_masked_coo(
        Xm, Ms, (n, d), g22))
    out['scipy_sparse'] = _error(lambda: distribute_masked_coo(
        Xm[lo:hi], M[lo:hi], (n, d), g41))
    out['masked_rows'] = _error(lambda: distribute_masked_coo(
        Xm[:3], Ms[:3], (n, d), g41))
    out['masked_backend'] = _error(lambda: distribute_masked_coo(
        Xm[lo:hi], Ms[lo:hi], (n, d), g41, backend='bogus'))
    mplan = distribute_masked_coo(Xm[lo:hi], Ms[lo:hi], (n, d), g41,
                                  device='cpu')
    out['masked_warm'] = _error(lambda: nmf(mplan, k, mesh=g41, max_iter=2))
    gplan = distribute_masked_coo(Xm[lo:hi], Ms[lo:hi], (n, d), g41,
                                  backend='segsum', device='cpu')
    W0, T0 = np.abs(rng.rand(n, k)), np.abs(rng.rand(k, d))
    out['phase'] = _error(lambda: nmf(gplan, k, W_in=W0, T_in=T0, mesh=g41,
                                      max_iter=2, reset_topic_method=None))
    out['gram_plan_warning'] = _error(lambda: nmf(
        mplan, k, W_in=W0, T_in=T0, mesh=g41, max_iter=2,
        update_order='phase', reset_topic_method=None))
    out['masked_other_mesh'] = _error(lambda: nmf(
        mplan, k, W_in=W0, T_in=T0, mesh=g22, max_iter=2))
    # a rank-block X (JAX's process-spanning X guards)
    lo, hi = process_row_block(n, g22)
    Xb = distribute_dense(Xm[lo:hi], (n, d), g22, device='cpu')
    out['block_no_mesh'] = _error(lambda: nmf(Xb, k, max_iter=1))
    out['block_sparse'] = _error(lambda: nmf(Xb, k, mesh=g22, sparse=True,
                                             max_iter=1))
    out['block_w_row'] = _error(lambda: nmf(Xb, k, mesh=g22,
                                            w_row=np.ones(n), max_iter=1))
    out['block_sparse_mask'] = _error(lambda: nmf(Xb, k, mesh=g22, W_mat=Ms,
                                                  max_iter=1))
    out['block_int'] = _error(lambda: nmf(
        RankBlock(Xb.block.long(), Xb.split, False), k, mesh=g22,
        max_iter=1))
    out['block_other_mesh'] = _error(lambda: nmf(Xb, k, mesh=g41,
                                                 max_iter=1))
    out['block_pmi'] = _error(lambda: nmf(Xb, k, mesh=g22,
                                          init='coherence_pmi', max_iter=1))
    Wb, _ = distribute_factors(np.ones((hi - lo, k)), np.ones((k, d)), n, g22,
                               device='cpu')
    out['block_w_in_alone'] = _error(lambda: nmf(Xb, k, mesh=g22, W_in=Wb,
                                                 max_iter=1))
    return out


def case_restore(mesh, tmp):
    """A checkpointed fit on the default global mesh whose ranks see
    different directories (``tmp``/<case>/rank<r>): (a) only the first
    rank's holds a checkpoint (2 sweeps of A's settings, written by it),
    and a fit of 5 from other warm starts resumes from it on every rank;
    (b) only the second rank's holds one (from another fit), and every
    rank starts fresh. The fits, each against its straight counterpart,
    bit for bit, on every rank."""
    import torch.distributed as dist

    from rri_nmf_tpu_torch.checkpoint import NMFCheckpointer
    from rri_nmf_tpu_torch.nmf import nmf
    from rri_nmf_tpu_torch.parallel import (distribute_dense,
                                            distribute_factors,
                                            process_row_block)
    g = _global(None)
    P = problem()
    rank = dist.get_rank()
    lo, hi = process_row_block(N, g)
    Xg = distribute_dense(P['X'][lo:hi], (N, D), g, device='cpu')
    Wg, Tg = distribute_factors(P['W0'][lo:hi], P['T0'], N, g, device='cpu')
    W2, T2 = distribute_factors(1.0 - P['W0'][lo:hi], 1.0 - P['T0'], N, g,
                                device='cpu')
    kw = dict(CONFIGS['A'][1])
    straight = _fit_dict(nmf(Xg, K, W_in=Wg, T_in=Tg, mesh=g, **kw))
    fresh = _fit_dict(nmf(Xg, K, W_in=W2, T_in=T2, mesh=g, **kw))
    ck_a = os.path.join(tmp, 'a', 'rank%d' % rank)
    nmf(Xg, K, W_in=Wg, T_in=Tg, mesh=g, checkpoint=ck_a,
        checkpoint_every=2, **dict(kw, max_iter=2))
    on_disk_a = NMFCheckpointer(ck_a).steps()
    resumed = _fit_dict(nmf(Xg, K, W_in=W2, T_in=T2, mesh=g,
                            checkpoint=ck_a, checkpoint_every=100, **kw))
    ck_b = os.path.join(tmp, 'b', 'rank%d' % rank)
    if rank == 1:
        # a checkpoint of another fit, on this rank's disk only
        import torch
        nmf(torch.as_tensor(P['X']), K, W_in=P['W0'], T_in=P['T0'],
            checkpoint=ck_b, checkpoint_every=3, **dict(kw, max_iter=3))
    on_disk_b = NMFCheckpointer(ck_b).steps()
    started = _fit_dict(nmf(Xg, K, W_in=W2, T_in=T2, mesh=g,
                            checkpoint=ck_b, checkpoint_every=100, **kw))
    mine = {'disk_a': on_disk_a, 'disk_b': on_disk_b,
            'resumed': _same_fit(resumed, straight),
            'started': _same_fit(started, fresh)}
    every = _every(mine)
    return {'every': every, 'resumed': resumed, 'straight': straight}


def case_nndsvd(mesh, shape, init='nndsvd'):
    """The NNDSVD init of a rank's block through the mesh
    (``initialize_nmf(RankBlock, svd_backend='torch', mesh=...)``) on a
    ``shape`` global mesh against the single-device one of the whole X
    with the same Ω (one seed), and the SVD (``randomized_svd_torch`` of
    the block, gathered; S and U·diag(S)·Vt) against the whole X's: the
    largest gaps, and whether the ranks agree bit for bit."""
    import torch

    from rri_nmf_tpu_torch.initialization import (initialize_nmf,
                                                  randomized_svd_torch)
    from rri_nmf_tpu_torch.parallel import distribute_dense, process_row_block
    g = _global(tuple(shape))
    X = problem()['X']
    out = {}
    if g.coordinate is not None:
        lo, hi = process_row_block(N, g)
        Xg = distribute_dense(X[lo:hi], (N, D), g, device='cpu')
        W, H = initialize_nmf(Xg, K, init, random_state=5,
                              svd_backend='torch', mesh=g)
        Wl, Hl = initialize_nmf(torch.as_tensor(X), K, init, random_state=5,
                                svd_backend='torch')
        gen = torch.Generator().manual_seed(5)
        U, S, Vt = randomized_svd_torch(Xg, K, generator=gen, mesh=g)
        gen = torch.Generator().manual_seed(5)
        Ul, Sl, Vtl = randomized_svd_torch(torch.as_tensor(X), K,
                                           generator=gen)
        U, Vt = g.gather_rows(U, Xg.split), g.gather_cols(Vt, Xg.split)
        # (a component's sign is free: compare U·diag(S)·Vt)
        gap = {name: float((a - b).abs().max()) for name, a, b in (
            ('W', W, Wl), ('H', H, Hl), ('S', S, Sl),
            ('USVt', (U * S) @ Vt, (Ul * Sl) @ Vtl))}
        out = {'gap': gap, 'bits': {'W': _np(W), 'H': _np(H)},
               'equal': torch.equal(W, Wl) and torch.equal(H, Hl)}
    every = _every(out)[:g.size]
    return dict(every[0], across_ranks=all(
        np.array_equal(e['bits']['W'], every[0]['bits']['W'])
        and np.array_equal(e['bits']['H'], every[0]['bits']['H'])
        for e in every))


def case_block_options(mesh):
    """On the default global mesh, a rank-block X beside the whole-X mesh
    fit: a dense mask as a RankBlock and whole (B3/B4's twins), a
    RankBlock ``W_in`` beside a whole X, ``x_dtype='int16'`` and
    ``'bfloat16'``, a fresh NNDSVD init, a callback (X gathered whole),
    and the objective calculator's pickle; bit for bit where the inputs
    are the same, and the first rank's answers."""
    import pickle

    import torch

    from rri_nmf_tpu_torch.nmf import nmf
    from rri_nmf_tpu_torch.parallel import (distribute_dense,
                                            distribute_factors,
                                            process_row_block)
    g = _global(None)
    P = problem()
    lo, hi = process_row_block(N, g)
    Xg = distribute_dense(P['Xm'][lo:hi], (N, D), g, device='cpu')
    Mg = distribute_dense(P['M'][lo:hi], (N, D), g, device='cpu')
    Wg, Tg = distribute_factors(P['W0'][lo:hi], P['T0'], N, g, device='cpu')
    warm = dict(W_in=Wg, T_in=Tg)
    whole = dict(W_in=P['W0'], T_in=P['T0'], device='cpu')
    masked = dict(max_iter=3, random_state=7, compute_obj_each_iter=True,
                  reset_topic_method=None, t_row_sum=1.0)
    out = {}

    def same(name, a, b):
        out[name] = _same_fit(_fit_dict(a), _fit_dict(b))

    ref = nmf(P['Xm'], K, W_mat=P['M'], mesh=g, **whole, **masked)
    same('mask_block', nmf(Xg, K, W_mat=Mg, mesh=g, **warm, **masked), ref)
    same('mask_whole', nmf(Xg, K, W_mat=P['M'], mesh=g, **warm, **masked),
         ref)
    same('w_in_block', nmf(P['Xm'], K, W_mat=P['M'], mesh=g, device='cpu',
                           **warm, **masked), ref)
    dense = dict(CONFIGS['A'][1], max_iter=3, reset_topic_method=None)
    for x_dtype in ('int16', 'bfloat16'):
        same(x_dtype, nmf(Xg, K, mesh=g, x_dtype=x_dtype, **warm, **dense),
             nmf(P['Xm'], K, mesh=g, x_dtype=x_dtype, **whole, **dense))
    fresh = nmf(Xg, K, mesh=g, init='nndsvd', **dense)
    out['fresh_finite'] = bool(torch.isfinite(fresh['W']).all()) and (
        fresh['obj_history'][-1] <= fresh['obj_history'][0])

    def frobenius(X, W, T):
        return float(torch.linalg.norm(X - W @ T))
    cb = nmf(Xg, K, mesh=g, diagnostics=frobenius, **warm, **dense)
    cb_whole = nmf(P['Xm'], K, mesh=g, diagnostics=frobenius, **whole,
                   **dense)
    out['diagnostics'] = (cb['diagnostics']['frobenius']
                          == cb_whole['diagnostics']['frobenius'])
    calc = cb['obj_calculator']
    out['objective'] = calc.true_objective() == cb['obj_history'][-1]
    try:
        pickle.loads(pickle.dumps(calc)).true_objective()
        out['pickled'] = None
    except ValueError as e:
        out['pickled'] = str(e)
    every = _every(out)
    return dict(every[0], across_ranks=all(e == every[0] for e in every))
