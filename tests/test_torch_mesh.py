"""The port's first mesh slice (ROADMAP A.12a: ``rri_nmf_tpu_torch.
parallel.mesh``, the plain sweep and the topic resets on a mesh, the
distributed objective, ``nmf(mesh=...)`` with HER and checkpoints)
against the JAX package, on the CPU in float64.

The port's ranks are four processes of one gloo world
(``tests/torch_mesh_worker.py``, started once for the module); a case
runs on meshes of (1, 1) up to (2, 2) ranks and comes back whole from the
first rank. The JAX references run here, on the conftest's eight virtual
devices: JAX's single-device fit and, for the ``nmf(mesh=...)`` cases,
JAX's mesh fit at the same mesh shape. The non-masked cases of
``tests/test_sharding.py`` and the mesh cases of ``tests/test_accel.py``
and ``tests/test_checkpoint.py`` are carried over at their tolerances:

- 1e-12 for the TM and the row-only training steps and ``nmf(mesh=)``;
- 1e-11 for resets (one block and several per rank) and unaligned shapes
  (the port splits those in uneven blocks, where JAX replicates the
  axis: the same numbers);
- 1e-12 relative for the distributed objective (dense and int16 X);
- 1e-9 for HER (1e-12 grouped against per-sweep), 1e-12 resumed against
  straight, 1e-11 across layouts.

The port's sweep runs B1's plain twin on the CPU where JAX's default
there is its XLA sweep, so each port fit is also held against the port's
own single-device fit at the same bound. The masked, sparse and
sparse-mask meshes and ``store_gradients`` on a mesh have their own
modules (``tests/test_torch_sharded_masked.py``,
``test_torch_sparse_mesh.py``, ``test_torch_masked_sparse_mesh.py``,
``test_torch_masked_gram_mesh.py``); here each runs once through
``nmf(mesh=...)``, and the objective calculator of a mesh fit and a
fitted estimator with a mesh pickle as JAX's do.
"""

import numpy as np
import pytest
import scipy.sparse
import torch

import jax
import jax.numpy as jnp
from rri_nmf_tpu.nmf import nmf as jax_nmf
from rri_nmf_tpu.ops.accel import make_residual_obj as jax_residual_obj
from rri_nmf_tpu.ops.quantized import quantize_x as jax_quantize_x
from rri_nmf_tpu.ops.sweep_xla import SweepConfig as JaxSweepConfig
from rri_nmf_tpu.ops.sweep_xla import make_reset_rowcol as \
    jax_make_reset_rowcol
from rri_nmf_tpu.ops.sweep_xla import make_sweep as jax_make_sweep
from rri_nmf_tpu.parallel import make_mesh as jax_make_mesh
from rri_nmf_tpu_torch.nmf import nmf as torch_nmf
from rri_nmf_tpu_torch.parallel import Mesh, make_mesh, problem_shardings
from rri_nmf_tpu_torch.parallel.mesh import block_range
from torch_mesh_worker import MeshPool, frobenius

torch.set_num_threads(2)

MESHES = [(1, 1), (2, 1), (4, 1), (1, 2), (2, 2)]
MESH_TOL = 1e-12
RESET_TOL = 1e-11
HER_TOL = 1e-9


@pytest.fixture(scope='module')
def pool(tmp_path_factory):
    p = MeshPool(tmp_path_factory.mktemp('mesh_ranks'))
    yield p
    p.close()


def _problem(n=64, d=32, k=6, seed=0):
    rng = np.random.RandomState(seed)
    return np.abs(rng.rand(n, d)), np.abs(rng.rand(n, k)), \
        np.abs(rng.rand(k, d))


def _lowrank(n, d, k, seed=0, noise=0.01):
    rng = np.random.RandomState(seed)
    return np.abs(rng.rand(n, k) @ rng.rand(k, d) + noise * rng.rand(n, d))


def _close(a, b, tol):
    return np.allclose(np.asarray(a, float), np.asarray(b, float), rtol=0,
                       atol=tol)


def _jax_mesh(shape):
    return jax_make_mesh(shape[0] * shape[1], mesh_shape=shape)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _same_fit(got, want, tol, obj=True):
    assert _close(got['W'], want['W'], tol), \
        np.abs(got['W'] - np.asarray(want['W'])).max()
    assert _close(got['T'], want['T'], tol)
    if obj:
        assert np.allclose(got['obj_history'], want['obj_history'],
                           rtol=tol, atol=0)


# ---------------------------------------------------------------------------
# the mesh and its layouts
# ---------------------------------------------------------------------------

def test_make_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match='init_process_group'):
        make_mesh()


@pytest.mark.parametrize('size,parts', [(10, 4), (64, 2), (3, 3), (7, 1)])
def test_blocks_follow_tensor_split(size, parts):
    want = [(int(b[0]), int(b[-1]) + 1) for b in
            torch.tensor_split(torch.arange(size), parts)]
    assert [block_range(size, parts, i) for i in range(parts)] == want


def test_mesh_shapes_coordinates_and_layouts(pool):
    """JAX's default shape rule, each rank's coordinate, a bad shape's
    error; the layouts of problem_shardings and the ranks' blocks."""
    got = pool.run('made', mesh=(2, 2), shapes=[None, 4, 3, 2, 1])
    assert got['shapes'] == [(2, 2), (2, 2), (3, 1), (1, 2), (1, 1)]
    assert got['coordinates'] == [(0, 0), (0, 0), (0, 0), (0, 0), (0, 0)]
    assert 'does not fit a world of 4' in got['bad']
    assert got['ranges'] == [(0, 5, 0, 4), (0, 5, 4, 7), (5, 10, 0, 4),
                             (5, 10, 4, 7)]
    assert got['outside'] == 'rank 3 is not in Mesh(dp=3, tp=1)'


# ---------------------------------------------------------------------------
# the training step (tests/test_sharding.py)
# ---------------------------------------------------------------------------

def _jax_steps(cfg, X, W, T, sweeps, resets=0):
    sweep = jax_make_sweep(JaxSweepConfig(**cfg))
    key = jax.random.PRNGKey(0)
    left = jnp.asarray(resets, jnp.int32)
    W, T = jnp.asarray(W), jnp.asarray(T)
    for _ in range(sweeps):
        W, T, key, left = sweep(jnp.asarray(X), W, T, key, left, key)
    return np.asarray(W), np.asarray(T), int(left)


TM_CFG = dict(k=6, project_T_each_iter=True, project_W_each_iter=True,
              t_row_sum=1.0, w_row_sum=1.0)


@pytest.mark.parametrize('mesh', MESHES)
def test_sharded_equals_single_device_tm(pool, mesh):
    """The (dp, tp) training step (the TM constraints, resets on) equals
    JAX's single-device sweep at 1e-12, and its objective descends."""
    X, W0, T0 = _problem()
    got = pool.run('step', mesh=mesh, X=X, W=W0, T=T0, cfg=TM_CFG,
                   sweeps=2, resets=23)
    Wd, Td, left = _jax_steps(TM_CFG, X, W0, T0, 2, resets=23)
    assert got['obj'][1] <= got['obj'][0]
    assert got['resets'] == left
    assert _close(got['W'], Wd, MESH_TOL) and _close(got['T'], Td, MESH_TOL)


@pytest.mark.parametrize('mesh', [(4, 1), (2, 1)])
def test_row_only_mesh(pool, mesh):
    """Pure dp sharding (tp = 1), the topic-modeling layout."""
    X, W0, T0 = _problem(n=80)
    cfg = dict(k=6, reset_topic_method=None)
    got = pool.run('step', mesh=mesh, X=X, W=W0, T=T0, cfg=cfg, sweeps=1)
    Wd, Td, _ = _jax_steps(cfg, X, W0, T0, 1)
    assert np.isfinite(got['obj'][0])
    assert _close(got['W'], Wd, MESH_TOL) and _close(got['T'], Td, MESH_TOL)


# ---------------------------------------------------------------------------
# nmf(mesh=...)
# ---------------------------------------------------------------------------

_JAX = {}


def _jax_fit(name, X, mesh=None, **kw):
    """JAX's fit of case ``name`` (on a JAX mesh of shape ``mesh``),
    computed once for the module."""
    key = (name, mesh)
    if key not in _JAX:
        extra = {} if mesh is None else dict(mesh=_jax_mesh(mesh))
        _JAX[key] = {k: (np.asarray(v) if k in ('W', 'T') else v)
                     for k, v in jax_nmf(X, **kw, **extra).items()}
    return _JAX[key]


PARAM_KW = dict(k=3, max_iter=5, random_state=0, early_stop=False,
                compute_obj_each_iter=True, reset_topic_method=None,
                project_T_each_iter=True, project_W_each_iter=True,
                t_row_sum=1.0, w_row_sum=1.0)


@pytest.mark.parametrize('mesh', MESHES)
def test_nmf_mesh_param(pool, mesh):
    """The whole fit on the mesh equals the single-device fits (JAX's and
    the port's) and JAX's fit on the same mesh at 1e-12."""
    X = _lowrank(64, 40, 3)
    got = pool.run('fit', mesh=mesh, X=X, kw=PARAM_KW)
    _same_fit(got, _jax_fit('param', X, **PARAM_KW), MESH_TOL)
    _same_fit(got, _jax_fit('param', X, mesh=mesh, **PARAM_KW), MESH_TOL)
    _same_fit(got, {k: _np(v) for k, v in torch_nmf(
        X, device='cpu', **PARAM_KW).items()}, MESH_TOL)


def _dead(n, d, k, dead, seed):
    rng = np.random.RandomState(seed)
    X = np.abs(rng.rand(n, k) @ rng.rand(k, d))
    W0 = np.abs(rng.rand(n, k))
    T0 = np.abs(rng.rand(k, d))
    for t in dead:
        W0[:, t] = 0.0
        T0[t] = 0.0
    return X, W0, T0


@pytest.mark.parametrize('mesh', [(4, 1), (2, 2), (1, 2)])
@pytest.mark.parametrize('order', ['phase', 'interleaved'])
def test_sharded_resets_match_single_device(pool, mesh, order):
    """Resets on a mesh (blockwise residual norms per rank, summed over
    tp, the first maximum over dp) pick JAX's documents: dead topics in
    phase order, and in the interleaved order where both checks fire."""
    if order == 'phase':
        X, W0, T0 = _dead(64, 40, 4, (1, 3), 0)
        kw = dict(k=4, max_iter=5, random_state=0, early_stop=False,
                  compute_obj_each_iter=True, n_resets=5,
                  update_order='phase',
                  reset_topic_method='max_resid_document')
        left = 3
    else:
        X, W0, T0 = _dead(48, 32, 3, (0,), 2)
        kw = dict(k=3, max_iter=4, random_state=0, early_stop=False,
                  n_resets=23, update_order='interleaved',
                  compute_obj_each_iter=True,
                  reset_topic_method='max_resid_document')
        left = None
    kw.update(W_in=W0, T_in=T0)
    want = _jax_fit('resets ' + order, X, **kw)
    got = pool.run('fit', mesh=mesh, X=X, kw=kw)
    assert got['n_resets_remaining'] == want['n_resets_remaining']
    if left is not None:
        assert got['n_resets_remaining'] == left
    _same_fit(got, want, RESET_TOL)
    assert np.all(np.diff(got['obj_history']) <= 1e-12)


def test_sharded_resets_multiblock_per_device(pool):
    """Several residual blocks per rank (9216 rows a rank: 4096 + 4096 +
    a clamped last block), combined over four dp ranks."""
    rng = np.random.RandomState(1)
    k, n, d = 3, 4 * 9216, 16
    X = np.abs(rng.rand(n, k) @ rng.rand(k, d)) + 0.01
    W0 = np.abs(rng.rand(n, k))
    T0 = np.abs(rng.rand(k, d))
    W0[:, 1] = 0.0
    T0[1] = 0.0
    kw = dict(k=k, max_iter=2, random_state=1, early_stop=False,
              compute_obj_each_iter=True, n_resets=5,
              reset_topic_method='max_resid_document', W_in=W0, T_in=T0)
    want = _jax_fit('multiblock', X, **kw)
    got = pool.run('fit', mesh=(4, 1), X=X, kw=kw)
    assert got['n_resets_remaining'] == want['n_resets_remaining'] == 4
    _same_fit(got, want, RESET_TOL)


@pytest.mark.parametrize('mesh', [(4, 1), (1, 2), (2, 2)])
def test_mesh_reset_rowcol_matches_jax(pool, mesh):
    """The mesh reset alone: the document and its row against JAX's
    single-device blockwise reset; a 'random' reset's blocks against the
    port's single-device draw from the same seed."""
    X, W, T = _problem(n=50, d=37, k=3, seed=4)
    cfg = dict(k=3, reset_topic_method='max_resid_document')
    got = pool.run('reset', mesh=mesh, X=X, W=W, T=T, cfg=cfg, t=1)
    key = jax.random.PRNGKey(0)
    row, col, _ = jax_make_reset_rowcol(JaxSweepConfig(**cfg))(
        jnp.asarray(X), jnp.asarray(W), jnp.asarray(T), 1, key, key)
    assert _close(got['row'], row, RESET_TOL)
    assert np.array_equal(got['col'], np.asarray(col))
    from rri_nmf_tpu_torch.ops.sweep import (SweepConfig, make_draws,
                                             make_reset_rowcol)
    for seeded in (False, True):
        rcfg = dict(k=3, reset_topic_method='random', fix_reset_seed=seeded)
        got = pool.run('reset', mesh=mesh, X=X, W=W, T=T, cfg=rcfg, t=2)
        row, col = make_reset_rowcol(SweepConfig(**rcfg))(
            torch.as_tensor(X), torch.as_tensor(W), torch.as_tensor(T), 2,
            make_draws(0, 'cpu'))
        assert np.array_equal(got['row'], row.numpy())
        assert np.array_equal(got['col'], col.numpy())


UNALIGNED_KW = dict(k=4, max_iter=5, random_state=0, early_stop=False,
                    compute_obj_each_iter=True)


@pytest.mark.parametrize('mesh', [(2, 2), (4, 1)])
def test_unaligned_shapes_fall_back_to_axiswise_sharding(pool, mesh):
    """Shapes off the mesh quanta: the port splits them in uneven blocks
    (logging the mesh-quanta warning) and gives the single-device numbers,
    with the defaults (resets on) and a per-row w_row_sum."""
    rng = np.random.RandomState(0)
    X = np.abs(rng.rand(50, 39))
    got = pool.run('fit', mesh=mesh, X=X, kw=UNALIGNED_KW)
    assert any('mesh quanta' in m for m in got['warnings'])
    want = _jax_fit('unaligned', X, **UNALIGNED_KW)
    assert _close(got['W'], want['W'], RESET_TOL)
    assert np.allclose(got['obj_history'], want['obj_history'], rtol=0,
                       atol=RESET_TOL)
    # one axis divisible (rows)
    X2 = np.abs(rng.rand(48, 39))
    got2 = pool.run('fit', mesh=mesh, X=X2, kw=UNALIGNED_KW)
    assert _close(got2['W'], _jax_fit('unaligned rows', X2,
                                      **UNALIGNED_KW)['W'], RESET_TOL)
    wrs = 1.0 + 0.5 * rng.rand(50)
    kwv = dict(k=4, max_iter=4, random_state=0, early_stop=False,
               reset_topic_method=None, w_row_sum=wrs,
               project_W_each_iter=True)
    gotv = pool.run('fit', mesh=mesh, X=X, kw=kwv)
    assert _close(gotv['W'], _jax_fit('unaligned wrs', X, **kwv)['W'],
                  RESET_TOL)
    assert np.allclose(gotv['W'].sum(1), wrs, atol=1e-8)


@pytest.mark.parametrize('mesh', [(2, 2), (1, 1)])
def test_distributed_blockwise_objective_parity(pool, mesh):
    """The distributed residual objective against JAX's single-device
    blockwise one, 1e-12 relative: dense, int16-coded X, and a shape that
    does not tile the mesh."""
    rng = np.random.RandomState(3)
    n, d, k = 64, 48, 5
    X, W, T = rng.rand(n, d), rng.rand(n, k), rng.rand(k, d)
    cfg = dict(k=k, reset_topic_method=None, update_order='phase',
               reg_w_l2=0.01, reg_t_l1=0.005)
    ref = jax_residual_obj(JaxSweepConfig(**cfg), distributed=False)
    v0 = float(ref(jnp.asarray(X), jnp.asarray(W), jnp.asarray(T)))
    v1 = pool.run('objective', mesh=mesh, X=X, W=W, T=T, cfg=cfg)
    assert abs(v1 - v0) < 1e-12 * abs(v0)
    vq0 = float(ref(jax_quantize_x(jnp.asarray(X)), jnp.asarray(W),
                    jnp.asarray(T)))
    vq = pool.run('objective', mesh=mesh, X=X, W=W, T=T, cfg=cfg,
                  quantize=True)
    assert abs(vq - vq0) < 1e-12 * abs(vq0)
    n2, d2 = 63, 47
    X2, W2, T2 = rng.rand(n2, d2), rng.rand(n2, k), rng.rand(k, d2)
    v5 = float(ref(jnp.asarray(X2), jnp.asarray(W2), jnp.asarray(T2)))
    v6 = pool.run('objective', mesh=mesh, X=X2, W=W2, T=T2, cfg=cfg)
    assert abs(v6 - v5) < 1e-12 * abs(v5)


# ---------------------------------------------------------------------------
# HER and checkpoints on a mesh (tests/test_accel.py, test_checkpoint.py)
# ---------------------------------------------------------------------------

HER_KW = dict(k=8, random_state=0, early_stop=False, update_order='phase',
              reset_topic_method=None, eps_stop=0.0, accel='her')


def _uniform(n=128, d=64, k=8, seed=5):
    rng = np.random.RandomState(seed)
    return rng.rand(n, k) @ rng.rand(k, d)


@pytest.mark.parametrize('mesh', [(2, 2), (4, 1)])
def test_her_mesh_matches_single_device(pool, mesh):
    """HER on a mesh: elementwise extrapolation on each rank's blocks,
    the restart check on the distributed objective."""
    X = _uniform()
    got = pool.run('fit', mesh=mesh, X=X, kw=dict(HER_KW, max_iter=20))
    want = _jax_fit('her', X, max_iter=20, **HER_KW)
    assert _close(got['W'], want['W'], HER_TOL)
    assert _close(got['T'], want['T'], HER_TOL)


def test_her_mesh_grouped_dispatch(pool):
    X = _uniform(seed=6)
    a = pool.run('fit', mesh=(2, 2), X=X, kw=dict(HER_KW, max_iter=12))
    b = pool.run('fit', mesh=(2, 2), X=X,
                 kw=dict(HER_KW, max_iter=12, sweeps_per_dispatch=4))
    assert _close(a['W'], b['W'], MESH_TOL) and _close(a['T'], b['T'],
                                                        MESH_TOL)


def _ckpt_problem(n=24, d=16, k=3, seed=0):
    rng = np.random.RandomState(seed)
    return np.abs(rng.rand(n, k) @ rng.rand(k, d) + 0.1 * rng.rand(n, d))


def test_her_mesh_resume_equals_straight(pool, tmp_path):
    """The first rank writes the whole factors and the HER state; a resume
    on the mesh equals the straight mesh fit."""
    X = _ckpt_problem()
    kw = dict(k=3, max_iter=10, random_state=0, early_stop=False,
              compute_obj_each_iter=True, reset_topic_method=None,
              eps_stop=0.0, accel='her', update_order='phase')
    straight = pool.run('fit', mesh=(2, 2), X=X, kw=kw)
    ck = str(tmp_path / 'her_mesh')
    pool.run('fit', mesh=(2, 2), X=X, kw=dict(kw, max_iter=5, checkpoint=ck,
                                              checkpoint_every=5))
    resumed = pool.run('fit', mesh=(2, 2), X=X,
                       kw=dict(kw, checkpoint=ck, checkpoint_every=100))
    assert _close(resumed['W'], straight['W'], MESH_TOL)
    assert _close(resumed['T'], straight['T'], MESH_TOL)


@pytest.mark.parametrize('mesh', [(2, 2), (4, 1)])
def test_mesh_checkpoint_resume_equals_straight(pool, mesh, tmp_path):
    """A mesh checkpoint holds the whole factors (one file, written by the
    first rank); the resumed mesh fit equals the straight one and JAX's
    single-device fit."""
    from rri_nmf_tpu_torch.checkpoint import NMFCheckpointer
    X = _ckpt_problem(n=40, d=24, seed=1)
    kw = dict(k=3, max_iter=8, random_state=0, early_stop=False,
              compute_obj_each_iter=True, reset_topic_method=None,
              update_order='phase', eps_stop=0.0)
    straight = pool.run('fit', mesh=mesh, X=X, kw=kw)
    ck = str(tmp_path / 'mesh_run')
    pool.run('fit', mesh=mesh, X=X, kw=dict(kw, max_iter=4, checkpoint=ck,
                                            checkpoint_every=2))
    state = NMFCheckpointer(ck).restore()
    assert state.iteration == 4 and tuple(state.W.shape) == (40, 3)
    assert tuple(state.T.shape) == (3, 24)
    resumed = pool.run('fit', mesh=mesh, X=X,
                       kw=dict(kw, checkpoint=ck, checkpoint_every=100))
    _same_fit(resumed, straight, MESH_TOL)
    _same_fit(resumed, _jax_fit('ckpt', X, **kw), MESH_TOL)


def test_mesh_checkpoint_cross_layout_resume(pool, tmp_path):
    """A single-device checkpoint resumes on a mesh, and a mesh
    checkpoint on one device."""
    X = _ckpt_problem(n=32, d=20, seed=2)
    base = dict(k=3, max_iter=6, random_state=0, early_stop=False,
                compute_obj_each_iter=True, reset_topic_method=None,
                update_order='phase', eps_stop=0.0)
    straight = _jax_fit('cross', X, **base)
    ck = str(tmp_path / 'single')
    torch_nmf(X, device='cpu', checkpoint=ck, checkpoint_every=3,
              **dict(base, max_iter=3))
    resumed = pool.run('fit', mesh=(4, 1), X=X,
                       kw=dict(base, checkpoint=ck, checkpoint_every=100))
    _same_fit(resumed, straight, RESET_TOL, obj=False)
    ck2 = str(tmp_path / 'mesh')
    pool.run('fit', mesh=(2, 2), X=X, kw=dict(base, max_iter=3,
                                              checkpoint=ck2,
                                              checkpoint_every=3))
    back = torch_nmf(X, device='cpu', checkpoint=ck2, checkpoint_every=100,
                     **base)
    _same_fit({k: _np(v) for k, v in back.items()}, straight, RESET_TOL,
              obj=False)


# ---------------------------------------------------------------------------
# the rest of nmf() on a mesh, and what still raises
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('case', ['dp noise', 'random resets', 'fix_T',
                                  'callbacks', 'w_row'])
def test_nmf_options_on_a_mesh(pool, case):
    """Options whose draws or callbacks the port owns: the (2, 2) mesh fit
    equals the port's single-device fit at 1e-11 (DP noise and 'random'
    resets draw the same numbers from one seed on every rank; callbacks
    see the whole factors)."""
    X = _lowrank(40, 30, 3, seed=7)
    kw = dict(k=3, max_iter=4, random_state=2, early_stop=False,
              compute_obj_each_iter=True)
    if case == 'dp noise':
        kw.update(eps_gauss_t=1e5, delta_gauss_t=1e-3)
    elif case == 'random resets':
        rng = np.random.RandomState(1)
        W0, T0 = np.abs(rng.rand(40, 3)), np.abs(rng.rand(3, 30))
        W0[:, 1] = 0.0
        T0[1] = 0.0
        kw.update(W_in=W0, T_in=T0, reset_topic_method='random')
    elif case == 'fix_T':
        T0 = np.abs(np.random.RandomState(2).rand(3, 30))
        kw.update(T_in=T0 / T0.sum(1, keepdims=True), fix_T=True,
                  w_row_sum=1.0, project_W_each_iter=True)
    elif case == 'callbacks':
        kw.update(diagnostics=[frobenius], early_stop=frobenius,
                  update_order='phase', reset_topic_method=None)
    else:
        kw.update(w_row=np.linspace(0.5, 2.0, 40), update_order='phase',
                  reset_topic_method=None)
    got = pool.run('fit', mesh=(2, 2), X=X, kw=kw)
    want = torch_nmf(X, device='cpu', **kw)
    _same_fit(got, {k: _np(v) for k, v in want.items()}, RESET_TOL)
    assert got['n_resets_remaining'] == want['n_resets_remaining']
    if case == 'callbacks':
        assert np.allclose(got['diagnostics']['frobenius'],
                           want['diagnostics']['frobenius'], rtol=RESET_TOL)


@pytest.mark.parametrize('case', ['masked', 'sparse', 'sparse mask',
                                  'store_gradients', 'not a mesh'])
def test_deferred_mesh_options_raise(pool, case):
    """A mesh that is not a ``Mesh`` raises ``TypeError``. The masked
    (A.12c), sparse (A.12d), ``store_gradients`` (A.12g) and sparse-mask
    (A.12e) forms, which raised until they were ported, run: each (2, 1)
    fit equals the port's single-device fit at 1e-11
    (tests/test_torch_sharded_masked.py, test_torch_sparse_mesh.py,
    test_torch_masked_sparse_mesh.py and test_torch_masked_gram_mesh.py
    hold them against JAX)."""
    X = _lowrank(20, 15, 2)
    kw = dict(k=2, max_iter=1, update_order='phase', reset_topic_method=None)
    if case == 'not a mesh':
        with pytest.raises(TypeError, match='make_mesh'):
            torch_nmf(X, mesh=object(), device='cpu', **kw)
        return
    extra = {
        'masked': dict(W_mat=np.ones((20, 15))),
        'sparse': dict(sparse=True),
        'sparse mask': dict(W_mat=scipy.sparse.csr_matrix(np.ones((20, 15)))),
        'store_gradients': dict(store_gradients=True),
    }[case]
    kw = dict(kw, max_iter=3, random_state=0, compute_obj_each_iter=True,
              **extra)
    got = pool.run('fit', mesh=(2, 1), X=X, kw=kw)
    want = torch_nmf(X, device='cpu', **kw)
    _same_fit(got, {k: _np(v) for k, v in want.items()}, RESET_TOL)
    if case == 'store_gradients':
        for key in ('numer_W', 'denom_W'):
            for it, v in want[key].items():
                assert _close(got[key][it], _np(v), RESET_TOL)


def test_mesh_objective_calculator_does_not_pickle(pool):
    """(Named for the contract it replaced: a mesh calculator raised on
    pickling.) JAX's contract (``rri_nmf_tpu/nmf.py:229-317``): a mesh
    fit's calculator pickles without the mesh and the rank's blocks. A
    dense or dense-mask one (JAX host-gathers its X) evaluates the whole
    objective on one device after a load, equal to the fit's last
    objective; a sparse-X or sparse-mask one (no rank holds X whole)
    raises JAX's ``mesh-sharded`` ValueError."""
    X = _lowrank(20, 15, 2)
    M = (np.random.RandomState(3).rand(20, 15) < 0.6).astype(float)
    kw = dict(k=2, max_iter=3, update_order='phase', reset_topic_method=None,
              random_state=0, compute_obj_each_iter=True)
    for extra, evaluates in ((dict(), True), (dict(W_mat=M), True),
                             (dict(w_row=np.linspace(0.5, 2.0, 20)), True),
                             (dict(sparse=True), False),
                             (dict(W_mat=scipy.sparse.csr_matrix(M)), False)):
        got = pool.run('fit', mesh=(2, 1), X=X, kw=dict(kw, **extra),
                       pickled=True)
        if evaluates:
            # (a w_row fit's history ends with its refit's objectives)
            want = got['objective']
            assert got['pickled'] == pytest.approx(want, rel=1e-12), extra
        else:
            assert got['pickled'].startswith('ValueError') \
                and 'mesh-sharded' in got['pickled'], (extra, got['pickled'])


@pytest.mark.parametrize('sparse_obs', [False, True])
def test_mesh_estimator_pickles(pool, recsys_train, sparse_obs):
    """``NMF_RS_Estimator(nmf_kwargs=dict(mesh=...))`` fitted on a (2, 1)
    mesh pickles and loads back without the mesh (its process groups
    stay behind): the same factors and score, the fit's objective
    calculator evaluating (dense mask) or raising JAX's ``mesh-sharded``
    ValueError (sparse mask), as the calculator's contract says."""
    from rri_nmf_tpu_torch.sklearn_interface import NMF_RS_Estimator
    n, d = recsys_train.shape
    I, J = recsys_train.nonzero()
    pairs, ratings = np.stack([I, J], axis=1), recsys_train[I, J]
    kw = dict(random_state=0, max_iter=6, sparse_obs=sparse_obs,
              nmf_kwargs=dict(update_order='phase'))
    got = pool.run('rs_estimator', mesh=(2, 1), pairs=pairs,
                   ratings=ratings, shape=(n, d, 5), kw=kw)
    assert np.array_equal(got['loaded_W'], got['W'])
    assert np.array_equal(got['loaded_T'], got['T'])
    assert got['loaded_score'] == got['score']
    assert 'mesh' not in got['loaded_nmf_kwargs']
    if sparse_obs:
        assert got['loaded_objective'].startswith('ValueError') \
            and 'mesh-sharded' in got['loaded_objective']
    else:
        assert got['loaded_objective'] == pytest.approx(
            got['obj_history'][-1], rel=1e-10)
    one = NMF_RS_Estimator(n, d, 5, device='cpu', **kw).fit(pairs, ratings)
    assert np.allclose(got['W'], _np(one.W), rtol=0, atol=1e-11)
    assert got['score'] == pytest.approx(one.score(pairs, ratings),
                                         rel=1e-10)


def test_problem_shardings_are_jax_layouts():
    mesh = Mesh.__new__(Mesh)
    mesh.axis_names = ('dp', 'tp')
    X, W, T, M, v = problem_shardings(mesh, masked=True,
                                      w_row_sum_is_vector=True)
    assert (X, W, T, M, v) == (('dp', 'tp'), ('dp', None), (None, 'tp'),
                               ('dp', 'tp'), ('dp', None))
