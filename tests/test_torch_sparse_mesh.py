"""The port's sparse-X mesh (ROADMAP A.12d: ``rri_nmf_tpu_torch.parallel.
sparse_mesh``, each rank's block of nonzeros through ``torch.sparse.mm``
or the gather kernel, then B1/B2) against the JAX package, on the CPU in
float64.

The ranks are four processes of one gloo world
(``tests/torch_mesh_worker.py``, started once for the module); the
kernels run as their plain twins on the CPU, each call counted per rank.
JAX's references run here: its single-device sparse fits and objective.
Carried over: the nine tests of ``tests/test_sparse_mesh.py`` (JAX's
(8, 1) and (4, 2) meshes as (4, 1) and (2, 2) on four ranks), the mesh
cases of ``tests/test_sparse_mxu.py`` and the ``'dma'`` refusal of
``tests/test_sparse_dma.py``, at their tolerances: 1e-11 for the factors,
1e-9 for the objectives, 1e-12 grouped against per-sweep. JAX's
``'mxu'`` references are its BCOO fits (``sparse=True``, which
``test_sparse_mxu.py`` holds at 1e-11 of its ``'mxu'`` fit) rather than
the Pallas kernel in interpret mode. The plan-group mismatch
``ValueError`` of ``test_sharded_mxu_two_groups_no_stale_trace`` has no
counterpart: the port's plans have no chunk grouping, so its test holds
the plans of a scipy X and of the same X as a torch CSR tensor through
one mesh sweep. Also: a mesh whose first ranks hold no nonzero.
"""

import re

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp
from rri_nmf_tpu.nmf import nmf as jax_nmf
from rri_nmf_tpu.ops.sweep_sparse import make_sparse_objective, to_bcoo
from rri_nmf_tpu_torch.nmf import nmf as torch_nmf
from rri_nmf_tpu_torch.ops.sweep import SweepConfig
from rri_nmf_tpu_torch.parallel import Mesh, supports_sharded_sparse
from torch_mesh_worker import MeshPool

torch.set_num_threads(2)

TOL = 1e-11
OBJ_TOL = 1e-9
SAME_TOL = 1e-12


@pytest.fixture(scope='module')
def pool(tmp_path_factory):
    p = MeshPool(tmp_path_factory.mktemp('sparse_ranks'))
    yield p
    p.close()


def _sparse_problem(n=80, d=50, k=5, seed=0, density=0.15):
    rng = np.random.RandomState(seed)
    Xd = np.abs(rng.rand(n, k) @ rng.rand(k, d))
    Xd[rng.rand(n, d) >= density] = 0.0
    return sp.csr_matrix(Xd), Xd


def _close(a, b, tol=TOL):
    return np.allclose(np.asarray(a, float), np.asarray(b, float), rtol=0,
                       atol=tol)


def _np(a):
    return a.double().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _same_fit(got, want, tol=TOL, obj_tol=OBJ_TOL):
    assert _close(got['W'], want['W'], tol), \
        np.abs(got['W'] - np.asarray(want['W'])).max()
    assert _close(got['T'], want['T'], tol)
    if 'obj_history' in want:
        assert np.allclose(got['obj_history'], want['obj_history'], rtol=0,
                           atol=obj_tol)


def _port(X, **kw):
    return {k: (_np(v) if k in ('W', 'T') else v)
            for k, v in torch_nmf(X, device='cpu', **kw).items()}


def _mesh_of(shape):
    mesh = Mesh.__new__(Mesh)
    mesh.shape = tuple(shape)
    return mesh


# ---------------------------------------------------------------------------
# tests/test_sparse_mesh.py
# ---------------------------------------------------------------------------

def test_partition_coo_roundtrip_and_duplicates(pool):
    """Each rank's block in local indices; the blocks put back together
    are X with duplicate coordinates summed (scipy's COO semantics)."""
    rows = np.array([0, 0, 3, 7, 7])
    cols = np.array([1, 1, 2, 0, 0])
    vals = np.array([1.0, 2.0, 5.0, 3.0, -1.0])
    X = sp.coo_matrix((vals, (rows, cols)), shape=(9, 5))
    blocks = pool.run('partition', mesh=(2, 2), X=X)
    dense = np.zeros((9, 5))
    for b in blocks:
        r0, r1, c0, c1 = b['range']
        assert b['dense'].shape == (r1 - r0, c1 - c0)
        dense[r0:r1, c0:c1] += b['dense']
    assert np.array_equal(dense, X.toarray())
    # the (0, 0) and (7, 0) duplicates are one coordinate each
    assert sum(b['nnz'] for b in blocks) == 3


def test_sharded_sparse_matches_single_device_tm(pool):
    """The TM preset on a row-split (4, 1) mesh (B2 on each rank's whole
    rows) equals JAX's single-device sparse fit: factors 1e-11,
    objectives 1e-9, non-increasing."""
    X, _ = _sparse_problem()
    kw = dict(k=5, max_iter=6, init='nndsvd', random_state=0,
              early_stop=False, compute_obj_each_iter=True,
              update_order='phase', reset_topic_method=None,
              project_T_each_iter=True, t_row_sum=1.0,
              w_row_sum=1.0, project_W_each_iter=True, sparse=True)
    got = pool.run('fit', mesh=(4, 1), X=X, kw=kw)
    assert got['calls']['tm_proj_update'] == 6
    _same_fit(got, jax_nmf(X, **kw))
    _same_fit(got, _port(X, **kw), SAME_TOL)
    assert np.all(np.diff(got['obj_history']) <= 1e-12)


def test_sharded_sparse_2d_mesh_with_regs(pool):
    """A (2, 2) mesh, both axes summed, with L1/L2 regularizers."""
    X, _ = _sparse_problem(n=70, d=60, seed=1)
    kw = dict(k=5, max_iter=6, random_state=0, early_stop=False,
              compute_obj_each_iter=True, update_order='phase',
              reset_topic_method=None, reg_w_l1=0.01, reg_t_l2=0.05,
              sparse=True)
    got = pool.run('fit', mesh=(2, 2), X=X, kw=kw)
    _same_fit(got, jax_nmf(X, **kw))
    _same_fit(got, _port(X, **kw), SAME_TOL)


def test_sharded_sparse_vector_w_row_sum(pool):
    X, _ = _sparse_problem(n=64, d=40, seed=2)
    ws = 0.5 + np.arange(64) / 64.0
    kw = dict(k=4, max_iter=4, random_state=0, early_stop=False,
              update_order='phase', reset_topic_method=None,
              w_row_sum=ws, project_W_each_iter=True, sparse=True)
    got = pool.run('fit', mesh=(4, 1), X=X, kw=kw)
    _same_fit(got, jax_nmf(X, **kw))
    assert np.allclose(got['W'].sum(1), ws, atol=1e-8)


def test_sharded_sparse_grouped_dispatch(pool):
    X, _ = _sparse_problem(seed=3)
    kw = dict(k=5, max_iter=6, random_state=0, early_stop=False,
              compute_obj_each_iter=False, update_order='phase',
              reset_topic_method=None, sparse=True)
    a = pool.run('fit', mesh=(4, 1), X=X, kw=kw)
    b = pool.run('fit', mesh=(4, 1), X=X,
                 kw=dict(kw, sweeps_per_dispatch=3))
    assert _close(a['W'], b['W'], SAME_TOL)
    assert _close(a['T'], b['T'], SAME_TOL)


def test_sharded_sparse_objective_exact(pool):
    """The mesh objective (cross term on each block, Grams summed over
    their axes) against JAX's single-device sparse objective."""
    X, _ = _sparse_problem(seed=4)
    rng = np.random.RandomState(7)
    W = np.abs(rng.rand(80, 5))
    T = np.abs(rng.rand(5, 50))
    a = float(make_sparse_objective(0.1, 0.2, 0.05, 0.01)(
        to_bcoo(X), jnp.asarray(W), jnp.asarray(T)))
    b = pool.run('sparse_objective', mesh=(2, 2), X=X, W=W, T=T,
                 regs=dict(reg_w_l2=0.1, reg_t_l2=0.2, reg_w_l1=0.05,
                           reg_t_l1=0.01))
    assert abs(a - b) < 1e-9 * max(1.0, a)


def test_sharded_sparse_tp_gate(pool):
    """A T-row sum constraint needs tp == 1: a (2, 2) mesh refuses it
    with JAX's ValueError; a (4, 1) mesh takes it."""
    X, _ = _sparse_problem()
    cfg = SweepConfig(k=5, reset_topic_method=None, update_order='phase',
                      project_T_each_iter=True, t_row_sum=1.0)
    assert not supports_sharded_sparse(cfg, _mesh_of((2, 2)))
    assert supports_sharded_sparse(cfg, _mesh_of((4, 1)))
    msg = pool.run('refusal', mesh=(2, 2), X=X, kw=dict(
        k=5, sparse=True, update_order='phase', reset_topic_method=None,
        project_T_each_iter=True, t_row_sum=1.0, max_iter=2))
    assert msg.startswith('ValueError') and 'tp > 1' in msg, msg


def test_sharded_sparse_auto_engages(pool):
    """``sparse='auto'`` with sparse-viable settings on a mesh takes each
    rank's block of nonzeros (X is never densified) and equals JAX's
    dense single-device fit."""
    X, Xd = _sparse_problem(seed=5)
    kw = dict(k=5, max_iter=4, random_state=0, early_stop=False,
              update_order='phase', reset_topic_method=None)
    got = pool.run('fit', mesh=(4, 1), X=X, kw=kw)
    assert got['calls']['partition_coo'] == 1
    _same_fit(got, jax_nmf(Xd, **kw))


def test_sharded_sparse_fix_T_transform(pool):
    """The fixed-T transform (the estimators' path) on a sparse mesh."""
    X, _ = _sparse_problem(seed=6)
    rng = np.random.RandomState(1)
    T0 = np.abs(rng.rand(5, 50))
    kw = dict(k=5, T_in=T0.copy(), fix_T=True, max_iter=3,
              random_state=0, early_stop=False, sparse=True,
              update_order='phase', reset_topic_method=None)
    got = pool.run('fit', mesh=(4, 1), X=X, kw=kw)
    assert np.allclose(got['T'], np.maximum(T0, 0))
    _same_fit(got, jax_nmf(X, **kw))
    Xd = np.abs(np.random.RandomState(5).rand(40, 30))
    with pytest.raises(ValueError):
        torch_nmf(Xd, 4, sparse='mxu', device='cpu')     # dense input


# ---------------------------------------------------------------------------
# the gather kernel on each rank (tests/test_sparse_mxu.py,
# test_sparse_dma.py)
# ---------------------------------------------------------------------------

MXU_KW = dict(k=6, max_iter=3, random_state=0, early_stop=False,
              update_order='phase', reset_topic_method=None,
              compute_obj_each_iter=True, eps_stop=0)


def _mxu_problem(seed=6):
    rng = np.random.RandomState(seed)
    Xd = np.abs(rng.rand(300, 260))
    Xd[Xd < 0.8] = 0.0
    return sp.csr_matrix(Xd)


@pytest.mark.parametrize('mesh', [(4, 1), (2, 2), (1, 1)])
def test_sharded_mxu_matches_single_device(pool, mesh):
    """``sparse='mxu'`` on a mesh (each rank's plan, two gather calls a
    sweep) equals JAX's single-device sparse fit (factors 1e-11,
    objectives 1e-9) and the port's: bit for bit on one rank. On (2, 2)
    ``sparse=True`` gives the same fit."""
    Xs = _mxu_problem()
    got = pool.run('fit', mesh=mesh, X=Xs, kw=dict(MXU_KW, sparse='mxu'))
    assert got['calls']['gather_contract'] == 2 * 3
    assert got['calls']['partition_mxu'] == 1
    want = jax_nmf(Xs, sparse=True, **MXU_KW)
    _same_fit(got, want)
    mine = _port(Xs, sparse='mxu', **MXU_KW)
    if mesh == (1, 1):
        assert np.array_equal(got['W'], mine['W'])
        assert np.array_equal(got['T'], mine['T'])
        assert got['obj_history'] == mine['obj_history']
    _same_fit(got, mine, SAME_TOL)
    if mesh == (2, 2):
        coo = pool.run('fit', mesh=mesh, X=Xs, kw=dict(MXU_KW, sparse=True))
        _same_fit(coo, got, TOL)


def test_sharded_mxu_tm_preset_no_column_leak(pool):
    """The TM preset through the gather kernel on a (4, 1) mesh: the
    projection gives mass only to the true columns (T rows sum to
    t_row_sum) and the fit equals JAX's single-device fit at 1e-9."""
    rng = np.random.RandomState(11)
    Xd = 0.05 * np.abs(rng.rand(96, 80))
    Xd[Xd < 0.04] = 0.0
    Xs = sp.csr_matrix(Xd)
    kw = dict(k=4, max_iter=3, random_state=0, early_stop=False,
              update_order='phase', reset_topic_method=None,
              project_T_each_iter=True, t_row_sum=1.0, eps_stop=0)
    got = pool.run('fit', mesh=(4, 1), X=Xs, kw=dict(kw, sparse='mxu'))
    assert np.allclose(got['T'].sum(axis=1), 1.0, atol=1e-12)
    want = jax_nmf(Xs, sparse=True, **kw)
    assert _close(got['T'], want['T'], OBJ_TOL)
    assert _close(got['W'], want['W'], OBJ_TOL)


def test_sharded_sparse_bf16_contraction_accumulates_f32(pool):
    """bfloat16 factors on a sparse mesh: the products sum in float32, so
    the mesh fit stays within 0.03 of the largest entry of JAX's
    single-device bfloat16 fit."""
    rng = np.random.RandomState(12)
    Xd = np.abs(rng.rand(256, 96))
    Xd[Xd < 0.6] = 0.0
    Xs = sp.csr_matrix(Xd.astype(np.float32))
    kw = dict(k=4, max_iter=3, random_state=0, early_stop=False,
              update_order='phase', reset_topic_method=None, eps_stop=0)
    got = pool.run('fit', mesh=(4, 1), X=Xs,
                   kw=dict(kw, sparse=True, dtype=torch.bfloat16))
    assert got['dtype'] == 'torch.bfloat16'
    ref = np.asarray(jax_nmf(Xs, sparse=True, dtype='bfloat16', **kw)['W'],
                     np.float32)
    assert np.abs(got['W'] - ref).max() <= 0.03 * np.abs(ref).max()


@pytest.mark.parametrize('empty', ['half a block', 'whole blocks'])
def test_sharded_mxu_inner_reps_and_empty_blocks(pool, empty):
    """inner_reps through the gather kernel on (2, 2), with the first dp
    rows mostly empty, and with ranks whose blocks hold no nonzero at
    all (their products are zero): 1e-11 of JAX's single-device fit."""
    rng = np.random.RandomState(7)
    Xd = np.abs(rng.rand(200, 150))
    Xd[Xd < 0.85] = 0.0
    Xd[:50 if empty == 'half a block' else 100] = 0.0
    Xs = sp.csr_matrix(Xd)
    if empty == 'whole blocks':
        blocks = pool.run('partition', mesh=(2, 2), X=Xs, mxu=True)
        assert [b['nnz'] for b in blocks][:2] == [0, 0]
        assert all(b['nnz'] > 0 for b in blocks[2:])
        for b in blocks[:2]:
            assert not b['wtx'].any() and not b['xtt'].any()
    kw = dict(k=5, max_iter=3, random_state=0, early_stop=False,
              update_order='phase', reset_topic_method=None,
              inner_reps=2, eps_stop=0)
    got = pool.run('fit', mesh=(2, 2), X=Xs, kw=dict(kw, sparse='mxu'))
    _same_fit(got, jax_nmf(Xs, sparse=True, **kw))


def test_sharded_mxu_two_groups(pool):
    """The plans of a scipy X and of the same X as a torch CSR tensor
    through the same mesh sweep give the same sweep, and the COO blocks'
    sweep agrees."""
    rng = np.random.RandomState(9)
    Xd = np.abs(rng.rand(300, 260))
    Xd[Xd < 0.8] = 0.0
    Xs = sp.csr_matrix(Xd)
    cfg = dict(k=5, reset_topic_method=None, update_order='phase')
    W0 = np.abs(rng.rand(300, 5))
    T0 = np.abs(rng.rand(5, 260))
    outs = [pool.run('sparse_sweep', mesh=(2, 2), X=Xs, W=W0, T=T0, cfg=cfg,
                     backend='mxu', torch_x=t) for t in (False, True)]
    assert outs[0]['calls']['gather_contract'] == 2
    assert _close(outs[0]['W'], outs[1]['W'])
    assert _close(outs[0]['T'], outs[1]['T'])
    coo = pool.run('sparse_sweep', mesh=(2, 2), X=Xs, W=W0, T=T0, cfg=cfg,
                   backend='torch')
    assert coo['calls']['gather_contract'] == 0
    assert _close(coo['W'], outs[0]['W'])


def test_sparse_dma_refuses_a_mesh(pool):
    """``sparse='dma'`` is single-device: with a mesh it raises JAX's
    ValueError, naming ``'mxu'``."""
    Xd = np.abs(np.random.RandomState(5).rand(40, 30))
    msg = pool.run('refusal', mesh=(4, 1), X=sp.csr_matrix(Xd),
                   kw=dict(k=4, sparse='dma'))
    assert msg is not None and re.match(
        r"ValueError: sparse='dma' is single-device.*'mxu'", msg), msg
