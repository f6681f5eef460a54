"""The port's sparse-mask O(nnz) mesh sweep (ROADMAP A.12e:
``rri_nmf_tpu_torch.parallel.masked_sparse_mesh``, each rank's row block
of observations, one (2, d) all-reduce a topic) against the JAX package,
on the CPU in float64.

The ranks are four processes of one gloo world
(``tests/torch_mesh_worker.py``, started once for the module). JAX's
references are its single-device fits, run here. Carried over from
``tests/test_masked_sparse.py``: ``test_mesh_parity_row_sharded`` (n=83:
uneven blocks), ``test_mesh_parity_projected_transfer`` and
``test_mesh_guards``, at JAX's tolerances (1e-10 for the factors, 1e-9
relative for the objectives), JAX's (8, 1) mesh as (4, 1) and (2, 1) on
four ranks; and the mesh half of
``test_plan_padding_preserves_sorted_rows`` (each rank's row stream
sorted, its padding weightless). JAX's ghost rows have no counterpart:
the port's blocks are uneven. Added: a (1, 1) mesh bit for bit the
single-device sweep and fit, the DP noise the same on every rank, and a
rank whose block holds no observation.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from rri_nmf_tpu.nmf import nmf as jax_nmf
from rri_nmf_tpu_torch.nmf import nmf as torch_nmf
from rri_nmf_tpu_torch.ops.sweep import SweepConfig
from rri_nmf_tpu_torch.parallel import Mesh, supports_sharded_masked_sparse
from torch_mesh_worker import MeshPool

torch.set_num_threads(2)

TOL = 1e-10
OBJ_RTOL = 1e-9


@pytest.fixture(scope='module')
def pool(tmp_path_factory):
    p = MeshPool(tmp_path_factory.mktemp('masked_sparse_ranks'))
    yield p
    p.close()


def _problem(seed, n=30, d=24, density=0.35):
    rng = np.random.RandomState(seed)
    M = (rng.rand(n, d) < density).astype(float)
    X = rng.rand(n, d) * M
    return X, M


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _same_fit(got, want, tol=TOL, obj_rtol=OBJ_RTOL):
    assert np.allclose(got['W'], _np(want['W']), rtol=0, atol=tol), \
        np.abs(got['W'] - _np(want['W'])).max()
    assert np.allclose(got['T'], _np(want['T']), rtol=0, atol=tol)
    if 'obj_history' in want:
        assert np.allclose(got['obj_history'], want['obj_history'],
                           rtol=obj_rtol, atol=0)


# ---------------------------------------------------------------------------
# tests/test_masked_sparse.py, the mesh tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('mesh', [(4, 1), (2, 1)])
def test_mesh_parity_row_sharded(pool, mesh):
    """The O(nnz) sweep on a row-split mesh equals JAX's single-device
    fit, with n = 83 not divisible by the mesh (uneven blocks); one
    partition and no gather launch on each rank."""
    X, M = _problem(0, n=83, d=40)
    Ms = sp.csr_matrix(M)
    common = dict(max_iter=8, compute_obj_each_iter=True,
                  reset_topic_method=None, reg_w_l1=0.01, reg_t_l1=0.01,
                  t_row_sum=1.0, random_state=0)
    want = jax_nmf(X, 5, W_mat=Ms, **common)
    got = pool.run('fit', mesh=mesh, X=X, kw=dict(k=5, W_mat=Ms, **common))
    _same_fit(got, want)
    assert got['calls']['partition_masked_coo'] == 1
    assert got['calls']['gather_contract'] == 0
    assert any('uneven blocks' in w for w in got['warnings'])


@pytest.mark.parametrize('mesh', [(4, 1), (2, 1)])
def test_mesh_parity_projected_transfer(pool, mesh):
    """Simplex projections and the scale transfer on the mesh (divisible
    n) equal JAX's single-device fit."""
    X, M = _problem(1, n=80, d=40)
    Ms = sp.csr_matrix(M)
    common = dict(max_iter=6, compute_obj_each_iter=True,
                  reset_topic_method=None, project_T_each_iter=True,
                  t_row_sum=1.0, w_row_sum=1.0, project_W_each_iter=True,
                  random_state=1)
    want = jax_nmf(X, 5, W_mat=Ms, **common)
    got = pool.run('fit', mesh=mesh, X=X, kw=dict(k=5, W_mat=Ms, **common))
    _same_fit(got, want)


@pytest.mark.parametrize('case', ['row blocks', 'random', 'per-row'])
def test_mesh_guards(pool, case):
    """JAX's ValueErrors: a (2, 2) mesh, a 'random' reset, a per-row
    ``w_row_sum`` vector."""
    X, M = _problem(2)
    kw = dict(k=4, W_mat=sp.csr_matrix(M), max_iter=1)
    mesh = (4, 1)
    if case == 'row blocks':
        mesh = (2, 2)
    elif case == 'random':
        kw['reset_topic_method'] = 'random'
    else:
        kw.update(w_row_sum=np.ones(30), project_W_each_iter=True)
    msg = pool.run('refusal', mesh=mesh, X=X, kw=kw)
    assert msg is not None and msg.startswith('ValueError') and case in msg


def test_mesh_partition_preserves_sorted_rows(pool):
    """Every rank's plan (tests/test_masked_sparse.py
    ``test_plan_padding_preserves_sorted_rows``, the mesh half): its local
    row stream non-decreasing, its padding weightless, and the blocks
    together the observed set, each rank's ``Σ m x²`` its own."""
    X, M = _problem(29, n=23, d=9, density=0.4)
    blocks = pool.run('masked_partition', mesh=(4, 1), X=X,
                      M=sp.csr_matrix(M))
    Mr, Xr = np.zeros_like(M), np.zeros_like(X)
    for b in blocks:
        r0, r1 = b['range']
        rows, cols, x, m = b['arrays']
        assert b['shape'] == (r1 - r0, 9)
        assert np.all(np.diff(rows) >= 0), 'a block is not sorted'
        assert not m[b['nnz']:].any() and not x[b['nnz']:].any()
        nz = b['nnz']
        Mr[rows[:nz] + r0, cols[:nz]] = m[:nz]
        Xr[rows[:nz] + r0, cols[:nz]] = x[:nz]
        assert b['sum_mx2'] == pytest.approx(
            float((M[r0:r1] * X[r0:r1] ** 2).sum()), rel=1e-14)
    assert np.array_equal(Mr, M) and np.array_equal(Xr, X * M)
    assert sum(b['nnz'] for b in blocks) == int(M.sum())


# ---------------------------------------------------------------------------
# added: the one-rank mesh, the DP noise, an empty block, the gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('case', ['sweep', 'nmf'])
def test_one_rank_mesh_is_the_single_device_sweep(pool, case):
    """A (1, 1) mesh makes no collective: three sweeps, and a fit with
    its objectives, bit for bit the single-device ones in the same
    process."""
    X, M = _problem(3, n=40, d=28)
    Ms = sp.csr_matrix(M)
    if case == 'sweep':
        rng = np.random.RandomState(4)
        got = pool.run('masked_mesh_sweep', mesh=(1, 1), X=X, M=Ms,
                       W=rng.rand(40, 4), T=rng.rand(4, 28), gram=False,
                       cfg=dict(k=4, masked=True, masked_sparse=True,
                                reset_topic_method=None, t_row_sum=1.0),
                       sweeps=3, single=True)
        for (Wm, Tm), (Ws, Ts) in zip(got['steps'], got['single']):
            assert np.array_equal(Wm, Ws) and np.array_equal(Tm, Ts)
        return
    got = pool.run('fit', mesh=(1, 1), X=X, single=True, kw=dict(
        k=4, W_mat=Ms, max_iter=4, compute_obj_each_iter=True,
        random_state=0, reg_w_l2=0.02))
    one = got['single']
    assert np.array_equal(got['W'], one['W'])
    assert np.array_equal(got['T'], one['T'])
    assert got['obj_history'] == one['obj_history']


def test_mesh_dp_noise_same_on_every_rank(pool):
    """DP noise on a (4, 1) mesh: every rank draws the same numbers from
    the first rank's seed, so every rank ends with the same T, and the
    fit equals the port's single-device DP fit (whose draws are the
    same)."""
    X, M = _problem(6, n=32, d=20)
    kw = dict(k=3, W_mat=sp.csr_matrix(M), max_iter=4, random_state=0,
              reset_topic_method=None, eps_gauss_t=1e4, delta_gauss_t=0.1)
    got = pool.run('fit', mesh=(4, 1), X=X, kw=kw, every_rank=True)
    for T in got['every_T']:
        assert np.array_equal(T, got['T'])
    want = torch_nmf(X, device='cpu', **kw)
    _same_fit(got, want)


def test_mesh_rank_without_observations(pool):
    """A rank whose row block holds no observation adds zero sums (and
    its W rows, with no observation, stay as the single-device fit
    leaves them): the (4, 1) fit equals JAX's single-device fit."""
    X, M = _problem(7, n=40, d=24, density=0.4)
    M[10:20] = 0.0
    X[10:20] = 0.0
    Ms = sp.csr_matrix(M)
    common = dict(max_iter=5, compute_obj_each_iter=True,
                  reset_topic_method=None, reg_t_l1=0.01, random_state=0)
    want = jax_nmf(X, 4, W_mat=Ms, **common)
    got = pool.run('fit', mesh=(4, 1), X=X, kw=dict(k=4, W_mat=Ms,
                                                    **common))
    _same_fit(got, want)


def test_supports_sharded_masked_sparse_gate():
    """JAX's gate: the single-device O(nnz) gate, no resets, no per-row
    ``w_row_sum`` vector, ``tp == 1``."""
    def mesh(shape):
        m = Mesh.__new__(Mesh)
        m.shape = shape
        return m
    base = dict(k=3, masked=True, masked_sparse=True,
                reset_topic_method=None)
    assert supports_sharded_masked_sparse(SweepConfig(**base), mesh((4, 1)))
    assert not supports_sharded_masked_sparse(SweepConfig(**base),
                                              mesh((2, 2)))
    for extra in (dict(reset_topic_method='random'),
                  dict(w_row_sum_is_vector=True),
                  dict(update_order='phase')):
        assert not supports_sharded_masked_sparse(
            SweepConfig(**dict(base, **extra)), mesh((4, 1)))
