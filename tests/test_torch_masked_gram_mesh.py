"""The port's Gram-phase sparse-mask mesh sweep (ROADMAP A.12e:
``rri_nmf_tpu_torch.parallel.masked_gram_mesh``, each rank's row block
through the gather kernel, one all-reduce a T-phase) against the JAX
package, on the CPU in float64.

The ranks are four processes of one gloo world
(``tests/torch_mesh_worker.py``, started once for the module); the
gather kernel runs as its plain twin there, each call counted per rank.
JAX's references are its single-device Gram sweeps and fits, run here.
Carried over: the 13 tests of ``tests/test_masked_gram_mesh.py`` at their
tolerances (1e-12 against single-device, 1e-13 panels against full
tensors, 1e-9 ``'mxu'`` against ``'segsum'``, 1e-11 and 1e-9 for the
driver), JAX's (8, 1) mesh as (4, 1) on four ranks (n = 30 on four ranks
splits 8, 8, 7, 7). ``test_mesh_mxu_segmented_and_padded_plans`` tests
JAX's padding of per-device chunk plans to one group count, which the
port does not do (each rank launches on its own plan); its replacement,
``test_mesh_mxu_uneven_plans``, shows that plans of very different sizes
give the same fit and objective. The fuzz prefix's pre-built-plan draws
(A.12f) run the driver on the whole X instead. DP noise is held against
the port's own single-device fit (torch draws other numbers than
``jax.random``). Added: a (1, 1) mesh bit for bit the single-device
sweep, and the gate.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rri_nmf_tpu.ops.sweep_masked_gram as jmg
from rri_nmf_tpu.nmf import nmf as jax_nmf
from rri_nmf_tpu.ops.sweep_xla import SweepConfig as JaxSweepConfig
from rri_nmf_tpu_torch.nmf import nmf as torch_nmf
from rri_nmf_tpu_torch.ops.sweep import SweepConfig
from rri_nmf_tpu_torch.parallel import Mesh, supports_sharded_masked_gram
from torch_mesh_worker import MeshPool

torch.set_num_threads(2)

MESH = (4, 1)


@pytest.fixture(scope='module')
def pool(tmp_path_factory):
    p = MeshPool(tmp_path_factory.mktemp('masked_gram_ranks'))
    yield p
    p.close()


def _problem(seed, n=30, d=24, k=4, density=0.35):
    rng = np.random.RandomState(seed)
    M = (rng.rand(n, d) < density).astype(float)
    X = rng.rand(n, d) * M
    W0 = np.abs(rng.rand(n, k))
    T0 = np.abs(rng.rand(k, d))
    return X, M, W0, T0


def _cfg(k, **kw):
    return dict(k=k, masked=True, masked_sparse=True, update_order='phase',
                reset_topic_method=None, **kw)


def _run_single(X, M, W0, T0, sweeps, **kw):
    """JAX's single-device Gram sweep (segsum), factors after each."""
    plan = jmg.plan_masked_gram(X, sp.csr_matrix(M), np.float64,
                                backend='segsum')
    sweep = jmg.make_masked_gram_sweep(
        JaxSweepConfig(**_cfg(W0.shape[1], **kw)), backend='segsum')
    key = jax.random.PRNGKey(0)
    r = jnp.asarray(0, jnp.int32)
    W, T = jnp.asarray(W0), jnp.asarray(T0)
    out = []
    for _ in range(sweeps):
        W, T, key, r = sweep(plan, W, T, key, r, key)
        out.append((np.array(W), np.array(T)))
    return out


def _run_mesh(pool, X, M, W0, T0, sweeps, mesh=MESH, backend='segsum',
              panel=None, **kw):
    """The port's mesh sweep: the whole factors after each sweep."""
    return pool.run('masked_mesh_sweep', mesh=mesh, X=X,
                    M=sp.csr_matrix(M), W=W0, T=T0,
                    cfg=_cfg(W0.shape[1], **kw), sweeps=sweeps,
                    backend=backend, panel=panel)['steps']


def _same(got, want, tol):
    assert len(got) == len(want)
    for (W1, T1), (W2, T2) in zip(got, want):
        assert np.allclose(W1, W2, rtol=0, atol=tol), np.abs(W1 - W2).max()
        assert np.allclose(T1, T2, rtol=0, atol=tol), np.abs(T1 - T2).max()


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


MESH_CONFIGS = [
    dict(),
    dict(project_T_each_iter=True, t_row_sum=1.0),
    dict(reg_t_l2=0.1, reg_w_l2=0.05),
    dict(reg_t_l1=0.02, reg_w_l1=0.01),
    dict(project_T_each_iter=True, t_row_sum=1.0, w_row_sum=1.0,
         project_W_each_iter=True),
    dict(inner_reps=2),
    dict(fix_T=True),
    dict(fix_W=True),
]


# ---------------------------------------------------------------------------
# tests/test_masked_gram_mesh.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('kw', MESH_CONFIGS)
def test_mesh_matches_single_device(pool, kw):
    """(4, 1) mesh sweep == JAX's single-device Gram sweep at float64
    roundoff; n = 30 splits unevenly over 4 ranks."""
    X, M, W0, T0 = _problem(1)
    _same(_run_mesh(pool, X, M, W0, T0, 3, **kw),
          _run_single(X, M, W0, T0, 3, **kw), 1e-12)


def test_mesh_mxu_backend_matches_segsum(pool):
    """Each rank's gather-kernel plans (the twin on the CPU) == the
    segsum mesh backend; 2 gather (A, C) and 2 Gram (Γ, Θ) launches a
    sweep on every rank."""
    X, M, W0, T0 = _problem(7, n=40, d=33, k=5)
    kw = dict(project_T_each_iter=True, t_row_sum=1.0, w_row_sum=1.0,
              project_W_each_iter=True)
    t1 = _run_mesh(pool, X, M, W0, T0, 2, backend='segsum', **kw)
    got = pool.run('masked_mesh_sweep', mesh=MESH, X=X, M=sp.csr_matrix(M),
                   W=W0, T=T0, cfg=_cfg(5, **kw), sweeps=2, backend='mxu')
    _same(got['steps'], t1, 1e-9)
    assert got['calls']['gather_contract'] == 2 * 2
    assert got['calls']['gram_contract'] == 2 * 2


def test_mesh_mxu_uneven_plans(pool):
    """Row blocks of very different nnz (density 0.05-0.7 down the rows)
    give each rank a plan of its own size, unpadded: the mesh's
    gather-kernel sweep equals JAX's single-device sweep, and the mesh
    objective the direct one. (Replaces JAX's padded-plan test: no plan
    is padded to another's size here.)"""
    rng = np.random.RandomState(12)
    n, d, k = 300, 200, 4
    dens = np.linspace(0.05, 0.7, n)[:, None]
    M = (rng.rand(n, d) < dens).astype(float)
    X = rng.rand(n, d) * M
    W0 = np.abs(rng.rand(n, k))
    T0 = np.abs(rng.rand(k, d))
    blocks = pool.run('masked_partition', mesh=MESH, X=X,
                      M=sp.csr_matrix(M))
    nnz = [b['nnz'] for b in blocks]
    assert max(nnz) > 4 * min(nnz)
    got = _run_mesh(pool, X, M, W0, T0, 1, backend='mxu')
    _same(got, _run_single(X, M, W0, T0, 1), 1e-9)
    W, T = got[0]
    obj = pool.run('masked_mesh_objective', mesh=MESH, X=X,
                   M=sp.csr_matrix(M), W=W, T=T, regs={}, backend='mxu')
    direct = 0.5 * np.sum(M * (X - W @ T) ** 2)
    assert obj == pytest.approx(direct, rel=1e-9)


def test_mesh_objective_identity_with_regs(pool):
    X, M, W0, T0 = _problem(9)
    regs = dict(reg_w_l2=0.02, reg_t_l2=0.01, reg_w_l1=0.005,
                reg_t_l1=0.003)
    got = pool.run('masked_mesh_objective', mesh=MESH, X=X,
                   M=sp.csr_matrix(M), W=W0, T=T0, regs=regs)
    direct = (0.5 * np.sum(M * (X - W0 @ T0) ** 2)
              + 0.5 * regs['reg_w_l2'] * np.sum(W0 ** 2)
              + 0.5 * regs['reg_t_l2'] * np.sum(T0 ** 2)
              + regs['reg_w_l1'] * np.abs(W0).sum()
              + regs['reg_t_l1'] * np.abs(T0).sum())
    assert got == pytest.approx(direct, rel=1e-12)


def test_driver_mesh_gram_end_to_end(pool):
    """nmf() routes a masked phase fit on a (4, 1) mesh through the Gram
    mesh sweep: parity with JAX's single-device Gram fit, monotone
    descent, a working (mesh-backed) objective calculator; after a
    pickle round trip it raises JAX's ``mesh-sharded`` ValueError."""
    X, M, _, _ = _problem(3, n=44, d=30, k=4)
    Ms = sp.csr_matrix(M)
    kw = dict(max_iter=8, compute_obj_each_iter=True, random_state=0,
              reset_topic_method=None, reg_t_l1=0.01, reg_w_l1=0.01,
              update_order='phase')
    single = jax_nmf(X, 4, W_mat=Ms, **kw)
    got = pool.run('fit', mesh=MESH, X=X, kw=dict(k=4, W_mat=Ms, **kw),
                   pickled=True)
    assert np.allclose(got['W'], single['W'], rtol=0, atol=1e-11)
    assert np.allclose(got['T'], single['T'], rtol=0, atol=1e-11)
    assert np.allclose(got['obj_history'], single['obj_history'], rtol=0,
                       atol=1e-9)
    assert np.all(np.diff(got['obj_history']) <= 1e-12)
    assert abs(got['objective'] - got['obj_history'][-1]) < 1e-10
    assert got['pickled'].startswith('ValueError') \
        and 'mesh-sharded' in got['pickled']
    assert got['calls']['partition_masked_gram'] == 1


def test_driver_mesh_gram_tm_preset(pool):
    """The projected TM-style preset on the mesh == JAX single-device."""
    X, M, _, _ = _problem(5, n=40, d=28, k=3)
    Ms = sp.csr_matrix(M)
    kw = dict(max_iter=6, compute_obj_each_iter=True, random_state=0,
              reset_topic_method=None, update_order='phase',
              project_T_each_iter=True, t_row_sum=1.0,
              w_row_sum=1.0, project_W_each_iter=True)
    single = jax_nmf(X, 3, W_mat=Ms, **kw)
    got = pool.run('fit', mesh=MESH, X=X, kw=dict(k=3, W_mat=Ms, **kw))
    assert np.allclose(got['W'], single['W'], rtol=0, atol=1e-11)
    assert np.allclose(got['T'], single['T'], rtol=0, atol=1e-11)
    assert np.allclose(got['T'].sum(axis=1), 1.0, rtol=0, atol=1e-12)


def test_driver_mesh_gram_dp_noise_reproducible(pool):
    """The DP Gaussian mechanism runs the same on every rank (one seed):
    reproducible for a fixed random_state, every rank's T the same, and
    equal to the port's single-device Gram DP fit."""
    X, M, _, _ = _problem(6, n=32, d=20, k=3)
    kw = dict(k=3, W_mat=sp.csr_matrix(M), max_iter=4, random_state=0,
              reset_topic_method=None, update_order='phase',
              eps_gauss_t=1e4, delta_gauss_t=0.1)
    r1 = pool.run('fit', mesh=MESH, X=X, kw=kw, every_rank=True)
    r2 = pool.run('fit', mesh=MESH, X=X, kw=kw)
    assert np.array_equal(r1['W'], r2['W'])
    assert all(np.array_equal(T, r1['T']) for T in r1['every_T'])
    single = torch_nmf(X, device='cpu', **kw)
    assert np.allclose(r1['W'], _np(single['W']), rtol=0, atol=1e-11)
    assert np.allclose(r1['T'], _np(single['T']), rtol=0, atol=1e-11)


def test_driver_mesh_gram_fix_T_transform(pool):
    """fix_T (transform) on the mesh: T untouched, W equal to JAX's
    single-device transform; the W-phase makes no collective."""
    X, M, _, _ = _problem(8, n=36, d=22, k=3)
    Ms = sp.csr_matrix(M)
    T_fixed = np.abs(np.random.RandomState(0).rand(3, 22))
    kw = dict(max_iter=4, random_state=0, reset_topic_method=None,
              update_order='phase', fix_T=True, T_in=T_fixed,
              W_in=np.full((36, 3), 1.0 / 3))
    single = jax_nmf(X, 3, W_mat=Ms, **kw)
    got = pool.run('fit', mesh=MESH, X=X, kw=dict(k=3, W_mat=Ms, **kw))
    assert np.array_equal(got['T'], T_fixed)
    assert np.allclose(got['W'], single['W'], rtol=0, atol=1e-11)


def _fuzz_draw(pool, seed):
    """JAX's ``masked_gram_mesh_draw(seed)``, its random stream replayed:
    random shapes, config and backend, 2 sweeps of the mesh sweep against
    JAX's single-device sweep at 1e-10; the draws that take JAX's
    pre-built-plan entry (ROADMAP A.12f) run the port's driver with the
    whole X against JAX's single-device fit instead."""
    rng = np.random.RandomState(1000 + seed)
    n = int(rng.randint(17, 61))
    d = int(rng.randint(12, 48))
    k = int(rng.randint(2, 7))
    X, M, W0, T0 = _problem(2000 + seed, n=n, d=d, k=k,
                            density=float(rng.uniform(0.2, 0.6)))
    kw = {}
    if rng.rand() < 0.5:
        kw['project_T_each_iter'] = True
        kw['t_row_sum'] = float(rng.choice([1.0, 2.0]))
    if rng.rand() < 0.4:
        kw['w_row_sum'] = float(rng.choice([1.0, 3.0]))
        kw['project_W_each_iter'] = rng.rand() < 0.5
    for r in ('reg_w_l1', 'reg_w_l2', 'reg_t_l1', 'reg_t_l2'):
        if rng.rand() < 0.3:
            kw[r] = float(rng.choice([0.01, 0.1]))
    if rng.rand() < 0.25:
        kw['inner_reps'] = int(rng.randint(2, 4))
    if rng.rand() < 0.15:
        kw['fix_T'] = True
    backend = 'mxu' if (rng.rand() < 0.2 and n * d <= 1200) else 'segsum'
    if rng.rand() < 0.3:
        n -= n % 8
        X, M, W0 = X[:n], M[:n], W0[:n]
        dkw = dict(max_iter=3, random_state=seed, compute_obj_each_iter=True,
                   reset_topic_method=None, update_order='phase', W_in=W0,
                   T_in=T0, **{kk: v for kk, v in kw.items()
                               if kk != 'fix_T'})
        Ms = sp.csr_matrix(M)
        want = jax_nmf(X, k, W_mat=Ms, **dkw)
        got = pool.run('fit', mesh=MESH, X=X, kw=dict(k=k, W_mat=Ms, **dkw))
        _same([(got['W'], got['T'])], [(want['W'], want['T'])], 1e-10)
        return 'driver'
    _same(_run_mesh(pool, X, M, W0, T0, 2, backend=backend, **kw),
          _run_single(X, M, W0, T0, 2, **kw), 1e-10)
    return backend


@pytest.mark.parametrize('seed', range(4))
def test_masked_gram_mesh_fuzz_prefix(pool, seed):
    """The suite's prefix of JAX's soak draw range."""
    assert _fuzz_draw(pool, seed) in ('driver', 'mxu', 'segsum')


@functools.lru_cache(maxsize=None)
def _panel_reference(kw_items):
    X, M, W0, T0 = _problem(31, k=4)
    return _run_single(X, M, W0, T0, 2, **dict(kw_items))


@pytest.mark.parametrize('panel', [1, 3])
@pytest.mark.parametrize('kw', [
    dict(),
    dict(project_T_each_iter=True, t_row_sum=1.0, w_row_sum=1.0,
         project_W_each_iter=True),
    dict(inner_reps=2),
    dict(fix_T=True),
])
def test_mesh_panel_bitwise_equals_full(pool, panel, kw):
    """Mesh panel tiling == mesh full tensors == JAX single-device at
    float64 roundoff (the same Gauss-Seidel sequence; one all-reduce of
    A, then one per Γ panel)."""
    X, M, W0, T0 = _problem(31, k=4)
    full = _run_mesh(pool, X, M, W0, T0, 2, **kw)
    tiled = _run_mesh(pool, X, M, W0, T0, 2, panel=panel, **kw)
    _same(tiled, full, 1e-13)
    _same(tiled, _panel_reference(tuple(sorted(kw.items()))), 1e-12)


def test_mesh_panel_mxu_backend(pool):
    X, M, W0, T0 = _problem(32, n=40, d=33, k=5)
    t1 = _run_mesh(pool, X, M, W0, T0, 2, panel=2, backend='segsum')
    t2 = _run_mesh(pool, X, M, W0, T0, 2, panel=2, backend='mxu')
    _same(t2, t1, 1e-9)


def test_driver_mesh_routes_large_k_to_panels(pool):
    """A mesh masked phase fit whose full Gram tensors pass the budget
    takes the panel-tiled mesh sweep and matches the full-tensor mesh
    fit. The panel comes from ``auto_panel(k, n / dp, d, ·)``: with a
    budget of two (k, n / dp + d) units it is 2 (the whole n would give
    1), read from the Gram launches of the ``'mxu'`` hint (2·2 a sweep,
    2 an objective; the gather kernel's A and C, 3 either way)."""
    X, M, _, _ = _problem(33, n=40, d=30, k=4)
    kw = dict(k=4, W_mat=sp.csr_matrix(M), max_iter=5,
              compute_obj_each_iter=True, random_state=0,
              reset_topic_method=None, update_order='phase',
              reg_t_l1=0.01, sparse='mxu')
    r_full = pool.run('fit', mesh=MESH, X=X, kw=kw)
    unit = 4 * (40 / MESH[0] + 30) * 8
    r_tiled = pool.run('fit', mesh=MESH, X=X, kw=kw, gram_budget=2 * unit)
    assert np.allclose(r_tiled['W'], r_full['W'], rtol=0, atol=1e-13)
    assert np.allclose(r_tiled['T'], r_full['T'], rtol=0, atol=1e-13)
    assert np.all(np.diff(r_tiled['obj_history']) <= 1e-12)
    for r, gram in ((r_full, 3), (r_tiled, 6)):
        assert r['calls']['gather_contract'] == 3 * len(r['obj_history'])
        assert r['calls']['gram_contract'] == gram * len(r['obj_history'])


@pytest.mark.parametrize('backend', ['segsum', 'mxu'])
def test_mesh_panel_objective_matches_full(pool, backend):
    X, M, W0, T0 = _problem(34, k=5)
    regs = dict(reg_w_l2=0.02, reg_t_l1=0.003)
    args = dict(mesh=MESH, X=X, M=sp.csr_matrix(M), W=W0, T=T0, regs=regs,
                backend=backend)
    full = pool.run('masked_mesh_objective', **args)
    tiled = pool.run('masked_mesh_objective', panel=2, **args)
    assert tiled == pytest.approx(full, rel=1e-12)


# ---------------------------------------------------------------------------
# added: the one-rank mesh, the gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('panel', [None, 2])
def test_one_rank_mesh_is_the_single_device_sweep(pool, panel):
    """A (1, 1) mesh makes no collective: the gather-kernel sweep (full
    tensors and panels) bit for bit the single-device one in the same
    process, with the same 2 gather and 2 Gram launches a sweep full."""
    X, M, W0, T0 = _problem(35, n=40, d=30, k=5)
    got = pool.run('masked_mesh_sweep', mesh=(1, 1), X=X,
                   M=sp.csr_matrix(M), W=W0, T=T0,
                   cfg=_cfg(5, reg_t_l1=0.01), sweeps=2, backend='mxu',
                   panel=panel, single=True)
    for (Wm, Tm), (Ws, Ts) in zip(got['steps'], got['single']):
        assert np.array_equal(Wm, Ws) and np.array_equal(Tm, Ts)
    if panel is None:
        assert got['calls']['gather_contract'] == 2 * 2
        assert got['calls']['gram_contract'] == 2 * 2


def test_supports_sharded_masked_gram_gate():
    """JAX's gate: the single-device Gram gate, no per-row ``w_row_sum``
    vector, ``tp == 1``."""
    def mesh(shape):
        m = Mesh.__new__(Mesh)
        m.shape = shape
        return m
    base = _cfg(3)
    assert supports_sharded_masked_gram(SweepConfig(**base), mesh((4, 1)))
    assert not supports_sharded_masked_gram(SweepConfig(**base),
                                            mesh((2, 2)))
    for extra in (dict(w_row_sum_is_vector=True),
                  dict(update_order='interleaved'),
                  dict(reset_topic_method='random')):
        assert not supports_sharded_masked_gram(
            SweepConfig(**dict(base, **extra)), mesh((4, 1)))
