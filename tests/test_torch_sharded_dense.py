"""The port's second mesh slice (ROADMAP A.12b: ``rri_nmf_tpu_torch.
parallel.sharded_dense``, the dense phase sweep with kernels B1 and B2 on
each rank's block) against the JAX package, on the CPU in float64.

The ranks are four processes of one gloo world
(``tests/torch_mesh_worker.py``, started once for the module); the
kernels run as their plain twins on the CPU. JAX's references run here:
its single-chip dense kernel sweep and ``nmf(use_pallas='interpret')``,
its mesh kernel sweep at the same mesh shape, and its GSPMD fit. Carried
over: all nine tests of ``tests/test_sharded_dense.py`` (1e-11; 1e-10
under negative L1) and the mesh cases of ``test_quantized.py`` (1e-10 the
sweep, 1e-6 relative the fit's objective, 1e-8 unaligned),
``test_bfloat16.py`` (1e-5), ``test_phase_order.py`` (1e-12) and
``test_inner_reps.py`` (1e-11, its sparse X densified: the sparse mesh is
A.12d). B1's and B2's calls per rank are counted on each mesh.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse
import torch

import jax
import jax.numpy as jnp
from rri_nmf_tpu.nmf import nmf as jax_nmf
from rri_nmf_tpu.ops.dense_pallas import make_dense_phase_sweep_pallas
from rri_nmf_tpu.ops.quantized import quantize_x as jax_quantize_x
from rri_nmf_tpu.ops.sweep_xla import SweepConfig as JaxSweepConfig
from rri_nmf_tpu.ops.sweep_xla import make_sweep as jax_make_sweep
from rri_nmf_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rri_nmf_tpu.parallel.sharded_dense import \
    make_sharded_dense_sweep_pallas
from rri_nmf_tpu_torch.nmf import nmf as torch_nmf
from rri_nmf_tpu_torch.ops import dense_kernels as dk
from rri_nmf_tpu_torch.ops.sweep import SweepConfig
from rri_nmf_tpu_torch.parallel import supports_sharded_dense
from torch_mesh_worker import MeshPool

torch.set_num_threads(2)

TOL = 1e-11


@pytest.fixture(scope='module')
def pool(tmp_path_factory):
    p = MeshPool(tmp_path_factory.mktemp('dense_ranks'))
    yield p
    p.close()


def _problem(n=100, d=80, k=6, seed=0):
    rng = np.random.RandomState(seed)
    return (np.abs(rng.rand(n, d)), np.abs(rng.rand(n, k)),
            np.abs(rng.rand(k, d)))


def _close(a, b, tol=TOL):
    return np.allclose(np.asarray(a, float), np.asarray(b, float), rtol=0,
                       atol=tol)


def _jax_run(sweep, X, W, T, *extras):
    key = jax.random.PRNGKey(0)
    r = jnp.asarray(0, jnp.int32)
    W1, T1, _, _ = sweep(X if not isinstance(X, np.ndarray)
                         else jnp.asarray(X), jnp.asarray(W),
                         jnp.asarray(T), key, r, key,
                         *[jnp.asarray(e) for e in extras])
    return np.asarray(W1), np.asarray(T1)


def _jax_mesh(shape):
    return jax_make_mesh(shape[0] * shape[1], mesh_shape=shape)


# ---------------------------------------------------------------------------
# the sweep (tests/test_sharded_dense.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('mesh', [(4, 1), (2, 2), (1, 2), (1, 1)])
def test_sharded_dense_matches_single_chip(pool, mesh):
    """The mesh sweep equals JAX's single-chip kernel sweep and JAX's mesh
    kernel sweep at 1e-11, with one B1 call a phase on each rank."""
    X, W0, T0 = _problem()
    cfg = dict(k=6, reset_topic_method=None, update_order='phase',
               reg_t_l2=0.02, reg_w_l1=0.01)
    assert supports_sharded_dense(SweepConfig(**cfg))
    got = pool.run('dense_sweep', mesh=mesh, X=X, W=W0, T=T0, cfg=cfg)
    assert got['calls'] == {'gs': 2, 'tm_proj': 0}
    jcfg = JaxSweepConfig(**cfg)
    Wa, Ta = _jax_run(make_dense_phase_sweep_pallas(jcfg, interpret=True),
                      X, W0, T0)
    assert _close(got['W'], Wa) and _close(got['T'], Ta)
    Wb, Tb = _jax_run(make_sharded_dense_sweep_pallas(
        jcfg, _jax_mesh(mesh), interpret=True), X, W0, T0)
    assert _close(got['W'], Wb) and _close(got['T'], Tb)


def test_sharded_dense_inner_reps_parity(pool):
    X, W0, T0 = _problem(seed=1)
    cfg = dict(k=6, reset_topic_method=None, update_order='phase',
               inner_reps=3)
    got = pool.run('dense_sweep', mesh=(2, 2), X=X, W=W0, T=T0, cfg=cfg)
    Wa, Ta = _jax_run(make_dense_phase_sweep_pallas(JaxSweepConfig(**cfg),
                                                    interpret=True),
                      X, W0, T0)
    assert _close(got['W'], Wa) and _close(got['T'], Ta)


def test_sharded_dense_w_row_sum_vector(pool):
    """A per-row W bound vector, split over dp with W's rows."""
    X, W0, T0 = _problem(seed=2)
    ub = 0.5 + np.random.RandomState(3).rand(100)
    cfg = dict(k=6, reset_topic_method=None, update_order='phase',
               w_row_sum=None, w_row_sum_is_vector=True,
               project_W_each_iter=True)
    got = pool.run('dense_sweep', mesh=(4, 1), X=X, W=W0, T=T0, cfg=cfg,
                   wrs=ub)
    Wa, Ta = _jax_run(make_dense_phase_sweep_pallas(JaxSweepConfig(**cfg),
                                                    interpret=True),
                      X, W0, T0, ub)
    assert _close(got['W'], Wa) and _close(got['T'], Ta)


@pytest.mark.parametrize('mesh', [(2, 2), (4, 1)])
def test_nmf_mesh_dense_kernel_parity(pool, mesh):
    """nmf(mesh=...) in phase order routes to the sharded kernel sweep and
    equals JAX's single-device kernel fit; with use_pallas=False (the
    plain Gram-blocked sweep on the mesh) its objectives equal JAX's
    GSPMD fit's at 1e-9."""
    X = _problem(n=96, d=64, seed=4)[0]
    kw = dict(k=5, max_iter=4, random_state=0, early_stop=False,
              update_order='phase', reset_topic_method=None,
              compute_obj_each_iter=True, eps_stop=0)
    single = jax_nmf(X, use_pallas='interpret', **kw)
    sharded = pool.run('fit', mesh=mesh, X=X, kw=kw)
    assert _close(sharded['W'], single['W'])
    assert _close(sharded['T'], single['T'])
    gspmd = jax_nmf(X, mesh=_jax_mesh(mesh), use_pallas=False, **kw)
    plain = pool.run('fit', mesh=mesh, X=X, kw=dict(kw, use_pallas=False))
    assert np.allclose(sharded['obj_history'], gspmd['obj_history'],
                       rtol=0, atol=1e-9)
    assert np.allclose(plain['obj_history'], gspmd['obj_history'], rtol=0,
                       atol=1e-9)
    assert _close(plain['W'], sharded['W'])


def test_nmf_mesh_dense_kernel_tm_preset(pool):
    """w_row_sum and the per-iteration W projection through nmf()."""
    X = _problem(n=80, d=60, seed=5)[0]
    kw = dict(k=4, max_iter=3, random_state=0, early_stop=False,
              update_order='phase', reset_topic_method=None,
              w_row_sum=1.0, project_W_each_iter=True, eps_stop=0)
    single = jax_nmf(X, use_pallas='interpret', **kw)
    sharded = pool.run('fit', mesh=(2, 2), X=X, kw=kw)
    assert _close(sharded['W'], single['W'])
    assert _close(sharded['T'], single['T'])


@pytest.mark.parametrize('mesh', [(4, 1), (1, 4), (2, 2)])
def test_sharded_tm_projection_matches_single_chip(pool, mesh):
    """The per-topic T simplex projection: B2 on the whole panel gathered
    over tp equals JAX's single-chip projected kernel (one B2 call a
    sweep on every rank, B1 only in the W-phase)."""
    X, W0, T0 = _problem(n=96, d=72, k=5, seed=6)
    cfg = dict(k=5, reset_topic_method=None, update_order='phase',
               project_T_each_iter=True, t_row_sum=1.0)
    assert supports_sharded_dense(SweepConfig(**cfg), d=72)
    got = pool.run('dense_sweep', mesh=mesh, X=X, W=W0, T=T0, cfg=cfg)
    assert got['calls'] == {'gs': 1, 'tm_proj': 1}
    Wa, Ta = _jax_run(make_dense_phase_sweep_pallas(JaxSweepConfig(**cfg),
                                                    interpret=True),
                      X, W0, T0)
    assert _close(got['W'], Wa) and _close(got['T'], Ta)
    assert np.allclose(got['T'].sum(axis=1), 1.0, atol=1e-6)


def test_nmf_mesh_tm_full_preset_projected(pool):
    """The estimator's whole TM preset (both simplex constraints,
    inner_reps=2) on a (1, 4) mesh: the single-chip kernel fit at 1e-11
    and JAX's GSPMD fit at 1e-6."""
    X = _problem(n=64, d=48, seed=7)[0]
    kw = dict(k=4, max_iter=3, random_state=0, early_stop=False,
              update_order='phase', reset_topic_method=None,
              project_T_each_iter=True, t_row_sum=1.0,
              w_row_sum=1.0, project_W_each_iter=True, eps_stop=0,
              inner_reps=2)
    single = jax_nmf(X, use_pallas='interpret', **kw)
    sharded = pool.run('fit', mesh=(1, 4), X=X, kw=kw)
    gspmd = jax_nmf(X, mesh=_jax_mesh((2, 4)), use_pallas=False, **kw)
    assert _close(sharded['W'], single['W'])
    assert _close(sharded['T'], single['T'])
    assert _close(sharded['W'], gspmd['W'], 1e-6)
    assert _close(sharded['T'], gspmd['T'], 1e-6)


@pytest.mark.parametrize('mesh', [(2, 2), (4, 1)])
def test_sharded_dense_negative_l1_padding_no_ghost_mass(pool, mesh):
    """Negative L1 on uneven blocks (50 columns and 60 rows over the
    mesh): nothing is padded, so no ghost column can grow; parity with
    JAX's plain sweep at 1e-10."""
    X, W0, T0 = _problem(n=62, d=50, k=4)
    cfg = dict(k=4, reset_topic_method=None, update_order='phase',
               reg_t_l1=-0.05, reg_t_l2=0.5, reg_w_l1=-0.02, reg_w_l2=0.5)
    got = pool.run('dense_sweep', mesh=mesh, X=X, W=W0, T=T0, cfg=cfg)
    Wa, Ta = _jax_run(jax_make_sweep(JaxSweepConfig(**cfg)), X, W0, T0)
    assert _close(got['W'], Wa, 1e-10), np.abs(got['W'] - Wa).max()
    assert _close(got['T'], Ta, 1e-10)


def test_sharded_tm_gate_budgets_gathered_width(monkeypatch):
    """B2's gate is asked at the gathered panel's width, the global d
    (nothing is padded, so it is the single-device width), on the device
    given; a shape-blind caller is declined for the TM preset."""
    asked = []

    def fits(k, d, dtype, device):
        asked.append((k, d, dtype, device.type))
        return d <= 6000

    monkeypatch.setattr(dk, 'tm_proj_fits', fits)
    cfg = SweepConfig(k=768, reset_topic_method=None, update_order='phase',
                      project_T_each_iter=True, t_row_sum=1.0)
    assert supports_sharded_dense(cfg, d=6000)
    assert not supports_sharded_dense(cfg, d=8192)
    assert asked == [(768, 6000, torch.float32, 'cpu'),
                     (768, 8192, torch.float32, 'cpu')]
    assert not supports_sharded_dense(cfg)
    assert supports_sharded_dense(dataclasses.replace(
        cfg, project_T_each_iter=False))
    assert not supports_sharded_dense(dataclasses.replace(
        cfg, reset_topic_method='random'))


# ---------------------------------------------------------------------------
# storage on a mesh, phase order, inner_reps (the mesh cases of
# test_quantized.py, test_bfloat16.py, test_phase_order.py,
# test_inner_reps.py)
# ---------------------------------------------------------------------------

def test_sharded_phase_sweep_parity_quantized(pool):
    """An int16-coded X through the mesh sweep: each rank's code block
    with its columns' scales equals JAX's single-chip sweep on JAX's
    code at 1e-10."""
    rng = np.random.RandomState(4)
    X = _problem(n=128, d=96)[0]
    W, T = rng.rand(128, 4), rng.rand(4, 96)
    cfg = dict(k=4, reset_topic_method=None, update_order='phase')
    got = pool.run('dense_sweep', mesh=(2, 2), X=X, W=W, T=T, cfg=cfg,
                   quantize=True)
    W1, T1 = _jax_run(make_dense_phase_sweep_pallas(JaxSweepConfig(**cfg),
                                                    interpret=True),
                      jax_quantize_x(jnp.asarray(X)), W, T)
    assert _close(got['W'], W1, 1e-10) and _close(got['T'], T1, 1e-10)


def test_nmf_mesh_fit_quantized(pool):
    X = _problem(n=128, d=96)[0]
    kw = dict(k=4, x_dtype='int16', update_order='phase',
              reset_topic_method=None, max_iter=8,
              compute_obj_each_iter=True, random_state=0)
    r = pool.run('fit', mesh=(2, 2), X=X, kw=kw)
    assert np.all(np.diff(r['obj_history']) <= 1e-9)
    r1 = jax_nmf(X, **kw)
    assert abs(r['obj_history'][-1] - r1['obj_history'][-1]) \
        <= 1e-6 * abs(r1['obj_history'][-1])


def test_nmf_mesh_fit_quantized_unaligned(pool):
    """int16 with the TM preset on an odd shape (61 × 47 over (2, 2))."""
    X = _problem(n=61, d=47)[0]
    kw = dict(k=4, x_dtype='int16', update_order='phase',
              reset_topic_method=None, max_iter=6,
              compute_obj_each_iter=True, random_state=0,
              project_T_each_iter=True, t_row_sum=1.0)
    r = pool.run('fit', mesh=(2, 2), X=X, kw=kw)
    r1 = jax_nmf(X, **kw)
    assert np.all(np.diff(r['obj_history']) <= 1e-9)
    assert _close(r['W'], r1['W'], 1e-8) and _close(r['T'], r1['T'], 1e-8)


def test_mixed_x_dtype_mesh_parity(pool):
    """bfloat16 X beside float32 factors on a mesh: the factors stay
    float32; a one-rank mesh is the single-device fit bit for bit, and
    the first sweep of a (2, 2) mesh equals the single-device fits (the
    port's and JAX's) at 1e-5. Later sweeps part: the mesh sums its Grams
    and numerators in another order, and the W -> bfloat16 cast before
    each product turns those one-ulp differences into rounding flips that
    grow from sweep to sweep (beside float64 factors too), so six sweeps
    are held at the bfloat16 storage's 1e-3 relative objective."""
    X = _problem(n=64, d=48, k=4)[0]
    kw = dict(k=4, max_iter=6, random_state=0, early_stop=False,
              reset_topic_method=None, update_order='phase',
              dtype='float32', x_dtype='bfloat16',
              compute_obj_each_iter=True)
    single = torch_nmf(X, device='cpu', **kw)
    one = pool.run('fit', mesh=(1, 1), X=X, kw=kw)
    assert one['dtype'] == 'torch.float32'
    assert np.array_equal(one['W'], single['W'].double().numpy())
    assert np.array_equal(one['T'], single['T'].double().numpy())
    meshed = pool.run('fit', mesh=(2, 2), X=X, kw=kw)
    assert np.allclose(meshed['obj_history'], single['obj_history'],
                       rtol=1e-3, atol=0)
    kw1 = dict(kw, max_iter=1)
    first = pool.run('fit', mesh=(2, 2), X=X, kw=kw1)
    for want in (torch_nmf(X, device='cpu', **kw1),
                 jax_nmf(X, use_pallas='interpret', **kw1)):
        assert _close(first['W'], want['W'], 1e-5)
        assert _close(first['T'], want['T'], 1e-5)


@pytest.mark.parametrize('dtype', ['bfloat16', 'float16'])
def test_16_bit_factors_on_a_mesh(pool, dtype):
    """16-bit factors on a (2, 2) mesh stay 16-bit and, over 3 sweeps,
    equal the port's single-device 16-bit fit within the JAX suite's
    kernel-against-plain bound (0.02): the Grams sum their float32
    partials in another order, and one-ulp flips grow from sweep to
    sweep."""
    X = _problem(n=64, d=48, k=4, seed=8)[0]
    kw = dict(k=4, max_iter=3, random_state=0, early_stop=False,
              reset_topic_method=None, update_order='phase', dtype=dtype)
    meshed = pool.run('fit', mesh=(2, 2), X=X, kw=kw)
    single = torch_nmf(X, device='cpu', **kw)
    assert meshed['dtype'] == 'torch.' + dtype
    assert _close(meshed['W'], single['W'].double(), 0.02)
    assert _close(meshed['T'], single['T'].double(), 0.02)


def test_phase_order_under_mesh(pool):
    rng = np.random.RandomState(0)
    X = np.abs(rng.rand(64, 3) @ rng.rand(3, 40) + 0.1 * rng.rand(64, 40))
    kw = dict(k=3, max_iter=6, random_state=0, early_stop=False,
              compute_obj_each_iter=True, reset_topic_method=None,
              update_order='phase')
    single = jax_nmf(X, **kw)
    sharded = pool.run('fit', mesh=(2, 2), X=X, kw=kw)
    assert _close(sharded['W'], single['W'], 1e-12)
    assert _close(sharded['T'], single['T'], 1e-12)


def test_inner_reps_sharded_parity(pool):
    """inner_reps=3 on a (2, 2) mesh (X densified: the sparse mesh is
    A.12d) against JAX's single-device sparse fit."""
    rng = np.random.RandomState(3)
    X = np.abs(rng.rand(64, 48))
    X[X < 0.7] = 0.0
    kw = dict(k=5, max_iter=4, random_state=0, early_stop=False,
              update_order='phase', reset_topic_method=None, inner_reps=3,
              compute_obj_each_iter=True)
    single = jax_nmf(scipy.sparse.csr_matrix(X), sparse=True, **kw)
    sharded = pool.run('fit', mesh=(2, 2), X=X, kw=kw)
    assert _close(sharded['W'], single['W'])
    assert np.allclose(sharded['obj_history'], single['obj_history'],
                       rtol=0, atol=1e-9)
