"""The port's dense-mask mesh (ROADMAP A.12c: ``rri_nmf_tpu_torch.parallel.
sharded_masked``, kernels B3 and B4 on each rank's block, and the plain
masked sweep on a mesh) and ``store_gradients`` on a mesh (A.12g) against
the JAX package, on the CPU in float64.

The ranks are four processes of one gloo world
(``tests/torch_mesh_worker.py``, started once for the module); the
kernels run as their plain twins on the CPU, each call counted per rank.
JAX's references run here: its single-device ``make_sweep`` and
``nmf()``. Carried over from ``tests/test_sharding.py``, at its
tolerances:

- the masked training step (``:55``), 1e-11;
- the sharded masked kernel sweep (``:94``) and its fixed-T form
  (``:124``), 1e-9 (T bit for bit under fixed T);
- ``nmf(W_mat=..., mesh=...)`` and its fixed-T transform (``:162``,
  ``:182``), 1e-9, grouped dispatch against per-sweep at 1e-12;
- the masked half of the unaligned-shape test (``:289``), 1e-11: the port
  splits the shape in uneven blocks where JAX replicates the axis;
- negative L1 (``:339``), 1e-9, here on uneven blocks: JAX's test guards
  its zero-padded tails, and the port pads nothing, so uneven blocks are
  what its solves must get right.

``:375`` pins JAX's aligned-shape repad skip (an O(nd) zero-pad it
traces or not); the port never pads, so it has no counterpart. Also: the
masked draws of ``tests/test_fuzz.py::mesh_parity_draw`` (1e-8), a masked
HER fit (1e-9) and a masked checkpoint resumed against straight (1e-12),
the masked objectives, every config the kernels' mesh gate refuses
through the plain masked mesh sweep, and ``store_gradients`` on (2, 1)
and (2, 2) against JAX's single-device stores (1e-10). Each mesh fit is
also held against the port's own single-device fit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from rri_nmf_tpu.nmf import nmf as jax_nmf
from rri_nmf_tpu.ops.accel import make_residual_obj as jax_residual_obj
from rri_nmf_tpu.ops.sweep_xla import SweepConfig as JaxSweepConfig
from rri_nmf_tpu.ops.sweep_xla import make_objective as jax_make_objective
from rri_nmf_tpu.ops.sweep_xla import make_sweep as jax_make_sweep
from rri_nmf_tpu_torch.nmf import nmf as torch_nmf
from rri_nmf_tpu_torch.ops.sweep import SweepConfig
from rri_nmf_tpu_torch.parallel import supports_sharded_masked
from test_fuzz import _sample_config
from torch_mesh_worker import MeshPool

torch.set_num_threads(2)

STEP_TOL = 1e-11
FIT_TOL = 1e-9
FUZZ_TOL = 1e-8
STORE_TOL = 1e-10
SAME_TOL = 1e-12
MESHES = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1)]


@pytest.fixture(scope='module')
def pool(tmp_path_factory):
    p = MeshPool(tmp_path_factory.mktemp('masked_ranks'))
    yield p
    p.close()


def _problem(n=64, d=32, k=6, seed=0, density=0.5):
    rng = np.random.RandomState(seed)
    X = np.abs(rng.rand(n, k) @ rng.rand(k, d) + 0.01 * rng.rand(n, d))
    M = (rng.rand(n, d) < density).astype(float)
    return X, M, np.abs(rng.rand(n, k)), np.abs(rng.rand(k, d))


def _close(a, b, tol):
    return np.allclose(np.asarray(a, float), np.asarray(b, float), rtol=0,
                       atol=tol)


def _np(a):
    return a.double().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _jax_sweeps(cfg, X, M, W, T, sweeps):
    """``sweeps`` sweeps of JAX's single-device make_sweep."""
    sweep = jax_make_sweep(JaxSweepConfig(**cfg))
    key = jax.random.PRNGKey(0)
    r = jnp.asarray(0, jnp.int32)
    W, T = jnp.asarray(W), jnp.asarray(T)
    for _ in range(sweeps):
        W, T, _, _ = sweep(jnp.asarray(X), W, T, key, r, key,
                           jnp.asarray(M))
    return np.asarray(W), np.asarray(T)


def _port_masked_sweeps(cfg, X, M, W, T, sweeps):
    """The port's single-device kernel sweep (B3/B4 twins)."""
    from rri_nmf_tpu_torch.ops.masked_kernels import make_masked_sweep
    from rri_nmf_tpu_torch.ops.sweep import make_draws
    sweep = make_masked_sweep(SweepConfig(**cfg))
    X, M, W, T = (torch.as_tensor(a) for a in (X, M, W, T))
    draws = make_draws(0, 'cpu')
    for _ in range(sweeps):
        W, T, _ = sweep(X, W, T, M, draws, 0)
    return W.numpy(), T.numpy()


def _same_fit(got, want, tol, obj=True):
    assert _close(got['W'], want['W'], tol), \
        np.abs(got['W'] - np.asarray(want['W'])).max()
    assert _close(got['T'], want['T'], tol), \
        np.abs(got['T'] - np.asarray(want['T'])).max()
    if obj:
        assert np.allclose(got['obj_history'], want['obj_history'],
                           rtol=tol, atol=0)


def _port(X, **kw):
    return {k: (_np(v) if k in ('W', 'T') else v)
            for k, v in torch_nmf(X, device='cpu', **kw).items()}


# ---------------------------------------------------------------------------
# the sweeps (tests/test_sharding.py)
# ---------------------------------------------------------------------------

STEP_CFG = dict(k=6, masked=True, reset_topic_method=None, t_row_sum=1.0)


@pytest.mark.parametrize('mesh', MESHES)
def test_sharded_equals_single_device_masked(pool, mesh):
    """The masked training step (the plain sweep with its collectives,
    the mask split like X, then the masked objective) equals JAX's
    single-device sweep at 1e-11, and its objective descends."""
    X, M, W0, T0 = _problem(seed=3)
    got = pool.run('step', mesh=mesh, X=X, W=W0, T=T0, cfg=STEP_CFG,
                   sweeps=2, M=M)
    Wd, Td = _jax_sweeps(STEP_CFG, X, M, W0, T0, 2)
    assert _close(got['W'], Wd, STEP_TOL) and _close(got['T'], Td, STEP_TOL)
    assert got['obj'][1] <= got['obj'][0]
    want = float(jax_residual_obj(JaxSweepConfig(**STEP_CFG),
                                  distributed=False)(
        jnp.asarray(X), jnp.asarray(Wd), jnp.asarray(Td), jnp.asarray(M)))
    assert abs(got['obj'][1] - want) <= 1e-12 * abs(want)


SWEEP_CFG = dict(k=4, masked=True, reset_topic_method=None, t_row_sum=1.0)


@pytest.mark.parametrize('mesh', MESHES)
def test_sharded_masked_sweep(pool, mesh):
    """B3/B4 on each rank's block equal JAX's single-device sweep at 1e-9
    (and the port's own single-device kernel sweep: bit for bit on one
    rank), with B3 and B4 k times a sweep on every rank."""
    rng = np.random.RandomState(0)
    n, d, k = 90, 70, 4
    X = np.abs(rng.rand(n, k) @ rng.rand(k, d) + 0.01 * rng.rand(n, d))
    M = (rng.rand(n, d) < 0.5).astype(float)
    W0, T0 = np.abs(rng.rand(n, k)), np.abs(rng.rand(k, d))
    assert supports_sharded_masked(SweepConfig(**SWEEP_CFG))
    got = pool.run('masked_sweep', mesh=mesh, X=X, M=M, W=W0, T=T0,
                   cfg=SWEEP_CFG, sweeps=3)
    assert got['calls']['phase_a'] == got['calls']['phase_b'] == 3 * k
    Wd, Td = _jax_sweeps(SWEEP_CFG, X, M, W0, T0, 3)
    assert _close(got['W'], Wd, FIT_TOL) and _close(got['T'], Td, FIT_TOL)
    Wp, Tp = _port_masked_sweeps(SWEEP_CFG, X, M, W0, T0, 3)
    tol = 0.0 if mesh == (1, 1) else SAME_TOL
    assert _close(got['W'], Wp, tol) and _close(got['T'], Tp, tol)


@pytest.mark.parametrize('mesh', [(2, 2), (4, 1)])
def test_sharded_masked_fix_t_inference(pool, mesh):
    """The fixed-T form (B4 alone, the RS transform preset without its
    resets): T bit for bit, W at 1e-9 of JAX's sweep; resets under fixed
    T stay outside the kernels' mesh gate."""
    rng = np.random.RandomState(3)
    n, d, k = 90, 70, 4
    X = np.abs(rng.rand(n, k) @ rng.rand(k, d) + 0.01 * rng.rand(n, d))
    M = (rng.rand(n, d) < 0.5).astype(float)
    W0, T0 = np.abs(rng.rand(n, k)), np.abs(rng.rand(k, d))
    T0 /= T0.sum(axis=1, keepdims=True)
    cfg = dict(k=k, masked=True, fix_T=True, reset_topic_method=None,
               t_row_sum=1.0, w_row_sum=2.0)
    assert supports_sharded_masked(SweepConfig(**cfg))
    got = pool.run('masked_sweep', mesh=mesh, X=X, M=M, W=W0, T=T0, cfg=cfg,
                   sweeps=3)
    assert got['calls']['phase_a'] == 0 and got['calls']['phase_b'] == 3 * k
    Wd, Td = _jax_sweeps(cfg, X, M, W0, T0, 3)
    assert np.array_equal(got['T'], Td)
    assert _close(got['W'], Wd, FIT_TOL)
    for method in ('random', 'max_resid_document'):
        assert not supports_sharded_masked(SweepConfig(
            k=k, masked=True, fix_T=True, reset_topic_method=method,
            t_row_sum=1.0))


@pytest.mark.parametrize('mesh', [(2, 2), (4, 1)])
def test_sharded_masked_negative_l1_uneven_blocks(pool, mesh):
    """Negative L1 on both factors at 10×9 (uneven blocks on both
    meshes): the per-coordinate solves see only real coordinates, so the
    sweep equals JAX's single-device sweep at 1e-9."""
    n, d, k = 10, 9, 3
    rng = np.random.RandomState(1)
    X = np.abs(rng.rand(n, k) @ rng.rand(k, d))
    M = np.ones((n, d))
    W0 = np.abs(rng.rand(n, k)) + 0.1
    T0 = np.abs(rng.rand(k, d)) + 0.1
    cfg = dict(k=k, masked=True, reset_topic_method=None, reg_t_l1=-0.1,
               reg_t_l2=0.5, reg_w_l1=-0.05, reg_w_l2=0.5)
    got = pool.run('masked_sweep', mesh=mesh, X=X, M=M, W=W0, T=T0, cfg=cfg)
    Wd, Td = _jax_sweeps(cfg, X, M, W0, T0, 1)
    assert _close(got['W'], Wd, FIT_TOL) and _close(got['T'], Td, FIT_TOL)


@pytest.mark.parametrize('mesh', [(2, 2), (1, 1)])
def test_masked_objectives_on_a_mesh(pool, mesh):
    """The distributed masked objectives (HER's residual one and the
    tracked one) against JAX's single-device ones, 1e-12 relative."""
    X, M, W, T = _problem(n=63, d=47, k=5, seed=4)
    cfg = dict(k=5, masked=True, reset_topic_method=None, reg_w_l2=0.01,
               reg_t_l1=0.005)
    got = pool.run('masked_objective', mesh=mesh, X=X, M=M, W=W, T=T,
                   cfg=cfg)
    args = [jnp.asarray(a) for a in (X, W, T, M)]
    want = [float(jax_residual_obj(JaxSweepConfig(**cfg),
                                   distributed=False)(*args)),
            float(jax_make_objective(masked=True, row_weighted=False,
                                     reg_w_l2=0.01,
                                     reg_t_l1=0.005)(*args))]
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-12 * abs(w)


# ---------------------------------------------------------------------------
# nmf(W_mat=..., mesh=...)
# ---------------------------------------------------------------------------

def test_nmf_mesh_masked_kernels(pool):
    """``nmf(mesh=...)`` routes a masked fit through B3/B4 on each rank
    (k launches of each a sweep) and matches JAX's fit at 1e-9; grouped
    dispatch matches the per-sweep fit at 1e-12."""
    rng = np.random.RandomState(0)
    X = np.abs(rng.rand(80, 3) @ rng.rand(3, 60) + 0.01 * rng.rand(80, 60))
    M = (rng.rand(80, 60) < 0.5).astype(float)
    kw = dict(k=3, W_mat=M, max_iter=5, random_state=0, early_stop=False,
              reset_topic_method=None, t_row_sum=1.0,
              compute_obj_each_iter=True)
    a = jax_nmf(X, **kw)
    b = pool.run('fit', mesh=(2, 2), X=X, kw=kw)
    assert b['calls']['phase_a'] == b['calls']['phase_b'] == 5 * 3
    _same_fit(b, a, FIT_TOL)
    _same_fit(b, _port(X, **kw), SAME_TOL)
    c = pool.run('fit', mesh=(2, 2), X=X,
                 kw=dict(kw, compute_obj_each_iter=False,
                         sweeps_per_dispatch=2))
    _same_fit(c, b, SAME_TOL, obj=False)


def test_nmf_mesh_fix_t_transform(pool):
    """The masked fixed-T transform on a mesh rides B4 alone and matches
    JAX's single-device transform (T unchanged)."""
    rng = np.random.RandomState(4)
    X = np.abs(rng.rand(80, 3) @ rng.rand(3, 60) + 0.01 * rng.rand(80, 60))
    M = (rng.rand(80, 60) < 0.5).astype(float)
    T_in = np.abs(rng.rand(3, 60))
    T_in /= T_in.sum(axis=1, keepdims=True)
    kw = dict(k=3, W_mat=M, T_in=T_in, fix_T=True, max_iter=4,
              random_state=0, early_stop=False, reset_topic_method=None,
              t_row_sum=1.0)
    a = jax_nmf(X, **kw)
    b = pool.run('fit', mesh=(4, 1), X=X, kw=kw)
    assert b['calls']['phase_a'] == 0 and b['calls']['phase_b'] == 4 * 3
    assert _close(b['W'], a['W'], FIT_TOL)
    assert np.array_equal(b['T'], np.asarray(a['T']))


@pytest.mark.parametrize('mesh', [(2, 2), (4, 1)])
def test_unaligned_masked_fit(pool, mesh):
    """The masked fit at 50×39 (uneven blocks on both meshes) equals
    JAX's single-device fit at 1e-11."""
    rng = np.random.RandomState(0)
    X = np.abs(rng.rand(50, 39))
    rng.rand(48, 39)            # the unmasked half's second matrix
    M = (rng.rand(50, 39) < 0.7).astype(float)
    kw = dict(k=4, max_iter=4, random_state=0, early_stop=False,
              reset_topic_method=None, W_mat=M)
    got = pool.run('fit', mesh=mesh, X=X, kw=kw)
    assert any('mesh quanta' in m for m in got['warnings'])
    assert _close(got['W'], jax_nmf(X, **kw)['W'], STEP_TOL)


def _fuzz_draw(seed):
    """The masked draws of tests/test_fuzz.py::mesh_parity_draw, the JAX
    mesh shapes (8, 1), (4, 2), (2, 4) on four ranks as (4, 1), (2, 2),
    (1, 4)."""
    rng = np.random.RandomState(7000 + seed)
    n = int(rng.randint(20, 60))
    d = int(rng.randint(15, 50))
    cfg, masked = _sample_config(rng)
    assert masked, seed
    k = cfg.pop('k')
    cfg.pop('sweeps_per_dispatch', None)
    cfg.pop('_draw_w_row', False)
    cfg.pop('_draw_f32', None)
    X = np.abs(rng.rand(n, k) @ rng.rand(k, d) + 0.01 * rng.rand(n, d))
    kw = dict(max_iter=4, random_state=seed, early_stop=False,
              compute_obj_each_iter=True, eps_stop=0, k=k)
    kw['W_mat'] = (rng.rand(n, d) < 0.6).astype(float)
    kw.update(cfg)
    mesh = [(4, 1), (2, 2), (1, 4)][int(rng.randint(3))]
    return X, kw, mesh


@pytest.mark.parametrize('seed', [1, 2, 4, 7])
def test_random_masked_config_mesh_parity(pool, seed):
    """Masked draws (HER, regularizers, inits, every mesh shape) at 1e-8
    of JAX's single-device fit."""
    X, kw, mesh = _fuzz_draw(seed)
    got = pool.run('fit', mesh=mesh, X=X, kw=kw)
    want = jax_nmf(X, **kw)
    _same_fit(got, want, FUZZ_TOL)


def test_masked_her_on_a_mesh(pool):
    """A masked HER fit on (2, 2): the extrapolation on each rank's
    blocks, the restart check on the distributed masked objective; 1e-9
    of JAX's single-device HER fit."""
    X, M, _, _ = _problem(n=60, d=40, k=4, seed=8, density=0.7)
    kw = dict(k=4, W_mat=M, max_iter=8, random_state=0, early_stop=False,
              reset_topic_method=None, eps_stop=0.0, accel='her',
              compute_obj_each_iter=True)
    got = pool.run('fit', mesh=(2, 2), X=X, kw=kw)
    assert got['calls']['phase_a'] == 8 * 4
    _same_fit(got, jax_nmf(X, **kw), FIT_TOL)


def test_masked_mesh_checkpoint_resume(pool, tmp_path):
    """A masked mesh fit resumed from its checkpoint equals the straight
    mesh fit at 1e-12, and JAX's single-device fit at 1e-9."""
    X, M, _, _ = _problem(n=40, d=24, k=3, seed=9, density=0.7)
    kw = dict(k=3, W_mat=M, max_iter=8, random_state=0, early_stop=False,
              compute_obj_each_iter=True, reset_topic_method=None,
              eps_stop=0.0)
    straight = pool.run('fit', mesh=(2, 2), X=X, kw=kw)
    ck = str(tmp_path / 'masked_mesh')
    pool.run('fit', mesh=(2, 2), X=X, kw=dict(kw, max_iter=4, checkpoint=ck,
                                              checkpoint_every=2))
    resumed = pool.run('fit', mesh=(2, 2), X=X,
                       kw=dict(kw, checkpoint=ck, checkpoint_every=100))
    _same_fit(resumed, straight, SAME_TOL)
    _same_fit(resumed, jax_nmf(X, **kw), FIT_TOL)


# the configs the kernels' mesh gate refuses (and use_pallas=False): the
# plain masked sweep with its collectives, JAX's GSPMD sweep
FALLBACK = {
    'max_resid_document': dict(reset_topic_method='max_resid_document',
                               t_row_sum=1.0, dead=1),
    'fix_T random': dict(fix_T=True, reset_topic_method='random',
                         t_row_sum=1.0, dead_t=2),
    'fix_T max_resid_document': dict(
        fix_T=True, reset_topic_method='max_resid_document', t_row_sum=1.0,
        dead_t=2),
    'vector w_row_sum': dict(reset_topic_method=None, w_row_sum='vector',
                             project_W_each_iter=True),
    'project_T t_row_sum': dict(reset_topic_method=None,
                                project_T_each_iter=True, t_row_sum=1.0),
    'dp noise': dict(reset_topic_method=None, eps_gauss_t=1e5,
                     delta_gauss_t=1e-3),
    'fix_W': dict(fix_W=True, reset_topic_method=None),
    'use_pallas=False': dict(use_pallas=False, reset_topic_method=None,
                             t_row_sum=1.0),
    'bfloat16 factors': dict(dtype=torch.bfloat16, reset_topic_method=None),
}


@pytest.mark.parametrize('case', sorted(FALLBACK))
def test_masked_mesh_fallback_sweep(pool, case):
    """Each masked config outside the kernels' mesh gate runs the plain
    masked sweep on the mesh (no B3/B4 call): the (2, 2) fit equals the
    port's single-device fit (which JAX's suite holds at 1e-8, its draws
    injected) at 1e-9, resets and draws included; the draw-free ones
    equal JAX's fit at 1e-9. 16-bit factors under the default
    ``use_pallas`` take the plain sweep too (JAX's rule): on the mesh
    their bfloat16 roundings agree with one device's within 1e-2."""
    X, M, W0, T0 = _problem(n=40, d=30, k=3, seed=16, density=0.7)
    kw = dict(k=3, W_mat=M, max_iter=4, random_state=3, early_stop=False,
              compute_obj_each_iter=True)
    kw.update(FALLBACK[case])
    dead, dead_t = kw.pop('dead', None), kw.pop('dead_t', None)
    if dead is not None:
        W0[:, dead] = 0.0
        kw.update(W_in=W0, T_in=T0)
    if dead_t is not None:
        T0[dead_t] = 0.0
        kw.update(T_in=T0)
    if kw.get('fix_W'):
        kw.update(W_in=W0)
    if kw.get('w_row_sum') == 'vector':
        kw['w_row_sum'] = 1.0 + 0.5 * np.random.RandomState(2).rand(40)
    got = pool.run('fit', mesh=(2, 2), X=X, kw=kw)
    assert got['calls']['phase_a'] == got['calls']['phase_b'] == 0
    want = _port(X, **kw)
    if case == 'bfloat16 factors':
        assert got['dtype'] == 'torch.bfloat16'
        assert _close(got['W'], want['W'], 1e-2)
        return
    _same_fit(got, want, FIT_TOL)
    assert got['n_resets_remaining'] == want['n_resets_remaining']
    if dead is not None or dead_t is not None:
        assert got['n_resets_remaining'] < 23
    if case in ('vector w_row_sum', 'project_T t_row_sum', 'fix_W',
                'use_pallas=False', 'max_resid_document'):
        _same_fit(got, jax_nmf(X, **kw), FIT_TOL)


# ---------------------------------------------------------------------------
# store_gradients on a mesh (A.12g)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('rows', [None, (0, 3, 7, 21, 39)])
@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('mesh', [(2, 1), (2, 2)])
def test_store_gradients_on_a_mesh(pool, mesh, masked, rows):
    """The stores come back whole on every rank: the numerators (and a
    masked fit's denominators) gathered over tp, the selected rows' sums
    over dp (each row on one dp rank); 1e-10 of JAX's single-device
    stores and of the port's."""
    X, M, _, _ = _problem(n=40, d=30, k=3, seed=15, density=0.7)
    kw = dict(k=3, max_iter=3, random_state=0, early_stop=False,
              store_gradients=True, reset_topic_method=None,
              ind_rows_to_store=rows, compute_obj_each_iter=True)
    if masked:
        kw['W_mat'] = M
    got = pool.run('fit', mesh=mesh, X=X, kw=kw)
    want = jax_nmf(X, **kw)
    mine = torch_nmf(X, device='cpu', **kw)
    _same_fit(got, want, STORE_TOL)
    for key in ('numer_W', 'denom_W'):
        assert sorted(got[key]) == sorted(want[key]) == [0, 1, 2]
        for it in want[key]:
            assert got[key][it].shape == np.asarray(want[key][it]).shape
            assert _close(got[key][it], want[key][it], STORE_TOL)
            assert _close(got[key][it], _np(mine[key][it]), STORE_TOL)
