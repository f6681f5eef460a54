"""The port's int16 column-scaled X storage (``x_dtype='int16'``,
``QuantizedX``) against the JAX package, on the CPU in float64.

- The code: q and s bit for bit against ``quantize_x`` and ``nmf()``'s
  host encoder ``_quantize_host``, from numpy and from a tensor; the
  round-trip bound, exact zeros and column maxima, ``qx_mean``.
- The scale-folded contractions at 1e-12 against JAX's, and
  :func:`~rri_nmf_tpu_torch.ops.quantized.xmm`'s block upcast (a small
  buffer forces many blocks) against the plain product.
- The dense kernel sweep on a QuantizedX against JAX's Pallas sweep in
  interpret mode at 1e-11 (``tests/test_quantized.py:98-101``), the
  objectives at 1e-8 and a HER step at 1e-11.
- ``nmf()``: ``x_dtype='int16'`` and a QuantizedX input against JAX's
  fits at 1e-8 (histories non-increasing within 1e-9), the pickled
  objective computer, JAX's gating errors, ``w_row`` and HER.
- The init on a QuantizedX (the device SVD backend) against the same
  backend on the dequantized matrix, and a 16-bit X's SVD in float32.
- The randomized draws of ``tests/test_quantized.py::quantized_draw``:
  a fit on the code equals the fit on the dequantized matrix.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rri_nmf_tpu.nmf import _quantize_host
from rri_nmf_tpu.nmf import nmf as jax_nmf
from rri_nmf_tpu.ops import quantized as jq
from rri_nmf_tpu.ops.accel import make_her_step as jax_her_step
from rri_nmf_tpu.ops.accel import make_residual_obj as jax_residual_obj
from rri_nmf_tpu.ops.dense_pallas import make_dense_phase_sweep_pallas
from rri_nmf_tpu.ops.sweep_xla import SweepConfig as JaxSweepConfig
from rri_nmf_tpu.ops.sweep_xla import make_objective as jax_objective
from rri_nmf_tpu_torch import initialization as ti
from rri_nmf_tpu_torch.convert import quantized_from_numpy
from rri_nmf_tpu_torch.nmf import nmf as torch_nmf
from rri_nmf_tpu_torch.ops import quantized as tq
from rri_nmf_tpu_torch.ops.accel import make_her_step, make_residual_obj
from rri_nmf_tpu_torch.ops.dense_kernels import make_dense_phase_sweep
from rri_nmf_tpu_torch.ops.sweep import SweepConfig, make_objective

torch.set_num_threads(2)
PHASE = dict(update_order='phase', reset_topic_method=None)


def _problem(n=96, d=80, seed=0, scale=7.0):
    return np.random.RandomState(seed).rand(n, d) * scale


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _pair(X):
    """The same code in both packages: JAX's quantize_x, carried over."""
    jx = jq.quantize_x(jnp.asarray(X))
    return jx, quantized_from_numpy(np.asarray(jx.q), np.asarray(jx.s),
                                    device='cpu')


# ---------------------------------------------------------------------------
# the code
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('source', ['numpy', 'tensor', 'float32'])
def test_codes_and_scales_match_jax_bit_for_bit(source):
    X = _problem()
    X[:, 3] = 0.0                      # an all-zero column: scale 1
    X[5, 7] = 0.0
    if source == 'float32':
        X = X.astype(np.float32)
    jx = jq.quantize_x(jnp.asarray(X))
    jh = _quantize_host(X, jnp.dtype(X.dtype))
    qx = tq.quantize_x(torch.as_tensor(X) if source == 'tensor' else X,
                       device='cpu')
    for want in (jx, jh):
        assert np.array_equal(_np(qx.q), np.asarray(want.q))
    assert np.array_equal(_np(qx.s), np.asarray(jh.s))
    # jitted, JAX's encoder may divide by 32767 as a product with the
    # reciprocal: one ulp in float32
    assert np.all(np.abs(_np(qx.s) - np.asarray(jx.s))
                  <= np.finfo(X.dtype).eps * _np(qx.s))
    assert qx.q.dtype == torch.int16 and qx.dtype == qx.s.dtype
    assert qx.shape == X.shape and qx.ndim == 2


def test_code_roundtrip_zeros_and_mean():
    X = _problem()
    X[:, 3] = 0.0
    X[0, 5] = 0.0
    qx = tq.quantize_x(X, device='cpu')
    Xdq = _np(tq.dequantize_x(qx))
    s = _np(qx.s)
    assert np.all(np.abs(Xdq - X) <= 0.5 * s[None, :] + 1e-12)
    assert np.linalg.norm(Xdq - X) / np.linalg.norm(X) < 5e-5
    assert np.all(Xdq[:, 3] == 0) and Xdq[0, 5] == 0
    np.testing.assert_allclose(Xdq.max(axis=0), X.max(axis=0), rtol=1e-12)
    assert abs(float(tq.qx_mean(qx)) - Xdq.mean()) < 1e-10
    assert abs(float(tq.qx_mean(qx))
               - float(jq.qx_mean(jq.quantize_x(jnp.asarray(X))))) < 1e-12
    with pytest.raises(ValueError, match='nonnegative'):
        tq.quantize_x(X - 10.0, device='cpu')
    with pytest.raises(ValueError, match='nonnegative'):
        tq.quantize_x(torch.as_tensor(X - 10.0))
    with pytest.raises(ValueError, match='int16'):
        quantized_from_numpy(np.ones((3, 2)), np.ones(2), device='cpu')


# ---------------------------------------------------------------------------
# the contractions
# ---------------------------------------------------------------------------

def test_contractions_match_jax():
    X = _problem()
    jx, qx = _pair(X)
    rng = np.random.RandomState(1)
    W, T = rng.rand(96, 6), rng.rand(6, 80)
    Om, Q = rng.rand(80, 9), rng.rand(96, 9)
    f64 = torch.float64
    pairs = [
        (tq.qx_t_numerator(torch.as_tensor(W), qx, f64),
         jq.qx_t_numerator(jnp.asarray(W), jx, jnp.float64)),
        (tq.qx_w_numerator(torch.as_tensor(T), qx, f64),
         jq.qx_w_numerator(jnp.asarray(T), jx, jnp.float64)),
        (tq.qx_rmul(qx, torch.as_tensor(Om), f64),
         jq.qx_rmul(jx, jnp.asarray(Om), jnp.float64)),
        (tq.qx_lmul_t(qx, torch.as_tensor(Q), f64),
         jq.qx_lmul_t(jx, jnp.asarray(Q), jnp.float64)),
        (tq.qx_row_block(qx, 10, 20, f64),
         jq.qx_row_block(jx, 10, 20, jnp.float64)),
        (tq.qx_col_block(qx, 30, 17, f64),
         jq.qx_col_block(jx, 30, 17, jnp.float64)),
    ]
    for got, want in pairs:
        assert got.shape == want.shape
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                   atol=1e-12 * max(1.0, float(
                                       np.abs(want).max())))


@pytest.mark.parametrize('shape', [(97, 13, 29), (11, 83, 7), (64, 64, 64)])
def test_block_upcast_matches_the_plain_product(monkeypatch, shape):
    """xmm upcasts the larger operand a block of rows at a time; a tiny
    buffer forces ragged blocks in every branch, transposed views too."""
    monkeypatch.setattr(tq, 'UPCAST_BYTES', 8 * 40)
    m, q, p = shape
    rng = np.random.RandomState(2)
    A, B = rng.rand(m, q), rng.rand(q, p)
    want = A @ B
    for a, b in ((torch.as_tensor(A).to(torch.float32), torch.as_tensor(B)),
                 (torch.as_tensor(A), torch.as_tensor(B).to(torch.bfloat16)),
                 (torch.as_tensor(A.T).T, torch.as_tensor(B.T).T.to(
                     torch.float16))):
        got = tq.xmm(a, b, torch.float64)
        exact = a.to(torch.float64) @ b.to(torch.float64)
        assert got.dtype == torch.float64 and got.shape == (m, p)
        np.testing.assert_allclose(_np(got), _np(exact), rtol=1e-12)
    assert np.allclose(_np(tq.xmm(torch.as_tensor(A), torch.as_tensor(B),
                                  torch.float64)), want, rtol=1e-14)


# ---------------------------------------------------------------------------
# the sweep, the objectives, HER
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('cfg_kw', [
    dict(),
    dict(inner_reps=3),
    dict(project_T_each_iter=True, t_row_sum=1.0),
    dict(reg_w_l2=0.05, reg_t_l1=0.02),
    dict(fix_T=True),
    dict(w_row_sum=1.0, project_W_each_iter=True),
])
def test_phase_sweep_on_the_code_matches_jax(cfg_kw):
    X = _problem()
    jx, qx = _pair(X)
    Xdq = tq.dequantize_x(qx)
    k = 6
    rng = np.random.RandomState(1)
    W, T = rng.rand(96, k), rng.rand(k, 80)
    jsw = make_dense_phase_sweep_pallas(
        JaxSweepConfig(k=k, **PHASE, **cfg_kw), interpret=True)
    sw = make_dense_phase_sweep(SweepConfig(k=k, **PHASE, **cfg_kw))
    key = jax.random.PRNGKey(0)
    rl = jnp.asarray(0, jnp.int32)
    Wt, Tt = torch.as_tensor(W), torch.as_tensor(T)
    Wj, Tj = jnp.asarray(W), jnp.asarray(T)
    for _ in range(3):
        Wj, Tj, _, _ = jsw(jx, Wj, Tj, key, rl, key)
        Wd, Td = sw(Xdq, Wt, Tt)
        Wt, Tt = sw(qx, Wt, Tt)
        for got, want in ((Wt, Wj), (Tt, Tj), (Wd, Wj), (Td, Tj)):
            np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                       atol=1e-11)


def test_objectives_and_her_step_match_jax():
    X = _problem()
    jx, qx = _pair(X)
    k = 6
    rng = np.random.RandomState(2)
    W, T = rng.rand(96, k), rng.rand(k, 80)
    Wt, Tt, Wj, Tj = (torch.as_tensor(W), torch.as_tensor(T),
                      jnp.asarray(W), jnp.asarray(T))
    for kw in (PHASE, dict(reset_topic_method=None)):
        for br in (32, 4096):
            a = make_residual_obj(SweepConfig(k=k, **kw), block_rows=br)
            b = jax_residual_obj(JaxSweepConfig(k=k, **kw), block_rows=br)
            assert abs(float(a(qx, Wt, Tt)) - float(b(jx, Wj, Tj))) < 1e-8
    for br in (None, 32):
        a = make_objective(reg_w_l2=0.01, block_rows=br)
        b = jax_objective(masked=False, row_weighted=False, reg_w_l2=0.01,
                          block_rows=br)
        assert abs(float(a(qx, Wt, Tt)) - float(b(jx, Wj, Tj))) < 1e-8
    # one HER step over the kernel sweep
    cfg = SweepConfig(k=k, **PHASE)
    jcfg = JaxSweepConfig(k=k, **PHASE)
    sw = make_dense_phase_sweep(cfg)
    step = make_her_step(lambda X, W, T: sw(X, W, T), make_residual_obj(cfg))
    jstep = jax_her_step(make_dense_phase_sweep_pallas(jcfg, interpret=True),
                         jax_residual_obj(jcfg))
    inf = torch.tensor(float('inf'), dtype=torch.float64)
    beta = torch.tensor(0.5, dtype=torch.float32)
    got = step(qx, Wt, Tt, Wt, Tt, Wt, Tt, inf, beta, inf)
    key = jax.random.PRNGKey(0)
    rl = jnp.asarray(0, jnp.int32)
    e = jnp.asarray(np.inf, jnp.float64)
    # beta is float32 in both packages' nmf()
    want = jstep(jx, Wj, Tj, Wj, Tj, Wj, Tj, e, jnp.asarray(0.5, jnp.float32),
                 e, key, rl, key)
    for a, b in zip(got[:6], want[:6]):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=1e-11)


# ---------------------------------------------------------------------------
# nmf()
# ---------------------------------------------------------------------------

def _same(a, b, tol=1e-8):
    assert np.allclose(_np(a['W']), np.asarray(b['W']), rtol=0, atol=tol)
    assert np.allclose(_np(a['T']), np.asarray(b['T']), rtol=0, atol=tol)
    if 'obj_history' in b:
        assert np.allclose(a['obj_history'], b['obj_history'], rtol=tol,
                           atol=0)


@pytest.mark.parametrize('kw', [
    dict(),
    dict(project_T_each_iter=True, t_row_sum=1.0, w_row_sum=1.0),
    dict(inner_reps=2, reg_t_l2=0.05),
    dict(accel='her'),
])
def test_x_dtype_int16_fit_matches_jax(kw):
    X = _problem()
    run = dict(PHASE, max_iter=8, compute_obj_each_iter=True,
               random_state=0, **kw)
    a = torch_nmf(X, 6, x_dtype='int16', device='cpu', **run)
    b = jax_nmf(X, 6, x_dtype='int16', **run)
    _same(a, b)
    assert a['W'].dtype == torch.float64
    if 'accel' not in kw:
        assert np.all(np.diff(a['obj_history']) <= 1e-9)
    # ~2e-5 storage noise: the dense fit's final objective within 2e-3
    d = torch_nmf(X, 6, device='cpu', **run)
    assert abs(a['obj_history'][-1] - d['obj_history'][-1]) \
        <= 5e-3 * abs(d['obj_history'][-1])


def test_quantized_input_smart_random_warm_start_and_pickle():
    X = _problem()
    jx, qx = _pair(X)
    run = dict(PHASE, max_iter=5, compute_obj_each_iter=True,
               random_state=0, init='smart_random')
    a = torch_nmf(qx, 5, **run)
    b = jax_nmf(jx, 5, **run)
    _same(a, b)
    assert np.all(np.diff(a['obj_history']) <= 1e-9)
    r2 = torch_nmf(qx, 5, W_in=a['W'], T_in=a['T'],
                   **dict(run, init=None, max_iter=3))
    assert r2['obj_history'][-1] <= a['obj_history'][-1] + 1e-9
    oc = a['obj_calculator']
    v = oc.true_objective()
    oc2 = pickle.loads(pickle.dumps(oc))
    assert isinstance(pickle.loads(pickle.dumps(oc)).X, tuple)
    assert abs(oc2.true_objective() - v) < 1e-8 * abs(v)
    assert abs(v - b['obj_calculator'].true_objective()) < 1e-8 * abs(v)


def test_quantized_input_diagnostics_see_the_dequantized_matrix():
    X = _problem()
    _, qx = _pair(X)
    seen = []

    def diag(Xc, W, T):
        seen.append(Xc)
        return float(((Xc - W @ T) ** 2).sum())

    r = torch_nmf(qx, 4, init='random', max_iter=2, random_state=0,
                  diagnostics=[diag], **PHASE)
    assert len(r['diagnostics']['diag']) == 3
    assert torch.equal(seen[0], tq.dequantize_x(qx))


def test_gating_errors_are_jax_s():
    X = _problem()
    for kw, match in (
            (dict(max_iter=2), 'phase'),              # the interleaved default
            (dict(W_mat=(X > 1).astype(float), **PHASE), 'dense unmasked'),
            (dict(dtype=torch.float16, **PHASE), 'float32/float64'),
            (dict(sparse=True, **PHASE), 'sparse'),
    ):
        with pytest.raises(ValueError, match=match):
            torch_nmf(X, 4, x_dtype='int16', device='cpu', **kw)
        with pytest.raises(ValueError, match=match):
            jax_nmf(X, 4, x_dtype='int16',
                    **{k: (jnp.float16 if v is torch.float16 else v)
                       for k, v in kw.items()})
    with pytest.raises(ValueError, match='nonnegative'):
        torch_nmf(X - 10.0, 4, x_dtype='int16', device='cpu', **PHASE)
    _, qx = _pair(X)
    with pytest.raises(ValueError, match='w_row'):
        torch_nmf(qx, 4, w_row=np.ones(96), **PHASE)
    with pytest.raises(ValueError, match='coherence_pmi'):
        torch_nmf(qx, 4, init='coherence_pmi', **PHASE)


def test_w_row_with_int16_dense_input_matches_jax():
    rng = np.random.RandomState(0)
    X = np.abs(rng.rand(48, 40))
    wr = rng.rand(48) * 0.9 + 0.1
    kw = dict(max_iter=5, random_state=0, compute_obj_each_iter=True, **PHASE)
    a = torch_nmf(X, 4, w_row=wr, x_dtype='int16', device='cpu', **kw)
    b = jax_nmf(X, 4, w_row=wr, x_dtype='int16', **kw)
    _same(a, b)
    c = torch_nmf(X, 4, w_row=wr, device='cpu', **kw)
    gap = abs(a['obj_history'][-1] - c['obj_history'][-1]) \
        / abs(c['obj_history'][-1])
    assert gap < 1e-5


# ---------------------------------------------------------------------------
# the init on the code
# ---------------------------------------------------------------------------

def test_init_on_the_code_matches_the_dequantized_matrix():
    X = _problem(n=150, d=100)
    jx, qx = _pair(X)
    Xdq = tq.dequantize_x(qx)
    for init, tol in (('nndsvd', 1e-8), ('nndsvda', 1e-7),
                      ('smart_random', 1e-7), ('nndsvd_lrc', 1e-8)):
        Wq, Hq = ti.initialize_nmf(qx, 8, init, random_state=0,
                                   svd_backend='torch')
        Wd, Hd = ti.initialize_nmf(Xdq, 8, init, random_state=0,
                                   svd_backend='torch')
        assert Wq.device == qx.device and Wq.dtype == torch.float64
        np.testing.assert_allclose(_np(Wq), _np(Wd), atol=tol)
        np.testing.assert_allclose(_np(Hq), _np(Hd), atol=tol)
    with pytest.raises(ValueError, match="svd_backend='torch'"):
        ti.initialize_nmf(qx, 8, 'nndsvd')
    # the device SVD on the code against JAX's, given JAX's test matrix
    p = 18
    omega = jax.random.normal(jax.random.PRNGKey(3), (100, p),
                              dtype=jnp.float64)
    Sj = jax.jit(jq_svd, static_argnums=1)(jx, 8, jax.random.PRNGKey(3))[1]
    St = ti.randomized_svd_torch(qx, 8, omega=torch.as_tensor(
        np.array(omega)))[1]
    np.testing.assert_allclose(_np(St), np.asarray(Sj), rtol=1e-10)


def jq_svd(X, k, key):
    from rri_nmf_tpu.initialization import randomized_svd_jax
    return randomized_svd_jax(X, k, key)


def test_16_bit_x_svd_computes_in_float32():
    """The device SVD on a bf16-stored X runs in float32: the same
    values as the float32 copy, and no dead topic."""
    X = _problem(n=200, d=120)
    Xb = torch.as_tensor(X).to(torch.bfloat16)
    Xf = Xb.to(torch.float32)
    g = torch.Generator().manual_seed(0)
    omega = torch.randn(120, 26, generator=g)
    Ub, Sb, Vb = ti.randomized_svd_torch(Xb, 16, omega=omega)
    Uf, Sf, Vf = ti.randomized_svd_torch(Xf, 16, omega=omega)
    assert Ub.dtype == torch.float32
    np.testing.assert_allclose(_np(Sb), _np(Sf), rtol=1e-5)
    Wb, Hb = ti.initialize_nmf(Xb, 16, 'nndsvd', random_state=0,
                               svd_backend='torch', dtype=torch.float32)
    assert int(((Wb.sum(0) == 0) | (Hb.sum(1) == 0)).sum()) == 0


# ---------------------------------------------------------------------------
# randomized draws (tests/test_quantized.py::quantized_draw, one device)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('seed', range(6))
def test_quantized_draws(seed):
    rng = np.random.RandomState(seed)
    n = int(rng.randint(24, 90))
    d = int(rng.randint(20, 80))
    k = int(rng.randint(2, 7))
    scale = float(10.0 ** rng.uniform(-2, 3))
    X = np.abs(rng.rand(n, k) @ rng.rand(k, d)
               + 0.01 * rng.rand(n, d)) * scale
    kw = dict(PHASE, max_iter=int(rng.randint(3, 8)), random_state=seed,
              compute_obj_each_iter=True, eps_stop=0, device='cpu')
    if rng.rand() < 0.4:
        kw['reg_t_l2'] = float(rng.rand() * 0.1)
    if rng.rand() < 0.3:
        kw['reg_w_l1'] = float(rng.rand() * 0.01)
    if rng.rand() < 0.4:
        kw['inner_reps'] = int(rng.randint(2, 4))
    if rng.rand() < 0.3:
        kw['project_T_each_iter'] = True
        kw['t_row_sum'] = 1.0
    if rng.rand() < 0.25:
        kw['accel'] = 'her'
    rng.rand()                                # the mesh draw of the JAX suite
    qx = tq.quantize_x(X, device='cpu')
    Xdq = _np(tq.dequantize_x(qx))
    if rng.rand() < 0.5:
        sol_q = torch_nmf(qx, k, **kw)
    else:
        sol_q = torch_nmf(Xdq, k, x_dtype='int16', **kw)
    sol_d = torch_nmf(Xdq, k, **kw)
    assert sol_q['W'].dtype == torch.float64
    oh = np.asarray(sol_q['obj_history'])
    assert np.all(np.isfinite(oh))
    if 'accel' not in kw:
        assert np.all(np.diff(oh) <= 1e-10 * max(1.0, abs(oh[0])))
    gap = abs(oh[-1] - sol_d['obj_history'][-1])
    assert gap <= 1e-9 * max(1.0, abs(sol_d['obj_history'][-1]))
    np.testing.assert_allclose(_np(sol_q['W']), _np(sol_d['W']),
                               atol=1e-8 * max(1.0, scale), rtol=1e-7)
