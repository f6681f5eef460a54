"""The port's 16-bit storage against the JAX package, on the CPU.

- 16-bit factors (``dtype=torch.bfloat16``/``float16``): each kernel's
  plain twin (B1, B2, B3, B4) against JAX's Pallas kernel in interpret
  mode on the same 16-bit inputs, within one ulp of the storage type
  elementwise (float32 work, rounded once at JAX's points); the fits of
  ``tests/test_bfloat16.py`` held to the JAX suite's bounds: histories
  non-increasing within 1e-3·obj₀ + 1e-6, and the kernel sweep against
  the plain one within 0.02.
- Mixed storage (``x_dtype='bfloat16'`` beside float32 or float64
  factors): the kernel sweep against JAX's in interpret mode (the factor
  cast down to the bfloat16 X, products summed in the accumulator
  dtype), ``nmf()`` with HER against JAX's at 1e-8, the auto-densified
  sparse X and the refusal in the sparse modes.
- ``cuda``-marked: each kernel's 16-bit build against its twin, in
  bfloat16 and float16, repeated bit for bit (skipped without a card);
  the gather kernel's also bit for bit the float32 NumPy mirror of its
  decomposition (``ops/sparse_mirror.kernel_mirror``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from rri_nmf_tpu.nmf import nmf as jax_nmf
from rri_nmf_tpu.ops import dense_pallas as jdp
from rri_nmf_tpu.ops import sweep_pallas as jsp
from rri_nmf_tpu.ops.sweep_xla import SweepConfig as JaxSweepConfig
from rri_nmf_tpu.ops.sweep_xla import make_sweep as jax_make_sweep
from rri_nmf_tpu_torch.nmf import nmf
from rri_nmf_tpu_torch.ops import dense_kernels as dk
from rri_nmf_tpu_torch.ops import masked_kernels as mk
from rri_nmf_tpu_torch.ops import sparse_kernels as sk
from rri_nmf_tpu_torch.ops import sparse_mirror
from rri_nmf_tpu_torch.ops import sparse_plan as spl
from rri_nmf_tpu_torch.ops.sweep import SweepConfig, make_objective

torch.set_num_threads(2)
PHASE = dict(update_order='phase', reset_topic_method=None)
DTYPES = [(torch.bfloat16, jnp.bfloat16), (torch.float16, jnp.float16)]
INF = float('inf')


def _problem(n=48, d=32, k=4, seed=0):
    rng = np.random.RandomState(seed)
    return np.abs(rng.rand(n, k) @ rng.rand(k, d) + 0.01 * rng.rand(n, d))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float64).cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def ulp(a, dtype):
    """One unit in the last place of |a| in the 16-bit ``dtype``."""
    mant, tiny = (7, 2.0 ** -126) if dtype == torch.bfloat16 \
        else (10, 2.0 ** -14)
    e = np.floor(np.log2(np.maximum(np.abs(a), tiny)))
    return 2.0 ** (e - mant)


def within_one_ulp(got, want, dtype, floor=0.0, got32=None, want32=None):
    """Elementwise within one ulp of the storage type, or within
    ``floor`` (float32 rounding of the work, where an entry comes out of a
    cancellation). ``got32``/``want32``: the float32 build's and twin's
    outputs on the same inputs upcast, whose difference at each entry is
    added to its ulp (the 16-bit forms work in float32 as those do)."""
    got, want = _np(got), _np(want)
    worst = np.maximum(np.abs(got), np.abs(want))
    one = ulp(worst, dtype)
    if got32 is not None:
        one = one + np.abs(_np(got32) - _np(want32))
    return bool(np.all(np.abs(got - want) <= np.maximum(one, floor)))


def non_increasing(oh):
    oh = np.asarray(oh, dtype=float)
    return bool(np.all(np.diff(oh) <= 1e-3 * oh[0] + 1e-6))


# ---------------------------------------------------------------------------
# the twins against the Pallas kernels (interpret mode), 16-bit inputs
# ---------------------------------------------------------------------------

def _gs_inputs(k, m, seed, dt):
    rng = np.random.RandomState(seed)
    A = rng.rand(3 * k, k)
    G = (A.T @ A).astype(np.float32)
    N = (rng.rand(k, m) * 3 * k).astype(np.float32)
    N[1] -= 2 * k                                # a clamped topic
    F = torch.as_tensor(rng.rand(k, m)).to(dt)
    return torch.as_tensor(G), torch.as_tensor(N), F


@pytest.mark.parametrize('dt,jdt', DTYPES)
@pytest.mark.parametrize('kw', [dict(l1=0.0, l2=0.0, bound=INF),
                                dict(l1=0.05, l2=0.1, bound=1.0, reps=2)])
def test_b1_twin_matches_the_pallas_kernel(dt, jdt, kw):
    k, m = 6, 256
    G, N, F = _gs_inputs(k, m, 1, dt)
    got = dk.gs_update_ref(G, N, F, kw['l1'], kw['l2'], kw['bound'],
                           reps=kw.get('reps', 1))
    want = jdp._gs_call(k, 128, 2, kw['l1'], kw['l2'], kw['bound'],
                        jnp.float32, jdt, jnp.asarray(G.numpy()),
                        jnp.asarray(np.diag(G.numpy()).reshape(k, 1)),
                        jnp.asarray(N.numpy()),
                        jnp.asarray(F.float().numpy(), jdt), interpret=True,
                        reps=kw.get('reps', 1))
    assert got.dtype == dt and want.dtype == jdt
    assert within_one_ulp(got, want, dt)
    # the concave branch takes the bound: a topic with no curvature
    G2 = G.clone()
    G2[2, 2] = -1.0
    got = dk.gs_update_ref(G2, N, F, 0.0, 0.0, 1.0)
    assert torch.all(got[2] == 1.0) or torch.all((got[2] == 0)
                                                 | (got[2] == 1.0))


@pytest.mark.parametrize('dt,jdt', DTYPES)
def test_b2_twin_matches_the_pallas_kernel(dt, jdt):
    k, d = 5, 300
    rng = np.random.RandomState(2)
    A = rng.rand(20, k)
    G = torch.as_tensor((A.T @ A).astype(np.float32))
    N = torch.as_tensor((rng.rand(k, d) * 4).astype(np.float32))
    F = torch.as_tensor(rng.rand(k, d) / d).to(dt)
    for l1, l2, reps in ((0.0, 0.0, 1), (0.01, 0.2, 2)):
        got = dk.tm_proj_update_ref(G, N, F, l1, l2, 1.0, reps=reps)
        want = jdp._tm_proj_call(
            k, d, d, l1, l2, 1.0, jnp.float32, jdt, jnp.asarray(G.numpy()),
            jnp.asarray(np.diag(G.numpy()).reshape(k, 1)),
            jnp.asarray(N.numpy()), jnp.asarray(F.float().numpy(), jdt),
            interpret=True, reps=reps)
        assert got.dtype == dt
        # an entry v - tau of a projected row is a cancellation: both
        # thresholds tau are float32 sums over the row in other orders
        assert within_one_ulp(got, want, dt, floor=1e-6)
        assert np.allclose(_np(got).sum(1), 1.0, atol=d * ulp(1.0, dt))


def _masked_inputs(n, d, dt, seed=3, exact=False):
    """R, M and the four vectors of B3/B4 in ``dt``. ``exact``: values on
    a 1/64 grid, so every product and sum of the rank-one updates is
    exact in 16 bits (JAX's interpret mode on the CPU rounds a fused
    float16 chain once, the port each op as the program states; on exact
    values the two agree)."""
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.as_tensor(a).to(dt)
    if exact:
        def v(*shape):
            return rng.randint(1, 9, shape) / 8.0
        R = rng.randint(-16, 17, (n, d)) / 16.0
    else:
        def v(*shape):
            return rng.rand(*shape)
        R = rng.randn(n, d)
    M = (rng.rand(n, d) < 0.5).astype(float)
    return t(R), t(M), t(v(n)), t(v(n)), t(v(d)), t(v(d))


@pytest.mark.parametrize('dt,jdt', DTYPES)
def test_b3_b4_twins_match_the_pallas_kernels(dt, jdt):
    n, d = 128, 256
    R, M, w, w2, ta, tb = _masked_inputs(n, d, dt, exact=True)

    def j(a):
        return jnp.asarray(a.float().numpy(), jdt)
    Ra = R.clone()
    sums = mk.phase_a_ref(Ra, M, w2, ta, w)
    Rj, wR0, nw = jsp._phase_a(j(R), j(M), j(w2), j(ta), j(w), True,
                               bn=64, bd=128)
    assert Ra.dtype == dt and sums[0].dtype == torch.float32
    assert np.array_equal(_np(Ra), np.asarray(Rj, float))
    for a, b in zip(sums, (wR0, nw)):
        scale = float(np.abs(np.asarray(b, float)).max())
        assert np.allclose(_np(a), np.asarray(b, float).ravel(), rtol=0,
                           atol=1e-6 * scale)
    Rb = R.clone()
    sums = mk.phase_b_ref(Rb, M, w, w2, ta, tb)
    Rj, Rt, mt2 = jsp._phase_b(j(R), j(M), j(w), j(w2), j(ta), j(tb), True,
                               bn=64, bd=128)
    assert np.array_equal(_np(Rb), np.asarray(Rj, float))
    for a, b in zip(sums, (Rt, mt2)):
        scale = float(np.abs(np.asarray(b, float)).max())
        assert np.allclose(_np(a), np.asarray(b, float).ravel(), rtol=0,
                           atol=1e-6 * scale)
    # on any values each product and sum rounds to 16 bits on its own
    R, M, w, w2, ta, tb = _masked_inputs(n, d, dt)
    Ra = R.clone()
    mk.phase_a_ref(Ra, M, w2, ta, w)
    step = (w2.float()[:, None] * ta.float()[None, :]).to(dt).float()
    assert torch.equal(Ra, (R.float() + step).to(dt))


# JAX's B3/B4 kernels in interpret mode, in a process whose XLA keeps
# every rounding the program states (no excess precision): inputs and
# outputs through an .npz file, the 16-bit values as float32.
_STRICT_KERNELS = """
import sys
import numpy as np
import jax
jax.config.update('jax_platforms', 'cpu')
import jax.numpy as jnp
from rri_nmf_tpu.ops import sweep_pallas as jsp
a = dict(np.load(sys.argv[1]))
j = {k: jnp.asarray(v, getattr(jnp, sys.argv[3])) for k, v in a.items()}
A = jsp._phase_a(j['R'], j['M'], j['w2'], j['ta'], j['w'], True, bn=64, bd=128)
B = jsp._phase_b(j['R'], j['M'], j['w'], j['w2'], j['ta'], j['tb'], True,
                 bn=64, bd=128)
np.savez(sys.argv[2], **{'%s%d' % (p, i): np.asarray(x, np.float32)
                         for p, out in (('a', A), ('b', B))
                         for i, x in enumerate(out)})
"""


def _strict_jax_kernels(tmp_path, jdt, **inputs):
    """JAX's ``_phase_a``/``_phase_b`` (interpret mode) on ``inputs``
    under ``--xla_allow_excess_precision=false``: ``((R, wR0, nw), (R,
    Rt, mt2))`` as float32 arrays."""
    import os
    import subprocess
    import sys
    src, dst = tmp_path / 'in.npz', tmp_path / 'out.npz'
    np.savez(src, **{k: v.float().numpy() for k, v in inputs.items()})
    env = dict(os.environ, JAX_PLATFORMS='cpu', XLA_FLAGS=(
        os.environ.get('XLA_FLAGS', '')
        + ' --xla_allow_excess_precision=false').strip())
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, '-c', _STRICT_KERNELS, str(src),
                    str(dst), jnp.dtype(jdt).name], check=True, env=env,
                   cwd=root, timeout=600)
    out = np.load(dst)
    return tuple(tuple(out['%s%d' % (p, i)] for i in range(3)) for p in 'ab')


@pytest.mark.parametrize('dt,jdt', DTYPES)
def test_b3_b4_twins_round_at_jax_points_on_general_values(tmp_path, dt,
                                                           jdt):
    """On general values (no grid), the twins against the kernel bodies
    of ``_phase_a_kernel``/``_phase_b_kernel`` as eager ``jnp`` chains, in
    which every op rounds to the storage type: R bit for bit, the float32
    sums at float32 rounding. In bfloat16 also against JAX's Pallas
    kernels in interpret mode with XLA's excess precision off, which
    round at the same points (with it on, the CPU keeps ``w * w`` in
    float32). In float16 the CPU compiles the kernel's fused chain with
    one rounding either way, so there the chain stands for the kernel."""
    n, d = 128, 256
    R, M, w, w2, ta, tb = _masked_inputs(n, d, dt, seed=7)
    f32 = jnp.float32

    def j(a):
        return jnp.asarray(a.float().numpy(), jdt)

    def close(a, b):
        b = np.asarray(b, float).ravel()
        return np.allclose(_np(a), b, rtol=0, atol=2e-6 * np.abs(b).max())
    Rj = j(R) + j(w2)[:, None] * j(ta)[None, :]
    MR = j(M) * Rj
    want_a = (Rj, j(w).astype(f32) @ MR.astype(f32),
              (j(w) * j(w)).astype(f32) @ j(M).astype(f32))
    Rj = (j(R) + j(w)[:, None] * j(ta)[None, :]
          - j(w2)[:, None] * j(tb)[None, :])
    want_b = (Rj, (j(M) * Rj).astype(f32) @ j(tb).astype(f32),
              j(M).astype(f32) @ (j(tb) * j(tb)).astype(f32))
    wants = [want_a, want_b]
    if dt == torch.bfloat16:
        wants += _strict_jax_kernels(tmp_path, jdt, R=R, M=M, w=w, w2=w2,
                                     ta=ta, tb=tb)
    for i, want in enumerate(wants):
        twin, args = ((mk.phase_a_ref, (w2, ta, w)) if i % 2 == 0 else
                      (mk.phase_b_ref, (w, w2, ta, tb)))
        Rt = R.clone()
        sums = twin(Rt, M, *args)
        assert np.array_equal(_np(Rt), np.asarray(want[0], float))
        assert all(close(a, b) for a, b in zip(sums, want[1:]))


# ---------------------------------------------------------------------------
# the fits (tests/test_bfloat16.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('order', [{}, PHASE])
def test_bf16_dense_monotone_and_converges(order):
    X = _problem()
    kw = dict(dict(max_iter=12, random_state=0, early_stop=False,
                   compute_obj_each_iter=True, reset_topic_method=None),
              **order)
    b16 = nmf(X, 4, dtype=torch.bfloat16, device='cpu', **kw)
    f64 = nmf(X, 4, device='cpu', **kw)
    oh = np.asarray(b16['obj_history'], dtype=float)
    assert non_increasing(oh)
    assert oh[-1] <= f64['obj_history'][-1] * 1.1 + 1e-6
    assert b16['W'].dtype == b16['T'].dtype == torch.bfloat16
    # JAX's bf16 fit of the same route: the kernel sweep in interpret
    # mode for the phase recipe, its plain sweep for the interleaved one
    j = jax_nmf(X, 4, dtype=jnp.bfloat16, **kw, **(
        dict(use_pallas='interpret') if order else {}))
    assert np.abs(_np(b16['W']) - np.asarray(j['W'], float)).max() < 0.02
    assert np.abs(_np(b16['T']) - np.asarray(j['T'], float)).max() < 0.02


@pytest.mark.parametrize('use_pallas', [None, True])
def test_bf16_masked_descends(use_pallas):
    """The masked sweep under 16-bit storage (float32 sums) keeps the
    float32-evaluated objective decreasing: B3/B4's twins with
    ``use_pallas=True``, the plain masked sweep by default (JAX's rule)."""
    X = _problem(seed=4)
    M = (np.random.RandomState(5).rand(*X.shape) < 0.6).astype(float)
    kw = dict(max_iter=6, random_state=0, reset_topic_method=None,
              t_row_sum=1.0, compute_obj_each_iter=True, early_stop=False)
    before = dict(mk.LAUNCHES)
    calls = []
    real = mk.phase_a_ref

    def counted(*args):
        calls.append(1)
        return real(*args)
    mk.phase_a_ref = counted
    try:
        soln = nmf(X, 3, W_mat=M, dtype=torch.bfloat16, device='cpu',
                   use_pallas=use_pallas, **kw)
    finally:
        mk.phase_a_ref = real
    assert mk.LAUNCHES == before
    assert bool(calls) == (use_pallas is True)
    oh = np.asarray(soln['obj_history'], dtype=float)
    assert np.all(np.isfinite(oh)) and oh[-1] < oh[0]
    assert non_increasing(oh)
    assert soln['W'].dtype == torch.bfloat16


def test_bf16_masked_sweep_matches_jax_pallas_sweep():
    """One masked kernel sweep in bfloat16 against JAX's two masked
    sweeps (Pallas in interpret mode, and XLA) on the same inputs. In
    bfloat16 their threshold decisions part equally valid trajectories:
    here JAX's own two differ by 0.19 in W after one sweep and by 1% in
    the objective, so the objective is what is held: the port's within 2%
    of each, and in float32 the factors within 1e-5."""
    from rri_nmf_tpu.ops.sweep_pallas import make_masked_sweep_pallas
    from rri_nmf_tpu.ops.sweep_xla import make_objective as jax_objective
    X = _problem(seed=4).astype(np.float32)
    M = (np.random.RandomState(5).rand(*X.shape) < 0.6).astype(np.float32)
    rng = np.random.RandomState(6)
    W = np.abs(rng.rand(X.shape[0], 3))
    T = np.abs(rng.rand(3, X.shape[1]))
    jcfg = JaxSweepConfig(k=3, masked=True, reset_topic_method=None,
                          t_row_sum=1.0)
    key = jax.random.PRNGKey(0)
    r = jnp.asarray(0, jnp.int32)
    jobj = jax_objective(masked=True, row_weighted=False)
    obj = make_objective(masked=True)
    sw = mk.make_masked_sweep(SweepConfig(k=3, masked=True,
                                          reset_topic_method=None,
                                          t_row_sum=1.0))
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        def j(a):
            return jnp.asarray(a, jdt)

        def t(a):
            return torch.as_tensor(a).to(dt)
        wants = [f(j(X), j(W), j(T), key, r, key, j(M))[:2] for f in (
            make_masked_sweep_pallas(jcfg, interpret=True),
            jax_make_sweep(jcfg))]
        Wt, Tt, _ = sw(t(X), t(W), t(T), t(M), None, 0)
        assert Wt.dtype == Tt.dtype == dt
        e = float(obj(t(X), Wt, Tt, t(M)))
        assert e < 0.1 * float(obj(t(X), t(W), t(T), t(M)))
        for Wj, Tj in wants:
            ej = float(jobj(j(X), Wj, Tj, j(M)))
            assert abs(e - ej) <= 0.02 * ej
            if dt == torch.float32:
                assert np.abs(_np(Wt) - np.asarray(Wj, float)).max() < 1e-5
                assert np.abs(_np(Tt) - np.asarray(Tj, float)).max() < 1e-5


def test_16_bit_simplex_projection_of_a_large_entry():
    """A 16-bit row whose largest entry absorbs the sum s in rounding
    (512 - 1 == 512 in bfloat16) has no threshold index; it projects to
    zeros, finite, as JAX's projection does (its index -1 wraps to a
    zero-size support), instead of indexing past the row. In float32 the
    same row goes to the vertex."""
    from rri_nmf_tpu_torch.matrixops import _proj_simplex_core
    V = torch.tensor([[512.0, 3.0, 1.0], [0.2, 0.3, 0.1]])
    want = {torch.bfloat16: [0.0, 0.0, 0.0], torch.float32: [1.0, 0.0, 0.0]}
    for dt, row in want.items():
        got = _proj_simplex_core(V.to(dt), 1.0)
        assert torch.equal(got[0].float(), torch.tensor(row))
        assert abs(float(got[1].float().sum()) - 1.0) < 1e-2


def test_bf16_masked_runs():
    X = _problem(seed=1)
    M = (np.random.RandomState(2).rand(*X.shape) < 0.6).astype(float)
    soln = nmf(X, 3, W_mat=M, dtype=torch.bfloat16, max_iter=6,
               random_state=0, reset_topic_method=None, t_row_sum=1.0,
               compute_obj_each_iter=True, early_stop=False, device='cpu')
    oh = np.asarray(soln['obj_history'], dtype=float)
    assert np.all(np.isfinite(oh)) and oh[-1] < oh[0]


@pytest.mark.parametrize('sparse', [True, 'mxu', 'dma'])
def test_bf16_sparse_fit_descends(sparse):
    """16-bit factors through the sparse sweep: the gather kernel's twin
    (or torch.sparse) reads 16-bit values, sums in float32."""
    X = _problem(n=64, d=48)
    X = sps.csr_matrix(X * (np.random.RandomState(3).rand(*X.shape) < 0.5))
    soln = nmf(X, 3, sparse=sparse, dtype=torch.bfloat16, max_iter=8,
               random_state=0, compute_obj_each_iter=True, early_stop=False,
               device='cpu', **PHASE)
    oh = np.asarray(soln['obj_history'], dtype=float)
    assert soln['W'].dtype == torch.bfloat16
    assert np.all(np.isfinite(oh)) and non_increasing(oh) and oh[-1] < oh[0]
    dense = nmf(X.toarray(), 3, max_iter=8, random_state=0, device='cpu',
                compute_obj_each_iter=True, early_stop=False, **PHASE)
    assert oh[-1] <= dense['obj_history'][-1] * 1.1 + 1e-6


# ---------------------------------------------------------------------------
# mixed storage: a bfloat16 X beside wider factors
# ---------------------------------------------------------------------------

def test_mixed_x_dtype_dense_monotone_and_close_to_f32():
    X = _problem()
    kw = dict(max_iter=12, random_state=0, early_stop=False,
              compute_obj_each_iter=True, dtype='float32', device='cpu',
              **PHASE)
    mix = nmf(X, 4, x_dtype='bfloat16', **kw)
    f32 = nmf(X, 4, **kw)
    oh = np.asarray(mix['obj_history'], dtype=float)
    assert non_increasing(oh)
    assert oh[-1] <= f32['obj_history'][-1] * 1.05 + 1e-6
    assert mix['W'].dtype == mix['T'].dtype == torch.float32
    assert float((mix['W'] - f32['W']).abs().max()) < 0.05


def test_mixed_x_dtype_interleaved_resets_run():
    X = _problem(seed=3)
    rng = np.random.RandomState(7)
    W0 = np.abs(rng.rand(X.shape[0], 4))
    T0 = np.abs(rng.rand(4, X.shape[1]))
    W0[:, 2] = 0.0
    T0[2] = 0.0
    soln = nmf(X, 4, x_dtype='bfloat16', dtype='float32', W_in=W0, T_in=T0,
               max_iter=5, random_state=0,
               reset_topic_method='max_resid_document',
               compute_obj_each_iter=True, early_stop=False, device='cpu')
    oh = np.asarray(soln['obj_history'], dtype=float)
    assert np.all(np.isfinite(oh))
    assert soln['n_resets_remaining'] < 23
    assert float(soln['T'][2].sum()) > 1e-10


@pytest.mark.parametrize('shape', [(140, 100, 5), (64, 96, 3)])
def test_mixed_x_dtype_dense_kernel_sweep_single_device(shape):
    """The kernel sweep on a bfloat16 X with float32 factors: JAX's kernel
    sweep (interpret mode) on the same inputs, where both cast the factor
    down to bfloat16 and sum in float32, within float32 rounding; JAX's
    plain sweep (which promotes instead) within the JAX suite's 0.02."""
    n, d, k = shape
    rng = np.random.RandomState(8)
    Xb = torch.as_tensor(rng.rand(n, d)).to(torch.bfloat16)
    W0 = np.abs(rng.rand(n, k)).astype(np.float32)
    T0 = np.abs(rng.rand(k, d)).astype(np.float32)
    cfg = dict(k=k, reset_topic_method=None, update_order='phase')
    Wt, Tt = dk.make_dense_phase_sweep(SweepConfig(**cfg))(
        Xb, torch.as_tensor(W0), torch.as_tensor(T0))
    key = jax.random.PRNGKey(0)
    rl = jnp.asarray(0, jnp.int32)
    Xj = jnp.asarray(Xb.float().numpy(), jnp.bfloat16)
    Wp, Tp, _, _ = jdp.make_dense_phase_sweep_pallas(
        JaxSweepConfig(**cfg), interpret=True)(Xj, jnp.asarray(W0),
                                               jnp.asarray(T0), key, rl, key)
    Wx, Tx, _, _ = jax_make_sweep(JaxSweepConfig(**cfg))(
        Xj, jnp.asarray(W0), jnp.asarray(T0), key, rl, key)
    assert Wt.dtype == Tt.dtype == torch.float32
    np.testing.assert_allclose(_np(Wt), np.asarray(Wp), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(Tt), np.asarray(Tp), rtol=1e-4, atol=1e-5)
    assert np.allclose(_np(Wt), np.asarray(Wx), atol=0.02)
    assert np.allclose(_np(Tt), np.asarray(Tx), atol=0.02)


@pytest.mark.parametrize('kw', [dict(), dict(accel='her'),
                                dict(matmul_precision='highest')])
def test_mixed_x_dtype_fit_matches_jax(kw):
    """nmf(x_dtype='bfloat16') with float64 factors (the accumulator),
    against JAX's kernel route in interpret mode, at 1e-8: the products of
    a bfloat16 X and the bfloat16-cast factor are exact, summed in
    float64. ``matmul_precision`` keeps the factor wide (the promotion).
    Three sweeps: the factor's cast to bfloat16 turns a float64 rounding
    difference into a one-ulp flip now and then, and the two fits part
    ~30x a sweep from there (1e-15, 3e-14, 4e-12, ..., 2e-6 at six)."""
    X = _problem(n=40, d=30)
    run = dict(max_iter=3, random_state=0, compute_obj_each_iter=True,
               x_dtype='bfloat16', **PHASE, **kw)
    a = nmf(X, 3, device='cpu', **run)
    b = jax_nmf(X, 3, use_pallas='interpret', **run)
    assert a['W'].dtype == torch.float64
    np.testing.assert_allclose(_np(a['W']), np.asarray(b['W']), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(_np(a['T']), np.asarray(b['T']), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(a['obj_history'], b['obj_history'], rtol=1e-8)


def test_mixed_x_dtype_sparse_auto_densifies():
    X = _problem()
    Xs = sps.csr_matrix(X * (np.random.RandomState(3).rand(*X.shape) < 0.4))
    soln = nmf(Xs, 3, x_dtype='bfloat16', dtype='float32', max_iter=4,
               random_state=0, device='cpu', **PHASE)
    assert soln['W'].dtype == torch.float32
    assert torch.isfinite(soln['W']).all()
    for fit, kw in ((nmf, dict(device='cpu', dtype=torch.float32)),
                    (jax_nmf, dict(dtype='float32'))):
        with pytest.raises(ValueError, match='x_dtype'):
            fit(Xs, 3, sparse=True, x_dtype='bfloat16', max_iter=2,
                **PHASE, **kw)


# ---------------------------------------------------------------------------
# the 16-bit kernels on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('dt', [torch.bfloat16, torch.float16])
def test_cuda_16_bit_kernels_match_twins(cuda_device, dt):
    dev = cuda_device
    k, m = 16, 3000
    G, N, F = (a.to(dev) for a in _gs_inputs(k, m, 1, dt))
    for run in (lambda f, F: f(G, N, F, 0.0, 0.0, INF),
                lambda f, F: f(G, N, F, 0.05, 0.1, 1.0, reps=2)):
        got, again = run(dk.gs_update, F), run(dk.gs_update, F)
        assert got.dtype == dt and torch.equal(got, again)
        assert within_one_ulp(got, run(dk.gs_update_ref, F), dt,
                              got32=run(dk.gs_update, F.float()),
                              want32=run(dk.gs_update_ref, F.float()))
    F2 = torch.as_tensor(np.random.RandomState(2).rand(k, m) / m,
                         device=dev).to(dt)
    got = dk.tm_proj_update(G, N, F2, 0.0, 0.0, 1.0)
    assert torch.equal(got, dk.tm_proj_update(G, N, F2, 0.0, 0.0, 1.0))
    assert within_one_ulp(
        got, dk.tm_proj_update_ref(G, N, F2, 0.0, 0.0, 1.0), dt,
        got32=dk.tm_proj_update(G, N, F2.float(), 0.0, 0.0, 1.0),
        want32=dk.tm_proj_update_ref(G, N, F2.float(), 0.0, 0.0, 1.0))
    R, M, w, w2, ta, tb = (a.to(dev) for a in _masked_inputs(517, 1030, dt))
    for kernel, twin, args in ((mk.phase_a, mk.phase_a_ref, (w2, ta, w)),
                               (mk.phase_b, mk.phase_b_ref,
                                (w, w2, ta, tb))):
        Rk, Rk2, Rr = R.clone(), R.clone(), R.clone()
        sk_ = kernel(Rk, M, *args)
        sk2 = kernel(Rk2, M, *args)
        sr = twin(Rr, M, *args)
        assert torch.equal(Rk, Rk2) and torch.equal(sk_[0], sk2[0])
        assert within_one_ulp(Rk, Rr, dt)
        for a, b in zip(sk_, sr):
            assert a.dtype == torch.float32
            assert float((a - b).abs().max()) <= 1e-4 * float(
                b.abs().max())
    # the gather kernel: ragged k (rows padded to 16 bytes), k past one
    # slice (200), both directions, a random matrix and Zipf word columns
    # cut between warps; its sums follow the float32 mirror of its
    # decomposition bit for bit
    from test_torch_sparse_layout import MATRICES
    c = sparse_mirror.kernel_constants()
    rng = np.random.RandomState(5)
    for X in (sps.random(700, 500, density=0.03, random_state=4,
                         format='csr'), MATRICES['zipf']()):
        plan = spl.plan_sparse_matrix(X, dt, device=dev)
        for k in (24, 50, 128, 200):
            W = torch.as_tensor(rng.rand(X.shape[0], k), device=dev).to(dt)
            T = torch.as_tensor(rng.rand(k, X.shape[1]), device=dev).to(dt)
            for call, dirn, Ft, ncols in (
                    (lambda: sk.contract_wtx(plan, W), 't_phase', W, plan.d),
                    (lambda: sk.contract_xtt(plan, T), 'w_phase', T.T,
                     plan.n)):
                got = call()
                assert got.dtype == torch.float32
                assert torch.equal(got, call())
                lay = getattr(plan, dirn)
                want = sk.gather_contract_ref(lay, Ft, k, ncols)
                assert float((got - want).abs().max()) <= 1e-5 * float(
                    want.abs().max())
                mirror = sparse_mirror.kernel_mirror(
                    lay, Ft, k, ncols, c['SG_NC'], c['SG_WARPS'],
                    sparse_mirror.slice_groups(k, 2), np.float32)
                assert np.array_equal(got.cpu().numpy(), mirror)
