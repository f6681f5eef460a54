"""The Gram kernel's plain twin (``sparse_kernels.gram_contract_ref``,
behind ``gram_contract`` on the CPU) and its wrapper, in float64.

- Against the dense product ``KR(F)ᵀ·M`` at 1e-13 of the largest entry:
  both directions of the mask plan (Γ over W's rows, Θ over Tᵀ's), the
  k(k+1)/2 unique pairs and panels of 1 and k−1 topics, k in {1, 3, 32,
  33}, on a mask with empty columns and one column holding most
  nonzeros.
- Against JAX's ``'mxu'`` Gram contractions (``_mxu_gram_t``/``_w`` and
  their panel forms, B5 in interpret mode on the materialized rows) at
  ``tests/test_torch_masked_gram.py``'s 1e-8.
- The wrapper's guards (16-bit factors, a factor on another device, a
  panel outside the topics, a short factor) and the routing of the
  ``'mxu'`` backend: Γ/Θ through ``gram_contract``, A/C through
  ``gather_contract``. The kernel itself runs on a card only
  (``test_cuda_gram_contractions_match_twins`` in
  ``tests/test_torch_masked_gram.py``, ``chip_smoke.py`` phase 17).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rri_nmf_tpu.ops.sweep_masked_gram as jmg
from rri_nmf_tpu_torch.ops import sparse_kernels as sk
from rri_nmf_tpu_torch.ops import sweep_masked_gram as mg

# float64 sums of at most ~300 products of numbers below 2: a few ulps
TOL_DENSE = 1e-13
# tests/test_torch_masked_gram.py's TOL (JAX's interpret mode and the twin
# sum in other orders)
TOL_JAX = 1e-8
KS = [1, 3, 32, 33]


def _mask(seed, n=200, d=40, density=0.01):
    """A weighted mask (values in [0.5, 1.5)) and X on it: column 7 and
    row 5 full, columns 0-2 and rows 190-199 empty; column 7 holds most
    of the nonzeros."""
    rng = np.random.RandomState(seed)
    M = (rng.rand(n, d) < density) * (0.5 + rng.rand(n, d))
    M[:, 7] = 0.5 + rng.rand(n)
    M[5, :] = 0.5 + rng.rand(d)
    M[:, :3] = 0.0
    M[190:, :] = 0.0
    assert (M[:, 7] != 0).sum() > (M != 0).sum() / 2
    X = rng.rand(n, d) * (M != 0)
    return X, M


def _factors(seed, n, d, k):
    rng = np.random.RandomState(seed)
    return rng.rand(n, k), rng.rand(k, d)


def _panels(k):
    """(t0, p): the last topic alone, and k - 1 topics from 0 and 1."""
    return [(k - 1, 1)] + ([(0, k - 1), (1, k - 1)] if k > 1 else [])


def _pairs(k, panel):
    if panel is None:
        return np.triu_indices(k)
    t0, p = panel
    r = np.arange(p * k)
    return t0 + r // k, r % k


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


@pytest.fixture(scope='module')
def problem():
    X, M = _mask(0)
    plan = mg.plan_masked_gram(X, sp.csr_matrix(M), torch.float64,
                               backend='mxu', device='cpu')
    return X, M, plan


@pytest.mark.parametrize('side', ['t', 'w'])
@pytest.mark.parametrize('k,panel', [(k, None) for k in KS]
                         + [(k, pan) for k in KS for pan in _panels(k)])
def test_ref_matches_the_dense_product(problem, k, panel, side):
    """out = KR(F)ᵀ·M (Γ, F = W) or KR(Tᵀ)ᵀ·Mᵀ (Θ) for the pairs of
    ``gram_pairs``, in the dense algebra."""
    X, M, plan = problem
    n, d = M.shape
    W, T = _factors(k, n, d, k)
    F, Mx, pl, ncols = ((W, M, plan.m_t, d) if side == 't'
                        else (T.T, M.T, plan.m_w, n))
    a, b = _pairs(k, panel)
    want = (F[:, a] * F[:, b]).T @ Mx
    got = sk.gram_contract(pl, torch.as_tensor(F), k, panel, ncols)
    assert got.dtype == torch.float64
    assert _rel(got, want) <= TOL_DENSE
    # empty columns of the output are zero
    empty = np.flatnonzero((Mx != 0).sum(0) == 0)
    assert empty.size and not got[:, empty].any()


@pytest.mark.parametrize('k', KS)
def test_pairs_are_the_sweeps_rows(k):
    """``gram_pairs`` is ``_sym_pairs``'s triangle and the panels'
    t-major rows."""
    it, is_, _ = mg._sym_pairs(k)
    a, b = sk.gram_pairs(k)
    assert np.array_equal(a.numpy(), it) and np.array_equal(b.numpy(), is_)
    for t0, p in _panels(k):
        a, b = sk.gram_pairs(k, (t0, p))
        ta, tb = _pairs(k, (t0, p))
        assert np.array_equal(a.numpy(), ta)
        assert np.array_equal(b.numpy(), tb)


@pytest.mark.parametrize('k', KS)
def test_sweep_contractions_match_jax_mxu(k):
    """The port's ``'mxu'`` Gram contractions (the Gram twin for Γ/Θ, the
    gather twin for A/C) against JAX's B5 in interpret mode on the
    materialized rows, whole and in panels, both directions."""
    X, M = _mask(1)
    Mc = sp.csr_matrix(M)
    n, d = M.shape
    W0, T0 = _factors(100 + k, n, d, k)
    jp = jmg.plan_masked_gram(X, Mc, np.float64, backend='mxu')
    pp = mg.plan_masked_gram(X, Mc, torch.float64, backend='mxu',
                             device='cpu')
    W, T = torch.as_tensor(W0), torch.as_tensor(T0)
    acc = torch.float64
    A, G = jmg._mxu_gram_t(jp, jnp.asarray(W0), jnp.float64, True)
    a, g = mg._mxu_gram_t(pp, W, acc)
    assert _rel(a, A) <= TOL_JAX and _rel(mg._unpack(g, k), G) <= TOL_JAX
    C, H = jmg._mxu_gram_w(jp, jnp.asarray(T0), jnp.float64, True)
    c, h = mg._mxu_gram_w(pp, T, acc)
    assert _rel(c, C) <= TOL_JAX and _rel(mg._unpack(h, k), H) <= TOL_JAX
    for t0, p in _panels(k):
        Gp = jmg._mxu_gram_t_panel(jp, jnp.asarray(W0), t0, p, jnp.float64,
                                   True)
        assert _rel(mg._mxu_gram_t_panel(pp, W, t0, p, acc), Gp) <= TOL_JAX
        Hp = jmg._mxu_gram_w_panel(jp, jnp.asarray(T0), t0, p, jnp.float64,
                                   True)
        assert _rel(mg._mxu_gram_w_panel(pp, T, t0, p, acc), Hp) <= TOL_JAX


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16])
def test_guard_16_bit(problem, dtype):
    _, M, plan = problem
    F = torch.rand(M.shape[0], 4, dtype=torch.float64).to(dtype)
    with pytest.raises(ValueError, match='float32 or float64'):
        sk.gram_contract(plan.m_t, F, 4, None, M.shape[1])


def test_guard_device_mismatch(problem):
    _, M, plan = problem
    F = torch.empty(M.shape[0], 4, dtype=torch.float64, device='meta')
    with pytest.raises(ValueError, match='the plan is on cpu'):
        sk.gram_contract(plan.m_t, F, 4, None, M.shape[1])


@pytest.mark.parametrize('panel', [(-1, 1), (0, 0), (3, 2), (0, 5)])
def test_guard_bad_pairs(problem, panel):
    _, M, plan = problem
    F = torch.rand(M.shape[0], 4, dtype=torch.float64)
    with pytest.raises(ValueError, match='panel'):
        sk.gram_contract(plan.m_t, F, 4, panel, M.shape[1])


def test_guard_short_factor(problem):
    _, M, plan = problem
    with pytest.raises(ValueError, match='Ft must be'):
        sk.gram_contract(plan.m_t, torch.rand(M.shape[0], 3,
                                              dtype=torch.float64),
                         4, None, M.shape[1])
    with pytest.raises(ValueError, match='the plan gathers'):
        sk.gram_contract(plan.m_t, torch.rand(10, 4, dtype=torch.float64),
                         4, None, M.shape[1])


def test_guard_values_dtype(problem):
    """A float64 plan meets a float32 factor: the kernel reads both in one
    dtype."""
    _, M, plan = problem
    F = torch.rand(M.shape[0], 4, dtype=torch.float32)
    with pytest.raises(ValueError, match='plan values'):
        sk.gram_contract(plan.m_t, F, 4, None, M.shape[1])


def test_mxu_backend_routing(problem, monkeypatch):
    """Γ/Θ (whole and panels) go to ``gram_contract`` with their pairs, A
    and C to ``gather_contract``; nothing materializes Khatri-Rao rows
    on the way."""
    X, M, plan = problem
    n, d = M.shape
    k = 5
    W, T = (torch.as_tensor(a) for a in _factors(3, n, d, k))
    calls = []

    def spy(name, fn):
        def wrapped(pl, Ft, *args):
            calls.append((name, pl is plan.m_t, Ft.shape) + args[:2])
            return fn(pl, Ft, *args)
        return wrapped
    monkeypatch.setattr(sk, 'gram_contract',
                        spy('gram', sk.gram_contract))
    monkeypatch.setattr(sk, 'gather_contract',
                        spy('gather', sk.gather_contract))
    acc = torch.float64
    for fn, args, want in (
            (mg._mxu_gram_t, (W, acc),
             [('gather', True, (n, k), k, d), ('gram', True, (n, k), k,
                                               None)]),
            (mg._mxu_gram_w, (T, acc),
             [('gather', False, (d, k), k, n), ('gram', False, (d, k), k,
                                                None)]),
            (mg._mxu_gram_t_panel, (W, 1, 2, acc),
             [('gram', True, (n, k), k, (1, 2))]),
            (mg._mxu_gram_w_panel, (T, 3, 2, acc),
             [('gram', False, (d, k), k, (3, 2))]),
            (mg._mxu_gram_t_A, (W, acc), [('gather', True, (n, k), k, d)]),
            (mg._mxu_gram_w_C, (T, acc),
             [('gather', False, (d, k), k, n)])):
        calls.clear()
        fn(plan, *args)
        assert calls == want, fn.__name__
