"""The yardstick's counts at the three cells' shapes against counts made
by hand, and the least time they give."""

import math
from types import SimpleNamespace

import numpy as np
import pytest

from portbench.core import roofline
from portbench.core.spec import Cell

TM_NNZ = 1_500_000           # a corpus of the tm-20ng shape
RS_Q = 1_000_209             # ML-1M's ratings
RS_NNZ = RS_Q - 50_011       # less the ceil(5%) the held-out stop keeps


def test_peaks_and_bound():
    assert roofline.PEAK_FLOPS['float32'] == 67e12
    assert roofline.PEAK_BYTES_PER_S == 3.35e12
    t, by = roofline.bound(67e12, 1.0)
    assert t == pytest.approx(1.0) and by == 'operations'
    t, by = roofline.bound(1.0, 3.35e12)
    assert t == pytest.approx(1.0) and by == 'bytes'


def test_masked_kernel_counts_at_rs_shape():
    n, d = 6040, 3952
    ops, nbytes = roofline.b3_counts(n, d)
    assert ops == 7 * 23_870_080
    # R read and written, M read (3 × 95.48 MB), w, dw, t_prev (n, n, d)
    # and the two (d,) sums: 3n + 3d floats
    assert nbytes == 4 * (3 * 23_870_080 + 3 * 6040 + 3 * 3952)
    ops, nbytes = roofline.b4_counts(n, d)
    assert ops == 9 * 23_870_080
    assert nbytes == 4 * (3 * 23_870_080 + 5 * 6040 + 2 * 3952)
    t, by = roofline.bound(*roofline.b3_counts(n, d))
    assert by == 'bytes' and t * 1e3 == pytest.approx(0.0855, abs=1e-4)


def test_tm_proj_counts_at_tm_shape():
    k, d = 50, 26214
    ops, nbytes = roofline.b2_counts(k, d)
    assert ops == 2 * 2500 * 26214
    assert nbytes == 4 * (2500 + 3 * 50 * 26214)
    t, by = roofline.bound(ops, nbytes)
    assert by == 'bytes' and t * 1e3 == pytest.approx(0.0047, abs=1e-4)


def _inputs(cell, q):
    """Inputs of the cell's kind: a sparse matrix with q nonzeros, or a
    table of q ratings."""
    if cell.startswith('rs'):
        return np.zeros((q, 2), np.int64), np.ones(q)
    return (SimpleNamespace(nnz=q),)


def _counts(cell, q):
    c = Cell(cell)
    ref = c.workload['reference']
    return c.module('reference', ref['path']).sweep_counts(
        c.config, ref, _inputs(cell, q))


def test_interleaved_sweep_counts():
    n, d, k = 11314, 26214, 50
    ops, nbytes = _counts('tm-20ng.fit', TM_NNZ)
    # per topic: X t and the T row's contraction (2·nnz each), Wᵀw and
    # W(Tt) (2nk each), Tᵀ(Wᵀw) and T t (2kd each)
    assert ops == k * (2 * 2 * TM_NNZ + 2 * 2 * n * k + 2 * 2 * k * d)
    # per topic: the nonzeros (8 bytes each), the row pointers, W and T
    # read and written once
    per_pass = TM_NNZ * 8 + (n + 1) * 4 + 2 * 4 * (n * k + k * d)
    assert nbytes == k * per_pass


def test_phase_sweep_counts():
    n, d, k = 11314, 26214, 50
    ops, nbytes = _counts('tm-20ng.fit-phase', TM_NNZ)
    # WᵀX and TXᵀ (2·nnz·k each), WᵀW and TTᵀ (2nk², 2dk²), the two
    # Gauss-Seidel panels (2k²d, 2k²n)
    assert ops == 2 * 2 * TM_NNZ * k + 2 * k * k * (n + d) * 2
    assert nbytes == 2 * (TM_NNZ * 8 + (n + 1) * 4 + 2 * 4 * (n * k + k * d))


def test_masked_sweep_counts():
    n, d, k = 6040, 3952, 40
    ops, nbytes = _counts('rs-ml1m.fit', RS_Q)
    assert ops == k * 6 * 2 * RS_NNZ + 3 * RS_NNZ
    assert nbytes == k * (RS_NNZ * 8 + (n + 1) * 4 + 2 * 4 * (n * k + k * d))
    # far under the dense form's k passes over R and M (k·3·n·d·4 bytes)
    assert nbytes < 0.2 * k * 3 * n * d * 4


def test_counted_inputs():
    """A sweep counts the inputs it trains on: a sparse matrix's
    nonzeros; a table's ratings less the held-out split's ceil(5%)."""
    import scipy.sparse as sp
    from portbench.reference import rs_masked, tm_phase
    X = sp.random(50, 40, density=0.1, format='csr', random_state=0)
    cfg = dict(n=50, d=40, k=3)
    assert tm_phase.sweep_counts(cfg, {}, (X,)) == \
        tm_phase.sweep_counts(cfg, {}, (SimpleNamespace(nnz=X.nnz),))
    assert rs_masked.held_out(1000) == 50 and rs_masked.held_out(999) == 50
    assert len(rs_masked.split(999)[0]) == 999 - 50

    def nnz(q):
        ops, _ = rs_masked.sweep_counts(cfg, {}, _inputs('rs', q))
        return ops // (12 * 3 + 3)
    assert nnz(1000) == 950 and nnz(999) == 949 and nnz(20) == 19


@pytest.mark.parametrize('cell', ['rs-ml1m.fit', 'tm-20ng.fit',
                                  'tm-20ng.fit-phase'])
def test_sweep_least_time_is_bytes_bound(cell):
    q = RS_Q if cell.startswith('rs') else TM_NNZ
    t, by = roofline.bound(*_counts(cell, q))
    assert by == 'bytes' and 0 < t < 1e-3 and math.isfinite(t)
