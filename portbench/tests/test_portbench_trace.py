"""The trace arithmetic on a synthetic event list: busy time as the
union of device intervals, the idle share, the kernel sums by name, and
the breakdown's idle gaps named by the host's span and operation."""

from types import SimpleNamespace

import pytest

from portbench.core.harness import Fit, Run
from portbench.core.spec import Cell, load_module
from portbench.core.trace import Trace

DEVICE = [('k_a', 10.0, 20.0), ('k_b', 15.0, 30.0),   # overlap: 10-30
          ('k_a', 50.0, 60.0), ('Memcpy HtoD', 60.0, 70.0),
          ('k_c', 95.0, 100.0), ('k_a', 120.0, 130.0)]  # past the window
HOST = [('portbench.traced_fit', 0.0, 100.0),
        ('aten::copy_', 30.0, 45.0), ('cudaStreamSynchronize', 32.0, 44.0),
        ('aten::item', 70.0, 94.0)]


def trace():
    return Trace(device=DEVICE, host=HOST, start=0.0, end=100.0, sweeps=2)


def test_busy_union_and_idle():
    tr = trace()
    assert tr.busy() == [[10.0, 30.0], [50.0, 70.0], [95.0, 100.0]]
    assert tr.busy_s == pytest.approx(45e-6)
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.gaps() == [(0.0, 10.0), (30.0, 50.0), (70.0, 95.0)]


def test_by_name_and_matching():
    tr = trace()
    by = tr.by_name()
    assert by['k_a'] == (3, pytest.approx(30e-6))
    assert tr.matching(('k_a', 'k_c')) == (4, pytest.approx(35e-6))


def test_breakdown():
    bd = trace().breakdown()
    assert bd['device_ops'][0] == ['k_a', pytest.approx(30e-6)]
    assert len(bd['device_ops']) == 4
    gaps = dict((n, s) for n, s in bd['idle_gaps'])
    # 0-10: only the fit's span; 30-50 at 40: the sync inside the copy;
    # 70-95 at 82.5: the host reading a value
    assert gaps == {'portbench.traced_fit': pytest.approx(10e-6),
                    'portbench.traced_fit/cudaStreamSynchronize':
                        pytest.approx(20e-6),
                    'portbench.traced_fit/aten::item': pytest.approx(25e-6)}
    assert sum(gaps.values()) == pytest.approx(100e-6 - trace().busy_s)


def test_breakdown_keeps_ten():
    dev = [('k%d' % i, float(i), i + 0.5) for i in range(30)]
    tr = Trace(device=dev, host=[], start=0.0, end=30.0)
    bd = tr.breakdown()
    assert len(bd['device_ops']) == 10
    assert bd['idle_gaps'] == [['host idle', pytest.approx(15e-6)]]


def _run(cell_name, trace_obj):
    cell = Cell(cell_name)
    return Run(cell=cell, setup_s=1.0,
               fits=[Fit(1.0, [0.2, 0.3, 0.4]), Fit(1.2, [0.2, 0.35, 0.5])],
               inputs=(SimpleNamespace(nnz=1000),), trace=trace_obj)


def test_device_readers():
    run = _run('tm-20ng.fit', trace())
    idle = load_module('metrics', 'device_idle_pct').read(run)
    assert idle == pytest.approx(55.0)
    kps = load_module('metrics', 'kernels_per_sweep').read(run)
    assert kps == pytest.approx(5 / 2)      # the copy is no kernel


def test_host_readers():
    run = _run('tm-20ng.fit', None)
    read = {m: load_module('metrics', m).read(run)
            for m in ('fit_s', 'outside_driver_s', 'first_sweep_s',
                      'sweep_ms')}
    assert read['fit_s'] == pytest.approx(1.1)
    assert read['outside_driver_s'] == pytest.approx((0.6 + 0.7) / 2)
    assert read['first_sweep_s'] == pytest.approx(0.2)
    # (0.2 + 0.3) s over 4 sweeps after the first
    assert read['sweep_ms'] == pytest.approx(125.0)
    for m in ('device_idle_pct', 'kernels_per_sweep', 'b2_roofline',
              'b3b4_roofline'):
        assert load_module('metrics', m).read(run) is None


def test_kernel_roofline_readers():
    n, d = 6040, 3952
    tr = Trace(device=[('void phase_a_kernel<float>', 0.0, 200.0),
                       ('void phase_b_kernel<float>', 200.0, 400.0),
                       ('void tm_proj_kernel<float, float>', 400.0, 1400.0)],
               host=[], start=0.0, end=1400.0, sweeps=1)
    run = _run('rs-ml1m.fit', tr)
    from portbench.core.roofline import b3_counts, b4_counts, bound
    least = bound(*b3_counts(n, d))[0] + bound(*b4_counts(n, d))[0]
    got = load_module('metrics', 'b3b4_roofline').read(run)
    assert got == pytest.approx(100 * least / 400e-6)
    run = _run('tm-20ng.fit-phase', tr)
    got = load_module('metrics', 'b2_roofline').read(run)
    assert got == pytest.approx(100 * 0.0047e-3 / 1000e-6, rel=1e-2)


def test_sweep_mfu_reader():
    run = _run('tm-20ng.fit-phase', None)
    from portbench.core.roofline import bound
    c = run.cell
    ops, nbytes = c.module('reference', 'tm_phase').sweep_counts(
        c.config, c.workload['reference'], run.inputs)
    got = load_module('metrics', 'sweep_mfu_pct').read(run)
    assert got == pytest.approx(100 * bound(ops, nbytes)[0] / 0.125)
