"""``b3b4_roofline`` (%), layer "kernels": B3 and B4 (``csrc/masked.cu``,
``phase_a_kernel`` and ``phase_b_kernel``/``phase_b_packed_kernel``) in
the traced fit: their launches times the least time of one launch at the
cell's (n, d) (``core/roofline.py``), over their device time by kernel
name."""

from portbench.core.roofline import b3_counts, b4_counts, bound


def read(run):
    tr = run.trace
    if tr is None:
        return None
    n, d, _ = run.cell.shape
    dt = run.cell.config['dtype']
    na, sa = tr.matching(('phase_a_kernel',))
    nb, sb = tr.matching(('phase_b_kernel', 'phase_b_packed_kernel'))
    if na + nb == 0 or sa + sb <= 0:
        return None
    least = (na * bound(*b3_counts(n, d), dt)[0]
             + nb * bound(*b4_counts(n, d), dt)[0])
    return 100.0 * least / (sa + sb)
