"""``b2_roofline`` (%), layer "kernels": B2 (``csrc/tm_proj.cu``,
``tm_proj_kernel``) in the traced fit: its launches times the least time
of one launch at the cell's (k, d) (``core/roofline.py``), over its
device time by kernel name."""

from portbench.core.roofline import b2_counts, bound


def read(run):
    tr = run.trace
    if tr is None:
        return None
    _, d, k = run.cell.shape
    c, s = tr.matching(('tm_proj_kernel',))
    if c == 0 or s <= 0:
        return None
    return 100.0 * c * bound(*b2_counts(k, d),
                             run.cell.config['dtype'])[0] / s
