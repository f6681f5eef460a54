"""The yardstick of the roofline shares: the card's published peaks, the
least time of a call, and the operations and bytes of the port's
hand-written kernels at a cell's shape.

``PEAK_FLOPS``, ``PEAK_BYTES_PER_S`` and :func:`bound` are copied from
``chip_smoke.py`` (lines 320-334 and 592-599); the kernels' counts from
its phases 3-4 (``chip_smoke.py:3130-3131``, ``:3457``).
"""

# The published peaks of an H100 SXM at 700 W (NVIDIA's data sheet):
# float32 and float64 outside the tensor cores; bfloat16 and float16 dense
# on them, with float32 sums.
PEAK_FLOPS = {'float32': 67e12, 'float64': 34e12, 'bfloat16': 989e12,
              'float16': 989e12}
PEAK_BYTES_PER_S = 3.35e12


def bound(flop, nbytes, dtype='float32'):
    """``(bound_s, bound_by)``: the least time the card could take for
    ``flop`` operations in ``dtype`` moving ``nbytes``, and which of the
    two binds."""
    t_ops = flop / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes), ('operations' if t_ops > t_bytes
                                 else 'bytes')


def b3_counts(n, d, itemsize=4):
    """B3 (``masked.cu`` ``phase_a_kernel``) on an (n, d) residual:
    ``R += dw·t_prevᵀ`` in place, then ``wᵀ(M⊙R)`` and ``(w²)ᵀM``.
    R read and written once, M read once, five vectors read and the two
    sums written."""
    return 7 * n * d, (3 * n * d + 3 * n + 3 * d) * itemsize


def b4_counts(n, d, itemsize=4):
    """B4 (``phase_b_kernel``): ``R += w·t_oldᵀ − w_eff·t_newᵀ``, then
    ``(M⊙R)·t_new`` and ``M·t_new²``."""
    return 9 * n * d, (3 * n * d + 5 * n + 2 * d) * itemsize


def b2_counts(k, d, itemsize=4):
    """B2 (``tm_proj.cu`` ``tm_proj_kernel``): the projected T-phase over
    the (k, d) panel from the Gram (k, k) and numerators (k, d): G, N and
    the old panel read once, the new one written once."""
    return 2 * k * k * d, (k * k + 3 * k * d) * itemsize
