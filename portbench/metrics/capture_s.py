"""``capture_s`` (s), layer "sweep": the traced fit's ``rri.sweep.capture``
spans summed: the CUDA graph capture of the plain sweep (a fit's second
sweep), with the operand copies it is captured from. Program span."""

from portbench.core.spans import seconds


def read(run):
    return seconds(run.trace, 'rri.sweep.capture')
