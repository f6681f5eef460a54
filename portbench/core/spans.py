"""The program's own spans in a traced fit: the ``rri.*`` regions that
``rri_nmf_tpu_torch.utils.profiling`` opens at the fit's stages, read
from the ``Trace``'s host events, on the device trace's clock.

A reader of a span returns ``None`` where the trace holds none of its
spans, as a checkout of the program from before the spans gives.
"""


def intervals(trace, *names):
    """``[(start, end)]`` (µs) of the host spans named one of ``names``,
    cut to the trace's window, in order of their start."""
    out = []
    for name, a, b in trace.host:
        if name in names:
            a, b = max(a, trace.start), min(b, trace.end)
            if b > a:
                out.append((a, b))
    return sorted(out)


def seconds(trace, *names):
    """Summed length (s) of the spans named one of ``names``, or ``None``
    where there is none (no trace, or a program without the spans)."""
    if trace is None:
        return None
    spans = intervals(trace, *names)
    if not spans:
        return None
    return sum(b - a for a, b in spans) / 1e6


def overlap(xs, ys):
    """Length of the intersection of two lists of sorted, disjoint
    ``(start, end)`` intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def merged(spans):
    """Sorted ``(start, end)`` intervals merged where they overlap."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def idle_share(trace, *names):
    """The share (%) of the spans named one of ``names`` in which no
    device operation runs, or ``None`` without such spans or without
    device operations."""
    if trace is None or not trace.device:
        return None
    spans = merged(intervals(trace, *names))
    total = sum(b - a for a, b in spans)
    if total <= 0:
        return None
    return 100.0 * overlap(spans, trace.gaps()) / total
