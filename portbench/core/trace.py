"""What a ``torch.profiler`` trace of one fit says: device operations by
name, the device's busy time (the union of their intervals), and the
idle gaps, each named by what the host was doing then.

The per-kernel sums copy the arithmetic of ``chip_smoke.device_kernels``
and ``trace_shares`` (``chip_smoke.py:1644-1684``): events whose device
type is CUDA, their device time summed by name.
"""

from dataclasses import dataclass
from typing import List, Tuple


@dataclass
class Trace:
    """A traced window: device operations ``(name, start_us, end_us)``,
    host operations ``(name, start_us, end_us)``, the window's bounds
    (µs, the trace's clock) and the sweeps the traced fit kept."""
    device: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    start: float
    end: float
    sweeps: int = 0

    @property
    def window_s(self):
        return (self.end - self.start) / 1e6

    def by_name(self):
        """``{name: (count, seconds)}`` of the device operations."""
        out = {}
        for name, a, b in self.device:
            c, s = out.get(name, (0, 0.0))
            out[name] = (c + 1, s + (b - a) / 1e6)
        return out

    def matching(self, fragments):
        """``(count, seconds)`` of the device operations whose name holds
        one of ``fragments``."""
        c, s = 0, 0.0
        for name, (n, sec) in self.by_name().items():
            if any(f in name for f in fragments):
                c, s = c + n, s + sec
        return c, s

    def busy(self):
        """Merged ``[(start, end)]`` of the device operations inside the
        window."""
        spans = sorted((max(a, self.start), min(b, self.end))
                       for _, a, b in self.device)
        merged = []
        for a, b in spans:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self):
        return sum(b - a for a, b in self.busy()) / 1e6

    def gaps(self):
        """``[(start, end)]`` of the window where no device operation
        runs."""
        out, at = [], self.start
        for a, b in self.busy():
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if self.end > at:
            out.append((at, self.end))
        return out

    def host_labels(self, times):
        """What the host was doing at each of the sorted ``times``: the
        outermost benchmark span (``portbench.*``) and the innermost host
        operation under way, joined by ``/``."""
        events = sorted((a, b, name) for name, a, b in self.host)
        active, spans, out, i = [], [], [], 0
        for t in times:
            while i < len(events) and events[i][0] <= t:
                (spans if events[i][2].startswith('portbench.')
                 else active).append(events[i])
                i += 1
            active = [e for e in active if e[1] > t] \
                if len(active) > 64 else active
            spans = [e for e in spans if e[1] > t]
            inner = next((e[2] for e in reversed(active) if e[1] > t), None)
            outer = spans[0][2] if spans else None
            out.append('/'.join(x for x in (outer, inner) if x)
                       or 'host idle')
        return out

    def breakdown(self, top=10):
        """``{'device_ops': [[name, seconds]], 'idle_gaps': [[label,
        seconds]]}``: the costliest device operations by summed time and
        the idle time summed by what the host was doing, ``top`` of
        each."""
        ops = sorted(((name, s) for name, (_, s) in self.by_name().items()),
                     key=lambda x: -x[1])[:top]
        idle = {}
        gaps = self.gaps()
        labels = self.host_labels([(a + b) / 2 for a, b in gaps])
        for (a, b), label in zip(gaps, labels):
            idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
        gaps = sorted(idle.items(), key=lambda x: -x[1])[:top]
        return {'device_ops': [[n[:120], s] for n, s in ops],
                'idle_gaps': [[n[:120], s] for n, s in gaps]}


def from_profiler(prof, span='portbench.traced_fit'):
    """The :class:`Trace` of a ``torch.profiler.profile`` whose window is
    the host span named ``span``, read from the profiler's raw events
    (a million of them read in seconds, where ``prof.events()`` takes
    minutes). The device's copies of the host's ``record_function``
    spans are no device operation."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    base = min((e.start_ns() for e in events), default=0)
    device, host = [], []
    window = None
    for e in events:
        name = e.name()
        a = (e.start_ns() - base) / 1e3
        b = (e.end_ns() - base) / 1e3
        if e.device_type() == cuda:
            annotation = (e.is_user_annotation()
                          if hasattr(e, 'is_user_annotation') else False)
            if not annotation and not name.startswith('portbench.'):
                device.append((name, a, b))
        else:
            host.append((name, a, b))
            if name == span:
                window = (a, b)
    if window is None:
        starts = [a for _, a, _ in device + host]
        ends = [b for _, _, b in device + host]
        window = (min(starts), max(ends)) if starts else (0.0, 0.0)
    return Trace(device=device, host=host, start=window[0], end=window[1])
