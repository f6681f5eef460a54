"""``kernels_per_sweep`` (kernels/sweep), layer "device": the device
kernels in the traced fit (copies and fills left out) over the sweeps it
kept."""


def read(run):
    tr = run.trace
    if tr is None or not tr.sweeps or not tr.device:
        return None
    kernels = sum(1 for name, _, _ in tr.device
                  if not name.startswith(('Memcpy', 'Memset')))
    return kernels / tr.sweeps
