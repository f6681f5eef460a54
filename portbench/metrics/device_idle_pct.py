"""``device_idle_pct`` (%), layer "device": the share of the traced fit's
window in which no device operation runs (the union of the kernel,
copy and fill intervals of the ``torch.profiler`` trace)."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
