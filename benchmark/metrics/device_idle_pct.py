"""``device_idle_pct``: the share of the profiled steps in which a card runs
no kernel, copy or set (the union of their intervals), averaged over the
cell's cards."""


def read(run):
    tr = run.trace
    if tr is None or not tr.events or tr.window_us <= 0:
        return None
    return 100.0 * (1.0 - tr.mean_busy_us() / tr.window_us)
