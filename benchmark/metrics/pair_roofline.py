"""``pair_roofline``: the least time of the exact sum's work over the kernel
time of a force call on its busiest card, in percent.

The work is the Newton-3 all-pairs count (``benchmark.roofline``) at the
fp32 peak of the cell's cards together. The kernel time of a call is the
union of every kernel interval inside it on one card, found by time and not
by name, so a renamed kernel still counts and a kernel that does more than
the needed work (the one-sided sum) reads lower. Summed over the profiled
calls before the ratio."""

from benchmark import roofline, tracing


def read(run):
    tr = run.trace
    if tr is None or not tr.force_calls:
        return None
    least = measured = 0.0
    for call, events in zip(tr.force_calls, tracing.calls_in(tr)):
        kernels = [e for e in events if e.cat == "kernel"]
        if not kernels:
            continue
        measured += max(tr.busy_us(d, cats=("kernel",), span=call)
                        for d in range(tr.cards)) / 1e6
        least += roofline.newton3_least_s(run.n, run.dim, run.chips)
    return 100.0 * least / measured if measured else None
