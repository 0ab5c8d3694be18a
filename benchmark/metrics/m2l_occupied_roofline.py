"""``m2l_occupied_roofline``: the least time of M2L's useful work over the
device time of the program's ``fmm.m2l`` span a force call, in percent, on
the FMM's occupied-cell layout.

The work is M2L's (target cell, offset) pairs whose source cell holds
bodies, the program's counter ``fmm.m2l_pairs`` (summed on the device at
each call), over the window's force calls, at 2·(order^D)² operations a
pair and 67e12 operations a second (:mod:`benchmark.clustered_work`): the
rows the parity classes pad with, and the offsets whose source is empty,
are no useful work, whatever the program multiplies. None where the
counter did not grow in the window (the occupied-cell layout did not run,
or the program has no such counter), the span never ran, or the mix names
no order."""

from benchmark import clustered_work, spans

snapshot = spans.snapshot


def read(run):
    key = "m2l_occupied_roofline"
    order = run.mix.get("tree", {}).get("order")
    ms = spans.ms_per_call(run, key, "fmm.m2l")
    pairs = spans.counted(run, key, "fmm.m2l_pairs")
    if not ms or not pairs or not run.force_calls or order is None:
        return None
    least_s = clustered_work.m2l_least_s(pairs / run.force_calls, run.dim,
                                         order)
    return 100.0 * 1e3 * least_s / ms
