"""``near_roofline``: the least time of the near field's real work over the
device time of the program's ``fmm.p2p`` span a force call, in percent, on
the FMM's occupied-cell layout (K6's occupied-leaf entry).

The work is the pairs the near field evaluated in the window, the
program's counter ``fmm.near_pairs`` (each leaf's bodies times the bodies
of its ring's leaves, summed on the device at each call), over the
window's force calls, at the one-sided pair's 5·D + 6 operations and 67e12
operations a second (:mod:`benchmark.clustered_work`). None where the
counter did not grow in the window (the occupied-cell layout did not run,
or the program has no such counter) or the span never ran."""

from benchmark import clustered_work, spans

snapshot = spans.snapshot


def read(run):
    key = "near_roofline"
    ms = spans.ms_per_call(run, key, "fmm.p2p")
    pairs = spans.counted(run, key, "fmm.near_pairs")
    if not ms or not pairs or not run.force_calls:
        return None
    least_s = clustered_work.near_least_s(pairs / run.force_calls, run.dim)
    return 100.0 * 1e3 * least_s / ms
