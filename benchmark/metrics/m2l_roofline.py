"""``m2l_roofline``: the least time of M2L's useful work over the device
time of the program's ``fmm.m2l`` span a force call, in percent.

The work is the V-list pairs of levels 2 to L at 2·(order^D)² operations
each (:mod:`benchmark.fmm_work`, at 67e12 operations a second), for the
cell's N and dimension and the order of its mix. None where the span never
ran in the window or the mix names no order."""

from benchmark import fmm_work, spans

snapshot = spans.snapshot


def read(run):
    order = run.mix.get("tree", {}).get("order")
    ms = spans.ms_per_call(run, "m2l_roofline", "fmm.m2l")
    if not ms or order is None:
        return None
    return 100.0 * 1e3 * fmm_work.m2l_least_s(run.n, run.dim, order) / ms
