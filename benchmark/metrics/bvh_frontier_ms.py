"""``bvh_frontier_ms``: device time of the program's ``bvh.frontier`` spans
(each batch's frontier loop in ``ops/bvh.bvh_accel_sorted``: MAC, inline
far field, one read-back an iteration; the escalation re-walks' loops
included) a force call."""

from benchmark import spans

snapshot = spans.snapshot


def read(run):
    return spans.ms_per_call(run, "bvh_frontier_ms", "bvh.frontier")
