"""``bvh_walk_iters_per_call``: the program's counter ``bvh.walk_iters``
(iterations of the frontier loops of ``ops/bvh.bvh_accel_sorted``, the
escalation re-walks' included; each ends in one host read-back) over the
window's force calls. The count of the loop steps that ``bvh_frontier_ms``
times."""

from benchmark import spans

snapshot = spans.snapshot


def read(run):
    return spans.bvh_count_per_call(run, "bvh_walk_iters_per_call",
                                    "bvh.walk_iters")
