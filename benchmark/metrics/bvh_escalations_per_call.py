"""``bvh_escalations_per_call``: the program's counter ``bvh.escalations``
(re-walk rounds of ``ops/bvh.bvh_forces``) over the window's force calls.
0 where the BVH ran in the window (``bvh.build``) without escalating."""

from benchmark import spans

snapshot = spans.snapshot


def read(run):
    return spans.bvh_count_per_call(run, "bvh_escalations_per_call",
                                    "bvh.escalations")
