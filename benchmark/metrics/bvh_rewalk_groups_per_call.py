"""``bvh_rewalk_groups_per_call``: the program's counter
``bvh.rewalk_groups`` (the groups each escalation round of
``ops/bvh.bvh_forces`` re-walks: the overflowed ones, padded to a power of
two) over the window's force calls: the size of the work ``bvh_rewalk_ms``
times. 0 where the BVH ran in the window (``bvh.build``) without
escalating."""

from benchmark import spans

snapshot = spans.snapshot


def read(run):
    return spans.bvh_count_per_call(run, "bvh_rewalk_groups_per_call",
                                    "bvh.rewalk_groups")
