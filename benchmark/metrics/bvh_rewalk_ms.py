"""``bvh_rewalk_ms``: device time of the program's ``bvh.rewalk`` spans
(each escalation round of ``ops/bvh.bvh_forces``: the overflowed groups'
re-walk and its read-back) a force call. It overlaps ``bvh_frontier_ms``
and ``bvh_near_ms``, which count the re-walks' loops and passes 2 too. 0
where the BVH ran in the window (``bvh.build``) without escalating."""

from benchmark import spans

snapshot = spans.snapshot


def read(run):
    got = spans.per(run, "bvh_rewalk_ms", "bvh.rewalk", "sim.force")
    if got is None or not spans.ran(run, "bvh_rewalk_ms", "bvh.build"):
        return None
    return 1e3 * got[0] / got[1]
