"""``bvh_near_ms``: device time of the program's ``bvh.near`` spans (each
batch's pass 2, ``ops/bvh._near_pass``; the escalation re-walks' included)
a force call."""

from benchmark import spans

snapshot = spans.snapshot


def read(run):
    return spans.ms_per_call(run, "bvh_near_ms", "bvh.near")
