"""``bvh_build_ms``: device time of the program's ``bvh.build`` span
(``build_bvh`` in ``ops/bvh._bvh_eval``) a force call."""

from benchmark import spans

snapshot = spans.snapshot


def read(run):
    return spans.ms_per_call(run, "bvh_build_ms", "bvh.build")
