"""``fmm_downward_ms``: device time of the program's ``fmm.downward`` span (L2L
and L2P, in ``ops/fmm.fmm_shard_partials``) a force call. None where the
span never ran in the window."""

from benchmark import spans

snapshot = spans.snapshot


def read(run):
    return spans.ms_per_call(run, "fmm_downward_ms", "fmm.downward")
