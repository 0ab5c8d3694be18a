"""``fmm_upward_ms``: device time of the program's ``fmm.upward`` span (P2M and
M2M with their tables, in ``ops/fmm.fmm_shard_partials``) a force call. None
where the span never ran in the window."""

from benchmark import spans

snapshot = spans.snapshot


def read(run):
    return spans.ms_per_call(run, "fmm_upward_ms", "fmm.upward")
