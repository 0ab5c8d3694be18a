"""``fmm_m2l_ms``: device time of the program's ``fmm.m2l`` span (M2L over
every level with its operators, in ``ops/fmm.fmm_shard_partials``) a force
call. None where the span never ran in the window."""

from benchmark import spans

snapshot = spans.snapshot


def read(run):
    return spans.ms_per_call(run, "fmm_m2l_ms", "fmm.m2l")
