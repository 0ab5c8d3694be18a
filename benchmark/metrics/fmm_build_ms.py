"""``fmm_build_ms``: device time of the program's ``fmm.build`` span (the
capacity scan or the sparse grid's sizes, and ``build_grid_tree``, in
``ops/fmm.fmm_forces``) a force call. None where the span never ran in the
window."""

from benchmark import spans

snapshot = spans.snapshot


def read(run):
    return spans.ms_per_call(run, "fmm_build_ms", "fmm.build")
