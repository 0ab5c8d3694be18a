"""``fmm_p2p_ms``: device time of the program's ``fmm.p2p`` span (the near
field: K6 on the dense layout, the windowed plain field on the sparse one) a
force call. None where the span never ran in the window."""

from benchmark import spans

snapshot = spans.snapshot


def read(run):
    return spans.ms_per_call(run, "fmm_p2p_ms", "fmm.p2p")
