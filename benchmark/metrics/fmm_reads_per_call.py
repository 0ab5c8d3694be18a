"""``fmm_reads_per_call``: the program's counter ``fmm.reads`` (each host
read-back of an FMM call: the capacity scan's, the sparse grid's sizes,
each chunk batch's window table, a shard's body range) over the window's
force calls. None where the FMM never ran in the window (no ``fmm.build``
span), 0 where it ran without a read-back."""

from benchmark import spans

snapshot = spans.snapshot


def read(run):
    key = "fmm_reads_per_call"
    grew = spans.counted(run, key, "fmm.reads")
    if grew is None or not run.force_calls \
            or not spans.ran(run, key, "fmm.build"):
        return None
    return grew / run.force_calls
