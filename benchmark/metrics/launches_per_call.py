"""``launches_per_call``: the kernels the profiler recorded on the cell's
cards in the profiled steps, over the force calls in them (every kernel,
torch's own and the port's, graph replays included)."""


def read(run):
    tr = run.trace
    if tr is None or not tr.force_calls or not tr.kernels():
        return None
    return len(tr.kernels()) / len(tr.force_calls)
