"""``ring_copy_ms``: device time of the copies between cards (the profiler's
peer-to-peer memcpy events) in the profiled steps, over the force calls in
them. Nothing to read where no copy went between cards."""


def read(run):
    tr = run.trace
    if tr is None or not tr.force_calls:
        return None
    peer = [e for e in tr.events
            if e.cat == "gpu_memcpy" and "PtoP" in e.name]
    if not peer:
        return None
    return sum(e.end - e.start for e in peer) / 1e3 / len(tr.force_calls)
