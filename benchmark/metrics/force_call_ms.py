"""``force_call_ms``: the mean span of one ``forces_fn`` call, ended in a
synchronize, over the window's steps that were not profiled (all of them
where every step was)."""


def read(run):
    spans = [s for s in run.step_spans if not s[2]] or run.step_spans
    calls = [c for _, step_calls, _ in spans for c in step_calls]
    return 1e3 * sum(calls) / len(calls) if calls else None
