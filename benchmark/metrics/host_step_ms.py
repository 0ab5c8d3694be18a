"""``host_step_ms``: a step's time outside its force calls (the integrator's
arithmetic and the step loop), from the harness's spans: each step's span
less its force calls' spans, averaged over the window's steps that were not
profiled (all of them where every step was)."""


def read(run):
    spans = [s for s in run.step_spans if not s[2]] or run.step_spans
    if not spans:
        return None
    return 1e3 * sum(t - sum(calls) for t, calls, _ in spans) / len(spans)
