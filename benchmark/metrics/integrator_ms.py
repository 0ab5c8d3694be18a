"""``integrator_ms``: a step's device time outside its force calls, from the
program's own spans: ``sim.step`` (``Simulation.run``) less its
``sim.force`` spans, over the steps. The program's counterpart of the
harness's ``host_step_ms``."""

from benchmark import spans

snapshot = spans.snapshot


def read(run):
    step = spans.per(run, "integrator_ms", "sim.step", "sim.step")
    force = spans.per(run, "integrator_ms", "sim.force", "sim.step")
    if step is None:
        return None
    return 1e3 * (step[0] - force[0]) / step[1]
