"""``force_calls_per_step``: calls of ``forces_fn`` in the window over its
steps, counted by the harness's wrapper (2 for the kick-drift-kick step as
``Simulation.run`` makes it; 1 where the acceleration is carried)."""


def read(run):
    return run.force_calls / run.steps if run.steps else None
