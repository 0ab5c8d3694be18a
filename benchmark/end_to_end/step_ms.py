"""``step_ms``: the window over the whole steps completed in it, on the
host's clock. Each step is one ``Simulation.run(steps=1, dt)`` ended in a
synchronize of the cell's cards, so the window holds all of their work."""


def read(run):
    return 1e3 * run.window_s / run.steps
