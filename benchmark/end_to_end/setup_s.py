"""``setup_s``: process start to the first timed step, on the host's clock:
imports, the kernel library's build or load, the bodies drawn on the card,
the simulation built and the mix's warm-up steps, ended in a synchronize."""


def read(run):
    return run.setup_s
