"""Iterations a solve took, as the solver returns them, averaged over
the traced window's solves (``iterations_per_solve.<loop>``)."""


def read(run):
    its = run.counters.get("iterations")
    return sum(its) / len(its) if its else None
