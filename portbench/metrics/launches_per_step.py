"""Device kernels a step in the trace (copies and fills not
counted), train cells."""


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    return run.trace.launches / run.trace.units
