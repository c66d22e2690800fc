"""Device ms a step of the elementwise, reduce, copy, fill, cat and index
kernels (trace.CATEGORIES 'glue')."""


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    return run.trace.per_unit_ms("glue") or 0.0
