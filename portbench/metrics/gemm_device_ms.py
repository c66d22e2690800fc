"""Device ms a step or request of cuBLAS GEMMs (trace.CATEGORIES 'gemm'),
train cells."""


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    return run.trace.per_unit_ms("gemm") or 0.0
