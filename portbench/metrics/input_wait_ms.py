"""Host ms a step spent in next() on the loader's prefetch iterator, over
the window's steps (the benchmark's own span, host clock)."""


def read(run):
    if run.kind != "train" or not run.input_wait_s:
        return None
    return 1e3 * sum(run.input_wait_s) / len(run.input_wait_s)
