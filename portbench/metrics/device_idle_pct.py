"""The share of a step's time in which nothing ran on the
card: 100 times one minus the device's busy seconds a step in the trace
(the union of its kernel, copy and fill intervals, so overlapping work on
two streams counts once) over the seconds a step took in the window,
without the profiler (train cells). The traced span itself is no base: the
profiler slows the host, and a host-paced span would read idle that the
untraced run does not have."""


def read(run):
    if run.kind != "train" or run.trace is None or run.units == 0:
        return None
    busy = run.trace.busy_s / run.trace.units
    return 100.0 * (1.0 - busy / (run.window_s / run.units))
