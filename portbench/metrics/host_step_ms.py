"""Host ms of a training step: the mean duration of the program's
`train.step` span (zero grads, forward and loss, backward, optimizer) over
the profiled steps. Under the profiler, which slows the host."""

from portbench import spans


def read(run):
    return spans.per_step(["train.step"]) if run.kind == "train" else None
