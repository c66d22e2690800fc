"""Host ms a training step spent taking the next batch from the loader's
prefetch queue: the program's `input.wait` spans (the queue's get and the
wait for the previous batch's copy) summed a step over the profiled
steps."""

from portbench import spans


def read(run):
    return spans.per_step(["input.wait"]) if run.kind == "train" else None
