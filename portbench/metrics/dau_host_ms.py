"""Host ms a training step inside the DAU layers: the program's
`dau.forward` and `dau.backward` spans (the layer's Python, the op's plan
and phase table, the kernel wrappers and the launches they enqueue) summed
a step over the profiled steps."""

from portbench import spans


def read(run):
    return spans.per_step(["dau.forward", "dau.backward"]) if run.kind == "train" else None
