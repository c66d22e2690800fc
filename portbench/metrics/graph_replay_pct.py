"""The share of the profiled training steps that replayed a CUDA graph:
100 times the program's `train.step` spans whose `graph` attr is 'replay'
over all of them (0 where the program's steps carry no such attr)."""

from portbench import spans


def read(run):
    if run.kind != "train":
        return None
    steps = [s for s in spans.recorded() if s.name == spans.STEP]
    if not steps:
        return None
    return 100.0 * sum(s.attrs.get("graph") == "replay" for s in steps) / len(steps)
