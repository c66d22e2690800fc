"""Images of every training step completed in the window over the window's
seconds (host clock, from the first timed step's start to the synchronize
after the last)."""


def read(run):
    return run.images / run.window_s if run.kind == "train" else None
