"""Seconds from the start of the process to the start of the window:
imports, the CUDA context, kernel libraries (built on a checkout's first
run), weights, data, the checked and warm-up steps or requests."""


def read(run):
    return run.setup_s
