"""Frequency bins a training step whose unit gradients took the unfused
spectral gather: the `bins` of the program's `dau.unit_grads` spans whose
`route` is 'unfused', summed a step over the profiled steps (0 where every
DAU layer took a fused kernel)."""

from portbench import spans


def read(run):
    if run.kind != "train":
        return None
    return spans.per_step(["dau.unit_grads"], value=lambda s: s.attrs["bins"],
                          where=lambda s: s.attrs.get("route") == "unfused")
