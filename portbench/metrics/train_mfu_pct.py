"""Model FLOPs a step (work.model_flops: the DAU layers at the 4-tap gather,
five passes; the other layers at three times their forward) times the
window's steps a second, over the card's bf16 peak."""


def read(run):
    card = run.card
    if run.kind != "train" or card is None:
        return None
    return 100.0 * run.flops_per_unit * run.units / run.window_s / card["bf16_flops"]
