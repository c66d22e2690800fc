"""K1's share of its roofline: the least seconds the card needs for the
three unit-gradient tables K1 made in a step (work.table_work, at each layer
where the counters saw it launch in the backward) over K1's device seconds a
step in the trace. None where K1 did not launch."""

from portbench import work


def read(run):
    card = run.card
    if run.kind != "train" or run.trace is None or not run.launches.get("K1") or card is None:
        return None
    bound = sum(run.layer_launches[la["name"]]["backward"].get("K1", 0)
                * work.bound_s(*work.table_work(la, run.elem_bytes), card) for la in run.layers)
    device_ms = run.trace.per_unit_ms("K1")
    return 100.0 * bound * 1e3 / device_ms if device_ms and bound else None
