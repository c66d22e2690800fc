"""The comparison that decides `correct`: readings of the program against
the float32 reference, each held to its limit.

Training, from the same weights and the same first batches, each over the
leaves whose reference gradient is at least a thousandth of the median
leaf's, each gap taken over the reference's norm of that leaf or of the
median leaf, whichever is larger:
- `grad_gap`: the worst leaf's gap between the norms of the first step's
  gradient (program against reference);
- `logit_err`: the first step's logits against the reference's, over the
  rows' spread (`logit_gap`). The gaps of norms cannot see a change of
  precision whose rounding errors are unbiased (they cancel in a norm):
  this number does;
- `change_gap`: the worst leaf's gap between the norms of the parameters'
  change over the first steps, over the leaves whose moves the storage's
  rounding cannot hide: at most a tenth of the elements that the
  reference's first gradient touches move by less than half a unit in the
  last place of their stored value (`hidden_share`). Where most of a
  leaf's moves round to nothing, as bf16 DAU weights under lr 1e-4 do, its
  change is a handful of rounding flips that the last bits of the gradient
  decide, and no measure of the update;
- `change_median`: the median leaf's gap of the changes' norms, over every
  counted leaf;
- `stats_gap` (models with batch statistics): the worst BatchNorm buffer's
  gap between the norms of its running statistic's change over the same
  steps, each over the reference's norm of that change or of the median
  buffer's, whichever is larger.
Reported and not compared, having no reading of the control or of a fault
to stand below (PERF.md): `loss_gap`, the largest relative gap of a step's
loss, and `grad_err`, the median leaf's norm of the difference of the first
step's gradients over the reference's norm.
"""

from __future__ import annotations

import math
import statistics
import typing as tp

import torch

__all__ = ["train_readings", "judge", "logit_gap", "hidden_share", "HIDDEN_MAX"]

# the most of a leaf's touched elements whose first move may round to nothing
# for its change to be compared worst-leaf
HIDDEN_MAX = 0.1


def _gap(p: float, r: float, floor: float) -> float:
    den = max(r, floor)
    if den == 0.0:
        return 0.0 if p == 0.0 else math.inf
    return abs(p - r) / den


def logit_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """The worst row's ||program - reference|| over the reference rows'
    root mean square distance from their mean row. (Random weights on noise
    images give rows that share ~92% of their norm, so a gap over the row's
    own norm would hardly see one row's logits swapped for another's.)"""
    p, r = program.float().to(reference.device), reference.float()
    if p.shape != r.shape:
        return math.inf
    spread = ((r - r.mean(dim=0)).norm(dim=1) ** 2).mean().sqrt()
    gap = float((p - r).norm(dim=1).max() / spread.clamp_min(1e-30))
    return gap if math.isfinite(gap) else math.inf


def hidden_share(stored: torch.Tensor, grad: torch.Tensor, lr: float) -> float:
    """The share, of the elements `grad` touches, whose step lr * |grad| is
    under half a unit in the last place of `stored` in its own dtype."""
    g = grad.float().abs()
    stored = stored.to(g.device)
    touched = g > 0
    if not bool(touched.any()):
        return 0.0
    info = torch.finfo(stored.dtype)
    mag = stored.float().abs().clamp_min(info.tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag))) * info.eps
    return float(((lr * g < ulp / 2) & touched).sum() / touched.sum())


def _moves(before: torch.Tensor, after_p: torch.Tensor, after_r: torch.Tensor) -> tp.List[int]:
    """[elements the program moved, elements the reference moved, elements
    moved by one and not the other]."""
    b = before.float().to(after_r.device)
    mp, mr = after_p.float().to(after_r.device) != b, after_r.float() != b
    return [int(mp.sum()), int(mr.sum()), int((mp ^ mr).sum())]


def train_readings(losses_p, grads_p: dict, changes_p: dict, losses_r, grads_r: dict,
                   params0: dict, final_r: dict, lr: float, logits_p=None, logits_r=None,
                   final_p: tp.Optional[dict] = None) -> tp.Tuple[dict, dict]:
    """(readings, detail) of the program's first steps against the
    reference's. grads_p, grads_r: leaf -> the first step's gradient (a
    missing program leaf counts as zero); changes_p: leaf or BatchNorm
    buffer -> the norm of the program's change; params0 (as stored) and
    final_r: name -> tensor; final_p: leaf -> the program's tensor after the
    steps, for the count of moved elements in `detail` (optional)."""
    from .reference.train import STATS

    gr = {k: float(g.float().norm()) for k, g in grads_r.items()}
    med_g = statistics.median(gr.values())
    counted = [k for k in gr if gr[k] >= 1e-3 * med_g]

    def ref_change(k):
        return float((final_r[k].float() - params0[k].to(final_r[k].device).float()).norm())

    cr = {k: ref_change(k) for k in counted}
    med_c = statistics.median(cr.values())
    gp = {k: grads_p[k].to(grads_r[k].device).float() if k in grads_p
          else torch.zeros_like(grads_r[k]) for k in counted}
    grad = {k: _gap(float(gp[k].norm()), gr[k], med_g) for k in counted}
    err = {k: _gap(float((gp[k] - grads_r[k].float()).norm()), 0.0, max(gr[k], med_g))
           for k in counted}
    change = {k: _gap(changes_p.get(k, 0.0), cr[k], med_c) for k in counted}
    hidden = {k: hidden_share(params0[k], grads_r[k], lr) for k in counted}
    resolved = [k for k in counted if hidden[k] <= HIDDEN_MAX]
    worst_g, worst_e = max(grad, key=grad.get), max(err, key=err.get)
    worst_c = max(resolved, key=change.get) if resolved else None
    readings = {"grad_gap": grad[worst_g],
                "change_gap": change[worst_c] if worst_c else math.inf,
                "change_median": statistics.median(change.values())}
    stats = [k for k in final_r if k.endswith(STATS)]
    detail: dict = {}
    if stats:
        sr = {k: ref_change(k) for k in stats}
        med_s = statistics.median(sr.values())
        sgap = {k: _gap(changes_p.get(k, 0.0), sr[k], med_s) for k in stats}
        worst_s = max(sgap, key=sgap.get)
        readings["stats_gap"] = sgap[worst_s]
        detail["stats_worst"] = [worst_s, sgap[worst_s]]
    if logits_r is not None:
        readings["logit_err"] = logit_gap(logits_p, logits_r)
    leaves = {k: {"grad_p": float(gp[k].norm()), "grad_r": gr[k], "grad_err": err[k],
                  "change_p": changes_p.get(k, 0.0), "change_r": cr[k], "change_gap": change[k],
                  "hidden_share": hidden[k]} for k in counted}
    for k in (final_p or {}):
        if k in leaves:
            leaves[k]["moved_p_r_either"] = _moves(params0[k], final_p[k], final_r[k])
    detail.update({
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses_p, losses_r)),
        "grad_err": statistics.median(err.values()), "grad_leaf": worst_g,
        "worst_err": [worst_e, err[worst_e]], "change_leaf": worst_c,
        "worst_change_all": [max(change, key=change.get), max(change.values())],
        "resolved": len(resolved), "left_out": sorted(set(gr) - set(counted)),
        "losses_program": losses_p, "losses_reference": losses_r, "leaves": leaves})
    return readings, detail


def judge(readings: dict, limits: dict) -> tp.Tuple[bool, dict]:
    """(every reading finite and within its limit, {name: {value, limit}})."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in readings.items()}
    ok = all(math.isfinite(v) and v <= limits[k] for k, v in readings.items())
    return ok, checks
