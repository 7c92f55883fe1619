"""The numbers a training cell compares: a run's readings of its checked
steps (each step's loss, the first gradient's leaf norms as the optimizer
took it, the parameters' change after the last step, as leaf norms)
against the reference's."""

from __future__ import annotations

from typing import Dict

import numpy as np


def compare(got: Dict, want: Dict, skip_below: float) -> Dict:
    """The gaps between a run's readings and the reference's:

    - ``loss1_rel``: the first step's loss, relative (the first step runs
      from the same weights on both sides, so only its arithmetic
      differs); ``loss_rel``: the largest over the checked steps;
    - ``grad_gap`` / ``change_gap``: by the worst leaf, the gap between the
      two norms over the larger of the reference leaf's norm and the median
      leaf's; ``grad_gap_median`` / ``change_gap_median``: the same gap of
      the median leaf. The change leaves out leaves whose reference
      gradient lies under ``skip_below`` times the median leaf's (they move
      under Adam by round-off alone).

    ``got`` of one step only (a baseline that follows the first step)
    gives the first step's numbers only."""
    loss = [abs(g - w) / abs(w) for g, w in zip(got["loss"], want["loss"])]
    gmed = float(np.median(list(want["grad"].values())))
    grad = [abs(got["grad"][n] - w) / max(w, gmed)
            for n, w in want["grad"].items()]
    out = {"loss1_rel": worst(loss[:1]), "grad_gap": worst(grad),
           "grad_gap_median": median(grad)}
    if len(got["loss"]) < len(want["loss"]):
        return out
    cmed = float(np.median(list(want["change"].values())))
    moved = [n for n, w in want["grad"].items() if w >= skip_below * gmed]
    change = [abs(got["change"][n] - want["change"][n])
              / max(want["change"][n], cmed) for n in moved]
    return {**out, "loss_rel": worst(loss), "change_gap": worst(change),
            "change_gap_median": median(change)}


def median(gaps) -> float:
    """The median gap; infinite if any is not finite."""
    vals = np.asarray(list(gaps), np.float64)
    return float(np.median(vals)) if np.isfinite(vals).all() \
        else float("inf")


def worst(gaps) -> float:
    """The largest gap; infinite if any is not finite (a NaN fails)."""
    vals = np.asarray(list(gaps), np.float64)
    return float(vals.max()) if np.isfinite(vals).all() else float("inf")


def over_baseline(gaps: Dict, base: Dict) -> Dict:
    """Each of the baseline's gaps (the reference with its products rounded
    to the configuration's precision, against the float32 reference) as
    the scale of the same gap of ``gaps``: ``<name>_over_baseline``, how
    far the program lies from the reference in units of a sound
    computation in that precision of the same steps (infinite if the gap
    is not finite)."""
    return {f"{n}_over_baseline": gaps[n] / max(b, 1e-30)
            if np.isfinite(gaps[n]) else float("inf") for n, b in base.items()}


def limit_checks(gaps: Dict, limits: Dict) -> list:
    """The compared gaps, each beside its limit (``limits``: name ->
    limit; a gap with no limit is read but not compared)."""
    return [{"name": n, "value": gaps[n], "limit": lim,
             "ok": gaps[n] <= lim} for n, lim in limits.items()]


def verdict(gaps: Dict, limits: Dict) -> Dict:
    """One reading's compared numbers beside their limits and whether it
    comes out correct: the program's, or a control's or a planted fault's
    read in the program's place (which has to come out not correct)."""
    checks = limit_checks(gaps, limits)
    return {"correct": bool(checks) and all(c["ok"] for c in checks),
            "checks": {c["name"]: [c["value"], c["limit"]] for c in checks}}
