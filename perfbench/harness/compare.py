"""The comparison that decides ``correct`` for a training cell.

The numbers, each of the program's readings against the reference's over the steps
the reference follows:

* ``loss0_gap``: the gap between the program's loss and the reference's at the first
  step (the later steps' losses follow a trajectory that amplifies rounding: their
  gaps swing from seed to seed far more than the first step's);
* ``grad_gap``: the worst leaf's gap between the norms of the first gradient (the
  program's worked out from its optimizer state after one step), measured against
  the reference's norm of that leaf or of the median leaf, whichever is larger;
* ``grad_proj_gap``: the first gradient to first order.  For each leaf, a fixed
  Gaussian direction r drawn from the run's seed (``weights.project``): the worst
  leaf's gap between the program's <r, g> (its g from the moments, as above) and the
  reference's, over the reference's gradient norm of that leaf or of the median
  leaf, whichever is larger.
  E|<r, d>| = sqrt(2/pi) |d| for an error d, so this reads the gradient's whole
  relative error, where ``grad_gap`` sees only its part along g: an error
  orthogonal to the gradient moves a norm at second order only;
* ``change_gap``: the same as ``grad_gap`` for the norm of each parameter's change
  over the steps, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (a key bias under softmax moves by round-off
  alone).

A cell's ``perfbench/checks/<cell>.json`` names the numbers it compares, each with
its limit; every number is printed.
"""

from __future__ import annotations

import math
import statistics

from harness.reference import Readings

#: a leaf whose first gradient in the reference is under this share of the median
#: leaf's is left out of ``change_gap``
STILL_LEAF = 1e-3


def _worst(prog: dict, ref: dict, names, scale: dict | None = None) -> tuple[float, str]:
    """The worst leaf's gap, over the leaf's ``scale`` (the reference's reading by
    default) or the median leaf's, whichever is larger."""
    scale = ref if scale is None else scale
    floor = statistics.median(scale[n] for n in names)
    return max((abs(prog[n] - ref[n]) / max(scale[n], floor, 1e-30), n) for n in names)


def gaps(prog: Readings, ref: Readings) -> tuple[dict[str, float], dict[str, str]]:
    """Every number, and where each was set (the step, or the leaf)."""
    if not (prog.grad_norms.keys() == prog.grad_proj.keys() == ref.grad_norms.keys()
            == ref.grad_proj.keys()):
        raise ValueError("the program's leaves differ from the reference's")
    names = list(ref.grad_norms)
    median_grad = statistics.median(ref.grad_norms.values())
    moving = [n for n in names if ref.grad_norms[n] >= STILL_LEAF * median_grad]
    if len(prog.losses) != len(ref.losses):
        raise ValueError("the program ran other steps than the reference")
    found = {"loss0_gap": (abs(prog.losses[0] - ref.losses[0]), "step 0"),
             "grad_gap": _worst(prog.grad_norms, ref.grad_norms, names),
             "grad_proj_gap": _worst(prog.grad_proj, ref.grad_proj, names, ref.grad_norms),
             "change_gap": _worst(prog.change_norms, ref.change_norms, moving)}
    return ({k: v for k, (v, _) in found.items()}, {k: at for k, (_, at) in found.items()})


def verdict(numbers: dict[str, float], limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers ``limits`` names:
    correct when every one is finite and at or under its limit."""
    checks = {name: {"value": numbers[name], "limit": limit["limit"]}
              for name, limit in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
