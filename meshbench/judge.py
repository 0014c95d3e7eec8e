"""The numbers that decide ``correct``, each a widest gap between what the
timed path produced and what the reference works out from the same
inputs. Pure arithmetic on readings; it imports nothing of the program.

Training (the first three steps of the trainer that the window then
drives, replays of its captured step graph):
  loss_gap    the largest relative gap of a step's loss;
  grad_gap    the worst leaf's gap between the norms of the first gradient
              as Adam takes it (L2 included), against the reference's norm
              of that leaf or of the median leaf, whichever is larger;
  update_gap  the same for the norms of each leaf's change after three
              steps, over the leaves whose raw reference gradient is at
              least a thousandth of the median leaf's (a leaf whose
              gradient is nought to rounding moves by round-off alone);
  grad_gap_median, update_gap_median  the median leaf's gap of the first
              gradient and of the change, steadier from seed to seed than
              the worst leaf's;
  grad_gap_dtype, grad_gap_dtype_median  grad_gap and grad_gap_median
              against the reference rounded as the configuration computes
              (bfloat16), which carries the same rounding of the gradient
              as the program: the first gradient's content, held closer
              than float32's reference can hold it;
  rows_gap    the largest difference between the rows a step counted
              (its packed ``count``) and the batch's real rows (exact).
The light evaluation step (one replay of the window's eval step graph, at
the seed's weights, on the first rows of the validation split):
  eval_loss_gap   the relative gap of its loss;
  eval_error_gap  the relative gap of its mean per-mesh pose error (the
              reconstruction taken back to each mesh's original pose);
  eval_rows_gap   the rows it counted against the batch's (exact).
The limits file of a cell names the numbers it compares.
"""
from __future__ import annotations

import numpy as np


def _finite(v: float) -> float:
    """A gap, with any NaN read as infinitely far."""
    return float(v) if np.isfinite(v) else float("inf")


def _leaf_gaps(prog: dict, ref: dict, names) -> np.ndarray:
    med = float(np.median([ref[k] for k in names]))
    return np.array([abs(prog[k] - ref[k]) / max(ref[k], med)
                     for k in names])


def _relative(a: float, b: float) -> float:
    return _finite(abs(a - b) / abs(b))


def train_numbers(prog: dict, ref: dict, at_dtype: dict | None = None
                  ) -> dict:
    """prog / ref: {"loss": [...], "rows": [...], "grad_norm": {leaf:
    norm}, "update_norm": {leaf: norm}, "eval": {"loss", "error",
    "rows"}}; ref also "raw_grad_norm". at_dtype: the reference's
    "grad_norm" at the configuration's own precision, where that is below
    float32."""
    lp, lr = np.asarray(prog["loss"]), np.asarray(ref["loss"])
    loss_gap = _finite(np.max(np.abs(lp - lr) / np.abs(lr)))
    names = sorted(ref["grad_norm"])
    raw = ref["raw_grad_norm"]
    med_raw = float(np.median([raw[k] for k in names]))
    moving = [k for k in names if raw[k] >= 1e-3 * med_raw]
    update = _leaf_gaps(prog["update_norm"], ref["update_norm"], moving)
    grad = _leaf_gaps(prog["grad_norm"], ref["grad_norm"], names)
    pe, re_ = prog["eval"], ref["eval"]
    out = {"loss_gap": loss_gap,
           "grad_gap": _finite(np.max(grad)),
           "grad_gap_median": _finite(np.median(grad)),
           "update_gap": _finite(np.max(update)),
           "update_gap_median": _finite(np.median(update)),
           "rows_gap": _finite(np.max(np.abs(np.asarray(prog["rows"])
                                             - np.asarray(ref["rows"])))),
           "eval_loss_gap": _relative(pe["loss"], re_["loss"]),
           "eval_error_gap": _relative(pe["error"], re_["error"]),
           "eval_rows_gap": _finite(abs(pe["rows"] - re_["rows"]))}
    if at_dtype is not None:
        grad = _leaf_gaps(prog["grad_norm"], at_dtype["grad_norm"], names)
        out.update(grad_gap_dtype=_finite(np.max(grad)),
                   grad_gap_dtype_median=_finite(np.median(grad)))
    return out


def judge(numbers: dict, limits: dict | None) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}} of the numbers the limits
    name): correct when each is finite and within its limit. Without
    limits (a calibration run) every number is returned, unjudged, and
    correct is False."""
    if limits is None:
        return False, {k: {"value": v, "limit": None}
                       for k, v in numbers.items()}
    checks = {k: {"value": numbers[k], "limit": limit}
              for k, limit in limits.items()}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return bool(ok), checks
