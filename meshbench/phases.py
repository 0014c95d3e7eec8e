"""The program's phase records of the measured window, for the readers of
forward_ms, backward_ms, optimizer_ms, eval_step_ms and step_gap_ms.

Each scanned epoch the program finalizes leaves one record in
``meshvae_tpu_torch.train.phases.RECORDS``: its kind, its step count,
whether a profiler ran when it was queued, whether every step replayed a
captured graph, each phase's device ms per step (marks written by the
device's clock inside the step graphs) and the gaps between steps. The
window's records are the train records of the window's train steps per
epoch and the light evaluation records of its eval steps per epoch, taken
unprofiled and replayed: that leaves out the one-batch checked epochs,
the warm-up epoch (its first steps warm up and capture) and the traced
sub-window. A program without the marks (an older checkout) leaves
none, and the readers return None.
"""
from __future__ import annotations

import numpy as np


def window(ctx) -> dict | None:
    """{"train": [records], "light": [records]} of the window, or None
    when it left none."""
    try:
        from meshvae_tpu_torch.train import phases
    except ImportError:
        return None
    shape = ctx.get("steps_per_epoch")
    if not shape:
        return None
    steps = {"train": shape[0], "light": shape[1]}
    picked = {"train": [], "light": []}
    for rec in list(phases.RECORDS):
        if (rec["kind"] in steps and rec["steps"] == steps[rec["kind"]]
                and rec["steps"] > 1 and rec["replayed"]
                and not rec["profiled"]):
            picked[rec["kind"]].append(rec)
    return picked if picked["train"] or picked["light"] else None


def train_phase_ms(ctx, phase: str) -> float | None:
    """The median over the window's train epochs of each epoch's mean
    device ms per step in `phase`."""
    recs = window(ctx)
    if recs is None or not recs["train"]:
        return None
    return float(np.median([rec["phases"][phase].mean()
                            for rec in recs["train"]]))


def eval_step_ms(ctx) -> float | None:
    """The median over the window's light evaluations of each one's mean
    device ms per eval step, from its start mark to its last."""
    recs = window(ctx)
    if recs is None or not recs["light"]:
        return None
    return float(np.median([sum(rec["phases"].values()).mean()
                            for rec in recs["light"]]))


def step_gap_ms(ctx) -> float | None:
    """The mean over every gap between two steps of the window's train and
    light epochs: the next step's start mark less this step's last."""
    recs = window(ctx)
    if recs is None:
        return None
    gaps = np.concatenate([rec["gap"] for rec in
                           recs["train"] + recs["light"]])
    return float(gaps.mean()) if gaps.size else None
