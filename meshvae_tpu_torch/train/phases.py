"""Where the scanned epoch's time goes, measured inside the program: device
phase marks inside the step graphs and guarded host spans around the
train loop's calls.

Phase marks. Each step of a scanned epoch (train/loop.py) stamps the
device's clock at the boundaries of its phases into row ``step`` of an
int64 [S, P] buffer staged beside its outputs (``_scan_outs``): on a card
a one-thread kernel (``ops/csrc/phase_mark.cu``) writes ``%globaltimer``,
reading the row from the scan's device-side step index, so a captured step
writes a new row at each replay; on the CPU the host writes
``time.monotonic_ns()`` into the same place. The slots (SLOTS):

  train  start, forward (the batch gather and the loss), backward (with
         the gradients' reduction), optimizer (Adam), metrics (the pose
         error, the packed metrics and their row written)
  eval   start, eval_forward (the loss and the pose error),
         eval_counterfactual (the sex-change decode, its re-encode and
         pose error, and the rows written)

A trainer may time parts of its train step's phases without changing
them: it declares sub-phases (``Trainer.sub_phases``, name -> (first
mark, last mark)), and each mark they name that no slot is becomes one
more column of the same buffer, after the slots (columns), stamped by the
trainer's objective. The sub-phases travel with the stamps, so this
module names no model.

The stamps come back in the epoch's one pull (graphs.HostCopy ``beside``
the outputs). Finalizing the epoch appends one record to RECORDS: the
kind ("train", "light", "errors", "collect"), the step count, whether a
profiler ran when the epoch was queued, whether every step replayed an
already captured graph, each phase's ms per step, each sub-phase's ms per
step and the gap in ms from each step's last slot mark to the next step's
start. LAUNCHES counts the marks per column, a replayed graph's included
(train/graphs.py).

Host spans. ``span(name)`` is a torch.profiler range "meshvae.<name>"
while a profiler runs and a shared no-op otherwise, so the step path
creates no RecordFunction in an unprofiled run: stage, shuffle,
step.<kind>, warm_up.<kind> and capture.<kind> (train/graphs.py), pull
(HostCopy.wait), finalize.<kind>.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import time

import numpy as np
import torch

SLOTS = {"train": ("start", "forward", "backward", "optimizer", "metrics"),
         "eval": ("start", "eval_forward", "eval_counterfactual")}

# one record per finalized epoch with marks, oldest dropped first; readers
# (meshbench/metrics/, the driver's epoch line) select by kind and shape
RECORDS: collections.deque = collections.deque(maxlen=4096)
_recorded = 0  # records ever appended (RECORDS drops the oldest)
LAUNCHES: dict = {}  # marks written, by slot name


def reset_launches() -> None:
    LAUNCHES.clear()

_NO_SPAN = contextlib.nullcontext()


def slots(kind: str) -> tuple:
    """The mark slots of a kind of scanned step ("train" or an eval kind)."""
    return SLOTS["train" if kind == "train" else "eval"]


def columns(kind: str, sub_phases: dict) -> tuple:
    """The stamps' columns of a kind of scanned step: the kind's slots,
    then each mark of `sub_phases` (name -> (first, last)) that no slot
    is, in the order they are named."""
    out = slots(kind)
    for pair in sub_phases.values():
        out += tuple(name for name in pair if name not in out)
    return out


def span(name: str):
    """A host range "meshvae.<name>" when a profiler runs, else a no-op."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function("meshvae." + name)
    return _NO_SPAN


def unmarked(name: str) -> None:
    """The mark of a step that records none."""


@functools.cache
def _lib():
    from ..ops._build import load_library

    lib = load_library("phase_mark")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.phase_mark.argtypes = [p, p, i, i, p]
    lib.phase_mark.restype = ctypes.c_int
    return lib


class Marks:
    """The mark of one staged epoch's steps: ``marks(name)`` stamps slot
    `name` of row ``step`` of ``stamps`` [S, P] (int64, on the device of
    the step index ``step`` [1])."""

    def __init__(self, stamps: torch.Tensor, step: torch.Tensor,
                 slots: tuple):
        if stamps.dtype != torch.int64 or step.dtype != torch.int64:
            raise TypeError("stamps and the step index must be int64")
        if stamps.shape[1] != len(slots) or not stamps.is_contiguous():
            raise ValueError(f"stamps must be a contiguous [S, {len(slots)}]")
        if stamps.device != step.device:
            raise ValueError("stamps and the step index on one device")
        self.stamps, self.step = stamps, step
        self.slot = {name: i for i, name in enumerate(slots)}

    def __call__(self, name: str) -> None:
        slot = self.slot[name]
        LAUNCHES[name] = LAUNCHES.get(name, 0) + 1
        if self.stamps.device.type != "cuda":
            self.stamps[int(self.step), slot] = time.monotonic_ns()
            return
        with torch.cuda.device(self.stamps.device):
            stream = torch.cuda.current_stream(self.stamps.device).cuda_stream
            rc = _lib().phase_mark(self.stamps.data_ptr(),
                                   self.step.data_ptr(),
                                   self.stamps.shape[1], slot, stream)
        if rc != 0:
            raise RuntimeError(f"phase_mark launch failed: CUDA error {rc}")


def pending(kind: str, stamps: torch.Tensor, replayed: bool,
            sub_phases: dict) -> dict:
    """What an epoch's record needs, for HostCopy's ``beside``: the kind,
    the stamps, the names of their columns, the sub-phases they time,
    whether every step replayed a captured graph and whether a profiler
    runs now, as the epoch is queued."""
    return {"kind": kind, "stamps": stamps, "replayed": replayed,
            "profiled": torch.autograd._profiler_enabled(),
            "columns": columns(kind, sub_phases),
            "sub_phases": dict(sub_phases)}


def record(beside) -> dict | None:
    """The record of an epoch whose HostCopy has been waited for (None
    when it carried no stamps), appended to RECORDS."""
    global _recorded
    if beside is None:
        return None
    stamps = np.asarray(beside["stamps"], dtype=np.int64)
    main = slots(beside["kind"])
    col = {name: i for i, name in enumerate(beside["columns"])}
    at = lambda name: stamps[:, col[name]]
    rec = {"kind": beside["kind"], "steps": int(stamps.shape[0]),
           "profiled": bool(beside["profiled"]),
           "replayed": bool(beside["replayed"]),
           "phases": {b: (at(b) - at(a)) * 1e-6
                      for a, b in zip(main, main[1:])},
           "sub_phases": {name: (at(b) - at(a)) * 1e-6
                          for name, (a, b) in beside["sub_phases"].items()},
           "gap": (at(main[0])[1:] - at(main[-1])[:-1]) * 1e-6}
    RECORDS.append(rec)
    _recorded += 1
    return rec


def recorded() -> int:
    """How many records were ever appended (for ``since``)."""
    return _recorded


def since(count: int) -> list[dict]:
    """The records appended after recorded() returned `count`."""
    new = min(_recorded - count, len(RECORDS))
    return list(RECORDS)[len(RECORDS) - new:] if new > 0 else []


def epoch_line(epoch: int, records: list[dict]) -> str | None:
    """The run log's line of one epoch's records: the median ms per step
    of each phase and sub-phase of each kind, and the mean gap between
    steps."""
    if not records:
        return None
    parts = []
    for rec in records:
        timed = {**rec["phases"], **rec["sub_phases"]}
        parts.append(f"{rec['kind']} " + " ".join(
            f"{name} {np.median(ms):.3f}" for name, ms in timed.items()))
    gaps = np.concatenate([rec["gap"] for rec in records])
    gap = f"{gaps.mean():.3f}" if gaps.size else "-"
    return (f"phases of epoch {epoch}, median ms per step: "
            + " | ".join(parts) + f" | step gap mean {gap}")
