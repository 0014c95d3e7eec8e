"""One run of one cell: the configuration, traffic, limits and metric
readers found by name (registry.py), the traffic's driver run against the
program, and the result assembled as the run's last line.

A driver's ``run(cell)`` does the set-up, the measured window, an optional
profiled sub-window after it, and the correctness check, and returns an
``Outcome``. The harness then picks the metrics the cell reports
(BENCHMARK.json's end-to-end and per-layer lists) and calls each per-layer
metric's reader on the outcome's context.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time

from .registry import Registry

# top-level module names the process must not hold: the JAX package of
# this repository and JAX itself (compared whole: the port's package name
# begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "meshvae_tpu")

CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_cache")


@dataclasses.dataclass
class Cell:
    workload: str
    config: dict
    traffic: dict
    limits: dict | None
    seed: int
    seconds: float
    trace: bool
    device: str
    root: str
    t_start: float
    # calibration and tests: the reference at this precision in the
    # program's place, a fault planted in the program, no measured window
    control: str | None = None
    fault: str | None = None
    readings_only: bool = False
    # lines for standard error: (phase, seconds since the process
    # started) and notes on the run
    phases: list = dataclasses.field(default_factory=list)
    notes: list = dataclasses.field(default_factory=list)

    def mark(self, phase: str) -> None:
        self.phases.append((phase, time.perf_counter() - self.t_start))


@dataclasses.dataclass
class Outcome:
    end_to_end: dict
    context: dict
    numbers: dict
    attempted: int
    failed: int
    memory_peak_bytes: int = 0
    busy_s: float | None = None
    window_s: float | None = None
    breakdown: dict | None = None


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def program_config(cell: Cell) -> dict:
    """The program's config dict: its defaults, then every key the
    configuration file states, paths resolved in the checkout and the
    hierarchy cache at a fixed directory inside it."""
    from meshvae_tpu_torch.config import default_config

    config = default_config()
    config.update(cell.config["program"])
    config["template"] = os.path.join(cell.root, config["template"])
    config["hierarchy_cache_dir"] = os.path.join(CACHE_DIR,
                                                 "program_hierarchy")
    return config


def make_cell(registry: Registry, workload: str, seed: int, seconds: float,
              trace: bool, device: str, t_start: float, **kw) -> Cell:
    w = registry.workload(workload)
    limits = kw.pop("limits", "registry")
    return Cell(workload=workload, config=registry.config(w["config"]),
                traffic=registry.traffic(w["traffic"]),
                limits=(registry.limits(workload) if limits == "registry"
                        else limits),
                seed=seed, seconds=seconds, trace=trace, device=device,
                root=registry.root, t_start=t_start, **kw)


def run_cell(registry: Registry, cell: Cell) -> tuple[dict, list[str]]:
    """The result line's dict and the check lines for standard error."""
    from .judge import judge

    driver = registry.driver(cell.traffic["driver"])
    out = driver.run(cell)
    correct, checks = judge(out.numbers, cell.limits)
    if cell.trace:
        metrics = {}
        for m in registry.per_layer(cell.workload):
            value = registry.metric_reader(m["name"])(out.context)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        # a metric "base.qualifier" is the driver's "base", measured in
        # the cells it lists (cells of unlike noise get bounds of their own)
        metrics = {m["name"]: {"value": out.end_to_end.get(
                       m["name"], out.end_to_end.get(m["name"].split(".")[0])),
                       "unit": m["unit"]}
                   for m in registry.end_to_end(cell.workload)}
    device = {"platform": "gpu" if cell.device == "cuda" else cell.device,
              "kind": out.context.get("device_kind", cell.device),
              "count": 1, "memory_peak_bytes": out.memory_peak_bytes}
    if cell.trace:
        device.update(busy_s=out.busy_s, window_s=out.window_s)
    result = {"correct": correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": device}
    if cell.trace and out.breakdown is not None:
        result["breakdown"] = out.breakdown
    result["checks"] = checks
    lines = [f"phase {name} {t:.3f} s" for name, t in cell.phases]
    lines += cell.notes
    lines += [f"check {k} {c['value']!r} limit {c['limit']!r}"
              for k, c in checks.items()]
    return result, lines
