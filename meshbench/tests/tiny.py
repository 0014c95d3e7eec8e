"""A tiny copy of the benchmark for the CPU tests: a 32 x 32 grid mesh as
the template, the published widths, K 3, batch 4, and a training cell in a
temporary root that holds BENCHMARK.json and the data files the registry
finds by name."""
from __future__ import annotations

import json
import os
import shutil

from meshbench.registry import PACKAGE_DIR

GRID = 32
# the tiny cell's limits, set from CPU readings over six seeds of the
# program (lower) and two of the control and of each fault (upper) at this
# size. float32: loss 0-8e-8, grad 5e-6-2.9e-5, update 4e-7-1.9e-4, eval
# loss 0-8e-8, eval error 0-1e-7; TF32's 8e-8-6.4e-7, 1.4e-3-2.3e-3,
# 5.4e-3-7.8e-3, 8e-8, 4e-7-7e-7. bfloat16: loss 2.4e-7-1.9e-6, grad
# 0.015-0.084, update 0.009-0.018, eval loss 8e-8-1.4e-6, eval error
# 1.7e-6-1.2e-5, grad against the bfloat16 reference 0.018-0.073 (median
# leaf 0.0018-0.0036); fp8's 6.6e-6-3e-5, 0.13-0.26, 0.037-0.075,
# 4.3e-6-3.2e-5, 4.6e-5-3.3e-4, 0.13-0.24 (0.03-0.04). Half a batch or its
# first half read twice: loss 0.0047-0.0075 on both; every step counts its
# batch's rows
LIMITS = {"float32": {"loss_gap": 1e-6, "grad_gap": 3e-4,
                      "update_gap": 1e-3, "rows_gap": 0,
                      "eval_loss_gap": 1e-6, "eval_error_gap": 3e-6,
                      "eval_rows_gap": 0},
          "bfloat16": {"loss_gap": 4e-6, "grad_gap": 0.12,
                       "update_gap": 0.03, "rows_gap": 0,
                       "grad_gap_dtype": 0.12,
                       "grad_gap_dtype_median": 0.01,
                       "eval_loss_gap": 4e-6, "eval_error_gap": 4e-5,
                       "eval_rows_gap": 0}}


def grid_obj(path: str, n: int = GRID) -> None:
    """An n x n vertex grid, two triangles per square, in the z = 0 plane
    bent by a smooth bump (so no vertex is degenerate for the alignment)."""
    lines = []
    for i in range(n):
        for j in range(n):
            x, y = i / (n - 1), j / (n - 1)
            lines.append("v %f %f %f" % (x, y, 0.2 * (x - 0.5) ** 2
                                         + 0.1 * y * x))
    for i in range(n - 1):
        for j in range(n - 1):
            a, b = i * n + j + 1, i * n + j + 2
            c, d = (i + 1) * n + j + 1, (i + 1) * n + j + 2
            lines += [f"f {a} {b} {d}", f"f {a} {d} {c}"]
    with open(path, "w") as fp:
        fp.write("\n".join(lines) + "\n")


def make_root(tmp: str, dtype: str = "float32") -> str:
    """A root with BENCHMARK.json, a copy of meshbench's data files and
    the tiny config ``grid`` (compute dtype `dtype`) and the cell
    ``grid.train``. Returns the root."""
    root = os.path.join(tmp, "root")
    pkg = os.path.join(root, "meshbench")
    shutil.copytree(PACKAGE_DIR, pkg, ignore=shutil.ignore_patterns(
        "_cache", "__pycache__", "tests"))
    template = os.path.join(tmp, "grid.obj")
    grid_obj(template)
    with open(os.path.join(pkg, "configs", "vae80k.json")) as fp:
        config = json.load(fp)
    bf16 = dtype == "bfloat16"
    config.update(
        name="grid", mesh={"template": template, "subdivisions": 0},
        peak={"name": "bf16" if bf16 else "tf32",
              "flops_per_s": 989e12 if bf16 else 495e12})
    config["program"].update(
        template=template, polygon_order=[3, 3, 3, 3, 3], batch_size=4,
        compute_dtype=dtype, matmul_precision="default" if bf16 else "high")
    with open(os.path.join(pkg, "configs", "grid.json"), "w") as fp:
        json.dump(config, fp)
    with open(os.path.join(pkg, "traffic", "train.json")) as fp:
        train = json.load(fp)
    train.update(train_meshes=16, valid_meshes=8, profile_epochs=1)
    with open(os.path.join(pkg, "traffic", "grid_train.json"), "w") as fp:
        json.dump(train, fp)
    with open(os.path.join(pkg, "limits", "grid.train.json"), "w") as fp:
        json.dump(LIMITS[dtype], fp)
    with open(os.path.join(PACKAGE_DIR, os.pardir, "BENCHMARK.json")) as fp:
        bench = json.load(fp)
    bench["configs"].append({"name": "grid", "source": "test",
                             "file": "meshbench/configs/grid.json",
                             "reduced": [], "why": "CPU tests"})
    bench["workloads"] += [
        {"name": "grid.train", "config": "grid", "traffic": "grid_train",
         "chips": 1, "why": "CPU tests"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("grid.train")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fp:
        json.dump(bench, fp)
    return root
