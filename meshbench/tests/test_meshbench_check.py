"""The correctness check fails what it must: the control (the reference
one precision below the configuration's, in the program's place) and a
fault planted in the timed path, at a size a test run holds."""
import time

import pytest

from meshbench import judge
from meshbench.harness import make_cell, run_cell
from meshbench.registry import Registry

SEED = 2**31 + 4099


def _cell(root, workload, **kw):
    reg = Registry(root)
    return reg, make_cell(reg, workload, SEED, 0.3, False, "cpu",
                          time.perf_counter(), **kw)


@pytest.mark.parametrize("workload,dtype,control", [
    ("grid.train", "float32", "tf32"), ("grid.train", "bfloat16", "fp8")])
def test_control_is_not_correct(workload, dtype, control, root32, root16):
    root = root32 if dtype == "float32" else root16
    reg, cell = _cell(root, workload, control=control, readings_only=True)
    out = reg.driver(cell.traffic["driver"]).run(cell)
    correct, _ = judge.judge(out.numbers, cell.limits)
    assert not correct, out.numbers


@pytest.mark.parametrize("fault", ["frozen_state", "half_batch",
                                   "duplicate_rows"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fault_in_the_timed_path_is_not_correct(fault, dtype, root32,
                                                root16):
    root = root32 if dtype == "float32" else root16
    reg, cell = _cell(root, "grid.train", fault=fault)
    result, _ = run_cell(reg, cell)
    assert not result["correct"], result["checks"]
    # a fault that reads the wrong rows fails a number taken from the
    # rows' content, not only the count of rows
    if fault == "duplicate_rows":
        assert result["checks"]["rows_gap"]["value"] == 0
        assert any(not c["value"] <= c["limit"]
                   for k, c in result["checks"].items()
                   if not k.endswith("rows_gap"))


def test_a_nan_reads_as_infinitely_far():
    ev = {"loss": 1.0, "error": 1.0, "rows": 4.0}
    ref = {"loss": [1.0], "rows": [4.0], "grad_norm": {"a": 1.0},
           "update_norm": {"a": 1.0}, "raw_grad_norm": {"a": 1.0},
           "eval": ev}
    prog = {"loss": [float("nan")], "rows": [4.0], "grad_norm": {"a": 1.0},
            "update_norm": {"a": 1.0}, "eval": dict(ev, error=float("nan"))}
    numbers = judge.train_numbers(prog, ref)
    assert numbers["loss_gap"] == float("inf")
    assert numbers["eval_error_gap"] == float("inf")
    assert not judge.judge(numbers, {"loss_gap": 1, "grad_gap": 1,
                                     "update_gap": 1})[0]
