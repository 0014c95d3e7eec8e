"""A tiny training cell, run on the CPU through the harness
as the benchmark's command runs it (the chip check skipped): correct
against the reference, and the result line's keys and metrics."""
import time

import pytest

from meshbench.harness import make_cell, run_cell
from meshbench.registry import Registry

SEED = 2**31 + 977


def _run(root, workload, **kw):
    reg = Registry(root)
    cell = make_cell(reg, workload, kw.pop("seed", SEED), kw.pop("seconds",
                                                                 0.5),
                     False, "cpu", time.perf_counter(), **kw)
    return reg, run_cell(reg, cell)


@pytest.mark.parametrize("workload", ["grid.train"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_cell_is_correct(workload, dtype, root32, root16):
    root = root32 if dtype == "float32" else root16
    reg, (result, lines) = _run(root, workload)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {m["name"] for m in
                                      reg.end_to_end(workload)}
    assert result["attempted"] > 0 and result["failed"] == 0
    for m in result["metrics"].values():
        assert m["value"] > 0
    # the check lines close standard error, one per compared number
    checks = lines[-len(result["checks"]):]
    assert all(line.startswith("check ") and " limit " in line
               for line in checks)
    assert not any(line.startswith("check ")
                   for line in lines[:-len(result["checks"])])
