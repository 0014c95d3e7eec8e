"""The yardstick's arithmetic against hand counts on a small grid mesh:
the model's operations per train step and eval step, a
kernel call's least time, the columns a call needs, and the trace's busy
time and idle gaps."""
import math

import numpy as np
import pytest

from meshbench import trace
from meshbench.reference import mesh as ref_mesh
from meshbench.tests.tiny import grid_obj
from meshbench.workcount import (HBM_BYTES_PER_S, PEAK_FLOPS, ModelShape,
                                 needed_columns, spmm_call_seconds,
                                 spmm_least_seconds)

CFG = {"num_conv_filters": [16, 16, 16, 32, 32], "polygon_order": [3] * 5,
       "n_layers": 4, "num_hidden": 512, "num_style": 16, "num_classes": 2}


@pytest.fixture(scope="module")
def shape(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("grid") / "g.obj")
    grid_obj(path, 16)
    v, f = ref_mesh.template(path)
    return ModelShape(ref_mesh.hierarchy(v, f, [2, 2, 2, 2]), CFG)


def test_operations_match_a_hand_count(shape):
    n, nnz = shape.n, shape.nnz
    # a 16 x 16 grid: 256 vertices; each interior vertex has 6 neighbours
    assert n[0] == 256
    assert nnz[0] == 2 * (15 * 16 * 2 + 15 * 15)
    k = 3
    enc = 0
    chans = [3, 16, 16, 16, 32]
    for i in range(4):
        fi, fo = chans[i], chans[i + 1]
        enc += (k - 1) * 2 * nnz[i] * fi + 2 * n[i] * k * fi * fo
        enc += 2 * n[i + 1] * fo            # the down-pool selects
    flat = n[4] * 32
    enc += 2 * flat * 512
    heads = 2 * 512 * 2 + 2 * 2 * (512 + 2) * 16
    dec = 2 * (16 + 2) * 512 + 2 * 512 * flat
    dchans = [32, 32, 16, 16, 16]            # decoder conv inputs
    douts = [32, 16, 16, 16]
    for i in range(4):
        lvl = 3 - i
        fi, fo = dchans[i], douts[i]
        dec += 2 * shape.up_nnz[lvl] * fi
        dec += (k - 1) * 2 * nnz[lvl] * fi + 2 * n[lvl] * k * fi * fo
    # the final conv: the coarsest level's corner, one product elsewhere
    dec += (k - 1) * 2 * nnz[4] * 16 + 2 * n[4] * k * 16 * 3
    dec += 2 * (n[0] - n[4]) * 16 * 3
    assert shape.encode() == enc
    assert shape.heads() == heads
    assert shape.decode() == dec
    assert shape.train_step(4) == 3 * 4 * (enc + heads + dec)
    assert shape.eval_step(4) == 4 * (2 * enc + heads + 2 * dec
                                      + 2 * 512 * 2)
    assert all(d == m for d, m in zip(shape.down_nnz, n[1:]))


def test_a_kernel_call_least_time_is_its_csr_bytes():
    # bf16, 1,000 rows, 6,000 nonzeros, 128 columns, one seed: a 2-byte
    # value and a 4-byte column per nonzero, 1,001 row pointers, x, the
    # seed and y
    want = (6000 * 6 + 4 * 1001 + 2 * 128 * 1000 * 3) / HBM_BYTES_PER_S
    assert spmm_call_seconds("bf16", 1000, 6000, 128, 1) == want
    # bf16x3 counts six operations per nonzero per column at the bf16 peak
    ops = 6 * 6000 * 1_000_000 / PEAK_FLOPS["bf16"]
    assert spmm_call_seconds("bf16x3", 1000, 6000, 1_000_000, 0) == max(
        ops, (6000 * 8 + 4 * 1001 + 4 * 1_000_000 * 1000 * 2)
        / HBM_BYTES_PER_S)


def test_padding_columns_are_not_work():
    widths = [3, 16, 32]
    assert needed_columns(128, [32], widths) == 96      # 3 padded to 4
    assert needed_columns(128, [16], widths) == 48      # 3 padded to 8
    assert needed_columns(512, [32], widths) == 512
    assert needed_columns(2048, [32, 64], widths) == 2048
    assert needed_columns(256, [32, 64], widths) == 192  # 2B rows, 3 -> 4


def test_least_seconds_sums_the_counted_calls(shape):
    calls = {("fp32", 256, 256, 64, "a1"): 2,
             ("fp32", 256, 256, 64, "a2 plus prev"): 3}
    got = spmm_least_seconds(calls, shape, [4])
    one = spmm_call_seconds("fp32", 256, shape.nnz[0], 64, 0)
    two = spmm_call_seconds("fp32", 256, shape.nnz[0], 64, 2)
    assert math.isclose(got, 2 * one + 3 * two)
    with pytest.raises(ValueError):
        spmm_least_seconds({("fp32", 999, 999, 64, "a1"): 1}, shape, [4])


def test_trace_window_busy_time_and_gaps():
    dev = [(0.0, 1.0, "k1"), (0.5, 2.0, "k2"), (3.0, 4.0, "k1"),
           (6.0, 6.5, "CatArrayBatchedCopy")]
    host = [(0.0, 10.0, "meshbench.train_epoch"), (2.2, 2.9, "cudaGraphLaunch"),
            (4.1, 5.9, "aten::copy_")]
    win = trace.Window(dev, host, 10.0)
    assert win.busy_s == pytest.approx(2.0 + 1.0 + 0.5)
    assert win.device_seconds(lambda n: n == "k1") == pytest.approx(2.0)
    assert win.top_ops(1) == [["k1", 2.0]]
    gaps = dict(win.idle_by_host())
    assert gaps["cudaGraphLaunch"] == pytest.approx(1.0)
    assert gaps["aten::copy_"] == pytest.approx(2.0)
    assert np.isclose(sum(gaps.values()), 3.0)
