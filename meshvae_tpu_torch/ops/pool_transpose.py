"""The pool backward's transpose product: dx = P^T @ g.

``pool_transpose`` launches the hand-written CUDA kernel
(``csrc/pool_transpose.cu``) for CUDA tensors and runs the plain PyTorch
twin ``pool_transpose_reference`` for CPU tensors. It replaces the TPU
kernels that meshvae_tpu/ops/pool.py ``_bsr_transpose_apply`` reaches
through ``_bsr_matmul_impl`` (meshvae_tpu/ops/pallas_cheb.py): the
column-major ``_make_colmajor_kernel`` (#7), the per-block
``_make_spmm_kernel`` (#5) and the row-grouped ``_make_grouped_kernel``
(#4) where it runs a P^T.

P^T is read in CSR (PoolOperator.t_ptr / t_col / t_val, built beside
t_bsr in graph.pool_operator), g [B, N_out, F] and dx [B, N_in, F] in
their model layout. The operator's dtype sets the mode: "fp32" (one fmaf
chain per output in ascending column order, the order in which
bsr_grouped_spmm's fp32 mode sums the block-sparse P^T, so the two give
the same bits) or "bf16" (the same chain on the widened values, one
rounding per output). The twin gathers in fp32 and rounds once; on the CPU
its order is the same, but it multiplies and adds in two roundings.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .graph import PoolOperator

DTYPES = {torch.float32: "fp32", torch.bfloat16: "bf16"}
MODES = tuple(DTYPES.values())

# Launches of the CUDA kernel per mode, and per (mode, rows of dx, rows of
# g, B * F): (n_in, n_out), or the row layout's (x_rows, g_rows). Counted
# where the wrapper launches it (never on the CPU twin path).
# Readers reset and read them around a run; train/graphs.py adds a CUDA
# graph's captured launches at each replay.
LAUNCHES = {mode: 0 for mode in MODES}
LAUNCHES_BY_SHAPE: dict[tuple[str, int, int, int], int] = {}


def reset_launches() -> None:
    for mode in MODES:
        LAUNCHES[mode] = 0
    LAUNCHES_BY_SHAPE.clear()


@functools.cache
def _lib():
    from ._build import load_library

    lib = load_library("pool_transpose")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pool_transpose.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.pool_transpose.restype = ctypes.c_int
    return lib


def _mode(pool: PoolOperator, g: torch.Tensor) -> str:
    if pool.t_ptr is None:
        raise ValueError("pool_transpose needs P^T in CSR (t_ptr, t_col, "
                         "t_val): pool_operator builds it above the fan-in "
                         "cutoff TGRAD_ELL_MAX")
    dtype = pool.t_val.dtype
    if dtype not in DTYPES or g.dtype != dtype:
        raise TypeError(f"pool_transpose takes fp32 or bf16 values and g in "
                        f"their dtype, got {dtype} and {g.dtype}")
    if g.dim() != 3 or g.shape[1] != pool.g_rows:
        raise ValueError(f"g must be [B, {pool.g_rows}, F], got "
                         f"{tuple(g.shape)}")
    return DTYPES[dtype]


def pool_transpose_reference(pool: PoolOperator,
                             g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin: dx[:, i] = sum_k t_val[k] * g[:, t_col[k]] over
    row i of the CSR, gathered and summed in fp32 (index_add_ in CSR order
    on the CPU), rounded once to the operator's dtype."""
    _mode(pool, g)
    b, _, f = g.shape
    rows = torch.repeat_interleave(
        torch.arange(pool.x_rows, device=g.device),
        torch.diff(pool.t_ptr.long()), output_size=pool.t_col.shape[0])
    terms = (pool.t_val.float()[None, :, None]
             * g.float()[:, pool.t_col.long()])
    dx = torch.zeros((b, pool.x_rows, f), dtype=torch.float32,
                     device=g.device)
    return dx.index_add_(1, rows, terms).to(g.dtype)


def _vec(f: int, size: int, *ptrs: int) -> int:
    """Elements per lane load: 16 bytes of them where they divide f and
    every pointer is 16-byte aligned, else 1."""
    vec = 16 // size
    return vec if f % vec == 0 and all(p % 16 == 0 for p in ptrs) else 1


def _launch(pool: PoolOperator, g: torch.Tensor, mode: str) -> torch.Tensor:
    b, n_out, f = g.shape
    dev = g.device
    nnz = pool.t_col.shape[0]
    for name, t, shape, dtype in (
            ("t_ptr", pool.t_ptr, (pool.x_rows + 1,), torch.int32),
            ("t_col", pool.t_col, (nnz,), torch.int32),
            ("t_val", pool.t_val, (nnz,), g.dtype)):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    g = g.contiguous()
    y = torch.empty((b, pool.x_rows, f), dtype=g.dtype, device=dev)
    vec = _vec(f, g.element_size(), g.data_ptr(), y.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().pool_transpose(
            pool.t_ptr.data_ptr(), pool.t_col.data_ptr(),
            pool.t_val.data_ptr(), g.data_ptr(), y.data_ptr(), pool.x_rows,
            n_out, f, b, MODES.index(mode), vec, stream)
    if rc != 0:
        raise RuntimeError(f"pool_transpose[{mode}] launch failed: CUDA "
                           f"error {rc}")
    return y


def pool_transpose(pool: PoolOperator, g: torch.Tensor) -> torch.Tensor:
    """dx [B, N_in, F] = P^T @ g for g [B, N_out, F], in the operator's
    dtype (g must have it too). Under the row layout the CSR holds the
    input level's row shard: dx is [B, pool.x_rows, F], this rank's rows,
    and g the all-gathered [B, pool.g_rows, F]. A CPU tensor runs the
    plain twin; a CUDA tensor launches the kernel or raises."""
    mode = _mode(pool, g)
    if g.device.type == "cpu":
        return pool_transpose_reference(pool, g)
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    y = _launch(pool, g, mode)
    LAUNCHES[mode] += 1
    key = (mode, pool.x_rows, pool.g_rows, g.shape[0] * g.shape[2])
    LAUNCHES_BY_SHAPE[key] = LAUNCHES_BY_SHAPE.get(key, 0) + 1
    return y
