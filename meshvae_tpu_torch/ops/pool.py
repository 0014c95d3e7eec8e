"""Mesh pool/unpool (counterpart of meshvae_tpu/ops/pool.py): out = P @ x
per batch item. pool_method "gather" (the default) applies P as weighted
gathers (down-pool rows are one-hot selections, barycentric up-pool rows
have <= 3 entries); "dense" as one dense product with the [M, N] matrix,
whose backward is autograd's P^T product (no kernel launch), as the JAX
package's dense pool is a plain einsum.

The gather path's backward dx = P^T @ g never scatters: autograd's
transpose of a gather is an atomic index_add, whose sums depend on thread
order. It applies the precomputed transpose instead: where the JAX package
takes its block-sparse kernel (above the fan-in cutoff, where P^T is also
built in CSR, and where B * F fills a column panel), through the CSR kernel
``pool_transpose`` (ops/pool_transpose.py, on PoolOperator.t_ptr / t_col /
t_val), else as weighted gathers over P^T (t_idx / t_w).

The operator's dtype sets the arithmetic: with float32 weights the kernel
runs fp32 (the JAX package pins HIGHEST there at every matmul_precision);
with bfloat16 weights (compute_dtype=bfloat16) the gathers multiply and add
in bf16 and the kernel runs its "bf16" mode (fp32 sums, one rounding), as
the JAX package's bf16 blocks run DEFAULT with a bf16 result.

Under seq_parallel's row layout a pool takes and returns the rank's rows
of a row-sharded level (``_PoolApply``); the dense pool gathers its input
whole, multiplies on every rank and keeps the rank's output rows.
"""
from __future__ import annotations

import torch

from .bsr_shard import from_rows, to_rows
from .bsr_spmm import COL_PANEL
from .graph import PoolOperator
from .pool_transpose import pool_transpose


def _gather_apply(x: torch.Tensor, idx: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """sum_d w[:, d] * x[:, idx[:, d]]; padded slots carry weight 0."""
    if idx.shape[1] == 1:
        return x[:, idx[:, 0]] * w[None, :, 0, None]
    acc = None
    for d in range(idx.shape[1]):
        term = w[None, :, d, None] * x[:, idx[:, d]]
        acc = term if acc is None else acc + term
    return acc


class _PoolApply(torch.autograd.Function):
    """out = P @ x by gathers. Under the row layout (PoolOperator's in_rows
    / out_rows) the forward all-gathers x over sp when its level is
    row-sharded (the gathers index rows below n_in, so the padding rows
    need no slice) and computes this rank's output rows when the output
    level is row-sharded, else all of them; the backward mirrors it:
    all-gather g when the output level is row-sharded, then this rank's
    rows of dx from P^T's row shard when the input level is row-sharded,
    else all of dx. Every row sums in the single process's order, and no
    sum crosses ranks."""

    @staticmethod
    def forward(ctx, x, pool):
        ctx.pool = pool
        if pool.in_rows is not None:
            x = pool.in_rows.group.all_gather(x, dim=1)
        return _gather_apply(x, pool.idx, pool.w)

    @staticmethod
    def backward(ctx, g):
        pool = ctx.pool
        if pool.out_rows is not None:
            g = pool.out_rows.group.all_gather(g, dim=1)
        # the JAX package's condition for its block-sparse kernel (below
        # one column panel of B * F that kernel would pad most of its work
        # away)
        if pool.t_ptr is not None and g.shape[0] * g.shape[2] >= COL_PANEL:
            dx = pool_transpose(pool, g)
        else:
            dx = _gather_apply(g, pool.t_idx, pool.t_w)
        return dx, None


def pool_apply(x: torch.Tensor, pool: PoolOperator,
               method: str = "gather") -> torch.Tensor:
    """x: [B, N_in, F] -> [B, N_out, F] (under the row layout, the rank's
    rows of a row-sharded level: PoolOperator.x_rows in, the output
    level's rows_local out); `method` is the pool_method the operator was
    built for (graph.pool_operator)."""
    if method == "dense":
        if pool.dense is None:
            raise ValueError("pool_method 'dense' on an operator built "
                             "without its dense layout; rebuild it with "
                             "pool_operator(..., pool_method='dense')")
        # the dense product on whole tensors, every rank the same
        if pool.in_rows is not None:
            x = from_rows(x, pool.in_rows)
        out = torch.matmul(pool.dense, x)
        return out if pool.out_rows is None else to_rows(out, pool.out_rows)
    if method != "gather":
        raise ValueError(f"unknown pool method: {method!r}")
    if pool.idx is None:
        raise ValueError("pool_method 'gather' on an operator built with "
                         "only its dense layout")
    return _PoolApply.apply(x, pool)
