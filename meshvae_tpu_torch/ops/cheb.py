"""Chebyshev spectral graph convolution (counterpart of
meshvae_tpu/ops/cheb.py and of ``cheb_conv_pallas`` / ``_basis_mix`` in
meshvae_tpu/ops/pallas_cheb.py).

out = sum_k T_k(L_hat) x @ W_k (+ bias), with T_0 = x, T_1 = L_hat x,
T_k = 2 L_hat T_{k-1} - T_{k-2}. The dense and ELL paths mix the K orders
by one [.., K*F] @ [K*F, F_out] product of their concatenation; the
block-sparse path by ops/cheb_mix.py, which reads the orders where they
lie. The operator's layout picks the propagation: the block-sparse kernel
(``cheb_conv_bsr``, or its row shards under seq_parallel:
``cheb_conv_bsr_sharded``), a dense product, or the neighbour-list gather
``propagate_ell`` (cheb_method ell; plain torch, autograd's backward, as
the JAX package's ell path is plain XLA). Under seq_parallel x and the
result are the rank's rows of a row-sharded level whatever the layout: an
ELL or dense row shard propagates through ``propagate_rows`` (the
all-gathered input, the rank's rows of L), the embedded final operator
through ``_embedded_rows``.

x: [B, N, F_in]; weight: [K, F_in, F_out]; bias: [F_out] or None.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.nn.functional as F

from .block_sparse import BlockSparseOperator
from .bsr_shard import (add_bias_rows, cheb_conv_bsr_sharded, from_rows,
                        rows_matmul, to_rows)
from .bsr_spmm import bsr_grouped_spmm, pad_features
from .cheb_mix import cheb_mix, cheb_mix_dw
from .graph import GraphOperator

# matmul_precision -> block-sparse kernel mode on float32 operators; bf16
# operators always run the kernel's "bf16" mode ("default": one bf16 x bf16
# pass, fp32 accumulation). Dense products on float32 operands run in full
# fp32 (TF32 is switched off on CUDA, device.resolve_device).
_KERNEL_MODE = {"highest": "fp32", "high": "bf16x3", "default": "bf16"}

# The lazy mix-cotangent seed (the JAX package's switch of the same name,
# pallas_cheb.FUSED_SEED_DOT, off by default): square mixes (f_pad ==
# f_out) outside mode bf16x3 pass c_j = g @ W_j^T to the kernel as
# t_plus_dot instead of computing it first. Read at each backward.
FUSED_SEED_DOT = bool(int(os.environ.get("MESHVAE_FUSED_SEED_DOT", "0")))


def resolve_precision(precision, dtype: torch.dtype = torch.float32) -> str:
    """matmul_precision for operands of `dtype`.

    float32: None / "" -> "highest" (true fp32, the parity default); "high"
    runs the kernel's bf16x3 split; "default" is not supported (XLA's
    DEFAULT on f32 operands truncates them to bf16, which the port does
    not reproduce).
    bfloat16: every value clamps to "default", as the JAX package's
    _clamp_bf16_precision does (HIGH's residual is zero on bf16 values and
    HIGHEST does not lower on bf16 operands)."""
    name = "" if precision is None else str(precision).lower()
    if name not in ("", *_KERNEL_MODE):
        raise ValueError(f"matmul_precision {precision!r} is not supported "
                         f"by the port; use one of {sorted(_KERNEL_MODE)}")
    if dtype == torch.bfloat16:
        return "default"
    if dtype != torch.float32:
        raise ValueError(f"operands of {dtype} are not supported")
    if name == "default":
        raise ValueError("matmul_precision 'default' is not supported by "
                         "the port on float32 operands; it runs only with "
                         "compute_dtype bfloat16")
    return name or "highest"


def propagate_ell(op: GraphOperator, x: torch.Tensor) -> torch.Tensor:
    """L_hat @ x over the vertex dim from the neighbour list: out[b, i] =
    sum_d w[i, d] * x[b, idx[i, d]], as one [B, N, D, F] gather and a
    weighted reduction over D (meshvae_tpu/ops/cheb.py propagate_ell).
    The gather is an index_select, whose backward is an index_add (no
    sort, no host sync: it captures in a CUDA graph). Autograd keeps only
    the operator's own idx and w for the backward; the gather and its
    reduction's operand are transient (validate.ell_step_bytes counts
    them)."""
    b, _, f = x.shape
    n, d = op.ell_idx.shape
    gathered = x.index_select(1, op.ell_idx.reshape(-1)).view(b, n, d, f)
    return torch.einsum("nd,bndf->bnf", op.ell_w, gathered)


class _PropagateRows(torch.autograd.Function):
    """L @ x on a row-sharded level with an ELL or dense row shard of L:
    the forward all-gathers x over the sp group and applies the rank's
    rows of L. Its backward is the same sharded product on the
    all-gathered cotangent (L symmetric: dx = L g, whose rank's rows are
    the rank's rows of L on all of g), so each rank's dx holds every
    rank's terms and the ELL backward runs no index_add."""

    @staticmethod
    def forward(ctx, x, op):
        ctx.op = op
        return _rows_product(op, x)

    @staticmethod
    def backward(ctx, g):
        return _rows_product(ctx.op, g.contiguous()), None


def _rows_product(op: GraphOperator, x: torch.Tensor) -> torch.Tensor:
    """The rank's rows of L @ x from x's rows [B, rows_local, F]: the
    gathered [B, n_pad_global, F] (ELL indices and dense columns stay
    below n, so the padding rows are never read) through the rank's rows
    of ell_idx / ell_w or dense."""
    full = op.rows.group.all_gather(x, dim=1)
    if op.ell_idx is not None:
        return propagate_ell(op, full)
    return torch.matmul(op.dense, full[:, :op.n])


def propagate_rows(op: GraphOperator, x: torch.Tensor) -> torch.Tensor:
    """L @ x on the rank's rows of an ELL or dense row shard
    (shard_graph_operator); differentiable in x (_PropagateRows)."""
    return _PropagateRows.apply(x, op)


def cheb_conv(x: torch.Tensor, op: GraphOperator, weight: torch.Tensor,
              bias: torch.Tensor | None = None,
              precision=None) -> torch.Tensor:
    """x, weight and bias in the operator's dtype (the model casts them):
    float32, or bfloat16, where every product takes bf16 operands with
    fp32 accumulation and a bf16 result, as the JAX package's bf16 mode.
    Where op.rows is set (seq_parallel's row layout) x and the result are
    the rank's rows [B, rows_local, F] of the level."""
    k = weight.shape[0]
    if op.active_n < op.n:
        # Rows/columns beyond active_n are empty (the embedded final-conv
        # operator stores only its corner): those vertices sit at
        # eigenvalue 0, where T_k(0) = (1, 0, -1, 0, ...), so the rest is
        # one product with sum_k T_k(0) W_k.
        coeffs = [1.0 if i % 4 == 0 else (-1.0 if i % 4 == 2 else 0.0)
                  for i in range(k)]
        w_eff = sum(c * weight[i] for i, c in enumerate(coeffs) if c != 0.0)
        if op.rows is not None:
            return _embedded_rows(x, op, weight, bias, w_eff, precision)
        corner = dataclasses.replace(op, n=op.active_n)
        inner = cheb_conv(x[:, :op.active_n], corner, weight, bias,
                          precision=precision)
        rest = torch.matmul(x[:, op.active_n:], w_eff)
        if bias is not None:
            rest = rest + bias
        return torch.cat([inner, rest], dim=1)

    if op.bsr_sp is not None:
        return cheb_conv_bsr_sharded(x, op, weight, bias,
                                     precision=precision)
    if op.bsr is not None:
        return cheb_conv_bsr(x, op.bsr, weight, bias, precision=precision)

    resolve_precision(precision, op.dtype)  # validate; dense/ell run plain
    shard = op.rows
    if shard is not None:
        prop = lambda t: propagate_rows(op, t)
    elif op.ell_idx is not None:
        prop = lambda t: propagate_ell(op, t)
    else:
        prop = lambda t: torch.matmul(op.dense, t)
    txs = [x]
    if k > 1:
        txs.append(prop(x))
    for _ in range(2, k):
        txs.append(2.0 * prop(txs[-1]) - txs[-2])
    f_in = x.shape[-1]
    basis = torch.cat(txs, dim=-1)
    w = weight.reshape(k * f_in, weight.shape[-1])
    if shard is not None:
        # dW and the bias gradient are summed over the rank's rows, then
        # over sp
        out = rows_matmul(basis, w, shard.group)
        return out if bias is None else add_bias_rows(
            out, bias, shard.count(), shard.group)
    out = torch.matmul(basis, w)
    if bias is not None:
        out = out + bias
    return out


def _embedded_rows(x: torch.Tensor, op: GraphOperator, weight: torch.Tensor,
                   bias: torch.Tensor | None, w_eff: torch.Tensor,
                   precision) -> torch.Tensor:
    """The embedded operator on row-sharded level-0 activations (op.rows):
    the corner rows [0, active_n) all-gathered whole from the ranks that
    hold them (a few hundred rows, rank 0's alone at scaled80k), the
    corner conv on them in the corner's own layout (a dense or ELL corner
    on the whole tensor; a block-sparse corner in the row form, through
    its own row shard, which cuts the corner's n_pad into other rows than
    level 0's), and this rank's rows of its result; the closed form on
    this rank's other rows, whose dW and bias gradient are summed over
    the group."""
    shard, a = op.rows, op.active_n
    corner = dataclasses.replace(op, n=a, row_shard=None)
    whole = from_rows(x, shard, n=a)
    if corner.bsr_sp is not None:
        own = corner.rows
        inner = from_rows(cheb_conv(to_rows(whole, own), corner, weight,
                                    bias, precision=precision), own)
    else:
        inner = cheb_conv(whole, corner, weight, bias, precision=precision)
    c = shard.count(a)
    rest = rows_matmul(x[:, c:], w_eff, shard.group)
    if bias is not None:
        rest = add_bias_rows(rest, bias, shard.count() - c, shard.group)
    return torch.cat([to_rows(inner, shard, n=a, rows=c), rest], dim=1)


class _BasisMix(torch.autograd.Function):
    """Chebyshev basis + mix on the padded [n_pad, B, F_pad] layout with a
    fused backward (counterpart of pallas_cheb._basis_mix). Every tensor is
    in the operator's dtype: in bf16 the recurrence state, the basis, the
    mix output, the cotangents c_j and dx, and dW are bf16, each product
    accumulated in fp32 and rounded once (BF16_STATE).

    Forward: T_0 = x, T_1 = L x, T_k = 2 L T_{k-1} - T_{k-2} (the seed
    folds into the kernel), then the mix sum_k T_k @ W_k read from the K
    orders where they lie (ops/cheb_mix.py; the orders are never
    concatenated). The K orders are saved for the backward.

    Backward, with c_j = g @ W_j^T the mix cotangent of T_j: dW_k = T_k^T g
    over (rows, batch), one cheb_mix_dw call on the saved orders; dx runs
    the reverse recurrence u_{j-1} = 2 L u_j + c_{j-1} - u_{j+1} (L symmetric)
    as two-seed kernel calls, ending with dx = L u_1 + c_0 - u_2. It is
    skipped when x needs no gradient (the first encoder conv on data).
    With FUSED_SEED_DOT on a square mix outside mode bf16x3, only
    c_{K-1} is computed here; every kernel call gets (g, W_{j-1}^T) and
    computes c_{j-1} itself (t_plus_dot), as _basis_mix's lazy branch."""

    @staticmethod
    def forward(ctx, xt, w, bsr, mode):
        n_pad, b, f_pad = xt.shape
        k, _, f_out = w.shape
        c = b * f_pad

        def mm(t, alpha, t_prev=None):
            prev = None if t_prev is None else t_prev.reshape(n_pad, c)
            return bsr_grouped_spmm(bsr, t.reshape(n_pad, c), mode, alpha,
                                    t_prev=prev).reshape(n_pad, b, f_pad)

        txs = [xt.contiguous()]
        if k > 1:
            txs.append(mm(txs[0], 1.0))
        for _ in range(2, k):
            txs.append(mm(txs[-1], 2.0, txs[-2]))
        ctx.save_for_backward(w, *txs)
        ctx.bsr, ctx.mode = bsr, mode
        rows = [t.view(n_pad * b, f_pad) for t in txs]
        return cheb_mix(rows, w).view(n_pad, b, f_out)

    @staticmethod
    def backward(ctx, g):
        w, *txs = ctx.saved_tensors
        bsr, mode = ctx.bsr, ctx.mode
        n_pad, b, _ = txs[0].shape
        k, f_pad, f_out = w.shape
        c = b * f_pad
        gm = g.reshape(n_pad * b, f_out)
        dw = cheb_mix_dw([t.view(n_pad * b, f_pad) for t in txs], gm)
        if not ctx.needs_input_grad[0]:
            return None, dw, None, None
        c_of = lambda j: torch.matmul(gm, w[j].t()).reshape(n_pad, c)
        if k == 1:
            dx = c_of(0)
        elif FUSED_SEED_DOT and f_pad == f_out and mode != "bf16x3":
            gm2 = gm.reshape(n_pad, c).contiguous()
            seeds = [{"t_plus_dot": (gm2, w[j].t().contiguous())}
                     for j in range(k - 1)]
            dx = reverse_recurrence(bsr, mode, c_of(k - 1), seeds)
        else:
            # per-order cotangents, each [n_pad, C] and contiguous
            seeds = [{"t_plus": c_of(j)} for j in range(k - 1)]
            dx = reverse_recurrence(bsr, mode, c_of(k - 1), seeds)
        return dx.reshape(n_pad, b, f_pad), dw, None, None


def reverse_recurrence(bsr: BlockSparseOperator, mode: str,
                       top: torch.Tensor, seeds: list[dict]) -> torch.Tensor:
    """The Chebyshev basis backward (L symmetric): u = top (the cotangent
    of T_{K-1}), u_{j-1} = 2 L u_j + s_{j-1} - u_{j+1} for j = K-1..2, then
    dx = L u_1 + s_0 - u_2, as K-1 two-seed kernel calls; seeds[j] gives
    s_j as the kernel's t_plus or t_plus_dot argument."""
    u, prev_u = top, None
    for j in range(len(seeds), 1, -1):
        u, prev_u = bsr_grouped_spmm(bsr, u, mode, 2.0, t_prev=prev_u,
                                     **seeds[j - 1]), u
    return bsr_grouped_spmm(bsr, u, mode, 1.0, t_prev=prev_u, **seeds[0])


def cheb_conv_bsr(x: torch.Tensor, bsr: BlockSparseOperator,
                  weight: torch.Tensor, bias: torch.Tensor | None,
                  precision=None) -> torch.Tensor:
    """Chebyshev conv through the block-sparse kernel, in the padded
    [N_pad, B, F_pad] layout of cheb_conv_pallas: transpose in, pad, K-1
    kernel calls (orders >= 2 fuse 2 L T_{k-1} - T_{k-2} into the kernel),
    one wide channel mix, transpose out. Differentiable in x and weight
    (the backward is _BasisMix's)."""
    mode = _KERNEL_MODE[resolve_precision(precision, bsr.blocks.dtype)]
    b, n, f_in = x.shape
    f_pad = pad_features(b, f_in)
    xt = F.pad(x.transpose(0, 1), (0, f_pad - f_in, 0, 0, 0, bsr.n_pad - n))
    w = F.pad(weight, (0, 0, 0, f_pad - f_in))  # [K, F_pad, F_out]
    out = _BasisMix.apply(xt, w, bsr, mode)[:n].transpose(0, 1)
    if bias is not None:
        out = out + bias
    return out
