"""Chebyshev spectral graph convolution (counterpart of
meshvae_tpu/ops/cheb.py and the forward of ``cheb_conv_pallas`` in
meshvae_tpu/ops/pallas_cheb.py).

out = sum_k T_k(L_hat) x @ W_k (+ bias), with T_0 = x, T_1 = L_hat x,
T_k = 2 L_hat T_{k-1} - T_{k-2}; all K orders are mixed by one
[.., K*F] @ [K*F, F_out] product.

x: [B, N, F_in]; weight: [K, F_in, F_out]; bias: [F_out] or None.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .block_sparse import BlockSparseOperator
from .bsr_spmm import bsr_grouped_spmm
from .graph import GraphOperator

# matmul_precision -> block-sparse kernel mode. Dense products always run
# in full fp32 (TF32 is switched off on CUDA, device.resolve_device).
_KERNEL_MODE = {"highest": "fp32", "high": "bf16x3"}

_COL_PANEL = 128  # the kernel layout pads B * F_pad to a multiple of this


def resolve_precision(precision) -> str:
    """None / "" -> "highest" (true fp32, the parity default); "high" runs
    the kernel's bf16x3 split. Other values are not supported by the port."""
    if precision is None or precision == "":
        return "highest"
    name = str(precision).lower()
    if name not in _KERNEL_MODE:
        raise ValueError(f"matmul_precision {precision!r} is not supported "
                         f"by the port; use one of {sorted(_KERNEL_MODE)}")
    return name


def cheb_conv(x: torch.Tensor, op: GraphOperator, weight: torch.Tensor,
              bias: torch.Tensor | None = None,
              precision=None) -> torch.Tensor:
    k = weight.shape[0]
    if op.active_n < op.n:
        # Rows/columns beyond active_n are empty (the embedded final-conv
        # operator stores only its corner): those vertices sit at
        # eigenvalue 0, where T_k(0) = (1, 0, -1, 0, ...), so the rest is
        # one product with sum_k T_k(0) W_k.
        corner = dataclasses.replace(op, n=op.active_n)
        inner = cheb_conv(x[:, :op.active_n], corner, weight, bias,
                          precision=precision)
        coeffs = [1.0 if i % 4 == 0 else (-1.0 if i % 4 == 2 else 0.0)
                  for i in range(k)]
        w_eff = sum(c * weight[i] for i, c in enumerate(coeffs) if c != 0.0)
        rest = torch.matmul(x[:, op.active_n:], w_eff)
        if bias is not None:
            rest = rest + bias
        return torch.cat([inner, rest], dim=1)

    if op.bsr is not None:
        return cheb_conv_bsr(x, op.bsr, weight, bias, precision=precision)

    resolve_precision(precision)  # validate; the dense path is plain fp32
    txs = [x]
    if k > 1:
        txs.append(torch.matmul(op.dense, x))
    for _ in range(2, k):
        txs.append(2.0 * torch.matmul(op.dense, txs[-1]) - txs[-2])
    f_in = x.shape[-1]
    out = torch.matmul(torch.cat(txs, dim=-1),
                       weight.reshape(k * f_in, weight.shape[-1]))
    if bias is not None:
        out = out + bias
    return out


def _pad_features(b: int, f: int) -> int:
    """Smallest f_pad >= f with b * f_pad a multiple of the column panel."""
    f_pad = f
    while (b * f_pad) % _COL_PANEL != 0:
        f_pad += 1
    return f_pad


def cheb_conv_bsr(x: torch.Tensor, bsr: BlockSparseOperator,
                  weight: torch.Tensor, bias: torch.Tensor | None,
                  precision=None) -> torch.Tensor:
    """Chebyshev conv through the block-sparse kernel, in the padded
    [N_pad, B, F_pad] layout of cheb_conv_pallas: transpose in, pad, K-1
    kernel calls (orders >= 2 fuse 2 L T_{k-1} - T_{k-2} into the kernel),
    one wide channel mix, transpose out."""
    mode = _KERNEL_MODE[resolve_precision(precision)]
    b, n, f_in = x.shape
    k, _, f_out = weight.shape
    n_pad = bsr.n_pad
    f_pad = _pad_features(b, f_in)
    c = b * f_pad
    xt = F.pad(x.transpose(0, 1), (0, f_pad - f_in, 0, 0, 0, n_pad - n))
    w = F.pad(weight, (0, 0, 0, f_pad - f_in))  # [K, F_pad, F_out]

    def mm(t, alpha, t_prev=None):
        prev = None if t_prev is None else t_prev.reshape(n_pad, c)
        return bsr_grouped_spmm(bsr, t.reshape(n_pad, c), mode, alpha,
                                t_prev=prev).reshape(n_pad, b, f_pad)

    txs = [xt]
    if k > 1:
        txs.append(mm(xt, 1.0))
    for _ in range(2, k):
        txs.append(mm(txs[-1], 2.0, txs[-2]))
    out = torch.matmul(torch.cat(txs, dim=-1), w.reshape(k * f_pad, f_out))
    out = out[:n].transpose(0, 1)
    if bias is not None:
        out = out + bias
    return out
