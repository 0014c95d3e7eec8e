"""Chebyshev conv with the fused propagate + mix kernel (counterpart of
meshvae_tpu/ops/pallas_fused.py, TPU kernel #9).

The JAX package keeps ``cheb_conv_fused`` importable and tested as a
design record, not as a ``cheb_method``; so does the port. Per recurrence
step k = 1..K-1 one launch of ``csrc/cheb_fused.cu`` computes
T_k = alpha L T_{k-1} - [T_{k-2}] and adds T_k @ W_k (per batch item) into
the output accumulator in place, so the basis is never re-read by a
separate mix. acc_0 = x @ W_0 is a plain matmul, as in the JAX package.
The kernel's propagation is the occupied-tile engine of
``bsr_grouped_spmm`` (it skips the 16x16 tiles ``tile_mask`` clears, and
in fp32 its T_k has the bits of ``bsr_grouped_spmm(..., t_prev=T_{k-2})``);
its mix runs on the CUDA cores in fp32 and on the tensor cores in bf16x3.

The backward is the JAX package's closed form: dW_k = <T_k, g> over the
saved basis, the mix cotangents g_j = g @ W_j^T, and the adjoint
recurrence a_j = g_j + 2 L a_{j+1} - a_{j+2}, dx = g_0 + L a_1 - a_2, with
every L-apply through ``bsr_grouped_spmm`` (the seeds folded in).

Operands are float32 (a bf16 operator is widened); precision "highest"
runs IEEE fp32 products, "high" the bf16x3 split in both the propagation
and the in-kernel mix (block-sparse mode "bf16x3"). Features pad as the
JAX package pads them: f_pad is the smallest power of two >= F_in with
B * f_pad a multiple of the 128-column panel. The output width is F_out
itself (the result is F_out wide in both packages).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from .block_sparse import BLOCK, TILES, BlockSparseOperator
from .bsr_spmm import (COL_PANEL, _check, _split_bf16,
                       bsr_grouped_spmm_reference)
from .cheb import _KERNEL_MODE, resolve_precision, reverse_recurrence

MODES = ("fp32", "bf16x3")

# Launches of the CUDA kernel per mode, counted where the wrapper launches
# it (never on the CPU twin path). Readers reset and read them around a run.
LAUNCHES = {mode: 0 for mode in MODES}


def reset_launches() -> None:
    for mode in MODES:
        LAUNCHES[mode] = 0


@functools.cache
def _lib():
    from ._build import load_library

    lib = load_library("cheb_fused")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cheb_fused_step.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i,
                                    i, i, ctypes.c_float, i, p]
    lib.cheb_fused_step.restype = ctypes.c_int
    return lib


def pad_feature(b: int, f: int) -> int:
    """Smallest power of two f_pad >= f with b * f_pad a multiple of the
    column panel (pallas_fused._pad_feature)."""
    f_pad = 1
    while f_pad < f:
        f_pad *= 2
    while (b * f_pad) % COL_PANEL:
        f_pad *= 2
    return f_pad


def _mix(t: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """t [.., f_pad] @ w [f_pad, f_out] in fp32, or with the bf16x3 split
    of both operands (hi*hi + (hi*lo + lo*hi)) in mode bf16x3."""
    if mode != "bf16x3":
        return torch.matmul(t, w)
    (th, tl), (wh, wl) = _split_bf16(t), _split_bf16(w)
    return torch.matmul(th, wh) + (torch.matmul(th, wl)
                                   + torch.matmul(tl, wh))


def cheb_fused_step_reference(bsr: BlockSparseOperator, t1: torch.Tensor,
                              t2: torch.Tensor | None, w: torch.Tensor,
                              acc: torch.Tensor, alpha: float,
                              mode: str = "fp32"):
    """Plain PyTorch twin of one fused step: (T_k, acc + T_k @ W_k per
    batch item), T_k = alpha L t1 - t2 through the SpMM twin."""
    n_pad, c = t1.shape
    f_pad, f_out = w.shape
    t = bsr_grouped_spmm_reference(bsr, t1, mode, alpha, t_prev=t2)
    mix = _mix(t.reshape(n_pad, c // f_pad, f_pad), w, mode)
    return t, acc + mix.reshape(acc.shape)


def cheb_fused_step(bsr: BlockSparseOperator, t1: torch.Tensor,
                    t2: torch.Tensor | None, w: torch.Tensor,
                    acc: torch.Tensor, alpha: float, mode: str = "fp32"):
    """One recurrence step fused with its channel mix: returns (T_k, acc)
    with T_k = alpha L t1 - t2 [n_pad, C] and acc [n_pad, B * f_out] +=
    T_k @ w per batch item. All fp32; t1 and t2 [n_pad, C] with C = B *
    f_pad, w [f_pad, f_out]. A CPU tensor runs the plain twin (acc is not
    modified); a CUDA tensor launches the kernel, which updates acc in
    place and returns it, or raises."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if t1.device.type == "cpu":
        return cheb_fused_step_reference(bsr, t1, t2, w, acc, alpha, mode)
    if t1.device.type != "cuda":
        raise ValueError(f"unsupported device {t1.device}")
    n_rows, g = bsr.g_idx.shape
    f_pad, f_out = w.shape
    c = t1.shape[1]
    if (f_pad & (f_pad - 1) or c % max(64, f_pad)
            or bsr.n_pad != bsr.n_pad_cols):
        raise ValueError(f"fused step takes a square operator, f_pad a power "
                         f"of two and C a multiple of max(64, f_pad); got "
                         f"f_pad {f_pad}, C {c}")
    dev, f32 = t1.device, torch.float32
    _check("t1", t1, (bsr.n_pad, c), dev, f32)
    if t2 is not None:
        _check("t2", t2, (bsr.n_pad, c), dev, f32)
    _check("w", w, (f_pad, f_out), dev, f32)
    _check("acc", acc, (bsr.n_pad, c // f_pad * f_out), dev, f32)
    _check("blocks", bsr.blocks, (bsr.num_blocks, BLOCK, BLOCK), dev, f32)
    _check("g_idx", bsr.g_idx, (bsr.n_pad // BLOCK, g), dev, torch.int32)
    _check("g_bcol", bsr.g_bcol, (n_rows * g,), dev, torch.int32)
    _check("tile_mask", bsr.tile_mask, (bsr.num_blocks, TILES), dev,
           torch.uint8)
    t = torch.empty_like(t1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().cheb_fused_step(
            bsr.blocks.data_ptr(), bsr.g_idx.data_ptr(),
            bsr.g_bcol.data_ptr(), bsr.tile_mask.data_ptr(), t1.data_ptr(),
            None if t2 is None else t2.data_ptr(), w.data_ptr(),
            t.data_ptr(), acc.data_ptr(), bsr.num_blocks, n_rows, g,
            bsr.n_pad_cols // BLOCK, c, f_pad, f_out, float(alpha),
            MODES.index(mode), stream)
    if rc != 0:
        raise RuntimeError(f"cheb_fused_step[{mode}] launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES[mode] += 1
    return t, acc


class _FusedCheb(torch.autograd.Function):
    """x2d [n_pad, B * f_pad], w [K, f_pad, f_out] -> acc [n_pad,
    B * f_out]; the closed-form backward of pallas_fused._vjp_bwd."""

    @staticmethod
    def forward(ctx, x2d, w, bsr, mode, b):
        n_pad, c = x2d.shape
        k, f_pad, f_out = w.shape
        acc = torch.matmul(x2d.reshape(n_pad, b, f_pad), w[0]).reshape(
            n_pad, b * f_out)
        ts = [x2d]
        for i in range(1, k):
            t, acc = cheb_fused_step(bsr, ts[-1], ts[-2] if i > 1 else None,
                                     w[i].contiguous(), acc,
                                     1.0 if i == 1 else 2.0, mode)
            ts.append(t)
        ctx.save_for_backward(*ts, w)
        ctx.bsr, ctx.mode, ctx.b = bsr, mode, b
        return acc

    @staticmethod
    def backward(ctx, g):
        *ts, w = ctx.saved_tensors
        bsr, mode, b = ctx.bsr, ctx.mode, ctx.b
        k, f_pad, f_out = w.shape
        n_pad, c = ts[0].shape
        g2 = g.reshape(n_pad * b, f_out)
        dw = torch.stack([torch.matmul(t.reshape(n_pad * b, f_pad).t(), g2)
                          for t in ts])
        g_t = [torch.matmul(g2, w[j].t()).reshape(n_pad, c)
               for j in range(k)]
        if k == 1:
            dx = g_t[0]
        else:
            dx = reverse_recurrence(bsr, mode, g_t[k - 1],
                                    [{"t_plus": g_t[j]} for j in range(k - 1)])
        return dx, dw, None, None, None


def cheb_conv_fused(x: torch.Tensor, op, weight: torch.Tensor,
                    bias: torch.Tensor | None = None,
                    precision=None) -> torch.Tensor:
    """x [B, N, F_in], weight [K, F_in, F_out] -> [B, N, F_out] on the
    operator's block-sparse form (op.bsr; active_n is not read, as in the
    JAX package). Differentiable in x, weight and bias."""
    bsr: BlockSparseOperator = op.bsr
    if bsr.blocks.dtype != torch.float32:
        bsr = dataclasses.replace(bsr, blocks=bsr.blocks.float())
    mode = _KERNEL_MODE[resolve_precision(precision, torch.float32)]
    b, n, f_in = x.shape
    f_pad = pad_feature(b, f_in)
    xt = F.pad(x.float().transpose(0, 1),
               (0, f_pad - f_in, 0, 0, 0, bsr.n_pad - n))
    w = F.pad(weight.float(), (0, 0, 0, f_pad - f_in))
    acc = _FusedCheb.apply(xt.reshape(bsr.n_pad, b * f_pad).contiguous(), w,
                           bsr, mode, b)
    out = acc.reshape(bsr.n_pad, b, -1)[:n].transpose(0, 1)
    if bias is not None:
        out = out + bias
    return out
