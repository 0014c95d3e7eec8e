"""The Chebyshev conv's channel mix and its weight gradient over the K
orders of the basis, read where they lie:

  cheb_mix(txs, w)      out [M, F_out] = sum_k txs[k] @ w[k]
  cheb_mix_dw(txs, g)   dW [K, F_pad, F_out], dW[k] = txs[k]^T @ g

txs is a list of the K orders T_k, each a contiguous [M, F_pad] tensor
(ops/cheb.py ``_BasisMix``: T_0 the padded input, T_1.. the outputs of
``bsr_grouped_spmm``), w [K, F_pad, F_out] and g [M, F_out], all in the
operator's dtype. A CUDA tensor launches the hand-written kernels of
``csrc/cheb_mix.cu`` (float32: IEEE fp32 FMAs, no TF32; bfloat16: the
tensor cores, fp32 accumulation, one rounding per output; dW as per-CTA
partial sums added in a fixed order), which never gather the orders into
one tensor; a CPU tensor runs the plain twins ``cheb_mix_reference`` /
``cheb_mix_dw_reference``, which multiply the orders' concatenation.

They replace no TPU kernel: meshvae_tpu/ops/pallas_cheb.py ``_basis_mix``
concatenates the orders and leaves the mix and dW to XLA's dot_general,
as the port did with ``torch.cat`` and cuBLAS before this kernel.

The mix is also the registered operator ``meshvae_torch::cheb_mix``
(``cheb_mix_op``: the orders as a Tensor[] and w), whose CPU
implementation is the twin and whose CUDA implementation is the launch;
``torch.export`` records it where the wrapper is called while exporting,
as it records ``bsr_grouped_spmm`` (infer/export.py).
"""
from __future__ import annotations

import ctypes
import functools

import torch

DTYPES = {torch.float32: "fp32", torch.bfloat16: "bf16"}
MODES = tuple(DTYPES.values())
MAX_ORDERS = 32  # csrc/cheb_mix.cu MAX_ORDERS

# Launches per (kind "fwd" | "dw", mode, K, F_pad, F_out), counted where the
# wrapper launches (never on the CPU twin path, nor inside an exported
# program). A "dw" call is one launch of the partial sums and one of their
# reduction, counted once. train/graphs.py adds a CUDA graph's captured
# launches at each replay.
LAUNCHES: dict[tuple[str, str, int, int, int], int] = {}


def reset_launches() -> None:
    LAUNCHES.clear()


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a loaded csrc/cheb_mix.cu library."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    orders = ctypes.POINTER(ctypes.c_void_p)
    lib.cheb_mix.argtypes = [orders, i, ll, i, i, p, p, i, p]
    lib.cheb_mix.restype = i
    lib.cheb_mix_dw_workspace.argtypes = [i, ll, i, i, i, i]
    lib.cheb_mix_dw_workspace.restype = ll
    lib.cheb_mix_dw.argtypes = [orders, i, ll, i, i, p, p, p, ll, i, p]
    lib.cheb_mix_dw.restype = i
    return lib


@functools.cache
def _lib():
    from ._build import load_library

    return bind(load_library("cheb_mix"))


def _check(txs, other: torch.Tensor, name: str, shape) -> str:
    """The mode of a call; raises unless every order is a contiguous
    [M, F_pad] tensor of `other`'s dtype and device and `other` has
    `shape`."""
    dtype = other.dtype
    if dtype not in DTYPES:
        raise TypeError(f"cheb_mix takes float32 or bfloat16, got {dtype}")
    if not 1 <= len(txs) <= MAX_ORDERS:
        raise ValueError(f"cheb_mix takes 1 to {MAX_ORDERS} orders, got "
                         f"{len(txs)}")
    m, f = txs[0].shape if txs[0].dim() == 2 else (-1, -1)
    for t in txs:
        if t.dim() != 2 or tuple(t.shape) != (m, f):
            raise ValueError(f"the orders must all be [M, F_pad] alike, got "
                             f"{[tuple(t.shape) for t in txs]}")
        if t.dtype != dtype or t.device != other.device:
            raise TypeError(f"the orders must be {dtype} on {other.device}, "
                            f"got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError("the orders must be contiguous")
    if tuple(other.shape) != tuple(shape(m, f)):
        raise ValueError(f"{name} must be {tuple(shape(m, f))}, got "
                         f"{tuple(other.shape)}")
    return DTYPES[dtype]


def cheb_mix_reference(txs, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the mix: one product of the orders'
    concatenation [M, K*F_pad] with w as [K*F_pad, F_out], on the operands
    widened to fp32 (exact for bf16), rounded once to their dtype. The
    concatenation keeps the summation order of the JAX package's
    dot_general (and of the conv before this kernel), so a CPU run and the
    reference sum alike; it is never built on the card's path."""
    k, f, f_out = w.shape
    return torch.matmul(torch.cat(txs, dim=-1).float(),
                        w.reshape(k * f, f_out).float()).to(w.dtype)


def cheb_mix_dw_fp32(txs, g: torch.Tensor) -> torch.Tensor:
    """dW [K, F_pad, F_out] in fp32, not rounded: the orders'
    concatenation, transposed, times g, on the operands widened to fp32.
    The twin rounds it; the sp row-sharded backward (ops/bsr_shard.py)
    sums it over the group first."""
    k, f = len(txs), txs[0].shape[1]
    return torch.matmul(torch.cat(txs, dim=-1).t().float(),
                        g.float()).reshape(k, f, g.shape[1])


def cheb_mix_dw_reference(txs, g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of dW: cheb_mix_dw_fp32 rounded once to the
    operands' dtype."""
    return cheb_mix_dw_fp32(txs, g).to(g.dtype)


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _orders(txs):
    return (ctypes.c_void_p * len(txs))(*[t.data_ptr() for t in txs])


def _launch_mix(txs, w: torch.Tensor, mode: str) -> torch.Tensor:
    k, f, f_out = w.shape
    m = txs[0].shape[0]
    out = torch.empty((m, f_out), dtype=w.dtype, device=w.device)
    with torch.cuda.device(w.device):
        rc = _lib().cheb_mix(_orders(txs), k, m, f, f_out, w.data_ptr(),
                             out.data_ptr(), MODES.index(mode),
                             _stream(w.device))
    if rc != 0:
        raise RuntimeError(f"cheb_mix[{mode}] launch failed at K={k}, "
                           f"M={m}, F_pad={f}, F_out={f_out}: CUDA error "
                           f"{rc}")
    return out


def _launch_dw(txs, g: torch.Tensor, mode: str) -> torch.Tensor:
    k = len(txs)
    m, f = txs[0].shape
    f_out = g.shape[1]
    dev = g.device
    with torch.cuda.device(dev):
        lib = _lib()
        aligned = all(t.data_ptr() % 16 == 0 for t in (*txs, g))
        n = lib.cheb_mix_dw_workspace(k, m, f, f_out, int(aligned),
                                      MODES.index(mode))
        if n < 0:
            raise RuntimeError(f"cheb_mix_dw[{mode}] has no plan for K={k}, "
                               f"M={m}, F_pad={f}, F_out={f_out}")
        ws = torch.empty((max(n, 1),), dtype=torch.float32, device=dev)
        dw = torch.empty((k, f, f_out), dtype=g.dtype, device=dev)
        rc = lib.cheb_mix_dw(_orders(txs), k, m, f, f_out, g.data_ptr(),
                             dw.data_ptr(), ws.data_ptr(), n,
                             MODES.index(mode), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"cheb_mix_dw[{mode}] launch failed at K={k}, "
                           f"M={m}, F_pad={f}, F_out={f_out}: CUDA error "
                           f"{rc}")
    return dw


def _count(kind: str, mode: str, k: int, f: int, f_out: int) -> None:
    key = (kind, mode, k, f, f_out)
    LAUNCHES[key] = LAUNCHES.get(key, 0) + 1


@torch.library.custom_op("meshvae_torch::cheb_mix", mutates_args=(),
                         device_types="cpu")
def cheb_mix_op(txs: list[torch.Tensor], w: torch.Tensor) -> torch.Tensor:
    """The registered operator; its CPU implementation is the twin."""
    return cheb_mix_reference(txs, w)


@cheb_mix_op.register_kernel("cuda")
def _op_cuda(txs, w):
    mode = _check(txs, w, "w", lambda m, f: (len(txs), f, w.shape[-1]))
    return _launch_mix(list(txs), w.contiguous(), mode)


@cheb_mix_op.register_fake
def _op_fake(txs, w):
    return w.new_empty((txs[0].shape[0], w.shape[-1]))


def cheb_mix(txs, w: torch.Tensor) -> torch.Tensor:
    """out [M, F_out] = sum_k txs[k] @ w[k] for K contiguous orders
    [M, F_pad] and w [K, F_pad, F_out], all of one dtype (float32 or
    bfloat16) and device. A CPU tensor runs the plain twin; a CUDA tensor
    launches the kernel or raises. While torch.export traces, the call is
    the registered operator instead."""
    if torch.compiler.is_exporting():
        return cheb_mix_op(list(txs), w)
    w = w.contiguous()
    mode = _check(txs, w, "w", lambda m, f: (len(txs), f, w.shape[-1]))
    if w.device.type == "cpu":
        return cheb_mix_reference(txs, w)
    if w.device.type != "cuda":
        raise ValueError(f"unsupported device {w.device}")
    out = _launch_mix(txs, w, mode)
    _count("fwd", mode, *w.shape)
    return out


def cheb_mix_dw(txs, g: torch.Tensor) -> torch.Tensor:
    """dW [K, F_pad, F_out], dW[k] = txs[k]^T @ g, for K contiguous orders
    [M, F_pad] and g [M, F_out] of their dtype and device. A CPU tensor
    runs the plain twin; a CUDA tensor launches the kernels or raises."""
    g = g.contiguous()
    mode = _check(txs, g, "g", lambda m, f: (m, g.shape[-1]))
    if g.device.type == "cpu":
        return cheb_mix_dw_reference(txs, g)
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    dw = _launch_dw(txs, g, mode)
    _count("dw", mode, len(txs), txs[0].shape[1], g.shape[1])
    return dw
